"""ctypes bindings of the native (C++) ingestion code, ``native/mps_native.cpp``:
the port of ``madipm_tpu/models/native.py``.

- :func:`native_parse_mps`: the MPS/QPS text parser (the same semantics as
  the Python parser of ``models/mps.py``, which stays the fallback);
- :func:`native_coo_to_csr`: counting-sort COO -> CSR;
- :func:`native_normal_pattern`: the symbolic pattern of ``models/sparse.py``.

The library is the repo's ``native/libmadipm_native.so`` when it exists and
exports every function used here.  This module never writes into
``native/``: when that library is missing or incomplete it compiles
``native/mps_native.cpp`` into ``madipm_tpu_torch/_build/`` (keyed by the
source's hash) with the host's C++ compiler.  If neither works,
:func:`available` is False and callers take the Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
_SYMBOLS = ("mps_parse2", "mps_unknown_refs", "mps_dims", "mps_free", "mps_fill",
            "coo_to_csr", "normal_pattern_build", "normal_pattern_dims",
            "normal_pattern_fill", "normal_pattern_free")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _open(path: Path) -> Optional[ctypes.CDLL]:
    """The library at ``path`` if it loads and has every symbol, else None."""
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    return lib if all(hasattr(lib, s) for s in _SYMBOLS) else None


def build(native_dir: Path = _NATIVE_DIR, build_dir: Path = _BUILD_DIR) -> Optional[Path]:
    """Compile ``native_dir/mps_native.cpp`` into ``build_dir`` unless this
    source was built there already; the library's path, or None when no
    compiler is found or the build fails."""
    src = native_dir / "mps_native.cpp"
    if not src.exists():
        return None
    key = hashlib.sha256(src.read_bytes() + " ".join(_CXX_FLAGS).encode()).hexdigest()[:16]
    out = build_dir / f"libmadipm_native_{key}.so"
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *_CXX_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        return None
    os.replace(tmp, out)
    return out


def find_library(native_dir: Path = _NATIVE_DIR, build_dir: Path = _BUILD_DIR) -> Optional[ctypes.CDLL]:
    """The repo's library when it loads and is complete, else one built
    into ``build_dir`` (nothing is written into ``native_dir``)."""
    lib = _open(native_dir / "libmadipm_native.so")
    if lib is None:
        built = build(native_dir, build_dir)
        lib = _open(built) if built is not None else None
    return lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.mps_parse2.restype = ctypes.c_void_p
    lib.mps_parse2.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32]
    lib.mps_unknown_refs.restype = ctypes.c_int64
    lib.mps_unknown_refs.argtypes = [ctypes.c_void_p]
    lib.mps_dims.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int64)] * 4 + [
        ctypes.POINTER(ctypes.c_int32)
    ]
    lib.mps_free.argtypes = [ctypes.c_void_p]
    lib.mps_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 11 + [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int64,
    ]
    lib.coo_to_csr.argtypes = [ctypes.c_int64, ctypes.c_int64] + [ctypes.c_void_p] * 6
    lib.normal_pattern_build.restype = ctypes.c_void_p
    lib.normal_pattern_build.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.normal_pattern_dims.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.normal_pattern_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6
    lib.normal_pattern_free.argtypes = [ctypes.c_void_p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if not _tried:
        _tried = True
        lib = find_library()
        _lib = _declare(lib) if lib is not None else None
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def native_parse_mps(text: str, name: str = "mps", fixed: bool = False):
    """Parse MPS text with the C++ parser; returns a QuadraticModel.
    ``fixed=True`` takes column-anchored fields (classic fixed MPS, names
    may hold spaces).  Raises RuntimeError without the native library."""
    import scipy.sparse as sp

    from .qp import QuadraticModel

    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available; use models.mps.parse_mps")
    raw = text.encode()
    h = lib.mps_parse2(raw, len(raw), 1 if fixed else 0)
    if not h:
        raise RuntimeError("native MPS parse failed")
    try:
        n_unknown = int(lib.mps_unknown_refs(ctypes.c_void_p(h)))
        nvar, ncon, nnz, qnnz = (ctypes.c_int64() for _ in range(4))
        maximize = ctypes.c_int32()
        lib.mps_dims(h, ctypes.byref(nvar), ctypes.byref(ncon), ctypes.byref(nnz),
                     ctypes.byref(qnnz), ctypes.byref(maximize))
        n, m, k, qk = nvar.value, ncon.value, nnz.value, qnnz.value
        Ai, Aj, Ax = np.empty(k, np.int32), np.empty(k, np.int32), np.empty(k, np.float64)
        Qi, Qj, Qx = np.empty(qk, np.int32), np.empty(qk, np.int32), np.empty(qk, np.float64)
        c, lvar, uvar = np.empty(n), np.empty(n), np.empty(n)
        lcon, ucon = np.empty(m), np.empty(m)
        integer_mask = np.empty(n, dtype=np.uint8)
        c0 = ctypes.c_double()
        namebuf = ctypes.create_string_buffer(256)
        lib.mps_fill(
            ctypes.c_void_p(h), _ptr(Ai), _ptr(Aj), _ptr(Ax), _ptr(c), _ptr(lvar),
            _ptr(uvar), _ptr(lcon), _ptr(ucon), _ptr(Qi), _ptr(Qj), _ptr(Qx),
            ctypes.byref(c0), _ptr(integer_mask), namebuf, ctypes.c_int64(256),
        )
    finally:
        lib.mps_free(h)

    A = sp.csr_matrix((Ax, (Ai, Aj)), shape=(m, n))
    Q = sp.csr_matrix((Qx, (Qi, Qj)), shape=(n, n)) if qk else None
    model = QuadraticModel(
        c=c, A=A, lcon=lcon, ucon=ucon, lvar=lvar, uvar=uvar, Q=Q,
        c0=c0.value, name=namebuf.value.decode() or name,
        minimize=not bool(maximize.value),
    )
    model._integer_cols = np.flatnonzero(integer_mask).tolist()  # type: ignore[attr-defined]
    model._n_unknown_refs = n_unknown  # type: ignore[attr-defined]
    return model


def native_coo_to_csr(n_rows: int, Ai, Aj, Ax):
    """COO -> CSR by the native counting sort: (indptr, indices, data)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available")
    Ai = np.ascontiguousarray(Ai, dtype=np.int32)
    Aj = np.ascontiguousarray(Aj, dtype=np.int32)
    Ax = np.ascontiguousarray(Ax, dtype=np.float64)
    nnz = Ai.size
    Bp = np.empty(n_rows + 1, dtype=np.int32)
    Bj = np.empty(nnz, dtype=np.int32)
    Bx = np.empty(nnz, dtype=np.float64)
    lib.coo_to_csr(ctypes.c_int64(n_rows), ctypes.c_int64(nnz), _ptr(Ai), _ptr(Aj), _ptr(Ax),
                   _ptr(Bp), _ptr(Bj), _ptr(Bx))
    return Bp, Bj, Bx


def native_normal_pattern(indptr, indices, m, n, K, m_pad):
    """The symbolic normal pattern by the C++ code: the six arrays of
    ``models.sparse.build_normal_pattern``.  Raises RuntimeError without
    the native library."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available")
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    h = lib.normal_pattern_build(
        ctypes.c_int64(m), ctypes.c_int64(n), ctypes.c_int64(K),
        _ptr(indptr), _ptr(indices), ctypes.c_int64(m_pad),
    )
    if not h:
        raise RuntimeError("normal_pattern_build failed")
    try:
        P, nnzS = ctypes.c_int64(), ctypes.c_int64()
        lib.normal_pattern_dims(h, ctypes.byref(P), ctypes.byref(nnzS))
        pair = [np.empty(P.value, dtype=np.int32) for _ in range(4)]
        dst = [np.empty(nnzS.value, dtype=np.int32) for _ in range(2)]
        lib.normal_pattern_fill(ctypes.c_void_p(h), *(_ptr(a) for a in pair + dst))
    finally:
        lib.normal_pattern_free(ctypes.c_void_p(h))
    return (*pair, *dst)
