"""The kernel library: every ``csrc/*.cu`` compiled by ``nvcc`` into one
shared library with a plain C interface, loaded with ``ctypes``.

The library is built at first use into ``madipm_tpu_torch/_build/``
(ignored by git), named by a hash of every file under ``csrc/`` (names
and contents, headers too) and of the flags, so that an edit rebuilds.
Each .cu is compiled by its own ``nvcc`` process, all of them at once.
Each kernel's wrapper (``ops/chol_inv.py``, ``ops/ozaki.py``) takes its
entry points from :func:`library` and declares their argument types.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _sources() -> tuple:
    """The .cu files to compile and every file under csrc/ (headers too)."""
    files = sorted(p for p in _CSRC.rglob("*") if p.is_file())
    return [p for p in files if p.suffix == ".cu"], files


def _build_key() -> str:
    """Hash of every file under csrc/ (names and contents) and the flags."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for p in _sources()[1]:
        h.update(p.relative_to(_CSRC).as_posix().encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernel library if these sources have not been built;
    return its path.  Each .cu is compiled by its own nvcc, all started
    together, and the objects are linked into one library.  Raises with
    the compiler's output when a step fails."""
    out = _BUILD_DIR / f"libmadipm_kernels_{_build_key()}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    compile_flags = [f for f in _NVCC_FLAGS if f != "-shared"]
    objs, procs = [], []
    for src in _sources()[0]:
        obj = _BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [_nvcc(), *compile_flags, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    try:
        for src, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} (rc={proc.returncode}):\n{err}")
        tmp = out.with_name(f"{tag}.tmp")
        link = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link {out.name} (rc={link.returncode}):\n{link.stderr}")
        os.replace(tmp, out)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if need be)."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib
