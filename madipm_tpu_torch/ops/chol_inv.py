"""Cholesky factors of SPD matrices: the hand-written CUDA kernels and their
wrappers.

``csrc/chol_inv.cu`` holds two entry points over one blocked sweep:
(L, L^-1), which replaces
``madipm_tpu/ops/pallas_chol.py::pallas_chol_inv``, and L alone, which
replaces ``pallas_cholesky``; the source note says what bounds them on an
H100 and how they are laid out.  The file is compiled with ``nvcc`` at
first use into ``madipm_tpu_torch/_build/`` (a shared library with a plain
C interface, loaded with ``ctypes``), keyed by a hash of the source and
flags so that an edit rebuilds.

:func:`chol_inv` and :func:`cholesky` launch their kernel for a CUDA tensor
and run the plain torch version (``ops/block_chol``) for a CPU tensor; a
CUDA tensor never falls back.  ``launches`` and ``cholesky_launches`` count
the kernel launches of each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import block_chol

#: panel width of the kernel: N must be a multiple of it
PANEL = 32

#: number of times :func:`chol_inv` launched the CUDA kernel
launches = 0
#: number of times :func:`cholesky` launched the CUDA kernel
cholesky_launches = 0

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "chol_inv.cu"
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


def build() -> Path:
    """Compile the kernel library if this source has not been built; return
    its path.  Raises with the compiler's output when the build fails."""
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"libchol_inv_{key}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SRC} (rc={proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name in ("madipm_chol_inv_f32", "madipm_chol_inv_f64",
                     "madipm_cholesky_f32", "madipm_cholesky_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _stack_for_kernel(S: torch.Tensor, name: str) -> torch.Tensor:
    """Check what the kernels take and return ``S`` as a (B, N, N) stack."""
    if S.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {S.device}")
    if S.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype must be float32 or float64, got {S.dtype}")
    if S.ndim not in (2, 3) or S.shape[-1] != S.shape[-2]:
        raise ValueError(f"{name}: expected (N,N) or (B,N,N), got {tuple(S.shape)}")
    n = S.shape[-1]
    if n == 0 or n % PANEL != 0:
        raise ValueError(f"{name}: N={n} must be a positive multiple of {PANEL}")
    if not S.is_contiguous():
        raise ValueError(f"{name}: S must be contiguous")
    S3 = S.unsqueeze(0) if S.ndim == 2 else S
    if S3.shape[0] == 0:
        raise ValueError(f"{name}: empty batch")
    return S3


def _launch(fn_name: str, S3: torch.Tensor, L: torch.Tensor, W: torch.Tensor):
    """Enqueue one kernel call on the current stream of ``S3``'s device."""
    suffix = "f32" if S3.dtype == torch.float32 else "f64"
    fn = getattr(_load(), f"madipm_{fn_name}_{suffix}")
    with torch.cuda.device(S3.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(S3.data_ptr(), L.data_ptr(), W.data_ptr(), S3.shape[0], S3.shape[-1], stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA kernel launch failed with cudaError {rc}")


def chol_inv(S: torch.Tensor):
    """(L, L^-1) of SPD ``S`` ((N,N) or (B,N,N)), upper triangles zero;
    NaN where S is not SPD.  CPU tensors take the plain version."""
    if S.device.type == "cpu":
        return block_chol.chol_inv(S)
    S3 = _stack_for_kernel(S, "chol_inv")
    L = torch.empty_like(S3)
    W = torch.empty_like(S3)
    _launch("chol_inv", S3, L, W)
    global launches
    launches += 1
    if S.ndim == 2:
        return L[0], W[0]
    return L, W


def cholesky(S: torch.Tensor) -> torch.Tensor:
    """L of SPD ``S`` ((N,N) or (B,N,N)), upper triangle zero; NaN where S
    is not SPD.  No inverse is formed.  CPU tensors take the plain version."""
    if S.device.type == "cpu":
        return block_chol.cholesky(S)
    S3 = _stack_for_kernel(S, "cholesky")
    L = torch.empty_like(S3)
    # the one inverted diagonal tile per instance that the panel step reads
    tile = torch.empty(S3.shape[0], PANEL, PANEL, dtype=S3.dtype, device=S3.device)
    _launch("cholesky", S3, L, tile)
    global cholesky_launches
    cholesky_launches += 1
    return L[0] if S.ndim == 2 else L
