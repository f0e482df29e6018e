"""(L, L^-1) of SPD matrices: the hand-written CUDA kernel and its wrapper.

The kernel (``csrc/chol_inv.cu``) replaces
``madipm_tpu/ops/pallas_chol.py::pallas_chol_inv``; its source note says
what bounds it on an H100 and how it is laid out.  It is compiled with
``nvcc`` at first use into ``madipm_tpu_torch/_build/`` (a shared library
with a plain C interface, loaded with ``ctypes``), keyed by a hash of the
source and flags so that an edit rebuilds.

:func:`chol_inv` launches the kernel for a CUDA tensor and runs the plain
torch version (``ops/block_chol.chol_inv``) for a CPU tensor; a CUDA
tensor never falls back.  ``launches`` counts kernel launches.
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
        for name in ("madipm_chol_inv_f32", "madipm_chol_inv_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def chol_inv(S: torch.Tensor):
    """(L, L^-1) of SPD ``S`` ((N,N) or (B,N,N)), upper triangles zero;
    NaN where S is not SPD.  CPU tensors take the plain version."""
    if S.device.type == "cpu":
        return block_chol.chol_inv(S)
    if S.device.type != "cuda":
        raise ValueError(f"chol_inv: unsupported device {S.device}")
    if S.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"chol_inv: dtype must be float32 or float64, got {S.dtype}")
    if S.ndim not in (2, 3) or S.shape[-1] != S.shape[-2]:
        raise ValueError(f"chol_inv: expected (N,N) or (B,N,N), got {tuple(S.shape)}")
    n = S.shape[-1]
    if n == 0 or n % PANEL != 0:
        raise ValueError(f"chol_inv: N={n} must be a positive multiple of {PANEL}")
    if not S.is_contiguous():
        raise ValueError("chol_inv: S must be contiguous")
    S3 = S.unsqueeze(0) if S.ndim == 2 else S
    if S3.shape[0] == 0:
        raise ValueError("chol_inv: empty batch")
    L = torch.empty_like(S3)
    W = torch.empty_like(S3)
    lib = _load()
    fn = lib.madipm_chol_inv_f32 if S.dtype == torch.float32 else lib.madipm_chol_inv_f64
    with torch.cuda.device(S.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(S3.data_ptr(), L.data_ptr(), W.data_ptr(), S3.shape[0], n, stream)
    if rc != 0:
        raise RuntimeError(f"chol_inv: CUDA kernel launch failed with cudaError {rc}")
    global launches
    launches += 1
    if S.ndim == 2:
        return L[0], W[0]
    return L, W
