"""Build the port's CUDA kernels at first use and bind them with ctypes.

``lkgd_torch/csrc/*.cu`` carry a plain C interface (no PyTorch headers), so one ``nvcc``
call compiles them in seconds into a shared library under ``lkgd_torch/_build/`` (listed
in ``.gitignore``). The library's name holds a hash of the sources and flags: an edited
source builds anew, an unchanged one is reused. Pointers and the stream go in as Python
ints from ``tensor.data_ptr()`` and ``torch.cuda.current_stream().cuda_stream``.

Nothing here runs at import: the CPU tests import every module, and this machine has no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "lkgd_flash_block_rows": ([_I], _I),
    "lkgd_flash_fwd": ([_P, _P, _P, _P, ctypes.POINTER(_LL), _I, _I, _I, _I, _I, _F,
                        _P, _P, _P, _I, _I, _P], _I),
    "lkgd_gn_stats": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    "lkgd_gn_apply": ([_P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _I, _P], _I),
    "lkgd_error_string": ([_I], ctypes.c_char_p),
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the nvcc call, None when reused


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin/nvcc: the "
                           "CUDA kernels cannot be built")
    return path


def build() -> Path:
    """Compile ``csrc/*.cu`` for sm_90a unless a library of the same sources exists."""
    global build_seconds
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in SOURCES)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"liblkgd_kernels_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The kernels' shared library, built and loaded on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _lib = lib
    return _lib


def check(err: int) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never runs)."""
    if err:
        raise RuntimeError(f"CUDA kernel launch failed: "
                           f"{library().lkgd_error_string(err).decode()}")
