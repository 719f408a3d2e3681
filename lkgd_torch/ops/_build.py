"""Build the port's CUDA kernels at first use and bind them with ctypes.

``lkgd_torch/csrc/*.cu`` carry a plain C interface (no PyTorch headers). One ``nvcc`` per
source, all started together, compiles them to objects in seconds; one more links them into
a shared library under ``lkgd_torch/_build/`` (listed in ``.gitignore``). The library's
name holds a hash of the sources, the shared headers (``*.cuh``) and the flags: an edited
source builds anew, an unchanged one is reused. Pointers and the stream go in as Python
ints from ``tensor.data_ptr()`` and the current stream's handle.

Nothing here runs at import: the CPU tests import every module, and a machine without a
card has no ``nvcc``.

``python -m lkgd_torch.ops._build`` prints what ``nvcc -Xptxas -v`` says of every kernel:
registers, spills, shared memory and ptxas's warnings.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
HEADERS = tuple(sorted((_PKG / "csrc").glob("*.cuh")))
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
              "-fPIC")

_P, _I, _LL, _F, _B = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                       ctypes.c_char_p)
_SIGNATURES = {
    "lkgd_flash_block_rows": ([_I, _I], _I),
    "lkgd_flash_smem_bytes": ([_I], _I),
    # packed int64 records go in as bytes (c_char_p): one pointer, no ctypes array to build
    "lkgd_flash_forward": ([_P] * 4 + [_B] + [_I] * 5 + [_F, _P, _P, _P, _I, _I, _I, _P], _I),
    "lkgd_flash_key_sq_max": ([_P, ctypes.POINTER(_LL), _I, _I, _I, _I, _P, _I, _I, _P], _I),
    "lkgd_flash_f32_block_rows": ([_I], _I),
    "lkgd_flash_f32_smem_bytes": ([_I], _I),
    "lkgd_flash_f32_stages": ([_I], _I),
    "lkgd_flash_f32_scratch_floats": ([_I] * 5, _LL),
    "lkgd_flash_bwd_block_rows": ([_I, _I], _I),
    "lkgd_flash_bwd_smem_bytes": ([_I, _I], _I),
    "lkgd_flash_bwd_stages": ([_I, _I], _I),
    "lkgd_flash_bwd_slices": ([_I, _I], _I),
    "lkgd_flash_bwd": ([_P] * 9 + [ctypes.POINTER(_LL), _I, _I, _I, _I, _I, _F, _F, _I, _I,
                                   _P], _I),
    "lkgd_flash_bwd_f32_block_rows": ([_I], _I),
    "lkgd_flash_bwd_f32_smem_bytes": ([_I, _I], _I),
    "lkgd_flash_bwd_f32_stages": ([_I, _I], _I),
    "lkgd_flash_bwd_f32_slices": ([_I, _I], _I),
    "lkgd_flash_bwd_f32_scratch_floats": ([_I] * 5, _LL),
    "lkgd_flash_bwd_f32": ([_P] * 9 + [ctypes.POINTER(_LL), _I, _I, _I, _I, _I, _F, _F, _I,
                                       _P, _I, _P], _I),
    "lkgd_group_norm": ([_P] * 5 + [_B, _F, _I, _P], _I),
    "lkgd_gn_apply": ([_P] * 4 + [_B, _I, _P], _I),
    "lkgd_gn_one_pass": ([_P] * 5 + [_B, _F, _I, _P], _I),
    "lkgd_relayout_heads": ([_I, _I, _B, _P, _I, _I, _I, _I, _P], _I),
    "lkgd_matmul_plan": ([_I, _I, _I, _I, ctypes.POINTER(_I)], _I),
    "lkgd_blocked_matmul": ([_P, _P, _P, _I, _I, _I, _I, _P], _I),
    "lkgd_flash_variant_plan": ([_I, _I, _I, _I, ctypes.POINTER(_I)], _I),
    "lkgd_flash_variant": ([_P, _P, _P, _P, _P, ctypes.POINTER(_LL), _I, _I, _I, _I, _F, _I,
                            _I, _I, _I, _P], _I),
    "lkgd_error_string": ([_I], ctypes.c_char_p),
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the nvcc calls, None when reused


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin/nvcc: the "
                           "CUDA kernels cannot be built")
    return path


def _run_all(cmds) -> None:
    """Run the commands at once and wait for all; raise with the stderr of any that fail."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    errors = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)} ({proc.returncode}):\n{err}")
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))


def build() -> Path:
    """Compile ``csrc/*.cu`` for sm_90a unless a library of the same sources exists."""
    global build_seconds
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in SOURCES + HEADERS)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"liblkgd_kernels_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{digest}.{os.getpid()}"
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in SOURCES]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(SOURCES, objects)])
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]])
    build_seconds = time.perf_counter() - t0
    for obj in objects:
        obj.unlink()
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


def _kernel_name(mangled: str) -> str:
    """A kernel's demangled name without its namespace and parameters."""
    name = subprocess.run(["c++filt", mangled], capture_output=True,
                          text=True).stdout.strip() or mangled
    return name.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]


def ptxas_report() -> str:
    """``-Xptxas -v`` of every source: one line a kernel (demangled name, registers, spill
    bytes, static shared memory), and every warning ptxas gave, with the kernels it names
    demangled."""
    nvcc, lines = _nvcc(), []
    with tempfile.TemporaryDirectory() as tmp:
        for src in SOURCES:
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                                   os.path.join(tmp, src.stem + ".o"), str(src)],
                                  capture_output=True, text=True, check=True)
            name = ""
            for line in proc.stderr.splitlines():
                if "Compiling entry function" in line:
                    name = _kernel_name(line.split("'")[1])
                elif "spill" in line:
                    spills = line.strip()
                elif "Used" in line and "registers" in line:
                    lines.append(f"{src.name} {name}: {line.split(':', 1)[1].strip()}; {spills}")
                elif "warning" in line.lower() or "Potential Performance Loss" in line:
                    line = re.sub(r"_Z\w+", lambda m: _kernel_name(m.group()), line.strip())
                    lines.append(f"{src.name}: {line[:300]}")
    return "\n".join(lines)


if __name__ == "__main__":
    print(ptxas_report())
