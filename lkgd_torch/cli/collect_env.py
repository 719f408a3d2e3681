"""Environment report for bug reports (counterpart of ``lkgd_tpu/cli/collect_env.py``, for
CUDA): versions of Python, torch, CUDA, cuDNN, Triton, numpy and the other packages the port
reads; ``nvcc --version``; the CUTLASS headers; the ``LKGD_*`` variables; the kernels' build
directory (``lkgd_torch/_build/``, where the JAX package reports its compilation cache); and
the card's name, power limit, SM count and memory.

  python -m lkgd_torch.cli.collect_env [--no-device]

Package versions come from their installed metadata: no package is imported to read its
version (importing JAX or transformers would load them, which the port never does).
``--no-device`` reports versions only; without it the card is required.
"""

from __future__ import annotations

import argparse
import os
import platform
import re
import shutil
import subprocess
import sys
from importlib import metadata
from pathlib import Path

import torch

from lkgd_torch.utils.device import require_device

PACKAGES = ("numpy", "triton", "scipy", "safetensors", "einops", "opencv-python",
            "opencv-python-headless", "pillow", "imageio", "tensorboard", "wandb", "gradio")


def _version(dist_name: str) -> str:
    try:
        return metadata.version(dist_name)
    except metadata.PackageNotFoundError:
        return "not installed"


def _run(cmd) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({type(e).__name__})"
    text = (out.stdout or out.stderr).strip()
    return text if out.returncode == 0 else f"failed ({out.returncode}): {text[-200:]}"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        return "not found"
    last = _run([path, "--version"]).splitlines()
    return f"{path}: {last[-1] if last else ''}"


def _cutlass() -> str:
    root = Path(os.environ.get("CUTLASS_PATH", "/usr/local/cutlass")) / "include"
    header = root / "cutlass" / "version.h"
    if not header.is_file():
        return f"{root} (absent)"
    parts = dict(re.findall(r"#define CUTLASS_(MAJOR|MINOR|PATCH) (\d+)", header.read_text()))
    version = ".".join(parts.get(k, "?") for k in ("MAJOR", "MINOR", "PATCH"))
    return f"{root} ({version})"


def _build_dir() -> str:
    path = Path(__file__).resolve().parents[1] / "_build"
    if not path.is_dir():
        return f"{path} (absent: the kernels build at first use)"
    return f"{path} ({len(list(path.iterdir()))} entries)"


def collect(probe_device: bool = True) -> dict:
    info = {
        "python": sys.version.replace("\n", " "),
        "platform": platform.platform(),
        "machine": platform.machine(),
        "torch": torch.__version__,
        "torch CUDA": torch.version.cuda or "none (CPU build)",
        "cuDNN": str(torch.backends.cudnn.version()) if torch.backends.cudnn.is_available()
        else "none",
        **{name: _version(name) for name in PACKAGES},
        "nvcc": _nvcc(),
        "CUTLASS headers": _cutlass(),
        "kernel build directory": _build_dir(),
        "env:CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES", "<unset>"),
        "env:LKGD_*": {k: v for k, v in os.environ.items() if k.startswith("LKGD_")}
        or "<none>",
    }
    if probe_device:
        device = require_device("cuda")
        props = torch.cuda.get_device_properties(device)
        info["devices"] = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        info["device0"] = (f"{props.name}, sm_{props.major}{props.minor}, "
                           f"{props.multi_processor_count} SMs, "
                           f"{props.total_memory / 2**30:.1f} GiB")
        info["nvidia-smi name, power limit"] = _run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return info


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-device", action="store_true",
                    help="versions only: no card is asked for")
    args = ap.parse_args(argv)
    for k, v in collect(probe_device=not args.no_device).items():
        print(f"{k:28s}: {v}")


if __name__ == "__main__":
    main()
