"""lkgd_torch — the PyTorch/CUDA port of lkgd_tpu for one NVIDIA H100.

The JAX package ``lkgd_tpu`` is the reference; this package mirrors its module layout
(``lkgd_torch/models/unet_svd.py`` <-> ``lkgd_tpu/models/unet_svd.py``) and holds Stable
Video Diffusion image-to-video (CLIP-H conditioning, the temporal VAE, the spatio-temporal
UNet, the Euler-Karras sampler and the pipelines that join them), frame-transition
generation over two streams coupled by joint attention, and the LKGD fine-tune. Every
Pallas TPU kernel of the JAX package is a hand-written CUDA kernel for Hopper
(``lkgd_torch/csrc``), built with ``nvcc`` at first use.

It imports ``torch`` and never ``jax`` nor any module of ``lkgd_tpu``. Its entry points run
on the card unless the caller names the CPU.
"""

__version__ = "0.1.0"
