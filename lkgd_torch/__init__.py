"""lkgd_torch — the PyTorch/CUDA port of lkgd_tpu for one NVIDIA H100.

The JAX package ``lkgd_tpu`` is the reference; this package mirrors its module layout
(``lkgd_torch/models/unet_svd.py`` <-> ``lkgd_tpu/models/unet_svd.py``) and holds the
base image-to-video path of Stable Video Diffusion: CLIP-H conditioning, the temporal VAE,
the spatio-temporal UNet, the Euler-Karras sampler and the pipeline that joins them.
The Pallas TPU kernels on that path are hand-written CUDA kernels for Hopper
(``lkgd_torch/csrc``), built with ``nvcc`` at first use.

It imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
