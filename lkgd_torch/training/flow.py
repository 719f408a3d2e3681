"""Flow-video diffusion training: the batch of UniMatch pseudo-labels (counterpart of
``lkgd_tpu/training/flow.py``; the reference's ``train_svd_of.py``, ``train_svd_of_fix.py``
and ``train_svd_of_lora.py``).

The frozen preprocessing makes the batch that ``make_svd_train_step`` consumes; the EDM
loss is the SVD step's, only what the latents are differs:

- mode "of": latents are the normalised flow-video latents, the condition the first RGB
  frame's latents;
- mode "of_fix": the condition also carries the first transition's flow image, 8 channels
  ``[flow | rgb]`` for the UNet with ``dual_cond_conv_in``;
- joint video+flow (``make_joint_vf_batch``): a video row and its flow row, which the joint
  attention couples.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from lkgd_torch.utils.flow_codec import flow_latent_normalize, flow_to_image_naive

ONE_PAIR = ("make_joint_vf_batch takes one clip: with two or more, the interleaved rows "
            "[v0, f0, v1, f1] meet stream masks that pair rows block-wise, so v0 would be "
            "coupled with v1, not with its own flow (ROADMAP.md Queue 3, 'trans training at "
            "two or more pairs')")


def make_flow_batch_fn(flow_fn: Callable, vae, mode: str = "of", scaling: float = 0.18215,
                       noise_aug: float = 0.02) -> Callable:
    """``prep(frames, image_embeddings, generator=None, noise=None) -> batch``.

    ``flow_fn``: (T+1, H, W, 3) in [0, 1] -> (T, H, W, 2) (``utils.optical_flow.make_flow_fn``).
    ``frames``: (B, T+1, H, W, 3) in [-1, 1]; T flows, hence T latent frames, come out.
    ``noise``: the standard normal (B, H, W, 3) that, times ``noise_aug``, augments the
    conditioning frame, in place of a draw from ``generator``. The batch: ``latents``
    (B, T, h, w, 4) = ``flow_latent_normalize(flow latents * scaling)``, ``cond_latents``
    the UNSCALED posterior mode of the augmented first frame (B, h, w, 4; in "of_fix" the
    first flow image's latents before it, 8 channels), ``image_embeddings`` as given; fp32.
    Runs under ``torch.no_grad()``; the VAE encodes in its own dtype."""
    if mode not in ("of", "of_fix"):
        raise ValueError(f"mode {mode!r}: expected 'of' or 'of_fix'")

    dtype = next(vae.parameters()).dtype

    def encode(x: torch.Tensor) -> torch.Tensor:
        return vae.encode_mode(x.to(dtype)).float()

    @torch.no_grad()
    def prep(frames: torch.Tensor, image_embeddings: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> dict:
        frames = frames.float()
        b, tp1, h, w, _ = frames.shape
        t = tp1 - 1
        flows = torch.stack([flow_fn((clip + 1.0) / 2.0) for clip in frames])  # (B, T, H, W, 2)
        flow_imgs = (flow_to_image_naive(flows) * 2.0 - 1.0).to(frames.device)  # VAE's range
        flow_lat = encode(flow_imgs.reshape(b * t, h, w, 3))
        latents = flow_latent_normalize(flow_lat.reshape(b, t, *flow_lat.shape[1:]) * scaling)

        first = frames[:, 0]
        if noise is None:
            noise = torch.randn(first.shape, generator=generator, device=first.device)
        cond = encode(first + noise.to(first.device).float() * noise_aug)
        if mode == "of_fix":
            cond = torch.cat([encode(flow_imgs[:, 0]), cond], dim=-1)  # flow | rgb
        return {"latents": latents, "cond_latents": cond,
                "image_embeddings": image_embeddings.float()}

    return prep


def make_joint_vf_batch(video_latents: torch.Tensor, flow_latents: torch.Tensor,
                        image_embeddings: torch.Tensor) -> dict:
    """Joint video+flow rows, interleaved ``[v0, f0]`` so that the stream masks pair the
    clip's video row with its flow row; the latents already scaled and normalised (the
    batch takes its ``cond_latents`` from the caller, as the JAX function's does). Train it
    with ``SVDTrainConfig(tie_stream_pairs=True)``, so that the pair shares its sigma. One
    clip only: more is refused (``ONE_PAIR``)."""
    if video_latents.shape[0] != 1:
        raise NotImplementedError(ONE_PAIR)
    lat = torch.stack([video_latents, flow_latents], dim=1)
    return {"latents": lat.reshape(-1, *lat.shape[2:]),
            "image_embeddings": image_embeddings.repeat_interleave(2, dim=0)}
