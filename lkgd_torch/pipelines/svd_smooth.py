"""Long-video smoothing (counterpart of ``lkgd_tpu/pipelines/svd_smooth.py``
``StableVideoDiffusionSmoothPipeline``): SDEdit refinement of an existing video with chunk
boundaries that move at random from step to step.

The whole video is encoded (CLIP embedding and noise-augmented VAE latents of every frame,
since any frame can become a chunk boundary), its clean latents are noised to
``sigmas[start_step]`` and then denoised from ``start_step`` on. At each step the sequence
is placed into a buffer of ``n_chunks * K`` frames (``K`` = ``config.num_frames``) at a
random front offset; positions outside the video repeat its edge frames. Every chunk runs
as a joint [forward, time-flipped] stream pair, the forward stream conditioned on the
chunk's first valid frame and the flipped one on its last, all chunks in one UNet call of
``4 * n_chunks`` stream-major rows ``[fwd, bwd, fwd_cond, bwd_cond]`` (joint mask
``(0, 1, 0, 1)``). Guidance is per frame, ``linspace(min, max, K)``; only the forward
stream's prediction is kept, sliced back at the offset, and one Euler step is taken over
the whole video. ``sequential_cfg`` runs the two CFG sides one after the other through
``unet_seq`` (``[fwd, bwd]`` rows, halved masks).

The loop is a Python loop over ``range(start_step, num_steps)`` where JAX had a
``lax.scan``. Randomness comes from the ``torch.Generator`` passed in or from the
injection hooks ``noise_aug=`` (the video's shape), ``initial_noise=`` (``(1, T, h, w, 4)``)
and ``offsets=`` (``(n_steps,)`` integers in ``[0, K)``), since torch and JAX generators
never agree.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from lkgd_torch.pipelines.svd import StableVideoDiffusionPipeline


class StableVideoDiffusionSmoothPipeline(StableVideoDiffusionPipeline):
    """video ``(T, H, W, 3)`` in [0, 1], ``T = total_frames`` -> the smoothed video
    ``(1, T, H, W, 3)``. ``config.num_frames`` is the chunk window ``K``."""

    deep_cache = False  # the JAX pipeline's loop has none

    def __init__(self, *args, start_step: int = 10, total_frames: int = 50, **kwargs):
        super().__init__(*args, **kwargs)
        self.start_step = start_step
        self.total_frames = total_frames
        chunk = self.config.num_frames
        self.n_chunks = math.ceil((total_frames + chunk - 1) / chunk)

    def _encode_frames(self, video: torch.Tensor) -> torch.Tensor:
        """[-1, 1] ``(T, H, W, 3)`` -> posterior-mode latents ``(T, h, w, 4)``, encoded ``K``
        frames at a time: the encoder works frame by frame, so the chunks change nothing but
        the size of its activations (at 50 frames of 576x1024 a level-0 activation would
        hold 3.8e9 elements)."""
        k = self.config.num_frames
        return torch.cat([self.vae.encode_mode(part.to(self.dtype))
                          for part in video.split(k)])

    def _offsets(self, n_steps: int, generator: torch.Generator,
                 given: Optional[Sequence[int]]) -> list:
        k = self.config.num_frames
        if given is None:
            given = torch.randint(0, k, (n_steps,), generator=generator,
                                  device=generator.device)
        offsets = [int(o) for o in (given.tolist() if torch.is_tensor(given) else given)]
        if len(offsets) != n_steps or not all(0 <= o < k for o in offsets):
            raise ValueError(f"offsets must be {n_steps} integers in [0, {k}), got {offsets}")
        return offsets

    @torch.inference_mode()
    def denoise(self, video: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise_aug: Optional[torch.Tensor] = None,
                initial_noise: Optional[torch.Tensor] = None,
                offsets: Optional[Sequence[int]] = None) -> torch.Tensor:
        """video: [0, 1] ``(T, H, W, 3)`` -> smoothed latents ``(1, T, h, w, 4)`` fp32."""
        cfg, sched, schedule = self.config, self.scheduler, self.schedule
        k, t_total, nc = cfg.num_frames, self.total_frames, self.n_chunks
        padded = nc * k
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        video = video.to(self.device, torch.float32)

        # conditioning for every frame: any frame can become a chunk boundary
        image_embeddings = self._encode_clip(video)  # (T, 1, D)
        video_m11 = video * 2.0 - 1.0
        noise = self._normal(video.shape, generator, noise_aug)
        cond_latents = self._encode_frames(video_m11 + cfg.noise_aug_strength * noise)
        zero_emb = torch.zeros_like(image_embeddings[:1]).expand(nc, -1, -1)
        zero_lat = torch.zeros_like(cond_latents[:1]).expand(nc, -1, -1, -1)

        # the clean latents, noised to sigma[start_step] (SDEdit)
        orig = self._encode_frames(video_m11).float() * self.vae_scaling
        sdedit = self._normal((1, t_total) + tuple(orig.shape[1:]), generator, initial_noise)
        latents = sched.add_noise(schedule, orig[None], sdedit, [self.start_step])[0]

        n_steps = schedule.num_steps - self.start_step
        offsets = self._offsets(n_steps, generator, offsets)
        sequential = cfg.sequential_cfg  # smooth always guides, per frame
        added_time_ids = self._add_time_ids(2 * nc if sequential else 4 * nc)
        g = torch.linspace(cfg.min_guidance_scale, cfg.max_guidance_scale, k,
                           device=self.device)[None, :, None, None, None]
        frame_pos = torch.arange(padded, device=self.device)
        chunk_start = torch.arange(nc, device=self.device) * k
        for i, offset in zip(range(self.start_step, schedule.num_steps), offsets):
            t = schedule.timesteps[i]
            # the video in the padded buffer at the offset; positions outside it repeat the
            # edge frames. Zero frames would be worse twice: the temporal attention would
            # attend to them, and all-zero frames make zero-variance GroupNorm groups whose
            # 1/sqrt(var + eps) blows fp32 noise up ~1e3x per norm layer
            src = torch.clamp(frame_pos - offset, 0, t_total - 1)
            chunks = latents[src].reshape(nc, k, *latents.shape[1:])
            # each chunk's first and last valid frame
            first = torch.clamp(torch.clamp(chunk_start, min=offset) - offset, 0, t_total - 1)
            last = torch.clamp(torch.clamp(chunk_start + k - 1, max=offset + t_total - 1)
                               - offset, 0, t_total - 1)
            streams = torch.cat([chunks, chunks.flip(1)])  # [fwd, bwd]: (2NC, K, h, w, 4)
            cond = torch.cat([cond_latents[first], cond_latents[last]])
            emb = torch.cat([image_embeddings[first], image_embeddings[last]])
            scaled = sched.scale_model_input(schedule, streams, i).to(self.dtype)
            if sequential:
                uncond, condp = (
                    self.unet_seq(torch.cat([scaled, c[:, None].expand(-1, k, -1, -1, -1)],
                                            dim=-1), t, e, added_time_ids).float()
                    for c, e in ((torch.cat([zero_lat, zero_lat]),
                                  torch.cat([zero_emb, zero_emb])), (cond, emb)))
            else:
                cond_rows = torch.cat([zero_lat, zero_lat, cond])
                model_in = torch.cat([torch.cat([scaled, scaled]),
                                      cond_rows[:, None].expand(-1, k, -1, -1, -1)], dim=-1)
                emb_rows = torch.cat([zero_emb, zero_emb, emb])
                uncond, condp = self.unet(model_in, t, emb_rows,
                                          added_time_ids).float().chunk(2)
            noise_pred = uncond + g * (condp - uncond)
            # the forward stream only, back at the offset
            noise_pred = noise_pred[:nc].reshape(padded, *latents.shape[1:])
            noise_pred = noise_pred[offset:offset + t_total]
            latents, _ = sched.step(schedule, noise_pred, i, latents)
        return latents[None]

    def __call__(self, video, generator: Optional[torch.Generator] = None,
                 output_type: str = "np", noise_aug: Optional[torch.Tensor] = None,
                 initial_noise: Optional[torch.Tensor] = None,
                 offsets: Optional[Sequence[int]] = None):
        """video: array or tensor ``(total_frames, H, W, 3)`` in [0, 1] at pipeline size.
        ``output_type`` as in the base pipeline."""
        video = torch.as_tensor(np.asarray(video) if not torch.is_tensor(video) else video,
                                dtype=torch.float32)
        if video.shape[0] != self.total_frames:
            raise ValueError(f"the pipeline was built for {self.total_frames} frames, got "
                             f"{video.shape[0]}")
        latents = self.denoise(video, generator, noise_aug, initial_noise, offsets)
        if output_type == "latent":
            return latents
        frames = self.decode_latents(latents)
        return frames.cpu().numpy() if output_type == "np" else frames
