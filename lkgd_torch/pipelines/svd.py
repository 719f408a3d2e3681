"""Stable Video Diffusion image-to-video, base mode (counterpart of
``lkgd_tpu/pipelines/svd.py`` ``StableVideoDiffusionPipeline``).

Stages, as in the JAX package: CLIP-H embedding of the antialiased 224^2 resize, VAE
``encode_mode`` of the noise-augmented frame, a CFG-doubled loop of Euler-Karras steps over
the UNet (a Python loop where JAX had ``lax.scan``), and an equal-chunked temporal VAE
decode. With ``sequential_cfg`` the two CFG halves go through the UNet one after the other
(``unet_seq``: the same parameters, stream masks halved): the same work with a lower
peak of activation memory in the loop. With ``deep_cache_interval`` ``dc > 1`` (DeepCache,
base pipeline only) step ``i`` runs the full UNet when ``i % dc == 0`` and refreshes the
cached input of its last up block; the other steps run the cached UNet (a Python ``if``
where JAX had ``lax.cond``). It is an approximation: the output changes. Layouts at the
public methods are the JAX package's: images ``(B, H, W, 3)`` in [0, 1], latents
``(B, T, h, w, 4)``, frames ``(B, T, H, W, 3)``.

``mesh`` (``parallel/mesh.py``; ``lkgd_tpu/pipelines/svd.py:85-92, 299-340``): in the
base pipeline's loop, at each step, the CFG-doubled rows split over its ``data`` axis and
the frames over its ``context`` axis (the UNet's temporal halves gather the frames:
``models/blocks_svd.py``), the predictions all-gathered before the guidance combine; the
latents and the scheduler stay replicated. The subclasses' loops, like their JAX
counterparts', split nothing: each rank runs the whole loop. In every class the equal-chunk
decode spreads its chunks over ``context`` when their number divides by it (chunk
``g * ctx + j`` on rank ``j``), the frames all-gathered after, and decodes them whole on
each rank otherwise. The ``model`` axis splits the weights (``parallel/tp.py``
``fully_shard``, applied to the models by the caller).

Randomness comes only from the ``torch.Generator`` passed in, or from pre-drawn standard
normals (``noise_aug=``, ``initial_noise=``) — the hook the parity tests use, since torch
and JAX generators never agree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from lkgd_torch.models.clip_vision import CLIPVisionModelWithProjection, clip_normalize
from lkgd_torch.models.configs import (CLIPVisionConfig, SVDUNetConfig, TemporalVAEConfig,
                                       halve_stream_masks)
from lkgd_torch.models.layers import init_params, materialize, share_parameters
from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition
from lkgd_torch.models.vae_temporal import AutoencoderKLTemporalDecoder
from lkgd_torch.ops.resize import resize_with_antialiasing
from lkgd_torch.parallel import mesh as meshlib
from lkgd_torch.parallel.sequence import all_gather, cfg_parallel_split, shard
from lkgd_torch.schedulers.euler_discrete import EulerDiscreteConfig, EulerDiscreteScheduler
from lkgd_torch.utils.device import require_device


@dataclasses.dataclass(frozen=True)
class SVDPipelineConfig:
    """Generation settings, defaults as in the JAX package."""

    height: int = 576
    width: int = 1024
    num_frames: int = 14
    num_inference_steps: int = 25
    min_guidance_scale: float = 1.0
    max_guidance_scale: float = 3.0
    fps: int = 7
    motion_bucket_id: int = 127
    noise_aug_strength: float = 0.02
    decode_chunk_size: int = 7
    do_classifier_free_guidance: bool = True
    # run the two CFG halves one after the other instead of batch-doubled: the same work,
    # a lower peak of activation memory in the loop
    sequential_cfg: bool = False
    # DeepCache: every dc-th step runs the full UNet, the steps between reuse its deep
    # feature; 1 = off (the exact path). Approximate when > 1. The base pipeline's alone.
    deep_cache_interval: int = 1


def as_batch(x) -> Optional[torch.Tensor]:
    """An array or tensor, ``(B, H, W, C)`` or one ``(H, W, C)``, as a float32 batch;
    None stays None."""
    if x is None:
        return None
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, dtype=torch.float32)
    return x[None] if x.dim() == 3 else x


def equal_chunks(n: int, max_chunk: int) -> int:
    """Largest divisor of n that is <= max_chunk (equal-shape decode chunks)."""
    for c in range(min(max_chunk, n), 0, -1):
        if n % c == 0:
            return c
    return n


def _check_splittable(config: SVDPipelineConfig, unet_config: SVDUNetConfig) -> None:
    """The ``data`` and ``context`` axes split the base loop's batched CFG rows and its
    frames: sequential CFG, DeepCache, stream masks or joint attention (which pair rows and
    reverse frames) are refused."""
    if config.sequential_cfg or config.deep_cache_interval > 1:
        raise ValueError("the mesh's data and context axes split the batched CFG loop: "
                         "sequential_cfg and deep_cache_interval > 1 are refused with them")
    if unet_config.joint is not None or unet_config.y_input_head_mask is not None or any(
            rule.streams for rule in unet_config.lora.rules):
        raise ValueError("the mesh's data and context axes split rows and frames: a UNet "
                         "with joint attention or stream masks pairs them, and is refused")


class StableVideoDiffusionPipeline:
    """Image -> video. The models are allocated on ``device`` (the card unless another is
    named; with no card and no explicit ``"cpu"`` the constructor raises) in ``dtype`` with
    uninitialised weights: fill them with ``init_params(generator)`` or
    ``<model>.load_state_dict(...)``. ``models``: ``(unet, vae, image_encoder)`` already
    built on ``device`` (a trainer's, for validation), run as they are: nothing is
    allocated or copied, and their ``requires_grad`` flags are left alone.

    Subclasses whose JAX counterparts run a loop of their own set ``base_loop = False``:
    they refuse a ``deep_cache_interval`` above 1, which those counterparts ignore, and the
    mesh spreads their decode alone."""

    base_loop = True

    def __init__(
        self,
        config: SVDPipelineConfig = SVDPipelineConfig(),
        unet_config: SVDUNetConfig = SVDUNetConfig(),
        vae_config: TemporalVAEConfig = TemporalVAEConfig(),
        clip_config: CLIPVisionConfig = CLIPVisionConfig(),
        scheduler_config: EulerDiscreteConfig = EulerDiscreteConfig.svd(),
        dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        models: Optional[tuple] = None,
        mesh: Optional[meshlib.Mesh] = None,
    ):
        if config.deep_cache_interval > 1 and not self.base_loop:
            raise ValueError(f"{type(self).__name__} has no DeepCache loop: "
                             f"deep_cache_interval must be 1, got {config.deep_cache_interval}")
        axes = {} if mesh is None else mesh.axes
        data, context = (mesh.groups[a] if axes.get(a, 1) > 1 else None
                         for a in (meshlib.DATA_AXIS, meshlib.CONTEXT_AXIS))
        # the decode's chunks spread over context in every class; the loop's rows and
        # frames split in the base loop alone
        self.decode_group = context
        self.data_group, self.context_group = (data, context) if self.base_loop else (None, None)
        if self.data_group is not None or self.context_group is not None:
            _check_splittable(config, unet_config)
        self.config = config
        self.dtype = dtype
        self.device = require_device(device)
        if models is None:
            self.unet = materialize(lambda: UNetSpatioTemporalCondition(unet_config),
                                    self.device, dtype)
            self.vae = materialize(lambda: AutoencoderKLTemporalDecoder(vae_config),
                                   self.device, dtype)
            self.image_encoder = materialize(
                lambda: CLIPVisionModelWithProjection(clip_config), self.device, dtype)
            for model in self.models:
                model.eval().requires_grad_(False)
        else:
            self.unet, self.vae, self.image_encoder = models
        self.unet_seq = None
        if config.sequential_cfg:
            # the same parameters under the stream masks of one CFG side
            with torch.device("meta"):
                seq = UNetSpatioTemporalCondition(halve_stream_masks(unet_config))
            self.unet_seq = share_parameters(self.unet, seq).eval()
        if self.context_group is not None:
            for m in self.unet.modules():
                if hasattr(m, "frame_group"):
                    m.frame_group = self.context_group
        self.scheduler = EulerDiscreteScheduler(scheduler_config)
        self.schedule = self.scheduler.set_timesteps(config.num_inference_steps, self.device)
        self.vae_scaling = vae_config.scaling_factor
        vae_scale_factor = 2 ** (len(vae_config.block_out_channels) - 1)
        self.latent_height = config.height // vae_scale_factor
        self.latent_width = config.width // vae_scale_factor

    @property
    def models(self):
        return (self.unet, self.vae, self.image_encoder)

    def init_params(self, generator: torch.Generator) -> None:
        """Random weights at the configured shapes, drawn from ``generator`` only."""
        for model in self.models:
            init_params(model, generator)

    # ------------------------------------------------------------------ conditioning
    def _encode_clip(self, image: torch.Tensor) -> torch.Tensor:
        """[0,1] (B,H,W,3) -> CLIP image embeddings (B, 1, D): [-1,1] -> antialiased
        224^2 -> [0,1] -> CLIP normalise -> vision tower."""
        size = self.image_encoder.config.image_size
        x = resize_with_antialiasing(image * 2.0 - 1.0, (size, size))
        x = clip_normalize((x + 1.0) / 2.0)
        return self.image_encoder(x.to(self.dtype))[:, None, :]

    def _add_time_ids(self, batch_size: int) -> torch.Tensor:
        cfg = self.config
        ids = torch.tensor([[cfg.fps - 1, cfg.motion_bucket_id, cfg.noise_aug_strength]],
                           dtype=torch.float32, device=self.device)
        return ids.repeat(batch_size, 1)

    def _guidance_scale(self, batch_size: int) -> torch.Tensor:
        cfg = self.config
        g = torch.linspace(cfg.min_guidance_scale, cfg.max_guidance_scale, cfg.num_frames,
                           device=self.device)
        return g[None].repeat(batch_size, 1)[..., None, None, None]  # (B, T, 1, 1, 1)

    def _normal(self, shape, generator: torch.Generator, given: Optional[torch.Tensor]):
        if given is not None:
            return given.to(self.device, torch.float32)
        return torch.randn(shape, generator=generator, device=self.device)

    # ------------------------------------------------------------------ generation
    def _cfg_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``[zeros | x]`` (the unconditional rows first) under CFG, else ``x``."""
        if self.config.do_classifier_free_guidance:
            return torch.cat([torch.zeros_like(x), x])
        return x

    def _augmented_latents(self, image: torch.Tensor, generator: torch.Generator,
                           noise: Optional[torch.Tensor]) -> torch.Tensor:
        """[0,1] (B, H, W, 3) -> posterior-mode latents (B, h, w, 4) of the image in [-1, 1]
        plus ``noise_aug_strength`` x a standard normal (``noise``, or drawn)."""
        image_m11 = image * 2.0 - 1.0
        noise = self._normal(image.shape, generator, noise)
        return self.vae.encode_mode((image_m11 + self.config.noise_aug_strength * noise)
                                    .to(self.dtype))

    def _condition(self, image: torch.Tensor, generator: torch.Generator,
                   noise_aug: Optional[torch.Tensor]):
        """CLIP embeddings, VAE latents of the noise-augmented image (expanded over the
        frames) and added time ids, CFG-doubled stream-major ``[uncond | cond]``."""
        image_embeddings = self._cfg_rows(self._encode_clip(image))
        image_latents = self._cfg_rows(self._augmented_latents(image, generator, noise_aug))
        image_latents = image_latents[:, None].expand(-1, self.config.num_frames, -1, -1, -1)
        return image_embeddings, image_latents, self._add_time_ids(image_embeddings.shape[0])

    def _initial_latents(self, streams: int, generator: torch.Generator,
                         initial_noise: Optional[torch.Tensor]) -> torch.Tensor:
        shape = (streams, self.config.num_frames, self.latent_height, self.latent_width, 4)
        return self._normal(shape, generator, initial_noise) * self.schedule.init_noise_sigma

    def _predict(self, unet, model_in: torch.Tensor, t, emb: torch.Tensor, ati: torch.Tensor,
                 extra) -> torch.Tensor:
        """One UNet call on ``model_in`` (latents joined with the conditioning channels);
        ``extra``: the rows of a subclass's per-row input (None here)."""
        return unet(model_in, t, emb, ati)

    def _loop(self, latents: torch.Tensor, image_embeddings: torch.Tensor,
              cond_latents: torch.Tensor, added_time_ids: torch.Tensor,
              extra: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The Euler loop with CFG: batched (``[uncond | cond]`` rows in one call), with
        ``sequential_cfg`` one half after the other through ``unet_seq``, or with DeepCache.
        ``cond_latents`` are joined to the scaled latents on the channel axis; ``extra``,
        CFG-doubled like them, reaches ``_predict``."""
        cfg = self.config
        cfg_rows = 2 if cfg.do_classifier_free_guidance else 1
        guidance = self._guidance_scale(latents.shape[0])
        sequential = cfg.sequential_cfg and cfg.do_classifier_free_guidance
        dc = cfg.deep_cache_interval
        if dc > 1 and sequential:
            raise ValueError("deep_cache_interval and sequential_cfg are mutually exclusive "
                             "(the cache spans the CFG-doubled batch)")
        halves = [x.chunk(2) if x is not None else (None, None)
                  for x in (image_embeddings, cond_latents, added_time_ids, extra)]
        cache = None
        for i in range(self.schedule.num_steps):
            t = self.schedule.timesteps[i]
            if sequential:
                # stream-major halves [uncond | cond], each through the half-batch UNet
                scaled = self.scheduler.scale_model_input(self.schedule, latents, i)
                scaled = scaled.to(self.dtype)
                uncond, cond = (
                    self._predict(self.unet_seq, torch.cat([scaled, lat], dim=-1), t, emb, ati,
                                  ext).float()
                    for emb, lat, ati, ext in zip(*halves))
                noise_pred = uncond + guidance * (cond - uncond)
            else:
                model_in = torch.cat([latents] * cfg_rows)
                model_in = self.scheduler.scale_model_input(self.schedule, model_in, i)
                model_in = torch.cat([model_in.to(self.dtype), cond_latents], dim=-1)
                if dc > 1:  # DeepCache: a full step every dc-th, cached steps between
                    noise_pred, cache = self.unet(
                        model_in, t, image_embeddings, added_time_ids,
                        deep_cache=None if i % dc == 0 else cache, return_deep_feature=True)
                elif self.data_group is not None or self.context_group is not None:
                    noise_pred = self._predict_split(model_in, t, image_embeddings,
                                                     added_time_ids)
                else:
                    noise_pred = self._predict(self.unet, model_in, t, image_embeddings,
                                               added_time_ids, extra)
                noise_pred = noise_pred.float()
                if cfg.do_classifier_free_guidance:
                    uncond, cond = noise_pred.chunk(2)
                    noise_pred = uncond + guidance * (cond - uncond)
            latents, _ = self.scheduler.step(self.schedule, noise_pred, i, latents)
        return latents

    def _predict_split(self, model_in: torch.Tensor, t, emb: torch.Tensor,
                       ati: torch.Tensor) -> torch.Tensor:
        """One UNet call on this rank's block of the rows (``data``) and of the frames
        (``context``), the prediction all-gathered over both."""
        data, context = self.data_group, self.context_group
        if data is not None:
            model_in, emb, ati = (cfg_parallel_split(x, data) for x in (model_in, emb, ati))
        if context is not None:
            model_in = shard(model_in, 1, context, "frames")
        pred = self.unet(model_in, t, emb, ati)
        if context is not None:
            pred = all_gather(pred, 1, context)
        return pred if data is None else all_gather(pred, 0, data)

    @torch.inference_mode()
    def denoise(self, image: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise_aug: Optional[torch.Tensor] = None,
                initial_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """image: [0,1] (B, H, W, 3) -> denoised latents (B, T, h, w, 4) fp32.

        ``noise_aug`` / ``initial_noise``: pre-drawn standard normals of the image's and the
        latents' shape, in place of draws from ``generator``."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        image = image.to(self.device, torch.float32)
        image_embeddings, image_latents, added_time_ids = self._condition(
            image, generator, noise_aug)
        latents = self._initial_latents(image.shape[0], generator, initial_noise)
        return self._loop(latents, image_embeddings, image_latents, added_time_ids)

    @torch.inference_mode()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, T, h, w, 4) -> [0,1] frames (B, T, H, W, 3) fp32, decoded in equal chunks of
        frames (each chunk one temporal decode)."""
        cfg = self.config
        b, t = latents.shape[:2]
        chunk = equal_chunks(t, cfg.decode_chunk_size)
        z = (latents.to(self.device, torch.float32) / self.vae_scaling).to(self.dtype)
        z = z.reshape(b * t // chunk, chunk, *latents.shape[2:])
        pg = self.decode_group
        if pg is not None and len(z) % dist.get_world_size(pg) == 0:
            # chunk g * ctx + j on rank j, then every rank's chunks back in order
            ctx, j = dist.get_world_size(pg), dist.get_rank(pg)
            mine = torch.stack([self.vae.decode(zc, chunk) for zc in z[j::ctx]])
            frames = all_gather(mine[:, None], 1, pg).flatten(0, 2)
        else:
            frames = torch.cat([self.vae.decode(zc, chunk) for zc in z])
        frames = frames.reshape(b, t, cfg.height, cfg.width, 3)
        return torch.clamp(frames.float() / 2.0 + 0.5, 0.0, 1.0)

    def generate(self, image: torch.Tensor, generator: Optional[torch.Generator] = None,
                 noise_aug: Optional[torch.Tensor] = None,
                 initial_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Denoise, then decode: [0,1] (B, H, W, 3) -> frames (B, T, H, W, 3)."""
        return self.decode_latents(self.denoise(image, generator, noise_aug, initial_noise))

    def __call__(self, image, generator: Optional[torch.Generator] = None,
                 output_type: str = "np", noise_aug: Optional[torch.Tensor] = None,
                 initial_noise: Optional[torch.Tensor] = None):
        """image: array or tensor (B, H, W, 3) or (H, W, 3) in [0,1] at pipeline size.
        ``output_type``: "np" frames, "pt" frames tensor, "latent" latents tensor."""
        image = as_batch(image)
        if output_type == "latent":
            return self.denoise(image, generator, noise_aug, initial_noise)
        frames = self.generate(image, generator, noise_aug, initial_noise)
        return frames.cpu().numpy() if output_type == "np" else frames
