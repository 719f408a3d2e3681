"""The CogVideoX causal 3D VAE (counterpart of ``lkgd_tpu/models/vae_cogvideox.py``).

Causal 3D convolutions (time front-padded with the replicated first frame, so frame t never
sees a later one), a spatial 2x down- or upsampling between levels, 4x temporal compression
in two causal 2x steps that keep the first frame uncompressed, GroupNorm(32, eps 1e-6) with
a fused SiLU over a sample's whole clip (``models/layers.GroupNorm``: kernels 3 and 4).

Layout: videos (B, T, H, W, C) channels-last; a convolution runs on the (B, C, T, H, W)
view of that memory (``channels_last_3d``). Latent frames = (T - 1) / 4 + 1.

Streaming: ``encode_mode`` / ``decode`` take an optional conv ``cache``, a dict the caller
holds across chunks (the JAX package's flax ``"cache"`` collection): an empty dict starts a
clip (replicate padding, the clip's first frame uncompressed) and is filled with each causal
convolution's last kt-1 input frames; a filled one continues the clip exactly. GroupNorm
statistics are then per chunk, as in the JAX package and diffusers.

No convolution call holds more than 2^31 elements in its input or output (the limit of
cuDNN's 32-bit indexing): a causal convolution splits its output frames into equal runs,
each reading its kt-1 frames before (exact: an output frame reads kt padded input
frames), and a per-frame 2D convolution splits its frames. At 49x480x720 the decoder's last
level holds 1x49x480x720x128 = 2.17e9 elements.

Parameter names are the JAX package's export names (``encoder.down_0_res_0.conv1.conv``,
``decoder.up_2_upsample``), the names its CLI reads from ``vae_3d.safetensors``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn

from lkgd_torch.models.configs import CogVideoXVAEConfig
from lkgd_torch.models.layers import GroupNorm

MAX_ELEMENTS = 2 ** 31 - 1  # the most a convolution's input or output may hold


def _runs(total: int, per_item: int, extra: int = 0) -> int:
    """Items per call so that ``(items + extra) * per_item`` stays within MAX_ELEMENTS,
    evened out over the calls."""
    most = max(1, MAX_ELEMENTS // per_item - extra)
    calls = math.ceil(total / most)
    return math.ceil(total / calls)


class CausalConv3d(nn.Module):
    """3D convolution with causal temporal padding (``conv``: a ``Conv3d`` with spatial
    padding ((kh-1)//2, kw//2) and none in time)."""

    def __init__(self, in_channels: int, out_channels: int, kernel=(3, 3, 3)):
        super().__init__()
        kt, kh, kw = kernel
        if kh % 2 == 0 or kw % 2 == 0:
            raise ValueError("CausalConv3d takes odd spatial kernels (symmetric padding)")
        self.kt = kt
        self.conv = nn.Conv3d(in_channels, out_channels, kernel,
                              padding=(0, (kh - 1) // 2, (kw - 1) // 2))

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None) -> torch.Tensor:
        """x: (B, T, H, W, C). ``cache``: None (a whole clip), or the caller's dict, where
        this convolution finds its front frames (else the first frame replicated) and leaves
        the last kt-1 input frames for the next chunk."""
        kt = self.kt
        front = x[:, :0]
        if kt > 1:
            front = None if cache is None else cache.get(self)
            if front is None:
                front = x[:, :1].expand(-1, kt - 1, -1, -1, -1)
            if cache is not None:
                tail = (x[:, -(kt - 1):] if x.shape[1] >= kt - 1
                        else torch.cat([front, x], dim=1)[:, -(kt - 1):])
                cache[self] = tail.clone()
        b, t, h, w, c = x.shape
        n = _runs(t, b * h * w * max(c, self.conv.out_channels), kt - 1)
        if n >= t:
            return self._conv(torch.cat([front, x], dim=1) if kt > 1 else x)
        out = x.new_empty(b, t, h, w, self.conv.out_channels)
        for t0 in range(0, t, n):
            t1 = min(t0 + n, t)
            # output frame i reads padded input frames i .. i+kt-1, i.e. x[i-kt+1 .. i]
            xs = torch.cat([front, x[:, :t1]], dim=1) if t0 < kt - 1 else x[:, t0 - kt + 1:t1]
            out[:, t0:t1] = self._conv(xs[:, -(t1 - t0 + kt - 1):])
        return out

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)


class FrameConv2d(nn.Conv2d):
    """A 2D convolution of every frame of (B, T, H, W, C), frames split into calls that stay
    within MAX_ELEMENTS."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        frames = x.reshape(b * t, h, w, c)
        ho = (h + 2 * self.padding[0] - self.kernel_size[0]) // self.stride[0] + 1
        wo = (w + 2 * self.padding[1] - self.kernel_size[1]) // self.stride[1] + 1
        n = _runs(b * t, max(h * w * c, ho * wo * self.out_channels))

        def conv(xs):
            return super(FrameConv2d, self).forward(xs.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

        if n >= b * t:
            out = conv(frames)
        else:
            out = frames.new_empty(b * t, ho, wo, self.out_channels)
            for i in range(0, b * t, n):
                out[i:i + n] = conv(frames[i:i + n])
        return out.reshape(b, t, ho, wo, self.out_channels)


class CogResBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, 32, 1e-6, act="silu")
        self.conv1 = CausalConv3d(in_channels, out_channels)
        self.norm2 = GroupNorm(out_channels, 32, 1e-6, act="silu")
        self.conv2 = CausalConv3d(out_channels, out_channels)
        self.conv_shortcut = (CausalConv3d(in_channels, out_channels, (1, 1, 1))
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x), cache)
        h = self.conv2(self.norm2(h), cache)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


def temporal_downsample(x: torch.Tensor, clip_start: bool = True) -> torch.Tensor:
    """Causal 2x temporal pooling: the clip's first frame kept, pairs of the rest averaged
    (an odd last frame dropped); ``clip_start=False`` (a continuation chunk) pairs every
    frame."""
    first, rest = (x[:, :1], x[:, 1:]) if clip_start else (x[:, :0], x)
    t = rest.shape[1] - rest.shape[1] % 2
    rest = rest[:, :t].reshape(x.shape[0], t // 2, 2, *x.shape[2:]).mean(dim=2)
    return torch.cat([first, rest], dim=1)


def temporal_upsample(x: torch.Tensor, clip_start: bool = True) -> torch.Tensor:
    """2x temporal upsampling; the clip's first frame stays single."""
    if not clip_start:
        return x.repeat_interleave(2, dim=1)
    return torch.cat([x[:, :1], x[:, 1:].repeat_interleave(2, dim=1)], dim=1)


def spatial_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x of (B, T, H, W, C)."""
    b, t, h, w, c = x.shape
    return x[:, :, :, None, :, None].expand(b, t, h, 2, w, 2, c).reshape(b, t, 2 * h, 2 * w, c)


class CogVideoXEncoder(nn.Module):
    def __init__(self, config: CogVideoXVAEConfig):
        super().__init__()
        self.config = cfg = config
        chs = cfg.block_out_channels
        self.conv_in = CausalConv3d(cfg.in_channels, chs[0])
        prev = chs[0]
        for i, ch in enumerate(chs):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", CogResBlock3D(prev, ch))
                prev = ch
            if i < len(chs) - 1:
                self.add_module(f"down_{i}_downsample", FrameConv2d(ch, ch, 3, stride=2,
                                                                    padding=1))
        self.mid_res_0 = CogResBlock3D(chs[-1], chs[-1])
        self.mid_res_1 = CogResBlock3D(chs[-1], chs[-1])
        self.norm_out = GroupNorm(chs[-1], 32, 1e-6, act="silu")
        self.conv_out = CausalConv3d(chs[-1], 2 * cfg.latent_channels)

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None) -> torch.Tensor:
        cfg = self.config
        clip_start = not cache
        h = self.conv_in(x, cache)
        for i in range(len(cfg.block_out_channels)):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h, cache)
            if i < len(cfg.block_out_channels) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                if cfg.temporal_compress_levels[i]:
                    h = temporal_downsample(h, clip_start)
        h = self.mid_res_1(self.mid_res_0(h, cache), cache)
        return self.conv_out(self.norm_out(h), cache)


class CogVideoXDecoder(nn.Module):
    def __init__(self, config: CogVideoXVAEConfig):
        super().__init__()
        self.config = cfg = config
        chs = tuple(reversed(cfg.block_out_channels))
        self.conv_in = CausalConv3d(cfg.latent_channels, chs[0])
        self.mid_res_0 = CogResBlock3D(chs[0], chs[0])
        self.mid_res_1 = CogResBlock3D(chs[0], chs[0])
        prev = chs[0]
        for i, ch in enumerate(chs):
            for j in range(cfg.layers_per_block):
                self.add_module(f"up_{i}_res_{j}", CogResBlock3D(prev, ch))
                prev = ch
            if i < len(chs) - 1:
                self.add_module(f"up_{i}_upsample", FrameConv2d(ch, ch, 3, padding=1))
        self.norm_out = GroupNorm(chs[-1], 32, 1e-6, act="silu")
        self.conv_out = CausalConv3d(chs[-1], cfg.out_channels)

    def forward(self, z: torch.Tensor, cache: Optional[dict] = None) -> torch.Tensor:
        cfg = self.config
        clip_start = not cache
        levels = len(cfg.block_out_channels)
        t_levels = tuple(reversed(cfg.temporal_compress_levels))
        h = self.conv_in(z, cache)
        h = self.mid_res_1(self.mid_res_0(h, cache), cache)
        for i in range(levels):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"up_{i}_res_{j}")(h, cache)
            if i < levels - 1:
                if t_levels[i]:
                    h = temporal_upsample(h, clip_start)
                h = getattr(self, f"up_{i}_upsample")(spatial_upsample_2x(h))
        return self.conv_out(self.norm_out(h), cache)


class AutoencoderKLCogVideoX(nn.Module):
    def __init__(self, config: CogVideoXVAEConfig = CogVideoXVAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = CogVideoXEncoder(config)
        self.decoder = CogVideoXDecoder(config)

    @property
    def spatial_scale(self) -> int:
        return 2 ** (len(self.config.block_out_channels) - 1)

    @property
    def temporal_scale(self) -> int:
        return 2 ** sum(self.config.temporal_compress_levels)

    def encode_mode(self, x: torch.Tensor, cache: Optional[dict] = None) -> torch.Tensor:
        """(B, T, H, W, 3) -> (B, T_lat, h, w, latent) posterior mean, in the model's dtype."""
        x = x.to(self.decoder.conv_in.conv.weight.dtype)
        return self.encoder(x, cache)[..., :self.config.latent_channels]

    def decode(self, z: torch.Tensor, cache: Optional[dict] = None) -> torch.Tensor:
        return self.decoder(z.to(self.decoder.conv_in.conv.weight.dtype), cache)


def chunked_decode(vae: AutoencoderKLCogVideoX, z: torch.Tensor, *,
                   chunk_latent_frames: int = 2) -> torch.Tensor:
    """Streaming decode in chunks of latent frames (diffusers' frame batching): exact
    temporal continuity through the conv cache, GroupNorm statistics per chunk. The first
    chunk takes the clip's first frame and the remainder, so every later chunk has one
    shape."""
    t = z.shape[1]
    first = (t - 1) % chunk_latent_frames + 1
    cache = {}
    outs = [vae.decode(z[:, :first], cache)]
    for i in range(first, t, chunk_latent_frames):
        outs.append(vae.decode(z[:, i:i + chunk_latent_frames], cache))
    return torch.cat(outs, dim=1)


def chunked_encode(vae: AutoencoderKLCogVideoX, x: torch.Tensor, *,
                   chunk_frames: int = 8) -> torch.Tensor:
    """Streaming encode in chunks of pixel frames, a multiple of the temporal compression so
    that every chunk pools into whole latent frames."""
    if chunk_frames % vae.temporal_scale:
        raise ValueError(f"chunk_frames {chunk_frames} not a multiple of the "
                         f"{vae.temporal_scale}x temporal compression")
    t = x.shape[1]
    first = (t - 1) % chunk_frames + 1
    cache = {}
    outs = [vae.encode_mode(x[:, :first], cache)]
    for i in range(first, t, chunk_frames):
        outs.append(vae.encode_mode(x[:, i:i + chunk_frames], cache))
    return torch.cat(outs, dim=1)


def _tiled_apply(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, th: int, tw: int,
                 overlap: float, to_out: Callable[[int], int], align: int = 1) -> torch.Tensor:
    """The tile grid and blend ramps of tiled decode and encode (diffusers' ``blend_v`` /
    ``blend_h``: ``b[y] = a[-n+y] * (1 - y/n) + b[y] * y/n``). ``to_out`` maps an input
    coordinate to the output grid; ``align`` keeps tile sizes and starts multiples of the
    encode's scale. Every tile has one shape: edge tiles move inward, never shrink."""
    h, w = x.shape[2], x.shape[3]
    if align > 1 and (h % align or w % align):
        raise ValueError(f"frame {h}x{w} must be a multiple of {align} for tiling")
    th, tw = min(th, h), min(tw, w)
    th -= th % align
    tw -= tw % align
    stride_h = max(align, (int(th * (1 - overlap)) // align) * align)
    stride_w = max(align, (int(tw * (1 - overlap)) // align) * align)

    def starts(dim, tile, stride):
        out = list(range(0, max(dim - tile, 0) + 1, stride))
        if out[-1] + tile < dim:
            out.append(dim - tile)
        return out

    def blend(done, new, ov, axis):
        ramp = torch.arange(ov, dtype=new.dtype, device=new.device) / ov
        ramp = ramp.view([-1 if a == axis else 1 for a in range(new.dim())])
        keep = done.shape[axis] - ov
        mixed = done.narrow(axis, keep, ov) * (1 - ramp) + new.narrow(axis, 0, ov) * ramp
        return torch.cat([done.narrow(axis, 0, keep), mixed,
                          new.narrow(axis, ov, new.shape[axis] - ov)], dim=axis)

    out = None
    for i in starts(h, th, stride_h):
        row = None
        for j in starts(w, tw, stride_w):
            tile = fn(x[:, :, i:i + th, j:j + tw])
            row = tile if row is None else blend(row, tile, row.shape[3] - to_out(j), 3)
        out = row if out is None else blend(out, row, out.shape[2] - to_out(i), 2)
    return out


def tiled_decode(vae: AutoencoderKLCogVideoX, z: torch.Tensor, *, tile_latent_height: int = 60,
                 tile_latent_width: int = 90, overlap: float = 0.25,
                 chunk_latent_frames: Optional[int] = None) -> torch.Tensor:
    """Spatially tiled decode (diffusers ``tiled_decode``, ``vae.enable_tiling()``):
    overlapping latent tiles, seams blended with linear ramps; composes with
    :func:`chunked_decode` per tile."""
    s = vae.spatial_scale

    def decode(zt):
        if chunk_latent_frames:
            return chunked_decode(vae, zt, chunk_latent_frames=chunk_latent_frames)
        return vae.decode(zt)

    return _tiled_apply(decode, z, tile_latent_height, tile_latent_width, overlap,
                        to_out=lambda p: p * s)


def tiled_encode(vae: AutoencoderKLCogVideoX, x: torch.Tensor, *, tile_height: int = 480,
                 tile_width: int = 720, overlap: float = 0.25,
                 chunk_frames: Optional[int] = None) -> torch.Tensor:
    """Spatially tiled encode with latent-space blend ramps (diffusers ``tiled_encode``);
    composes with :func:`chunked_encode` per tile."""
    s = vae.spatial_scale

    def encode(xt):
        if chunk_frames:
            return chunked_encode(vae, xt, chunk_frames=chunk_frames)
        return vae.encode_mode(xt)

    return _tiled_apply(encode, x, tile_height, tile_width, overlap, to_out=lambda p: p // s,
                        align=s)
