#!/usr/bin/env python3
"""Drive the PyTorch port (``lkgd_torch``) once on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``. Phases,
each printing its own lines; any failure raises and the script exits non-zero:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the CUDA kernels from ``lkgd_torch/csrc`` with ``nvcc`` for sm_90a;
3. each kernel against its plain PyTorch version at the main path's shapes: bf16 inputs
   through the kernel, the plain version in fp32 on the same inputs (flash max |d| <=
   2e-2, GroupNorm max |d| <= 3e-2 in bf16 and <= 1e-5 in fp32), with both times;
4. the tiny end-to-end pipeline at fp32 on the GPU against the same weights and noise on
   the CPU (latents and frames at rtol 1e-4, atol 2e-4);
5. the full-size clip: 14 frames at 576x1024, 25 steps, CFG, bf16 random weights from a
   seeded generator; two clips (the first warms up), every kernel's launch count in the
   second, which must be > 0 for all four, and finite frames in [0, 1].

The second-to-last line of standard output holds the card's name and power limit as
``nvidia-smi`` prints them, the last one ``{"ok": true, "device": {...}}``. fp32 phases
run with TF32 off for matmuls and cuDNN convolutions. The script needs the repository
around it and a CUDA device; without either it fails before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

FLASH_TOL = 2e-2
GN_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-5}
REPLACES = {  # the Pallas kernel body each CUDA kernel replaces
    "flash_bound": "lkgd_tpu/ops/flash_attention.py:40",
    "flash_maxtrack": "lkgd_tpu/ops/flash_attention.py:102",
    "gn_stats": "lkgd_tpu/ops/group_norm.py:44",
    "gn_apply": "lkgd_tpu/ops/group_norm.py:56",
}
SOURCES = {"flash_bound": "lkgd_torch/csrc/flash_attention.cu",
           "flash_maxtrack": "lkgd_torch/csrc/flash_attention.cu",
           "gn_stats": "lkgd_torch/csrc/group_norm.cu",
           "gn_apply": "lkgd_torch/csrc/group_norm.cu"}


def gpu_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device() -> tuple[str, str]:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {smi} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    return smi, torch.cuda.get_device_name(0)


def phase_build() -> None:
    from lkgd_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"[build] {path.name}: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {'%.1f s' % _build.build_seconds if _build.build_seconds else 'reused'})",
          flush=True)


def phase_kernels(dev: torch.device, gen: torch.Generator) -> dict:
    """Kernels against their plain versions; returns per-kernel numbers at the main shapes
    (flash: UNet level 0; GroupNorm: the UNet level-0 spatial resblock)."""
    from lkgd_torch.ops import flash_attention as fa
    from lkgd_torch.ops import group_norm as gn

    results = {}

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    flash_cases = [("unet level 0", (2, 9216, 5, 64), 1.0),
                   ("unet level 1", (4, 2304, 10, 64), 1.0),
                   ("vae mid", (2, 9216, 1, 512), 1.0), ("ragged", (2, 1100, 5, 64), 1.0),
                   ("fallback", (1, 1100, 2, 64), 60.0)]
    for label, shape, scale in flash_cases:
        q, k = randn(*shape, scale=scale).bfloat16(), randn(*shape, scale=scale).bfloat16()
        v = randn(*shape).bfloat16()
        want = fa.flash_attention_maxtrack_plain(q.float(), k.float(), v.float())
        for kernel in ("flash_bound", "flash_maxtrack"):
            if kernel == "flash_maxtrack":
                os.environ["LKGD_FLASH_MAXTRACK"] = "1"
            try:
                counter = fa.recomputed_tiles(dev)
                counter.zero_()
                got = fa.flash_attention(q, k, v)
                torch.cuda.synchronize()
                recomputed = int(counter.item())
                err = (got.float() - want).abs()
                max_err, mean_err = err.max().item(), err.mean().item()
                ms = gpu_ms(lambda: fa.flash_attention(q, k, v))
            finally:
                os.environ.pop("LKGD_FLASH_MAXTRACK", None)
            plain = (fa.flash_attention_maxtrack_plain if kernel == "flash_maxtrack"
                     else fa.flash_attention_bound_plain)
            plain_ms = gpu_ms(lambda: plain(q, k, v), reps=2)
            print(f"[kernel] {kernel} {label} (B,S,H,D)={shape} x{scale}: max|d| {max_err:.3e} "
                  f"mean|d| {mean_err:.3e} (tol {FLASH_TOL}) | {ms:.3f} ms, plain {plain_ms:.3f} "
                  f"ms | tiles recomputed {recomputed}", flush=True)
            assert np.isfinite(max_err) and max_err <= FLASH_TOL, (kernel, label, max_err)
            if label == "fallback" and kernel == "flash_bound":
                assert recomputed > 0, "the huge-norm input must trip the fallback"
            if label == "unet level 0":
                results[kernel] = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}

    gn_cases = [("unet level 0 spatial", (28, 9216, 320), torch.bfloat16),
                ("unet level 0 temporal", (2, 14 * 9216, 320), torch.bfloat16),
                ("vae decode full res", (7, 576 * 1024, 128), torch.bfloat16),
                ("ragged", (3, 1001, 96), torch.bfloat16),
                ("unet level 0 spatial", (28, 9216, 320), torch.float32),
                ("ragged", (3, 1001, 96), torch.float32)]
    for label, shape, dtype in gn_cases:
        x = (randn(*shape, scale=2.0) + 0.5).to(dtype)
        w = (randn(shape[-1], scale=0.1) + 1.0).to(dtype)
        b = randn(shape[-1], scale=0.1).to(dtype)
        kw = dict(num_groups=32, eps=1e-5)
        a_want, b_want = gn.group_norm_affine_plain(x.float(), w.float(), b.float(), **kw)
        a_got, b_got = gn.group_norm_affine(x, w, b, **kw)
        stats_err = max((a_got - a_want).abs().max().item(), (b_got - b_want).abs().max().item())
        for act in (None, "silu"):
            got = gn.group_norm(x, w, b, act=act, **kw)
            err = (got.float() - gn.group_norm_plain(x.float(), w.float(), b.float(), act=act,
                                                     **kw)).abs()
            apply_want = gn.group_norm_apply_plain(x.float(), a_got, b_got, act)
            apply_err = (gn.group_norm_apply(x, a_got, b_got, act).float()
                         - apply_want).abs().max().item()
            tol = GN_TOL[dtype]
            stats_ms = gpu_ms(lambda: gn.group_norm_affine(x, w, b, **kw))
            stats_plain_ms = gpu_ms(lambda: gn.group_norm_affine_plain(x, w, b, **kw))
            apply_ms = gpu_ms(lambda: gn.group_norm_apply(x, a_got, b_got, act))
            apply_plain_ms = gpu_ms(lambda: gn.group_norm_apply_plain(x, a_got, b_got, act))
            print(f"[kernel] group_norm {label} {tuple(shape)} {str(dtype)[6:]} act={act}: "
                  f"max|d| {err.max().item():.3e} mean|d| {err.mean().item():.3e} (tol {tol}) "
                  f"| stats+fold {stats_ms:.3f} ms, plain {stats_plain_ms:.3f} ms (affine "
                  f"max|d| {stats_err:.3e}) | apply {apply_ms:.3f} ms, plain "
                  f"{apply_plain_ms:.3f} ms (max|d| {apply_err:.3e})", flush=True)
            assert err.max().item() <= tol, (label, dtype, act, err.max().item())
            assert apply_err <= tol, (label, dtype, act, apply_err)
            if label == "unet level 0 spatial" and dtype == torch.bfloat16 and act == "silu":
                results["gn_stats"] = {"max_abs_err": stats_err, "ms": stats_ms,
                                       "plain_ms": stats_plain_ms}
                results["gn_apply"] = {"max_abs_err": apply_err, "ms": apply_ms,
                                       "plain_ms": apply_plain_ms}
    return results


def _tiny_pipeline(device):
    from lkgd_torch.models.configs import CLIPVisionConfig, SVDUNetConfig, TemporalVAEConfig
    from lkgd_torch.pipelines.svd import SVDPipelineConfig, StableVideoDiffusionPipeline

    # the tiny configuration of tests/test_pipeline_torch_oracle.py:35-46
    return StableVideoDiffusionPipeline(
        config=SVDPipelineConfig(height=48, width=48, num_frames=4, num_inference_steps=3,
                                 decode_chunk_size=2),
        unet_config=SVDUNetConfig(
            block_out_channels=(32, 64),
            down_block_types=("CrossAttnDownBlockSpatioTemporal", "DownBlockSpatioTemporal"),
            up_block_types=("UpBlockSpatioTemporal", "CrossAttnUpBlockSpatioTemporal"),
            layers_per_block=1, num_attention_heads=(2, 4), cross_attention_dim=64),
        vae_config=TemporalVAEConfig(block_out_channels=(32, 64), layers_per_block=1),
        clip_config=CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=64,
                                     num_layers=2, num_heads=2, intermediate_size=128,
                                     projection_dim=64),
        dtype=torch.float32, device=device)


def phase_tiny(dev: torch.device) -> None:
    from lkgd_torch.ops import group_norm as gn

    cpu = _tiny_pipeline("cpu")
    cpu.init_params(torch.Generator().manual_seed(7))
    gpu = _tiny_pipeline(dev)
    for src, dst in zip(cpu.models, gpu.models):
        dst.load_state_dict(src.state_dict(), strict=True)
    rng = np.random.default_rng(5)
    image = torch.from_numpy(rng.uniform(size=(1, 48, 48, 3)).astype(np.float32))
    noise_aug = torch.from_numpy(rng.standard_normal((1, 48, 48, 3)).astype(np.float32))
    init_noise = torch.from_numpy(rng.standard_normal((1, 4, 24, 24, 4)).astype(np.float32))
    gn_before = gn.launches["gn_stats"]
    lat_cpu = cpu.denoise(image, noise_aug=noise_aug, initial_noise=init_noise)
    lat_gpu = gpu.denoise(image, noise_aug=noise_aug, initial_noise=init_noise)
    frames_cpu = cpu.decode_latents(lat_cpu)
    frames_gpu = gpu.decode_latents(lat_gpu)
    torch.cuda.synchronize()
    gn_calls = gn.launches["gn_stats"] - gn_before
    for name, got, want in (("latents", lat_gpu, lat_cpu), ("frames", frames_gpu, frames_cpu)):
        got = got.cpu()
        err = (got - want).abs().max().item()
        print(f"[tiny] GPU vs CPU fp32 {name} {tuple(want.shape)}: max|d| {err:.3e} "
              f"(rtol 1e-4, atol 2e-4) | GroupNorm kernel launches {gn_calls}", flush=True)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-4)
    assert gn_calls > 0, "the tiny GPU pipeline must run the GroupNorm kernels"


def phase_full(dev: torch.device) -> dict:
    from lkgd_torch.ops import flash_attention as fa
    from lkgd_torch.ops import group_norm as gn
    from lkgd_torch.pipelines.svd import SVDPipelineConfig, StableVideoDiffusionPipeline

    cfg = SVDPipelineConfig(height=576, width=1024, num_frames=14, num_inference_steps=25,
                            decode_chunk_size=14)
    t0 = time.perf_counter()
    pipe = StableVideoDiffusionPipeline(config=cfg, dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    pipe.init_params(gen)
    n_params = sum(p.numel() for m in pipe.models for p in m.parameters())
    image = torch.rand((1, cfg.height, cfg.width, 3), generator=gen, device=dev)
    torch.cuda.synchronize()
    print(f"[full] {n_params / 1e9:.3f} B bf16 random params, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    launches = {}
    for clip in (1, 2):
        if clip == 2:  # the counted run: counters and peak memory from zero
            for counts in (fa.launches, gn.launches):
                for name in counts:
                    counts[name] = 0
            fa.recomputed_tiles(dev).zero_()
            torch.cuda.reset_peak_memory_stats(dev)
        clip_gen = torch.Generator(device=dev).manual_seed(clip)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        latents = pipe.denoise(image, clip_gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        frames = pipe.decode_latents(latents)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if clip == 2:
            launches = {**fa.launches, **gn.launches}
            recomputed = int(fa.recomputed_tiles(dev).item())
            peak = torch.cuda.max_memory_allocated(dev)
        print(f"[full] clip {clip}{' (warm-up)' if clip == 1 else ''}: {t2 - t0:.3f} s/clip "
              f"= denoise {t1 - t0:.3f} s ({cfg.num_inference_steps} steps) + decode "
              f"{t2 - t1:.3f} s", flush=True)
        assert frames.shape == (1, cfg.num_frames, cfg.height, cfg.width, 3), frames.shape
        assert torch.isfinite(latents).all(), "non-finite latents"
        assert torch.isfinite(frames).all(), "non-finite frames"
        assert frames.min().item() >= 0.0 and frames.max().item() <= 1.0
    print(f"[full] clip 2: peak memory {peak / 2**30:.2f} GiB | launches {launches} | "
          f"fallback tiles recomputed {recomputed} | frames mean {frames.mean().item():.4f} "
          f"std {frames.std().item():.4f}", flush=True)
    for name in REPLACES:
        assert launches.get(name, 0) > 0, f"kernel {name} was not launched by the main path"
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check runs "
                         "only on a CUDA device")
    root = Path(__file__).resolve().parent
    if not (root / "lkgd_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no lkgd_torch/csrc next to {__file__}; run it from a "
                         f"checkout of the repository")
    sys.path.insert(0, str(root))
    # fp32 phases compare exact fp32 arithmetic: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    smi, kind = phase_device()
    phase_build()
    kernels = phase_kernels(dev, torch.Generator(device=dev).manual_seed(1234))
    phase_tiny(dev)
    launches = phase_full(dev)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches[name], **kernels[name]} for name in REPLACES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
