#!/usr/bin/env python3
"""Drive the PyTorch port (``lkgd_torch``) once on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``. Phases,
each printing its own lines; any failure raises and the script exits non-zero:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the CUDA kernels from ``lkgd_torch/csrc`` with ``nvcc`` for sm_90a;
3. each kernel against its plain PyTorch version at the main path's shapes: bf16 inputs
   through the kernel, the plain version in fp32 on the same inputs (flash max |d| <=
   FLASH_TOL * max|ref|, GroupNorm max |d| <= 3e-2 in bf16 and <= 1e-5 in fp32), with
   both times;
4. the tiny end-to-end pipeline at fp32 on the GPU against the same weights and noise on
   the CPU (latents and frames at rtol 1e-4, atol 2e-4);
5. the full-size clip: 14 frames at 576x1024, 25 steps, CFG, bf16 random weights from a
   seeded generator; two clips (the first warms up), every kernel's launch count in the
   second, which must be > 0 for the four inference kernels and 0 for the four training
   ones (no gradient is asked for), and finite frames in [0, 1];
6. the training kernels (head split and merge, flash LSE forwards, dq and dk/dv
   backwards) against their plain versions at the fine-tune's shapes, ragged S and the
   huge-norm input that trips the LSE forward's fallback: split/merge bit-exact, out max
   |d| <= FLASH_TOL * max|ref|, lse within 1e-2 log2 units, dq/dk/dv max |d| <= 2e-2 *
   max|ref|, with the kernels' fwd+bwd times beside the plain ones;
7. the tiny LKGD train step (knowledge fusion, rank-2 temporal LoRA, remat) at fp32 on
   the GPU against the CPU with the same weights and injected sigmas, noise and dropout:
   the loss, every trainable gradient (scaled by its largest entry) and the trainables
   after one AdamW step at rtol 1e-4, atol 2e-4, frozen weights bit-identical;
8. the LKGD fine-tune through ``lkgd_torch/cli/train_svd_lora.py``'s ``build`` at full
   width (SVD UNet, its VAE, CLIP-H, ViT-B/16-384; bf16 random frozen weights, fp32
   trainables), 512x512, 8 frames, batch 1, rank-4 temporal LoRA, remat, lr 2e-4: one
   warm-up step and three counted ones; sec/step split into preprocessing and train step,
   peak memory, each loss, every kernel's launch count (all ten > 0), the trainables
   moved, sampled frozen weights did not, every gradient finite; then three more steps
   under ``torch.profiler`` for the device's busy share of that window; and the exported
   safetensors read back. Neither window syncs the host inside it: losses stay on the
   device until it ends, and the end-of-fit checkpoint falls after its closing event.

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

# flash outputs relative to max|ref|: the kernels round P to bf16 before P.V and the
# output to bf16 (at most 4.8e-3 of max|ref| over every case here on an H100)
FLASH_TOL = 1e-2
GN_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-5}
# lse is rounded nowhere: exp2 and the summation order alone move it
LSE_TOL = 1e-2
# dq, dk, dv relative to max|ref|: the kernels round P and dS to bf16 before their
# products over up to 4096 keys or queries
GRAD_TOL = 2e-2
REPLACES = {  # the Pallas kernel body each CUDA kernel replaces
    "flash_bound": "lkgd_tpu/ops/flash_attention.py:40",
    "flash_maxtrack": "lkgd_tpu/ops/flash_attention.py:102",
    "gn_stats": "lkgd_tpu/ops/group_norm.py:44",
    "gn_apply": "lkgd_tpu/ops/group_norm.py:56",
    "flash_bound_lse": "lkgd_tpu/ops/flash_attention.py:150",
    "flash_maxtrack_lse": "lkgd_tpu/ops/flash_attention.py:183",
    "flash_bwd_dq": "lkgd_tpu/ops/flash_attention.py:218",
    "flash_bwd_dkv": "lkgd_tpu/ops/flash_attention.py:246",
    "split_heads": "lkgd_tpu/ops/flash_attention.py:546",
    "merge_heads": "lkgd_tpu/ops/flash_attention.py:552",
}
INFERENCE = ("flash_bound", "flash_maxtrack", "gn_stats", "gn_apply")
TRAINING = ("flash_bound_lse", "flash_maxtrack_lse", "flash_bwd_dq", "flash_bwd_dkv",
            "split_heads", "merge_heads")
SOURCES = {"flash_bound": "lkgd_torch/csrc/flash_attention.cu",
           "flash_maxtrack": "lkgd_torch/csrc/flash_attention.cu",
           "gn_stats": "lkgd_torch/csrc/group_norm.cu",
           "gn_apply": "lkgd_torch/csrc/group_norm.cu",
           "flash_bound_lse": "lkgd_torch/csrc/flash_attention.cu",
           "flash_maxtrack_lse": "lkgd_torch/csrc/flash_attention.cu",
           "flash_bwd_dq": "lkgd_torch/csrc/flash_attention_bwd.cu",
           "flash_bwd_dkv": "lkgd_torch/csrc/flash_attention_bwd.cu",
           "split_heads": "lkgd_torch/csrc/relayout_heads.cu",
           "merge_heads": "lkgd_torch/csrc/relayout_heads.cu"}


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


def host_probe_ms() -> float:
    """Wall ms of a fixed pure-Python loop: how fast this host runs interpreter work, the
    part of a host-bound step that is not waiting."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc += i & 7
    return (time.perf_counter() - t0) * 1e3


def host_line() -> str:
    return (f"host probe {host_probe_ms():.1f} ms, load average "
            f"{'/'.join(f'{x:.2f}' for x in os.getloadavg())}, {len(os.sched_getaffinity(0))} "
            f"cores")


def phase_device() -> tuple[str, str]:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {smi} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | {host_line()}",
          flush=True)
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
                ref_max = want.abs().max().item()
                ms = gpu_ms(lambda: fa.flash_attention(q, k, v))
            finally:
                os.environ.pop("LKGD_FLASH_MAXTRACK", None)
            plain = (fa.flash_attention_maxtrack_plain if kernel == "flash_maxtrack"
                     else fa.flash_attention_bound_plain)
            plain_ms = gpu_ms(lambda: plain(q, k, v), reps=2)
            print(f"[kernel] {kernel} {label} (B,S,H,D)={shape} x{scale}: max|d| {max_err:.3e} "
                  f"of max|ref| {ref_max:.3e} (tol {FLASH_TOL} x max|ref|) mean|d| "
                  f"{mean_err:.3e} | {ms:.3f} ms, plain {plain_ms:.3f} ms | tiles recomputed "
                  f"{recomputed}", flush=True)
            assert np.isfinite(max_err) and max_err <= FLASH_TOL * ref_max, \
                (kernel, label, max_err, ref_max)
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
            _zero_counts()
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
    for name in INFERENCE:
        assert launches.get(name, 0) > 0, f"kernel {name} was not launched by the main path"
    for name in TRAINING:  # inference asks for no gradient: the training kernels stay idle
        assert launches.get(name, 0) == 0, f"kernel {name} was launched by inference"
    return launches


def _zero_counts() -> None:
    from lkgd_torch.ops import flash_attention as fa
    from lkgd_torch.ops import group_norm as gn

    for counts in (fa.launches, gn.launches):
        for name in counts:
            counts[name] = 0


def phase_train_kernels(dev: torch.device, gen: torch.Generator) -> dict:
    """The training kernels against their plain versions; returns per-kernel numbers at
    UNet level 0 of the fine-tune (B*T=8, S=4096, 5 heads, D=64)."""
    from lkgd_torch.ops import flash_attention as fa

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).bfloat16()

    results = {}
    cases = [("unet level 0", (8, 4096, 5, 64), 1.0), ("unet level 1", (8, 1024, 10, 64), 1.0),
             ("ragged", (2, 1100, 5, 64), 1.0), ("fallback", (1, 1100, 2, 64), 60.0)]
    for label, shape, scale in cases:
        q, k, v, do = randn(*shape, scale=scale), randn(*shape, scale=scale), randn(*shape), \
            randn(*shape)
        want_out, want_lse = fa.flash_fwd_lse_maxtrack_plain(q.float(), k.float(), v.float())
        # at the huge-norm input lse reaches ~2e4 log2 units, where fp32 logits carry ~1e-3
        lse_tol = LSE_TOL * max(1.0, want_lse.abs().max().item() / 1e3)
        out_tol = FLASH_TOL * want_out.abs().max().item()
        row = _relayout_check(fa, label, shape, randn)
        for kernel in ("flash_bound_lse", "flash_maxtrack_lse"):
            if kernel == "flash_maxtrack_lse":
                os.environ["LKGD_FLASH_MAXTRACK"] = "1"
            try:
                counter = fa.recomputed_tiles(dev)
                counter.zero_()
                out, lse = fa.flash_fwd_lse(q, k, v)
                torch.cuda.synchronize()
                recomputed = int(counter.item())
                ms = gpu_ms(lambda: fa.flash_fwd_lse(q, k, v))
            finally:
                os.environ.pop("LKGD_FLASH_MAXTRACK", None)
            plain = (fa.flash_fwd_lse_maxtrack_plain if kernel == "flash_maxtrack_lse"
                     else fa.flash_fwd_lse_bound_plain)
            plain_ms = gpu_ms(lambda: plain(q, k, v), reps=2)
            out_err = (out.float() - want_out).abs().max().item()
            lse_err = (lse - want_lse).abs().max().item()
            print(f"[train-kernel] {kernel} {label} (B,S,H,D)={shape} x{scale}: out max|d| "
                  f"{out_err:.3e} of max|ref| {out_tol / FLASH_TOL:.3e} (tol {FLASH_TOL} x "
                  f"max|ref|) lse max|d| {lse_err:.3e} (tol {lse_tol:.3g}) | {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms | tiles recomputed {recomputed}", flush=True)
            assert np.isfinite(out_err) and out_err <= out_tol, (kernel, label, out_err, out_tol)
            assert np.isfinite(lse_err) and lse_err <= lse_tol, (kernel, label, lse_err)
            if label == "fallback" and kernel == "flash_bound_lse":
                assert recomputed > 0, "the huge-norm input must trip the fallback"
            row[kernel] = {"max_abs_err": out_err, "ms": ms, "plain_ms": plain_ms}

        # the backward from the guarded forward's out and lse, as the autograd Function
        out, lse = fa.flash_fwd_lse(q, k, v)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        ref = (q.float(), k.float(), v.float(), do.float(), lse, delta)
        args = (q, k, v, do, lse, delta)
        for kernel, fn, plain, names in (
                ("flash_bwd_dq", fa.flash_bwd_dq, fa.flash_bwd_dq_plain, ("dq",)),
                ("flash_bwd_dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain, ("dk", "dv"))):
            got, want = fn(*args), plain(*ref)
            got, want = (got, want) if len(names) > 1 else ((got,), (want,))
            errs = {}
            for name, g, w in zip(names, got, want):
                assert torch.isfinite(g).all(), (kernel, label, name)
                errs[name] = ((g.float() - w).abs().max().item(), w.abs().max().item())
            ms = gpu_ms(lambda: fn(*args))
            plain_ms = gpu_ms(lambda: plain(*args), reps=2)
            print(f"[train-kernel] {kernel} {label} (B,S,H,D)={shape} x{scale}: " + ", ".join(
                f"{n} max|d| {e:.3e} of max|ref| {m:.3e} (tol {GRAD_TOL} x max|ref|)"
                for n, (e, m) in errs.items()) + f" | {ms:.3f} ms, plain {plain_ms:.3f} ms",
                flush=True)
            for name, (e, m) in errs.items():
                assert e <= GRAD_TOL * m, (kernel, label, name, e, m)
            row[kernel] = {"max_abs_err": max(e for e, _ in errs.values()), "ms": ms,
                           "plain_ms": plain_ms}
        # one call of the Function: 3 splits, 7/8, 1 merge; then 1 split, 9, 10, 3 merges
        per_call = {"flash_bound_lse": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                    "split_heads": 4, "merge_heads": 4}
        fwd_bwd = sum(n * row[k]["ms"] for k, n in per_call.items())
        plain_fwd_bwd = sum(n * row[k]["plain_ms"] for k, n in per_call.items())
        print(f"[train-kernel] {label}: fwd+bwd (kernels 5 x4 + 7/8 + 9 + 10 + 6 x4) "
              f"{fwd_bwd:.3f} ms, plain {plain_fwd_bwd:.3f} ms", flush=True)
        if label == "unet level 0":
            results = row
        del q, k, v, do, want_out, want_lse, out, lse, delta, ref, args
        torch.cuda.empty_cache()
    return results


def _relayout_check(fa, label: str, shape, randn) -> dict:
    """Kernels 5 and 6 against their plain versions, bit for bit: split a strided view (a
    slice of a fused projection, as q, k, v arrive) and merge it back."""
    b, s, h, d = shape
    x = randn(b, s, 2 * h * d)[..., h * d:].unflatten(-1, (h, d))
    split = fa.split_heads(x)
    merged = fa.merge_heads(split)
    errs = {"split_heads": (split.float() - fa.split_heads_plain(x).float()).abs().max().item(),
            "merge_heads": (merged.float() - x.float()).abs().max().item()}
    row = {}
    for name, fn, plain, arg in (("split_heads", fa.split_heads, fa.split_heads_plain, x),
                                 ("merge_heads", fa.merge_heads, fa.merge_heads_plain, split)):
        ms, plain_ms = gpu_ms(lambda: fn(arg)), gpu_ms(lambda: plain(arg))
        mb = arg.numel() * arg.element_size() / 2 ** 20
        print(f"[train-kernel] {name} {label} (B,S,H,D)={shape} ({mb:.1f} MiB): max|d| "
              f"{errs[name]:.3e} (tol 0: a copy) | {ms:.3f} ms, plain {plain_ms:.3f} ms",
              flush=True)
        assert errs[name] == 0.0, (name, label, errs[name])
        row[name] = {"max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms}
    return row


def _tiny_train_unet(device):
    from lkgd_torch.cli.train_svd_lora import trainable
    from lkgd_torch.models.configs import LoraRouter, LoraRule, SVDUNetConfig
    from lkgd_torch.models.layers import materialize
    from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition

    # the tiny LKGD configuration of tests/test_training.py:18-24, with remat
    config = SVDUNetConfig(
        block_out_channels=(32, 64),
        down_block_types=("CrossAttnDownBlockSpatioTemporal", "DownBlockSpatioTemporal"),
        up_block_types=("UpBlockSpatioTemporal", "CrossAttnUpBlockSpatioTemporal"),
        layers_per_block=1, num_attention_heads=(2, 4), cross_attention_dim=64,
        knowledge_fusion=True, remat=True,
        lora=LoraRouter(rules=(LoraRule(pattern="*temporal*attn1.*", name="ft", rank=2),)))
    return materialize(lambda: UNetSpatioTemporalCondition(config), device, torch.float32,
                       fp32=trainable)


def phase_train_tiny(dev: torch.device) -> None:
    from lkgd_torch.cli.train_svd_lora import trainable
    from lkgd_torch.models.layers import init_params
    from lkgd_torch.ops import group_norm as gn
    from lkgd_torch.training import train_state as ts

    cpu = _tiny_train_unet("cpu")
    gen = torch.Generator().manual_seed(11)
    init_params(cpu, gen)
    with torch.no_grad():  # LoRA B and the text vectors start at zero: make their paths count
        for name, p in cpu.named_parameters():
            if trainable(name):
                p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    gpu = _tiny_train_unet(dev)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    rng = np.random.default_rng(21)
    b, t, hw = 2, 4, 8
    batch = {"latents": rng.standard_normal((b, t, hw, hw, 4)) * 0.5,
             "cond_latents": rng.standard_normal((b, hw, hw, 4)),
             "image_embeddings": rng.standard_normal((b, 1, 64)),
             "domain_features": rng.standard_normal((b, 1, 48)),
             "flow_features": rng.standard_normal((b, 1, 48))}
    draws = {"sigmas": np.array([0.7, 3.0]), "noise": rng.standard_normal((b, t, hw, hw, 4)),
             "dropout_u": np.array([0.61, 0.06])}  # each dropout mask acts on one sample
    config = ts.SVDTrainConfig(conditioning_dropout_prob=0.3)
    results = {}
    for side, unet, device in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
        tensors = {k: torch.tensor(v, dtype=torch.float32, device=device)
                   for k, v in {**batch, **draws}.items()}
        state = ts.init_train_state(unet, ts.make_optimizer(1e-3, trainable_predicate=trainable))
        frozen = {n: p.detach().clone() for n, p in unet.named_parameters() if not trainable(n)}
        gn_before = gn.launches["gn_stats"]
        loss = ts.svd_loss(unet, {k: tensors[k] for k in batch}, config,
                           **{k: tensors[k] for k in draws})
        loss.backward()
        grads = {n: p.grad.detach().cpu().clone() for n, p in state.trainables.items()}
        state.optimizer.step()
        if device != "cpu":
            torch.cuda.synchronize()
        for name, p in unet.named_parameters():
            if not trainable(name):
                assert torch.equal(p, frozen[name]), f"{side}: frozen {name} moved"
        results[side] = (loss.item(), grads,
                         {n: p.detach().cpu() for n, p in state.trainables.items()},
                         gn.launches["gn_stats"] - gn_before)
    (loss_c, grads_c, after_c, _), (loss_g, grads_g, after_g, gn_calls) = \
        results["cpu"], results["gpu"]
    grad_err = max(((grads_g[n] - grads_c[n]).abs().max() / grads_c[n].abs().max().clamp_min(
        1e-12)).item() for n in grads_c)
    step_err = max((after_g[n] - after_c[n]).abs().max().item() for n in after_c)
    print(f"[train-tiny] GPU vs CPU fp32: loss {loss_g:.6f} vs {loss_c:.6f} | {len(grads_c)} "
          f"trainable grads, max |d|/max|ref| {grad_err:.3e} | after one step max|d| "
          f"{step_err:.3e} (rtol 1e-4, atol 2e-4) | frozen bit-identical | GroupNorm kernel "
          f"launches {gn_calls}", flush=True)
    assert np.isfinite(loss_g) and abs(loss_g - loss_c) <= 2e-4 + 1e-4 * abs(loss_c)
    for name in grads_c:
        assert torch.isfinite(grads_g[name]).all(), name
        scale = grads_c[name].abs().max().clamp_min(1e-12)
        torch.testing.assert_close(grads_g[name] / scale, grads_c[name] / scale, rtol=1e-4,
                                   atol=2e-4, msg=name)
        torch.testing.assert_close(after_g[name], after_c[name], rtol=1e-4, atol=2e-4,
                                   msg=name)
    assert gn_calls > 0, "the tiny GPU train step must run the GroupNorm kernels"


def _read_safetensors(path: str) -> dict:
    """name -> numpy array of a safetensors file of F32 tensors."""
    with open(path, "rb") as f:
        blob = f.read()
    n = int.from_bytes(blob[:8], "little")
    header = json.loads(blob[8:8 + n])
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        assert info["dtype"] == "F32", (name, info["dtype"])
        start, end = info["data_offsets"]
        out[name] = np.frombuffer(blob[8 + n + start:8 + n + end], "<f4").reshape(info["shape"])
    return out


def phase_train_full(dev: torch.device) -> dict:
    import tempfile

    from lkgd_torch.cli import train_svd_lora as cli
    from lkgd_torch.ops import flash_attention as fa
    from lkgd_torch.ops import group_norm as gn

    with tempfile.TemporaryDirectory() as out_dir:
        args = cli.make_parser().parse_args([
            "--output-dir", out_dir, "--height", "512", "--width", "512", "--num-frames", "8",
            "--per-device-batch-size", "1", "--rank", "4", "--learning-rate", "2e-4",
            "--remat", "--dtype", "bf16", "--device", str(dev), "--checkpoint-every", "0",
            "--max-steps", "1", "--seed", "0"])
        t0 = time.perf_counter()
        run = cli.build(args)
        trainer = run.trainer
        trainer.config.log_every = 1  # the warm-up step's record checks the JSONL log
        gen = torch.Generator(device=dev).manual_seed(5)
        clips = [{"pixel_values": torch.rand((1, 9, 512, 512, 3), generator=gen, device=dev)
                  * 2 - 1} for _ in range(7)]
        trainables = trainer.state.trainables
        n_train = sum(p.numel() for p in trainables.values())
        n_all = sum(p.numel() for p in run.unet.parameters())
        torch.cuda.synchronize()
        print(f"[train] LKGD fine-tune 512x512x8f, batch 1: UNet {n_all / 1e9:.3f} B params, "
              f"{len(trainables)} trainable tensors ({n_train / 1e6:.3f} M, fp32), set-up "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        t0 = time.perf_counter()
        trainer.fit(iter(clips[:1]))  # warm-up step
        torch.cuda.synchronize()
        print(f"[train] warm-up step {time.perf_counter() - t0:.3f} s", flush=True)

        # In the timed windows the step keeps its loss on the device and records a CUDA
        # event after itself; with no log due, nothing in a window waits on the host, and
        # the end-of-fit checkpoint comes after the window's last event.
        losses, marks = [], []
        step = trainer.train_step

        def recorded_step(state, batch, generator):
            state, loss = step(state, batch, generator)
            losses.append(loss)
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            return state, loss

        trainer.train_step = recorded_step
        trainer.config.log_every = 10 ** 9

        def window(first: int, last: int) -> tuple[float, float]:
            """Steps on clips[first:last] through the trainer: seconds a step between the
            window's opening event and the last step's, and the process's CPU seconds a
            step (every thread, autograd's device thread included) over the fit."""
            marks.clear()
            opening = torch.cuda.Event(enable_timing=True)
            trainer.config.max_steps = trainer.state.step + last - first
            cpu0 = time.process_time()
            opening.record()
            trainer.fit(iter(clips[first:last]))
            cpu_s = (time.process_time() - cpu0) / (last - first)
            torch.cuda.synchronize()
            return opening.elapsed_time(marks[-1]) / 1e3 / (last - first), cpu_s

        before = {n: p.detach().clone() for n, p in trainables.items()}
        frozen = {n: p.detach().clone() for n, p in run.unet.named_parameters()
                  if n in ("conv_in.weight", "down_blocks.0.attentions.0.proj_in.weight",
                           "down_blocks.0.attentions.0.temporal_transformer_blocks.0.attn1."
                           "to_q.weight", "mid_block.resnets.0.spatial_res_block.conv1.weight",
                           "up_blocks.3.attentions.2.transformer_blocks.0.ff.net.2.weight",
                           "conv_norm_out.weight")}
        assert len(frozen) == 6, sorted(frozen)
        finite = []
        hooks = [p.register_post_accumulate_grad_hook(
            lambda p: finite.append(torch.isfinite(p.grad).all())) for p in trainables.values()]
        _zero_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        step_s, cpu_s = window(1, 4)
        launches = {**fa.launches, **gn.launches}
        peak = torch.cuda.max_memory_allocated(dev)
        for h in hooks:
            h.remove()
        moved = [n for n, p in trainables.items() if not torch.equal(p, before[n])]

        t0 = time.perf_counter()  # the preprocessing alone, on the same clips
        for clip in clips[1:4]:
            run.preprocess(clip["pixel_values"], trainer.generator)
        torch.cuda.synchronize()
        pre_s = (time.perf_counter() - t0) / 3

        # the same window under the profiler: the device's busy share of it
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prof_step_s, prof_cpu_s = window(4, 7)
        device_ms, ckpt_ms, n_device, runtime, relayout = 0.0, 0.0, 0, {}, {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                ms = e.self_device_time_total / 1e3
                # the end-of-fit checkpoint's reads fall after the window's last event
                if "DtoH" in e.key:
                    ckpt_ms += ms
                else:
                    device_ms += ms
                    n_device += e.count
                if "relayout_heads_kernel" in e.key:
                    relayout["split" if "<true>" in e.key else "merge"] = (ms, e.count)
            elif e.key.startswith("cuda"):  # runtime calls on the host
                runtime[e.key] = e.count
        busy = device_ms / (prof_step_s * 3e3)
        syncs = {k: n for k, n in runtime.items() if "Synchronize" in k or "Memcpy" in k}

        step_losses = [x.item() for x in losses[:3]]
        records = [json.loads(line) for line in
                   (Path(out_dir) / "metrics.jsonl").read_text().splitlines()]
        print(f"[train] {step_s:.3f} s/step = preprocessing {pre_s:.3f} s + train step "
              f"{step_s - pre_s:.3f} s (3 steps after the warm-up, between CUDA events; "
              f"preprocessing timed alone on the same clips), host CPU {cpu_s:.3f} s/step | "
              f"peak memory {peak / 2**30:.2f} GiB | losses {step_losses} | launches "
              f"{launches} | trainables moved {len(moved)}/{len(trainables)} | grads finite "
              f"{len(finite)} checks | {host_line()}", flush=True)
        print(f"[train] profiled window: {prof_step_s:.3f} s/step (3 steps under "
              f"torch.profiler), host CPU {prof_cpu_s:.3f} s/step, device busy "
              f"{device_ms / 3:.1f} ms/step = {100 * busy:.1f}% of the window (kernels, copies "
              f"and fills: {n_device / 3:.0f} a step; device-to-host copies after the window "
              f"{ckpt_ms:.1f} ms left out) | host syncs and copies over the 3 steps and the "
              f"checkpoint {syncs} | relayout kernels device ms, launches "
              f"{relayout}", flush=True)
        assert trainer.state.step == 7 and all(np.isfinite(step_losses)), step_losses
        assert [r["step"] for r in records] == [1] and np.isfinite(records[0]["train_loss"])
        assert len(finite) == 3 * len(trainables) and torch.stack(finite).all().item(), \
            "non-finite gradient"
        assert len(moved) == len(trainables), "a trainable did not move"
        for name, p in run.unet.named_parameters():
            if name in frozen:
                assert torch.equal(p, frozen[name]), f"frozen {name} moved"
        for name in REPLACES:
            assert launches.get(name, 0) > 0, f"kernel {name} was not launched by training"
        assert busy > 0.0, busy

        path = str(Path(out_dir) / "model.safetensors")
        n = cli.export_trainable_safetensors(run.unet, cli.trainable, path)
        exported = _read_safetensors(path)
        assert n == len(exported) and sorted(exported) == sorted(trainables)
        for name, value in exported.items():
            assert np.array_equal(value, trainables[name].detach().float().cpu().numpy()), name
        print(f"[train] export: {n} tensors, {os.path.getsize(path) / 2**20:.2f} MiB, read back "
              f"equal", flush=True)
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
    clip_launches = phase_full(dev)
    torch.cuda.empty_cache()
    kernels.update(phase_train_kernels(dev, torch.Generator(device=dev).manual_seed(4321)))
    phase_train_tiny(dev)
    train_launches = phase_train_full(dev)
    # launches: the inference kernels' count from the clip, the training kernels' from the
    # counted training steps; both paths' counts under launches_by_path
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": (clip_launches if name in INFERENCE else train_launches)[name],
         "launches_by_path": {"clip": clip_launches[name], "train": train_launches[name]},
         **kernels[name]} for name in REPLACES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
