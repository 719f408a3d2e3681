"""Checkpoint parity verifier (counterpart of ``lkgd_tpu/cli/verify_parity.py``).

``record`` runs a model on seeded inputs and writes them with its output to an ``.npz``;
``check`` loads a checkpoint (diffusers safetensors names), replays the recorded inputs and
reports the fp32 agreement as JSON (exit 1 when it fails the tolerance). The ``.npz`` format
is the JAX package's: channels-last arrays under the same keys (``sample, timestep,
encoder_hidden_states, added_time_ids, output, config``; ``image, noise_aug, initial_noise,
latents, pipe_config`` for the whole pipeline), so a record written by either package checks
in the other against the same safetensors file.

  # a record of the SVD UNet (tiny, or the svd-xt geometry) on the weights of a checkpoint
  python -m lkgd_torch.cli.verify_parity record --config svd-xt --out rec.npz \\
      --checkpoint unet/diffusion_pytorch_model.safetensors
  python -m lkgd_torch.cli.verify_parity check --record rec.npz \\
      --checkpoint unet/diffusion_pytorch_model.safetensors --report parity.json

``--model cogvideox`` records one DiT forward, ``--model svd_pipeline`` the whole denoising
loop (image and injected noise -> latents) from a diffusers checkpoint root holding
``unet/``, ``vae/`` and ``image_encoder/``. Without ``--checkpoint`` a record draws random
weights from ``--seed``. Models run in fp32 on the card: ``--device`` defaults to ``cuda``
and a machine without one fails unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from lkgd_torch.models.configs import (CLIPVisionConfig, CogVideoXConfig, SVDUNetConfig,
                                       TemporalVAEConfig)
from lkgd_torch.models.layers import init_params, materialize
from lkgd_torch.utils.device import require_device
from lkgd_torch.utils.porting import load_state_dict

TINY = dict(block_out_channels=(32, 64),
            down_block_types=("CrossAttnDownBlockSpatioTemporal", "DownBlockSpatioTemporal"),
            up_block_types=("UpBlockSpatioTemporal", "CrossAttnUpBlockSpatioTemporal"),
            layers_per_block=1, num_attention_heads=(2, 4), cross_attention_dim=64)
COG_FIELDS = ("num_layers", "num_attention_heads", "attention_head_dim", "in_channels",
              "out_channels", "text_embed_dim", "time_embed_dim", "patch_size",
              "patch_size_t", "max_text_seq_length", "use_rope", "knowledge_fusion")
UNET_FIELDS = ("in_channels", "out_channels", "layers_per_block", "cross_attention_dim",
               "num_frames")
UNET_TUPLES = ("block_out_channels", "down_block_types", "up_block_types",
               "num_attention_heads")


def _config_from_dict(d: dict) -> SVDUNetConfig:
    clean = {}
    for f in dataclasses.fields(SVDUNetConfig):
        if f.name in d and f.name not in ("joint", "lora"):
            v = d[f.name]
            clean[f.name] = tuple(v) if isinstance(v, list) else v
    return SVDUNetConfig(**clean)


def _resolve_weights(path: str) -> str:
    if os.path.isfile(path):
        return path
    for cand in ("diffusion_pytorch_model.safetensors",
                 os.path.join("unet", "diffusion_pytorch_model.safetensors"),
                 os.path.join("transformer", "diffusion_pytorch_model.safetensors"),
                 "unet.safetensors", "transformer.safetensors", "model.safetensors"):
        p = os.path.join(path, cand)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no safetensors found under {path}")


def _build(config_dict: dict, device: torch.device) -> torch.nn.Module:
    """The fp32 model a record's ``config`` names (uninitialised)."""
    if config_dict.get("model") == "cogvideox":
        from lkgd_torch.models.cogvideox import CogVideoXTransformer3D

        fields = {f.name for f in dataclasses.fields(CogVideoXConfig)}
        cfg = CogVideoXConfig(**{k: v for k, v in config_dict.items() if k in fields})
        return materialize(lambda: CogVideoXTransformer3D(cfg), device, torch.float32).eval()
    from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition

    cfg = _config_from_dict(config_dict)
    return materialize(lambda: UNetSpatioTemporalCondition(cfg), device, torch.float32).eval()


def _weights(module: torch.nn.Module, args, path=None) -> None:
    """``--checkpoint`` (or ``path``) loaded, strictly unless ``--lenient``; random from
    ``--seed`` without one."""
    path = path or args.checkpoint
    if path:
        module.load_state_dict(load_state_dict(_resolve_weights(path)),
                               strict=not args.lenient)
    else:
        init_params(module, torch.Generator(device=_device(args)).manual_seed(args.seed))


def _device(args) -> torch.device:
    return require_device(args.device)


def _run(module: torch.nn.Module, inputs, device) -> np.ndarray:
    with torch.inference_mode():
        out = module(*(torch.as_tensor(x).to(device) for x in inputs))
    return out.float().cpu().numpy()


def _record_cogvideox(args) -> None:
    """One DiT forward of the CogVideoX transformer (tiny, or CogVideoX-5B I2V)."""
    cfg = CogVideoXConfig.tiny() if args.config == "tiny" else CogVideoXConfig.cogvideox_5b_i2v()
    if args.config_json:
        cfg = dataclasses.replace(cfg, **json.loads(args.config_json))
    config = {"model": "cogvideox", **{k: getattr(cfg, k) for k in COG_FIELDS}}
    device = _device(args)
    model = _build(config, device)
    _weights(model, args)
    rng = np.random.default_rng(args.seed)
    b, t, h, w = args.batch, args.frames, args.height // 8, args.width // 8
    sample = rng.standard_normal((b, t, h, w, cfg.in_channels)).astype(np.float32)
    text = rng.standard_normal((b, cfg.max_text_seq_length,
                                cfg.text_embed_dim)).astype(np.float32) * 0.3
    timestep = np.full((b,), 500.0, np.float32)
    out = _run(model, (sample, text, timestep), device)
    np.savez_compressed(args.out, sample=sample, timestep=timestep, encoder_hidden_states=text,
                        output=out, config=json.dumps(config))
    print(f"recorded {out.shape} cogvideox denoise output -> {args.out}")


def _build_pipeline(args, device):
    """The SVD pipeline for the whole-loop record: tiny widths or the svd-xt geometry."""
    from lkgd_torch.pipelines.svd import SVDPipelineConfig, StableVideoDiffusionPipeline

    if args.config == "tiny":
        ucfg = SVDUNetConfig(**TINY)
        vcfg = TemporalVAEConfig(block_out_channels=(32, 64), layers_per_block=1)
        ccfg = CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                                num_heads=2, intermediate_size=128, projection_dim=64)
    else:
        ucfg, vcfg, ccfg = SVDUNetConfig(), TemporalVAEConfig(), CLIPVisionConfig()
    pcfg = SVDPipelineConfig(height=args.height, width=args.width, num_frames=args.frames,
                             num_inference_steps=args.steps, decode_chunk_size=2)
    return StableVideoDiffusionPipeline(config=pcfg, unet_config=ucfg, vae_config=vcfg,
                                        clip_config=ccfg, dtype=torch.float32, device=device)


def _pipeline_weights(pipe, args) -> None:
    """unet, vae and image_encoder from a diffusers checkpoint root, or random from
    ``--seed``."""
    if not args.checkpoint:
        pipe.init_params(torch.Generator(device=pipe.device).manual_seed(args.seed))
        return
    clip = os.path.join(args.checkpoint, "image_encoder")
    for name, module, path in (("unet", pipe.unet, os.path.join(args.checkpoint, "unet")),
                               ("vae", pipe.vae, os.path.join(args.checkpoint, "vae")),
                               ("image_encoder", pipe.image_encoder, clip)):
        _weights(module, args, path)


def _pipeline_latents(pipe, image, noise_aug, initial_noise) -> np.ndarray:
    dev = pipe.device
    with torch.inference_mode():
        out = pipe(torch.from_numpy(image).to(dev), output_type="latent",
                   noise_aug=torch.from_numpy(noise_aug).to(dev),
                   initial_noise=torch.from_numpy(initial_noise).to(dev))
    return out.float().cpu().numpy()


def record_pipeline(args) -> None:
    """The whole pipeline loop: image + injected noise -> denoised latents."""
    pipe = _build_pipeline(args, _device(args))
    _pipeline_weights(pipe, args)
    rng = np.random.default_rng(args.seed)
    b = args.batch
    image = rng.uniform(size=(b, args.height, args.width, 3)).astype(np.float32)
    noise_aug = rng.standard_normal((b, args.height, args.width, 3)).astype(np.float32)
    init_noise = rng.standard_normal((b, args.frames, pipe.latent_height, pipe.latent_width,
                                      4)).astype(np.float32)
    latents = _pipeline_latents(pipe, image, noise_aug, init_noise)
    np.savez_compressed(
        args.out, image=image, noise_aug=noise_aug, initial_noise=init_noise, latents=latents,
        pipe_config=json.dumps({"model": "svd_pipeline", "config": args.config,
                                "height": args.height, "width": args.width,
                                "frames": args.frames, "steps": args.steps}))
    print(f"recorded pipeline latents {latents.shape} -> {args.out}")


def _report(args, got: np.ndarray, want: np.ndarray, pipeline: bool = False) -> int:
    """The JAX package's report (the pipeline's with its ``mode`` and no relative error),
    printed, written to ``--report``; 0 when it passes, else 1."""
    abs_err = np.abs(got - want)
    report = {**({"mode": "pipeline"} if pipeline else {}), "checkpoint": args.checkpoint,
              "record": args.record, "shape": list(want.shape),
              "max_abs_err": float(abs_err.max()), "mean_abs_err": float(abs_err.mean())}
    if not pipeline:
        report["max_rel_err"] = float((abs_err / np.maximum(np.abs(want), 1e-8)).max())
    report.update(rtol=args.rtol, atol=args.atol,
                  **{"pass": bool(np.allclose(got, want, rtol=args.rtol, atol=args.atol))})
    print(json.dumps(report, indent=2))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
    return 0 if report["pass"] else 1


def check_pipeline(args, rec) -> int:
    meta = json.loads(str(rec["pipe_config"]))
    pargs = argparse.Namespace(config=meta["config"], height=meta["height"],
                               width=meta["width"], frames=meta["frames"], steps=meta["steps"])
    pipe = _build_pipeline(pargs, _device(args))
    _pipeline_weights(pipe, args)
    got = _pipeline_latents(pipe, rec["image"], rec["noise_aug"], rec["initial_noise"])
    return _report(args, got, np.asarray(rec["latents"], np.float32), pipeline=True)


def record(args) -> int:
    if args.model == "cogvideox":
        _record_cogvideox(args)
        return 0
    if args.model == "svd_pipeline":
        record_pipeline(args)
        return 0
    cfg_dict = dict(TINY) if args.config == "tiny" else {}
    if args.config_json:
        cfg_dict.update(json.loads(args.config_json))
    device = _device(args)
    unet = _build(cfg_dict, device)
    _weights(unet, args)
    c = unet.config
    b, t, h, w = args.batch, args.frames, args.height // 8, args.width // 8
    rng = np.random.default_rng(args.seed)
    sample = rng.standard_normal((b, t, h, w, c.in_channels)).astype(np.float32)
    timestep = np.full((b,), 0.25 * np.log(7.0), np.float32)
    ehs = rng.standard_normal((b, 1, c.cross_attention_dim)).astype(np.float32)
    add_ids = np.asarray([[6.0, 127.0, 0.02]] * b, np.float32)
    out = _run(unet, (sample, timestep, ehs, add_ids), device)
    config = {**{k: getattr(c, k) for k in UNET_FIELDS},
              **{k: list(getattr(c, k)) for k in UNET_TUPLES}}
    np.savez_compressed(args.out, sample=sample, timestep=timestep, encoder_hidden_states=ehs,
                        added_time_ids=add_ids, output=out, config=json.dumps(config))
    print(f"recorded {out.shape} denoise output -> {args.out}")
    return 0


def check(args) -> int:
    rec = np.load(args.record, allow_pickle=False)
    if "pipe_config" in rec:
        return check_pipeline(args, rec)
    cfg_dict = json.loads(str(rec["config"]))
    device = _device(args)
    model = _build(cfg_dict, device)
    if cfg_dict.get("model") == "cogvideox":
        inputs = (rec["sample"], rec["encoder_hidden_states"], rec["timestep"])
    else:
        inputs = (rec["sample"], rec["timestep"], rec["encoder_hidden_states"],
                  rec["added_time_ids"])
    model.load_state_dict(load_state_dict(_resolve_weights(args.checkpoint)),
                          strict=not args.lenient)
    return _report(args, _run(model, inputs, device), np.asarray(rec["output"], np.float32))


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="mode", required=True)
    pr = sub.add_parser("record")
    pr.add_argument("--out", required=True)
    pr.add_argument("--model", default="svd", choices=["svd", "cogvideox", "svd_pipeline"])
    pr.add_argument("--config", default="tiny", choices=["tiny", "svd-xt"])
    pr.add_argument("--config-json", help="extra config field overrides (JSON)")
    pr.add_argument("--checkpoint", help="safetensors to record with (svd_pipeline: a "
                                         "diffusers checkpoint root with unet/vae/image_encoder)")
    pr.add_argument("--lenient", action="store_true")
    pr.add_argument("--batch", type=int, default=2)
    pr.add_argument("--frames", type=int, default=2)
    pr.add_argument("--height", type=int, default=64)
    pr.add_argument("--width", type=int, default=64)
    pr.add_argument("--steps", type=int, default=3,
                    help="svd_pipeline: denoising steps in the recorded loop")
    pr.add_argument("--seed", type=int, default=0)
    pr.set_defaults(fn=record)
    pc = sub.add_parser("check")
    pc.add_argument("--record", required=True)
    pc.add_argument("--checkpoint", required=True)
    pc.add_argument("--report")
    pc.add_argument("--rtol", type=float, default=1e-4)
    pc.add_argument("--atol", type=float, default=1e-4)
    pc.add_argument("--lenient", action="store_true")
    pc.set_defaults(fn=check)
    for sp in (pr, pc):
        sp.add_argument("--device", default="cuda",
                        help="the card by default; a run without one fails unless cpu is "
                             "named")
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    _device(args)  # the card unless the CPU is named, before any file is read
    return args.fn(args) or 0


if __name__ == "__main__":
    raise SystemExit(main())
