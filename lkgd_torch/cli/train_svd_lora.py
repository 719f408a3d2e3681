"""LKGD fine-tuning with the PyTorch port (counterpart of ``lkgd_tpu/cli/train_svd_lora.py``,
``--mode lkgd``).

Trains the quaternion latent-knowledge fusion and a LoRA on the temporal self-attention
(``*temporal_transformer_blocks*attn1.*``); the rest of the UNet, the VAE, CLIP-H and the
ViT-B/16-384 knowledge encoder stay frozen. Each step encodes its clips with the frozen
models under ``torch.no_grad()``, then takes an EDM step with conditioning dropout, a
masked AdamW and checkpoints. Example::

  python -m lkgd_torch.cli.train_svd_lora --video-folder data/clips --output-dir out \\
      --width 512 --height 512 --num-frames 8 --rank 4 --learning-rate 2e-4 --remat

The weights are random, drawn from ``--seed`` at the real shapes: loading a checkpoint
(``--weights``) waits until one is in the repository. ``build(args)`` makes everything but
the data, so that other callers (``chip_smoke.py``) run the same code on synthetic clips.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable

import torch

from lkgd_torch.models.clip_vision import CLIPVisionModelWithProjection, clip_normalize
from lkgd_torch.models.configs import (CLIPVisionConfig, LoraRouter, LoraRule, SVDUNetConfig,
                                      TemporalVAEConfig)
from lkgd_torch.models.layers import init_params, materialize
from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition
from lkgd_torch.models.vae_temporal import AutoencoderKLTemporalDecoder
from lkgd_torch.models.vit_mae import ViT, ViTConfig, encode_knowledge_features
from lkgd_torch.ops.resize import resize_with_antialiasing
from lkgd_torch.training.train_state import (SVDTrainConfig, init_train_state, make_optimizer,
                                             make_svd_train_step)
from lkgd_torch.training.trainer import Trainer, TrainerConfig, export_trainable_safetensors
from lkgd_torch.utils.device import require_device

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
VAE_SCALING = 0.18215


def trainable(name: str) -> bool:
    """The parameters ``--mode lkgd`` trains: LoRA factors and the knowledge fusion."""
    return "lora_" in name or "knowledge_fusion" in name


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--video-folder", help="folder of mp4 clips (required by main)")
    p.add_argument("--output-dir", default="output_svd_lora")
    p.add_argument("--weights", help="diffusers-layout weights: not ported yet")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--num-frames", type=int, default=14)
    p.add_argument("--per-device-batch-size", type=int, default=1)
    p.add_argument("--rank", type=int, default=4)
    p.add_argument("--learning-rate", type=float, default=2e-4)
    p.add_argument("--max-steps", type=int, default=1000)
    p.add_argument("--checkpoint-every", type=int, default=200)
    p.add_argument("--conditioning-dropout-prob", type=float, default=0.1)
    p.add_argument("--mode", choices=["lkgd", "trans"], default="lkgd",
                   help="lkgd: quaternion fusion + temporal LoRA; trans: joint attention is "
                        "ported (inference, run_inference_svd.py --mode trans), its training "
                        "(tie_stream_pairs, the xy/yx/y adapters) is not yet")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--remat", action="store_true",
                   help="gradient checkpointing of every UNet block (the reference's "
                        "--gradient_checkpointing)")
    p.add_argument("--use-8bit-adam", action="store_true", help="not ported yet")
    p.add_argument("--report-to", choices=["jsonl", "tensorboard", "wandb"], default="jsonl",
                   help="metrics go to output-dir/metrics.jsonl; the others are not ported yet")
    p.add_argument("--validation-image", action="append", default=[],
                   help="in-training validation sampling: not ported yet")
    p.add_argument("--device", default="cuda",
                   help="the card by default; a run without one fails unless cpu is named")
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="bf16",
                   help="compute dtype and the dtype of the frozen weights (trained ones stay "
                        "fp32); the CUDA flash kernels take bf16 only")
    return p


def _refuse_unported(args) -> None:
    unported = [
        (args.mode == "trans", "--mode trans training (tie_stream_pairs and the xy/yx/y "
                               "adapters; joint attention itself runs in run_inference_svd.py "
                               "--mode trans; ROADMAP.md Queue 1, item 8)"),
        (args.use_8bit_adam, "--use-8bit-adam (training/optim8bit.py, ROADMAP.md Queue 1, "
                             "item 9)"),
        (bool(args.validation_image), "--validation-image (validation sampling, "
                                      "training/variants.py, ROADMAP.md Queue 1, item 9)"),
        (args.report_to != "jsonl", f"--report-to {args.report_to} (utils/trackers.py, "
                                    f"ROADMAP.md Queue 1, item 9)"),
        (bool(args.weights), "--weights (no checkpoint is in the repository, ROADMAP.md "
                             "Queue 1, item 6)"),
    ]
    for bad, what in unported:
        if bad:
            raise NotImplementedError(f"{what} is not ported to lkgd_torch yet")


@dataclasses.dataclass(frozen=True)
class Widths:
    """The models' widths: the published ones by default (SVD, its VAE, CLIP-H, ViT-B/16-384);
    the CPU tests pass tiny ones. ``unet``: overrides of ``SVDUNetConfig`` fields."""

    unet: dict = dataclasses.field(default_factory=dict)
    vae: TemporalVAEConfig = TemporalVAEConfig()
    clip: CLIPVisionConfig = CLIPVisionConfig()
    vit: ViTConfig = ViTConfig.vit_base_patch16_384()


@dataclasses.dataclass
class TrainRun:
    """What ``build`` makes: the trainer, whose step is the frozen-encoder preprocessing
    ``preprocess(pixel_values, generator) -> batch`` and then the train step on that batch,
    and the UNet it trains."""

    trainer: Trainer
    preprocess: Callable
    unet: torch.nn.Module


def build(args, widths: Widths = Widths()) -> TrainRun:
    """Models with random weights from ``--seed``, the preprocessing, the train step and the
    trainer, for ``--mode lkgd``."""
    _refuse_unported(args)
    device, dtype = require_device(args.device), _DTYPES[args.dtype]
    unet_config = SVDUNetConfig(
        **{**widths.unet, "num_frames": args.num_frames, "knowledge_fusion": True,
           "remat": args.remat,
           "lora": LoraRouter(rules=(LoraRule("*temporal_transformer_blocks*attn1.*", "lkgd",
                                              args.rank, float(args.rank)),))})
    unet = materialize(lambda: UNetSpatioTemporalCondition(unet_config), device, dtype,
                       fp32=trainable)
    vae = materialize(lambda: AutoencoderKLTemporalDecoder(widths.vae), device, dtype)
    clip = materialize(lambda: CLIPVisionModelWithProjection(widths.clip), device, dtype)
    vit = materialize(lambda: ViT(widths.vit), device, dtype)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    print("random weights from --seed (no checkpoint is loaded)")
    for model in (unet, vae, clip, vit):
        init_params(model, generator)
    for model in (vae, clip, vit):
        model.eval().requires_grad_(False)

    @torch.no_grad()
    def preprocess(pixel_values: torch.Tensor, gen: torch.Generator) -> dict:
        """pixel_values (B, T+1, H, W, 3) in [-1, 1] -> the train step's batch (fp32)."""
        frames = pixel_values.to(device, torch.float32)[:, :-1]
        b, t = frames.shape[:2]
        latents = vae.encode_mode(frames.reshape(b * t, *frames.shape[2:]).to(dtype))
        latents = latents.float().reshape(b, t, *latents.shape[1:]) * VAE_SCALING
        cond_img = frames[:, 0]
        noise = torch.randn(cond_img.shape, generator=gen, device=device) * 0.02
        cond_latents = vae.encode_mode((cond_img + noise).to(dtype)).float()
        size = clip.config.image_size
        clip_in = resize_with_antialiasing(frames[:, 0], (size, size))  # [-1, 1]
        emb = clip(clip_normalize((clip_in + 1.0) / 2.0).to(dtype))[:, None, :].float()
        domain = encode_knowledge_features(vit, frames).float()
        return {"latents": latents, "cond_latents": cond_latents, "image_embeddings": emb,
                "domain_features": domain, "flow_features": domain}

    optimizer = make_optimizer(args.learning_rate, trainable_predicate=trainable)
    state = init_train_state(unet, optimizer)
    step = make_svd_train_step(SVDTrainConfig(
        conditioning_dropout_prob=args.conditioning_dropout_prob))

    def train_step(state, batch, gen):
        return step(state, preprocess(batch["pixel_values"], gen), gen)

    trainer = Trainer(train_step, state, TrainerConfig(
        output_dir=args.output_dir, max_steps=args.max_steps,
        checkpoint_every=args.checkpoint_every, seed=args.seed))
    return TrainRun(trainer, preprocess, unet)


def main(argv=None) -> None:
    parser = make_parser()
    args = parser.parse_args(argv)
    if not args.video_folder:
        parser.error("--video-folder is required")
    from lkgd_torch.data.datasets import MiniDataset, PrefetchLoader

    run = build(args)
    ds = MiniDataset(args.video_folder, sample_size=(args.height, args.width),
                     sample_n_frames=args.num_frames)
    loader = PrefetchLoader(ds, batch_size=args.per_device_batch_size, device=args.device)
    run.trainer.restore_latest()
    run.trainer.fit(iter(loader))
    path = f"{args.output_dir}/model.safetensors"
    n = export_trainable_safetensors(run.unet, trainable, path)
    print(f"exported {n} trainable tensors to {path}")


if __name__ == "__main__":
    main()
