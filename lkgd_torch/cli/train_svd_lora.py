"""Fine-tuning with the PyTorch port (counterpart of ``lkgd_tpu/cli/train_svd_lora.py``).

``--mode lkgd`` trains the quaternion latent-knowledge fusion and a LoRA on the temporal
self-attention (``*temporal_transformer_blocks*attn1.*``). ``--mode trans`` trains the
frame-transition model: the joint-attention branch (``attn1n``, ``conv1n``) and three
stream-masked adapters (``yx_lora`` on ``attn1n``, ``xy_lora`` on ``attn1``, ``y_lora`` on
``attn2``) on each clip paired with its time-flipped copy, the two streams sharing one
noise level. The rest of the UNet, the VAE, CLIP-H and, in lkgd mode, the ViT-B/16-384
knowledge encoder stay frozen. Each step encodes its clips with the frozen models under
``torch.no_grad()``, then takes an EDM step with conditioning dropout, a masked AdamW
(``--use-8bit-adam``: 8-bit moments) and checkpoints; metrics go to
``output-dir/metrics.jsonl`` and, with ``--report-to``, to TensorBoard or wandb; with
``--validation-image`` and ``--validation-every`` the current weights render GIFs under
``output-dir/validation``. Example::

  python -m lkgd_torch.cli.train_svd_lora --video-folder data/clips --output-dir out \\
      --width 512 --height 512 --num-frames 8 --rank 4 --learning-rate 2e-4 --remat

The weights are random, drawn from ``--seed`` at the real shapes: loading a checkpoint
(``--weights``) waits until one is in the repository. ``build(args)`` makes everything but
the data, so that other callers (``chip_smoke.py``) run the same code on synthetic clips.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Callable

import torch

from lkgd_torch.models.clip_vision import CLIPVisionModelWithProjection, clip_normalize
from lkgd_torch.models.configs import (CLIPVisionConfig, JointAttentionConfig, LoraRouter,
                                      LoraRule, SVDUNetConfig, TemporalVAEConfig)
from lkgd_torch.models.layers import init_params, materialize
from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition
from lkgd_torch.models.vae_temporal import AutoencoderKLTemporalDecoder
from lkgd_torch.models.vit_mae import ViT, ViTConfig, encode_knowledge_features
from lkgd_torch.ops.resize import resize_with_antialiasing
from lkgd_torch.training.train_state import (SVDTrainConfig, init_train_state, make_optimizer,
                                             make_svd_train_step, trainable_trans)
from lkgd_torch.training.trainer import Trainer, TrainerConfig, export_trainable_safetensors
from lkgd_torch.utils.device import require_device
from lkgd_torch.utils.trackers import make_tracker

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
                   help="lkgd: quaternion fusion + temporal LoRA; trans: the joint branch "
                        "and the xy/yx/y adapters on [clip, time-flipped clip] pairs, one "
                        "pair a step")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--remat", action="store_true",
                   help="gradient checkpointing of every UNet block (the reference's "
                        "--gradient_checkpointing)")
    p.add_argument("--use-8bit-adam", action="store_true",
                   help="Adam moments held blockwise in 8 bits (training/optim8bit.py)")
    p.add_argument("--report-to", choices=["jsonl", "tensorboard", "wandb"], default="jsonl",
                   help="metrics always go to output-dir/metrics.jsonl; tensorboard and wandb "
                        "mirror them")
    p.add_argument("--validation-image", action="append", default=[],
                   help="an image rendered through the full pipeline with the current "
                        "weights every --validation-every steps, written as a GIF under "
                        "output-dir/validation; trans mode takes them in [start, end] pairs")
    p.add_argument("--validation-every", type=int, default=0)
    p.add_argument("--num-validation-steps", type=int, default=25,
                   help="denoising steps of a validation clip")
    p.add_argument("--device", default="cuda",
                   help="the card by default; a run without one fails unless cpu is named")
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="bf16",
                   help="compute dtype and the dtype of the frozen weights (trained ones stay "
                        "fp32); the CUDA flash kernels take bf16 only")
    return p


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
    the UNet it trains and the predicate on parameter names that selects the trained
    parameters."""

    trainer: Trainer
    preprocess: Callable
    unet: torch.nn.Module
    trainable: Callable[[str], bool]


def unet_config(args, widths: Widths = Widths()) -> SVDUNetConfig:
    """The UNet ``--mode`` trains, every adapter at ``alpha = rank``."""
    rank = args.rank
    if args.mode == "lkgd":
        extra = dict(knowledge_fusion=True, lora=LoraRouter(rules=(
            LoraRule("*temporal_transformer_blocks*attn1.*", "lkgd", rank, float(rank)),)))
    else:
        extra = dict(joint=JointAttentionConfig(post="conv", flip=True, mask=(0, 1)),
                     lora=LoraRouter(rules=(
                         LoraRule("*attn1n*", "yx_lora", rank, float(rank), (0, 1)),
                         LoraRule("*attn1.*", "xy_lora", rank, float(rank), (1, 0)),
                         LoraRule("*attn2*", "y_lora", rank, float(rank), (0, 1)))))
    return SVDUNetConfig(**{**widths.unet, "num_frames": args.num_frames, "remat": args.remat,
                            **extra})


ONE_PAIR = ("--mode trans trains one [clip, time-flipped clip] pair a step: with two or more "
            "the stream masks and partner streams pair clip 0 with clip 1, not with its own "
            "flipped copy (ROADMAP.md Queue 3, 'trans training at two or more pairs')")


def load_validation_image(path: str, height: int, width: int):
    """An image in [0, 1] ``(height, width, 3)``, resized with PIL's bicubic filter where its
    size differs, as the JAX CLI loads validation images."""
    import numpy as np

    from lkgd_torch.data.video_io import read_image

    img = read_image(path)
    if img.shape[:2] != (height, width):
        from PIL import Image

        img = np.asarray(Image.fromarray((img * 255).astype(np.uint8)).resize(
            (width, height), Image.BICUBIC), np.float32) / 255.0
    return img


def _validation_fn(args, unet: torch.nn.Module, vae, clip, device, dtype):
    """The validation sampler of ``--validation-image`` on the trainer's own modules, or
    None when no validation is asked for."""
    if not (args.validation_image and args.validation_every):
        return None
    import numpy as np

    from lkgd_torch.pipelines.svd import StableVideoDiffusionPipeline, SVDPipelineConfig
    from lkgd_torch.pipelines.svd_trans import StableVideoDiffusionTransPipeline
    from lkgd_torch.training.variants import make_validation_sampler

    paths = args.validation_image
    if args.mode == "trans":
        if len(paths) % 2:
            raise SystemExit("trans validation consumes --validation-image in [start, end] "
                             "pairs: give an even number")
        cls = StableVideoDiffusionTransPipeline
        images = [np.stack([load_validation_image(p, args.height, args.width) for p in pair])
                  for pair in zip(paths[::2], paths[1::2])]
    else:
        cls = StableVideoDiffusionPipeline
        images = [load_validation_image(p, args.height, args.width)[None] for p in paths]
    config = SVDPipelineConfig(height=args.height, width=args.width,
                               num_frames=args.num_frames,
                               num_inference_steps=args.num_validation_steps,
                               decode_chunk_size=min(args.num_frames, 8))
    pipe = cls(config=config, unet_config=unet.config, vae_config=vae.config,
               clip_config=clip.config, dtype=dtype, device=device, models=(unet, vae, clip))
    return make_validation_sampler(pipe, images, os.path.join(args.output_dir, "validation"))


def clip_embedding(clip: torch.nn.Module, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) images in [-1, 1] -> (B, 1, D) fp32 CLIP-H embeddings, after the
    antialiased resize to CLIP's size."""
    size = clip.config.image_size
    clip_in = resize_with_antialiasing(images.float(), (size, size))
    dtype = next(clip.parameters()).dtype
    return clip(clip_normalize((clip_in + 1.0) / 2.0).to(dtype))[:, None, :].float()


def make_preprocess(vae, clip, vit=None, trans: bool = False) -> Callable:
    """The frozen models' preprocessing, ``preprocess(pixel_values, generator) -> batch``:
    pixel_values (B, T+1, H, W, 3) in [-1, 1] -> the train step's batch (fp32) of the first
    T frames: scaled VAE latents, the unscaled latents of the first frame with 0.02 x
    normal noise, its CLIP embedding, and with ``vit`` the knowledge features. With
    ``trans`` the rows are [clip, time-flipped clip], each conditioned on its own first
    frame (one pair only: ``ONE_PAIR``)."""
    device, dtype = next(vae.parameters()).device, next(vae.parameters()).dtype

    @torch.no_grad()
    def preprocess(pixel_values: torch.Tensor, gen: torch.Generator) -> dict:
        frames = pixel_values.to(device, torch.float32)[:, :-1]
        if trans:
            if frames.shape[0] != 1:
                raise NotImplementedError(ONE_PAIR)
            frames = torch.stack([frames, frames.flip(1)], dim=1).flatten(0, 1)
        b, t = frames.shape[:2]
        latents = vae.encode_mode(frames.reshape(b * t, *frames.shape[2:]).to(dtype))
        latents = latents.float().reshape(b, t, *latents.shape[1:]) * VAE_SCALING
        cond_img = frames[:, 0]
        noise = torch.randn(cond_img.shape, generator=gen, device=device) * 0.02
        cond_latents = vae.encode_mode((cond_img + noise).to(dtype)).float()
        batch = {"latents": latents, "cond_latents": cond_latents,
                 "image_embeddings": clip_embedding(clip, frames[:, 0])}
        if vit is not None:
            domain = encode_knowledge_features(vit, frames).float()
            batch.update(domain_features=domain, flow_features=domain)
        return batch

    return preprocess


def build(args, widths: Widths = Widths()) -> TrainRun:
    """Models with random weights from ``--seed``, the preprocessing, the train step and the
    trainer of ``--mode``."""
    if args.weights:
        raise NotImplementedError("--weights is not ported to lkgd_torch yet (no checkpoint "
                                  "is in the repository, ROADMAP.md Queue 1, item 6)")
    trans = args.mode == "trans"
    if trans and args.per_device_batch_size != 1:
        raise NotImplementedError(ONE_PAIR)
    device, dtype = require_device(args.device), _DTYPES[args.dtype]
    predicate = trainable_trans if trans else trainable
    unet = materialize(lambda: UNetSpatioTemporalCondition(unet_config(args, widths)), device,
                       dtype, fp32=predicate)
    vae = materialize(lambda: AutoencoderKLTemporalDecoder(widths.vae), device, dtype)
    clip = materialize(lambda: CLIPVisionModelWithProjection(widths.clip), device, dtype)
    # the knowledge encoder feeds the fusion only: the trans UNet has none
    vit = None if trans else materialize(lambda: ViT(widths.vit), device, dtype)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    print("random weights from --seed (no checkpoint is loaded)")
    frozen = [m for m in (vae, clip, vit) if m is not None]
    for model in (unet, *frozen):
        init_params(model, generator)
    for model in frozen:
        model.eval().requires_grad_(False)

    preprocess = make_preprocess(vae, clip, vit, trans)
    optimizer = make_optimizer(args.learning_rate, trainable_predicate=predicate,
                               use_8bit=args.use_8bit_adam)
    state = init_train_state(unet, optimizer)
    step = make_svd_train_step(SVDTrainConfig(
        conditioning_dropout_prob=args.conditioning_dropout_prob, tie_stream_pairs=trans))

    def train_step(state, batch, gen):
        return step(state, preprocess(batch["pixel_values"], gen), gen)

    trainer = Trainer(
        train_step, state,
        TrainerConfig(output_dir=args.output_dir, max_steps=args.max_steps,
                      checkpoint_every=args.checkpoint_every, seed=args.seed,
                      validation_every=args.validation_every or None),
        validation_fn=_validation_fn(args, unet, vae, clip, device, dtype),
        tracker=make_tracker(args.report_to, args.output_dir, run_name=f"svd_{args.mode}"))
    return TrainRun(trainer, preprocess, unet, predicate)


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
    n = export_trainable_safetensors(run.unet, run.trainable, path)
    print(f"exported {n} trainable tensors to {path}")


if __name__ == "__main__":
    main()
