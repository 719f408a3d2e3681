"""CogVideoX LoRA fine-tuning with the PyTorch port (counterpart of
``lkgd_tpu/cli/train_cogvideox_lora.py``, the reference's ``finetune/train.py`` with
``models/cogvideox_i2v/lora_trainer.py``).

Trains LoRA adapters (rank 128, alpha 64 on ``to_q``/``to_k``/``to_v``/``to_out`` of every
``attn1``, the reference's defaults) and the quaternion knowledge fusion, or with
``--full-finetune`` every parameter, on precomputed latents and prompt embeddings read
from a tensor cache (``data/tensor_cache.py``; the prompt embeddings from
``cli/embed_text.py``). The step is the v-prediction MSE of the DDIM scheduler and a
masked AdamW (``--use-8bit-adam``: 8-bit moments); ``--remat`` recomputes every
transformer block in the backward pass, which the 5B model at 49 frames needs. Trained
parameters are fp32 and the frozen ones bf16, the compute bf16 (fp32 with ``--tiny``).
Example::

  python -m lkgd_torch.cli.train_cogvideox_lora --cache cache.lkgd --output-dir out \\
      --rank 128 --learning-rate 1e-4 --max-steps 1000 --remat

Metrics go to ``output-dir/metrics.jsonl`` and, with ``--report-to``, to TensorBoard or
wandb; ``--validation-every N`` denoises the first cached sample's conditioning with the
current weights (DDIM, ``--num-validation-steps``) into
``output-dir/validation/step{N}_latents.npy``. The run resumes from the newest checkpoint
in ``output-dir`` and ends by exporting the trained parameters to
``output-dir/model.safetensors`` under the JAX CLI's export names. It runs on the card
unless ``--device cpu`` is given. The weights are random, drawn from ``--seed`` at the
published shapes: ``--weights`` is refused until a CogVideoX checkpoint is in the
repository (ROADMAP.md Queue 1, item 11). ``build(args, sample)`` makes everything but the
data, so that other callers (``chip_smoke.py``) run the same code.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from lkgd_torch.models.cogvideox import CogVideoXTransformer3D
from lkgd_torch.models.configs import CogVideoXConfig, LoraRouter, LoraRule
from lkgd_torch.models.layers import init_params, materialize
from lkgd_torch.pipelines.cogvideox_i2v import (CogVideoXImageToVideoPipeline,
                                                CogVideoXPipelineConfig,
                                                CogVideoXTextToVideoPipeline,
                                                make_cogvideox_train_step)
from lkgd_torch.training.train_state import init_train_state, make_optimizer
from lkgd_torch.training.trainer import Trainer, TrainerConfig, export_trainable_safetensors
from lkgd_torch.utils.device import require_device
from lkgd_torch.utils.porting import cogvideox_export_name
from lkgd_torch.utils.trackers import make_tracker

WEIGHTS = ("--weights is not ported to lkgd_torch: no CogVideoX checkpoint is in the "
           "repository (ROADMAP.md Queue 1, item 11); weights are random from --seed")


def trainable(name: str) -> bool:
    """The parameters LoRA mode trains: the adapters and the knowledge fusion."""
    return "lora_" in name or "knowledge_fusion" in name


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cache", help="tensor cache with latents / prompt_embeds (required by main)")
    p.add_argument("--output-dir", default="output_cogvideox_lora")
    p.add_argument("--rank", type=int, default=128)
    p.add_argument("--lora-alpha", type=float, default=64.0)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--max-steps", type=int, default=1000)
    p.add_argument("--checkpoint-every", type=int, default=200)
    p.add_argument("--mode", choices=["i2v", "t2v"], default="i2v",
                   help="t2v drops the image-condition channels (reference "
                        "cogvideox_t2v/lora_trainer.py)")
    p.add_argument("--tiny", action="store_true", help="tiny model, fp32 (tests)")
    p.add_argument("--remat", action="store_true",
                   help="recompute every transformer block in the backward pass (gradient "
                        "checkpointing; the 5B model at 49 frames needs it)")
    p.add_argument("--full-finetune", action="store_true",
                   help="train every transformer parameter instead of the LoRA adapters and "
                        "the fusion (the reference's sft mode)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--use-8bit-adam", action="store_true",
                   help="Adam moments held blockwise in 8 bits (training/optim8bit.py)")
    p.add_argument("--weights", help="safetensors dir of a pretrained model: not ported")
    p.add_argument("--report-to", choices=["jsonl", "tensorboard", "wandb"], default="jsonl",
                   help="metrics always go to output-dir/metrics.jsonl; tensorboard and wandb "
                        "mirror them")
    p.add_argument("--validation-every", type=int, default=0,
                   help="every N steps, denoise a clip from the first cached sample's "
                        "conditioning with the current weights; writes its latents .npy")
    p.add_argument("--num-validation-steps", type=int, default=50)
    p.add_argument("--device", default="cuda",
                   help="the card by default; a run without one fails unless cpu is named")
    return p


class _Adapted:
    """Adapt cache field names: SVD-flavoured caches store ``cond_latents`` /
    ``image_embeddings``; the CogVideoX step wants ``image_latents`` / ``prompt_embeds``
    (the image embedding tiled to the text width, 8 rows)."""

    def __init__(self, base, text_dim: int):
        self.base = base
        self.text_dim = text_dim

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, i: int) -> dict:
        s = dict(self.base[i])
        if "image_latents" not in s and "cond_latents" in s:
            s["image_latents"] = s.pop("cond_latents")
        if "prompt_embeds" not in s:
            emb = s.get("image_embeddings")
            if emb is None:
                raise KeyError("cache lacks prompt_embeds/image_embeddings")
            e = torch.as_tensor(emb).reshape(-1)
            reps = -(-self.text_dim // e.numel())
            s["prompt_embeds"] = e.repeat(reps)[:self.text_dim][None, :].repeat(8, 1).float()
        s.pop("image_embeddings", None)
        return s


def transformer_config(args, **overrides) -> CogVideoXConfig:
    """The transformer of the flags; ``overrides``: config fields replaced after them."""
    lora = (LoraRouter() if args.full_finetune
            else LoraRouter(rules=(LoraRule("*attn1*", "cog", args.rank, args.lora_alpha,
                                            projections=("to_q", "to_k", "to_v", "to_out")),)))
    cfg = CogVideoXConfig.tiny(lora=lora) if args.tiny else CogVideoXConfig.cogvideox_5b_i2v(
        lora=lora)
    cfg = dataclasses.replace(cfg, remat=args.remat)
    if args.mode == "t2v":  # T2V checkpoints take bare noise latents
        cfg = dataclasses.replace(cfg, in_channels=cfg.out_channels)
    return dataclasses.replace(cfg, **overrides)


@dataclasses.dataclass
class TrainRun:
    """What ``build`` makes: the trainer, the transformer it trains and the predicate on
    parameter names that selects the trained parameters."""

    trainer: Trainer
    transformer: CogVideoXTransformer3D
    trainable: Callable[[str], bool]


def _validation_fn(args, transformer, dtype, device, sample: Optional[dict]):
    """The validation sampler on the trainer's own transformer (DDIM, the pipeline's CFG),
    or None when no validation is asked for."""
    if not args.validation_every or sample is None:
        return None
    f_lat, vh, vw = sample["latents"].shape[:3]
    pcfg = CogVideoXPipelineConfig(height=vh * 8, width=vw * 8, num_frames=(f_lat - 1) * 4 + 1,
                                   num_inference_steps=args.num_validation_steps)
    cls = CogVideoXImageToVideoPipeline if args.mode == "i2v" else CogVideoXTextToVideoPipeline
    pipe = cls(config=pcfg, transformer_config=transformer.config, dtype=dtype, device=device,
               transformer=transformer)
    val_dir = os.path.join(args.output_dir, "validation")
    os.makedirs(val_dir, exist_ok=True)

    def validation_fn(state, step_no: int) -> dict:
        gen = torch.Generator(device=device).manual_seed(step_no)
        prompt = torch.as_tensor(sample["prompt_embeds"])[None]
        if args.mode == "i2v":
            latents = pipe(prompt, torch.as_tensor(sample["image_latents"])[None], generator=gen)
        else:
            latents = pipe(prompt, generator=gen)
        np.save(os.path.join(val_dir, f"step{step_no}_latents.npy"), latents.cpu().numpy())
        return {"num_samples": 1}

    return validation_fn


def build(args, sample: Optional[dict] = None, **overrides) -> TrainRun:
    """The transformer with random weights from ``--seed`` (trained parameters fp32, the rest
    in the compute dtype), the optimizer, the train step and the trainer; ``sample``: the
    first cached sample, whose conditioning ``--validation-every`` denoises; ``overrides``:
    transformer config fields (``chip_smoke.py`` cuts the full fine-tune's depth)."""
    if args.weights:
        raise NotImplementedError(WEIGHTS)
    device = require_device(args.device)
    dtype = torch.float32 if args.tiny else torch.bfloat16
    predicate = (lambda name: True) if args.full_finetune else trainable
    cfg = transformer_config(args, **overrides)
    transformer = materialize(lambda: CogVideoXTransformer3D(cfg, dtype=dtype), device, dtype,
                              fp32=predicate)
    print("random weights from --seed (no checkpoint is loaded)")
    init_params(transformer, torch.Generator(device=device).manual_seed(args.seed))
    optimizer = make_optimizer(args.learning_rate, trainable_predicate=predicate,
                               use_8bit=args.use_8bit_adam)
    state = init_train_state(transformer, optimizer)
    step = make_cogvideox_train_step(transformer, optimizer, mode=args.mode)
    trainer = Trainer(
        step, state,
        TrainerConfig(output_dir=args.output_dir, max_steps=args.max_steps,
                      checkpoint_every=args.checkpoint_every, seed=args.seed,
                      validation_every=args.validation_every or None),
        validation_fn=_validation_fn(args, transformer, dtype, device, sample),
        tracker=make_tracker(args.report_to, args.output_dir,
                             run_name=f"cogvideox_{args.mode}"))
    return TrainRun(trainer, transformer, predicate)


def export(run: TrainRun, path: str) -> int:
    """The trained parameters to ``path`` under the JAX CLI's export names."""
    return export_trainable_safetensors(run.transformer, run.trainable, path,
                                        key_map=cogvideox_export_name)


def main(argv=None) -> None:
    parser = make_parser()
    args = parser.parse_args(argv)
    if args.weights:
        parser.error(WEIGHTS)
    if not args.cache:
        parser.error("--cache is required")
    from lkgd_torch.data.datasets import PrefetchLoader
    from lkgd_torch.data.tensor_cache import PrecomputedLatentDataset

    ds = _Adapted(PrecomputedLatentDataset(args.cache), 64 if args.tiny else 4096)
    if len(ds) == 0:
        raise SystemExit("cache has no samples with latents")
    run = build(args, ds[0])
    loader = PrefetchLoader(ds, batch_size=args.batch_size, device=args.device)
    run.trainer.restore_latest()
    run.trainer.fit(iter(loader))
    n = export(run, os.path.join(args.output_dir, "model.safetensors"))
    print(f"exported {n} trainable tensors")


if __name__ == "__main__":
    main()
