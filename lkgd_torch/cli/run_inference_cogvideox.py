"""CogVideoX inference with the PyTorch port (counterpart of
``lkgd_tpu/cli/run_inference_cogvideox.py``): image-, text- or video-to-video through the
latent-level pipelines, with the causal 3D VAE around them (encode the conditioning image
or video, denoise, decode).

Examples::

  # CogVideoX-5B image-to-video: 49 frames at 480x720, DPM with dynamic CFG
  python -m lkgd_torch.cli.run_inference_cogvideox --image frame.png --output clip.gif

  # text-to-video with CogVideoX-2b and a streaming decode in 2-latent-frame chunks
  python -m lkgd_torch.cli.run_inference_cogvideox --generate-type t2v --variant 2b \
      --prompt-embeds prompt.npy --vae-chunk-frames 2

  # video-to-video (SDEdit at strength 0.8), tiled VAE
  python -m lkgd_torch.cli.run_inference_cogvideox --generate-type v2v --image clip.mp4 \
      --vae-tiling --vae-tile-latent 30 45

  # sequence parallelism: the DiT's video tokens split over 2 processes, one card each
  # (NCCL; gloo with --device cpu), ring attention (or ulysses: the heads split)
  torchrun --nproc-per-node 2 -m lkgd_torch.cli.run_inference_cogvideox --image frame.png \
      --mesh context=2 --sequence-parallel ring

  # the weights split over 2 processes: tensor parallel (24 of the 48 heads a rank) or FSDP
  torchrun --nproc-per-node 2 -m lkgd_torch.cli.run_inference_cogvideox --image frame.png \
      --mesh model=2 --weight-sharding tp

  # the CFG rows over data, the video tokens over context, the weights over model: 8 ranks
  torchrun --nproc-per-node 8 -m lkgd_torch.cli.run_inference_cogvideox --image frame.png \
      --mesh data=2,context=2,model=2 --sequence-parallel ulysses --weight-sharding fsdp

Prompts are T5 embeddings from ``--prompt-embeds`` (a ``.npy`` of (L, 4096) or (B, L,
4096)), or zeros without it. It runs on the card: ``--device`` defaults to ``cuda`` and a
machine without one fails unless ``--device cpu`` is given. The weights are random, drawn
from ``--seed`` at the real shapes; ``--lora`` loads a LoRA safetensors (diffusers, peft or
kohya names) into adapters on the transformer's ``attn1`` projections that it names.

``--mesh`` runs one process a rank (launched by ``torchrun``), the product of its axis sizes
the world size: every rank builds the same weights and noise from ``--seed`` (a checksum
all-reduce of the weights and of the final latents makes a divergence an error) and rank 0
writes the video. ``context=N`` (with ``--sequence-parallel ulysses|ring``) splits the DiT's
video tokens (``parallel/sequence.py``), ``data=N`` the CFG rows, ``model=N`` the
transformer's weights as ``--weight-sharding`` says (``tp``, the default: tensor parallel;
``fsdp``: gathered at use; ``parallel/tp.py``); the CLI prints the transformer's bytes a
rank holds. ``stage=N`` makes the mesh's stage groups and nothing reads them, as in the JAX
CLI, which builds the axis and replicates the weights over it but never pipelines: each
stage rank runs the whole model (the pipeline is ``parallel/pp.py`` ``cogvideox_pp_blocks``,
a ``blocks_override`` of the transformer). Not ported: ``--weights`` (no checkpoint or T5
model is in the repository: ROADMAP.md Queue 1, item 11), which is refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from lkgd_torch.models.configs import (CogVideoXConfig, CogVideoXVAEConfig, LoraRouter,
                                       LoraRule)
from lkgd_torch.models.layers import init_params, materialize
from lkgd_torch.models.vae_cogvideox import (AutoencoderKLCogVideoX, chunked_decode,
                                             chunked_encode, tiled_decode, tiled_encode)
from lkgd_torch.pipelines.cogvideox_i2v import (CogVideoXImageToVideoPipeline,
                                                CogVideoXPipelineConfig,
                                                CogVideoXTextToVideoPipeline,
                                                CogVideoXVideoToVideoPipeline)

_PROJECTIONS = ("to_q", "to_k", "to_v", "to_out")


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--generate-type", choices=["i2v", "t2v", "v2v"], default="i2v")
    p.add_argument("--image", help="conditioning image (i2v) or input video (v2v)")
    p.add_argument("--strength", type=float, default=0.8,
                   help="v2v SDEdit strength: the fraction of the schedule re-denoised")
    p.add_argument("--output", default="output_cogvideox.gif")
    p.add_argument("--lora", help="LoRA safetensors for the transformer's attn1 projections")
    p.add_argument("--prompt-embeds", help=".npy T5 embeddings (L, 4096) or (B, L, 4096)")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=720)
    p.add_argument("--num-frames", type=int, default=49)
    p.add_argument("--num-inference-steps", type=int, default=50)
    p.add_argument("--guidance-scale", type=float, default=6.0)
    p.add_argument("--scheduler", choices=["ddim", "dpm"], default="dpm",
                   help="dpm: SDE-DPM-Solver++(2M) with dynamic CFG; ddim: deterministic")
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--tiny", action="store_true", help="tiny widths (tests)")
    p.add_argument("--variant", choices=["1.0", "1.5", "2b"], default="1.0",
                   help="1.5: CogVideoX1.5-5B (temporal patching); 2b: CogVideoX-2b "
                        "(sincos positions, t2v / v2v only)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--vae-tiling", action="store_true",
                   help="spatially tiled VAE encode and decode")
    p.add_argument("--vae-tile-latent", type=int, nargs=2, default=(60, 90), metavar=("H", "W"),
                   help="latent tile size for --vae-tiling")
    p.add_argument("--vae-chunk-frames", type=int, default=0,
                   help="streaming VAE decode (encode) in chunks of N latent frames (N x the "
                        "temporal compression pixel frames) with exact conv caches; 0 = "
                        "whole clip")
    p.add_argument("--device", default="cuda",
                   help="the card by default; a run without one fails unless cpu is named")
    p.add_argument("--mesh", help="axis=size list, e.g. 'model=2' or "
                                  "'data=2,context=2,model=2', one process (torchrun) a rank: "
                                  "'data' splits the CFG rows, 'context' the DiT's video tokens, "
                                  "'model' its weights; 'stage' is made and unread, as in the "
                                  "JAX CLI")
    p.add_argument("--sequence-parallel", choices=["none", "ulysses", "ring"], default="none",
                   help="sequence-parallel attention over the mesh's context axis: ulysses "
                        "(the heads split, H %% N == 0) or ring (K/V passed round the ranks)")
    p.add_argument("--weight-sharding", choices=["tp", "fsdp"],
                   help="how the mesh's model axis splits the transformer's weights: tp "
                        "(tensor parallel, the default) or fsdp (gathered at use)")
    # not ported: refused with the ROADMAP item that holds them
    p.add_argument("--weights", help=argparse.SUPPRESS)
    return p


def check_args(p: argparse.ArgumentParser, args) -> None:
    if args.weights:
        p.error("--weights is not ported to lkgd_torch: no CogVideoX checkpoint or T5 model "
                "is in the repository (ROADMAP.md Queue 1, item 11); weights are random from "
                "--seed")
    from lkgd_torch.parallel.mesh import CONTEXT_AXIS, MODEL_AXIS, parse_mesh

    axes = {}
    if args.mesh:
        try:
            axes = parse_mesh(args.mesh)
        except ValueError as e:
            p.error(str(e))
    if CONTEXT_AXIS in axes and args.sequence_parallel == "none":
        p.error(f"--mesh {CONTEXT_AXIS}={axes[CONTEXT_AXIS]} needs --sequence-parallel "
                f"ulysses or ring: the context axis splits the DiT's video tokens")
    if args.sequence_parallel != "none" and CONTEXT_AXIS not in axes:
        p.error("--sequence-parallel needs --mesh with a 'context' axis")
    if args.weight_sharding and MODEL_AXIS not in axes:
        p.error("--weight-sharding needs --mesh with a 'model' axis: it says how that axis "
                "splits the weights")
    if args.generate_type != "t2v" and not args.image:
        p.error(f"--image is required for --generate-type {args.generate_type}")
    if args.variant == "2b" and args.generate_type == "i2v" and not args.tiny:
        p.error("CogVideoX-2b has no I2V checkpoint (t2v / v2v only)")


def lora_rule(state_dict: dict):
    """An adapter ``lora`` on the ``attn1`` projections the LoRA file holds, at its rank
    (alpha = rank, diffusers' default)."""
    down = [v for k, v in state_dict.items() if "lora_A" in k or "lora.down" in k]
    if not down:
        raise ValueError("--lora: the file holds no LoRA factor")
    rank = int(down[0].shape[0])
    projections = tuple(p for p in _PROJECTIONS if any(f".{p}." in k for k in state_dict))
    return LoraRule("*attn1*", "lora", rank, float(rank), (), projections)


def transformer_config(args, lora=None) -> CogVideoXConfig:
    if args.tiny:
        cfg = CogVideoXConfig.tiny()
    elif args.variant == "1.5":
        cfg = CogVideoXConfig.cogvideox1_5_5b_i2v()
    elif args.variant == "2b":
        cfg = CogVideoXConfig.cogvideox_2b()
    else:
        cfg = CogVideoXConfig.cogvideox_5b_i2v()
    if args.generate_type in ("t2v", "v2v"):  # T2V checkpoints have no image channels
        cfg = dataclasses.replace(cfg, in_channels=cfg.out_channels)
    if args.sequence_parallel != "none":
        cfg = dataclasses.replace(cfg, sequence_parallel=args.sequence_parallel)
    if lora is not None:
        cfg = dataclasses.replace(cfg, lora=LoraRouter((lora,)))
    return cfg


def build(args):
    """The pipeline of ``--generate-type`` and the VAE, random weights from ``--seed`` (and
    ``--lora`` loaded). Returns (pipe, vae). With ``--mesh`` it first joins (or makes) the
    mesh's process groups, builds on this rank's device, checks that every rank holds the
    same weights, then splits the transformer's over a ``model`` axis."""
    from lkgd_torch.utils.porting import load_safetensors, port_lora_safetensors

    grid = None
    if args.mesh:
        from lkgd_torch.parallel import mesh

        grid = mesh.make_mesh(args.mesh, args.device)
        args.device = str(mesh.rank_device(args.device))

    lora_sd = load_safetensors(args.lora) if args.lora else None
    tcfg = transformer_config(args, lora_rule(lora_sd) if lora_sd else None)
    vcfg = CogVideoXVAEConfig.tiny() if args.tiny else CogVideoXVAEConfig()
    pcfg = CogVideoXPipelineConfig(
        height=args.height, width=args.width, num_frames=args.num_frames,
        num_inference_steps=args.num_inference_steps, guidance_scale=args.guidance_scale,
        scheduler=args.scheduler, vae_scale_factor_spatial=2 ** (len(vcfg.block_out_channels) - 1))
    kw = dict(config=pcfg, transformer_config=tcfg, dtype=torch.bfloat16, device=args.device,
              mesh=grid)
    if args.generate_type == "t2v":
        pipe = CogVideoXTextToVideoPipeline(**kw)
    elif args.generate_type == "v2v":
        pipe = CogVideoXVideoToVideoPipeline(strength=args.strength, **kw)
    else:
        pipe = CogVideoXImageToVideoPipeline(**kw)
    vae = materialize(lambda: AutoencoderKLCogVideoX(vcfg), pipe.device, pipe.dtype)
    vae.eval().requires_grad_(False)
    print("random weights from --seed (no checkpoint is loaded)")
    gen = torch.Generator(device=pipe.device).manual_seed(args.seed)
    pipe.init_params(gen)
    init_params(vae, gen)
    if lora_sd:
        n = port_lora_safetensors(lora_sd, pipe.transformer, "lora", strict=True)
        print(f"loaded {n} LoRA tensors from {args.lora}")
    if grid is not None:
        from lkgd_torch.parallel import tp
        from lkgd_torch.parallel.mesh import MODEL_AXIS, check_replicated

        check_replicated(list(pipe.transformer.parameters()) + list(vae.parameters()))
        if MODEL_AXIS in grid.axes:
            pg = grid.groups[MODEL_AXIS]
            if (args.weight_sharding or "tp") == "tp":
                tp.tensor_parallel(pipe.transformer, pg)
            else:
                tp.fully_shard(pipe.transformer, pg)
        print(f"transformer bytes/rank: "
              f"{tp.per_device_param_bytes(pipe.transformer) / 2**20:.0f} MiB")
    return pipe, vae


def encode(vae: AutoencoderKLCogVideoX, x: torch.Tensor, args) -> torch.Tensor:
    """[-1, 1] (B, T, H, W, 3) -> scaled latents (B, T_lat, h, w, C) fp32, in the VAE mode
    ``--vae-tiling`` / ``--vae-chunk-frames`` choose."""
    chunk = args.vae_chunk_frames * vae.temporal_scale if args.vae_chunk_frames else None
    if args.vae_tiling:
        s = vae.spatial_scale
        lat = tiled_encode(vae, x, tile_height=args.vae_tile_latent[0] * s,
                           tile_width=args.vae_tile_latent[1] * s,
                           chunk_frames=chunk if x.shape[1] > 1 else None)
    elif chunk:
        lat = chunked_encode(vae, x, chunk_frames=chunk)
    else:
        lat = vae.encode_mode(x)
    return lat.float() * vae.config.scaling_factor


def decode(vae: AutoencoderKLCogVideoX, latents: torch.Tensor, args) -> torch.Tensor:
    """Scaled latents -> [0, 1] frames (B, T, H, W, 3) fp32, in the VAE mode of the flags."""
    z = latents / vae.config.scaling_factor
    if args.vae_tiling:
        frames = tiled_decode(vae, z, tile_latent_height=args.vae_tile_latent[0],
                              tile_latent_width=args.vae_tile_latent[1],
                              chunk_latent_frames=args.vae_chunk_frames or None)
    elif args.vae_chunk_frames:
        frames = chunked_decode(vae, z, chunk_latent_frames=args.vae_chunk_frames)
    else:
        frames = vae.decode(z)
    return torch.clamp(frames.float() / 2.0 + 0.5, 0.0, 1.0)


def prompt_embeds(args, config: CogVideoXConfig) -> torch.Tensor:
    if args.prompt_embeds:
        emb = np.load(args.prompt_embeds).astype(np.float32)
        return torch.from_numpy(emb if emb.ndim == 3 else emb[None])
    print("no --prompt-embeds: zero T5 embeddings")
    return torch.zeros((1, config.max_text_seq_length, config.text_embed_dim))


@torch.inference_mode()
def generate(pipe, vae, args, prompt: torch.Tensor) -> torch.Tensor:
    """Encode the input of ``--generate-type``, denoise: the latents."""
    from lkgd_torch.data.video_io import load_input, process_frames

    gen = torch.Generator(device=pipe.device).manual_seed(args.seed)
    if args.generate_type == "t2v":
        return pipe(prompt, generator=gen)
    if args.generate_type == "v2v":
        frames = process_frames(load_input(args.image)[:args.num_frames], args.height, args.width)
        if frames.shape[0] != args.num_frames:
            raise SystemExit(f"--generate-type v2v needs {args.num_frames} input frames "
                             f"(--num-frames), got {frames.shape[0]} from {args.image}")
        video = torch.from_numpy(frames[None]).to(pipe.device) * 2.0 - 1.0
        return pipe(prompt, encode(vae, video, args), generator=gen)
    image = process_frames(load_input(args.image)[:1], args.height, args.width)
    image = torch.from_numpy(image[None]).to(pipe.device) * 2.0 - 1.0
    return pipe(prompt, encode(vae, image, args)[:, 0], generator=gen)


def main(argv=None) -> None:
    p = make_parser()
    args = p.parse_args(argv)
    check_args(p, args)

    from lkgd_torch.data.video_io import write_video

    pipe, vae = build(args)
    prompt = prompt_embeds(args, pipe.transformer.config)

    def now() -> float:
        if pipe.device.type == "cuda":
            torch.cuda.synchronize(pipe.device)
        return time.perf_counter()

    t0 = now()
    latents = generate(pipe, vae, args, prompt)
    if args.mesh:
        from lkgd_torch.parallel.mesh import check_replicated

        check_replicated([latents], None, "latents")
    t1 = now()
    with torch.inference_mode():
        video = decode(vae, latents, args)
    t2 = now()
    print(f"{t2 - t0:.3f} s/clip = encode and denoise ({args.num_inference_steps} steps) "
          f"{t1 - t0:.3f} s + decode {t2 - t1:.3f} s")
    # 1.5's temporal patching pads the latent clip: drop the extra decoded frames
    video = video[:, :args.num_frames].cpu().numpy()
    if args.mesh:
        import torch.distributed as dist

        if dist.get_rank() != 0:  # every rank holds the same video: rank 0 writes it
            return
    write_video(args.output, video[0], fps=args.fps)
    print(f"wrote {args.output}: {video[0].shape}")


if __name__ == "__main__":
    main()
