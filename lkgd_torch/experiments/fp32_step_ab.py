"""Time the fp32 LKGD fine-tune's steps one at a time, in turns across checkouts of this
repository.

    python -m lkgd_torch.experiments.fp32_step_ab [ROOT ...] [--steps 8]

Each ROOT (default: this checkout) runs in a process of its own, in the order given, with
its own build of the kernels and its own ``lkgd_torch``: name a parent and a change as
``parent change change parent`` to see the drift under load beside the difference. The
set-up is ``chip_smoke.py`` phase 8o's: ``train_svd_lora --dtype fp32`` with the CLI's
defaults (512x512, 14 frames, batch 1, rank 4, no remat), cuDNN TF32 on as the CLI runs it,
random clips from a seed. After one step that builds and warms, each of ``--steps`` steps
is timed alone (wall, after a synchronize), with the caching allocator's device mallocs and
frees in it. One JSON line a root: the steps' seconds, their mean, and the mallocs. The card's
name and power limit come first. The card only.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import torch


def _time_here(steps: int) -> dict:
    """Step times of the ``lkgd_torch`` on ``sys.path`` (the root's), on the current card."""
    from lkgd_torch.cli import train_svd_lora as cli

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory() as out:
        args = cli.make_parser().parse_args(
            ["--output-dir", out, "--dtype", "fp32", "--device", "cuda", "--checkpoint-every",
             "0", "--max-steps", "1", "--seed", "0"])
        trainer = cli.build(args).trainer
        gen = torch.Generator(device=dev).manual_seed(6)
        clips = [{"pixel_values": torch.rand((1, 15, 512, 512, 3), generator=gen,
                                             device=dev) * 2 - 1} for _ in range(steps + 1)]
        trainer.fit(iter(clips[:1]))
        torch.cuda.synchronize()
        trainer.config.log_every = 10 ** 9
        times, mallocs, frees = [], [], []
        for clip in clips[1:]:
            before = torch.cuda.memory_stats()
            trainer.config.max_steps = trainer.state.step + 1
            t0 = time.perf_counter()
            trainer.fit(iter([clip]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            after = torch.cuda.memory_stats()
            mallocs.append(after.get("num_device_alloc", 0) - before.get("num_device_alloc", 0))
            frees.append(after.get("num_device_free", 0) - before.get("num_device_free", 0))
    return {"step_s": times, "mean_s": sum(times) / len(times), "device_mallocs": mallocs,
            "device_frees": frees}


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("roots", nargs="*", help="checkouts to time, in turn (default: this one)")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:  # inside a root: its own lkgd_torch, no other module of this checkout
        print(json.dumps(_time_here(args.steps)), flush=True)
        return []

    from lkgd_torch.experiments._timing import device_line
    from lkgd_torch.experiments.kernel_ab import run_roots
    from lkgd_torch.utils.device import require_device

    print(device_line(require_device("cuda")), flush=True)
    return run_roots(__file__, args.roots, ["--steps", str(args.steps)])


if __name__ == "__main__":
    main()
