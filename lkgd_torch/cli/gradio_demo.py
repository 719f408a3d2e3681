"""Gradio demo over the base and trans pipelines (counterpart of
``lkgd_tpu/cli/gradio_demo.py``).

Gradio is optional and imported only here, when the demo starts; without it the demo falls
back to the standard-library server of ``cli/web_demo.py`` (the same controls and the same
pipeline adapter, ``build_generate_fn``).

  python -m lkgd_torch.cli.gradio_demo [--mode trans] [--port 7860]

It runs on the card: ``--device`` defaults to ``cuda`` and a machine without one fails unless
``--device cpu`` is given. Random weights from ``--seed``; ``--weights`` is refused (ROADMAP.md
Queue 1, item 6).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from lkgd_torch.cli import web_demo


def build_demo(generate, mode: str):
    """A Gradio interface over ``generate`` (``web_demo.build_generate_fn``'s adapter)."""
    import gradio as gr

    from lkgd_torch.data.video_io import write_mp4

    out_dir = tempfile.mkdtemp(prefix="lkgd_gradio_")

    def run(image, end_image, seed, motion_bucket_id, fps):
        start = np.asarray(image, np.float32) / 255.0
        end = None if end_image is None else np.asarray(end_image, np.float32) / 255.0
        video = generate(start, end, int(seed), int(motion_bucket_id), int(fps))
        out = os.path.join(out_dir, "out.mp4")
        write_mp4(out, video, fps=int(fps))
        return out

    inputs = [gr.Image(label="start frame"),
              gr.Image(label="end frame (trans mode)", visible=(mode == "trans")),
              gr.Number(value=23123134, label="seed"),
              gr.Slider(1, 255, value=127, label="motion bucket"),
              gr.Slider(1, 30, value=7, label="fps")]
    return gr.Interface(fn=run, inputs=inputs, outputs=gr.Video(), title=f"LKGD {mode}")


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=["base", "trans"], default="base")
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--num-frames", type=int, default=14)
    p.add_argument("--seed", type=int, default=23123134)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", default="cuda",
                   help="the card by default; a run without one fails unless cpu is named")
    p.add_argument("--weights", help=argparse.SUPPRESS)  # refused, naming its item
    return p


def main(argv=None, widths=None) -> None:
    p = make_parser()
    args = p.parse_args(argv)
    if args.weights:
        p.error(f"--weights is not ported to lkgd_torch: no checkpoint is in the repository "
                f"({web_demo.WEIGHTS[args.mode]}); weights are random from --seed")
    try:
        import gradio  # noqa: F401
        have_gradio = True
    except ImportError:
        print("gradio is not installed: serving the standard-library web demo instead")
        have_gradio = False
    generate = web_demo.build_generate_fn(web_demo.build_svd(args, widths), args.mode)
    if have_gradio:
        build_demo(generate, args.mode).launch(server_port=args.port)
    else:
        web_demo.serve(generate, args.mode, args.port)


if __name__ == "__main__":
    main()
