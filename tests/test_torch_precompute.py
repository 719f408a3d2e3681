"""``lkgd_torch.cli.precompute_cache`` against the JAX package at tiny widths: the per-clip
encode against the JAX modules composed as ``lkgd_tpu/cli/precompute_cache.py:60-66``
composes them (the JAX CLI hardcodes the published widths, so it is not run), the CLI end
to end on two tiny mp4s and one too short with ``--weights`` written from the JAX params,
the cache read back by the JAX ``PrecomputedLatentDataset`` and by the port's CogVideoX
cache adapter, and the refusals. Tolerance: rtol 1e-4, atol 2e-4 at fp32."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from lkgd_tpu.data.tensor_cache import PrecomputedLatentDataset as JaxCacheDataset  # noqa: E402
from lkgd_tpu.models.clip_vision import CLIPVisionConfig as JaxCLIPConfig  # noqa: E402
from lkgd_tpu.models.clip_vision import CLIPVisionModelWithProjection as JaxCLIP  # noqa: E402
from lkgd_tpu.models.clip_vision import clip_normalize as jax_clip_normalize  # noqa: E402
from lkgd_tpu.models.vae_temporal import AutoencoderKLTemporalDecoder as JaxVAE  # noqa: E402
from lkgd_tpu.models.vae_temporal import TemporalVAEConfig as JaxVAEConfig  # noqa: E402
from lkgd_tpu.ops.resize import resize_with_antialiasing as jax_resize  # noqa: E402
from lkgd_tpu.utils.porting import (clip_export_key_map, export_state_dict,  # noqa: E402
                                    vae_export_key_map)

from lkgd_torch.cli import precompute_cache as pc  # noqa: E402
from lkgd_torch.data.video_io import process_frames, read_video_frames, write_video  # noqa: E402
from lkgd_torch.models import configs as tcfg  # noqa: E402
from lkgd_torch.utils.porting import (clip_key_map, save_safetensors,  # noqa: E402
                                      vae_key_map)
from tests.test_torch_porting import (TINY_CLIP, TINY_VAE, jit, port_state_dict,  # noqa: E402
                                      randomize)

RTOL, ATOL = 1e-4, 2e-4
SIZE, FRAMES = 32, 6
WIDTHS = pc.Widths(vae=tcfg.TemporalVAEConfig(**TINY_VAE), clip=tcfg.CLIPVisionConfig(**TINY_CLIP))


@pytest.fixture(scope="module")
def jax_side():
    """The tiny JAX VAE and CLIP, random params and the jitted encode of the JAX CLI."""
    vae = JaxVAE(JaxVAEConfig(**TINY_VAE), dtype=jnp.float32)
    clip = JaxCLIP(JaxCLIPConfig(**TINY_CLIP), dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    vp = randomize(jax.eval_shape(lambda: vae.init(key, jnp.zeros((1, SIZE, SIZE, 3)),
                                                   num_frames=1)), seed=3, scale=0.1)
    cp = randomize(jax.eval_shape(lambda: clip.init(key, jnp.zeros((1, 32, 32, 3)))), seed=4,
                   scale=0.1)
    size = TINY_CLIP["image_size"]

    @jit
    def encode(vp, cp, frames):
        lat = vae.apply(vp, frames, method=JaxVAE.encode_mode)
        x = jax_resize(frames[:1], (size, size))
        emb = clip.apply(cp, jax_clip_normalize((x + 1.0) / 2.0))
        return lat * 0.18215, lat[0], emb

    return vp, cp, encode


def _clip(seed, n=FRAMES, h=40, w=48):
    return np.random.default_rng(seed).random((n, h, w, 3)).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_encode_clip_matches_jax(jax_side):
    vp, cp, encode = jax_side
    args = pc.make_parser().parse_args(["--video-folder", ".", "--output", "x",
                                        "--device", "cpu"])
    enc = pc.build(args, WIDTHS)
    enc.vae.load_state_dict(port_state_dict(vp, vae_key_map), strict=True)
    enc.clip.load_state_dict(port_state_dict(cp, clip_key_map), strict=True)
    frames = process_frames(_clip(0), SIZE, SIZE)
    got = pc.encode_clip(enc, frames)
    lat, cond, emb = encode(vp, cp, jnp.asarray(frames * 2.0 - 1.0))
    assert got["latents"].shape == (FRAMES, SIZE // 2, SIZE // 2, 4)
    assert got["cond_latents"].shape == (SIZE // 2, SIZE // 2, 4)
    assert got["image_embeddings"].shape == (1, 1, TINY_CLIP["projection_dim"])
    _close(got["latents"], lat)
    _close(got["cond_latents"], cond)
    _close(got["image_embeddings"], np.asarray(emb)[:, None])


def _weights(tmp_path, vp, cp) -> str:
    folder = tmp_path / "weights"
    folder.mkdir()
    for name, params, key_map in (("vae", vp, vae_export_key_map),
                                  ("image_encoder", cp, clip_export_key_map)):
        sd = {k: np.asarray(v, np.float32) for k, v in export_state_dict(params, key_map).items()}
        save_safetensors(sd, str(folder / f"{name}.safetensors"))
    return str(folder)


def test_cli_end_to_end_with_weights(jax_side, tmp_path, capsys):
    vp, cp, encode = jax_side
    videos = tmp_path / "clips"
    videos.mkdir()
    for i, n in enumerate((FRAMES + 2, FRAMES, 3)):  # the last is too short: skipped
        write_video(str(videos / f"clip{i}.mp4"), _clip(10 + i, n))
    cache_path = str(tmp_path / "cache.lkgd")
    argv = ["--video-folder", str(videos), "--output", cache_path, "--weights",
            _weights(tmp_path, vp, cp), "--height", str(SIZE), "--width", str(SIZE),
            "--num-frames", str(FRAMES), "--device", "cpu"]
    pc.main(argv, widths=WIDTHS)
    out = capsys.readouterr().out
    assert "skip clip2: only 3 frames" in out and "done: 6 tensors" in out

    data = JaxCacheDataset(cache_path)  # the JAX package reads the port's cache
    assert data.samples == ["clip0", "clip1"]
    for name, sample in zip(data.samples, data):
        frames, _ = read_video_frames(str(videos / f"{name}.mp4"), max_frames=FRAMES)
        lat, cond, emb = encode(vp, cp, jnp.asarray(
            process_frames(frames, SIZE, SIZE) * 2.0 - 1.0))
        np.testing.assert_allclose(np.asarray(sample["latents"]), lat, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(np.asarray(sample["cond_latents"]), cond, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(np.asarray(sample["image_embeddings"]),
                                   np.asarray(emb)[:, None], rtol=RTOL, atol=ATOL)

    # the port's CogVideoX fine-tune reads it through its cache adapter
    from lkgd_torch.cli.train_cogvideox_lora import _Adapted
    from lkgd_torch.data.tensor_cache import PrecomputedLatentDataset

    sample = _Adapted(PrecomputedLatentDataset(cache_path), 64)[0]
    assert sample["latents"].shape == (FRAMES, SIZE // 2, SIZE // 2, 4)
    assert sample["image_latents"].shape == (SIZE // 2, SIZE // 2, 4)
    assert sample["prompt_embeds"].shape == (8, 64)

    pc.main(argv, widths=WIDTHS)  # a second run keeps the cached names
    out = capsys.readouterr().out
    assert "cached" not in out and "done: 6 tensors" in out


def test_refusals(tmp_path):
    base = ["--video-folder", str(tmp_path), "--output", str(tmp_path / "c.lkgd"),
            "--device", "cpu"]
    with pytest.raises(SystemExit):
        pc.main(base + ["--knowledge"], widths=WIDTHS)
    (tmp_path / "w").mkdir()
    with pytest.raises(FileNotFoundError, match="vae.safetensors"):
        pc.main(base + ["--weights", str(tmp_path / "w")], widths=WIDTHS)
