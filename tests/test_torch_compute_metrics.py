"""``lkgd_torch.cli.compute_metrics`` at tiny CLIP widths: every key of its JSON against the
JAX package's metric functions on the same inputs and parameters. CLIP-H's tiny twin is
the JAX CLIP's params written to ``image_encoder.safetensors``; InceptionV3 and I3D come
from ``--inception-weights`` (a ``.pth``) and ``--i3d-weights`` (a ``.safetensors``) written
from one set of JAX parameters. The JAX CLI builds CLIP-H at its published widths and is
not run; ``fid`` and ``fvd`` hold the port's features (held to the JAX nets in
``tests/test_torch_eval.py``) through the JAX Frechet functions; ``fid``'s fit over 2048
features takes one ``scipy.linalg.sqrtm`` of 5-20 s here, so the test reads the features the
CLI fitted and holds them to the nets, and the JAX ``frechet_distance`` is held to the
port's on the same code path (full rank and rank-deficient) in ``tests/test_torch_eval.py``.
Tolerance: rtol 1e-4, atol 2e-4 at fp32; the Frechet values to 1e-4 relative."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import lkgd_tpu.eval.fid_inception as jfi  # noqa: E402
import lkgd_tpu.eval.i3d as ji  # noqa: E402
import lkgd_tpu.eval.metrics as jm  # noqa: E402
from lkgd_tpu.data.video_io import load_input  # noqa: E402
from lkgd_tpu.models.clip_vision import CLIPVisionConfig as JaxCLIPConfig  # noqa: E402
from lkgd_tpu.models.clip_vision import CLIPVisionModelWithProjection as JaxCLIP  # noqa: E402
from lkgd_tpu.utils.porting import clip_export_key_map, export_state_dict  # noqa: E402

from lkgd_torch.cli import compute_metrics as cm  # noqa: E402
from lkgd_torch.data.video_io import write_video  # noqa: E402
from lkgd_torch.eval import fid_inception as tfi  # noqa: E402
from lkgd_torch.eval import i3d as ti  # noqa: E402
from lkgd_torch.models import configs as tcfg  # noqa: E402
from lkgd_torch.utils.porting import (i3d_state_dict, inception_state_dict,  # noqa: E402
                                      save_safetensors)
from tests.test_torch_eval import _synthetic  # noqa: E402
from tests.test_torch_porting import TINY_CLIP, randomize  # noqa: E402

RTOL, ATOL = 1e-4, 2e-4
WIDTHS = cm.Widths(clip=tcfg.CLIPVisionConfig(**TINY_CLIP))


def _media(folder, seed, n_videos=2, frames=9, size=32):
    folder.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n_videos):
        write_video(str(folder / f"v{i}.gif"), rng.random((frames, size, size, 3)))
    return str(folder)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("metrics")
    gen, ref = _media(root / "gen", 1), _media(root / "ref", 2)
    depth_a, depth_b = root / "pred", root / "gt"
    depth_a.mkdir(), depth_b.mkdir()
    rng = np.random.default_rng(3)
    for i in range(2):
        d = rng.random((1, 16, 16, 3)) * 0.8 + 0.1
        write_video(str(depth_b / f"d{i}.gif"), d)
        write_video(str(depth_a / f"d{i}.gif"), np.clip(d * 0.9 + 0.05, 0, 1))

    clip = JaxCLIP(JaxCLIPConfig(**TINY_CLIP), dtype=jnp.float32)
    cparams = randomize(jax.eval_shape(lambda: clip.init(jax.random.PRNGKey(0),
                                                         jnp.zeros((1, 32, 32, 3)))), seed=8)
    (root / "w").mkdir()
    save_safetensors({k: np.asarray(v, np.float32)
                      for k, v in export_state_dict(cparams, clip_export_key_map).items()},
                     str(root / "w" / "image_encoder.safetensors"))
    inception_sd = inception_state_dict(_synthetic(jfi.init_synthetic, 1))
    torch.save(inception_sd, str(root / "inception.pth"))
    i3d_sd = i3d_state_dict(_synthetic(ji.init_synthetic, 2))
    save_safetensors({k: v.numpy() for k, v in i3d_sd.items()}, str(root / "i3d.safetensors"))
    out = root / "metrics.json"
    # the features each Frechet fit of the CLI got, by the key it fills
    fits = []
    mp = pytest.MonkeyPatch()
    for name in ("fid_from_features", "fvd_from_features"):
        def spy(real, fake, fn=getattr(cm.M, name)):
            value = fn(real, fake)
            fits.append((np.asarray(real), np.asarray(fake), value))
            return value
        mp.setattr(cm.M, name, spy)
    results = cm.main(["--generated", gen, "--reference", ref, "--weights", str(root / "w"),
                       "--inception-weights", str(root / "inception.pth"),
                       "--i3d-weights", str(root / "i3d.safetensors"),
                       "--pred-depth", str(depth_a), "--gt-depth", str(depth_b),
                       "--output", str(out), "--device", "cpu"], widths=WIDTHS)
    mp.undo()
    # clip_fid, clip_fvd, fid, fvd, in the CLI's order
    return dict(results=results, fits=dict(zip(("clip_fid", "clip_fvd", "fid", "fvd"), fits)),
                gen=gen, ref=ref, clip=clip, cparams=cparams,
                inception_sd=inception_sd, i3d_sd=i3d_sd, depth=(str(depth_a), str(depth_b)),
                out=out)


def _load(folder):
    import glob
    import os

    return [load_input(f) for f in sorted(glob.glob(os.path.join(folder, "*.gif")))]


def test_every_key_present_and_written(run):
    import json

    r = run["results"]
    assert sorted(r) == sorted(["psnr", "ssim", "clip_fid", "clip_fvd", "fid", "fvd",
                                "abs_rel", "delta1", "delta2", "delta3"])
    assert all(np.isfinite(v) for v in r.values())
    assert json.loads(run["out"].read_text()) == r


def test_pixel_and_depth_keys_match_jax(run):
    r = run["results"]
    gen, ref = _load(run["gen"]), _load(run["ref"])
    assert r["psnr"] == pytest.approx(np.mean([float(jm.psnr(jnp.asarray(g), jnp.asarray(f)))
                                               for g, f in zip(gen, ref)]), rel=RTOL)
    assert r["ssim"] == pytest.approx(np.mean([float(jm.ssim(jnp.asarray(g), jnp.asarray(f)))
                                               for g, f in zip(gen, ref)]), rel=RTOL, abs=ATOL)
    pred = np.stack([x[0].mean(-1) for x in _load(run["depth"][0])])
    gt = np.stack([x[0].mean(-1) for x in _load(run["depth"][1])])
    want = jm.depth_metrics(jnp.asarray(pred), jnp.asarray(gt))
    for k, v in want.items():
        assert r[k] == pytest.approx(v, rel=RTOL, abs=ATOL), k


def test_clip_keys_match_jax(run):
    r = run["results"]
    extract = jm.make_clip_feature_extractor(run["clip"], run["cparams"])

    def feats(videos):
        f = [np.asarray(extract(jnp.asarray(v))) for v in videos]
        return np.concatenate(f), np.stack([x.mean(0) for x in f])

    gf, gv = feats(_load(run["gen"]))
    rf, rv = feats(_load(run["ref"]))
    np.testing.assert_allclose(run["fits"]["clip_fid"][1], gf, rtol=RTOL, atol=ATOL)
    assert r["clip_fid"] == pytest.approx(jm.fid_from_features(rf, gf), rel=1e-4, abs=1e-6)
    assert r["clip_fvd"] == pytest.approx(jm.fvd_from_features(rv, gv), rel=1e-4, abs=1e-6)


def test_fid_and_fvd_keys(run):
    """The features of the first video of each side recomputed by the nets of the weight
    files; the values through the JAX Frechet functions."""
    r, fits = run["results"], run["fits"]
    inception = tfi.InceptionV3().eval()
    inception.load_state_dict(run["inception_sd"], strict=True)
    net = ti.InceptionI3d().eval()
    net.load_state_dict(run["i3d_sd"], strict=True)
    gen, ref = _load(run["gen"]), _load(run["ref"])
    ref_f, gen_f, fid = fits["fid"]
    assert gen_f.shape == ref_f.shape == (2 * 9, 2048)
    np.testing.assert_allclose(gen_f[:9], inception(torch.from_numpy(gen[0])).numpy(),
                               rtol=RTOL, atol=ATOL)
    assert r["fid"] == fid and fid > 0
    ref_v, gen_v, _ = fits["fvd"]
    assert gen_v.shape == ref_v.shape == (2, 400)
    np.testing.assert_allclose(ref_v[:1], net(cm.i3d_input(ref[0], "cpu")).numpy(),
                               rtol=RTOL, atol=ATOL)
    assert r["fvd"] == pytest.approx(jm.fvd_from_features(ref_v, gen_v), rel=1e-4)


def test_gates(tmp_path):
    """Paired metrics only when the shapes agree; clip_fvd only with two videos a side."""
    gen = _media(tmp_path / "g", 4, n_videos=1, frames=3, size=32)
    ref = _media(tmp_path / "r", 5, n_videos=2, frames=3, size=24)
    r = cm.main(["--generated", gen, "--reference", ref, "--output",
                 str(tmp_path / "m.json"), "--device", "cpu"], widths=WIDTHS)
    assert sorted(r) == ["clip_fid"]
