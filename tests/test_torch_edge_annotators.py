"""The edge and line-art annotators in the port (``lkgd_torch.models.hed``, ``pidinet``,
``lineart``, ``lineart_anime``) against the JAX package's at fp32, each with random JAX params
carried across by ``lkgd_torch.utils.porting``'s converters and loaded strictly:

* HED (full width; no smaller one exists) through ``hed_edge``, PiDiNet (``table5``) whole,
  the Informative-Drawings generator at full width and the Anime2Sketch U-Net at
  ``num_downs=6, ngf=8`` (the JAX package's own small test size): rtol 1e-4, atol 2e-4;
* the host code given equal inputs: ``safe_step``, ``scribble_postprocess`` and
  ``convert_pdc`` (each of the four ops) equal;
* the processors end to end from a checkpoint file under the published names, which the JAX
  processors read through their own porters (PiDiNet's file holds the raw pixel-difference
  kernels, converted on both sides) and the port through ``cli/annotate.py``'s
  ``build_edge_processor``: the soft maps at rtol 1e-4, atol 2e-4; the quantised ones
  (``*safe``, ``scribble_*``) equal but on at most 1% of the pixels, where a value within
  rounding of a step may fall either way."""

import argparse

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import hed as JH  # noqa: E402
from lkgd_tpu.models import lineart as JL  # noqa: E402
from lkgd_tpu.models import lineart_anime as JA  # noqa: E402
from lkgd_tpu.models import pidinet as JP  # noqa: E402

from lkgd_torch.cli import annotate  # noqa: E402
from lkgd_torch.models import hed as PH  # noqa: E402
from lkgd_torch.models import lineart as PL  # noqa: E402
from lkgd_torch.models import lineart_anime as PA  # noqa: E402
from lkgd_torch.models import pidinet as PP  # noqa: E402
from lkgd_torch.utils.porting import (hed_state_dict, lineart_anime_state_dict,  # noqa: E402
                                      lineart_state_dict, pidinet_state_dict, save_safetensors)
from tests.test_torch_porting import flatten, jit  # noqa: E402
from tests.test_torch_raft import close, random_params  # noqa: E402

H, W = 30, 44
SMALL_ANIME = dict(num_downs=6, ngf=8)


def image(seed: int, h: int = H, w: int = W) -> np.ndarray:
    return np.random.default_rng(seed).uniform(size=(h, w, 3)).astype(np.float32)


def _params(model, hw, seed):
    x = jnp.zeros((1, *hw, 3))
    return random_params(jax.eval_shape(model.init, jax.random.PRNGKey(0), x), seed)


@pytest.fixture(scope="module")
def hed():
    model = JH.ControlNetHED()
    params = _params(model, (32, 32), 1)
    for i in range(1, 6):  # edges above one half, which the scribble's threshold keeps
        params["params"][f"block{i}"]["projection"]["bias"] = jnp.full((1,), 1.0)
    port = PH.build_hed("cpu")
    port.load_state_dict(hed_state_dict(flatten(params)), strict=True)
    return model, params, port


@pytest.fixture(scope="module")
def pidinet():
    model = JP.PiDiNet()
    params = _params(model, (32, 32), 2)
    port = PP.build_pidinet("cpu")
    port.load_state_dict(pidinet_state_dict(flatten(params)), strict=True)
    return model, params, port


def _save(sd: dict, path) -> str:
    save_safetensors({k: np.asarray(v, np.float32) for k, v in sd.items()}, str(path))
    return str(path)


def _args(annotation: str, path: str) -> argparse.Namespace:
    return argparse.Namespace(annotation=annotation, weights=path, device="cpu",
                              model_size="small")


def _labels_close(got, want, quantised: bool):
    assert got.shape == want.shape and got.dtype == np.float32
    assert len(np.unique(want)) > 1, "a constant label map proves nothing"
    if quantised:
        assert (got != want).mean() <= 0.01, (got != want).mean()
    else:
        close(got, want)


def test_hed_edge(hed):
    model, params, port = hed
    x = np.stack([image(3), image(4)])
    want = np.asarray(jit(lambda p, img: JH.hed_edge(model, p, img))(params, jnp.asarray(x)))
    with torch.no_grad():
        got = PH.hed_edge(port, torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, H, W)
    assert want.std() > 1e-3
    close(got, want)


def test_host_postprocessing_is_the_jax_packages():
    edge = np.random.default_rng(5).uniform(size=(H, W)).astype(np.float32)
    edge[8:12] = 0.9  # a line for the scribble to keep
    np.testing.assert_array_equal(PH.safe_step(edge), np.asarray(JH.safe_step(jnp.asarray(edge))))
    np.testing.assert_array_equal(PH.scribble_postprocess(edge), JH.scribble_postprocess(edge))
    w = np.random.default_rng(6).normal(size=(4, 3, 3, 3)).astype(np.float32)
    for op in ("cv", "cd", "ad", "rd"):
        np.testing.assert_array_equal(PP.convert_pdc(op, w), JP.convert_pdc(op, w), err_msg=op)
    assert all(PP.pdc_op_for(k.replace("module.", "")) == JP._pdc_op_for(k) for k in
               ("init_block.weight", "block1_1.conv1.weight", "block3_4.conv1.weight",
                "module.block4_2.conv1.weight", "block2_1.conv2.weight"))


@pytest.mark.parametrize("annotation", ["softedge_hed", "scribble_hed"])
def test_hed_processor_from_a_checkpoint_file(hed, tmp_path, annotation):
    _, params, _ = hed
    path = _save({f"netNetwork.{k}": v for k, v in hed_state_dict(flatten(params)).items()},
                 tmp_path / "ControlNetHED.safetensors")
    want_fn = JH.make_hed_processor(path, scribble=annotation.startswith("scribble"),
                                    safe=annotation.endswith("hedsafe"))
    got_fn = annotate.build_edge_processor(_args(annotation, path))
    img = image(7)
    _labels_close(got_fn(img), want_fn(img), annotation != "softedge_hed")


def test_pidinet(pidinet):
    model, params, port = pidinet
    x = np.stack([image(8, 32, 48)])
    want = np.asarray(jit(model.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (1, 32, 48)
    assert want.std() > 1e-3
    close(got, want)


@pytest.mark.parametrize("annotation", ["softedge_pidinet"])
def test_pidinet_processor_from_a_raw_checkpoint(tmp_path, annotation):
    """``table5_pidinet.pth`` holds the raw pixel-difference kernels (a radial difference's
    3x3): both sides convert them."""
    rng = np.random.default_rng(9)
    with torch.device("meta"):
        names = PP.PiDiNet().state_dict()
    raw = {}
    for name, t in names.items():
        shape = (t.shape[0], 1, 3, 3) if PP.pdc_op_for(name) == "rd" else tuple(t.shape)
        fan_in = int(np.prod(shape[1:])) if len(shape) == 4 else 1
        raw[f"module.{name}"] = rng.normal(size=shape) / np.sqrt(fan_in) * (
            1.0 if len(shape) == 4 else 0.1)
    path = _save(raw, tmp_path / "table5_pidinet.safetensors")
    want_fn = JP.make_pidinet_processor(path, safe=annotation.endswith("pidsafe"))
    got_fn = annotate.build_edge_processor(_args(annotation, path))
    img = image(10)
    _labels_close(got_fn(img), want_fn(img), annotation.endswith("pidsafe"))


@pytest.fixture(scope="module")
def lineart():
    model = JL.LineartGenerator(JL.LineartConfig())
    params = _params(model, (32, 32), 11)
    port = PL.build_lineart(PL.LineartConfig(), "cpu")
    port.load_state_dict(lineart_state_dict(flatten(params)), strict=True)
    return model, params, port


def test_lineart(lineart, tmp_path):
    model, params, port = lineart
    x = image(12, 32, 44)[None]
    want = np.asarray(jit(model.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (1, 32, 44, 1)
    assert want.std() > 1e-3
    close(got, want)
    path = _save(lineart_state_dict(flatten(params)), tmp_path / "sk_model.safetensors")
    img = image(13)
    _labels_close(annotate.build_edge_processor(_args("lineart", path))(img),
                  JL.make_lineart_processor(path)(img), False)


def test_lineart_anime(tmp_path, monkeypatch):
    jcfg, pcfg = JA.LineartAnimeConfig(**SMALL_ANIME), PA.LineartAnimeConfig(**SMALL_ANIME)
    model = JA.LineartAnimeGenerator(jcfg)
    params = _params(model, (64, 64), 14)
    sd = lineart_anime_state_dict(flatten(params))
    port = PA.build_lineart_anime(pcfg, "cpu")
    port.load_state_dict(sd, strict=True)
    assert PA.lineart_anime_key(3, 6, "up") == JA._torch_key(3, 6, "up") == (
        "model.model.1.model.3.model.3.model.5")
    x = np.random.default_rng(15).uniform(-1, 1, size=(1, 64, 128, 3)).astype(np.float32)
    want = np.asarray(jit(model.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (1, 64, 128, 1)
    assert want.std() > 1e-3
    close(got, want)
    path = _save(sd, tmp_path / "netG.safetensors")
    monkeypatch.setattr(PA, "LineartAnimeConfig", lambda: pcfg)  # the CLI builds the published size
    img = image(16, 50, 70)
    want_fn = JA.make_lineart_anime_processor(
        JA.port_lineart_anime({k: v.numpy() for k, v in sd.items()}, jcfg), jcfg)
    _labels_close(annotate.build_edge_processor(_args("lineart_anime", path))(img),
                  want_fn(img), False)
