"""DPT-hybrid and DPT-large in the port (``lkgd_torch.models.midas``) against
``lkgd_tpu.models.midas`` at fp32: ``MidasConfig.tiny()`` and ``tiny_large()`` with the JAX
params carried across by ``dpt_hybrid_state_dict`` / ``dpt_large_state_dict`` and loaded
strictly, the hybrid also on a non-square grid that resamples its position embedding;
``midas_resize_shape`` on a table of sizes; both processors end to end on one image with
their checkpoints written to a file from the JAX params under the published names, which
the JAX processors read through their own porters (``port_midas``, ``port_dpt_large``) and
the port loads strictly through ``cli/annotate.py``'s ``build_depth_processor``.
Tolerance rtol 1e-4, atol 2e-4 of the depth normalised by its largest value (the random
tiny models reach depths of ~1e1-1e2); the ``depth`` processor's output to one level of
its uint8 round trip (1/255), since a value a rounding away from an integer level may
truncate either way, on at most 1% of the pixels."""

import argparse

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import midas as J  # noqa: E402

from lkgd_torch.cli import annotate  # noqa: E402
from lkgd_torch.models import midas as P  # noqa: E402
from lkgd_torch.utils.porting import (dpt_hybrid_state_dict, dpt_large_state_dict,  # noqa: E402
                                      save_safetensors)
from tests.test_torch_porting import flatten, jit  # noqa: E402
from tests.test_torch_raft import close, random_params  # noqa: E402

KINDS = {"hybrid": (J.DPTHybridDepth, J.MidasConfig.tiny(), P.MidasConfig.tiny(),
                    dpt_hybrid_state_dict),
         "large": (J.DPTLargeDepth, J.MidasConfig.tiny_large(), P.MidasConfig.tiny_large(),
                   dpt_large_state_dict)}


def _pair(kind: str):
    module, jcfg, pcfg, convert = KINDS[kind]
    model = module(jcfg)
    x = jnp.zeros((1, jcfg.image_size, jcfg.image_size, 3))
    params = random_params(jax.eval_shape(model.init, jax.random.PRNGKey(0), x), 5)
    # a positive last bias keeps the final ReLU from zeroing the whole depth map
    params["params"]["head_conv3"]["bias"] = jnp.full((1,), 0.5)
    port = P.build_dpt(kind, pcfg, device="cpu")
    port.load_state_dict(convert(flatten(params)), strict=True)
    return model, params, port


@pytest.fixture(scope="module")
def pairs():
    return {kind: _pair(kind) for kind in KINDS}


def _close_scaled(got, want):
    scale = np.abs(want).max()
    assert scale > 1e-3
    close(got.numpy() / scale, want / scale)


@pytest.mark.parametrize("kind,hw", [("hybrid", (64, 64)), ("hybrid", (64, 96)),
                                     ("large", (64, 64))])
def test_tiny_model(pairs, kind, hw):
    model, params, port = pairs[kind]
    x = np.random.default_rng(1).uniform(-1, 1, size=(2, *hw, 3)).astype(np.float32)
    want = np.asarray(jit(model.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, *hw)
    _close_scaled(got, want)


def test_midas_resize_shape_table():
    for h, w in ((576, 1024), (1024, 576), (384, 384), (100, 1000), (511, 513), (50, 60),
                 (720, 1280), (2000, 300)):
        for method in ("minimal", "lower_bound", "upper_bound"):
            assert (P.midas_resize_shape(h, w, method=method)
                    == J.midas_resize_shape(h, w, method=method)), (h, w, method)
    assert P.midas_resize_shape(576, 1024) == (384, 672)


@pytest.mark.parametrize("annotation,kind", [("depth_midas", "hybrid"), ("depth", "large")])
def test_processor_from_a_checkpoint_file(pairs, tmp_path, monkeypatch, annotation, kind):
    model, params, _ = pairs[kind]
    path = str(tmp_path / f"{kind}.safetensors")
    save_safetensors({k: v.numpy() for k, v in KINDS[kind][3](flatten(params)).items()}, path)
    jcfg, pcfg = KINDS[kind][1], KINDS[kind][2]
    # the CLI builds the published configurations: here the tiny ones stand in for them
    if kind == "hybrid":
        want_fn = J.make_midas_processor(path, jcfg)
        monkeypatch.setattr(P, "MidasConfig", lambda: pcfg)
    else:
        want_fn = J.make_depth_processor(path, jcfg)
        monkeypatch.setattr(P.MidasConfig, "large", classmethod(lambda cls: pcfg))
    args = argparse.Namespace(annotation=annotation, weights=path, device="cpu",
                              model_size="small")
    got_fn = annotate.build_depth_processor(args)
    image = np.random.default_rng(2).uniform(size=(50, 70, 3)).astype(np.float32)
    want, got = want_fn(image), got_fn(image)
    assert got.shape == want.shape == (50, 70, 3) and got.dtype == np.float32
    if annotation == "depth_midas":
        close(got, want)
    else:
        diff = np.abs(got - want)
        assert diff.max() <= 1.0 / 255 + 1e-6 and (diff > 0).mean() <= 0.01, diff.max()
        assert len(np.unique(want)) > 10
