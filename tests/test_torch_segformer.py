"""SegFormer in the port (``lkgd_torch.models.segformer``) against ``lkgd_tpu.models.segformer``
at fp32, at ``SegformerConfig.tiny()`` with random JAX params carried across by
``segformer_state_dict`` (HF's names) and loaded strictly: the logits at rtol 1e-4, atol 2e-4;
the B4 configuration's names against the JAX templates through the same
converter; the palette equal; the ``segmentation`` processor from a file through
``cli/annotate.py``'s ``build_segmentation_processor`` (``segformer_config`` set to tiny), which
the JAX processor reads through ``port_segformer``: the class map equal wherever the JAX
logits' top-two margin exceeds 1e-3, the palette image likewise."""

import argparse

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import segformer as J  # noqa: E402
from lkgd_tpu.utils.porting import load_state_dict as jax_load  # noqa: E402

from lkgd_torch.cli import annotate  # noqa: E402
from lkgd_torch.models import segformer as P  # noqa: E402
from lkgd_torch.utils.porting import save_safetensors, segformer_state_dict  # noqa: E402
from tests.test_torch_porting import flatten, jit  # noqa: E402
from tests.test_torch_raft import close, random_params  # noqa: E402


def _shapes(cfg):
    return jax.eval_shape(J.SegformerForSemanticSegmentation(cfg).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3)))


@pytest.fixture(scope="module")
def pair():
    cfg = J.SegformerConfig.tiny()
    params = random_params(_shapes(cfg), 4)
    port = P.build_segformer(P.SegformerConfig.tiny(), "cpu")
    port.load_state_dict(segformer_state_dict(flatten(params)), strict=True)
    return J.SegformerForSemanticSegmentation(cfg), params, port


def test_tiny_logits(pair):
    model, params, port = pair
    x = np.random.default_rng(1).normal(size=(2, 64, 96, 3)).astype(np.float32)
    want = np.asarray(jit(model.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, 16, 24, 5)
    close(got, want)


@pytest.mark.parametrize("size", ["b4_ade"])
def test_published_names(size):
    """The HF names the converter gives the JAX template of B4 (B0 is B4 with fewer blocks
    and narrower stages) are the port's; ``--model-size`` picks B0 or B4 as the JAX CLI
    does."""
    shapes = flatten(jax.tree.map(lambda s: np.zeros((1,) * len(s.shape), np.float32),
                                  _shapes(getattr(J.SegformerConfig, size)())))
    names = segformer_state_dict(shapes)
    with torch.device("meta"):
        port = P.SegformerForSemanticSegmentation(getattr(P.SegformerConfig, size)()).state_dict()
    assert sorted(names) == sorted(port)
    assert len(shapes) == len(names) - 1  # the port's BatchNorm counts its batches
    assert P.segformer_config("base") == P.SegformerConfig.b4_ade() == P.SegformerConfig()
    assert P.segformer_config("small") == P.SegformerConfig.b0_ade()
    assert J.SegformerConfig.b0_ade() == J.SegformerConfig(**vars(P.SegformerConfig.b0_ade()))


def test_palette():
    np.testing.assert_array_equal(P.ade_palette(), J.ade_palette())


def test_processor_from_a_checkpoint_file(pair, tmp_path, monkeypatch):
    model, params, port = pair
    path = str(tmp_path / "segformer.safetensors")
    save_safetensors({k: v.numpy() for k, v in segformer_state_dict(flatten(params)).items()},
                     path)
    cfg = J.SegformerConfig.tiny()
    jparams = J.port_segformer(jax_load(path), _shapes(cfg))
    monkeypatch.setattr(P, "segformer_config", lambda size: P.SegformerConfig.tiny())
    got_fn = annotate.build_segmentation_processor(argparse.Namespace(
        annotation="segmentation", weights=path, device="cpu", model_size="small"))
    # 0-255 values, which both processors divide by 255 (the CLI's [0, 1] frames too)
    image = np.random.default_rng(3).uniform(size=(50, 70, 3)).astype(np.float32) * 255
    logits = np.asarray(jit(model.apply)(jparams, J.normalize_pixels(jnp.asarray(
        np.pad(image / 255.0, ((0, 14), (0, 26), (0, 0))))[None])))[0]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 1e-3
    assert sure.mean() > 0.9
    labels = P.segformer_labels(port, image)
    np.testing.assert_array_equal(labels[sure], logits.argmax(-1)[sure])
    got, want = got_fn(image), J.make_segmentation_processor(jparams, cfg)(image)
    assert got.shape == want.shape == (50, 70, 3) and got.dtype == want.dtype == np.uint8
    assert len(np.unique(want.reshape(-1, 3), axis=0)) > 1
    near = np.kron(sure, np.ones((4, 4), bool))[:50, :70]
    np.testing.assert_array_equal(got[near], want[near])

