"""BLIP in the port (``lkgd_torch.models.blip``) against ``lkgd_tpu.models.blip`` at fp32, at the
JAX package's own tiny configuration (``tests/test_blip.py``) with random JAX params carried
across by ``blip_state_dict`` (HF's names) and loaded strictly: the logits at rtol 1e-4, atol
2e-4; ``greedy_caption``'s ids equal at every step whose JAX logits' top-two margin (teacher
forced on the JAX ids) exceeds 1e-3; ``preprocess_images`` equal; the port's state dict read
back by the JAX package's ``port_blip`` (HF's names) to the same params."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import blip as J  # noqa: E402

from lkgd_torch.models import blip as P  # noqa: E402
from lkgd_torch.utils.porting import blip_state_dict  # noqa: E402
from tests.test_torch_porting import flatten, jit  # noqa: E402
from tests.test_torch_raft import close, random_params  # noqa: E402

TINY = dict(image_size=32, patch_size=8, vision_hidden=48, vision_layers=2, vision_heads=2,
            vision_intermediate=96, vocab_size=64, text_hidden=32, text_layers=2, text_heads=2,
            text_intermediate=64, max_position_embeddings=32, bos_token_id=60, sep_token_id=61,
            pad_token_id=0)


def tiny_blip(seed: int = 5):
    """(JAX model, its random params, the port's model with them)."""
    model = J.BlipCaptioner(J.BlipConfig(**TINY))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 4), jnp.int32))
    params = random_params(shapes, seed)
    port = P.build_blip(P.BlipConfig(**TINY), "cpu")
    port.load_state_dict(blip_state_dict(flatten(params)), strict=True)
    return model, params, port


def greedy_agrees(got: np.ndarray, want: np.ndarray, logits: np.ndarray, first: int):
    """``got`` equals ``want`` at every decoded position up to the first whose logits (teacher
    forced on ``want``; row ``i`` predicts position ``i + 1``) have a top-two margin of 1e-3
    or less; returns how many positions were held."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    held = 0
    for i in range(first, want.shape[1]):
        if margin[:, i - 1].min() <= 1e-3:
            break
        np.testing.assert_array_equal(got[:, i], want[:, i], err_msg=f"step {i}")
        held += 1
    return held


@pytest.fixture(scope="module")
def pair():
    return tiny_blip()


def test_logits(pair):
    model, params, port = pair
    rng = np.random.default_rng(0)
    pixels = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 60, size=(2, 7)).astype(np.int32)
    want = np.asarray(jit(model.apply)(params, jnp.asarray(pixels), jnp.asarray(ids)))
    with torch.no_grad():
        got = port(torch.from_numpy(pixels), torch.from_numpy(ids).long())
    assert tuple(got.shape) == want.shape == (2, 7, 64)
    close(got, want)


def test_greedy_caption(pair):
    model, params, port = pair
    pixels = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = J.greedy_caption(model, params, jnp.asarray(pixels), max_length=10)
    got = P.greedy_caption(port, torch.from_numpy(pixels), max_length=10).numpy()
    assert got.shape == want.shape == (2, 10) and (got[:, 0] == 60).all()
    logits = np.asarray(jit(model.apply)(params, jnp.asarray(pixels), jnp.asarray(want)))
    assert greedy_agrees(got, want, logits, 1) >= 5


def test_preprocess_images():
    images = np.random.default_rng(2).uniform(size=(2, 40, 56, 3)).astype(np.float32)
    np.testing.assert_array_equal(P.preprocess_images(images, 32),
                                  np.asarray(J.preprocess_images(images, 32)))


def test_published_names(pair):
    """The port's state dict is HF's: the JAX porter, which reads HF's names, takes it back to
    the very params, and the tied prediction bias stands under both of its names."""
    _, params, port = pair
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = flatten(J.port_blip(sd, J.BlipConfig(**TINY)))
    want = flatten(params)
    assert sorted(back) == sorted(want)
    for name, value in want.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)
    np.testing.assert_array_equal(sd["text_decoder.cls.predictions.bias"],
                                  sd["text_decoder.cls.predictions.decoder.bias"])
