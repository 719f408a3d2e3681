"""CogVLM2-Caption in the port (``lkgd_torch.models.cogvlm``) against ``lkgd_tpu.models.cogvlm``
at fp32, at ``CogVLMConfig.tiny()`` with random JAX params carried across by
``cogvlm_state_dict`` (THUDM's names) and loaded strictly: the logits of two frames and a
prompt at rtol 1e-4, atol 2e-4; ``build_position_ids`` equal; ``greedy_video_caption``'s ids
equal at every step whose JAX logits' top-two margin (teacher forced on the JAX ids) exceeds
1e-3. The names: every THUDM name ``cogvlm_export_name`` gives the ``caption_8b`` template
(shapes from ``jax.eval_shape``) is the port's with the same shape, and the JAX package's
``cogvlm_key_map`` takes each back to its JAX path; ``port_cogvlm`` drops the rotary buffers."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import cogvlm as J  # noqa: E402

from lkgd_torch.models import cogvlm as P  # noqa: E402
from lkgd_torch.utils.porting import cogvlm_export_name, cogvlm_state_dict  # noqa: E402
from tests.test_torch_blip import greedy_agrees  # noqa: E402
from tests.test_torch_porting import flatten, jit  # noqa: E402
from tests.test_torch_raft import close, random_params  # noqa: E402


def _shapes(cfg):
    model = J.CogVLMVideoCaptioner(cfg)
    frames = jnp.zeros((1, 1, cfg.image_size, cfg.image_size, 3))
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0), frames,
                                 jnp.zeros((1, 4), jnp.int32))


def tiny_cogvlm(seed: int = 6):
    """(JAX model, its random params, the port's fp32 model with them)."""
    model, shapes = _shapes(J.CogVLMConfig.tiny())
    params = random_params(shapes, seed)
    port = P.build_cogvlm(P.CogVLMConfig.tiny(), "cpu", dtype=torch.float32)
    port.load_state_dict(cogvlm_state_dict(flatten(params)), strict=True)
    return model, params, port


@pytest.fixture(scope="module")
def pair():
    return tiny_cogvlm()


def frames(seed: int, t: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(1, t, 32, 32, 3)).astype(np.float32)


def test_logits(pair):
    model, params, port = pair
    f = frames(1)
    ids = np.random.default_rng(2).integers(3, 64, size=(1, 6)).astype(np.int32)
    want = np.asarray(jit(model.apply)(params, jnp.asarray(f), jnp.asarray(ids)))
    with torch.no_grad():
        got = port(torch.from_numpy(f), torch.from_numpy(ids).long())
    assert tuple(got.shape) == want.shape == (1, 6, 64)
    close(got, want)


def test_build_position_ids():
    mask = np.zeros((2, 12), bool)
    mask[0, 1:5] = mask[0, 7:9] = True
    mask[1, 2:11] = True
    np.testing.assert_array_equal(P.build_position_ids(torch.from_numpy(mask)).numpy(),
                                  np.asarray(J.build_position_ids(jnp.asarray(mask))))


def test_greedy_video_caption(pair):
    model, params, port = pair
    f = frames(3)
    prompt = np.array([[5, 9, 17]], np.int32)
    want = J.greedy_video_caption(model, params, jnp.asarray(f), prompt, max_new_tokens=6)
    got = P.greedy_video_caption(port, torch.from_numpy(f), torch.from_numpy(prompt).long(),
                                 max_new_tokens=6).numpy()
    assert got.shape == want.shape == (1, 6)
    ids = np.concatenate([prompt, want], axis=1)
    logits = np.asarray(jit(model.apply)(params, jnp.asarray(f), jnp.asarray(ids)))
    # row 2 + i of the prompt-and-caption logits predicts generated token i
    assert greedy_agrees(np.concatenate([prompt, got], 1), ids, logits, 3) >= 4


def test_caption_8b_names():
    _, shapes = _shapes(J.CogVLMConfig.caption_8b())
    leaves = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    with torch.device("meta"):
        port = {k: tuple(v.shape) for k, v in
                P.CogVLMVideoCaptioner(P.CogVLMConfig.caption_8b()).state_dict().items()}
    names = {cogvlm_export_name(path[len("params/"):]): path for path in leaves}
    assert sorted(names) == sorted(port)
    for name, path in names.items():
        shape = leaves[path]
        if path.endswith("/kernel"):
            shape = shape[::-1] if len(shape) == 2 else (shape[3], shape[2], *shape[:2])
        elif path.endswith(("cls_embedding", "position_embedding")):
            shape = shape[1:]
        assert tuple(shape) == port[name], name
        mapped = J.cogvlm_key_map(name).replace(".", "/")  # the leaf keeps torch's name
        module = path.rsplit("/", 1)[0]
        assert path == f"params/{mapped}" or module == f"params/{mapped.rsplit('/', 1)[0]}", name
    sd = {"model.layers.0.self_attn.rotary_emb.inv_freq": torch.zeros(4),
          "lm_head.weight": torch.zeros(1)}
    assert list(P.port_cogvlm(sd)) == ["lm_head.weight"]
