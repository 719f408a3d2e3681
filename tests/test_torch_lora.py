"""LoRA in the port (``lkgd_torch.models.layers.DenseWithLora``, ``models.configs.LoraRouter``)
against ``lkgd_tpu`` at fp32: the adapter layer with and without a stream mask, the set of
parameters the router resolves on the tiny UNet, and that UNet's forward with knowledge
fusion and a temporal LoRA. LoRA B factors are random (non-zero) so the adapter paths
contribute. Tolerance rtol 1e-4, atol 2e-4, as the other torch-oracle tests."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import configs as jcfg  # noqa: E402
from lkgd_tpu.models import layers as jlayers  # noqa: E402
from lkgd_tpu.models.unet_svd import UNetSpatioTemporalCondition as JaxUNet  # noqa: E402
from lkgd_tpu.utils.porting import export_state_dict  # noqa: E402

from lkgd_torch.models import configs as tcfg  # noqa: E402
from lkgd_torch.models import layers as tlayers  # noqa: E402
from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition  # noqa: E402

from tests.test_torch_porting import TINY_UNET, port_state_dict, randomize  # noqa: E402

TOL = dict(rtol=1e-4, atol=2e-4)
# the tiny LKGD configuration of tests/test_training.py:18-24, plus an adapter on the
# spatial self-attention's output projection so that to_out routing is covered too
RULES = (dict(pattern="*temporal*attn1.*", name="ft", rank=2),
         dict(pattern="*.transformer_blocks.0.attn1*", name="sp", rank=3, alpha=6.0,
              projections=("to_out",)))


def tiny_lkgd_configs():
    """(JAX, port) tiny UNet configs with knowledge fusion and the LoRA rules above."""
    return (jcfg.SVDUNetConfig(**TINY_UNET, knowledge_fusion=True,
                               lora=jcfg.LoraRouter(tuple(jcfg.LoraRule(**r) for r in RULES))),
            tcfg.SVDUNetConfig(**TINY_UNET, knowledge_fusion=True,
                               lora=tcfg.LoraRouter(tuple(tcfg.LoraRule(**r) for r in RULES))))


def tiny_lkgd_inputs(b=2, t=4, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, 8, 8, 8)).astype(np.float32),
            np.array([0.3, -1.2][:b], np.float32),
            rng.standard_normal((b, 1, 64)).astype(np.float32),
            np.tile(np.array([[6, 127, 0.02]], np.float32), (b, 1)),
            rng.standard_normal((b, 1, 48)).astype(np.float32),
            rng.standard_normal((b, 1, 48)).astype(np.float32))


@pytest.fixture(scope="module")
def tiny_lkgd():
    jconf, tconf = tiny_lkgd_configs()
    jmod = JaxUNet(jconf, dtype=jnp.float32)
    args = tuple(jnp.asarray(a) for a in tiny_lkgd_inputs())
    shapes = jax.eval_shape(lambda *a: jmod.init(jax.random.PRNGKey(0), *a[:4],
                                                 domain_features=a[4], flow_features=a[5]),
                            *args)
    params = randomize(shapes, seed=12)
    port = tlayers.materialize(lambda: UNetSpatioTemporalCondition(tconf), "cpu", torch.float32)
    return jmod, params, port


def trainable(path: str) -> bool:
    return "lora_" in path or "knowledge_fusion" in path


@pytest.mark.parametrize("streams", [(), (0, 1)], ids=["all_rows", "stream_mask"])
def test_dense_with_lora(streams):
    x = np.random.default_rng(0).normal(size=(4, 5, 24)).astype(np.float32)
    spec = (jlayers.LoraSpec("a", rank=3, alpha=6.0, streams=streams),
            jlayers.LoraSpec("b", rank=2, alpha=2.0))
    jmod = jlayers.DenseWithLora(16, adapters=spec)
    params = randomize(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x)), seed=1)
    tspec = tuple(tlayers.LoraSpec(s.name, s.rank, s.alpha, s.streams) for s in spec)
    port = tlayers.materialize(lambda: tlayers.DenseWithLora(24, 16, adapters=tspec), "cpu",
                               torch.float32)
    port.load_state_dict(port_state_dict(params), strict=True)
    assert port.lora_a_A.shape == (24, 3) and port.lora_a_B.shape == (3, 16)
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_stream_gate():
    got = tlayers.stream_gate((0, 1, 1), 6, torch.float32)
    want = np.asarray(jlayers.stream_gate((0, 1, 1), 6, jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)


def test_router_resolves_the_jax_parameters(tiny_lkgd):
    """The port's parameter names, all and trainable, are the JAX export's names."""
    _, params, port = tiny_lkgd
    names = sorted(port.state_dict())
    assert names == sorted(export_state_dict(params))
    got = sorted(n for n in names if trainable(n))
    want = sorted(export_state_dict(params, path_predicate=trainable))
    assert got == want
    lora = [n for n in got if "lora_" in n]
    assert "down_blocks.0.attentions.0.temporal_transformer_blocks.0.attn1.to_q.lora_ft_A" in lora
    assert "up_blocks.1.attentions.1.transformer_blocks.0.attn1.to_out.0.lora_sp_B" in lora
    # 4 transformers (down 0, mid, up 1 twice): temporal attn1 to_q/k/v and spatial attn1
    # to_out, each with A and B
    assert len(lora) == 4 * 3 * 2 + 4 * 2


def test_rule_matching_is_fnmatch_or_substring():
    rule = tcfg.LoraRule("temporal_transformer_blocks", "x")
    assert rule.matches("down_blocks.0.attentions.0.temporal_transformer_blocks.0.attn2", "to_k")
    assert not rule.matches("down_blocks.0.attentions.0.temporal_transformer_blocks.0.attn2",
                            "to_out")
    router = tcfg.LoraRouter((tcfg.LoraRule("*attn1n*", "yx", streams=(0, 1)),))
    assert router.resolve("m.attn1n", "to_k")[0].streams == (0, 1)
    assert router.resolve("m.attn1n", "to_out") == ()


def test_tiny_lkgd_unet(tiny_lkgd):
    """The tiny UNet with knowledge fusion and LoRA equals the JAX one on the same weights."""
    jmod, params, port = tiny_lkgd
    port.load_state_dict(port_state_dict(params), strict=True)
    inputs = tiny_lkgd_inputs()
    fn = jax.jit(lambda p, s, t, e, i, d, f: jmod.apply(p, s, t, e, i, domain_features=d,
                                                         flow_features=f))
    want = np.asarray(fn(params, *map(jnp.asarray, inputs)))
    with torch.no_grad():
        got = port(*map(torch.from_numpy, inputs[:4]), domain_features=torch.from_numpy(
            inputs[4]), flow_features=torch.from_numpy(inputs[5])).numpy()
    np.testing.assert_allclose(got, want, **TOL)
