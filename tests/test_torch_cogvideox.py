"""The port's CogVideoX transformer (``lkgd_torch.models.cogvideox``) against
``lkgd_tpu.models.cogvideox`` at fp32 on the CPU, on the same weights: the rotary and
sincos tables, the knowledge fusion in its CogVideoX form at the published width, the tiny
DiT in its 1.0, 1.5 and 2b forms with knowledge features and a LoRA router on ``attn1``
(every parameter random, the zero-init ones included), the diffusers names of a JAX
export loaded strictly, and the plain flash version against the JAX package's padded
Pallas wrapper at a ragged joint sequence.

JAX params come from ``jax.eval_shape`` plus numpy randoms, and the JAX forward is jitted.
Tolerances: rtol 1e-4 / atol 2e-4 on the outputs (fp32, matmuls summed in another order);
the tables 1e-5; the flash plain version against Pallas 2e-5, as the port's flash tests."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from lkgd_tpu.models import cogvideox as jcog  # noqa: E402
from lkgd_tpu.models.configs import LoraRouter as JaxRouter  # noqa: E402
from lkgd_tpu.models.configs import LoraRule as JaxRule  # noqa: E402
from lkgd_tpu.ops import flash_attention as jfa  # noqa: E402
from lkgd_tpu.ops import fusion as jfusion  # noqa: E402
from lkgd_tpu.utils.porting import cogvideox_export_key_map, export_state_dict  # noqa: E402

from lkgd_torch.models import cogvideox as tcog  # noqa: E402
from lkgd_torch.models import configs as tcfg  # noqa: E402
from lkgd_torch.models.layers import init_params, materialize  # noqa: E402
from lkgd_torch.ops import flash_attention as tfa  # noqa: E402
from lkgd_torch.ops import fusion as tfusion  # noqa: E402
from lkgd_torch.utils.porting import cogvideox_key_map  # noqa: E402

from tests.test_torch_porting import flatten, port_state_dict, randomize  # noqa: E402

TOL = dict(rtol=1e-4, atol=2e-4)
# the tiny DiT's forms: (JAX config overrides, latent frames, frame size)
VARIANTS = {"1.0": ({}, 3, 8), "1.5": ({"patch_size_t": 2}, 4, 8),
            "2b": ({"use_rope": False, "in_channels": 4}, 3, 8)}


def jax_config(variant: str, lora: bool = True) -> jcog.CogVideoXConfig:
    rules = (JaxRule("*attn1*", "lora", 2, 2.0, (), ("to_q", "to_k", "to_v", "to_out")),)
    return dataclasses.replace(jcog.CogVideoXConfig.tiny(lora=JaxRouter(rules if lora else ())),
                               **VARIANTS[variant][0])


def torch_config(variant: str, lora: bool = True) -> tcfg.CogVideoXConfig:
    rules = (tcfg.LoraRule("*attn1*", "lora", 2, 2.0, (), ("to_q", "to_k", "to_v", "to_out")),)
    return dataclasses.replace(
        tcfg.CogVideoXConfig.tiny(lora=tcfg.LoraRouter(rules if lora else ())),
        **VARIANTS[variant][0])


def jax_params(cfg, inputs, seed: int = 21):
    model = jcog.CogVideoXTransformer3D(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *(jnp.asarray(x) for x in inputs))
    return randomize(shapes, seed=seed)


def dit_inputs(cfg, seed: int = 0, batch: int = 2):
    """Latents, T5 tokens, timesteps and domain / flow features of width 1000 (one token for
    every text token, one side of the CFG batch), numpy float32."""
    _, frames, size = VARIANTS["1.5" if cfg.patch_size_t else "1.0"]
    rng = np.random.default_rng(seed)
    f32 = np.float32
    latents = rng.normal(size=(batch, frames, size, size, cfg.in_channels)).astype(f32)
    text = rng.normal(size=(batch, cfg.max_text_seq_length, cfg.text_embed_dim)).astype(f32)
    t = np.array([37.0, 901.0][:batch], f32)
    domain = rng.normal(size=(1, 1, 1000)).astype(f32)
    flow = rng.normal(size=(1, 1, 1000)).astype(f32)
    return latents, text, t, domain, flow


def port_transformer(variant: str, params, lora: bool = True):
    model = materialize(lambda: tcog.CogVideoXTransformer3D(torch_config(variant, lora)), "cpu",
                        torch.float32)
    model.load_state_dict(port_state_dict(params, cogvideox_key_map), strict=True)
    return model.eval()


def test_rope_tables_and_rotary_match_jax():
    for shape in ((3, 4, 5, 16), (13, 30, 45, 64)):
        want_c, want_s = jcog.rope_3d(*shape)
        got_c, got_s = tcog.rope_3d(*shape)
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)
    cos, sin = jcog.rope_3d(2, 3, 4, 16)
    x = np.random.default_rng(1).normal(size=(2, 24, 3, 16)).astype(np.float32)
    want = np.asarray(jcog.apply_rotary(jnp.asarray(x), cos, sin))
    got = tcog.apply_rotary(torch.from_numpy(x), torch.from_numpy(np.asarray(cos)),
                            torch.from_numpy(np.asarray(sin))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("args", [(64, 3, 4, 5), (3072, 13, 30, 45)], ids=["tiny", "2b"])
def test_sincos_positions_match_jax(args):
    want = np.asarray(jcog.sincos_pos_embed_3d(*args))
    got = tcog.sincos_pos_embed_3d(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_fusion_cogvideox_form_at_published_width():
    """d=256, knowledge dim 1024, recombine 1024->512->4096 with the zero-init output (random
    here), one domain/flow token broadcast over 226 T5 tokens and over a CFG-doubled batch."""
    rng = np.random.default_rng(2)
    ctx = rng.normal(size=(2, 226, 4096)).astype(np.float32)
    domain = rng.normal(size=(1, 1, 1000)).astype(np.float32)
    flow = rng.normal(size=(1, 1, 1000)).astype(np.float32)
    kw = dict(ctx_dim=4096, knowledge_dim=1024, compress_dim=256, sf_hidden=512,
              zero_init_output=True)
    jmod = jfusion.LatentKnowledgeFusion(**kw)
    params = randomize(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(ctx),
                                      jnp.asarray(domain), jnp.asarray(flow)), seed=5)
    want = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(ctx), jnp.asarray(domain),
                                          jnp.asarray(flow)))
    port = materialize(lambda: tfusion.LatentKnowledgeFusion(**kw), "cpu", torch.float32)
    port.load_state_dict(port_state_dict(params), strict=True)
    got = port(torch.from_numpy(ctx), torch.from_numpy(domain), torch.from_numpy(flow))
    assert got.shape == ctx.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    # the zero-init output: a fresh fusion adds nothing until trained
    init_params(port, torch.Generator().manual_seed(0))
    assert not port.fuse_sf_2.weight.any() and not port.fuse_sf_2.bias.any()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_jax_export_names_load_strictly(variant):
    """The port's state-dict names are the JAX export's with ``cogvideox_export_key_map``
    (diffusers' names, ``quaternion_lora_*`` for the fusion), values equal, every 2D
    kernel in torch's layout."""
    cfg = jax_config(variant)
    inputs = dit_inputs(cfg)
    params = jax_params(cfg, inputs)
    want = export_state_dict(params, key_map=cogvideox_export_key_map)
    got = port_state_dict(params, cogvideox_key_map)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), value, err_msg=name)
    model = port_transformer(variant, params)
    names = set(model.state_dict())
    assert names == set(want)
    assert {"quaternion_lora_fuse_sf.2.weight", "transformer_blocks.1.attn1.to_out.0.lora_lora_B",
            "transformer_blocks.0.ff.net.0.proj.weight", "patch_embed.proj.weight",
            "norm_out.linear.weight"} <= names


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_transformer_matches_jax(variant):
    """The tiny DiT's forward with knowledge features and rank-2 LoRA on every projection
    of ``attn1``, every parameter random."""
    cfg = jax_config(variant)
    latents, text, t, domain, flow = dit_inputs(cfg)
    params = jax_params(cfg, (latents, text, t, domain, flow))
    model = jcog.CogVideoXTransformer3D(cfg)
    want = np.asarray(jax.jit(lambda p, *a: model.apply(p, a[0], a[1], a[2], domain_features=a[3],
                                                        flow_features=a[4]))(
        params, *(jnp.asarray(x) for x in (latents, text, t, domain, flow))))
    port = port_transformer(variant, params)
    with torch.no_grad():
        got = port(*(torch.from_numpy(x) for x in (latents, text, t)),
                   domain_features=torch.from_numpy(domain), flow_features=torch.from_numpy(flow))
    assert got.shape == latents.shape[:-1] + (cfg.out_channels,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_knowledge_features_and_lora_move_the_output():
    """With every leaf random, the domain features and the LoRA factors reach the output: a
    wrong branch could not pass the parity test by adding nothing."""
    cfg = jax_config("1.0")
    latents, text, t, domain, flow = dit_inputs(cfg)
    params = jax_params(cfg, (latents, text, t, domain, flow))
    port = port_transformer("1.0", params)
    args = [torch.from_numpy(x) for x in (latents, text, t)]
    with torch.no_grad():
        base = port(*args, domain_features=torch.from_numpy(domain),
                    flow_features=torch.from_numpy(flow))
        other_domain = port(*args, domain_features=torch.from_numpy(2 * domain),
                            flow_features=torch.from_numpy(flow))
        for name, p in port.named_parameters():
            if name.endswith("lora_lora_B"):
                p.zero_()
        no_lora = port(*args, domain_features=torch.from_numpy(domain),
                       flow_features=torch.from_numpy(flow))
    assert (base - other_domain).abs().max() > 1e-3
    assert (base - no_lora).abs().max() > 1e-3


def test_plain_flash_matches_padded_pallas_on_a_joint_sequence():
    """A joint [text | video] sequence of 8 + 3 x 6 x 9 = 170 tokens tiles no block: the JAX
    wrapper pads to a block multiple and masks keys past the valid length; the port's plain
    versions (and kernels) never pad."""
    rng = np.random.default_rng(7)
    shape = (2, 8 + 3 * 6 * 9, 3, 64)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    for plain in (tfa.flash_attention_bound_plain, tfa.flash_attention_maxtrack_plain):
        got = plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_configs_match_jax():
    """The port's configs carry the JAX package's values, the sequence-parallel fields
    among them."""
    for name in ("cogvideox_5b_i2v", "cogvideox_2b", "cogvideox1_5_5b", "cogvideox1_5_5b_i2v",
                 "tiny"):
        want = dataclasses.asdict(getattr(jcog.CogVideoXConfig, name)())
        got = dataclasses.asdict(getattr(tcfg.CogVideoXConfig, name)())
        want.pop("lora")
        got.pop("lora")
        assert got == want, name
    assert tcfg.CogVideoXConfig().inner_dim == 3072
    with torch.device("meta"):
        n = sum(p.numel() for p in tcog.CogVideoXTransformer3D().parameters())
    assert 5.5e9 < n < 5.7e9, n
