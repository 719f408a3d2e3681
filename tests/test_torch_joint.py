"""Joint x<->y stream attention in the port (``lkgd_torch.models.blocks_svd``
``_partner_streams`` / ``JointAttentionBranch``, ``models.configs``) against ``lkgd_tpu`` at
fp32 on the same inputs and weights: the partner-stream swap for alternating and
non-alternating masks with and without the frame flip, the branch in every ``post`` mode
with and without ``add_norm`` in spatial and temporal form, the LoRA router's inverted K/V
masks, ``halve_stream_masks``, the tiny joint UNet, and the LoRA state-dict import in
diffusers, peft and kohya spellings. Every leaf is random: the branch's post projections
are zero-initialised, and at init a wrong branch would pass every comparison. Tolerance
rtol 1e-4, atol 2e-4, as the other torch-oracle tests."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import blocks_svd as jblocks  # noqa: E402
from lkgd_tpu.models import configs as jcfg  # noqa: E402
from lkgd_tpu.models.unet_svd import UNetSpatioTemporalCondition as JaxUNet  # noqa: E402
from lkgd_tpu.utils import porting as jporting  # noqa: E402

from lkgd_torch.models import blocks_svd as tblocks  # noqa: E402
from lkgd_torch.models import configs as tcfg  # noqa: E402
from lkgd_torch.models.layers import materialize  # noqa: E402
from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition  # noqa: E402
from lkgd_torch.utils import porting as tporting  # noqa: E402

from tests.test_torch_porting import TINY_UNET, port_state_dict, randomize  # noqa: E402

TOL = dict(rtol=1e-4, atol=2e-4)
MASKS = [(0, 1), (0, 1, 0, 1), (0, 0, 1, 1)]
# the two LoRA rules of tests/test_pipelines_variants.py:25-28 (the CLI's, at rank 2)
RULES = (dict(pattern="*attn1n*", name="yx", rank=2, streams=(0, 1, 0, 1)),
         dict(pattern="*temporal*attn1.*", name="xy", rank=2, streams=(1, 0, 1, 0)))


def both(cls_name: str, **kw):
    return getattr(jcfg, cls_name)(**kw), getattr(tcfg, cls_name)(**kw)


def routers(rules=RULES):
    return (jcfg.LoraRouter(tuple(jcfg.LoraRule(**r) for r in rules)),
            tcfg.LoraRouter(tuple(tcfg.LoraRule(**r) for r in rules)))


@pytest.mark.parametrize("flip_frames", [False, True], ids=["temporal_call", "spatial_call"])
@pytest.mark.parametrize("flip", [False, True], ids=["noflip", "flip"])
@pytest.mark.parametrize("mask", MASKS, ids=["01", "0101", "0011"])
def test_partner_streams(mask, flip, flip_frames):
    """Rows are (streams, batch, frames) with frames innermost; the flip reverses the
    partner's frames only where the caller's rows carry them (``flip_frames``)."""
    jjoint, tjoint = both("JointAttentionConfig", mask=mask, flip=flip)
    assert jjoint.partner_perm == tjoint.partner_perm
    frames, batch = 3, 2
    x = np.random.default_rng(0).normal(size=(len(mask) * batch * frames, 5, 4)).astype(np.float32)
    want = np.asarray(jblocks._partner_streams(jnp.asarray(x), jjoint, frames, flip_frames))
    got = tblocks._partner_streams(torch.from_numpy(x), tjoint, frames, flip_frames)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, x)


@pytest.mark.parametrize("temporal", [False, True], ids=["spatial", "temporal"])
@pytest.mark.parametrize("add_norm", [False, True], ids=["plain", "add_norm"])
@pytest.mark.parametrize("post", ["conv", "scale", "conv_fuse"])
def test_joint_attention_branch(post, add_norm, temporal):
    dim, heads, dim_head, frames, temb_dim = 16, 2, 8, 3, 24
    mask = (0, 0, 1, 1) if post == "conv_fuse" else (0, 1, 0, 1)
    jjoint, tjoint = both("JointAttentionConfig", post=post, add_norm=add_norm, flip=True,
                          mask=mask, temporal=temporal)
    jlora, tlora = routers([dict(RULES[0], streams=mask)])
    path = "down_blocks.0.attentions.0.transformer_blocks.0"
    rng = np.random.default_rng(1)
    x = rng.normal(size=(len(mask) * frames, 6, dim)).astype(np.float32)
    temb = rng.normal(size=(len(mask) * frames, temb_dim)).astype(np.float32)
    jmod = jblocks.JointAttentionBranch(dim, heads, dim_head, jjoint, path, jlora,
                                        temporal=temporal)
    args = (jnp.asarray(x), frames, not temporal, jnp.asarray(temb))
    params = randomize(jax.eval_shape(lambda a, t: jmod.init(jax.random.PRNGKey(0), a, frames,
                                                             not temporal, t),
                                      args[0], args[3]), seed=2)
    port = materialize(lambda: tblocks.JointAttentionBranch(
        dim, heads, dim_head, tjoint, path, tlora, temporal=temporal, temb_channels=temb_dim),
        "cpu", torch.float32)
    port.load_state_dict(port_state_dict(params), strict=True)
    want = np.asarray(jmod.apply(params, *args))
    got = port(torch.from_numpy(x), frames, not temporal, torch.from_numpy(temb))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    assert np.abs(want).max() > 1e-3  # the branch contributes


def test_lora_router_inverts_kv_masks():
    """K and V adapters of ``attn1n`` act on the partner stream and take ``1 - streams``;
    Q and ``to_out`` keep the rule's mask, and an empty mask stays empty."""
    rules = (dict(pattern="*attn1n*", name="yx", rank=2, streams=(0, 1, 0, 1),
                  projections=("to_q", "to_k", "to_v", "to_out")),
             dict(pattern="*attn1n*", name="all", rank=3, streams=()))
    jrouter, trouter = routers(rules)
    path = "mid_block.attentions.0.transformer_blocks.0.attn1n"
    for proj in ("to_q", "to_k", "to_v", "to_out"):
        for invert in (False, True):
            want = jrouter.resolve(path, proj, invert_streams=invert)
            got = trouter.resolve(path, proj, invert_streams=invert)
            assert [dataclasses.astuple(s) for s in got] == [dataclasses.astuple(s) for s in want]
    adapters = trouter.adapters(path, invert_kv=True)
    assert adapters["to_q"][0].streams == (0, 1, 0, 1) == adapters["to_out"][0].streams
    assert adapters["to_k"][0].streams == (1, 0, 1, 0) == adapters["to_v"][0].streams
    assert adapters["to_k"][1].streams == ()


def test_stream_gate_built_under_inference_mode_serves_training():
    """Gates are built once and kept: one first asked for inside ``inference_mode`` (a
    pipeline run) must still be a normal tensor that a later training step can multiply a
    gradient-carrying tensor by."""
    from lkgd_torch.models.layers import stream_gate

    with torch.inference_mode():
        first = stream_gate((0, 1, 1, 0), 8, torch.float32, "cpu")
    again = stream_gate([0, 1, 1, 0], 8, torch.float32, "cpu")
    assert again is first and not first.is_inference()
    assert first.tolist() == [0, 0, 1, 1, 1, 1, 0, 0]
    x = torch.ones(8, requires_grad=True)
    (x * first).sum().backward()
    assert x.grad.tolist() == first.tolist()


def joint_unet_configs(**joint_kw):
    """(JAX, port) tiny joint UNet of tests/test_pipelines_variants.py:18-28: spatial and
    temporal joint, flip, the two LoRA rules."""
    kw = dict(post="conv", flip=True, mask=(0, 1, 0, 1), spatial=True, temporal=True)
    kw.update(joint_kw)
    jjoint, tjoint = both("JointAttentionConfig", **kw)
    jlora, tlora = routers()
    return (jcfg.SVDUNetConfig(**TINY_UNET, joint=jjoint, lora=jlora),
            tcfg.SVDUNetConfig(**TINY_UNET, joint=tjoint, lora=tlora))


def test_halve_stream_masks():
    jconf, tconf = joint_unet_configs()
    jhalf, thalf = jcfg.halve_stream_masks(jconf), tcfg.halve_stream_masks(tconf)
    assert thalf.joint.mask == jhalf.joint.mask == (0, 1)
    assert [r.streams for r in thalf.lora.rules] == [r.streams for r in jhalf.lora.rules] \
        == [(0, 1), (1, 0)]
    # masks shorter than four streams, and a UNet with neither joint nor LoRA, stay as they are
    assert tcfg.halve_stream_masks(thalf) == thalf
    plain = tcfg.SVDUNetConfig(**TINY_UNET)
    assert tcfg.halve_stream_masks(plain) == plain
    # the parameters do not depend on the masks: both configs build the same names and shapes
    with torch.device("meta"):
        full = {n: p.shape for n, p in UNetSpatioTemporalCondition(tconf).named_parameters()}
        half = {n: p.shape for n, p in UNetSpatioTemporalCondition(thalf).named_parameters()}
    assert full == half


def unet_inputs(rows=4, t=3, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, t, 8, 8, 8)).astype(np.float32),
            np.float32(0.3),
            rng.standard_normal((rows, 1, 64)).astype(np.float32),
            np.tile(np.array([[6, 127, 0.02]], np.float32), (rows, 1)))


@pytest.fixture(scope="module")
def joint_unet():
    jconf, tconf = joint_unet_configs()
    jmod = JaxUNet(jconf, dtype=jnp.float32)
    args = tuple(jnp.asarray(a) for a in unet_inputs())
    params = randomize(jax.eval_shape(lambda *a: jmod.init(jax.random.PRNGKey(0), *a), *args),
                       seed=12)
    port = materialize(lambda: UNetSpatioTemporalCondition(tconf), "cpu", torch.float32)
    port.load_state_dict(port_state_dict(params), strict=True)  # raises on any name off
    return jmod, params, port


def test_joint_unet_state_dict_names(joint_unet):
    """The joint parameters sit on the transformer block under diffusers' names, as the JAX
    exporter writes them (no ``joint.`` scope)."""
    _, params, port = joint_unet
    want = jporting.export_state_dict(params, key_map=jporting.svd_export_key_map)
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    block = "down_blocks.0.attentions.0.transformer_blocks.0."
    tblock = "down_blocks.0.attentions.0.temporal_transformer_blocks.0."
    for name in (block + "attn1n.to_k.weight", block + "conv1n.weight",
                 block + "attn1n.to_k.lora_yx_A", tblock + "attn1n.to_out.0.bias",
                 tblock + "conv1n.weight", tblock + "attn1.to_q.lora_xy_B"):
        np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=name)
    assert not any("joint" in n for n in got)


@pytest.mark.parametrize("joint_scale", [1.0, 0.5])
def test_joint_unet_matches_jax(joint_unet, joint_scale):
    """All leaves random; ``joint_scale`` scales the spatial branch only."""
    jmod, params, port = joint_unet
    args = unet_inputs()
    want = np.asarray(jax.jit(lambda p, *a: jmod.apply(p, *a, joint_scale=joint_scale))(
        params, *(jnp.asarray(a) for a in args)))
    with torch.no_grad():
        got = port(*(torch.as_tensor(a) for a in args), joint_scale=joint_scale).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_joint_unet_streams_interact(joint_unet):
    """Changing the y stream's input changes the x stream's output: the branch is live."""
    _, _, port = joint_unet
    args = [torch.as_tensor(a) for a in unet_inputs()]
    with torch.no_grad():
        base = port(*args)
        args[0] = args[0].clone()
        args[0][1] += 1.0  # stream 1 (y, uncond)
        moved = port(*args)
    assert (moved[0] - base[0]).abs().max() > 1e-4  # its partner, stream 0
    assert torch.equal(moved[2:], base[2:])  # the other pair is untouched


@pytest.mark.parametrize("spelling", ["diffusers", "peft", "kohya"])
def test_lora_import_round_trip_and_matches_jax(joint_unet, spelling):
    """export -> ``port_lora_safetensors`` gives the adapter back in the port, and equals
    ``lkgd_tpu.utils.porting.port_lora_safetensors`` on the same state dict."""
    _, params, port = joint_unet
    exported = tporting.export_lora_state_dict(port, "yx")
    want_jax = jporting.export_lora_safetensors(params, "yx")
    assert sorted(exported) == sorted(want_jax) and len(exported) > 0
    for name, value in want_jax.items():
        np.testing.assert_array_equal(exported[name], value, err_msg=name)

    def respell(key: str) -> str:
        if spelling == "peft":
            key = "base_model.model." + key[len("unet."):]
            return key.replace(".lora_A.weight", ".lora_A.yx.weight").replace(
                ".lora_B.weight", ".lora_B.yx.weight")
        if spelling == "kohya":
            return key.replace(".lora_A.weight", ".lora.down.weight").replace(
                ".lora_B.weight", ".lora.up.weight")
        return key

    rng = np.random.default_rng(9)
    state = {respell(k): rng.normal(size=v.shape).astype(np.float32) for k, v in exported.items()}
    state["unet.conv_in.weight"] = np.zeros((1,), np.float32)  # no LoRA tensor: skipped
    _, tconf = joint_unet_configs()
    fresh = materialize(lambda: UNetSpatioTemporalCondition(tconf), "cpu", torch.float32)
    fresh.load_state_dict(port.state_dict(), strict=True)
    n = tporting.port_lora_safetensors(state, fresh, "yx", strict=True)
    assert n == len(exported)
    # equal to the JAX importer on the same dict, through the numpy porter
    ported = jporting.port_lora_safetensors(state, params, "yx")
    want = port_state_dict(ported)
    got = fresh.state_dict()
    for name in got:
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(), err_msg=name)
    # round trip: what was imported is what the export gives back, and the xy adapter and
    # every other weight kept their values
    again = tporting.export_lora_state_dict(fresh, "yx")
    for key, value in exported.items():
        np.testing.assert_array_equal(again[key], state[respell(key)], err_msg=key)
    for name, value in port.state_dict().items():
        if "lora_yx_" not in name:
            assert torch.equal(got[name], value), name


def test_lora_import_strict_reports_strays(joint_unet):
    _, _, port = joint_unet
    state = {"unet.mid_block.nowhere.to_q.lora_A.weight": np.zeros((2, 4), np.float32)}
    with pytest.raises(ValueError, match="unused 1 LoRA keys"):
        tporting.port_lora_safetensors(state, port, "yx", strict=True)
    assert tporting.port_lora_safetensors(state, port, "yx") == 0
