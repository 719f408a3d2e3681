"""The SD-2D models of the port (``lkgd_torch.models.unet_2d``, ``vae_2d``, ``controlnet_2d``,
``clip_text``) against ``lkgd_tpu`` at fp32 on the CPU, on the tiny configs of
``tests/test_sd2d.py:19-24`` (``TINY_UNET``, ``TINY_VAE``), every parameter random (the
zero-init ``conv_out`` of the conditioning embedder, ``conv_fuse``, the ControlNet's heads
and the joint branch's post projections included), the JAX params carried by
``lkgd_torch.utils.porting`` and loaded with ``strict=True``:

* the UNet in every option, joined into three cases: per-sample timesteps, 9 input channels
  with the conditioning encoder, joint attention (``conv_fuse``) with stream-masked LoRA
  and ``joint_scale``, ControlNet residuals, and track fusion on the latent grid and in
  pixels (``track_image_size``);
* the export names: the port's state dict is ``export_state_dict(params,
  unet2d_export_key_map)``, name for name and value for value;
* the VAE's ``encode_mode``, ``encode_sample`` (JAX's noise given) and ``decode``;
* ControlNet-2D's residuals at ``conditioning_scale`` 0.7;
* the CLIP text tower at ``output_hidden_state_index`` -1 and -2.

Tolerance rtol 1e-4, atol 2e-4, the repo's parity tolerance."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import clip_text as jclip  # noqa: E402
from lkgd_tpu.models import configs as jcfg  # noqa: E402
from lkgd_tpu.models import controlnet_2d as jcn  # noqa: E402
from lkgd_tpu.models import unet_2d as junet  # noqa: E402
from lkgd_tpu.models import vae_2d as jvae  # noqa: E402
from lkgd_tpu.utils.porting import export_state_dict, unet2d_export_key_map  # noqa: E402

from lkgd_torch.cli import run_inference_sd2d as cli  # noqa: E402
from lkgd_torch.models import clip_text as tclip  # noqa: E402
from lkgd_torch.models import configs as tcfg  # noqa: E402
from lkgd_torch.models import controlnet_2d as tcn  # noqa: E402
from lkgd_torch.models import unet_2d as tunet  # noqa: E402
from lkgd_torch.models import vae_2d as tvae  # noqa: E402
from lkgd_torch.models.layers import materialize  # noqa: E402
from lkgd_torch.utils.porting import clip_text_key_map, unet2d_key_map, vae_key_map  # noqa: E402

from tests.test_torch_porting import jit, port_state_dict, randomize  # noqa: E402

TOL = dict(rtol=1e-4, atol=2e-4)
# tests/test_sd2d.py:19-24, the CLI's --tiny widths
TINY_UNET = dict(in_channels=4, **cli.TINY_UNET)
TINY_VAE = cli.TINY_VAE
EMB = (16, 32, 96)  # two stride-2 convolutions: the tiny VAE's factor of 4
S, LAT = 32, 8


def unet_configs(variant: str):
    """(JAX, port) UNet2DConfig of one case. The cases join options, each option in one:
    ``base`` (per-sample timesteps, ControlNet residuals), ``inpaint_tracks`` (9 input
    channels, the conditioning encoder, track fusion on the latent grid),
    ``joint_conv_fuse_tracks`` (joint attention with the ``conv_fuse`` post projection, two
    LoRA rules, one stream-masked, ``joint_scale``, track fusion with tracks in pixels of
    ``track_image_size``). The ``conv`` post projection runs in the joint-control pipeline
    and train-step tests."""
    out = []
    for c in (jcfg, tcfg):
        kw = {}
        if variant == "inpaint_tracks":
            kw = dict(in_channels=9, cond_embedding_channels=3, cond_embedding_blocks=EMB,
                      track_fusion=True)
        elif variant.startswith("joint"):
            kw = dict(joint=c.JointAttentionConfig(post="conv_fuse", mask=(0, 1, 0, 1),
                                                   spatial=True),
                      lora=c.LoraRouter((c.LoraRule("*attn1*", "xy", 2, 4.0, (1, 0, 1, 0)),
                                         c.LoraRule("*attn2*", "all", 2, 2.0))),
                      track_fusion=True)
        ucfg = junet.UNet2DConfig if c is jcfg else tcfg.UNet2DConfig
        out.append(ucfg(**{**TINY_UNET, **kw}))
    return tuple(out)


def unet_inputs(variant: str, seed: int = 0) -> tuple:
    """(args, kwargs) as numpy: sample, per-sample timesteps, context; the case's extras."""
    rng = np.random.default_rng(seed)
    rows = 4
    cin = 9 if variant == "inpaint_tracks" else 4
    args = (rng.normal(size=(rows, LAT, LAT, cin)).astype(np.float32),
            np.asarray([3.0, 999.0, 500.0, 41.0], np.float32),
            rng.normal(size=(rows, 5, 32)).astype(np.float32))
    kw = {}
    if variant == "inpaint_tracks":
        kw["cond_image"] = rng.uniform(size=(rows, S, S, 3)).astype(np.float32)
    if variant.startswith("joint"):
        kw["joint_scale"] = 0.7
    if variant == "base":
        widths = (32, 32, 32, 64)  # conv_in, down 0, its downsampler, down 1
        sizes = (LAT, LAT, LAT // 2, LAT // 2)
        kw["down_block_additional_residuals"] = tuple(
            rng.normal(size=(rows, s, s, c)).astype(np.float32) for c, s in zip(widths, sizes))
        kw["mid_block_additional_residual"] = rng.normal(
            size=(rows, LAT // 2, LAT // 2, 64)).astype(np.float32)
    if variant.endswith("tracks"):
        pixels = variant.startswith("joint")
        extent = S if pixels else LAT
        pairs, n_tracks = rows // 2, 12
        kw["tracks"] = (rng.uniform(-1, extent + 1, (pairs, n_tracks, 2)).astype(np.float32),
                        rng.uniform(0, extent, (pairs, n_tracks, 2)).astype(np.float32),
                        (rng.random((pairs, n_tracks)) > 0.3).astype(np.float32))
        if pixels:
            kw["track_image_size"] = (S, S)
    return args, kw


def _jax(x):
    return jax.tree.map(lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a, x)


def _torch(x):
    return jax.tree.map(lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a, x)


VARIANTS = ["base", "inpaint_tracks", "joint_conv_fuse_tracks"]


@pytest.fixture(scope="module", params=VARIANTS)
def unet_case(request):
    variant = request.param
    jc, tc = unet_configs(variant)
    args, kw = unet_inputs(variant)
    model = junet.UNet2DCondition(jc)
    init_kw = {k: v for k, v in kw.items() if k in ("cond_image", "tracks")}
    params = randomize(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), *_jax(args), **_jax(init_kw))), seed=20 + VARIANTS.index(variant))
    static = {k: v for k, v in kw.items() if k in ("joint_scale", "track_image_size")}
    dynamic = {k: v for k, v in kw.items() if k not in static}
    want = jit(lambda p, a, d: model.apply(p, *a, **d, **static))(
        params, _jax(args), _jax(dynamic))
    port = materialize(lambda: tunet.UNet2DCondition(tc), "cpu", torch.float32)
    port.load_state_dict(port_state_dict(params, unet2d_key_map), strict=True)
    return dict(variant=variant, params=params, args=args, kw=kw, want=np.asarray(want),
                port=port)


def test_unet_matches_jax(unet_case):
    with torch.no_grad():
        got = unet_case["port"](*_torch(unet_case["args"]), **_torch(unet_case["kw"]))
    assert got.shape == unet_case["want"].shape
    np.testing.assert_allclose(got.numpy(), unet_case["want"], **TOL)


def test_unet_export_names_load_strictly(unet_case):
    """The port's names and values are the JAX exporter's with ``unet2d_export_key_map``:
    diffusers' ``UNet2DConditionModel`` names."""
    want = export_state_dict(unet_case["params"], key_map=unet2d_export_key_map)
    got = port_state_dict(unet_case["params"], unet2d_key_map)
    assert sorted(got) == sorted(want) == sorted(unet_case["port"].state_dict())
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), value, err_msg=name)
    marker = {"base": "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight",
              "inpaint_tracks": "cond_embedding.blocks.3.weight",
              "joint_conv_fuse_tracks": "up_blocks.1.attentions.1.transformer_blocks.0.conv_fuse"}
    assert any(marker[unet_case["variant"]] in n for n in got), marker[unet_case["variant"]]


def test_tracks_change_the_output_and_zero_init_leaves_it():
    """With ``conv_fuse`` random the tracks move both streams; at its zero init they move
    nothing (the JAX test's identity, here in the port)."""
    _, tc = unet_configs("joint_conv_fuse_tracks")
    args, kw = unet_inputs("joint_conv_fuse_tracks")
    port = materialize(lambda: tunet.UNet2DCondition(tc), "cpu", torch.float32)
    from lkgd_torch.models.layers import init_params

    init_params(port, torch.Generator().manual_seed(0))
    with torch.no_grad():
        plain = port(*_torch(args))
        fused = port(*_torch(args), **_torch(kw))
        assert torch.equal(plain, fused)
        for name, p in port.named_parameters():
            if "conv_fuse" in name:
                p.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(1))
        moved = port(*_torch(args), **_torch(kw))
    assert (moved - plain).abs().amax(dim=(1, 2, 3)).min() > 1e-4


@pytest.fixture(scope="module")
def vae_case():
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, size=(2, S, S, 3)).astype(np.float32)
    model = jvae.AutoencoderKL(jvae.VAE2DConfig(**TINY_VAE))
    params = randomize(jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                                         jnp.asarray(x))), seed=7)
    key = jax.random.PRNGKey(3)

    def run(p, x):
        z = model.apply(p, x, method=jvae.AutoencoderKL.encode_mode)
        return (z, model.apply(p, x, method=jvae.AutoencoderKL.encode_moments),
                model.apply(p, x, key, method=jvae.AutoencoderKL.encode_sample),
                model.apply(p, z, method=jvae.AutoencoderKL.decode))

    z, moments, sample, decoded = jit(run)(params, jnp.asarray(x))
    port = materialize(lambda: tvae.AutoencoderKL(tcfg.VAE2DConfig(**TINY_VAE)), "cpu",
                       torch.float32)
    port.load_state_dict(port_state_dict(params, vae_key_map), strict=True)
    # encode_sample's draw: normal(key) of the mean's shape, as the JAX module draws it
    noise = jax.random.normal(key, z.shape, jnp.float32)
    return dict(x=x, z=np.asarray(z), sample=np.asarray(sample), decoded=np.asarray(decoded),
                moments=np.asarray(moments), noise=np.asarray(noise), port=port)


@pytest.mark.parametrize("method", ["encode_mode", "encode_sample", "decode", "roundtrip"])
def test_vae_matches_jax(vae_case, method):
    port, x = vae_case["port"], torch.from_numpy(vae_case["x"])
    with torch.no_grad():
        if method == "encode_mode":
            got, want = port.encode_mode(x), vae_case["z"]
        elif method == "encode_sample":
            got = port.encode_sample(x, noise=torch.tensor(vae_case["noise"]))
            want = vae_case["sample"]
            assert vae_case["moments"][..., 4:].min() < 0  # the clip's range is exercised
        elif method == "decode":
            got, want = port.decode(torch.from_numpy(vae_case["z"])), vae_case["decoded"]
        else:
            got, want = port(x), vae_case["decoded"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_controlnet_matches_jax():
    rng = np.random.default_rng(9)
    args = (rng.normal(size=(2, LAT, LAT, 4)).astype(np.float32),
            np.asarray([1.0, 700.0], np.float32), rng.normal(size=(2, 5, 32)).astype(np.float32),
            rng.uniform(size=(2, S, S, 3)).astype(np.float32))
    jconfig = jcn.ControlNet2DConfig(unet=junet.UNet2DConfig(**TINY_UNET),
                                     conditioning_embedding_out_channels=EMB)
    model = jcn.ControlNet2D(jconfig)
    params = randomize(jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                                         *_jax(args))), seed=13)
    down, mid = jit(lambda p, a: model.apply(p, *a, conditioning_scale=0.7))(
        params, _jax(args))
    port = materialize(lambda: tcn.ControlNet2D(tcfg.ControlNet2DConfig(
        unet=tcfg.UNet2DConfig(**TINY_UNET), conditioning_embedding_out_channels=EMB)), "cpu",
        torch.float32)
    sd = port_state_dict(params, unet2d_key_map)
    assert sorted(sd) == sorted(export_state_dict(params, key_map=unet2d_export_key_map))
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got_down, got_mid = port(*_torch(args), conditioning_scale=0.7)
    assert len(got_down) == len(down) == 4
    for g, w in zip(got_down + (got_mid,), tuple(down) + (mid,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.fixture(scope="module")
def clip_case():
    ids = np.random.default_rng(2).integers(0, 128, size=(2, 16))
    model = jclip.CLIPTextModel(jclip.CLIPTextConfig.tiny())
    params = randomize(jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                                         jnp.asarray(ids))), seed=17)
    port = materialize(lambda: tclip.CLIPTextModel(tcfg.CLIPTextConfig.tiny()), "cpu",
                       torch.float32)
    port.load_state_dict(port_state_dict(params, clip_text_key_map), strict=True)
    return dict(ids=ids, params=params, model=model, port=port)


@pytest.mark.parametrize("index", [-1, -2], ids=["last", "penultimate"])
def test_clip_text_matches_jax(clip_case, index):
    want = clip_case["model"].apply(clip_case["params"], jnp.asarray(clip_case["ids"]),
                                    output_hidden_state_index=index)
    with torch.no_grad():
        got = clip_case["port"](torch.from_numpy(clip_case["ids"]), index)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert "text_model.encoder.layers.1.self_attn.q_proj.weight" in clip_case["port"].state_dict()


def test_clip_text_is_causal(clip_case):
    """A later token changes no earlier position's state."""
    ids = torch.from_numpy(clip_case["ids"])
    moved = ids.clone()
    moved[:, 9:] = (moved[:, 9:] + 1) % 128
    with torch.no_grad():
        a, b = clip_case["port"](ids), clip_case["port"](moved)
    assert torch.equal(a[:, :9], b[:, :9]) and not torch.equal(a[:, 9:], b[:, 9:])


def test_open_clip_h_and_sd2_shapes():
    """The published widths build on the meta device with SD2's parameter counts (text
    encoder 340,387,840; UNet 865,910,724, five more input channels for inpainting)."""
    with torch.device("meta"):
        text = tclip.CLIPTextModel(tcfg.CLIPTextConfig.open_clip_h())
        unets = [tunet.UNet2DCondition(tcfg.UNet2DConfig(in_channels=c)) for c in (4, 9)]
    assert sum(p.numel() for p in text.parameters()) == 340_387_840
    assert [sum(p.numel() for p in u.parameters()) for u in unets] == [865_910_724,
                                                                        865_910_724 + 5 * 9 * 320]
    assert tcfg.UNet2DConfig().time_embed_dim == 1280
