"""The SD-2D pipelines of the port (``lkgd_torch.pipelines.sd2d``) and its CLI
(``lkgd_torch.cli.run_inference_sd2d``) against ``lkgd_tpu.pipelines.sd2d`` at fp32 on the
CPU: the tiny configs of ``tests/test_sd2d.py`` (32x32 images, a VAE of factor 4, 2 DDIM
steps), every parameter random (the zero-init heads included), the JAX params carried by
``lkgd_torch.utils.porting``, and JAX's draw of the starting latents given as
``initial_noise`` (``normal(rng, (b, h, w, 4))``; joint control ``normal(split(rng)[0],
(2b, h, w, 4))``):

* inpaint, with a mask whose edges fall between latent cells (JAX's nearest resize samples
  at half-pixel centres), and inpaint with ControlNet-2D;
* joint control with a joint UNet (``post="conv"``, mask ``(0, 1, 0, 1)``): ``cond_x`` at
  one pair, and ``cond_y`` with a ``spatial_mask`` at two pairs;
* the condition pipeline with a condition image;
* ``optimize_latents`` against JAX's on the same guidance loss;
* the row pairing of joint control at two pairs (rows pair across pairs, as in JAX: the
  record of ``ROADMAP.md`` Queue 3);
* the CLI at tiny widths on the CPU (both modes, the PNG written), its refusals, and the
  double scaling of its image that it mirrors from the JAX CLI.

Images and latents at rtol 1e-4, atol 2e-4, the repo's parity tolerance."""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import configs as jcfg  # noqa: E402
from lkgd_tpu.models.controlnet_2d import ControlNet2DConfig as JaxCNConfig  # noqa: E402
from lkgd_tpu.models.unet_2d import UNet2DConfig as JaxUNetConfig  # noqa: E402
from lkgd_tpu.models.vae_2d import VAE2DConfig as JaxVAEConfig  # noqa: E402
from lkgd_tpu.pipelines import sd2d as jpipe  # noqa: E402

from lkgd_torch.cli import run_inference_sd2d as cli  # noqa: E402
from lkgd_torch.models import configs as tcfg  # noqa: E402
from lkgd_torch.pipelines import sd2d as tpipe  # noqa: E402
from lkgd_torch.utils.porting import unet2d_key_map, vae_key_map  # noqa: E402

from tests.test_torch_porting import jit, port_state_dict, randomize  # noqa: E402
from tests.test_torch_sd2d import EMB, TINY_UNET, TINY_VAE  # noqa: E402

TOL = dict(rtol=1e-4, atol=2e-4)
S, LAT, STEPS, CTX = 32, 8, 2, 4
KEY = jax.random.PRNGKey(7)
KEY_MAPS = {"unet": unet2d_key_map, "vae": vae_key_map, "controlnet": unet2d_key_map}


def configs(kind: str):
    """(JAX kwargs, port kwargs) of the pipeline constructors."""
    out = []
    for c, unet_cls, vae_cls, pcfg in (
            (jcfg, JaxUNetConfig, JaxVAEConfig, jpipe.SD2DPipelineConfig),
            (tcfg, tcfg.UNet2DConfig, tcfg.VAE2DConfig, tpipe.SD2DPipelineConfig)):
        kw = dict(config=pcfg(height=S, width=S, num_inference_steps=STEPS),
                  vae_config=vae_cls(**TINY_VAE))
        if kind.startswith("inpaint"):
            kw["unet_config"] = unet_cls(**{**TINY_UNET, "in_channels": 9})
        if kind == "inpaint_controlnet":
            cn_cls = JaxCNConfig if c is jcfg else tcfg.ControlNet2DConfig
            kw["controlnet_config"] = cn_cls(unet=unet_cls(**TINY_UNET),
                                             conditioning_embedding_out_channels=EMB)
        if kind.startswith("joint"):
            kw["unet_config"] = unet_cls(**TINY_UNET, joint=c.JointAttentionConfig(
                post="conv", mask=(0, 1, 0, 1), spatial=True))
            kw["cond_x"] = kind == "joint_x"
        if kind == "condition":
            kw["unet_config"] = unet_cls(**TINY_UNET, cond_embedding_channels=3,
                                         cond_embedding_blocks=EMB)
        out.append(kw)
    return tuple(out)


CLASSES = {"inpaint": "StableDiffusionInpaintPipeline",
           "inpaint_controlnet": "StableDiffusionInpaintPipeline",
           "joint_x": "StableDiffusionJointControlPipeline",
           "joint_y": "StableDiffusionJointControlPipeline",
           "condition": "StableDiffusionConditionPipeline"}


@functools.cache
def param_shapes(kind: str):
    """The JAX pipeline's parameter shapes, traced once a kind (``cond_x`` moves none)."""
    jkw, _ = configs(kind)
    return jax.eval_shape(getattr(jpipe, CLASSES[kind])(dtype=jnp.float32, **jkw).init_params,
                          jax.random.PRNGKey(0))


def pipelines(kind: str, seed: int):
    """The JAX pipeline with random params and the port's with the same weights."""
    jkw, tkw = configs(kind)
    jax_pipe = getattr(jpipe, CLASSES[kind])(dtype=jnp.float32, **jkw)
    jax_pipe._generate = jit(jax_pipe._generate_impl)  # the pipeline's own, FAST_COMPILE
    params = randomize(param_shapes("joint_x" if kind == "joint_y" else kind), seed=seed)
    port = getattr(tpipe, CLASSES[kind])(dtype=torch.float32, device="cpu", **tkw)
    for name in params:
        getattr(port, name).load_state_dict(port_state_dict(params[name], KEY_MAPS[name]),
                                            strict=True)
    return jax_pipe, params, port


def inputs(b: int, seed: int):
    rng = np.random.default_rng(seed)
    image = rng.uniform(size=(b, S, S, 3)).astype(np.float32)
    mask = np.zeros((b, S, S, 1), np.float32)
    mask[:, 6:21, 5:22] = 1.0  # edges inside latent cells of 4 pixels
    prompt = rng.normal(size=(b, CTX, 32)).astype(np.float32)
    negative = rng.normal(size=(b, CTX, 32)).astype(np.float32)
    control = rng.uniform(size=(b, S, S, 3)).astype(np.float32)
    return dict(image=image, mask=mask, prompt=prompt, negative=negative, control=control)


def noise(shape) -> np.ndarray:
    return np.asarray(jax.random.normal(KEY, shape, jnp.float32))


def close(got, want):
    got = got.numpy() if torch.is_tensor(got) else got
    assert got.shape == np.shape(want)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["inpaint", "inpaint_controlnet"])
def test_inpaint_matches_jax(kind):
    jax_pipe, params, port = pipelines(kind, seed=31)
    x = inputs(1, seed=1)
    control = x["control"] if kind == "inpaint_controlnet" else None
    want = jax_pipe(params, x["prompt"], x["image"], x["mask"], x["negative"], rng=KEY,
                    control=control)
    got = port(x["prompt"], x["image"], x["mask"], x["negative"], control=control,
               initial_noise=noise((1, LAT, LAT, 4)))
    close(got, want)
    # the mask reaches the latent grid at half-pixel centres: rows 6..20 -> cells 1..4
    cells = tpipe.resize_nearest(torch.from_numpy(x["mask"]), LAT, LAT)[0, :, :, 0]
    want_cells = jax.image.resize(x["mask"], (1, LAT, LAT, 1), "nearest")
    np.testing.assert_array_equal(cells.numpy(), np.asarray(want_cells)[0, :, :, 0])
    assert cells[1].sum() > 0 and cells[0].sum() == 0


@pytest.mark.parametrize("kind,pairs", [("joint_x", 1), ("joint_y", 2)],
                         ids=["cond_x_one_pair", "cond_y_spatial_mask_two_pairs"])
def test_joint_control_matches_jax(kind, pairs):
    jax_pipe, params, port = pipelines(kind, seed=32)
    x = inputs(pairs, seed=2)
    spatial = x["mask"] if kind == "joint_y" else None
    want = jax_pipe(params, x["prompt"], x["image"], x["negative"], rng=KEY,
                    spatial_mask=spatial)
    initial = jax.random.normal(jax.random.split(KEY)[0], (2 * pairs, LAT, LAT, 4))
    got = port(x["prompt"], x["image"], x["negative"], spatial_mask=spatial,
               initial_noise=np.asarray(initial))
    close(got, want)
    assert got.shape[0] == 2 * pairs


def test_condition_pipeline_matches_jax():
    jax_pipe, params, port = pipelines("condition", seed=33)
    x = inputs(1, seed=3)
    want = jax_pipe(params, x["prompt"], cond_image=x["control"],
                    negative_prompt_embeds=x["negative"], rng=KEY)
    got = port(x["prompt"], cond_image=x["control"], negative_prompt_embeds=x["negative"],
               initial_noise=noise((1, LAT, LAT, 4)))
    close(got, want)


def test_optimize_latents_matches_jax():
    """Three SGD steps against a guidance loss with the L2 anchor, from inside a
    ``no_grad`` block (the pipelines' mode): autograd is on inside the method."""
    jax_pipe, _, port = pipelines("inpaint", seed=34)
    z = np.random.default_rng(4).normal(size=(1, LAT, LAT, 4)).astype(np.float32)
    target = np.linspace(-1, 1, z.size, dtype=np.float32).reshape(z.shape)
    want = jax_pipe.optimize_latents(jnp.asarray(z),
                                     lambda v: jnp.mean((v - jnp.asarray(target)) ** 4),
                                     guidance_lr=0.3, num_optimizer_steps=3, reg_weight=0.5)
    with torch.no_grad():
        got = port.optimize_latents(torch.from_numpy(z),
                                    lambda v: torch.mean((v - torch.from_numpy(target)) ** 4),
                                    guidance_lr=0.3, num_optimizer_steps=3, reg_weight=0.5)
    close(got, want)
    assert not got.requires_grad


def test_joint_control_rows_pair_across_pairs():
    """At two pairs the joint-control rows ``[x0, y0, x1, y1]`` (x CFG-doubled) meet the
    UNet's mask ``(0, 1, 0, 1)`` block-wise: the streams are row blocks ``[x0, y0]``,
    ``[x1, y1]``, ..., so x0's joint partner is x1, not y0, in both packages. Moving row 2
    (x1) moves row 0's output; moving row 1 (y0) leaves it bit-equal. At one pair the blocks
    are single rows and x0 pairs with y0."""
    _, _, port = pipelines("joint_x", seed=35)
    unet = port.unet
    for p in unet.parameters():  # the joint branch's zero-init post projection included
        if not p.any():
            torch.nn.init.normal_(p, 0.0, 0.2, generator=torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    rows = torch.from_numpy(rng.normal(size=(8, LAT, LAT, 4)).astype(np.float32))
    ctx = torch.from_numpy(rng.normal(size=(8, CTX, 32)).astype(np.float32))
    t = torch.full((8,), 500.0)
    with torch.no_grad():
        base = unet(rows, t, ctx)
        for moved, changes in ((2, True), (1, False)):
            other = rows.clone()
            other[moved] += 1.0
            out = unet(other, t, ctx)
            assert torch.equal(out[0], base[0]) != changes, moved


def _cli_args(tmp_path, mode, *extra):
    from PIL import Image

    image = tmp_path / "in.png"
    Image.fromarray((np.random.default_rng(8).uniform(size=(40, 48, 3)) * 255)
                    .astype(np.uint8)).save(image)
    return ["--mode", mode, "--image", str(image), "--output", str(tmp_path / f"{mode}.png"),
            "--height", str(S), "--width", str(S), "--num-inference-steps", str(STEPS),
            "--tiny", "--device", "cpu", *extra]


@pytest.mark.parametrize("mode", ["inpaint", "joint_control"])
def test_cli_runs_on_the_cpu_at_tiny_widths(tmp_path, mode, capsys):
    from PIL import Image

    cli.main(_cli_args(tmp_path, mode))
    out = np.asarray(Image.open(tmp_path / f"{mode}.png"))
    assert out.shape == (S, S, 3)
    assert "s/image" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--weights", "w"], ["--prompt", "a cat"],
                                  ["--tokenizer", "tok"]], ids=["weights", "prompt", "tokenizer"])
def test_cli_refuses_what_needs_files(tmp_path, flag, capsys):
    with pytest.raises(SystemExit):
        cli.main(_cli_args(tmp_path, "inpaint", *flag))
    assert "ROADMAP.md Queue 1, item 13" in capsys.readouterr().err


def test_cli_scales_the_image_twice_as_the_jax_cli(tmp_path):
    """The JAX CLI hands the pipelines ``image * 2 - 1`` (``lkgd_tpu/cli/
    run_inference_sd2d.py:192, 194``), which scale it again: the VAE sees [-3, 1]. The port
    mirrors it: the CLI's latents are the pipeline's on the image scaled once more."""
    args = cli.make_parser().parse_args(_cli_args(tmp_path, "joint_control"))
    pipe = cli.build(args)
    image, _ = cli.load_inputs(args)
    emb = cli.prompt_embeds(args, 32)
    seen = []
    encode = pipe.vae.encode_mode
    pipe.vae.encode_mode = lambda x: seen.append((x.min().item(), x.max().item())) or encode(x)
    latents = cli.denoise(pipe, args, emb, image)
    assert seen[0][0] < -1.0 - 1e-3 and seen[0][0] >= -3.0
    gen = torch.Generator().manual_seed(args.seed)
    direct = pipe.denoise(emb, image[None] * 2.0 - 1.0, generator=gen)
    assert torch.equal(latents, direct)
    assert dataclasses.asdict(pipe.config)["num_inference_steps"] == STEPS
    assert pipe.unet.config.joint is None  # the CLI's joint_control has no joint attention
