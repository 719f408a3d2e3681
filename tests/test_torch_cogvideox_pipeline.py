"""The port's CogVideoX schedulers, pipelines and CLI against ``lkgd_tpu`` at fp32 on the
CPU: the DDIM scheduler (schedule, v-prediction step, ``add_noise``, ``get_velocity``) and
the SDE-DPM-Solver++(2M) step in its first-order, second-order, no-history and final
branches, with and without noise; the tiny I2V pipeline with DPM and with DDIM, T2V, V2V
and the 1.5 form (temporal patching, padded latent frames), every parameter random,
knowledge features given, and JAX's own draws injected (``initial_noise``, ``step_noise``,
V2V's ``noise``: torch and JAX generators never agree); and the CLI at tiny widths on the
CPU, writing a video in each generate type and VAE mode, with the refused flags.

Tolerances: rtol 1e-4 / atol 2e-4 (fp32), the scheduler steps 1e-5."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models.cogvideox import CogVideoXConfig as JaxConfig  # noqa: E402
from lkgd_tpu.pipelines import cogvideox_i2v as jpipe  # noqa: E402
from lkgd_tpu.schedulers.cogvideox_ddim import CogVideoXDDIMScheduler as JaxDDIM  # noqa: E402
from lkgd_tpu.schedulers.cogvideox_dpm import CogVideoXDPMScheduler as JaxDPM  # noqa: E402

from lkgd_torch.cli import run_inference_cogvideox as cli  # noqa: E402
from lkgd_torch.models.configs import CogVideoXConfig  # noqa: E402
from lkgd_torch.pipelines import cogvideox_i2v as tpipe  # noqa: E402
from lkgd_torch.schedulers.cogvideox_ddim import CogVideoXDDIMScheduler  # noqa: E402
from lkgd_torch.schedulers.cogvideox_dpm import CogVideoXDPMScheduler  # noqa: E402
from lkgd_torch.utils.porting import cogvideox_key_map  # noqa: E402

from tests.test_torch_porting import port_state_dict, randomize  # noqa: E402

TOL = dict(rtol=1e-4, atol=2e-4)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
PIPE = dict(height=32, width=32, num_frames=9, num_inference_steps=3,
            vae_scale_factor_spatial=4)  # 3 latent frames of 8 x 8


def _rng(seed):
    return np.random.default_rng(seed)


def test_ddim_schedule_step_and_noise_match_jax():
    j, t = JaxDDIM(), CogVideoXDDIMScheduler()
    np.testing.assert_allclose(t.alphas_cumprod, j.alphas_cumprod, rtol=0, atol=0)
    for n in (3, 50):
        js, ts = j.set_timesteps(n), t.set_timesteps(n)
        np.testing.assert_array_equal(ts.timesteps, np.asarray(js.timesteps))
        np.testing.assert_array_equal(ts.alphas_cumprod_prev, np.asarray(js.alphas_cumprod_prev))
    sched = (j.set_timesteps(50), t.set_timesteps(50))
    x, v = (_rng(s).normal(size=(2, 3, 4, 4, 4)).astype(np.float32) for s in (0, 1))
    for i in (0, 17, 49):
        want = j.step(sched[0], jnp.asarray(v), i, jnp.asarray(x))
        got = t.step(sched[1], torch.from_numpy(v), i, torch.from_numpy(x))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **STEP_TOL)
    steps = np.array([999, 3])
    for name in ("add_noise", "get_velocity"):
        want = getattr(j, name)(jnp.asarray(x), jnp.asarray(v), jnp.asarray(steps))
        got = getattr(t, name)(torch.from_numpy(x), torch.from_numpy(v), torch.from_numpy(steps))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)


@pytest.mark.parametrize("case", ["first_order", "second_order", "no_history", "final",
                                  "mean_update"])
def test_dpm_step_matches_jax(case):
    j, t = JaxDPM(), CogVideoXDPMScheduler()
    js, ts = j.set_timesteps(50), t.set_timesteps(50)
    np.testing.assert_array_equal(ts.second_order_ok, np.asarray(js.second_order_ok))
    x, v, old, z = (_rng(s).normal(size=(2, 3, 4, 4, 4)).astype(np.float32) for s in range(4))
    i = {"first_order": 0, "second_order": 21, "no_history": 21, "final": 49,
         "mean_update": 21}[case]
    history = case != "no_history"
    noise = None if case == "mean_update" else z
    want = j.step(js, jnp.asarray(v), jnp.asarray(old), i, jnp.asarray(x),
                  None if noise is None else jnp.asarray(noise), have_history=history)
    got = t.step(ts, torch.from_numpy(v), torch.from_numpy(old), i, torch.from_numpy(x),
                 None if noise is None else torch.from_numpy(noise), have_history=history)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STEP_TOL)
    if case == "final":  # h = inf: the step lands on x0
        np.testing.assert_allclose(got[0].numpy(), got[1].numpy(), rtol=0, atol=0)


def _jax_draws(pipe, rng, shape):
    """The JAX loop's draws: the initial latents from ``rng``, DPM's step i from
    ``fold_in(fold_in(rng, 0x0D9B), i)``."""
    sde = jax.random.fold_in(rng, 0x0D9B)
    steps = [np.asarray(jax.random.normal(jax.random.fold_in(sde, i), shape, jnp.float32))
             for i in range(pipe.schedule.num_steps)]
    return np.asarray(jax.random.normal(rng, shape, jnp.float32)), np.stack(steps)


CASES = {  # pipeline kind, scheduler, JAX config overrides
    "i2v_dpm": ("i2v", "dpm", {}),
    "i2v_ddim": ("i2v", "ddim", {}),
    "t2v_ddim": ("t2v", "ddim", {"in_channels": 4}),
    "v2v_dpm": ("v2v", "dpm", {"in_channels": 4}),
    "i2v_1.5_dpm": ("i2v", "dpm", {"patch_size_t": 2}),
}
CLASSES = {"i2v": "CogVideoXImageToVideoPipeline", "t2v": "CogVideoXTextToVideoPipeline",
           "v2v": "CogVideoXVideoToVideoPipeline"}


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_jax(case):
    kind, scheduler, overrides = CASES[case]
    cls = CLASSES[kind]
    jcfg = dataclasses.replace(JaxConfig.tiny(), **overrides)
    tcfg = dataclasses.replace(CogVideoXConfig.tiny(), **overrides)
    extra = {"strength": 0.67} if kind == "v2v" else {}
    jp = getattr(jpipe, cls)(config=jpipe.CogVideoXPipelineConfig(**PIPE, scheduler=scheduler),
                             transformer_config=jcfg, dtype=jnp.float32, **extra)
    tp = getattr(tpipe, cls)(config=tpipe.CogVideoXPipelineConfig(**PIPE, scheduler=scheduler),
                             transformer_config=tcfg, dtype=torch.float32, device="cpu", **extra)
    params = randomize(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)), seed=41, scale=0.1)
    tp.transformer.load_state_dict(port_state_dict(params["transformer"], cogvideox_key_map),
                                   strict=True)
    r = _rng(8)
    f32 = np.float32
    prompt = r.normal(size=(1, jcfg.max_text_seq_length, jcfg.text_embed_dim)).astype(f32)
    domain, flow = (r.normal(size=(1, 1, 1000)).astype(f32) for _ in range(2))
    rng = jax.random.PRNGKey(3)
    latent_shape = (1, jp.latent_frames, 8, 8, jcfg.out_channels)
    initial, steps = _jax_draws(jp, rng, latent_shape)
    kw = dict(domain_features=domain, flow_features=flow)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    if kind == "i2v":
        image = r.normal(size=(1, 8, 8, jcfg.out_channels)).astype(f32)
        want = jp(params, jnp.asarray(prompt), jnp.asarray(image), rng=rng, **jkw)
        got = tp(prompt, image, initial_noise=initial, step_noise=steps, **kw)
    elif kind == "t2v":
        want = jp(params, jnp.asarray(prompt), rng=rng, **jkw)
        got = tp(prompt, initial_noise=initial, step_noise=steps, **kw)
    else:
        video = r.normal(size=(1, 3, 8, 8, 4)).astype(f32)
        noise = np.asarray(jax.random.normal(rng, video.shape, jnp.float32))
        assert tp.start_index == jp.start_index == 1
        want = jp(params, jnp.asarray(prompt), jnp.asarray(video), rng=rng, **jkw)
        got = tp(prompt, video, noise=noise, step_noise=steps, **kw)
    assert got.shape == want.shape == latent_shape
    assert np.abs(np.asarray(want)).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pipelines_refuse_what_jax_refuses():
    cfg = tpipe.CogVideoXPipelineConfig(**PIPE)
    with pytest.raises(ValueError, match="in_channels"):
        tpipe.CogVideoXTextToVideoPipeline(config=cfg, transformer_config=CogVideoXConfig.tiny(),
                                           device="cpu")
    t2v = dataclasses.replace(CogVideoXConfig.tiny(), in_channels=4)
    with pytest.raises(ValueError, match="strength"):
        tpipe.CogVideoXVideoToVideoPipeline(config=cfg, transformer_config=t2v, strength=0.0,
                                            device="cpu")
    with pytest.raises(ValueError, match="scheduler"):
        tpipe.CogVideoXImageToVideoPipeline(
            config=dataclasses.replace(cfg, scheduler="euler"),
            transformer_config=CogVideoXConfig.tiny(), device="cpu")
    pipe = tpipe.CogVideoXImageToVideoPipeline(
        config=cfg, transformer_config=dataclasses.replace(CogVideoXConfig.tiny(),
                                                           patch_size_t=2), device="cpu")
    assert pipe.latent_frames == 4  # 3 latent frames padded to a multiple of 2


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    from lkgd_torch.data.video_io import write_video

    root = tmp_path_factory.mktemp("cogvideox")
    frames = _rng(9).uniform(size=(9, 40, 56, 3)).astype(np.float32)
    write_video(str(root / "frame.png"), frames[:1], fps=8)
    write_video(str(root / "clip.gif"), frames, fps=8)
    return root


TINY_ARGS = ["--device", "cpu", "--tiny", "--height", "32", "--width", "48", "--num-frames",
             "9", "--num-inference-steps", "2"]


@pytest.mark.parametrize("mode", [
    ("i2v", "frame.png", []), ("t2v", None, ["--scheduler", "ddim"]),
    ("v2v", "clip.gif", ["--vae-chunk-frames", "2"]),
    ("i2v", "frame.png", ["--vae-tiling", "--vae-tile-latent", "4", "6", "--vae-chunk-frames",
                          "1"])], ids=["i2v", "t2v", "v2v_chunked", "i2v_tiled_chunked"])
def test_cli_writes_a_video(media, tmp_path, mode):
    from lkgd_torch.data.video_io import load_input

    kind, image, extra = mode
    out = tmp_path / "out.gif"
    argv = TINY_ARGS + ["--generate-type", kind, "--output", str(out)] + extra
    if image:
        argv += ["--image", str(media / image)]
    cli.main(argv)
    video = load_input(str(out))
    assert video.shape == (9, 32, 48, 3)


def test_cli_prompt_embeds_and_lora(media, tmp_path):
    """``--prompt-embeds`` reaches the transformer, and ``--lora`` loads a rank-2 LoRA file
    into adapters on the projections it names."""
    from lkgd_torch.utils.porting import save_safetensors

    cfg = CogVideoXConfig.tiny()
    emb = _rng(3).normal(size=(cfg.max_text_seq_length, cfg.text_embed_dim)).astype(np.float32)
    np.save(tmp_path / "emb.npy", emb)
    inner = cfg.inner_dim
    lora = {}
    for i in range(cfg.num_layers):
        for proj in ("to_q", "to_v"):
            key = f"transformer.transformer_blocks.{i}.attn1.{proj}"
            lora[f"{key}.lora_A.weight"] = _rng(i).normal(size=(2, inner)).astype(np.float32)
            lora[f"{key}.lora_B.weight"] = _rng(i + 5).normal(size=(inner, 2)).astype(np.float32)
    save_safetensors(lora, str(tmp_path / "lora.safetensors"))
    args = cli.make_parser().parse_args(TINY_ARGS + ["--image", str(media / "frame.png"),
                                                     "--lora", str(tmp_path / "lora.safetensors"),
                                                     "--prompt-embeds", str(tmp_path / "emb.npy")])
    pipe, vae = cli.build(args)
    got = pipe.transformer.transformer_blocks[1].attn1.to_v.lora_lora_B.float()
    want = torch.from_numpy(lora["transformer.transformer_blocks.1.attn1.to_v.lora_B.weight"].T)
    torch.testing.assert_close(got, want.bfloat16().float(), rtol=0, atol=0)  # the CLI's bf16
    assert not hasattr(pipe.transformer.transformer_blocks[0].attn1.to_k, "lora_lora_A")
    prompt = cli.prompt_embeds(args, pipe.transformer.config)
    assert prompt.shape == (1,) + emb.shape
    latents = cli.generate(pipe, vae, args, prompt)
    assert torch.isfinite(latents).all()


@pytest.mark.parametrize("flag", [["--weights", "w"], ["--mesh", "slice=4"],
                                  ["--weight-sharding", "fsdp"], ["--sequence-parallel", "ring"]])
def test_cli_refuses_unported_flags(flag, capsys):
    """The flag that waits for files names its item, and the JAX mesh's ``slice`` axis,
    which has no counterpart, is refused; ``--sequence-parallel`` and ``--weight-sharding``,
    ported, are refused without the ``--mesh`` axis they act on."""
    with pytest.raises(SystemExit):
        cli.main(["--image", "x.png"] + flag)
    err = capsys.readouterr().err
    if flag[0] == "--sequence-parallel":
        assert "--sequence-parallel needs --mesh with a 'context' axis" in err
    elif flag[0] == "--weight-sharding":
        assert "--weight-sharding needs --mesh with a 'model' axis" in err
    elif flag[0] == "--mesh":
        assert "--mesh axes ['slice'] are not ported to lkgd_torch" in err
    else:
        assert "ROADMAP.md Queue 1, item 1" in err
