"""The port's last tools against ``lkgd_tpu`` on the CPU: DDIM inversion and its helpers, the
w8a8 int8 products, ``verify_parity`` records checked across the two packages, the web and
Gradio demos and ``collect_env``.

Tolerances: rtol 1e-4 / atol 2e-4 at fp32 unless stated; the int8 codes and scales exactly,
the int8 products within 1e-5 relative."""

import base64
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_torch.cli import gradio_demo, verify_parity, web_demo  # noqa: E402
from lkgd_torch.ops import quantization as tq  # noqa: E402
from lkgd_torch.utils import inversion as tinv  # noqa: E402

from tests.test_torch_porting import (TINY_CLIP, TINY_UNET, TINY_VAE, jit,  # noqa: E402
                                      tiny_torch_pipeline)

TOL = dict(rtol=1e-4, atol=2e-4)


def _rng(seed):
    return np.random.default_rng(seed)


# ------------------------------------------------------------------ inversion
def test_ddim_inversion_matches_jax():
    """The reversed schedule with a linear eps model that reads both the latents and the
    timestep, on CogVideoX's DDIM schedule and on SD's."""
    from lkgd_tpu.pipelines.sd2d import sd_ddim_config
    from lkgd_tpu.schedulers.cogvideox_ddim import CogVideoXDDIMScheduler as JaxDDIM
    from lkgd_tpu.utils.inversion import ddim_inversion

    from lkgd_torch.pipelines.sd2d import sd_ddim_config as t_sd_ddim_config
    from lkgd_torch.schedulers.cogvideox_ddim import CogVideoXDDIMScheduler

    x0 = _rng(0).normal(size=(2, 3, 4, 4, 4)).astype(np.float32)
    w = _rng(1).normal(size=(4,)).astype(np.float32) * 0.2
    c = _rng(2).normal(size=x0.shape).astype(np.float32)
    for jcfg, tcfg in ((None, None), (sd_ddim_config(), t_sd_ddim_config())):
        js = JaxDDIM(jcfg) if jcfg else JaxDDIM()
        ts = CogVideoXDDIMScheduler(tcfg) if tcfg else CogVideoXDDIMScheduler()
        jsched, tsched = js.set_timesteps(10), ts.set_timesteps(10)
        want = ddim_inversion(lambda lat, t: lat * w + 1e-3 * t * c, js, jsched,
                              jnp.asarray(x0))
        cw, cc = torch.from_numpy(w), torch.from_numpy(c)
        got = tinv.ddim_inversion(lambda lat, t: lat * cw + 1e-3 * t * cc, ts, tsched,
                                  torch.from_numpy(x0))
        assert got.dtype == torch.float32
        assert np.abs(np.asarray(want) - x0).max() > 0.1  # the latents really moved
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_inversion_helpers_match_jax():
    from lkgd_tpu.utils import inversion as jinv

    frames = _rng(3).uniform(-1, 1, size=(2, 3, 8, 8, 3)).astype(np.float32)
    proj = _rng(4).normal(size=(3, 4)).astype(np.float32)
    want = jinv.tensor_to_vae_latent(lambda x: x[:, ::2, ::2] @ proj, jnp.asarray(frames))
    got = tinv.tensor_to_vae_latent(lambda x: x[:, ::2, ::2] @ torch.from_numpy(proj),
                                    torch.from_numpy(frames))
    assert got.shape == (2, 3, 4, 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tinv.get_add_time_ids(6, 127, 0.02, 3).numpy(),
                                  np.asarray(jinv.get_add_time_ids(6, 127, 0.02, 3)))
    for path in ("ckpt/flip_temporal", "ckpt/noflip_notemporal_nospatial", "a/b", "x_flip",
                 "temporal_nospatial"):
        assert (tinv.parse_checkpoint_behavior_flags(path)
                == jinv.parse_checkpoint_behavior_flags(path)), path


# ------------------------------------------------------------------ quantization
def test_int8_codes_and_scales_equal_jax():
    """Round half to even on both sides: the codes and scales are JAX's bit for bit, half-way
    values included (x / scale = k + 0.5 exactly). JAX's functions run op by op here, the
    formula as written: under ``jit`` XLA turns ``max / 127.0`` into a product with the
    rounded reciprocal, one ulp off on some scales."""
    from lkgd_tpu.ops import quantization as jq

    x = _rng(5).normal(size=(64, 96)).astype(np.float32) * 3.0
    x[0, :5] = [127.0, 0.5, 1.5, 2.5, -2.5]  # scale 1: the half-way cases
    x[1] = 0.0  # an all-zero row: the 1e-8 floor
    w = _rng(6).normal(size=(96, 40)).astype(np.float32)
    for (gq, gs), (wq, ws) in ((tq.quantize_rows(torch.from_numpy(x)),
                                jq.quantize_rows(jnp.asarray(x))),
                               (tq.quantize_cols(torch.from_numpy(w)),
                                jq.quantize_cols(jnp.asarray(w)))):
        assert gq.dtype == torch.int8
        np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    assert tq.quantize_rows(torch.from_numpy(x))[0][0, :5].tolist() == [127, 0, 2, 2, -2]
    assert [tq.min_quant_rows(c, f) for c, f in ((320, 1280), (8, 8), (4, 4))] == \
        [jq.min_quant_rows(c, f) for c, f in ((320, 1280), (8, 8), (4, 4))]


@pytest.mark.parametrize("case", ["matmul", "matmul_bf16", "conv_same", "conv_stride2",
                                  "conv_valid"])
def test_int8_products_match_jax(case):
    from lkgd_tpu.ops import quantization as jq

    r = _rng(7)
    if case.startswith("matmul"):
        x = r.normal(size=(2, 37, 72)).astype(np.float32)
        w = r.normal(size=(72, 24)).astype(np.float32)
        dt, jdt = ((torch.bfloat16, jnp.bfloat16) if case == "matmul_bf16"
                   else (torch.float32, jnp.float32))
        want = np.asarray(jit(jq.int8_matmul)(jnp.asarray(x, jdt), jnp.asarray(w, jdt)),
                          np.float32)
        got = tq.int8_matmul(torch.from_numpy(x).to(dt), torch.from_numpy(w).to(dt))
        assert got.dtype == dt and got.shape == (2, 37, 24)
        rtol = 1e-5 if dt == torch.float32 else 8e-3  # one bf16 rounding of the output
    else:
        x = r.normal(size=(2, 9, 11, 16)).astype(np.float32)
        w = r.normal(size=(3, 3, 16, 8)).astype(np.float32)
        strides, padding = {"conv_same": ((1, 1), "SAME"), "conv_stride2": ((2, 2), "SAME"),
                            "conv_valid": ((1, 1), "VALID")}[case]
        want = np.asarray(jit(lambda a, b: jq.int8_conv2d(a, b, strides, padding))(
            jnp.asarray(x), jnp.asarray(w)))
        got = tq.int8_conv2d(torch.from_numpy(x), torch.from_numpy(w), strides, padding)
        rtol = 1e-5
    assert got.shape == want.shape
    got = got.float().numpy()
    assert np.abs(got - want).max() <= rtol * np.abs(want).max(), np.abs(got - want).max()


def test_int_matmul_is_exact_beyond_fp32():
    """K = 9 x 1280 with every code at 127: sums of 1.9e8 > 2^24, exact in int32."""
    a = torch.full((3, 9 * 1280), 127, dtype=torch.int8)
    b = torch.full((9 * 1280, 2), -127, dtype=torch.int8)
    b[0, 1] = 1
    got = tq.int_matmul(a, b)
    assert got.dtype == torch.int32
    assert got[:, 0].tolist() == [-127 * 127 * 9 * 1280] * 3
    assert got[0, 1].item() == -127 * 127 * (9 * 1280 - 1) + 127


# ------------------------------------------------------------------ verify_parity
def _svd_checkpoint(tmp_path: Path, seed=0) -> str:
    from safetensors.numpy import save_file

    from lkgd_tpu.cli import verify_parity as jvp
    from lkgd_tpu.models.unet_svd import UNetSpatioTemporalCondition
    from lkgd_tpu.utils import porting

    unet = UNetSpatioTemporalCondition(jvp._config_from_dict(jvp.TINY))
    shapes = jax.eval_shape(lambda: unet.init(jax.random.PRNGKey(seed), jnp.ones((1, 2, 8, 8, 8)),
                                              jnp.zeros((1,)), jnp.ones((1, 1, 64)),
                                              jnp.ones((1, 3))))
    rng = _rng(seed)
    params = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.05).astype(np.float32),
                          shapes)
    path = str(tmp_path / "diffusion_pytorch_model.safetensors")
    save_file(porting.export_state_dict(params, key_map=porting.svd_export_key_map), path)
    return path


def _cog_checkpoint(tmp_path: Path) -> str:
    from safetensors.numpy import save_file

    from lkgd_tpu.models.cogvideox import CogVideoXConfig, CogVideoXTransformer3D
    from lkgd_tpu.utils import porting

    cfg = CogVideoXConfig.tiny()
    model = CogVideoXTransformer3D(cfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 2, 8, 8, cfg.in_channels)),
        jnp.ones((1, cfg.max_text_seq_length, cfg.text_embed_dim)), jnp.zeros((1,)),
        domain_features=jnp.ones((1, 1, 48)), flow_features=jnp.ones((1, 1, 48))))
    rng = _rng(5)
    params = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.05).astype(np.float32),
                          shapes)
    path = str(tmp_path / "transformer.safetensors")
    save_file(porting.export_state_dict(params, key_map=porting.cogvideox_export_key_map), path)
    return path


SIZES = {"svd": ["--batch", "1", "--frames", "2", "--height", "32", "--width", "32"],
         "cogvideox": ["--model", "cogvideox", "--batch", "1", "--frames", "2", "--height",
                       "64", "--width", "64"]}


@pytest.mark.parametrize("model", ["svd", "cogvideox"])
@pytest.mark.parametrize("recorder", ["jax", "port"])
def test_verify_parity_records_check_across_packages(model, recorder, tmp_path):
    """A record of one package checks in the other on the same safetensors file (JAX's
    exporter names), and in its own package; a perturbed output layer fails the port's
    check."""
    from lkgd_tpu.cli import verify_parity as jvp

    ckpt = (_svd_checkpoint if model == "svd" else _cog_checkpoint)(tmp_path)
    rec, report = str(tmp_path / "rec.npz"), str(tmp_path / "report.json")
    argv = ["record", "--out", rec, "--config", "tiny", "--checkpoint", ckpt, *SIZES[model]]
    if recorder == "jax":
        assert jvp.main(argv) == 0
    else:
        assert verify_parity.main(argv + ["--device", "cpu"]) == 0
    with np.load(rec) as f:
        assert abs(f["output"]).max() > 1e-3
        keys = set(f.files)
    assert keys == ({"sample", "timestep", "encoder_hidden_states", "output", "config"}
                    | ({"added_time_ids"} if model == "svd" else set()))
    check = ["check", "--record", rec, "--checkpoint", ckpt, "--report", report]
    checker = verify_parity.main if recorder == "jax" else jvp.main
    assert checker(check + (["--device", "cpu"] if recorder == "jax" else [])) == 0
    rep = json.load(open(report))
    assert rep["pass"] and rep["max_abs_err"] < 1e-4, rep
    if recorder == "port":
        return
    from lkgd_torch.utils.porting import load_safetensors, save_safetensors

    sd = load_safetensors(ckpt)
    name = "conv_out.weight" if model == "svd" else "proj_out.weight"
    sd[name] = sd[name] + 0.05
    bad = str(tmp_path / "bad.safetensors")
    save_safetensors(sd, bad)
    assert verify_parity.main(["check", "--record", rec, "--checkpoint", bad, "--report",
                               report, "--device", "cpu"]) == 1
    assert not json.load(open(report))["pass"]


def test_verify_parity_pipeline_roundtrip(tmp_path):
    """``svd_pipeline``: a whole-loop record on a diffusers checkpoint root (unet, vae and
    image_encoder written from the port's seeded modules) checks on that root, and fails
    on a root whose VAE output layer is perturbed."""
    from lkgd_torch.models.layers import init_params
    from lkgd_torch.utils.porting import save_safetensors

    pipe = tiny_torch_pipeline()
    init_params(pipe.unet, torch.Generator().manual_seed(3))
    init_params(pipe.vae, torch.Generator().manual_seed(4))
    init_params(pipe.image_encoder, torch.Generator().manual_seed(5))
    roots = {"good": tmp_path / "good", "bad": tmp_path / "bad"}
    for kind, root in roots.items():
        for name, module, file in (("unet", pipe.unet, "diffusion_pytorch_model.safetensors"),
                                   ("vae", pipe.vae, "diffusion_pytorch_model.safetensors"),
                                   ("image_encoder", pipe.image_encoder, "model.safetensors")):
            sd = {k: v.numpy() for k, v in module.state_dict().items()}
            if kind == "bad" and name == "vae":
                sd["encoder.conv_out.weight"] = sd["encoder.conv_out.weight"] + 0.05
            (root / name).mkdir(parents=True)
            save_safetensors(sd, str(root / name / file))
    rec, report = str(tmp_path / "pipe.npz"), str(tmp_path / "report.json")
    assert verify_parity.main(["record", "--model", "svd_pipeline", "--out", rec,
                               "--checkpoint", str(roots["good"]), "--batch", "1", "--frames",
                               "2", "--height", "32", "--width", "32", "--steps", "2",
                               "--device", "cpu"]) == 0
    with np.load(rec) as f:
        assert set(f.files) == {"image", "noise_aug", "initial_noise", "latents", "pipe_config"}
        assert f["latents"].shape == (1, 2, 16, 16, 4)
    for kind, rc in (("good", 0), ("bad", 1)):
        assert verify_parity.main(["check", "--record", rec, "--checkpoint", str(roots[kind]),
                                   "--report", report, "--device", "cpu"]) == rc
        rep = json.load(open(report))
        assert rep["mode"] == "pipeline" and rep["pass"] == (rc == 0), rep


# ------------------------------------------------------------------ web and Gradio demos
def _png_b64(h=8, w=8, seed=0):
    from PIL import Image

    img = Image.fromarray(_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture
def server():
    calls = {}

    def generate(start, end, seed, motion_bucket_id, fps):
        if seed == 13:
            raise ValueError("no such clip")
        calls.update(start=start, end=end, seed=seed, motion=motion_bucket_id, fps=fps)
        return _rng(seed).integers(0, 255, (4, 16, 16, 3), dtype=np.uint8)

    httpd = web_demo.make_server(generate, "trans", 0, host="127.0.0.1")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", calls
    httpd.shutdown()
    httpd.server_close()


def _post(url, body):
    return urllib.request.urlopen(urllib.request.Request(url, data=json.dumps(body).encode()))


def test_web_demo_page_generate_404_and_500(server, tmp_path):
    url, calls = server
    html = urllib.request.urlopen(url + "/").read().decode()
    assert "trans pipeline" in html and "/generate" in html
    reply = _post(url + "/generate", {"start": _png_b64(), "end": _png_b64(seed=1), "seed": 7,
                                      "motion_bucket_id": 42, "fps": 9})
    assert reply.status == 200 and reply.headers["Content-Type"] == "video/mp4"
    data = reply.read()
    assert data[4:8] == b"ftyp"  # the mp4 container's magic
    assert calls["seed"] == 7 and calls["motion"] == 42 and calls["fps"] == 9
    assert calls["start"].shape == (8, 8, 3) and calls["start"].dtype == np.float32
    assert calls["end"] is not None and 0.0 <= calls["start"].max() <= 1.0
    (tmp_path / "out.mp4").write_bytes(data)
    from lkgd_torch.data.video_io import read_video_frames

    frames, _ = read_video_frames(str(tmp_path / "out.mp4"))
    want = _rng(7).integers(0, 255, (4, 16, 16, 3), dtype=np.uint8) / 255.0
    assert frames.shape == (4, 16, 16, 3)
    assert abs(frames.mean() - want.mean()) < 0.05  # the levels themselves, not saturated
    for path, code in (("/nothing", 404), ("/generate", 500)):
        with pytest.raises(urllib.error.HTTPError) as err:
            if path == "/nothing":
                urllib.request.urlopen(url + path)
            else:
                _post(url + path, {"start": _png_b64(), "seed": 13})
        assert err.value.code == code
    assert err.value.read() == b"ValueError: no such clip"


def test_web_demo_generate_fn_is_the_pipeline(tmp_path):
    """``build_generate_fn`` at tiny widths: the pipeline's frames as uint8 for the start
    frame resized to its size and the request's seed."""
    from lkgd_torch.data.video_io import process_frames

    pipe = tiny_torch_pipeline()
    pipe.init_params(torch.Generator().manual_seed(0))
    start = _rng(8).uniform(size=(60, 80, 3)).astype(np.float32)
    got = web_demo.build_generate_fn(pipe, "base")(start, None, 5, 127, 7)
    image = process_frames(start[None], pipe.config.height, pipe.config.width)
    want = pipe(image, generator=torch.Generator().manual_seed(5))[0]
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, (np.clip(want, 0, 1) * 255).astype(np.uint8))


def _tiny_widths():
    from lkgd_torch.cli import run_inference_svd
    from lkgd_torch.models import configs as tcfg

    return run_inference_svd.Widths(unet=TINY_UNET, vae=tcfg.TemporalVAEConfig(**TINY_VAE),
                                    clip=tcfg.CLIPVisionConfig(**TINY_CLIP))


def test_gradio_demo_falls_back_to_the_web_demo(monkeypatch, capsys):
    served = {}
    monkeypatch.setitem(sys.modules, "gradio", None)  # absent, on either machine
    monkeypatch.setattr(web_demo, "serve",
                        lambda fn, mode, port: served.update(fn=fn, mode=mode, port=port))
    gradio_demo.main(["--mode", "trans", "--height", "32", "--width", "32", "--num-frames",
                      "2", "--port", "7001", "--device", "cpu"], widths=_tiny_widths())
    assert "gradio is not installed" in capsys.readouterr().out
    assert served["mode"] == "trans" and served["port"] == 7001 and callable(served["fn"])


@pytest.mark.parametrize("cli", ["web_demo", "gradio_demo"])
def test_demos_refuse_weights(cli):
    main = {"web_demo": web_demo.main, "gradio_demo": gradio_demo.main}[cli]
    with pytest.raises(SystemExit):
        main(["--weights", "ckpts", "--device", "cpu"])


# ------------------------------------------------------------------ collect_env
def test_collect_env_no_device_loads_no_forbidden_module():
    code = ("import sys\n"
            "from lkgd_torch.cli import collect_env\n"
            "collect_env.main(['--no-device'])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'transformers', 'lkgd_tpu', 'triton', "
            "'gradio'))\n"
            "print('BAD', bad); sys.exit(1 if bad else 0)")
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "LKGD_PROBE": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=root, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    for key in ("torch", "numpy", "triton", "nvcc", "CUTLASS headers", "kernel build directory",
                "env:LKGD_*"):
        assert f"\n{key:28s}: " in "\n" + out, key
    assert "LKGD_PROBE" in out and "devices" not in out
