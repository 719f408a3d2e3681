"""The port's Euler-Karras scheduler against ``lkgd_tpu.schedulers.euler_discrete``: the
schedule arrays under every beta schedule, ``scale_model_input``, ``step`` (also with
``s_churn`` and given noise), ``add_noise`` at integer step indices,
``step_index_for_timestep`` and ``config_from_diffusers_json`` (atol 1e-6: both hold fp32
values computed from the same float64 host schedule)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.schedulers import euler_discrete as jsched  # noqa: E402

from lkgd_torch.schedulers import euler_discrete as tsched  # noqa: E402

CONFIGS = {
    "svd": dict(num_train_timesteps=1000, beta_start=0.00085, beta_end=0.012,
                beta_schedule="scaled_linear", prediction_type="v_prediction",
                interpolation_type="linear", use_karras_sigmas=True, sigma_min=0.002,
                sigma_max=700.0, timestep_spacing="leading", timestep_type="continuous",
                steps_offset=1),
    "epsilon_linspace": dict(),
    "trailing_zero_snr": dict(timestep_spacing="trailing", rescale_betas_zero_snr=True,
                              beta_schedule="squaredcos_cap_v2"),
}


def _pair(name, steps):
    jax_s = jsched.EulerDiscreteScheduler(jsched.EulerDiscreteConfig(**CONFIGS[name]))
    torch_s = tsched.EulerDiscreteScheduler(tsched.EulerDiscreteConfig(**CONFIGS[name]))
    return jax_s, jax_s.set_timesteps(steps), torch_s, torch_s.set_timesteps(steps)


def test_svd_config_matches():
    assert tsched.EulerDiscreteConfig.svd() == tsched.EulerDiscreteConfig(**CONFIGS["svd"])
    assert (dataclasses.asdict(tsched.EulerDiscreteConfig.svd())
            == dataclasses.asdict(jsched.EulerDiscreteConfig.svd()))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("steps", [3, 25])
def test_schedule_arrays(name, steps):
    _, js, _, ts = _pair(name, steps)
    np.testing.assert_allclose(ts.sigmas.numpy(), np.asarray(js.sigmas), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.timesteps.numpy(), np.asarray(js.timesteps), rtol=0,
                               atol=1e-6)
    assert ts.init_noise_sigma == float(js.init_noise_sigma)
    assert ts.num_steps == js.num_steps == steps


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_scale_model_input_and_step(name):
    jax_s, js, torch_s, ts = _pair(name, 25)
    rng = np.random.default_rng(0)
    sample = rng.standard_normal((2, 3, 4, 5, 4)).astype(np.float32) * 5
    out = rng.standard_normal(sample.shape).astype(np.float32)
    for i in (0, 7, 24):
        want = np.asarray(jax_s.scale_model_input(js, jnp.asarray(sample), i))
        got = torch_s.scale_model_input(ts, torch.from_numpy(sample), i).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        want_prev, want_x0 = jax_s.step(js, jnp.asarray(out), i, jnp.asarray(sample))
        got_prev, got_x0 = torch_s.step(ts, torch.from_numpy(out), i, torch.from_numpy(sample))
        np.testing.assert_allclose(got_prev.numpy(), np.asarray(want_prev), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_x0.numpy(), np.asarray(want_x0), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("beta_schedule", ["linear", "scaled_linear", "squaredcos_cap_v2"])
@pytest.mark.parametrize("karras", [False, True], ids=["plain", "karras"])
def test_every_beta_schedule(beta_schedule, karras):
    kw = dict(beta_schedule=beta_schedule, use_karras_sigmas=karras)
    js = jsched.EulerDiscreteScheduler(jsched.EulerDiscreteConfig(**kw)).set_timesteps(10)
    ts = tsched.EulerDiscreteScheduler(tsched.EulerDiscreteConfig(**kw)).set_timesteps(10)
    np.testing.assert_allclose(ts.sigmas.numpy(), np.asarray(js.sigmas), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.timesteps.numpy(), np.asarray(js.timesteps), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(NotImplementedError):
        tsched.EulerDiscreteScheduler(tsched.EulerDiscreteConfig(beta_schedule="sigmoid"))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_with_churn_and_given_noise(name):
    jax_s, js, torch_s, ts = _pair(name, 25)
    rng = np.random.default_rng(1)
    sample, out, noise = (rng.standard_normal((2, 3, 4, 5, 4)).astype(np.float32)
                          for _ in range(3))
    for i, churn in ((0, 0.5), (12, 40.0)):  # gamma below and at its cap sqrt(2) - 1
        want = jax_s.step(js, jnp.asarray(out), i, jnp.asarray(sample), s_churn=churn,
                          s_noise=1.003, noise=jnp.asarray(noise))
        got = torch_s.step(ts, torch.from_numpy(out), i, torch.from_numpy(sample),
                           s_churn=churn, s_noise=1.003, noise=torch.from_numpy(noise))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
        plain = torch_s.step(ts, torch.from_numpy(out), i, torch.from_numpy(sample))[0]
        assert not torch.allclose(got[0], plain)
    with pytest.raises(ValueError, match="explicit `noise`"):
        torch_s.step(ts, torch.from_numpy(out), 0, torch.from_numpy(sample), s_churn=1.0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_add_noise_at_step_indices(name):
    jax_s, js, torch_s, ts = _pair(name, 25)
    rng = np.random.default_rng(2)
    x, noise = (rng.standard_normal((3, 2, 4, 4, 4)).astype(np.float32) for _ in range(2))
    idx = np.array([0, 10, 24])
    want = jax_s.add_noise(js, jnp.asarray(x), jnp.asarray(noise), jnp.asarray(idx))
    got = torch_s.add_noise(ts, torch.from_numpy(x), torch.from_numpy(noise), idx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    one = torch_s.add_noise(ts, torch.from_numpy(x[:1]), torch.from_numpy(noise[:1]), [10])
    np.testing.assert_allclose(one.numpy(), x[:1] + noise[:1] * ts.sigmas[10].item(),
                               rtol=1e-6, atol=1e-6)


def test_step_index_for_timestep_takes_the_second_match():
    jax_s, js, torch_s, ts = _pair("svd", 25)
    for i in (0, 9, 24):
        t = float(ts.timesteps[i])
        assert torch_s.step_index_for_timestep(ts, t) == jax_s.step_index_for_timestep(js, t) == i
    dup = np.array([999.0, 500.0, 500.0, 1.0], np.float32)
    jdup = js._replace(timesteps=jnp.asarray(dup))
    tdup = ts._replace(timesteps=torch.from_numpy(dup))
    assert torch_s.step_index_for_timestep(tdup, 500.0) == \
        jax_s.step_index_for_timestep(jdup, 500.0) == 2
    with pytest.raises(ValueError, match="not in schedule"):
        torch_s.step_index_for_timestep(ts, 12345.0)


def test_config_from_diffusers_json(tmp_path):
    import json

    path = tmp_path / "scheduler_config.json"
    path.write_text(json.dumps({
        "_class_name": "EulerDiscreteScheduler", "_diffusers_version": "0.24.0",
        "beta_end": 0.012, "beta_schedule": "scaled_linear", "beta_start": 0.00085,
        "interpolation_type": "linear", "num_train_timesteps": 1000,
        "prediction_type": "v_prediction", "rescale_betas_zero_snr": False, "sigma_max": 700.0,
        "sigma_min": 0.002, "steps_offset": 1, "timestep_spacing": "leading",
        "timestep_type": "continuous", "trained_betas": None, "use_karras_sigmas": True}))
    got = tsched.config_from_diffusers_json(str(path))
    want = jsched.config_from_diffusers_json(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got == tsched.EulerDiscreteConfig.svd()
