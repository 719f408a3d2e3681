"""The port's Euler-Karras scheduler against ``lkgd_tpu.schedulers.euler_discrete``: the
schedule arrays, ``scale_model_input`` and ``step`` (atol 1e-6: both hold fp32 values
computed from the same float64 host schedule)."""

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
