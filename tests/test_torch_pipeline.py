"""End-to-end parity of the port: the tiny ``generate`` of
``tests/test_pipeline_torch_oracle.py:99-121`` (same configs, same injected noise, the
same weights through the numpy porter) through the JAX pipeline and the PyTorch port, at
fp32. Latents and frames agree at rtol 1e-4, atol 2e-4 (the oracle test's tolerance:
fp32 rounding through a 3-step loop of the composed UNet)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests.test_torch_porting import (H, T, W, load_jax_params, tiny_jax_params,  # noqa: E402
                                      tiny_jax_pipeline, tiny_torch_pipeline)


def test_base_pipeline_latents_and_frames_match_jax():
    jpipe = tiny_jax_pipeline()
    params = tiny_jax_params(jpipe)
    rng = np.random.default_rng(5)
    image = rng.uniform(size=(1, H, W, 3)).astype(np.float32)
    noise_aug = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    init_noise = rng.standard_normal((1, T, H // 2, W // 2, 4)).astype(np.float32)

    want_lat = np.asarray(jpipe(params, image, output_type="latent",
                                noise_aug=jnp.asarray(noise_aug),
                                initial_noise=jnp.asarray(init_noise)), np.float32)
    want_frames = np.asarray(jpipe._decode(params["vae"], jnp.asarray(want_lat)))

    tpipe = tiny_torch_pipeline()
    load_jax_params(tpipe, params)
    got_lat = tpipe(image, output_type="latent", noise_aug=torch.from_numpy(noise_aug),
                    initial_noise=torch.from_numpy(init_noise))
    np.testing.assert_allclose(got_lat.numpy(), want_lat, rtol=1e-4, atol=2e-4)
    # the decode on the same latents, so frames compare the decode alone as well
    got_frames = tpipe.decode_latents(torch.tensor(want_lat)).numpy()
    assert got_frames.shape == (1, T, H, W, 3)
    np.testing.assert_allclose(got_frames, want_frames, rtol=1e-4, atol=2e-4)
    # and the whole generate() path end to end
    got_all = tpipe(image, noise_aug=torch.from_numpy(noise_aug),
                    initial_noise=torch.from_numpy(init_noise))
    np.testing.assert_allclose(got_all, want_frames, rtol=1e-4, atol=2e-4)
