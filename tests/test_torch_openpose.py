"""OpenPose in the port (``lkgd_torch.models.openpose``) against ``lkgd_tpu.models.openpose`` at
fp32. The body model has no smaller configuration: it runs at its published widths on 64 x 96
inputs, with random JAX params carried across by ``openpose_state_dict`` and loaded strictly
(rtol 1e-4, atol 2e-4). The host decoding is the JAX package's copy: given equal inputs, a
synthetic person (Gaussian keypoint blobs, unit PAF bands along the limbs) decodes to equal
peaks, limbs, people and skeleton image in both. The processor from a
``body_pose_model.pth``-named file through ``cli/annotate.py``'s ``build_openpose_processor``
against the JAX model on its ``port_openpose_body`` params, at ``detect_resolution=64`` (368
would run the VGG front on a 368-row image): the PAFs and heatmaps it decodes at rtol 1e-4,
atol 2e-4, and the skeleton map against the JAX processor's steps on the JAX maps, equal but on
at most 1% of the pixels."""

import argparse
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import openpose as J  # noqa: E402

from lkgd_torch.cli import annotate  # noqa: E402
from lkgd_torch.models import openpose as P  # noqa: E402
from lkgd_torch.utils.porting import openpose_state_dict, save_safetensors  # noqa: E402
from tests.test_torch_porting import flatten, jit  # noqa: E402
from tests.test_torch_raft import close, random_params  # noqa: E402

# the skeleton's 18 keypoints (x, y) on a 96 x 64 canvas
PERSON = ((48, 8), (48, 18), (38, 18), (34, 30), (32, 40), (58, 18), (62, 30), (64, 40),
          (42, 36), (42, 48), (42, 58), (54, 36), (54, 48), (54, 58), (46, 6), (50, 6),
          (44, 7), (52, 7))


@pytest.fixture(scope="module")
def pair():
    model = J.BodyPoseModel(J.OpenPoseConfig())
    x = jnp.zeros((1, 64, 64, 3))
    params = random_params(jax.eval_shape(model.init, jax.random.PRNGKey(0), x), 3)
    port = P.build_openpose(P.OpenPoseConfig(), "cpu")
    port.load_state_dict(openpose_state_dict(flatten(params)), strict=True)
    return model, params, port


def test_body_model(pair):
    model, params, port = pair
    x = np.random.default_rng(1).uniform(-0.5, 0.5, size=(1, 64, 96, 3)).astype(np.float32)
    want = jit(model.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, w, c in zip(got, want, (38, 19)):
        assert tuple(g.shape) == w.shape == (1, 8, 12, c)
        close(g, np.asarray(w))


def synthetic_maps(h: int = 64, w: int = 96):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    heat = np.zeros((h, w, 19), np.float32)
    for k, (x, y) in enumerate(PERSON):
        heat[..., k] = np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 4.0)
    paf = np.zeros((h, w, 38), np.float32)
    for (ka, kb), (cx, cy) in zip(J.LIMB_SEQ, J.MAP_IDX):
        a, b = np.array(PERSON[ka], np.float32), np.array(PERSON[kb], np.float32)
        v = (b - a) / max(np.linalg.norm(b - a), 1e-4)
        t = np.clip(((xx - a[0]) * v[0] + (yy - a[1]) * v[1]) / max(np.linalg.norm(b - a), 1e-4),
                    0, 1)
        band = np.hypot(xx - (a[0] + t * (b - a)[0]), yy - (a[1] + t * (b - a)[1])) <= 1.5
        paf[..., cx] = np.where(band, v[0], paf[..., cx])
        paf[..., cy] = np.where(band, v[1], paf[..., cy])
    return paf, heat


def test_host_decoding_is_the_jax_packages():
    paf, heat = synthetic_maps()
    peaks = P.find_peaks(heat)
    assert peaks == J.find_peaks(heat) and sum(map(len, peaks)) == 18
    conns = P.match_limbs(paf, peaks, 64)
    assert conns == J.match_limbs(paf, peaks, 64)
    candidate, subsets = P.assemble_people(peaks, conns)
    want_c, want_s = J.assemble_people(peaks, conns)
    np.testing.assert_array_equal(candidate, want_c)
    assert len(subsets) == len(want_s) == 1 and subsets[0][19] >= 17
    np.testing.assert_array_equal(np.stack(subsets), np.stack(want_s))
    canvas = P.draw_bodypose(64, 96, candidate, subsets)
    np.testing.assert_array_equal(canvas, J.draw_bodypose(64, 96, want_c, want_s))
    assert canvas.max() > 0.5


def test_processor_from_a_checkpoint_file(pair, tmp_path, monkeypatch):
    import cv2

    model, params, port = pair
    path = str(tmp_path / "body_pose_model.safetensors")
    sd = openpose_state_dict(flatten(params))
    save_safetensors({k: v.numpy() for k, v in sd.items()}, path)
    image = np.random.default_rng(2).uniform(size=(40, 60, 3)).astype(np.float32)
    jparams = J.port_openpose_body({k: v.numpy() for k, v in sd.items()})
    run = jit(model.apply)
    want_paf, want_heat = run(jparams, jnp.asarray(cv2.resize(image, (96, 64))[None] - 0.5))
    got_paf, got_heat = P.openpose_maps(port, image, detect_resolution=64)
    for got, want in ((got_paf, want_paf), (got_heat, want_heat)):
        close(got, cv2.resize(np.asarray(want)[0], (60, 40), interpolation=cv2.INTER_CUBIC))
    monkeypatch.setattr(P, "make_openpose_processor",
                        functools.partial(P.make_openpose_processor, detect_resolution=64))
    got = annotate.build_openpose_processor(argparse.Namespace(
        annotation="openpose", weights=path, device="cpu", model_size="small"))(image)
    # the JAX processor's decoding of its own maps (its body is J.make_openpose_processor's)
    paf, heat = (cv2.resize(np.asarray(m)[0], (60, 40), interpolation=cv2.INTER_CUBIC)
                 for m in (want_paf, want_heat))
    peaks = J.find_peaks(heat)
    want = J.draw_bodypose(40, 60, *J.assemble_people(peaks, J.match_limbs(paf, peaks, 40)))
    assert got.shape == want.shape == (40, 60, 3) and got.dtype == np.float32
    assert (got != want).mean() <= 0.01
