"""Sequence parallelism on ``torch.distributed`` against ``lkgd_tpu/parallel/sequence.py``.

The port's ranks run as separate processes over gloo on the CPU (a ``FileStore`` in the
test's directory: no port to collide on; ``tests/test_torch_tensor_parallel.py`` ``launch``
starts them), 2 and 4 of them; the JAX package's functions run
on a CPU mesh of the same size. One launch of P processes runs every case of a size:
``ulysses_attention``, ``ring_attention`` and ``joint_sp_attention`` in both modes on the
same numpy inputs, a ring whose key shards differ 100x in norm (each shard's bound shift its
own) and whose every other shard holds an outlier key that no query reads (the shard's rows
past the 2^-110 guard, taken by the max-tracking version: the LSE forward's plain versions at
1024 queries and keys a shard), the tiny SP pipeline of
``tests/test_cogvideox.py:127-149`` in both modes, and the refusals (P does not divide the
video tokens, P does not divide the heads for Ulysses, ``--mesh context=N`` against another
world size). The CLI runs once more in 2 ranks with ``--sequence-parallel ring``.

This module imports no JAX at import time: the ranks import it to run ``_rank_cases``.
Tolerances: rtol 1e-4 / atol 2e-4 at fp32; the pipeline rtol 2e-4 / atol 2e-5 (the JAX
test's)."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_tensor_parallel import launch

TOL = dict(rtol=1e-4, atol=2e-4)
PIPE_TOL = dict(rtol=2e-4, atol=2e-5)
TEXT = 5  # text tokens of the joint cases: no multiple of 2 or 4 (the ring pads them)
PIPE = dict(height=32, width=32, num_frames=29, num_inference_steps=2)  # 8 x 2 x 2 tokens
SKEW = (1.0, 0.01)  # key scales of alternate shards: norms 100x apart, both weighing in
CLI_ARGS = ["--device", "cpu", "--tiny", "--height", "32", "--width", "48", "--num-frames",
            "9", "--num-inference-steps", "2", "--seed", "5"]


# ------------------------------------------------------------------ the ranks' side
def _shard(x: torch.Tensor, rank: int, world: int, text: int = 0) -> torch.Tensor:
    """The text prefix and this rank's shard of the rest of axis 1."""
    n = (x.shape[1] - text) // world
    return torch.cat([x[:, :text], x[:, text + rank * n:text + (rank + 1) * n]], dim=1)


def _refusal(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "no error"


def _attention_cases(rank, world, work, pg) -> dict:
    from lkgd_torch.parallel import sequence

    out = {}
    q, k, v = work["plain"]
    for name, fn in (("ulysses", sequence.ulysses_attention), ("ring", sequence.ring_attention)):
        out[name] = fn(*(_shard(x, rank, world) for x in (q, k, v)), pg)
    q, k, v = work["joint"]
    for mode in ("ulysses", "ring"):
        shards = (_shard(x, rank, world, TEXT) for x in (q, k, v))
        out[f"joint_{mode}"] = sequence.joint_sp_attention(*shards, TEXT, mode, pg)
    out["skewed"] = sequence.ring_attention(*(_shard(x, rank, world) for x in work["skewed"]),
                                            pg)
    return out


def _pipeline_cases(rank, world, work, grid) -> dict:
    from lkgd_torch.models.configs import CogVideoXConfig
    from lkgd_torch.pipelines import cogvideox_i2v as cog

    out = {}
    for mode in ("ulysses", "ring"):
        tcfg = dataclasses.replace(CogVideoXConfig.tiny(), num_attention_heads=4,
                                   sequence_parallel=mode)
        pipe = cog.CogVideoXImageToVideoPipeline(cog.CogVideoXPipelineConfig(**PIPE), tcfg,
                                                 dtype=torch.float32, device="cpu", mesh=grid)
        pipe.transformer.load_state_dict(work["state_dict"], strict=True)
        with torch.inference_mode():
            out[f"pipeline_{mode}"] = pipe(work["prompt"], work["image"],
                                           initial_noise=work["initial_noise"])
        if mode == "ring":  # 3 video tokens a frame row: P does not divide them
            out["refuse_tokens"] = _refusal(lambda: pipe.transformer(
                torch.zeros(1, 1, 2, 6, 8), work["prompt"], 999.0))
    return out


def _refusals(rank, world, pg) -> dict:
    from lkgd_torch.parallel import mesh, sequence

    x = torch.zeros(1, 2 + 4, 3, 8)  # 3 heads
    return {"refuse_heads": _refusal(lambda: sequence.joint_sp_attention(x, x, x, 2, "ulysses",
                                                                         pg)),
            "refuse_world": _refusal(lambda: mesh.make_mesh(f"context={world + 1}", "cpu"))}


def _fp32(pipeline_class):
    """The CLI's pipeline class built in fp32 where the CLI builds it in bf16."""
    return lambda **kw: pipeline_class(**{**kw, "dtype": torch.float32})


def _cli_rank_cases(rank, world, work_dir) -> dict:
    """``run_inference_cogvideox.main`` with ``--mesh context=P --sequence-parallel ring``
    in fp32; the frames it would write saved as they are."""
    from lkgd_torch.cli import run_inference_cogvideox as cli
    from lkgd_torch.data import video_io

    cli.CogVideoXImageToVideoPipeline = _fp32(cli.CogVideoXImageToVideoPipeline)
    video_io.write_video = lambda path, frames, fps: np.save(path + ".npy", frames)
    cli.main(CLI_ARGS + ["--image", str(work_dir / "frame.png"), "--output",
                         str(work_dir / "sp.gif"), "--mesh", f"context={world}",
                         "--sequence-parallel", "ring"])
    return {}


def _rank_cases(rank, world, work_dir) -> dict:
    from lkgd_torch.parallel import mesh

    grid = mesh.make_mesh(f"context={world}", "cpu")
    pg = grid.groups["context"]
    work = torch.load(work_dir / "work.pt", weights_only=False)
    return {**_attention_cases(rank, world, work, pg),
            **_pipeline_cases(rank, world, work, grid), **_refusals(rank, world, pg)}


# ------------------------------------------------------------------ the JAX side
def _jax_cases(world: int) -> tuple:
    """The numpy inputs of every case (as torch tensors for the ranks) and JAX's outputs on
    a CPU mesh of ``world`` devices."""
    import jax
    import jax.numpy as jnp

    from lkgd_tpu.models.cogvideox import CogVideoXConfig as JaxConfig
    from lkgd_tpu.parallel.mesh import make_mesh
    from lkgd_tpu.parallel.sequence import joint_sp_attention, ring_attention, ulysses_attention
    from lkgd_tpu.pipelines import cogvideox_i2v as jpipe

    from lkgd_torch.utils.porting import cogvideox_key_map
    from tests.test_torch_porting import port_state_dict, randomize

    rng = np.random.default_rng(world)
    mesh = make_mesh({"context": world}, jax.devices()[:world])

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    plain = [normal(2, 64, 8, 16) for _ in range(3)]
    joint = [normal(2, TEXT + 64, 8, 16) for _ in range(3)]
    n = 1024  # queries and keys a shard: the LSE forward's plain versions
    scale = np.repeat(np.array([SKEW[i % 2] for i in range(world)], np.float32), n)
    skewed = [normal(1, world * n, 2, 16, scale=2.0), normal(1, world * n, 2, 16),
              normal(1, world * n, 2, 16)]
    skewed[1] *= scale[None, :, None, None]
    skewed[0][..., 0] = 0.0  # no query reads the outliers' direction
    for i in range(0, world, 2):  # an outlier key of 60x the norm in every other shard
        skewed[1][:, i * n] = 0.0
        skewed[1][:, i * n, :, 0] = 60.0 * 4.0
    want = {}
    for name, fn in (("ulysses", ulysses_attention), ("ring", ring_attention)):
        want[name] = fn(*map(jnp.asarray, plain), mesh)
    with jax.set_mesh(mesh):
        for mode in ("ulysses", "ring"):
            want[f"joint_{mode}"] = jax.jit(
                lambda a, b, c, m=mode: joint_sp_attention(a, b, c, TEXT, m))(*map(jnp.asarray,
                                                                                     joint))
    want["skewed"] = ring_attention(*map(jnp.asarray, skewed), mesh)

    jcfg = dataclasses.replace(JaxConfig.tiny(), num_attention_heads=4)
    jp = jpipe.CogVideoXImageToVideoPipeline(jpipe.CogVideoXPipelineConfig(**PIPE), jcfg,
                                             dtype=jnp.float32)
    params = randomize(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)), seed=43, scale=0.1)
    prompt, image = np.ones((1, 8, 64), np.float32) * 0.3, np.ones((1, 4, 4, 4), np.float32) * 0.5
    key = jax.random.PRNGKey(3)
    want["pipeline"] = jp(params, jnp.asarray(prompt), jnp.asarray(image), rng=key)
    initial = np.array(jax.random.normal(key, want["pipeline"].shape, jnp.float32))
    work = {"plain": [torch.from_numpy(x) for x in plain],
            "joint": [torch.from_numpy(x) for x in joint],
            "skewed": [torch.from_numpy(x) for x in skewed],
            "state_dict": port_state_dict(params["transformer"], cogvideox_key_map),
            "prompt": torch.from_numpy(prompt), "image": torch.from_numpy(image),
            "initial_noise": torch.from_numpy(initial)}
    return work, {k: np.asarray(v) for k, v in want.items()}


@pytest.fixture(scope="module", params=[2, 4], ids=["2_ranks", "4_ranks"])
def runs(request, tmp_path_factory):
    """Every case at one world size: the ranks' outputs joined, JAX's outputs."""
    world = request.param
    work_dir = tmp_path_factory.mktemp(f"sp{world}")
    work, want = _jax_cases(world)
    torch.save(work, work_dir / "work.pt")
    outs = launch("tests.test_torch_sequence_parallel", world, work_dir)
    got = {}
    for name in outs[0]:
        if name.startswith("refuse"):
            got[name] = [o[name] for o in outs]
        elif name.startswith("pipeline"):  # whole on every rank
            for o in outs[1:]:
                torch.testing.assert_close(o[name], outs[0][name], rtol=0, atol=0)
            got[name] = outs[0][name].numpy()
        else:  # each rank's shard (joint: the whole text prefix on each)
            text = TEXT if name.startswith("joint") else 0
            for o in outs[1:]:
                torch.testing.assert_close(o[name][:, :text], outs[0][name][:, :text],
                                           rtol=0, atol=0)
            got[name] = torch.cat([outs[0][name][:, :text]]
                                  + [o[name][:, text:] for o in outs], dim=1).numpy()
    return world, got, want


@pytest.mark.parametrize("case", ["ulysses", "ring", "joint_ulysses", "joint_ring", "skewed"])
def test_sp_attention_matches_jax(runs, case):
    _, got, want = runs
    assert got[case].shape == want[case].shape
    np.testing.assert_allclose(got[case], want[case], **TOL)


def test_sp_pipeline_matches_jax(runs):
    """The tiny I2V pipeline with each mode's DiT: every rank's latents equal, and equal to
    the JAX package's dense pipeline on the same weights and noise."""
    _, got, want = runs
    assert np.abs(want["pipeline"]).max() > 0.1
    for mode in ("ulysses", "ring"):
        np.testing.assert_allclose(got[f"pipeline_{mode}"], want["pipeline"], **PIPE_TOL,
                                   err_msg=mode)


def test_sp_refusals(runs):
    world, got, _ = runs
    assert all("3 video tokens" in m and "does not divide" in m for m in got["refuse_tokens"])
    assert all("3 heads" in m for m in got["refuse_heads"])
    assert all(f"context={world + 1} needs {world + 1} processes" in m
               for m in got["refuse_world"])


def test_sp_cli_ring_equals_one_process(tmp_path, monkeypatch):
    """``run_inference_cogvideox`` in 2 gloo ranks with ``--sequence-parallel ring`` (fp32):
    rank 0 alone writes, the frames the single-process CLI writes."""
    from lkgd_torch.cli import run_inference_cogvideox as cli
    from lkgd_torch.data import video_io

    frame = np.random.default_rng(9).uniform(size=(1, 40, 56, 3)).astype(np.float32)
    video_io.write_video(str(tmp_path / "frame.png"), frame, fps=8)
    launch("tests.test_torch_sequence_parallel", 2, tmp_path, entry="_cli_rank_cases")
    monkeypatch.setattr(cli, "CogVideoXImageToVideoPipeline",
                        _fp32(cli.CogVideoXImageToVideoPipeline))
    monkeypatch.setattr(video_io, "write_video",
                        lambda path, frames, fps: np.save(path + ".npy", frames))
    cli.main(CLI_ARGS + ["--image", str(tmp_path / "frame.png"), "--output",
                         str(tmp_path / "one.gif")])
    got, want = np.load(tmp_path / "sp.gif.npy"), np.load(tmp_path / "one.gif.npy")
    assert sorted(p.name for p in tmp_path.glob("*.npy")) == ["one.gif.npy", "sp.gif.npy"]
    assert got.shape == want.shape == (9, 32, 48, 3)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("argv,message", [
    (["--mesh", "model=2", "--sequence-parallel", "ring"], "needs --mesh with a 'context' axis"),
    (["--mesh", "data=2", "--sequence-parallel", "ulysses"],
     "needs --mesh with a 'context' axis"),
    (["--weight-sharding", "tp"], "needs --mesh with a 'model' axis"),
    (["--sequence-parallel", "ulysses"], "needs --mesh"),
    (["--mesh", "context=2"], "needs --sequence-parallel"),
], ids=["model_axis", "data_axis", "weight_sharding", "sp_without_mesh", "mesh_without_sp"])
def test_cli_refusals(argv, message, capsys):
    from lkgd_torch.cli import run_inference_cogvideox as cli

    p = cli.make_parser()
    with pytest.raises(SystemExit):
        cli.check_args(p, p.parse_args(["--image", "x.png", "--device", "cpu"] + argv))
    assert message in capsys.readouterr().err


def test_attention_with_lse_matches_jax():
    """The (out, lse2) primitive against the JAX package's on the plain path, its lse in
    the (B, S_q, H) layout, and the merge of two key blocks against whole attention; at 1024+
    tokens the LSE forward's plain version (kernel 7's arithmetic with its shift) agrees."""
    import jax.numpy as jnp

    from lkgd_tpu.ops.attention import _xla_attention, attention_with_lse as jax_lse

    from lkgd_torch.ops.attention import attention_with_lse
    from lkgd_torch.parallel.sequence import merge_partials

    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, 64, 4, 16)).astype(np.float32) for _ in range(3))
    want_o, want_l = jax_lse(*map(jnp.asarray, (q, k, v)))
    got_o, got_l = attention_with_lse(*map(torch.from_numpy, (q, k, v)))
    assert got_l.shape == (2, 64, 4) and got_l.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    q, k, v = (rng.normal(size=(1, 2048, 2, 16)).astype(np.float32) for _ in range(3))
    k[:, :1024] *= 30.0  # the two blocks' bound shifts far apart
    whole = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v)), None))
    (o1, l1), (o2, l2) = (attention_with_lse(torch.from_numpy(q), torch.from_numpy(k[:, s]),
                                             torch.from_numpy(v[:, s]))
                          for s in (slice(0, 1024), slice(1024, None)))
    want_o, want_l = jax_lse(*map(jnp.asarray, (q, k[:, :1024], v[:, :1024])))
    np.testing.assert_allclose(l1.numpy(), np.asarray(want_l), **TOL)
    merged, merged_l = merge_partials([(o1, l1), (o2, l2)])
    np.testing.assert_allclose(merged.numpy(), whole, **TOL)
    _, whole_l = jax_lse(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(merged_l.numpy(), np.asarray(whole_l), **TOL)
