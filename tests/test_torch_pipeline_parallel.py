"""Pipeline parallelism on ``torch.distributed`` (``lkgd_torch/parallel/pp.py``) against
``lkgd_tpu/parallel/pp.py``, the cases of ``tests/test_pipeline_parallel.py``.

One launch of 4 gloo ranks (``tests/test_torch_tensor_parallel.py`` ``launch``) runs every
case: the MLP stack of 8 layers at M=2 over ``--mesh stage=4`` and, at B=8, M=8 over the
two stage groups of ``data=2,stage=2``; 6 layers over 4 stages and a batch that M does not
divide, refused; tiny CogVideoX blocks (4 layers) over 4 stages at M=2; the tiny
transformer's full forward with ``blocks_override=cogvideox_pp_blocks(...)`` at M=2, and at
M=1 beside the unsharded forward of the same process. The JAX package's ``gpipe`` and
``cogvideox_pp_blocks`` run on a CPU mesh of the same size in the test process. Each case
is held against JAX and against the unsharded port at 2e-5, the JAX test's tolerance; the
stacked MLP tree goes to both packages as it is (``gpipe`` takes JAX's stacked layout).

This module imports no JAX at import time: the ranks import it to run ``_rank_cases``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_tensor_parallel import launch

TOL = dict(rtol=2e-5, atol=2e-5)
WORLD = 4
B, T, HW = 4, 2, 4  # the CogVideoX cases' batch, latent frames, latent height and width


def _mlp_step(lp, st, cst):
    return torch.tanh(st @ lp["w"] + lp["b"]) + cst["skip"] * st


def _refusal(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "no error"


def port_cogvideox(state_dict):
    from lkgd_torch.models.cogvideox import CogVideoXTransformer3D
    from lkgd_torch.models.configs import CogVideoXConfig
    from lkgd_torch.models.layers import materialize

    cfg = dataclasses.replace(CogVideoXConfig.tiny(), num_layers=4)
    model = materialize(lambda: CogVideoXTransformer3D(cfg), "cpu", torch.float32)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def port_rope(model, text_len: int):
    """The rotary tables a block of the port takes: the identity over the text prefix, as
    the transformer's forward builds them."""
    import torch.nn.functional as F

    from lkgd_torch.models.cogvideox import rope_3d

    cfg = model.config
    cos, sin = rope_3d(T, HW // cfg.patch_size, HW // cfg.patch_size, cfg.attention_head_dim)
    return F.pad(cos, (0, 0, text_len, 0), value=1.0), F.pad(sin, (0, 0, text_len, 0))


def _block_step(block, st, rope):
    hidden, encoder = block(st["hidden"], st["encoder"], st["temb"], rope)
    return {"hidden": hidden, "encoder": encoder, "temb": st["temb"]}


# ------------------------------------------------------------------ the ranks' side
def _rank_cases(rank, world, work_dir) -> dict:
    from lkgd_torch.parallel import mesh, pp, tp

    work = torch.load(work_dir / "work.pt", weights_only=False)
    grid = mesh.make_mesh(f"stage={world}", "cpu")
    pg = grid.groups[pp.STAGE_AXIS]
    out = {}
    with torch.no_grad():
        mlp = work["mlp"]
        out["mlp"] = pp.gpipe(_mlp_step, mlp["params"], mlp["state"], mlp["consts"], group=pg,
                              num_microbatches=2)
        six = {k: v[:6] for k, v in mlp["params"].items()}
        out["refuse_layers"] = _refusal(lambda: pp.gpipe(
            _mlp_step, six, mlp["state"], mlp["consts"], group=pg, num_microbatches=2))
        out["refuse_batch"] = _refusal(lambda: pp.gpipe(
            _mlp_step, mlp["params"], mlp["state"], mlp["consts"], group=pg,
            num_microbatches=3))
        two = mesh.make_mesh("data=2,stage=2", "cpu")
        wide = work["mlp8"]
        out["mlp8"] = pp.gpipe(_mlp_step, wide["params"], wide["state"], wide["consts"],
                               group=two.groups[pp.STAGE_AXIS], num_microbatches=8)

        model = port_cogvideox(work["state_dict"])
        blocks = work["blocks"]
        rope = port_rope(model, blocks["encoder"].shape[1])
        out["blocks"] = pp.gpipe(_block_step, list(model.transformer_blocks), blocks, rope,
                                 group=pg, num_microbatches=2)
        x, prompt, ts = work["forward"]
        whole = tp.per_device_param_bytes(model)
        for m in (1, 2):
            model = port_cogvideox(work["state_dict"])
            if m == 1:
                out["plain"] = model(x, prompt, ts)
            override = pp.cogvideox_pp_blocks(model, pg, num_microbatches=m)
            out[f"forward_m{m}"] = model(x, prompt, ts, blocks_override=override)
        out["bytes"] = (tp.per_device_param_bytes(model), whole)
        try:
            model(x, prompt, ts)
        except RuntimeError as e:
            out["elsewhere"] = str(e)
    _cli_case(work_dir)
    return out


def _cli_case(work_dir) -> None:
    """``run_inference_cogvideox.main`` with ``--mesh stage=4`` in fp32: the axis is made and
    unread, as in the JAX CLI; the frames rank 0 would write saved as they are."""
    from lkgd_torch.cli import run_inference_cogvideox as cli
    from lkgd_torch.data import video_io
    from tests.test_torch_sequence_parallel import _fp32
    from tests.test_torch_tensor_parallel import CLI_ARGS

    cli.CogVideoXImageToVideoPipeline = _fp32(cli.CogVideoXImageToVideoPipeline)
    video_io.write_video = lambda path, frames, fps: np.save(path + ".npy", frames)
    cli.main(CLI_ARGS + ["--image", str(work_dir / "frame.png"), "--output",
                         str(work_dir / "stage.gif"), "--mesh", f"stage={WORLD}"])


# ------------------------------------------------------------------ the JAX side
def _mlp(n_layers=8, b=4, d=16, seed=0):
    """``tests/test_pipeline_parallel.py``'s MLP stack: numpy params, state and consts."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(0, 0.3, (n_layers, d, d)).astype(np.float32),
              "b": rng.normal(0, 0.1, (n_layers, d)).astype(np.float32)}
    return params, rng.normal(size=(b, d)).astype(np.float32), {"skip": np.float32(0.5)}


def _jax_cases() -> tuple:
    import jax
    import jax.numpy as jnp

    from lkgd_tpu.models.cogvideox import (CogVideoXBlock, CogVideoXConfig,
                                           CogVideoXTransformer3D, rope_3d)
    from lkgd_tpu.parallel.mesh import make_mesh
    from lkgd_tpu.parallel.pp import cogvideox_pp_blocks, gpipe, stack_block_params

    from lkgd_torch.utils.porting import cogvideox_key_map
    from tests.test_torch_porting import port_state_dict, randomize

    def jstep(lp, st, cst):
        return jnp.tanh(st @ lp["w"] + lp["b"]) + cst["skip"] * st

    def sequential(step, stacked, state, consts):
        return jax.lax.scan(lambda c, lp: (step(lp, c, consts), None), state, stacked)[0]

    mesh4 = make_mesh({"stage": WORLD}, jax.devices()[:WORLD])
    mesh2 = make_mesh({"stage": 2}, jax.devices()[:2])
    want, work = {}, {}
    for name, (b, m, mesh) in (("mlp", (4, 2, mesh4)), ("mlp8", (8, 8, mesh2))):
        params, state, consts = _mlp(b=b)
        jp = jax.tree.map(jnp.asarray, (params, state, consts))
        want[name] = gpipe(jstep, *jp, mesh=mesh, num_microbatches=m)
        want[f"{name}_sequential"] = sequential(jstep, *jp)
        work[name] = {"params": {k: torch.from_numpy(v) for k, v in params.items()},
                      "state": torch.from_numpy(state),
                      "consts": {"skip": torch.tensor(consts["skip"])}}

    cfg = dataclasses.replace(CogVideoXConfig.tiny(), num_layers=4)
    model = CogVideoXTransformer3D(cfg)
    x = jax.random.normal(jax.random.PRNGKey(0), (B, T, HW, HW, 8))
    pe = jax.random.normal(jax.random.PRNGKey(1), (B, 8, cfg.text_embed_dim))
    ts = jnp.full((B,), 500.0)
    params = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(2), x, pe, jnp.zeros((B,))),
                       seed=21, scale=0.2)
    stacked = stack_block_params(params["params"], cfg.num_layers)
    block = CogVideoXBlock(cfg, "pp")
    hp = HW // cfg.patch_size
    rng = np.random.default_rng(5)
    state = {"hidden": rng.normal(size=(B, T * hp * hp, cfg.inner_dim)).astype(np.float32),
             "encoder": rng.normal(size=(B, 8, cfg.inner_dim)).astype(np.float32),
             "temb": rng.normal(size=(B, cfg.inner_dim)).astype(np.float32)}
    rope = rope_3d(T, hp, hp, cfg.attention_head_dim)

    def bstep(lp, st, cst):
        hid, enc = block.apply({"params": lp}, st["hidden"], st["encoder"], st["temb"], cst)
        return {"hidden": hid, "encoder": enc, "temb": st["temb"]}

    jstate = jax.tree.map(jnp.asarray, state)
    want["blocks"] = gpipe(bstep, stacked, jstate, rope, mesh=mesh4, num_microbatches=2)
    want["forward_plain"] = model.apply(params, x, pe, ts)
    blocks_fn = cogvideox_pp_blocks(cfg, params, mesh4, num_microbatches=2)
    want["forward"] = model.apply(params, x, pe, ts, blocks_override=blocks_fn)
    work["state_dict"] = port_state_dict(params, cogvideox_key_map)
    work["blocks"] = {k: torch.from_numpy(v) for k, v in state.items()}
    work["forward"] = tuple(torch.from_numpy(np.array(a)) for a in (x, pe, ts))
    return work, jax.tree.map(np.asarray, want)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from lkgd_torch.data import video_io

    work_dir = tmp_path_factory.mktemp("pp")
    work, want = _jax_cases()
    torch.save(work, work_dir / "work.pt")
    frame = np.random.default_rng(9).uniform(size=(1, 40, 56, 3)).astype(np.float32)
    video_io.write_video(str(work_dir / "frame.png"), frame, fps=8)
    outs = launch("tests.test_torch_pipeline_parallel", WORLD, work_dir)
    return work, want, outs, work_dir


def _same_on_every_rank(outs, name):
    from torch.utils._pytree import tree_flatten

    first = tree_flatten(outs[0][name])[0]
    for o in outs[1:]:
        for a, b in zip(first, tree_flatten(o[name])[0]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    return outs[0][name]


@pytest.mark.parametrize("case", ["mlp", "mlp8"], ids=["m2_over_4_stages", "m8_over_2_stages"])
def test_mlp_stack_matches_jax_gpipe(runs, case):
    """The MLP stack, handed to both packages as one stacked tree: the port's pipeline on
    every rank equals JAX's ``gpipe`` and the sequential scan; the unsharded port too."""
    work, want, outs, _ = runs
    got = _same_on_every_rank(outs, case).numpy()
    np.testing.assert_allclose(got, want[case], **TOL)
    np.testing.assert_allclose(got, want[f"{case}_sequential"], **TOL)
    mlp = work[case]
    st = mlp["state"]
    for i in range(mlp["params"]["w"].shape[0]):
        st = _mlp_step({k: v[i] for k, v in mlp["params"].items()}, st, mlp["consts"])
    np.testing.assert_allclose(got, st.numpy(), **TOL)


def test_refusals_carry_jax_messages(runs):
    _, _, outs, _ = runs
    for o in outs:
        assert o["refuse_layers"] == "6 layers do not split over 4 stages"
        assert o["refuse_batch"] == "batch 4 does not split into 3 microbatches"


def test_cogvideox_blocks_match_jax_gpipe(runs):
    """Four tiny DiT blocks over 4 stages at M=2, the time embedding a pass-through leaf of
    the state and the rotary tables a constant."""
    work, want, outs, _ = runs
    got = _same_on_every_rank(outs, "blocks")
    model = port_cogvideox(work["state_dict"])
    st = work["blocks"]
    rope = port_rope(model, st["encoder"].shape[1])
    with torch.no_grad():
        for block in model.transformer_blocks:
            st = _block_step(block, st, rope)
    for k in ("hidden", "encoder", "temb"):
        assert np.abs(want["blocks"][k]).max() > 0.1
        np.testing.assert_allclose(got[k].numpy(), want["blocks"][k], err_msg=k, **TOL)
        np.testing.assert_allclose(got[k].numpy(), st[k].numpy(), err_msg=k, **TOL)


def test_full_forward_with_pp_blocks_matches_plain(runs):
    """``forward(blocks_override=cogvideox_pp_blocks(...))`` equals JAX's forward with its own
    ``cogvideox_pp_blocks`` and the plain forward; at M=1 the same bits as the plain forward
    of the same process. Each rank then holds its blocks only and the transformer refuses
    a call without the override."""
    work, want, outs, _ = runs
    m2 = _same_on_every_rank(outs, "forward_m2").numpy()
    np.testing.assert_allclose(m2, want["forward"], **TOL)
    np.testing.assert_allclose(m2, want["forward_plain"], **TOL)
    block = sum(p.numel() * 4 for p in port_cogvideox(work["state_dict"]).transformer_blocks[0]
                .parameters())
    for o in outs:
        torch.testing.assert_close(o["forward_m1"], o["plain"], rtol=0, atol=0)
        held, whole = o["bytes"]
        assert held == whole - 3 * block  # the 3 blocks of the other stages dropped
        assert "lives on stage" in o["elsewhere"]


def test_parse_mesh_takes_the_stage_axis():
    from lkgd_torch.parallel import mesh, pp

    assert mesh.parse_mesh("stage=2") == {"stage": 2}
    assert mesh.parse_mesh("data=2,stage=2") == {"data": 2, "stage": 2}
    assert pp.STAGE_AXIS == mesh.STAGE_AXIS == "stage"
    with pytest.raises(ValueError, match="'slice'"):
        mesh.parse_mesh("slice=2")


def test_stack_block_params_is_jax_layout():
    """The port's ``stack_block_params`` stacks a state dict's ``transformer_blocks.{i}.*``
    as JAX's stacks its ``transformer_blocks_{i}`` subtrees, and ``unstack_block_params``
    gives the blocks back."""
    from lkgd_torch.models.cogvideox import CogVideoXTransformer3D
    from lkgd_torch.models.configs import CogVideoXConfig
    from lkgd_torch.parallel import pp

    model = CogVideoXTransformer3D(dataclasses.replace(CogVideoXConfig.tiny(), num_layers=3))
    sd = model.state_dict()
    stacked = pp.stack_block_params(sd, 3)
    assert stacked.keys() == model.transformer_blocks[0].state_dict().keys()
    for name, x in stacked.items():
        assert x.shape[0] == 3
        for i, blk in enumerate(pp.unstack_block_params(stacked)):
            assert torch.equal(blk[name], sd[f"transformer_blocks.{i}.{name}"])
    with pytest.raises(ValueError, match="do not hold the same names"):
        pp.stack_block_params(sd, 4)


def test_cli_stage_axis_runs_the_whole_model(runs, monkeypatch):
    """``run_inference_cogvideox --mesh stage=4`` (fp32) over the 4 ranks: the axis is made
    and nothing reads it, as in the JAX CLI; rank 0 alone writes, the frames of the
    single-process CLI bit for bit (each rank runs the whole model)."""
    from lkgd_torch.cli import run_inference_cogvideox as cli
    from lkgd_torch.data import video_io
    from tests.test_torch_sequence_parallel import _fp32
    from tests.test_torch_tensor_parallel import CLI_ARGS

    work_dir = runs[-1]
    monkeypatch.setattr(cli, "CogVideoXImageToVideoPipeline",
                        _fp32(cli.CogVideoXImageToVideoPipeline))
    monkeypatch.setattr(video_io, "write_video",
                        lambda path, frames, fps: np.save(path + ".npy", frames))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' threading: the same reductions
    try:
        cli.main(CLI_ARGS + ["--image", str(work_dir / "frame.png"), "--output",
                             str(work_dir / "one.gif")])
    finally:
        torch.set_num_threads(threads)
    got, want = np.load(work_dir / "stage.gif.npy"), np.load(work_dir / "one.gif.npy")
    assert got.shape == want.shape == (9, 32, 48, 3)
    np.testing.assert_array_equal(got, want)
