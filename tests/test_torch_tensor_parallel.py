"""Weight sharding on ``torch.distributed`` (``lkgd_torch/parallel/tp.py``, the full
``parallel/mesh.py``) against ``lkgd_tpu/parallel/tp.py``.

* The spec functions against JAX's on the tiny CogVideoX (4 heads) and the tiny SVD UNet,
  VAE and CLIP: each JAX leaf's sharded axis, carried through the exporter's layouts by a
  marker array (``_torch_dims``), is the dim the port's spec names.
* One launch of 4 gloo ranks (a ``FileStore`` in the test's directory, as
  ``tests/test_torch_sequence_parallel.py``) runs the tiny I2V pipeline with its DiT tensor
  parallel at ``model=4``, FSDP at ``model=4`` (``min_size=1``: more than 20 leaves split),
  ``context=2,model=2`` (Ulysses and tensor parallel), ``data=2,model=2`` (the CFG rows
  over ``data``) and with a LoRA on every ``attn1`` projection, every leaf random; each
  against the JAX package's unsharded pipeline at rtol 2e-4 / atol 2e-5, the tolerance of
  ``tests/test_tensor_parallel.py``; the FSDP run also bit for bit against the port's
  unsharded pipeline. The bytes a rank holds equal JAX's ``per_device_param_bytes`` on a
  4-device CPU mesh, and the refusals (heads that ``model`` does not divide, a mesh whose
  product is not the world, the JAX mesh's ``slice`` axis) name their cause. The CogVideoX CLI runs once
  more in the same ranks with ``--mesh data=2,model=2 --weight-sharding fsdp``: rank 0 writes
  the frames the one-process CLI writes.

This module imports no JAX at import time: the ranks import it to run ``_rank_main``, and
the other multi-process test files its ``launch``.
"""

import dataclasses
import datetime
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-5)
WORLD = 4
PIPE = dict(height=32, width=32, num_frames=29, num_inference_steps=2)  # 8 x 2 x 2 tokens
LORA = ("*attn1*", "lora", 2, 2.0, (), ("to_q", "to_k", "to_v", "to_out"))
# the meshes of the ranks' pipeline cases: (case, --mesh, weight sharding, LoRA, Ulysses)
CASES = (("tp4", "model=4", "tp", False, False), ("fsdp4", "model=4", "fsdp", False, False),
         ("ctx2_model2", "context=2,model=2", "tp", False, True),
         ("data2_model2", "data=2,model=2", "tp", False, False),
         ("lora_tp4", "model=4", "tp", True, False))


# ------------------------------------------------------------------ the ranks' side
def _refusal(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "no error"


def port_config(lora: bool = False, **kw):
    from lkgd_torch.models.configs import CogVideoXConfig, LoraRouter, LoraRule

    router = LoraRouter((LoraRule(*LORA),) if lora else ())
    return dataclasses.replace(CogVideoXConfig.tiny(lora=router), num_attention_heads=4, **kw)


def _pipeline_case(spec, sharding, lora, ulysses, work) -> dict:
    from lkgd_torch.parallel import mesh, tp
    from lkgd_torch.pipelines import cogvideox_i2v as cog

    grid = mesh.make_mesh(spec, "cpu")
    tcfg = port_config(lora, sequence_parallel="ulysses" if ulysses else "none")
    pipe = cog.CogVideoXImageToVideoPipeline(cog.CogVideoXPipelineConfig(**PIPE), tcfg,
                                             dtype=torch.float32, device="cpu", mesh=grid)
    pipe.transformer.load_state_dict(work["lora_sd" if lora else "state_dict"], strict=True)
    pg = grid.groups["model"]
    if sharding == "tp":
        tp.tensor_parallel(pipe.transformer, pg)
    else:
        tp.fully_shard(pipe.transformer, pg, min_size=1)
    split = sum(p.numel() < n for p, n in zip(pipe.transformer.parameters(), work["numels"]))
    with torch.inference_mode():
        out = pipe(work["prompt"], work["image"], initial_noise=work["initial_noise"])
    return {"out": out, "bytes": tp.per_device_param_bytes(pipe.transformer), "split": split}


def _refusals() -> dict:
    from lkgd_torch.models.cogvideox import CogVideoXTransformer3D
    from lkgd_torch.parallel import mesh, tp

    grid = mesh.make_mesh(f"model={WORLD}", "cpu")
    with torch.device("meta"):
        six = CogVideoXTransformer3D(dataclasses.replace(port_config(), num_attention_heads=6))
    return {"heads": _refusal(lambda: tp.tensor_parallel(six, grid.groups["model"])),
            "world": _refusal(lambda: mesh.make_mesh("model=3", "cpu")),
            "slice": _refusal(lambda: mesh.make_mesh("slice=4", "cpu"))}


CLI_ARGS = ["--device", "cpu", "--tiny", "--height", "32", "--width", "48", "--num-frames",
            "9", "--num-inference-steps", "2", "--seed", "5"]
CLI_MESH = ["--mesh", "data=2,model=2", "--weight-sharding", "fsdp"]


def _cli_case(work_dir) -> None:
    """``run_inference_cogvideox.main`` with ``CLI_MESH`` in fp32; the frames rank 0 would
    write saved as they are."""
    from lkgd_torch.cli import run_inference_cogvideox as cli
    from lkgd_torch.data import video_io
    from tests.test_torch_sequence_parallel import _fp32

    cli.CogVideoXImageToVideoPipeline = _fp32(cli.CogVideoXImageToVideoPipeline)
    video_io.write_video = lambda path, frames, fps: np.save(path + ".npy", frames)
    cli.main(CLI_ARGS + ["--image", str(work_dir / "frame.png"), "--output",
                         str(work_dir / "mesh.gif")] + CLI_MESH)


def _rank_cases(rank, world, work_dir) -> dict:
    work = torch.load(work_dir / "work.pt", weights_only=False)
    out = {name: _pipeline_case(*rest, work) for name, *rest in CASES}
    out["refusals"] = _refusals()
    _cli_case(work_dir)
    return out


def _rank_main() -> None:
    """One rank of ``launch``: joins the gloo group, runs the entry, saves its outputs."""
    import torch.distributed as dist

    rank, world = int(os.environ["LAUNCH_RANK"]), int(os.environ["LAUNCH_WORLD"])
    work_dir = Path(os.environ["LAUNCH_DIR"])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(str(work_dir / "store"), world),
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        module = __import__(os.environ["LAUNCH_MODULE"], fromlist=["_rank_cases"])
        out = getattr(module, os.environ["LAUNCH_ENTRY"])(rank, world, work_dir)
        torch.save(out, work_dir / f"out{rank}.pt")
    finally:
        dist.destroy_process_group()


def launch(module: str, world: int, work_dir: Path, timeout: float = 240.0,
           entry: str = "_rank_cases", meanwhile=None) -> list:
    """``world`` ranks as processes over gloo (a ``FileStore`` in ``work_dir``), each running
    ``module.entry(rank, world, work_dir)``; a rank that fails or hangs fails the test.
    ``meanwhile()``, if given, runs in this process while the ranks run. Returns each rank's
    outputs."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tests.test_torch_tensor_parallel import _rank_main; _rank_main()")
    env = {**os.environ, "LAUNCH_WORLD": str(world), "LAUNCH_DIR": str(work_dir),
           "LAUNCH_MODULE": module, "LAUNCH_ENTRY": entry, "OMP_NUM_THREADS": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(ROOT)], cwd=ROOT,
                              env={**env, "LAUNCH_RANK": str(r)}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        if meanwhile is not None:
            meanwhile()
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the {module} ranks did not finish in {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not failed, f"ranks {failed} failed; rank {failed[:1]}:\n" + logs[failed[0]][-4000:]
    return [torch.load(work_dir / f"out{r}.pt", weights_only=False) for r in range(world)]


# ------------------------------------------------------------------ the JAX side
def jax_config(lora: bool = False):
    from lkgd_tpu.models.cogvideox import CogVideoXConfig
    from lkgd_tpu.models.configs import LoraRouter, LoraRule

    router = LoraRouter((LoraRule(*LORA),) if lora else ())
    return dataclasses.replace(CogVideoXConfig.tiny(lora=router), num_attention_heads=4)


def _jax_pipeline(lora: bool = False):
    import jax.numpy as jnp

    from lkgd_tpu.pipelines import cogvideox_i2v as jpipe

    return jpipe.CogVideoXImageToVideoPipeline(jpipe.CogVideoXPipelineConfig(**PIPE),
                                               jax_config(lora), dtype=jnp.float32)


def _jax_cases() -> tuple:
    """The ranks' inputs and JAX's outputs: the unsharded pipeline with and without LoRA,
    and the bytes a device holds under each sharding on a 4-device CPU mesh."""
    import jax
    import jax.numpy as jnp

    from lkgd_tpu.parallel import tp as jtp
    from lkgd_tpu.parallel.mesh import make_mesh

    from lkgd_torch.utils.porting import cogvideox_key_map
    from tests.test_torch_porting import port_state_dict, randomize

    want, params = {}, {}
    prompt, image = np.ones((1, 8, 64), np.float32) * 0.3, np.ones((1, 4, 4, 4), np.float32) * 0.5
    key = jax.random.PRNGKey(3)
    for lora in (False, True):
        jp = _jax_pipeline(lora)
        params[lora] = randomize(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)),
                                 seed=43, scale=0.1)
        want[lora] = np.asarray(jp(params[lora], jnp.asarray(prompt), jnp.asarray(image),
                                   rng=key))
    initial = np.array(jax.random.normal(key, want[False].shape, jnp.float32))
    mesh = make_mesh({"model": WORLD}, jax.devices()[:WORLD])
    p = params[False]
    nbytes = {"tp": jtp.per_device_param_bytes(jtp.shard_params(mesh, p,
                                                                jtp.cogvideox_tp_specs(p))),
              "fsdp": jtp.per_device_param_bytes(jtp.shard_params(
                  mesh, p, jtp.fsdp_specs(p, axis_size=WORLD, min_size=1)))}
    sd = port_state_dict(params[False]["transformer"], cogvideox_key_map)
    work = {"state_dict": sd,
            "lora_sd": port_state_dict(params[True]["transformer"], cogvideox_key_map),
            "numels": [x.numel() for x in _port_transformer(sd).parameters()],
            "prompt": torch.from_numpy(prompt), "image": torch.from_numpy(image),
            "initial_noise": torch.from_numpy(initial)}
    return work, want, nbytes


def _port_transformer(state_dict=None, lora: bool = False):
    from lkgd_torch.models.cogvideox import CogVideoXTransformer3D
    from lkgd_torch.models.layers import materialize

    model = materialize(lambda: CogVideoXTransformer3D(port_config(lora)), "cpu", torch.float32)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from lkgd_torch.data import video_io

    work_dir = tmp_path_factory.mktemp("tp")
    work, want, nbytes = _jax_cases()
    torch.save(work, work_dir / "work.pt")
    frame = np.random.default_rng(9).uniform(size=(1, 40, 56, 3)).astype(np.float32)
    video_io.write_video(str(work_dir / "frame.png"), frame, fps=8)
    outs = launch("tests.test_torch_tensor_parallel", WORLD, work_dir)
    return work, want, nbytes, outs, work_dir


def test_cli_mesh_equals_one_process(runs, monkeypatch):
    """``run_inference_cogvideox`` over ``--mesh data=2,model=2 --weight-sharding fsdp``
    (fp32): rank 0 alone writes, the frames the single-process CLI writes."""
    from lkgd_torch.cli import run_inference_cogvideox as cli
    from lkgd_torch.data import video_io
    from tests.test_torch_sequence_parallel import _fp32

    work_dir = runs[-1]
    monkeypatch.setattr(cli, "CogVideoXImageToVideoPipeline",
                        _fp32(cli.CogVideoXImageToVideoPipeline))
    monkeypatch.setattr(video_io, "write_video",
                        lambda path, frames, fps: np.save(path + ".npy", frames))
    cli.main(CLI_ARGS + ["--image", str(work_dir / "frame.png"), "--output",
                         str(work_dir / "one.gif")])
    got, want = np.load(work_dir / "mesh.gif.npy"), np.load(work_dir / "one.gif.npy")
    assert sorted(p.name for p in work_dir.glob("*.gif.npy")) == ["mesh.gif.npy", "one.gif.npy"]
    assert got.shape == want.shape == (9, 32, 48, 3)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_sharded_pipeline_matches_jax(runs, case):
    """Every rank's latents equal, and equal to the JAX package's unsharded pipeline."""
    _, want, _, outs, _ = runs
    lora = dict((c[0], c[3]) for c in CASES)[case]
    for o in outs[1:]:
        torch.testing.assert_close(o[case]["out"], outs[0][case]["out"], rtol=0, atol=0)
    assert np.abs(want[lora]).max() > 0.1
    np.testing.assert_allclose(outs[0][case]["out"].numpy(), want[lora], **TOL)


def test_fsdp_is_the_unsharded_port_bit_for_bit(runs):
    """FSDP gathers the same tensors: its pipeline is the port's unsharded one exactly, with
    more than 20 leaves split on every rank."""
    from lkgd_torch.pipelines import cogvideox_i2v as cog

    work, _, _, outs, _ = runs
    assert all(o["fsdp4"]["split"] > 20 for o in outs), [o["fsdp4"]["split"] for o in outs]
    pipe = cog.CogVideoXImageToVideoPipeline(cog.CogVideoXPipelineConfig(**PIPE), port_config(),
                                             dtype=torch.float32, device="cpu")
    pipe.transformer.load_state_dict(work["state_dict"], strict=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' threading: the same reductions
    try:
        with torch.inference_mode():
            want = pipe(work["prompt"], work["image"], initial_noise=work["initial_noise"])
    finally:
        torch.set_num_threads(threads)
    torch.testing.assert_close(outs[0]["fsdp4"]["out"], want, rtol=0, atol=0)


@pytest.mark.parametrize("sharding", ["tp", "fsdp"])
def test_bytes_a_rank_match_jax(runs, sharding):
    _, _, nbytes, outs, _ = runs
    got = [o[f"{sharding}4"]["bytes"] for o in outs]
    assert got == [nbytes[sharding]] * WORLD, (got, nbytes[sharding])
    whole = sum(p.numel() * 4 for p in _port_transformer().parameters())
    assert nbytes[sharding] < 0.8 * whole


def test_refusals(runs):
    *_, outs, _ = runs
    for o in outs:
        got = o["refusals"]
        assert "6 heads" in got["heads"] and "does not divide by 4" in got["heads"]
        assert "model=3 needs 3 processes, the world has 4" in got["world"]
        assert "axes ['slice'] are not ported" in got["slice"]


# ------------------------------------------------------------------ the spec functions
def _torch_dims(flat_specs: dict, shapes: dict, key_map) -> dict:
    """{port name: the torch dim that holds the JAX leaf's sharded axis, or None}: a marker
    array (the index along the sharded axis) carried through the port's exporter."""
    from lkgd_torch.utils.porting import from_flax_params

    markers = {}
    for path, spec in flat_specs.items():
        shape = shapes[path]
        axes = [d for d, a in enumerate(spec) if a is not None]
        x = np.zeros(shape, np.float32)
        if axes:
            d = axes[0]
            x = x + np.arange(shape[d], dtype=np.float32).reshape(
                [-1 if i == d else 1 for i in range(len(shape))])
        markers[path] = x
    dims = {}
    for name, t in from_flax_params(markers, key_map).items():
        varies = [d for d in range(t.dim()) if t.shape[d] > 1
                  and not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
        dims[name] = varies[0] if varies else None
    return dims


def _flat(tree, is_leaf=None) -> dict:
    import jax

    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _svd_models():
    """(JAX parameter shapes by model, the port's modules by model on meta) of the tiny SVD
    pipeline."""
    import jax

    from lkgd_torch.models import configs as tcfg
    from lkgd_torch.models.clip_vision import CLIPVisionModelWithProjection
    from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition
    from lkgd_torch.models.vae_temporal import AutoencoderKLTemporalDecoder
    from tests.test_torch_porting import TINY_CLIP, TINY_UNET, TINY_VAE, tiny_jax_pipeline

    shapes = jax.eval_shape(tiny_jax_pipeline().init_params, jax.random.PRNGKey(0))
    with torch.device("meta"):
        port = {"unet": UNetSpatioTemporalCondition(tcfg.SVDUNetConfig(**TINY_UNET)),
                "vae": AutoencoderKLTemporalDecoder(tcfg.TemporalVAEConfig(**TINY_VAE)),
                "image_encoder": CLIPVisionModelWithProjection(
                    tcfg.CLIPVisionConfig(**TINY_CLIP))}
    return shapes, port


@pytest.mark.parametrize("model,sharding,min_size", [
    ("cogvideox", "tp", None), ("cogvideox", "fsdp", 1), ("cogvideox", "fsdp", 2 ** 10),
    ("unet", "fsdp", 1), ("vae", "fsdp", 1), ("image_encoder", "fsdp", 2 ** 12)])
def test_specs_match_jax(model, sharding, min_size):
    """For each leaf, the port's split dim is JAX's sharded axis in the port's layout."""
    import jax
    from jax.sharding import PartitionSpec

    from lkgd_tpu.parallel import tp as jtp

    from lkgd_torch.models.cogvideox import CogVideoXTransformer3D, _exported_name
    from lkgd_torch.parallel import tp
    from lkgd_torch.utils.porting import cogvideox_key_map
    from tests.test_torch_porting import KEY_MAPS

    if model == "cogvideox":
        shapes = jax.eval_shape(_jax_pipeline().init_params, jax.random.PRNGKey(0))
        shapes = shapes["transformer"]
        with torch.device("meta"):
            port = CogVideoXTransformer3D(port_config())
        key_map = cogvideox_key_map

        def rename(n):
            return _exported_name(n) if n.startswith("knowledge_fusion.") else n
    else:
        all_shapes, ports = _svd_models()
        shapes, port, key_map = all_shapes[model], ports[model], KEY_MAPS[model]

        def rename(n):
            return n
    if sharding == "tp":
        jspecs, specs = jtp.cogvideox_tp_specs(shapes), tp.cogvideox_tp_specs(port)
    else:
        jspecs = jtp.fsdp_specs(shapes, axis_size=WORLD, min_size=min_size)
        specs = tp.fsdp_specs(port, min_size, axis_size=WORLD)
    flat_shapes = {k: v.shape for k, v in _flat(shapes).items()}
    want = _torch_dims(_flat(jspecs, lambda x: isinstance(x, PartitionSpec)), flat_shapes,
                       key_map)
    got = {rename(n): d for n, d in specs.items()}
    assert sorted(got) == sorted(want)
    assert got == want
    assert sum(d is not None for d in got.values()) > 5
