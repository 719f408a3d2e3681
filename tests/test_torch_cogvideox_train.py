"""The port's CogVideoX train step (``lkgd_torch.pipelines.cogvideox_i2v``
``make_cogvideox_train_step``) against ``lkgd_tpu.pipelines.cogvideox_i2v`` at fp32 on the
CPU, on the tiny DiT with knowledge fusion and the CLI's rank-2 LoRA on every ``attn1``
projection, every parameter random (the fusion's zero-init output and the LoRA B factors
included), knowledge features of width 1000, 2 clips of 3 latent frames at 8x8:

* the loss and every trainable gradient, i2v and t2v, with remat off and on, against the
  JAX package's own jitted step with its draws (``jax.random.split(rng)``: the timesteps,
  then the noise) passed to the port as ``timesteps=`` and ``noise=``; the JAX gradients
  are read from the step itself, through an optimizer that keeps them in its state;
* the update on one set of gradients: the port's AdamW on JAX's gradients against optax's
  on them, and the port's step against the JAX step at the entries whose gradient is at
  least 1% of the largest of its tensor;
* remat on against off in the port: the same loss and gradients;
* the trained set under LoRA and under ``--full-finetune``, by the JAX CLI's export names;
* the mixed dtypes of a full fine-tune (fp32 parameters, bf16 compute) against the JAX
  module at ``dtype=bfloat16`` with the same fp32 parameters.

Tolerances: the loss rtol 1e-4, atol 2e-4; gradients and parameters the same after scaling
each by its largest entry, gradients by 1% of the largest of all where that is larger
(Adam's first step turns rounding-level gradients into moves that differ between any two
programs, hence the entries the step is held at). The bf16 forward within 3e-2 of max|ref|
(two programs rounding to bf16 at different points)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import cogvideox as jcog  # noqa: E402
from lkgd_tpu.models.configs import LoraRouter as JaxRouter  # noqa: E402
from lkgd_tpu.models.configs import LoraRule as JaxRule  # noqa: E402
from lkgd_tpu.pipelines import cogvideox_i2v as jpipe  # noqa: E402
from lkgd_tpu.training import train_state as jts  # noqa: E402
from lkgd_tpu.utils.porting import export_state_dict  # noqa: E402

from lkgd_torch.cli import train_cogvideox_lora as cli  # noqa: E402
from lkgd_torch.models import cogvideox as tcog  # noqa: E402
from lkgd_torch.models import configs as tcfg  # noqa: E402
from lkgd_torch.models.layers import materialize  # noqa: E402
from lkgd_torch.pipelines import cogvideox_i2v as tpipe  # noqa: E402
from lkgd_torch.schedulers.cogvideox_ddim import CogVideoXDDIMScheduler  # noqa: E402
from lkgd_torch.training import train_state as tts  # noqa: E402
from lkgd_torch.utils.porting import cogvideox_export_name, cogvideox_key_map  # noqa: E402

from tests.test_torch_porting import port_state_dict, randomize  # noqa: E402

TOL = dict(rtol=1e-4, atol=2e-4)
B, F, S = 2, 3, 8
LR = 1e-3
KEY = jax.random.PRNGKey(5)
PROJECTIONS = ("to_q", "to_k", "to_v", "to_out")


def jax_trainable(path: str) -> bool:
    return "lora_" in path or "knowledge_fusion" in path


def jax_config(mode: str, lora: bool = True) -> jcog.CogVideoXConfig:
    rules = (JaxRule("*attn1*", "cog", 2, 4.0, projections=PROJECTIONS),) if lora else ()
    cfg = jcog.CogVideoXConfig.tiny(lora=JaxRouter(rules=rules))
    return dataclasses.replace(cfg, in_channels=cfg.out_channels) if mode == "t2v" else cfg


def torch_config(mode: str, remat: bool = False, lora: bool = True) -> tcfg.CogVideoXConfig:
    rules = (tcfg.LoraRule("*attn1*", "cog", 2, 4.0, projections=PROJECTIONS),) if lora else ()
    cfg = dataclasses.replace(tcfg.CogVideoXConfig.tiny(lora=tcfg.LoraRouter(rules=rules)),
                              remat=remat)
    return dataclasses.replace(cfg, in_channels=cfg.out_channels) if mode == "t2v" else cfg


def batch(seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"latents": rng.normal(size=(B, F, S, S, 4)).astype(f32),
            "image_latents": rng.normal(size=(B, S, S, 4)).astype(f32),
            "prompt_embeds": rng.normal(size=(B, 8, 64)).astype(f32),
            "domain_features": rng.normal(size=(B, 1, 1000)).astype(f32),
            "flow_features": rng.normal(size=(B, 1, 1000)).astype(f32)}


def draws(key) -> dict:
    """The timesteps and noise the JAX step draws from ``key``
    (``lkgd_tpu/pipelines/cogvideox_i2v.py:378-380``)."""
    r_t, r_noise = jax.random.split(key)
    return {"timesteps": jax.random.randint(r_t, (B,), 0, 1000),
            "noise": jax.random.normal(r_noise, (B, F, S, S, 4), jnp.float32)}


def grads_kept(inner):
    """``inner`` with the gradients it was last given kept in its state."""
    def init(params):
        return (jax.tree.map(jnp.zeros_like, params), inner.init(params))

    def update(grads, state, params=None):
        updates, inner_state = inner.update(grads, state[1], params)
        return updates, (grads, inner_state)

    return optax.GradientTransformation(init, update)


def jax_params(cfg, seed: int):
    model = jcog.CogVideoXTransformer3D(cfg)
    b = batch()
    in_ch = cfg.in_channels
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((B, F, S, S, in_ch)),
                            jnp.asarray(b["prompt_embeds"]), jnp.zeros((B,)),
                            domain_features=jnp.asarray(b["domain_features"]),
                            flow_features=jnp.asarray(b["flow_features"]))
    return model, randomize(shapes, seed=seed)


def torch_names(name: str) -> str:
    """A port parameter name -> its state-dict name (the fusion as ``quaternion_lora_*``)."""
    return tcog._exported_name(name) if name.startswith("knowledge_fusion.") else name


def _torch(d: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _scaled_close(got, want, name, floor=1e-12):
    scale = max(floor, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got) / scale, np.asarray(want) / scale,
                               err_msg=name, **TOL)


def _floor(want: dict) -> float:
    return 1e-2 * max(float(w.abs().max()) for w in want.values())


@pytest.fixture(scope="module", params=["i2v", "t2v"])
def jax_run(request):
    """The JAX package's jitted step once with masked AdamW (lr 1e-3) behind an optimizer
    that keeps the gradients: its loss, gradients and parameters after; optax on those
    gradients; the random params."""
    mode = request.param
    model, params = jax_params(jax_config(mode), seed=31 if mode == "i2v" else 32)
    optimizer = grads_kept(jts.make_optimizer(LR, trainable_predicate=jax_trainable))
    step = jax.jit(jpipe.make_cogvideox_train_step(model, optimizer, mode=mode))
    state = jts.init_train_state(params, optimizer)
    b = {k: jnp.asarray(v) for k, v in batch().items()}
    if mode == "t2v":
        b.pop("image_latents")
    new_state, loss = step(state, b, KEY)
    grads = new_state.opt_state[0]
    plain = jts.make_optimizer(LR, trainable_predicate=jax_trainable)
    updates, _ = plain.update(grads, plain.init(params), params)
    return dict(mode=mode, params=params, loss=float(loss), grads=grads,
                after=new_state.params, optax_after=optax.apply_updates(params, updates))


def port_transformer(mode: str, params, remat: bool = False, lora: bool = True):
    model = materialize(lambda: tcog.CogVideoXTransformer3D(torch_config(mode, remat, lora)),
                        "cpu", torch.float32)
    model.load_state_dict(port_state_dict(params, cogvideox_key_map), strict=True)
    return model


def port_step(run, remat: bool):
    """The port's loss, gradients (by state-dict name) and one train step with JAX's draws."""
    model = port_transformer(run["mode"], run["params"], remat)
    optimizer = tts.make_optimizer(LR, trainable_predicate=cli.trainable)
    state = tts.init_train_state(model, optimizer)
    b = _torch(batch())
    if run["mode"] == "t2v":
        b.pop("image_latents")
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(torch_names(n), p.grad.detach().clone()))
        for n, p in state.trainables.items()]
    step = tpipe.make_cogvideox_train_step(model, optimizer, mode=run["mode"])
    state, loss = step(state, b, **_torch(draws(KEY)))
    for h in hooks:
        h.remove()
    after = {torch_names(n): p.detach().clone() for n, p in state.trainables.items()}
    return dict(loss=loss.item(), grads=grads, after=after, step=state.step)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_loss_and_gradients_match_jax(jax_run, remat):
    got = port_step(jax_run, remat)
    np.testing.assert_allclose(got["loss"], jax_run["loss"], **TOL)
    want = {n: g for n, g in port_state_dict(jax_run["grads"], cogvideox_key_map).items()
            if jax_trainable(n) or n.startswith("quaternion_lora_")}
    assert sorted(got["grads"]) == sorted(want) and len(want) == 45
    floor = _floor(want)
    for name, g in got["grads"].items():
        assert torch.isfinite(g).all(), name
        _scaled_close(g.numpy(), want[name].numpy(), name, floor)
    assert got["step"] == 1


def test_update_on_one_set_of_gradients(jax_run):
    """The port's AdamW on JAX's gradients is optax's on them; and where the gradients are
    above the floor, the port's step is the JAX package's step."""
    start = {n: p for n, p in port_state_dict(jax_run["params"], cogvideox_key_map).items()}
    want = {n: g for n, g in port_state_dict(jax_run["grads"], cogvideox_key_map).items()
            if jax_trainable(n) or n.startswith("quaternion_lora_")}
    params = torch.nn.ParameterList([torch.nn.Parameter(start[n].clone()) for n in want])
    optimizer = tts.make_optimizer(LR)
    optimizer.init(params)
    for p, name in zip(params, want):
        p.grad = want[name].clone()
    optimizer.step()
    optax_after = port_state_dict(jax_run["optax_after"], cogvideox_key_map)
    for p, name in zip(params, want):
        _scaled_close(p.detach().numpy(), optax_after[name].numpy(), name)
    got = port_step(jax_run, remat=True)["after"]
    after = port_state_dict(jax_run["after"], cogvideox_key_map)
    for name, g in want.items():  # entries whose gradient is above the floor of its tensor
        above = g.abs() >= 1e-2 * g.abs().max()
        _scaled_close(got[name][above].numpy(), after[name][above].numpy(), name)
    frozen = [n for n in after if n not in want]
    for name in frozen:  # the mask: no update, no weight decay
        np.testing.assert_array_equal(after[name].numpy(), start[name].numpy(), err_msg=name)


@pytest.mark.parametrize("mode", ["i2v", "t2v"])
def test_remat_on_against_off(mode):
    _, params = jax_params(jax_config(mode), seed=33)
    runs = [port_step(dict(mode=mode, params=params), remat) for remat in (False, True)]
    assert runs[0]["loss"] == pytest.approx(runs[1]["loss"], rel=1e-6)
    for name, g in runs[0]["grads"].items():
        torch.testing.assert_close(runs[1]["grads"][name], g, rtol=1e-5, atol=1e-7, msg=name)


@pytest.mark.parametrize("full", [False, True], ids=["lora", "full_finetune"])
def test_trained_set_matches_the_jax_cli(full, tmp_path):
    """The CLI's trainables by their JAX export names and shapes: the JAX CLI's trainable
    predicate over the same configuration's params (LoRA factors and the fusion, or all)."""
    argv = ["--tiny", "--device", "cpu", "--output-dir", str(tmp_path), "--rank", "2",
            "--lora-alpha", "4"] + (["--full-finetune"] if full else [])
    run = cli.build(cli.make_parser().parse_args(argv))
    got = {cogvideox_export_name(n): tuple(p.shape)
           for n, p in run.trainer.state.trainables.items()}
    jcfg = jcog.CogVideoXConfig.tiny(lora=JaxRouter(
        rules=() if full else (JaxRule("*attn1*", "cog", 2, 4.0, projections=PROJECTIONS),)))
    _, params = jax_params(jcfg, seed=34)
    want = {k: v.shape for k, v in export_state_dict(
        params, path_predicate=(lambda p: True) if full else jax_trainable).items()}
    assert got == want
    model = run.transformer
    for name, p in model.named_parameters():
        assert p.requires_grad == (full or cli.trainable(name)), name
        assert p.dtype == torch.float32


def test_mixed_dtypes_of_a_full_finetune_match_jax():
    """fp32 parameters computed in bf16 (a full fine-tune at full width): the port's
    ``dtype=bfloat16`` forward and its gradient against the JAX module at
    ``dtype=bfloat16`` with the same fp32 parameters."""
    cfg = jax_config("i2v", lora=False)
    _, params = jax_params(cfg, seed=35)
    b = batch()
    t = np.array([37.0, 901.0], np.float32)
    x = np.concatenate([b["latents"], np.repeat(b["image_latents"][:, None], F, 1)], -1)
    args = (x, b["prompt_embeds"], t)
    feats = dict(domain_features=b["domain_features"], flow_features=b["flow_features"])
    jmodel = jcog.CogVideoXTransformer3D(cfg, dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(jmodel.apply)(
        params, *(jnp.asarray(a) for a in args),
        **{k: jnp.asarray(v) for k, v in feats.items()}).astype(jnp.float32))
    model = materialize(lambda: tcog.CogVideoXTransformer3D(
        torch_config("i2v", lora=False), dtype=torch.bfloat16), "cpu", torch.float32)
    model.load_state_dict(port_state_dict(params, cogvideox_key_map), strict=True)
    out = model(*(torch.from_numpy(a) for a in args), **_torch(feats))
    assert out.dtype == torch.bfloat16
    got = out.float().detach().numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 3e-2, err
    out.float().square().mean().backward()
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None, name
        assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all(), name


def test_step_draws_from_its_generator():
    """Without injected draws the step draws its timesteps and noise from the generator it
    is given: two generators of one seed give one loss."""
    _, params = jax_params(jax_config("i2v"), seed=36)
    losses = []
    for _ in range(2):
        model = port_transformer("i2v", params)
        loss = tpipe.cogvideox_loss(model, _torch(batch()), CogVideoXDDIMScheduler(), "i2v",
                                    torch.Generator().manual_seed(4))
        losses.append(loss.item())
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    with pytest.raises(ValueError, match="mode"):
        tpipe.make_cogvideox_train_step(port_transformer("i2v", params), None, mode="v2v")
