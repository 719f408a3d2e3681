"""8-bit Adam in the port (``lkgd_torch.training.optim8bit``) against
``lkgd_tpu.training.optim8bit`` on the same arrays: blockwise quantisation and its inverse
(linear and quartic codes, ragged sizes, all-zero blocks), three ``adamw8bit`` steps per
tensor and packed, the packed form bit-identical to the per-tensor one,
``opt_state_bytes``, and ``make_optimizer(use_8bit=True)`` with the trainable mask and the
global-norm clip, through a checkpoint's ``state_dict`` round trip.

Codes must be equal and dequantised values within 1e-6 relative: both sides do the same
fp32 arithmetic. Parameters after three steps rtol 1e-5, atol 1e-7, as the fp32 AdamW
comparison of ``tests/test_torch_training.py``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.training import optim8bit as jopt  # noqa: E402
from lkgd_tpu.training import train_state as jts  # noqa: E402

from lkgd_torch.training import optim8bit as topt  # noqa: E402
from lkgd_torch.training import train_state as tts  # noqa: E402

# two tensors above the 8-bit threshold (one ragged against the block), one below it
SHAPES = {"lora_a": (70, 64), "lora_big": (4101,), "lora_small": (5, 7)}


@pytest.mark.parametrize("power", [1, 4])
@pytest.mark.parametrize("block", [256, 64])
def test_quantize_dequantize_match_jax(power, block):
    rng = np.random.default_rng(power + block)
    x = (rng.standard_normal(1000) * np.logspace(-6, 1, 1000)).astype(np.float32)
    if power == 4:
        x = np.abs(x)  # the second moment
    x[:block] = 0.0  # an all-zero block keeps scale 0
    want = jopt.quantize8(jnp.asarray(x), block, power)
    got = topt.quantize8(torch.from_numpy(x), block, power)
    assert got.codes.dtype == torch.int8 and got.codes.shape == x.shape
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    back = topt.dequantize8(got, block, power).numpy()
    np.testing.assert_allclose(back, np.asarray(jopt.dequantize8(want, block, power)),
                               rtol=1e-6, atol=0)
    assert not back[:block].any()


def _tensors(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("packed", [False, True], ids=["per_tensor", "packed"])
def test_adamw8bit_steps_match_jax(packed):
    init = _tensors(0)
    grads = [_tensors(i + 1, 0.1) for i in range(3)]
    tx = jopt.adamw8bit(1e-2, packed=packed)
    params_j = {k: jnp.asarray(v) for k, v in init.items()}
    state_j = tx.init(params_j)
    for g in grads:
        updates, state_j = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state_j,
                                     params_j)
        params_j = optax.apply_updates(params_j, updates)

    names = sorted(SHAPES)  # the order of the JAX tree's leaves
    params = [torch.nn.Parameter(torch.from_numpy(init[k].copy())) for k in names]
    opt = topt.adamw8bit(params, 1e-2, packed=packed)
    for g in grads:
        for k, p in zip(names, params):
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k, p in zip(names, params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params_j[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert topt.opt_state_bytes(opt) == jopt.opt_state_bytes(state_j)
    # packed and per tensor hold the same codes: the packed form changes the layout only
    if packed:
        plain = [torch.nn.Parameter(torch.from_numpy(init[k].copy())) for k in names]
        other = topt.adamw8bit(plain, 1e-2)
        for g in grads:
            for k, p in zip(names, plain):
                p.grad = torch.from_numpy(g[k].copy())
            other.step()
        for p, q in zip(params, plain):
            assert torch.equal(p, q)


def test_8bit_state_is_a_quarter_of_fp32():
    params = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES.values()]
    fp32 = torch.optim.AdamW(params)
    for p in params:
        p.grad = torch.ones_like(p)
    fp32.step()
    bytes32 = topt.opt_state_bytes(fp32.state_dict())
    bytes8 = topt.opt_state_bytes(topt.adamw8bit(params))
    big = sum(int(np.prod(s)) for k, s in SHAPES.items() if k != "lora_small")
    assert bytes8 < 0.3 * bytes32 and bytes8 >= 2 * big


@pytest.mark.parametrize("use_8bit", [True, "packed"], ids=["per_tensor", "packed"])
def test_masked_8bit_optimizer_matches_jax(use_8bit, tmp_path):
    """``make_optimizer(use_8bit=...)``: the clip, the 8-bit AdamW, a frozen leaf left
    bit-identical, and a resume from the state dict continuing the same trajectory."""
    init = {**_tensors(4), "frozen": np.ones((3, 3), np.float32)}
    grads = [{**_tensors(10 + i, 3.0), "frozen": np.ones((3, 3), np.float32)}
             for i in range(3)]
    trainable = lambda name: name.startswith("lora_")  # noqa: E731
    tx = jts.make_optimizer(1e-2, trainable_predicate=trainable, use_8bit=use_8bit)
    params_j = {k: jnp.asarray(v) for k, v in init.items()}
    state_j = tx.init(params_j)
    for g in grads:
        updates, state_j = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state_j,
                                     params_j)
        params_j = optax.apply_updates(params_j, updates)

    def module():
        m = torch.nn.Module()
        for k, v in init.items():
            m.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
        return m

    def run(m, opt, steps):
        for g in steps:
            for k, p in opt.params.items():
                p.grad = torch.from_numpy(g[k].copy())
            opt.step()

    m = module()
    opt = tts.make_optimizer(1e-2, trainable_predicate=trainable, use_8bit=use_8bit)
    opt.init(m)
    run(m, opt, grads[:2])
    torch.save({"opt": opt.state_dict(), "params": m.state_dict()}, tmp_path / "ckpt.pt")
    run(m, opt, grads[2:])
    for k in init:
        np.testing.assert_allclose(getattr(m, k).detach().numpy(), np.asarray(params_j[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert torch.equal(m.frozen, torch.ones(3, 3))

    blob = torch.load(tmp_path / "ckpt.pt", weights_only=True)
    resumed = module()
    resumed.load_state_dict(blob["params"])
    opt2 = tts.make_optimizer(1e-2, trainable_predicate=trainable, use_8bit=use_8bit)
    opt2.init(resumed)
    opt2.load_state_dict(blob["opt"])
    assert int(opt2.adamw.state.count) == 2
    run(resumed, opt2, grads[2:])
    for k, p in resumed.named_parameters():
        assert torch.equal(p, getattr(m, k)), k
