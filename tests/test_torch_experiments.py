"""The port's two microbenchmark kernels on the CPU: the plain versions of
``lkgd_torch.ops.matmul.blocked_matmul`` and ``lkgd_torch.ops.flash_variants.flash_variant``
against the Pallas kernels of ``experiments/matmul_microbench.py`` (``pallas_matmul``) and
``experiments/flash_variant_microbench.py`` (``run_variant``, all five modes) in interpret
mode, on the same bf16 inputs made from a numpy seed, and the two entry points at tiny
sizes.

Tolerances: outputs are bf16, so differences are stated relative to max |ref|: 1e-2 (a
bf16 ulp is 2^-8 = 3.9e-3 of the value; both sides round the product or the output once,
and the variants round the probabilities as well). ``bf16exp`` takes exp2 in bf16 on both
sides but XLA's and PyTorch's bf16 exp2 may round differently by an ulp per probability:
2e-2. ``noexp`` is arithmetic (no softmax, only unsafe as one) and is compared too."""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from lkgd_torch.experiments import flash_variant_microbench, matmul_microbench  # noqa: E402
from lkgd_torch.ops import flash_variants as fv  # noqa: E402
from lkgd_torch.ops import matmul as mm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_experiments(tmp_path_factory):
    """The JAX experiment files as modules. Importing them turns the persistent compile
    cache on: point it at a temporary directory first."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LKGD_JAX_CACHE", str(tmp_path_factory.mktemp("jax_cache")))
    mp.syspath_prepend(str(ROOT))
    try:
        yield (importlib.import_module("experiments.matmul_microbench"),
               importlib.import_module("experiments.flash_variant_microbench"))
    finally:
        mp.undo()
        for name in ("experiments.matmul_microbench", "experiments.flash_variant_microbench"):
            sys.modules.pop(name, None)


def _bf16(rng, shape, scale=1.0):
    """bf16-representable float32 values, and the same as a torch bf16 tensor."""
    x = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).bfloat16()
    return x, jnp.asarray(x.float().numpy(), jnp.bfloat16)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want.astype(jnp.float32))
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("m,k,n,bm", [(256, 64, 128, 128), (384, 320, 64, 128)])
def test_blocked_matmul_plain_matches_pallas_matmul(jax_experiments, m, k, n, bm):
    rng = np.random.default_rng(0)
    (x, jx), (w, jw) = _bf16(rng, (m, k)), _bf16(rng, (k, n))
    with pltpu.force_tpu_interpret_mode():
        want = jax_experiments[0].pallas_matmul(jx, jw, bm)
    got = mm.blocked_matmul_plain(x, w)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert _rel(got, want) <= 1e-2
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(mm.blocked_matmul(x, w), got)


@pytest.mark.parametrize("mode,tol", [("base", 1e-2), ("prescale", 1e-2), ("bf16exp", 2e-2),
                                      ("prescale_bf16exp", 2e-2), ("noexp", 1e-2)])
def test_flash_variant_plain_matches_run_variant(jax_experiments, mode, tol):
    rng = np.random.default_rng(1)
    (q, jq), (k, jk), (v, jv) = (_bf16(rng, (2, 256, 64)) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = jax_experiments[1].run_variant(jq, jk, jv, 128, 128, mode)
    t = fv.bound_t(q, k)
    got = fv.flash_variant_plain(q, k, v, t, mode)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 256, 64)
    assert _rel(got, want) <= tol, (mode, _rel(got, want))
    assert torch.equal(fv.flash_variant(q, k, v, t, mode, (128, 64)), got)


def test_variant_bound_matches_jax_bound(jax_experiments):
    """t, the kernel's input, is the production bound: equal to JAX's ``_bound_t``."""
    rng = np.random.default_rng(2)
    (q, jq), (k, jk) = _bf16(rng, (2, 128, 64), 3.0), _bf16(rng, (2, 128, 64), 3.0)
    want = np.asarray(jax_experiments[1]._bound_t(jq, jk, 64 ** -0.5))
    got = fv.bound_t(q, k).numpy()
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=1e-5, atol=1e-5)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match=r"\(M, K\) x \(K, N\)"):
        mm.blocked_matmul(x, torch.zeros(4, 8))
    q = torch.zeros(1, 8, 8)
    with pytest.raises(ValueError, match="unknown mode"):
        fv.flash_variant(q, q, q, torch.zeros(1, 8), "exp3")
    with pytest.raises(ValueError, match="tile"):
        fv.flash_variant(q, q, q, torch.zeros(1, 8), "base", (1024, 1024))


def test_matmul_microbench_main_tiny_on_cpu(capsys):
    rows = matmul_microbench.main(["--device", "cpu", "--m", "256", "--k", "64", "--n", "128",
                                   "64", "--reps", "1"])
    out = capsys.readouterr().out
    assert [r["shape"] for r in rows] == [(256, 64, 128), (256, 64, 64)]
    assert all(r["ok"] for r in rows)
    for word in ("qkv separate", "qkv wide+split", "qkv middle-axis", "library x @ w",
                 "blocked_matmul", "OK"):
        assert word in out, word
    assert "WRONG" not in out


def test_flash_variant_microbench_main_tiny_on_cpu(capsys):
    rows = flash_variant_microbench.main(["--device", "cpu", "--bh", "2", "--s", "128", "--d",
                                          "32", "--tiles", "64x64", "128x128", "--reps", "1"])
    out = capsys.readouterr().out
    assert len(rows) == 5 * 2 and "wrapper" in out
    by_mode = {r["mode"]: r["max_abs_diff"] for r in rows}
    assert by_mode["base"] == 0.0 and np.isnan(by_mode["noexp"])
    assert 0.0 < by_mode["bf16exp"] < 0.05 and by_mode["prescale"] < 0.05


def test_traced_takes_an_empty_trace_again(monkeypatch):
    """``experiments._timing.traced``: a trace in which the tracer recorded no device
    operation is taken again after a pause that doubles each time, up to eight tries, and
    then it raises; a trace with one is returned with the function's result."""
    from types import SimpleNamespace

    import torch.profiler
    from torch.autograd import DeviceType

    from lkgd_torch.experiments import _timing

    recorded = []  # what each successive trace records

    class FakeProfile:
        def __init__(self, activities):
            self.events = recorded.pop(0)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self.events

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    pauses = []
    monkeypatch.setattr(_timing.time, "sleep", pauses.append)
    device_event = SimpleNamespace(device_type=DeviceType.CUDA)
    host_event = SimpleNamespace(device_type=DeviceType.CPU)
    calls = []
    monkeypatch.setattr(_timing, "trace_counts", {"traces": 0, "empty": 0})
    recorded[:] = [[], [host_event], [host_event, device_event]]
    prof, out = _timing.traced(lambda: calls.append(1) or len(calls))
    assert out == 3 and prof.events[-1] is device_event and not recorded
    assert pauses == [0.05, 0.1] and _timing.trace_counts == {"traces": 3, "empty": 2}
    recorded[:] = [[]] * 8
    pauses.clear()
    with pytest.raises(RuntimeError, match="no device operation in 8 traces"):
        _timing.traced(lambda: calls.append(1))
    assert len(calls) == 11 and not recorded
    assert pauses == [0.05 * 2**k for k in range(7)]
    assert _timing.trace_counts == {"traces": 11, "empty": 10}


def test_profiled_takes_a_trace_that_lost_calls_again(monkeypatch):
    """``experiments.group_norm_ab.profiled`` (the smoke's device times by kernel and its
    GroupNorm one-operation check): every call enqueues the same operations, so a trace in
    which an operation's count is not a multiple of the calls made is taken again and
    counted in ``_timing.trace_counts["lost"]``; after four such traces it raises. A whole
    trace gives device ms and operations a call."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from lkgd_torch.experiments import _timing, group_norm_ab

    def event(key, count):
        return SimpleNamespace(device_type=DeviceType.CUDA, key=key, count=count,
                               self_device_time_total=250.0 * count)

    host = SimpleNamespace(device_type=DeviceType.CPU, key="cudaLaunchKernel", count=7,
                           self_device_time_total=0.0)
    traces = [[event("stats", 9), event("apply", 10), host],
              [event("stats", 10), event("apply", 10), host]]

    def traced(run):
        events = traces.pop(0)
        return SimpleNamespace(key_averages=lambda: events), run()

    monkeypatch.setattr(_timing, "traced", traced)
    monkeypatch.setattr(_timing, "trace_counts", {"traces": 0, "empty": 0, "lost": 0})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    calls = []
    out = group_norm_ab.profiled(lambda: calls.append(1), calls=10)
    assert out == {"ms": {"stats": 0.25, "apply": 0.25}, "ops": 2.0}
    assert len(calls) == 21 and not traces and _timing.trace_counts["lost"] == 1
    traces[:] = [[event("stats", 19)]] * 4
    with pytest.raises(RuntimeError, match="lost operations in 4 traces"):
        group_norm_ab.profiled(lambda: None, calls=10)
    assert not traces and _timing.trace_counts["lost"] == 5
