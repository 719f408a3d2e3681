"""The port's tensor cache (``lkgd_torch.data.tensor_cache``) against the JAX package's
(``lkgd_tpu.data.tensor_cache``): the same file format through the one shared source
``native/tensor_cache.cc``, so a cache written by either reads back, byte for byte, in the
other, in every dtype (bfloat16 through ml_dtypes on the JAX side, a 16-bit view into
``torch.bfloat16`` on the port's); keys, a later record of a key winning, reopening, the
dataset views of both packages, and the port's library built under ``lkgd_torch/_build/``
and nowhere in ``native/``."""

import numpy as np
import pytest

ml_dtypes = pytest.importorskip("ml_dtypes")
import torch  # noqa: E402

from lkgd_tpu.data import tensor_cache as jtc  # noqa: E402

from lkgd_torch.data import tensor_cache as ttc  # noqa: E402

ARRAYS = {
    "clip0/latents": np.random.default_rng(0).normal(size=(3, 4, 4, 4)).astype(np.float32),
    "clip0/prompt_embeds": np.random.default_rng(1).normal(size=(8, 16)).astype(np.float16),
    "clip0/image_latents": np.random.default_rng(2).normal(size=(4, 4, 4)).astype(
        ml_dtypes.bfloat16),
    "clip1/latents": np.arange(24, dtype=np.int32).reshape(2, 3, 4),
    "clip1/ids": np.arange(-3, 5, dtype=np.int64),
    "clip1/mask": np.array([[0, 1, 255]], np.uint8),
}


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _port_dtype(x: np.ndarray) -> torch.dtype:
    return torch.bfloat16 if x.dtype == ml_dtypes.bfloat16 else torch.from_numpy(x).dtype


def test_jax_written_cache_reads_back_in_the_port(tmp_path):
    path = str(tmp_path / "jax.lkgd")
    cache = jtc.TensorCache(path)
    for key, x in ARRAYS.items():
        cache.put(key, x)
    cache.put("clip1/latents", ARRAYS["clip1/latents"] + 7)  # a later record wins
    cache.close()
    ours = ttc.TensorCache(path)
    assert ours.keys() == list(ARRAYS) and len(ours) == len(ARRAYS)
    assert "clip0/latents" in ours and "clip2/latents" not in ours
    for key, x in ARRAYS.items():
        got = ours.get(key)
        want = x + 7 if key == "clip1/latents" else x
        assert isinstance(got, torch.Tensor) and got.dtype == _port_dtype(x), key
        assert tuple(got.shape) == x.shape and _bytes(got) == _bytes(want), key
    with pytest.raises(KeyError):
        ours.get("clip2/latents")
    ours.close()


def test_port_written_cache_reads_back_in_jax(tmp_path):
    path = str(tmp_path / "port.lkgd")
    cache = ttc.TensorCache(path)
    tensors = {key: (torch.from_numpy(x.astype(np.float32)).bfloat16()
                     if x.dtype == ml_dtypes.bfloat16 else torch.from_numpy(x))
               for key, x in ARRAYS.items()}
    for key, x in tensors.items():
        cache.put(key, x)
    cache.put("clip1/extra", ARRAYS["clip1/ids"])  # numpy arrays go in as they are
    cache.close()
    theirs = jtc.TensorCache(path)
    assert theirs.keys() == list(ARRAYS) + ["clip1/extra"]
    for key, x in tensors.items():
        got = theirs.get(key)
        assert got.dtype == ARRAYS[key].dtype and got.shape == tuple(x.shape), key
        assert _bytes(got) == _bytes(x), key
    np.testing.assert_array_equal(theirs.get("clip1/extra"), ARRAYS["clip1/ids"])
    theirs.close()
    with pytest.raises(TypeError):
        ttc.TensorCache(str(tmp_path / "other.lkgd")).put("x", torch.zeros(2, dtype=torch.int8))


def test_reopen_and_dataset_views_agree(tmp_path):
    """A cache grown by both packages over reopenings; the two datasets see the same
    samples and fields."""
    path = str(tmp_path / "both.lkgd")
    ours = ttc.TensorCache(path)
    ours.put("b/latents", torch.ones(2, 3))
    ours.put("b/prompt_embeds", torch.zeros(4, 5).bfloat16())
    ours.close()
    theirs = jtc.TensorCache(path)
    theirs.put("a/latents", ARRAYS["clip0/latents"])
    theirs.put("a/cond_latents", ARRAYS["clip0/image_latents"])
    theirs.put("c/prompt_embeds", ARRAYS["clip0/prompt_embeds"])  # no latents: no sample
    theirs.close()
    ds_ours, ds_theirs = ttc.PrecomputedLatentDataset(path), jtc.PrecomputedLatentDataset(path)
    assert ds_ours.samples == ds_theirs.samples == ["a", "b"]
    for i in range(2):
        got, want = ds_ours[i], ds_theirs[i]
        assert sorted(got) == sorted(want)
        for key in want:
            assert _bytes(got[key]) == _bytes(want[key]), (i, key)


def test_library_is_built_under_the_port(tmp_path, monkeypatch):
    """The port's copy of the library lives in ``lkgd_torch/_build/`` and is rebuilt when
    missing; ``native/`` holds only the source as far as the port is concerned."""
    assert ttc.LIBRARY.parent.name == "_build" and ttc.LIBRARY.parent.parent.name == "lkgd_torch"
    assert ttc.SOURCE.name == "tensor_cache.cc" and ttc.SOURCE.parent.name == "native"
    library = tmp_path / "_build" / "libtensor_cache.so"
    monkeypatch.setattr(ttc, "LIBRARY", library)
    monkeypatch.setattr(ttc, "_lib", None)
    lib = ttc.library()
    assert library.exists() and lib.lkgd_cache_count(None) == 0
    assert sorted(p.name for p in library.parent.iterdir()) == ["libtensor_cache.so"]
