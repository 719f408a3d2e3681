"""The port's T5 v1.1 encoder (``lkgd_torch.models.t5_text``) against
``lkgd_tpu.models.t5_text`` at fp32 on the CPU, and ``cli/embed_text.py``:

* ``relative_position_buckets`` equal to JAX's, bucket for bucket, short and long range
  (past ``max_distance``), square and not;
* the tiny encoder on explicit token ids with a padding mask, every parameter random (JAX
  params through ``t5_state_dict``, loaded strictly), rtol 1e-4 / atol 2e-4; the port's
  state dict read back by the JAX package's ``port_t5_encoder`` gives the same params (the
  names are transformers' ``T5EncoderModel`` names), and a ``T5EncoderModel`` state dict
  loads strictly and gives its outputs;
* ``embed_text --tiny`` writing a ``.npy`` and a directory (shapes and finite values: its
  hash tokenizer is salted per process), ``--t5`` refused."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import t5_text as jt5  # noqa: E402

from lkgd_torch.cli import embed_text  # noqa: E402
from lkgd_torch.models import configs as tcfg  # noqa: E402
from lkgd_torch.models import t5_text as tt5  # noqa: E402
from lkgd_torch.utils.porting import t5_state_dict  # noqa: E402

from tests.test_torch_porting import flatten, randomize  # noqa: E402

TOL = dict(rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("q_len,k_len", [(8, 8), (300, 300), (17, 600)])
def test_relative_position_buckets_match_jax(q_len, k_len):
    for buckets, distance in ((32, 128), (8, 20)):
        want = np.asarray(jt5.relative_position_buckets(q_len, k_len, buckets, distance))
        got = tt5.relative_position_buckets(q_len, k_len, buckets, distance).numpy()
        np.testing.assert_array_equal(got, want)
        if k_len > distance:  # keys past max_distance share the last bucket
            assert want.max() == buckets - 1


@pytest.fixture(scope="module")
def tiny_jax():
    cfg = jt5.T5Config.tiny()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    mask = np.ones((2, 17), np.int32)
    mask[1, 9:] = 0
    model = jt5.T5Encoder(cfg)
    params = randomize(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(ids),
                                      jnp.asarray(mask)), seed=3, scale=0.3)
    want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(ids), jnp.asarray(mask)))
    return dict(cfg=cfg, ids=ids, mask=mask, params=params, want=want)


def _port(state_dict) -> tt5.T5Encoder:
    model = tt5.build_t5_encoder(tcfg.T5Config.tiny(), torch.float32, "cpu")
    model.load_state_dict(state_dict, strict=True)
    return model


def test_tiny_encoder_matches_jax_with_padding(tiny_jax):
    model = _port(t5_state_dict(flatten(tiny_jax["params"])))
    with torch.no_grad():
        got = model(torch.from_numpy(tiny_jax["ids"]).long(),
                    torch.from_numpy(tiny_jax["mask"])).numpy()
    assert got.shape == (2, 17, 32)
    np.testing.assert_allclose(got, tiny_jax["want"], **TOL)
    # padding moves the padded row's real tokens: the mask reaches the softmax
    with torch.no_grad():
        unmasked = model(torch.from_numpy(tiny_jax["ids"]).long()).numpy()
    assert np.abs(unmasked[1, :9] - got[1, :9]).max() > 1e-3
    np.testing.assert_allclose(unmasked[0], got[0], **TOL)


def test_names_are_the_ones_port_t5_encoder_reads(tiny_jax):
    """The port's state dict (transformers' names) through the JAX package's own reader
    gives back the JAX params, leaf for leaf."""
    model = _port(t5_state_dict(flatten(tiny_jax["params"])))
    assert model.encoder.embed_tokens is model.shared
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert "shared.weight" in sd and "encoder.embed_tokens.weight" in sd
    back = flatten(jt5.port_t5_encoder(sd, tiny_jax["cfg"]))
    want = flatten(tiny_jax["params"])
    assert sorted(back) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_transformers_state_dict_loads_strictly():
    transformers = pytest.importorskip("transformers")
    cfg = tcfg.T5Config.tiny()
    hf = transformers.T5EncoderModel(transformers.T5Config(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model, d_kv=cfg.d_kv, d_ff=cfg.d_ff,
        num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        relative_attention_num_buckets=cfg.relative_attention_num_buckets,
        relative_attention_max_distance=cfg.relative_attention_max_distance,
        feed_forward_proj="gated-gelu", dropout_rate=0.0)).eval()
    model = _port(hf.state_dict())
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 11)))
    mask = torch.ones(2, 11, dtype=torch.long)
    mask[0, 6:] = 0
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask).last_hidden_state.numpy()
        got = model(ids, mask).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_random_encoder_is_seeded_and_finite():
    outs = []
    for _ in range(2):
        model = tt5.build_t5_encoder(tcfg.T5Config.tiny(), torch.float32, "cpu",
                                     torch.Generator().manual_seed(4))
        assert not any(p.requires_grad for p in model.parameters())
        with torch.no_grad():
            outs.append(model(torch.arange(16).view(2, 8)))
    assert torch.equal(outs[0], outs[1]) and torch.isfinite(outs[0]).all()


def test_embed_text_tiny_writes_npy_and_directory(tmp_path, capsys):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a girl riding a horse\n\nwaves over rocks at dusk\n")
    out = tmp_path / "emb.npy"
    embed_text.main(["--tiny", "--device", "cpu", "--prompt", "smoke rising",
                     "--prompts-file", str(prompts), "--output", str(out)])
    emb = np.load(out)
    assert emb.shape == (3, 8, 32) and emb.dtype == np.float32 and np.isfinite(emb).all()
    embed_text.main(["--tiny", "--device", "cpu", "--prompt", "one", "--prompt", "two words",
                     "--max-length", "4", "--output", str(tmp_path / "dir")])
    files = sorted(p.name for p in (tmp_path / "dir").iterdir())
    assert files == ["prompt_0000.npy", "prompt_0001.npy"]
    for name in files:
        e = np.load(tmp_path / "dir" / name)
        assert e.shape == (1, 4, 32) and np.isfinite(e).all()
    assert "wrote" in capsys.readouterr().out
    ids, mask = embed_text.hash_tokens(["a b c", "x"], 128, 2)
    assert ids.shape == mask.shape == (2, 2) and mask.tolist() == [[1, 1], [1, 0]]
    assert ids[1, 1] == 0 and ids.max() < 128


@pytest.mark.parametrize("argv,message", [
    (["--t5", "ckpt", "--prompt", "x"], "ROADMAP.md Queue 1, item 11"),
    (["--prompt", "x"], "--t5"),
    (["--tiny"], "no prompts")], ids=["t5", "no_tiny", "no_prompt"])
def test_embed_text_refusals(argv, message, tmp_path, capsys):
    with pytest.raises(SystemExit):
        embed_text.main(argv + ["--output", str(tmp_path / "e.npy"), "--device", "cpu"])
    assert message in capsys.readouterr().err
