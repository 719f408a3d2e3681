"""The port's checkpoint manifests: its full-width modules, built on the meta device, have
exactly the checked-in keys and shapes (1428, 374, 520, 1022 and 124 keys); its JSON copies are
the JAX package's byte for byte; a state dict of exactly those keys loads strictly into
each module; the parameter totals are the published models'."""

import filecmp
import os

import pytest
import torch

from lkgd_torch.utils import checkpoint_manifest as cm

# keys and parameters of each checkpoint (SVD-xt's unet, vae and image encoder;
# CogVideoX-5B-I2V's transformer without knowledge fusion; torchvision's raft_large)
SIZES = {"svd_xt_unet": (1428, 1524623082), "svd_vae": (374, 97742847),
         "clip_vit_h": (520, 632076800), "cogvideox_5b_transformer": (1022, 5570473536),
         "raft_large": (124, 5257536)}
JAX_DIR = os.path.join(os.path.dirname(__file__), "..", "lkgd_tpu", "utils", "manifests")


@pytest.fixture(scope="module")
def generated():
    return {name: gen() for name, gen in cm.GENERATORS.items()}


@pytest.mark.parametrize("name", sorted(SIZES))
def test_port_module_matches_checked_in(generated, name):
    m = cm.load_manifest(name)
    assert generated[name] == m, "architecture drift: compare the port's module names"
    assert (len(m), cm.param_total(m)) == SIZES[name]


@pytest.mark.parametrize("name", sorted(SIZES))
def test_port_copy_is_the_jax_file(name):
    assert filecmp.cmp(os.path.join(cm.MANIFEST_DIR, name + ".json"),
                       os.path.join(JAX_DIR, name + ".json"), shallow=False)


def test_synthetic_state_dicts_load_strictly():
    from lkgd_torch.models.clip_vision import CLIPVisionModelWithProjection
    from lkgd_torch.models.cogvideox import CogVideoXTransformer3D
    from lkgd_torch.models.configs import (CLIPVisionConfig, CogVideoXConfig, SVDUNetConfig,
                                           TemporalVAEConfig)
    from lkgd_torch.models.raft import RAFT, RAFTConfig
    from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition
    from lkgd_torch.models.vae_temporal import AutoencoderKLTemporalDecoder

    factories = {
        "svd_xt_unet": lambda: UNetSpatioTemporalCondition(SVDUNetConfig(num_frames=14)),
        "svd_vae": lambda: AutoencoderKLTemporalDecoder(TemporalVAEConfig()),
        "clip_vit_h": lambda: CLIPVisionModelWithProjection(CLIPVisionConfig()),
        "cogvideox_5b_transformer": lambda: CogVideoXTransformer3D(
            CogVideoXConfig.cogvideox_5b_i2v(knowledge_fusion=False)),
        "raft_large": lambda: RAFT(RAFTConfig.large()),
    }
    for name, factory in factories.items():
        with torch.device("meta"):
            module = factory()
        sd = cm.synthetic_state_dict(cm.load_manifest(name))
        result = module.load_state_dict(sd, strict=True, assign=True)
        assert not result.missing_keys and not result.unexpected_keys
        # no memory behind it: one zero seen through every shape
        assert all(p.device.type == "cpu" and p.untyped_storage().nbytes() == 4
                   for p in module.state_dict().values())
        missing = dict(list(sd.items())[1:])
        with pytest.raises(RuntimeError, match="Missing key"):
            module.load_state_dict(missing, strict=True, assign=True)


def test_main_check_and_write(tmp_path, monkeypatch, capsys):
    cm.main(["--check"])
    assert capsys.readouterr().out.count(": OK") == 5
    monkeypatch.setattr(cm, "MANIFEST_DIR", str(tmp_path))
    cm.main(["--write"])
    for name in SIZES:
        assert filecmp.cmp(tmp_path / f"{name}.json", os.path.join(JAX_DIR, name + ".json"),
                           shallow=False)
