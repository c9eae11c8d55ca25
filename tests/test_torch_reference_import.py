"""Reading reference checkpoints: `utils/bridge.py` `load_reference_checkpoint`,
`load_reference_meta`, `univnet_disc_params_from_reference_sd`, and
`bin/import_ckpt.py`, against the JAX package's
`audiodec_tpu/utils/torch_import.py` and `tools/import_ckpt.py`.

The `.pkl` files are written here with `torch.save` from the goldens'
reference state dicts (`sd__*` keys): gen_small (an autoencoder) and
voc_mrf (a vocoder with weight norm), in the reference trainer's layout
and bare.  Arrays compare bit for bit; the imported params exactly (both
packages fold weight norm in float64 and round once).
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax

from audiodec_tpu.models import discriminators as JD
from audiodec_tpu.train import checkpoint as jax_ckpt
from audiodec_tpu.utils import torch_import
from audiodec_tpu_torch.bin import import_ckpt
from audiodec_tpu_torch.models import discriminators as D
from audiodec_tpu_torch.utils import bridge
from audiodec_tpu_torch.utils.checkpoint import load_only_params
from audiodec_tpu_torch.utils.config import dump_yaml

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
CONFIGS = {
    "gen_small": {"model_type": "symAudioDec", "generator_params": dict(
        encode_channels=4, decode_channels=4, code_dim=16, codebook_num=4,
        codebook_size=32)},
    "voc_mrf": {"model_type": "HiFiGAN", "generator_params": dict(
        in_channels=16, channels=32, upsample_scales=[5, 5, 4, 3],
        upsample_kernel_sizes=[10, 10, 8, 6])},
}
META = {"steps": 1234, "epochs": 7}


def _sd(name):
    data = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    return {k[len("sd__"):]: data[k] for k in data.files
            if k.startswith("sd__")}


def _save(path, sd, layout):
    tensors = {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
    if layout == "trainer":
        obj = {"model": {"generator": tensors, "discriminator": {}},
               "optimizer": {}, **META}
    else:
        obj = tensors
    torch.save(obj, path)
    return path


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), np.asarray(tree)


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("layout", ["trainer", "bare"])
@pytest.mark.parametrize("name", ["gen_small", "voc_mrf"])
def test_loaders_match_jax(tmp_path, name, layout):
    sd = _sd(name)
    path = str(_save(tmp_path / f"{name}.pkl", sd, layout))
    got = bridge.load_reference_checkpoint(path)
    want = torch_import.load_torch_checkpoint(path)
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in sd:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], sd[k])
    meta = bridge.load_reference_meta(path)
    assert meta == torch_import.load_torch_meta(path)
    assert meta == (META if layout == "trainer" else {})


def test_univnet_discriminator_import_matches_jax():
    """The combined UnivNet discriminator: the MRSD of disc_univnet under
    `mrsd.`, the weight-normed MPD of disc_hifigan under `mpd.`."""
    mrsd = {f"mrsd.{k}": v for k, v in _sd("disc_univnet").items()}
    mpd = {k: v for k, v in _sd("disc_hifigan").items()
           if k.startswith("mpd.")}
    assert any(k.endswith("weight_g") for k in mpd)
    sd = {**mrsd, **mpd}
    cfg = D.UnivNetDiscriminatorConfig(
        mrsd=D.MultiResolutionSpectralConfig(
            discriminator=D.SpectralDiscriminatorConfig(channels=16)),
        mpd=D.MultiPeriodConfig(discriminator=D.PeriodDiscriminatorConfig(
            channels=8, max_downsample_channels=64)))
    jcfg = JD.UnivNetDiscriminatorConfig(
        mrsd=JD.MultiResolutionSpectralConfig(
            discriminator=JD.SpectralDiscriminatorConfig(channels=16)),
        mpd=JD.MultiPeriodConfig(discriminator=JD.PeriodDiscriminatorConfig(
            channels=8, max_downsample_channels=64)))
    ours = bridge.univnet_disc_params_from_reference_sd(sd, cfg)
    want = jax.tree_util.tree_map(
        np.asarray, torch_import.import_univnet_discriminator(sd, jcfg))
    _assert_trees_equal(bridge.disc_params_to_jax(ours), want)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_import_ckpt", os.path.join(ROOT, "tools", "import_ckpt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["gen_small", "voc_mrf"])
def test_import_ckpt_matches_the_jax_tool(tmp_path, monkeypatch, name):
    """The port's converter against tools/import_ckpt.py on the same .pkl
    and config: the same params (read back by JAX's load_checkpoint and
    by the port's load_only_params), the same header, the same
    config.yml beside each."""
    pkl = str(_save(tmp_path / "checkpoint-1234steps.pkl", _sd(name),
                    "trainer"))
    cfg_path = tmp_path / "ref.yml"
    cfg_path.write_text(dump_yaml(CONFIGS[name]))
    ours = str(tmp_path / "port" / "checkpoint-1234steps.ckpt")
    theirs = str(tmp_path / "jax" / "checkpoint-1234steps.ckpt")
    assert import_ckpt.main(["--torch", pkl, "--config", str(cfg_path),
                             "--out", ours]) == ours
    monkeypatch.setattr(sys, "argv", ["import_ckpt.py", "--torch", pkl,
                                      "--config", str(cfg_path),
                                      "--out", theirs])
    _jax_tool().main()

    got_state, got_header = jax_ckpt.load_checkpoint(ours)
    want_state, want_header = jax_ckpt.load_checkpoint(theirs)
    assert got_header == want_header == {
        "steps": 1234, "imported_from": "checkpoint-1234steps.pkl",
        "epochs": 7}
    _assert_trees_equal(got_state, want_state)
    params, header = load_only_params(ours)
    assert header == want_header
    _assert_trees_equal(params, load_only_params(theirs)[0])
    for d in ("port", "jax"):
        assert ((tmp_path / d / "config.yml").read_text()
                == cfg_path.read_text())
