"""The plain reference against the reference implementation's goldens, and
against the port at CPU-test widths on the benchmark's seeded weights."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import weights as W
from benchmark.harness.context import load_json
from benchmark.reference import codec as R
from benchmark.reference import layout as L
from conftest import DATA, ROOT

GOLDEN = ROOT / "tests" / "golden"
SYMAD = load_json(ROOT / "benchmark" / "configs"
                  / "symAD_vctk_48000_hop300.json")


def _golden(name):
    path = GOLDEN / f"{name}.npz"
    if not path.exists():
        pytest.skip(f"{path} is not in this checkout")
    d = np.load(path)
    sd = {k[4:]: torch.from_numpy(np.asarray(d[k], np.float32))
          for k in d.files if k.startswith("sd__")
          and "pad_buffer" not in k}
    return d, sd


def test_symad_against_golden():
    d, sd = _golden("gen_symad")
    gp, df = SYMAD["generator_params"], SYMAD["code_defaults"]
    rows = {r.key for r in L.symad_layout(gp, df)}
    assert rows == set(sd), "the layout names the golden's keys"
    z = R.encode(torch.from_numpy(d["x"]), sd, gp, df)
    np.testing.assert_allclose(z.numpy(), d["z"], atol=1e-6)
    embed = R.codebooks(sd, gp)
    idx = R.rvq_encode(z, embed)
    flat = idx[0].T.numpy() + 1024 * np.arange(8)[:, None]
    np.testing.assert_array_equal(flat, d["idx_stream"])
    np.testing.assert_allclose(R.rvq_decode(idx, embed).numpy(), d["zq"],
                               atol=1e-5)
    y = R.decode(torch.from_numpy(d["zq"]), sd, gp, df)
    np.testing.assert_allclose(y.numpy(), d["y"], atol=1e-6)


def test_vocoder_against_golden():
    d, sd = _golden("voc_v1_small_trained")
    vp = dict(load_json(ROOT / "benchmark" / "configs" /
                        "AudioDec_v1_symAD_vctk_48000_hop300.json")
              ["generator_params"], channels=128)
    rows = {r.key for r in L.vocoder_layout(vp)}
    assert rows == set(sd), "the layout names the golden's keys"
    y = R.vocode(torch.from_numpy(d["zq"]), R.fold_weight_norm(sd), vp)
    np.testing.assert_allclose(y.numpy(), d["y"], atol=1e-6)


@pytest.fixture(scope="module")
def tiny_models():
    """The seeded tiny state dicts, the port's params from them through its
    import path, and both configurations."""
    from audiodec_tpu_torch.utils import bridge
    from audiodec_tpu_torch.utils.config import generator_config
    sym = load_json(DATA / "tiny_symad.json")
    voc = load_json(DATA / "tiny_ad_v1.json")
    gp, df = sym["generator_params"], sym["code_defaults"]
    sd = W.state_dict(L.symad_layout(gp, df), sym["init"], 5, "symad", "cpu")
    vsd = W.state_dict(L.vocoder_layout(voc["generator_params"]),
                       voc["init"], 5, "vocoder", "cpu")
    cfg, vcfg = generator_config(sym), generator_config(voc)
    params = bridge.params_from_reference_sd(W.to_numpy(sd), cfg)
    params["vocoder"] = bridge.vocoder_params_from_reference_sd(
        W.to_numpy(vsd), vcfg)
    return sym, voc, sd, vsd, cfg, vcfg, params


def test_reference_against_port(tiny_models):
    from audiodec_tpu_torch.models.autoencoder import (
        decoder_apply, encoder_apply, projector_apply)
    from audiodec_tpu_torch.models.vocoder import vocoder_apply
    from audiodec_tpu_torch.ops.vq import rvq_forward_index, rvq_lookup
    sym, voc, sd, vsd, cfg, vcfg, params = tiny_models
    gp, df = sym["generator_params"], sym["code_defaults"]
    x = W.audio(5, "x", (2, 1, 4800), 0.3, "cpu")
    z_ref = R.encode(x, sd, gp, df)
    h = encoder_apply(params["encoder"], x.transpose(1, 2), cfg)
    z = projector_apply(params["projector"], h, cfg)
    torch.testing.assert_close(z.transpose(1, 2), z_ref, rtol=1e-5,
                               atol=1e-6)
    embed = R.codebooks(sd, gp)
    idx_ref = R.rvq_encode(z_ref, embed)
    _, idx = rvq_forward_index(z_ref.transpose(1, 2), params["quantizer"])
    assert torch.equal(idx.long(), idx_ref)
    zq = rvq_lookup(idx, params["quantizer"])
    torch.testing.assert_close(zq.transpose(1, 2),
                               R.rvq_decode(idx_ref, embed))
    torch.testing.assert_close(
        decoder_apply(params["decoder"], zq, cfg).transpose(1, 2),
        R.decode(zq.transpose(1, 2), sd, gp, df), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        vocoder_apply(params["vocoder"], zq, vcfg).transpose(1, 2),
        R.vocode(zq.transpose(1, 2), R.fold_weight_norm(vsd),
                 voc["generator_params"]), rtol=1e-5, atol=1e-6)
