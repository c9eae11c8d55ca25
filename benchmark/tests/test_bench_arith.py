"""The frozen FLOP and bound arithmetic against numbers worked out by hand
and against the port's own counts."""

from __future__ import annotations

import json

import pytest

from benchmark.arith import bounds, flops
from conftest import ROOT

CFG = ROOT / "benchmark" / "configs"
SYM = json.loads((CFG / "symAD_vctk_48000_hop300.json").read_text())
VOC = json.loads((CFG / "AudioDec_v1_symAD_vctk_48000_hop300.json")
                 .read_text())
GP, DF, VP = SYM["generator_params"], SYM["code_defaults"], \
    VOC["generator_params"]
T, B = 480000, 16
N = T // 300


def test_symad_batch_flops():
    # 4.2196 TFLOP a batch of 16 x 10 s (the port's count)
    enc = sum(flops.encoder_flops(GP, DF, T).values())
    total = (enc + flops.projector_flops(GP, N) + flops.rvq_flops(GP, N)
             + flops.decoder_flops(GP, DF, N))
    assert B * total == 4_219_640_217_600
    # one stack: 3 units x (7 + 1) taps x C^2 x 2 FLOP x T
    assert flops.encoder_flops(GP, DF, T)["stack0"] == 3 * 8 * 32 ** 2 * 2 * T
    assert flops.rvq_flops(GP, N) == 8 * 2 * N * 64 * 1024


def test_vocoder_batch_flops():
    assert B * flops.vocoder_flops(VP, N) == 15_277_208_371_200
    assert round(B * flops.vocoder_flops(VP, N) / 1e12, 2) == 15.28


def test_against_the_port():
    from audiodec_tpu_torch.utils import flops as port
    from audiodec_tpu_torch.utils.config import generator_config
    cfg, vcfg = generator_config(SYM), generator_config(VOC)
    assert port.transcode_flops(cfg, T)["total"] == (
        sum(flops.encoder_flops(GP, DF, T).values())
        + flops.projector_flops(GP, N) + flops.rvq_flops(GP, N)
        + flops.decoder_flops(GP, DF, N))
    assert port.vocoder_flops(vcfg, N) == flops.vocoder_flops(VP, N)


def test_bounds():
    # PERF.md's table: 0.969 ms for symAD's two stacks, 3.149 for the
    # vocoder's three
    two = (bounds.mma_stack(B, T, 32, storage=bounds.F32)
           + bounds.mma_stack(B, T, 32, storage=bounds.BF16))
    assert two * 1e3 == pytest.approx(0.969, abs=5e-4)
    three = 3 * bounds.mma_stack(B, T, 32, k=11, k2=11,
                                 storage=bounds.BF16, bias=True)
    assert three * 1e3 == pytest.approx(3.149, abs=5e-4)
