"""CPU tests of the benchmark (run with `python -m pytest benchmark/tests`);
the tests marked `card` run on an H100 and skip elsewhere."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips where there is none)")


@pytest.fixture
def card():
    """The CUDA device, with the port's precision policy (TF32 off), as a
    run sets it; or a skip: decided here, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from audiodec_tpu_torch.bin.codec_test import require_device
    return require_device("cuda:0")


def tiny_overrides(cell: str) -> dict:
    """run_cell's overrides: the cell's configuration at CPU-test widths
    and its traffic mix at CPU-test sizes."""
    from benchmark.harness.context import load_json
    sym = load_json(DATA / "tiny_symad.json")
    configs = {"symAD_vctk_48000_hop300": sym, "tiny_symad": sym,
               "AudioDec_v1_symAD_vctk_48000_hop300":
                   load_json(DATA / "tiny_ad_v1.json")}
    wl = load_json(ROOT / "benchmark" / "workloads" / f"{cell}.json")
    mix = "tiny_train" if "train" in wl["traffic"] else "tiny_transcode"
    return {"config": configs[wl["config"]], "configs": configs.__getitem__,
            "traffic": load_json(DATA / f"{mix}.json")}


@pytest.fixture
def tiny():
    return tiny_overrides
