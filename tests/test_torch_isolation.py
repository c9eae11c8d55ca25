"""The port stands alone: no JAX, no PyYAML, nothing of audiodec_tpu.

The machine with the card has neither JAX nor PyYAML, so a port module or
chip_smoke.py that touched either would die there.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from audiodec_tpu_torch.bin.codec_test import BatchTranscoder
from audiodec_tpu_torch.models.autoencoder import GeneratorConfig

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "audiodec_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)
    yield "chip_smoke"


def test_imports_without_jax_yaml_or_jax_package():
    code = ("import sys\n"
            "for m in ('jax', 'yaml', 'audiodec_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {list(_modules())!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("pattern", [
    r"^\s*(import|from)\s+jax\b",
    r"^\s*(import|from)\s+yaml\b",
    r"audiodec_tpu\.",
])
def test_sources_do_not_reach_jax(pattern):
    hits = [f"{p.relative_to(ROOT)}:{i}"
            for p in SOURCES
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if re.search(pattern, line)]
    assert not hits


def test_package_holds_no_binaries():
    assert not [p for p in PKG.rglob("*")
                if p.suffix in (".so", ".npz", ".wav", ".npy")]


def test_entry_point_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GeneratorConfig(encode_channels=4, decode_channels=4, code_dim=16,
                          codebook_num=4, codebook_size=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchTranscoder({}, cfg)


def test_spawned_ranks_import_no_jax():
    """The ranks that bin/multihost_probe.py starts (the tests' and
    chip_smoke.py's workers) import neither JAX, PyYAML nor the JAX
    package: two gloo ranks run the probe with Python's import log on."""
    from audiodec_tpu_torch.bin.multihost_probe import run_ranks

    outs = run_ranks(2, ["--worker", "probe", "--seq", "1", "--device",
                         "cpu", "--threads", "1"], timeout=300,
                     env=dict(os.environ, PYTHONPROFILEIMPORTTIME="1"))
    for out in outs:
        assert "OK" in out
        imported = {line.rsplit("|", 1)[-1].strip().split(".")[0]
                    for line in out.splitlines()
                    if line.startswith("import time:")}
        assert "torch" in imported
        assert not imported & {"jax", "yaml", "audiodec_tpu"}
