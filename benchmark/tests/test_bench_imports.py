"""What the benchmark loads: neither JAX nor the JAX package in a run (top-
level module names compared whole: `audiodec_tpu_torch` is the port and
`audiodec_tpu` the forbidden JAX package), and nothing of the port in the
reference."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import ROOT

RUN_TINY = r"""
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
from conftest import tiny_overrides
from benchmark import run
out = run.run_cell("symad.transcode.b16x10s", 7, 0.5, False,
                   torch.device("cpu"),
                   overrides=tiny_overrides("symad.transcode.b16x10s"))
print(json.dumps({{"forbidden": run.loaded_forbidden(),
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

REFERENCE_ONLY = r"""
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.codec, benchmark.reference.layout
import benchmark.arith.flops, benchmark.arith.bounds
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _python(code: str) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", code.format(root=str(ROOT),
                                           tests=str(ROOT / "benchmark"
                                                     / "tests"))],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    out = json.loads(_python(RUN_TINY))
    assert out["forbidden"] == []
    assert "audiodec_tpu_torch" in out["top"]
    assert not {"jax", "jaxlib", "flax", "audiodec_tpu"} & set(out["top"])


def test_forbidden_names_compare_whole():
    from benchmark import run
    saved = dict(sys.modules)
    try:
        sys.modules.pop("jax", None)
        sys.modules["audiodec_tpu_torch_fake"] = sys
        assert "audiodec_tpu" not in run.loaded_forbidden()
        sys.modules["audiodec_tpu.models"] = sys
        assert "audiodec_tpu" in run.loaded_forbidden()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_reference_imports_nothing_of_the_port():
    top = json.loads(_python(REFERENCE_ONLY))
    assert "audiodec_tpu_torch" not in top and "audiodec_tpu" not in top
    assert "jax" not in top


def test_no_card_no_result(tmp_path):
    """Without enough CUDA devices, or without the port beside it, a run
    exits with another code than 0 and prints no result."""
    import shutil
    import torch
    cmd = [sys.executable, "benchmark/run.py", "--workload",
           "symad.transcode.b16x10s", "--seed", "1", "--seconds", "1"]
    bare = tmp_path / "bare"
    shutil.copytree(ROOT / "benchmark", bare / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", bare)
    dirs = [bare] if torch.cuda.is_available() else [ROOT, bare]
    for cwd in dirs:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300, cwd=cwd)
        assert proc.returncode != 0
        assert proc.stdout.strip() == ""
