"""`bin/codec_pipeline.py` against scripts/run_codec_pipeline.sh: the stages
each selection runs and each stage's command line, read from the script
by putting a `python` on PATH that records its arguments instead of
running them.  The port's command lines are the script's with
`audiodec_tpu.bin` replaced by `audiodec_tpu_torch.bin`, the interpreter
by this one, and `--device` added where it is given.
"""

import os
import stat
import subprocess
import sys

import pytest

from audiodec_tpu_torch.bin import codec_pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "run_codec_pipeline.sh")
SEP = "\x1f"

SELECTIONS = [
    [],
    ["--start", "2", "--stop", "3"],
    ["--start", "1", "--stop", "1", "--tag_prefix", "runs"],
    ["--stop", "0", "--resume", "exp/x/checkpoint-10steps.ckpt"],
    ["--start", "3", "--ae_tag", "a/b", "--voc_tag", "c/d",
     "--ae_config", "cfg/ae.yaml", "--voc_config", "cfg/voc.yaml",
     "--stats_config", "cfg/st.yaml"],
    ["--start", "3", "--stop", "2"],
]


def _script_argvs(tmp_path, args):
    shim = tmp_path / "bin" / "python"
    shim.parent.mkdir(exist_ok=True)
    log = tmp_path / "calls.log"
    log.write_text("")
    shim.write_text('#!/bin/bash\n(IFS=$\'\\x1f\'; echo "$*") >> "$LOG"\n')
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    env = dict(os.environ, LOG=str(log),
               PATH=f"{shim.parent}{os.pathsep}{os.environ['PATH']}")
    out = subprocess.run(["bash", SCRIPT, *args], env=env, cwd=tmp_path,
                         capture_output=True, text=True, check=True).stdout
    stages = [int(line.split()[2].rstrip(":"))
              for line in out.splitlines() if line.startswith("=== stage")]
    calls = [line.split(SEP) for line in log.read_text().splitlines()]
    return stages, calls


@pytest.mark.parametrize("args", SELECTIONS, ids=lambda a: " ".join(a)
                         or "defaults")
def test_stages_and_argvs_match_the_script(tmp_path, args):
    stages, calls = _script_argvs(tmp_path, args)
    ours = codec_pipeline.stage_argvs(codec_pipeline._parser().parse_args(
        args))
    assert [n for n, _ in ours] == stages
    assert len(calls) == len(stages)
    for (_, argv), call in zip(ours, calls):
        assert argv[0] == sys.executable
        assert argv[1:] == [a.replace("audiodec_tpu.bin.",
                                      "audiodec_tpu_torch.bin.")
                            for a in call]


def test_device_is_passed_to_every_stage():
    ours = codec_pipeline.stage_argvs(codec_pipeline._parser().parse_args(
        ["--device", "cpu"]))
    assert [n for n, _ in ours] == [0, 1, 2, 3, 4]
    assert all(argv[-2:] == ["--device", "cpu"] for _, argv in ours)


def test_main_runs_the_stages_in_order_from_the_repo_root(monkeypatch):
    calls = []

    def run(cmd, cwd, env, check):
        assert check and str(cwd) == ROOT
        assert env["PYTHONPATH"].split(os.pathsep)[0] == ROOT
        calls.append(cmd)

    monkeypatch.setattr(codec_pipeline.subprocess, "run", run)
    assert codec_pipeline.main(["--start", "1", "--stop", "3"]) == [1, 2, 3]
    assert [c[2] for c in calls] == ["audiodec_tpu_torch.bin.codec_stats",
                                     "audiodec_tpu_torch.bin.codec_train",
                                     "audiodec_tpu_torch.bin.codec_test"]
