"""The codec's five-stage pipeline on the port's command lines (counterpart of
scripts/run_codec_pipeline.sh, the reference's submit_codec_*.sh stages):

  0: train the autoencoder      1: extract the code statistics
  2: train the vocoder          3: test symAE (AE encoder + AE decoder)
  4: test AE + vocoder

    python -m audiodec_tpu_torch.bin.codec_pipeline --start 0 --stop 4 \\
        [--ae_config ...] [--voc_config ...] [--stats_config ...] \\
        [--tag_prefix exp] [--ae_tag DIR] [--voc_tag DIR] [--resume CKPT] \\
        [--device cpu]

The options and defaults are the script's.  Each stage runs
`python -m audiodec_tpu_torch.bin.<codec_train|codec_stats|codec_test>`
with the script's arguments, from the repo root (so relative paths are
the repo root's, as the script's `cd` makes them), and a failing stage
stops the run.  The statistics' output and the vocoder's analyzer are
where the configs name them, as for the script.  `--device` (the port's
addition) is passed to every stage; without it they run on the card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
STAGES = ("train autoencoder", "extract code statistics", "train vocoder",
          "test symAE", "test AE + vocoder")


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--stop", type=int, default=4)
    p.add_argument("--ae_config",
                   default="configs/autoencoder/symAD_vctk_48000_hop300.yaml")
    p.add_argument("--voc_config", default="configs/vocoder/"
                   "AudioDec_v1_symAD_vctk_48000_hop300_clean.yaml")
    p.add_argument("--stats_config", default="configs/statistic/"
                   "symAD_vctk_48000_hop300_clean.yaml")
    p.add_argument("--tag_prefix", default="exp")
    p.add_argument("--ae_tag", default=None)
    p.add_argument("--voc_tag", default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--device", default=None,
                   help="passed to every stage (default: the card)")
    return p


def _stem(path: str) -> str:
    name = os.path.basename(path)
    return name[:-len(".yaml")] if name.endswith(".yaml") else name


def stage_argvs(args) -> list:
    """-> [(stage, argv)] of the stages from --start to --stop, each argv
    `python -m audiodec_tpu_torch.bin.<cli> ...`."""
    ae_tag = args.ae_tag or f"{args.tag_prefix}/autoencoder/" \
        f"{_stem(args.ae_config)}"
    voc_tag = args.voc_tag or f"{args.tag_prefix}/vocoder/" \
        f"{_stem(args.voc_config)}"
    ae_ckpt = f"{ae_tag}/checkpoint-final.ckpt"
    resume = ["--resume", args.resume] if args.resume else []
    device = ["--device", args.device] if args.device else []

    def cli(name, *rest):
        return [sys.executable, "-m", f"audiodec_tpu_torch.bin.{name}",
                *rest, *device]

    stages = [
        cli("codec_train", "--config", args.ae_config, "--tag", ae_tag,
            *resume),
        cli("codec_stats", "--config", args.stats_config, "--analyzer",
            ae_ckpt),
        cli("codec_train", "--config", args.voc_config, "--tag", voc_tag),
        cli("codec_test", "--encoder", ae_ckpt, "--decoder", ae_ckpt,
            "--subset", "test"),
        cli("codec_test", "--encoder", ae_ckpt, "--decoder",
            f"{voc_tag}/checkpoint-final.ckpt", "--subset", "test"),
    ]
    return [(n, argv) for n, argv in enumerate(stages)
            if args.start <= n <= args.stop]


def main(argv=None) -> list:
    """Run the selected stages -> their numbers."""
    args = _parser().parse_args(argv)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    ran = []
    for n, cmd in stage_argvs(args):
        print(f"=== stage {n} ({STAGES[n]}): {' '.join(cmd[1:])} ===",
              flush=True)
        subprocess.run(cmd, cwd=ROOT, env=env, check=True)
        ran.append(n)
    return ran


if __name__ == "__main__":
    main()
