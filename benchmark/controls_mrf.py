"""The controls of the cell `ad_v0.transcode.b16x10s`, which its driver
(drivers/transcode_mrf.py) builds in place of the program when a run's
`variant` names one.  Read them as benchmark/controls.py reads the other
cells' (its docstring):

    python3 benchmark/controls.py --workload ad_v0.transcode.b16x10s \\
        --seeds 1-12 --variant program --variant fp8_vocode

Variants:
- `fp8_vocode`: the program's encode, and reference/mrf.py's vocoder put
  in place of the program's, every conv's operands rounded to float8 e4m3
  (per-tensor scale): the step below bfloat16;
- `cli:<flags>`, `tf32_program`: as benchmark/controls.py builds them.

Not part of a benchmark run.
"""

from __future__ import annotations

import torch

from benchmark import controls
from benchmark.drivers import transcode as TC
from benchmark.reference import codec as R
from benchmark.reference import mrf as M


class _Fp8Vocode:
    """The program's encode; the reference's MRF vocoder in fp8, as
    PCM16."""

    def __init__(self, ctx, program):
        self.program = program
        sym, voc = TC.parts(ctx)
        self.vp = voc["generator_params"]
        self.embed = R.codebooks(ctx.state["sd"], sym["generator_params"])
        self.vsd = M.fold_weight_norm(ctx.state["vsd"])

    def encode(self, x):
        return self.program.encode(x)

    def decode(self, idx):
        saved, R.F = R.F, controls._fp8_functional()
        try:
            with torch.no_grad():
                y = M.vocode_mrf(R.rvq_decode(idx.long(), self.embed),
                                 self.vsd, self.vp)
        finally:
            R.F = saved
        return TC.pcm16(y).to(torch.int16).transpose(1, 2)


def transcode_variant(ctx):
    if ctx.variant == "fp8_vocode":
        st = ctx.state
        return _Fp8Vocode(ctx, TC.build_program(ctx, st["sd"], st["vsd"],
                                                ctx.params["cli"]))
    return controls.transcode_variant(ctx)
