"""Adversarial training: the adversarial stage of `codec_train` on symAD,
its models, state and steps built as bin/codec_train.py builds them
(`build_models`, train/steps.py `train_state`, `make_autoencoder_steps`)
with the seeded weights carried in through utils/bridge.py, and the
window calling the adversarial step back to back.

Set-up drives that same state through its first three steps (the
warm-up), on batches 0-2 of a pool of `pool` seeded batches, and keeps what
the check needs: each step's mel, adversarial and discriminator losses,
every trained leaf's first gradient (from Adam's first moment after step 1)
and its change over the three steps.  The window goes on from batch 3.  At
the first step past a share of the window drawn from the seed (`probe`,
between its two ends) it snapshots the trained leaves and both Adams'
state, and keeps the same readings of that step and the two after it.
WAV loading is left out: the batches are made on the device.

Traffic parameters (benchmark/traffic/<mix>.json): `pool`, `amplitude`,
`probe` ([low, high] shares of the window), `trace_wait`, `trace_steps`;
the batch (`batch_size` x `batch_length`) is the configuration's.

End to end: `train_audio_s_per_s`, seconds of training audio consumed by
the window's steps over its wall time, which ends in a synchronize.
Checks, against the reference's same three steps from the same state and
batches (benchmark/reference/train.py): `loss_gap`, the largest relative
gap of a step's loss; `grad_gap` and `update_gap`, by the worst leaf, the
gap between the program's and the reference's norms of a leaf's first
gradient and of its change, over the reference's norm of that leaf or of
the median leaf of its optimizer, whichever is larger.  Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out (they move by round-off alone).  The `window_` numbers are the same
readings of the window's three probed steps: the reference takes the
program's snapshot (trained leaves, Adam's moments and step count; the
frozen encoder, projector and codebooks are the seeded ones) and follows it
for three steps, since it cannot replay hundreds of steps in a check's
time.  The learning rates are the configuration's: its schedules first
move at step 200000.
"""

from __future__ import annotations

import random
import statistics
import time

import torch

from benchmark.harness import weights as W
from benchmark.harness.trace import Tracer, span
from benchmark.reference import layout as L
from benchmark.reference import train as RT

LOSSES = ("mel_loss", "adversarial_loss", "discriminator_loss")


def ref_key(path: str, n_msd: int) -> str:
    """A trained leaf's path in the port's trees -> its key in the
    reference's state dict; n_msd: the layers of a scale discriminator."""
    p = path.split("/")
    leaf = {"w": "weight", "b": "bias", "v": "weight_v", "g": "weight_g"}
    if p[0] == "decoder":
        if p[1] in ("conv1", "conv2"):
            return f"decoder.{p[1]}.conv.{leaf[p[2]]}"
        pre = f"decoder.conv_blocks.{p[2]}"
        if p[3] == "conv":
            return f"{pre}.conv.deconv.{leaf[p[4]]}"
        unit = f"{pre}.res_units.{p[4]}.{p[5]}"
        return (f"{unit}.conv.weight" if p[5] == "conv1"
                else f"{unit}.weight")
    if p[0] == "msd":
        return f"{RT._msd_key(int(p[2]), int(p[4]), n_msd)}.{leaf[p[5]]}"
    if p[3] == "output_conv":
        return f"mpd.discriminators.{p[2]}.output_conv.conv.{leaf[p[4]]}"
    return f"mpd.discriminators.{p[2]}.convs.{p[4]}.0.conv.{leaf[p[5]]}"


def setup(ctx):
    cfg, p = ctx.config, ctx.params
    gp, df, dp = (cfg["generator_params"], cfg["code_defaults"],
                  cfg["discriminator_params"])
    sd = W.state_dict(L.symad_layout(gp, df), cfg["init"], ctx.seed,
                      "symad", ctx.device)
    dsd = W.state_dict(RT.disc_layout(dp), cfg["init"], ctx.seed, "disc",
                       ctx.device)
    shape = (cfg["batch_size"], cfg["adv_batch_length"], 1)
    pool = [W.audio(ctx.seed, f"train{i}", shape, p["amplitude"],
                    ctx.device) for i in range(p["pool"])]
    ctx.state.update(sd=sd, dsd=dsd, pool=pool, rate=cfg["sampling_rate"])
    ctx.setup_marks("weights_and_inputs")
    state, adv = build_program(ctx, sd, dsd)
    ctx.state.update(train_state=state, adv=adv)
    ctx.setup_marks("program")
    ctx.state["first"] = first_steps(ctx, state, adv, pool[:3])
    ctx.setup_marks("warm_up")


def build_program(ctx, sd, dsd):
    """(train state, adversarial step) as codec_train builds them, with
    the seeded weights in place of its own draw."""
    from audiodec_tpu_torch.bin import codec_train
    from audiodec_tpu_torch.train.criterion import build_criterion
    from audiodec_tpu_torch.train.steps import (
        make_autoencoder_steps, train_state)
    from audiodec_tpu_torch.utils import bridge
    from audiodec_tpu_torch.utils.bridge import tree_map
    from audiodec_tpu_torch.utils.config import discriminator_config
    cfg = ctx.config
    gen_cfg, _, disc_apply, _ = codec_train.build_models(
        cfg, "autoencoder", ctx.device, ctx.seed)

    def on_device(tree):
        return tree_map(lambda t: t.to(ctx.device), tree)

    gen = on_device(bridge.params_from_reference_sd(W.to_numpy(sd),
                                                    gen_cfg))
    disc = on_device(bridge.hifigan_disc_params_from_reference_sd(
        W.to_numpy(dsd), discriminator_config(cfg), fold=False))
    state = train_state(gen, disc, cfg)
    steps = make_autoencoder_steps(gen_cfg, disc_apply, cfg,
                                   build_criterion(cfg))
    return state, steps["adv"]


def _n_msd(ctx) -> int:
    return len(RT._msd_layers(ctx.config["discriminator_params"][
        "scale_discriminator_params"]))


def _trained(ctx, state) -> dict:
    """{reference key: leaf} of every leaf the two optimizers train (the
    frozen encoder and projector left out)."""
    return {ref_key(path, _n_msd(ctx)): t
            for role in ("gen_opt", "disc_opt")
            for path, t in state[role].params.items()
            if path.split("/")[0] not in ("encoder", "projector")}


def _moments(ctx, state) -> dict:
    """{reference key: (exp_avg, exp_avg_sq, step)} of every leaf the two
    optimizers have state for, and beta1 of each role."""
    out = {}
    for role in ("gen_opt", "disc_opt"):
        opt = state[role]
        for path, t in opt.params.items():
            st = opt.opt.state.get(t, {})
            if "exp_avg" in st:
                out[ref_key(path, _n_msd(ctx))] = (
                    st["exp_avg"], st["exp_avg_sq"], st["step"],
                    opt.opt.param_groups[0]["betas"][0])
    return out


def first_steps(ctx, state, adv, batches) -> dict:
    """Three steps of the program from the seeded state -> losses, first
    gradients, changes."""
    before = {k: t.detach().clone()
              for k, t in _trained(ctx, state).items()}
    losses, grads = [], {}
    for i, x in enumerate(batches):
        state, rec = adv(state, x)
        losses.append([float(rec[k]) for k in LOSSES])
        if i == 0:
            grads = {k: float(m.norm()) / (1 - b1)
                     for k, (m, _, _, b1) in _moments(ctx, state).items()}
    after = _trained(ctx, state)
    return {"losses": losses, "grads": grads,
            "changes": {k: float((after[k].detach() - before[k]).norm())
                        for k in before}}


class Probe:
    """Three steps of the window from the first one that starts `at_s`
    seconds into it: a snapshot of the trained leaves and of Adam's state
    before them, their losses, Adam's first moment after the first (its
    gradient is (m1 - beta1 m0) / (1 - beta1)) and the leaves after the
    third.  Device copies only: nothing waits for the device."""

    def __init__(self, at_s: float):
        self.at_s, self.step, self.recs = at_s, None, []

    @property
    def done(self) -> bool:
        return len(self.recs) == 3

    def before(self, ctx, state, n: int, elapsed: float):
        if self.step is None and elapsed >= self.at_s:
            self.step = n
            self.leaves = {k: t.detach().clone()
                           for k, t in _trained(ctx, state).items()}
            self.moments = {k: (m.clone(), v.clone(), float(t), b1)
                            for k, (m, v, t, b1) in
                            _moments(ctx, state).items()}

    def after(self, ctx, state, rec):
        if self.step is None or self.done:
            return
        self.recs.append([rec[k].detach().clone() for k in LOSSES])
        if len(self.recs) == 1:
            self.m1 = {k: m.clone() for k, (m, _, _, _) in
                       _moments(ctx, state).items()}
        if self.done:
            self.after_leaves = {k: t.detach().clone()
                                 for k, t in _trained(ctx, state).items()}

    def record(self) -> dict:
        """The probed steps in the form of `first_steps`."""
        grads = {k: float((self.m1[k] - b1 * m0).norm()) / (1 - b1)
                 for k, (m0, _, _, b1) in self.moments.items()}
        return {"losses": [[float(v) for v in r] for r in self.recs],
                "grads": grads,
                "changes": {k: float((self.after_leaves[k]
                                      - self.leaves[k]).norm())
                            for k in self.leaves}}


def _steps(ctx, start, until, tracer=None, events=None, probe=None):
    """Steps from pool batch `start` on while until(n, elapsed) holds ->
    (steps, wall seconds); with `events`, a CUDA event as each step starts
    and one after the last (nothing waits for them)."""
    state, adv, pool = (ctx.state["train_state"], ctx.state["adv"],
                        ctx.state["pool"])
    cuda = ctx.device.type == "cuda"

    def mark():
        if events is not None and cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

    n = 0
    t0 = time.perf_counter()
    while until(n, time.perf_counter() - t0):
        mark()
        if probe:
            probe.before(ctx, state, n, time.perf_counter() - t0)
        with span("step", ctx.traced):
            state, rec = adv(state, pool[(start + n) % len(pool)])
        if probe:
            probe.after(ctx, state, rec)
        n += 1
        if tracer:
            tracer.step()
    mark()
    if cuda:
        torch.cuda.synchronize(ctx.device)
    ctx.state["train_state"] = state
    return n, time.perf_counter() - t0


def window(ctx):
    """The measured window from batch 3 on, with its probed steps, then, in
    a traced run, more steps under the profiler, which records the
    device's activity alone.  A traced run's window times each step on the
    device's clock: CUDA events as each starts, so that it runs as an
    untraced one does."""
    p, cfg = ctx.params, ctx.config
    events = [] if ctx.traced else None
    lo, hi = p["probe"]
    probe = Probe(ctx.seconds * random.Random(
        W.derive(ctx.seed, "probe")).uniform(lo, hi))
    n, wall = _steps(ctx, 3, lambda n, dt: dt < ctx.seconds or not
                     probe.done, events=events, probe=probe)
    ctx.window_s, ctx.attempted = wall, n
    ctx.counters["steps"] = n
    ctx.state["probe"] = probe
    audio = n * cfg["batch_size"] * cfg["adv_batch_length"] / cfg[
        "sampling_rate"]
    ctx.e2e["train_audio_s_per_s"] = audio / wall
    if events:
        ctx.timings["step_ms"] = [a.elapsed_time(b)
                                  for a, b in zip(events, events[1:])]
    if ctx.traced:
        count = p["trace_wait"] + 1 + p["trace_steps"]
        with Tracer(p["trace_wait"], p["trace_steps"],
                    host=False) as tracer:
            _steps(ctx, 3 + n, lambda n, dt: n < count, tracer=tracer)
        ctx.trace = tracer.reduce()


def release(ctx):
    ctx.state.pop("train_state", None)
    ctx.state.pop("adv", None)


def reference_steps(ctx, batches, probe=None) -> dict:
    """The reference's three steps from the seeded state, or with `probe`
    from the program's snapshot, in the form of `first_steps`."""
    trainer = RT.Trainer(ctx.state["sd"], ctx.state["dsd"], ctx.config)
    opts = (trainer.gen_opt, trainer.disc_opt)
    if probe is not None:
        # a leaf without Adam state in the program starts from zero moments
        with torch.no_grad():
            for o in opts:
                for k, t in o.params.items():
                    t.copy_(probe.leaves[k])
                    if k in probe.moments:
                        m, v, step, _ = probe.moments[k]
                        o.m[k].copy_(m)
                        o.v[k].copy_(v)
                        o.t = int(step)
    before = {k: t.detach().clone() for o in opts
              for k, t in o.params.items()}
    m0 = {k: o.m[k].clone() for o in opts for k in o.params}
    losses, grads = [], {}
    for i, x in enumerate(batches):
        losses.append(list(trainer.step(x.transpose(1, 2))))
        if i == 0:
            grads = {k: float((o.m[k] - o.betas[0] * m0[k]).norm())
                     / (1 - o.betas[0]) for o in opts for k in o.params}
    return {"losses": losses, "grads": grads,
            "changes": {k: float((t.detach() - before[k]).norm())
                        for o in opts for k, t in o.params.items()},
            "roles": [list(o.params) for o in opts]}


def probed_batches(ctx) -> list:
    """The pool's batches of the window's probed steps."""
    pool, k = ctx.state["pool"], ctx.state["probe"].step
    return [pool[(3 + k + i) % len(pool)] for i in range(3)]


def worst_leaf(prog: dict, ref: dict, roles, keep) -> float:
    """The largest |program norm - reference norm| over max(reference
    norm, the median leaf's of its optimizer), over the kept leaves."""
    worst = 0.0
    for keys in roles:
        med = statistics.median(ref[k] for k in keys)
        for k in keys:
            if k in keep:
                worst = max(worst, abs(prog.get(k, 0.0) - ref[k])
                            / max(ref[k], med, 1e-30))
    return worst


def compare(prog: dict, ref: dict) -> dict:
    keep = set()
    for keys in ref["roles"]:
        med = statistics.median(ref["grads"][k] for k in keys)
        keep |= {k for k in keys if ref["grads"][k] >= 1e-3 * med}
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for sa, sb in zip(prog["losses"], ref["losses"])
                   for a, b in zip(sa, sb))
    return {"loss_gap": loss_gap,
            "grad_gap": worst_leaf(prog["grads"], ref["grads"],
                                   ref["roles"], keep),
            "update_gap": worst_leaf(prog["changes"], ref["changes"],
                                     ref["roles"], keep)}


def check(ctx):
    """The program's first three steps, and the window's three probed
    steps, against the reference's, float32 with TF32 off."""
    from benchmark.drivers.transcode import tf32
    with tf32(False):
        ref = reference_steps(ctx, ctx.state["pool"][:3])
        out = compare(ctx.state["first"], ref)
        probe = ctx.state["probe"]
        ref = reference_steps(ctx, probed_batches(ctx), probe)
        prog = ctx.state.get("window_steps") or probe.record()
    out.update({"window_" + k: v for k, v in compare(prog, ref).items()})
    return out
