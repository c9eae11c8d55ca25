"""The port's spans (`utils/profiling.py` `span`, `span_totals`): off
without a profiler, recorded while one records (nested, as
`audiodec/<name>` in its trace, tallied by name, the tally started afresh
after an untraced span), placed in `BatchTranscoder`'s stages and in the
adversarial step's parts, and without effect on what they time: indices,
PCM, losses and leaves equal bit for bit with tracing on and off.  Tiny
widths on the CPU; no JAX."""

import glob
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from audiodec_tpu_torch.bin import codec_test, codec_train
from audiodec_tpu_torch.data.wav import write_wav
from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    generator_init,
)
from audiodec_tpu_torch.models.vocoder import VocoderConfig, vocoder_init
from audiodec_tpu_torch.train.criterion import build_criterion
from audiodec_tpu_torch.train.optim import tree_leaves
from audiodec_tpu_torch.train.steps import make_autoencoder_steps, train_state
from audiodec_tpu_torch.utils import config, profiling
from audiodec_tpu_torch.utils.bridge import params_to_jax
from audiodec_tpu_torch.utils.checkpoint import save_checkpoint
from audiodec_tpu_torch.utils.profiling import span, span_totals

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYMAD = os.path.join(ROOT, "configs", "autoencoder",
                     "symAD_vctk_48000_hop300.yaml")
SMALL = dict(encode_channels=4, decode_channels=4, code_dim=16,
             codebook_num=4, codebook_size=32)
VOC = dict(in_channels=16, channels=32, upsample_scales=(5, 5, 4, 3),
           upsample_kernel_sizes=(10, 10, 8, 6),
           resblock_kernel_sizes=(11,), resblock_dilations=((1, 3, 5),),
           groups=3)
ENCODE = ("encode", "encoder", "projector", "rvq")
DECODE = ("decode", "lookup", "decoder", "pcm16")
FORWARD = ("generator", "adversarial", "regenerate", "discriminate")
PARTS = FORWARD + ("gen_update", "disc_update")


def _cpu_profile(**kw):
    return profile(activities=[ProfilerActivity.CPU], **kw)


def _named(prof, name):
    return [e for e in prof.events() if e.name == profiling.PREFIX + name]


def _within(inner, outer) -> bool:
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_span_off_records_nothing():
    """Without a profiler a span is the one shared no-op context, and the
    tally does not move."""
    before = span_totals()
    a, b = span("encode"), span("decode", torch.device("cpu"))
    assert a is b is profiling._OFF
    with a, b:
        torch.ones(4).sum()
    assert span_totals() == before


def test_spans_record_in_the_active_steps_only():
    """Under a scheduled CPU profiler the spans count in the active steps
    alone, show as nested `audiodec/` events, and an untraced span followed
    by a traced one starts the tally afresh."""
    sched = schedule(wait=2, warmup=1, active=3, repeat=1)
    with _cpu_profile(schedule=sched) as prof:
        for _ in range(7):
            with span("outer"):
                with span("inner"):
                    torch.ones(64).cumsum(0)
            prof.step()
    tot = span_totals()
    assert set(tot) == {"outer", "inner"}
    assert tot["outer"]["count"] == tot["inner"]["count"] == 3
    assert 0 < tot["inner"]["host_ms"] <= tot["outer"]["host_ms"]
    # on the host the device time is the host time
    assert tot["inner"]["device_ms"] == tot["inner"]["host_ms"]
    outer, inner = _named(prof, "outer"), _named(prof, "inner")
    assert len(outer) == len(inner) == 3
    assert all(any(_within(i, o) for o in outer) for i in inner)

    with span("outer"):
        pass
    with _cpu_profile():
        with span("other"):
            pass
    assert set(span_totals()) == {"other"}


def _transcoder(route: str, vocoder: bool) -> codec_test.BatchTranscoder:
    gen = torch.Generator().manual_seed(3)
    params = generator_init(GeneratorConfig(**SMALL), gen)
    voc = None
    if vocoder:
        vcfg = VocoderConfig(**VOC)
        voc = (vocoder_init(vcfg, gen), vcfg)
    return codec_test.BatchTranscoder(
        params, GeneratorConfig(**SMALL), voc=voc, stack=route,
        dec_dtype=torch.bfloat16, pcm16=True, device="cpu")


@pytest.mark.parametrize("vocoder", [False, True], ids=["symad", "vocoder"])
@pytest.mark.parametrize("route", ["folded", "plain"])
def test_transcoder_stage_spans(route, vocoder):
    """Each of encode's and decode's stages once per call under a profiler,
    the stages inside their parent on the host's clock, and indices and PCM
    bit-equal with tracing on and off."""
    tc = _transcoder(route, vocoder)
    x = 0.3 * torch.randn(2, 3000, 1, generator=torch.Generator()
                          .manual_seed(5))
    idx_off = tc.encode(x)
    pcm_off = tc.decode(idx_off)
    with _cpu_profile() as prof:
        for _ in range(2):
            idx_on = tc.encode(x)
            pcm_on = tc.decode(idx_on)
    assert torch.equal(idx_on, idx_off) and torch.equal(pcm_on, pcm_off)
    assert pcm_on.dtype == torch.int16
    tot = span_totals()
    assert set(tot) == set(ENCODE + DECODE)
    assert all(tot[k]["count"] == 2 for k in tot)
    for parent, stages in ((ENCODE[0], ENCODE[1:]), (DECODE[0], DECODE[1:])):
        assert (sum(tot[k]["host_ms"] for k in stages)
                <= tot[parent]["host_ms"])
        for k in stages:
            assert all(any(_within(e, p) for p in _named(prof, parent))
                       for e in _named(prof, k))


def _tiny_train_config() -> dict:
    cfg = config.load_config(SYMAD)
    cfg["generator_params"].update(SMALL)
    dp = cfg["discriminator_params"]
    dp["scales"], dp["periods"] = 2, [2, 3]
    dp["scale_discriminator_params"].update(
        channels=16, max_downsample_channels=32, max_groups=4)
    dp["period_discriminator_params"].update(channels=4,
                                             max_downsample_channels=16)
    return cfg


def _adv_program(cfg):
    gen_cfg, gen, disc_apply, disc = codec_train.build_models(
        cfg, "autoencoder", torch.device("cpu"), 7)
    steps = make_autoencoder_steps(gen_cfg, disc_apply, cfg,
                                   build_criterion(cfg))
    return train_state(gen, disc, cfg), steps["adv"]


def test_adv_step_part_spans():
    """One adversarial step gives every part once, `backward` and `update`
    once for each optimizer; the parts cover at least 90% of the step's
    host time; the losses and every leaf come out bit-equal with tracing on
    and off."""
    cfg = _tiny_train_config()
    (state, adv), (twin, adv_twin) = _adv_program(cfg), _adv_program(cfg)
    x = 0.3 * torch.randn(2, 1200, 1,
                          generator=torch.Generator().manual_seed(9))
    state, rec_off = adv(state, x)
    with _cpu_profile():
        twin, rec_on = adv_twin(twin, x)
    tot = span_totals()
    assert set(tot) == {"adv_step", "backward", "update"} | set(PARTS)
    assert tot["adv_step"]["count"] == 1
    assert all(tot[k]["count"] == 1 for k in PARTS)
    assert tot["backward"]["count"] == tot["update"]["count"] == 2
    parts = sum(tot[k]["host_ms"] for k in FORWARD + ("backward", "update"))
    assert parts >= 0.9 * tot["adv_step"]["host_ms"]
    assert rec_on.keys() == rec_off.keys()
    assert all(torch.equal(rec_on[k], rec_off[k]) for k in rec_on)
    for tree in ("gen", "disc"):
        a, b = dict(tree_leaves(state[tree])), dict(tree_leaves(twin[tree]))
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a), tree


def test_codec_test_profile_trace_names_the_spans(tmp_path):
    """`codec_test --profile DIR`'s Chrome trace carries the port's spans."""
    exp = tmp_path / "exp"
    exp.mkdir()
    with open(SYMAD) as f:
        (exp / "base.yaml").write_text(f.read())
    (exp / "config.yml").write_text(
        "inherit: base.yaml\ngenerator_params:\n"
        + "".join(f"    {k}: {v}\n" for k, v in SMALL.items()))
    params = generator_init(GeneratorConfig(**SMALL),
                            torch.Generator().manual_seed(0))
    ckpt = str(exp / "checkpoint-1.ckpt")
    save_checkpoint(ckpt, {"gen": params_to_jax(params)}, 1)
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    write_wav(str(wavs / "u0.wav"), (0.3 * np.random.default_rng(0)
                                     .standard_normal((3000, 1))
                                     ).astype(np.float32), 48000)
    codec_test.main(["--encoder", ckpt, "--decoder", ckpt, "--data-path",
                     str(wavs), "--outdir", str(tmp_path / "out"),
                     "--device", "cpu", "--profile", str(tmp_path / "prof")])
    (trace,) = glob.glob(str(tmp_path / "prof" / "trace-*.json"))
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"audiodec/encode", "audiodec/decoder"} <= names
