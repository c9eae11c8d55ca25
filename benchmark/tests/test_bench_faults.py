"""A run with the timed path broken underneath comes out not correct: the
rest of a run (set-up, window, check, the result line) on the CPU at
CPU-test widths, past the harness's look for a card, once for each fault a
cell can have. A sound run at the same size comes out correct."""

from __future__ import annotations

import pytest
import torch

from benchmark import run

TRANSCODE = ["symad.transcode.b16x10s", "ad_v1.transcode.b16x10s"]
TRAIN = ["symad.train_adv.b16x9600"]
SEED = 2 ** 31 + 11


def _run(cell, tiny):
    return run.run_cell(cell, SEED, 0.5, False, torch.device("cpu"),
                        overrides=tiny(cell))


def _altered(idx):
    """One index of the batch replaced by the next code of its layer."""
    idx = idx.clone()
    idx[0, 0, 0] = (idx[0, 0, 0] + 1) % 16
    return idx


@pytest.mark.parametrize("cell", TRANSCODE + TRAIN)
def test_sound_run_is_correct(cell, tiny):
    out = _run(cell, tiny)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


def _transcode_faults():
    from audiodec_tpu_torch.bin.codec_test import BatchTranscoder
    enc, dec = BatchTranscoder.encode, BatchTranscoder.decode

    def altered_answer(self, x):
        return _altered(enc(self, x))

    def half_batch(self, idx):
        y = dec(self, idx[: idx.shape[0] // 2])
        return torch.cat([y, y])

    return {"altered_answer": ("encode", altered_answer),
            "half_batch": ("decode", half_batch)}


@pytest.mark.parametrize("fault", ["altered_answer", "half_batch"])
@pytest.mark.parametrize("cell", TRANSCODE)
def test_transcode_fault_is_caught(cell, fault, tiny, monkeypatch):
    from audiodec_tpu_torch.bin.codec_test import BatchTranscoder
    name, fn = _transcode_faults()[fault]
    monkeypatch.setattr(BatchTranscoder, name, fn)
    out = _run(cell, tiny)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("cell", TRAIN)
def test_train_fault_is_caught(cell, fault, tiny, monkeypatch):
    from audiodec_tpu_torch.train import optim
    from audiodec_tpu_torch.train import steps
    if fault == "state_unchanged":
        # the optimizers take their gradients and move nothing
        monkeypatch.setattr(optim.Optimizer, "step",
                            lambda self, loss, paths=None, axis=None: None)
    else:
        make = steps.make_autoencoder_steps

        def half(*a, **k):
            out = make(*a, **k)
            adv = out["adv"]
            out["adv"] = lambda state, x: adv(state, x[: x.shape[0] // 2])
            return out

        monkeypatch.setattr(steps, "make_autoencoder_steps", half)
    out = _run(cell, tiny)
    assert not out["correct"], out["checks"]


def _after_warm_up(fault):
    """make_autoencoder_steps whose adversarial step turns faulty after
    set-up's three steps, inside the window only."""
    from audiodec_tpu_torch.train import steps
    make = steps.make_autoencoder_steps

    def made(*a, **k):
        out = make(*a, **k)
        adv, calls = out["adv"], [0]

        def step(state, x):
            calls[0] += 1
            if calls[0] <= 3:
                return adv(state, x)
            if fault == "half_batch":
                return adv(state, x[: x.shape[0] // 2])
            disc = [t.detach().clone()
                    for t in state["disc_opt"].params.values()]
            state, rec = adv(state, x)
            with torch.no_grad():
                for t, s in zip(state["disc_opt"].params.values(), disc):
                    t.copy_(s)
            return state, rec

        out["adv"] = step
        return out

    return made


@pytest.mark.parametrize("fault", ["half_batch", "discriminator_skipped"])
@pytest.mark.parametrize("cell", TRAIN)
def test_train_window_fault_is_caught(cell, fault, tiny, monkeypatch):
    """A fault that starts after set-up's warm-up steps fails the window's
    probed steps, while set-up's own numbers stay within their limits."""
    from audiodec_tpu_torch.train import steps
    monkeypatch.setattr(steps, "make_autoencoder_steps",
                        _after_warm_up(fault))
    out = _run(cell, tiny)
    assert not out["correct"], out["checks"]
    start = {k: c for k, c in out["checks"].items()
             if not k.startswith("window_")}
    assert all(c["value"] <= c["limit"] for c in start.values()), start
