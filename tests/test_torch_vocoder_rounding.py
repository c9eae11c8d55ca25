"""Where the vocoder's float32 training chain rounds: each candidate op held
against its float64 value (ROADMAP.md section C, "The vocoder's float32
training chain").

The chain is `tests/test_torch_parallel_train.py`'s: from
`tests/golden/voc_train_step.npz`'s init, the vocoder's metric step, then
its adversarial step, on the whole batch in one process.  The reference is
the same chain in float64.  Each reading is the distance from it at the
witness element (`WITNESS_LEAF`, `WITNESS_ELEMENT`, a weight-norm gain
whose Adam first moment nearly cancels) and the worst leaf's q99, for the
float32 chain as it is and with one op computed in float64 (its inputs
widened, its output rounded to float32 once): the weight norm's
resolution (`ops/norms.py`), the log-mel spectrogram of the mel loss
(`ops/spectral.py mel_spectrogram` as `losses/mel.py` calls it), the
STFT's rfft alone, and Adam's moments and update (`train/optim.py`).
`pytest -s` prints them.

Then each candidate op alone, the port's against JAX's same op on the
same seeded inputs, both in float32 on the CPU: the relative RMS error
against the port's op in float64, the port's within 1.25x of XLA's, for
each output and gradient.  The weight norm's resolution (forward and its
vjp to `v` and `g`, at the vocoder's conv shapes), the log-mel
spectrogram at the chain's mel loss (forward and vjp), Adam's update over
the chain's config (two steps, the second gradient nearly cancelling the
first, as at the witness element) and the STFT's rfft at the loss's FFT
size (512).  If one rounded more than XLA's, it would be the fault.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.test_torch_parallel_train as T
from audiodec_tpu.ops import norms as jax_norms
from audiodec_tpu.ops import spectral as jax_spectral
from audiodec_tpu.train import optim as jax_optim
from audiodec_tpu_torch.losses import mel as mel_loss
from audiodec_tpu_torch.ops import norms, spectral
from audiodec_tpu_torch.train import optim
from audiodec_tpu_torch.train.optim import tree_leaves
from audiodec_tpu_torch.utils import bridge

torch.set_num_threads(1)

FFT = 512          # VOC_CONFIG's mel_loss_params fft_sizes
RATIO = 1.25       # the port's op's error within this of XLA's


def _wn64(orig):
    def resolve(d):
        if d["v"].dtype != torch.float32:
            return orig(d)
        return {k: v.float() for k, v in orig(
            {k: v.double() for k, v in d.items()}).items()}
    return resolve


def _mel64(orig):
    def mel(x, **kw):
        if x.dtype != torch.float32:
            return orig(x, **kw)
        return orig(x.double(), **kw).float()
    return mel


def _rfft64(orig):
    def rfft(x, *a, **kw):
        if x.dtype != torch.float32:
            return orig(x, *a, **kw)
        return orig(x.double(), *a, **kw).to(torch.complex64)
    return rfft


def _adam64_step(self, loss, paths=None, axis=None):
    """Optimizer.step with Adam's moments kept and its update computed in
    float64, each param rounded to float32 once after the update."""
    paths = list(self.params) if paths is None else list(paths)
    leaves = [self.params[p] for p in paths]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    group = self.opt.param_groups[0]
    (b1, b2), lr, eps = group["betas"], group["lr"], group["eps"]
    moments = self.__dict__.setdefault("_f64", {})
    with torch.no_grad():
        for p, t, g in zip(paths, leaves, grads):
            g = torch.zeros_like(t) if g is None else g
            m, v, n = moments.get(p, (0.0, 0.0, 0))
            n += 1
            m = b1 * m + (1 - b1) * g.double()
            v = b2 * v + (1 - b2) * g.double() ** 2
            moments[p] = (m, v, n)
            step = lr * (m / (1 - b1 ** n)) / (
                torch.sqrt(v / (1 - b2 ** n)) + eps)
            t.copy_((t.double() - step).float())
    with warnings.catch_warnings():
        # torch.optim.Adam's own step is not called, which its scheduler
        # notices
        warnings.simplefilter("ignore", UserWarning)
        self.sched.step()


@pytest.fixture(scope="module")
def chain_case():
    inputs = T._inputs()
    return next(c for c in T._port_cases(inputs) if c["name"] == "voc_chain")


def _gen(state):
    tree = bridge.vocoder_params_to_jax(bridge.tree_map(
        torch.Tensor.detach, state["gen"]))
    return {p: T._np(t) for p, t in tree_leaves(tree)}


def test_vocoder_chain_op_readings(chain_case, monkeypatch, capsys):
    ref = _gen(T._port_voc_chain(chain_case, torch.float64))
    patches = {
        "as it is": [],
        "weight norm in float64": [(norms, "_resolve_weight_norm",
                                    _wn64(norms._resolve_weight_norm))],
        "log-mel in float64": [(mel_loss, "mel_spectrogram",
                                _mel64(mel_loss.mel_spectrogram))],
        "rfft in float64": [(torch.fft, "rfft", _rfft64(torch.fft.rfft))],
        "Adam in float64": [(optim.Optimizer, "step", _adam64_step)],
    }
    readings = {}
    for name, sets in patches.items():
        with monkeypatch.context() as m:
            for obj, attr, fn in sets:
                m.setattr(obj, attr, fn)
            got = _gen(T._port_voc_chain(chain_case, torch.float32))
        qs = {p: float(np.quantile(np.abs(got[p] - ref[p]), 0.99))
              for p in ref}
        worst = max(qs, key=qs.get)
        at = np.abs(got[T.WITNESS_LEAF] - ref[T.WITNESS_LEAF]).reshape(-1)
        readings[name] = {"at_element": float(at[T.WITNESS_ELEMENT]),
                          "worst_q99": qs[worst], "worst_leaf": worst}
        assert np.isfinite(readings[name]["worst_q99"])
    with capsys.disabled():
        for name, r in readings.items():
            print(f"\nvocoder float32 chain, {name}, against float64: {r}")


def test_rfft_rounds_as_xla_does(capsys):
    """Forward and backward of the f32 rfft at n = 512 on seeded frames:
    relative RMS error against float64, torch's within 1.25x of XLA's."""
    rng = np.random.default_rng(1)
    err = {k: [] for k in ("torch_fwd", "xla_fwd", "torch_bwd", "xla_bwd")}
    for _ in range(8):
        x = rng.standard_normal((64, FFT)).astype(np.float32)
        ct = rng.standard_normal((64, FFT // 2 + 1)).astype(np.float32)
        ref = np.fft.rfft(x.astype(np.float64), axis=-1)
        scale = np.sqrt(np.mean(np.abs(ref) ** 2))
        for k, got in (("torch_fwd", torch.fft.rfft(torch.from_numpy(x))
                        .numpy()),
                       ("xla_fwd", np.asarray(jnp.fft.rfft(jnp.asarray(x))))):
            err[k].append(np.sqrt(np.mean(np.abs(got - ref) ** 2)) / scale)
        grads = {}
        for dt, cdt in ((torch.float32, torch.complex64),
                        (torch.float64, torch.complex128)):
            xt = torch.from_numpy(x).to(dt).requires_grad_(True)
            torch.autograd.backward(torch.fft.rfft(xt),
                                    torch.from_numpy(ct).to(cdt))
            grads[dt] = xt.grad.numpy()
        _, vjp = jax.vjp(jnp.fft.rfft, jnp.asarray(x))
        g_xla = np.asarray(vjp(jnp.asarray(ct, jnp.complex64))[0])
        g64 = grads[torch.float64]
        scale = np.sqrt(np.mean(g64 ** 2))
        for k, got in (("torch_bwd", grads[torch.float32]),
                       ("xla_bwd", g_xla)):
            err[k].append(np.sqrt(np.mean((got - g64) ** 2)) / scale)
    err = {k: float(np.mean(v)) for k, v in err.items()}
    with capsys.disabled():
        print(f"\nrfft at n = {FFT}, relative RMS error against float64: "
              f"{err}")
    assert err["torch_fwd"] <= RATIO * err["xla_fwd"]
    assert err["torch_bwd"] <= RATIO * err["xla_bwd"]


def _rel(got, ref):
    return float(np.sqrt(np.mean((np.asarray(got, np.float64) - ref) ** 2))
                 / np.sqrt(np.mean(ref ** 2)))


def _held(name, err, capsys):
    """err: {output: ([port's], [XLA's])} -> each mean within RATIO."""
    err = {k: (float(np.mean(t)), float(np.mean(x)))
           for k, (t, x) in err.items()}
    with capsys.disabled():
        print(f"\n{name}, relative RMS error against float64 (port, XLA): "
              f"{err}")
    for k, (t, x) in err.items():
        assert t <= RATIO * x, (k, t, x)


@pytest.mark.parametrize("shape", [(32, 32, 3), (32, 16, 10), (1, 32, 7)],
                         ids=lambda s: "x".join(map(str, s)))
def test_weight_norm_rounds_as_xla_does(shape, capsys):
    """`ops/norms.py _resolve_weight_norm` against JAX's on seeded v, g and
    a cotangent of w at the vocoder's conv shapes (torch's orientation, g
    keeping axis 0): w, dv and dg."""
    rng = np.random.default_rng(2)
    err = {k: ([], []) for k in ("w", "dv", "dg")}

    def jax_wn(v, g):
        return jax_norms._resolve_weight_norm({"v": v, "g": g})["w"]

    jax_wn = jax.jit(jax_wn)
    for _ in range(8):
        v = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        g = np.abs(rng.standard_normal((shape[0], 1, 1))).astype(np.float32)
        ct = rng.standard_normal(shape).astype(np.float32)
        got = {}
        for dt in (torch.float32, torch.float64):
            vt = torch.from_numpy(v).to(dt).requires_grad_(True)
            gt = torch.from_numpy(g).to(dt).requires_grad_(True)
            w = norms._resolve_weight_norm({"v": vt, "g": gt})["w"]
            w.backward(torch.from_numpy(ct).to(dt))
            got[dt] = (w.detach().numpy(), vt.grad.numpy(),
                       gt.grad.numpy())
        w, vjp = jax.vjp(jax_wn, jnp.asarray(v), jnp.asarray(g))
        xla = (w, *vjp(jnp.asarray(ct)))
        for k, t, x, r in zip(err, got[torch.float32], xla,
                              got[torch.float64]):
            err[k][0].append(_rel(t, r))
            err[k][1].append(_rel(x, r))
    _held(f"weight norm at {shape}", err, capsys)


def test_log_mel_rounds_as_xla_does(capsys):
    """`ops/spectral.py mel_spectrogram` against JAX's at the chain's mel
    loss (VOC_CONFIG's mel_loss_params) on seeded waveforms and
    cotangents: the log-mel and its vjp to the waveform, over 32 draws
    (over 8 the ratio of the two means still moves by about 0.2)."""
    p = T.VOC_CONFIG["mel_loss_params"]
    kw = dict(fs=p["fs"], fft_size=p["fft_sizes"][0],
              hop_size=p["hop_sizes"][0], win_length=p["win_lengths"][0],
              num_mels=p["num_mels"], fmin=p["fmin"], fmax=p["fmax"],
              log_base=p["log_base"])
    rng = np.random.default_rng(3)
    err = {k: ([], []) for k in ("mel", "dx")}
    jax_mel = jax.jit(lambda a: jax_spectral.mel_spectrogram(a, **kw))
    for _ in range(32):
        x = (0.1 * rng.standard_normal((4, 4800))).astype(np.float32)
        ct = None
        got = {}
        for dt in (torch.float32, torch.float64):
            xt = torch.from_numpy(x).to(dt).requires_grad_(True)
            m = spectral.mel_spectrogram(xt, **kw)
            if ct is None:
                ct = rng.standard_normal(tuple(m.shape)).astype(np.float32)
            m.backward(torch.from_numpy(ct).to(dt))
            got[dt] = (m.detach().numpy(), xt.grad.numpy())
        m, vjp = jax.vjp(jax_mel, jnp.asarray(x))
        xla = (m, vjp(jnp.asarray(ct))[0])
        for k, t, xl, r in zip(err, got[torch.float32], xla,
                               got[torch.float64]):
            err[k][0].append(_rel(t, r))
            err[k][1].append(_rel(xl, r))
    _held("log-mel", err, capsys)


def test_adam_rounds_as_xla_does(capsys):
    """`train/optim.py Optimizer` (the generator's, VOC_CONFIG) against
    JAX's `make_optimizer` on the same gradients: two steps on seeded
    small params, the second gradient nearly cancelling the first's
    moment; the change of the params."""
    config = T.VOC_CONFIG
    rng = np.random.default_rng(4)
    err = {"update": ([], [])}
    tx = jax_optim.make_optimizer(config, "generator")
    jax_update = jax.jit(tx.update)
    for _ in range(8):
        p0 = (1e-3 * rng.standard_normal(4096)).astype(np.float32)
        g1 = (1e-3 * rng.standard_normal(4096)).astype(np.float32)
        g2 = (-g1 + 1e-6 * rng.standard_normal(4096)).astype(np.float32)
        got = {}
        for dt in (torch.float32, torch.float64):
            t = torch.from_numpy(p0).to(dt, copy=True)
            opt = optim.Optimizer(config, "generator", [("p", t)])
            for g in (g1, g2):
                opt.step(torch.sum(t * torch.from_numpy(g).to(dt)))
            got[dt] = t.detach().numpy() - p0.astype(np.float64)
        state, pj = tx.init(jnp.asarray(p0)), jnp.asarray(p0)
        for g in (g1, g2):
            u, state = jax_update(jnp.asarray(g), state, pj)
            pj = pj + u
        ref = got[torch.float64]
        err["update"][0].append(_rel(got[torch.float32], ref))
        err["update"][1].append(_rel(np.asarray(pj, np.float64)
                                     - p0.astype(np.float64), ref))
    _held("Adam", err, capsys)
