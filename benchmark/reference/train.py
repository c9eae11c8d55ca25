"""symAD's adversarial training step in plain float32 PyTorch, on state
dicts in the reference checkpoint's layout.

Written from facebookresearch/AudioDec (trainer/autoencoder.py, the
"efficient" paradigm's adversarial stage; trainer/trainerGAN.py's losses)
and the HiFiGAN discriminators it trains against
(models/vocoder/modules/discriminator.py):

- the generator: encoder, projector and RVQ frozen (eval, no gradient),
  the decoder trained; loss = lambda_mel * mel + lambda_adv * (adversarial
  + lambda_fm * feature matching);
- mel: |STFT| (Hann window, centre reflect padding, sqrt of the power
  clamped at 1e-10), a Slaney mel filterbank (librosa's default), clamped at
  1e-10, natural log; the L1 mean;
- adversarial: sum over discriminators of mean((D(y) - 1)^2); feature
  matching: sum over discriminators and layers but the last of mean |D_l(y)
  - D_l(x)|; discriminator: sum of mean((D(x) - 1)^2) + mean(D(y_)^2), y_
  from the updated decoder;
- MSD: 3 scale discriminators of plain grouped convs, AvgPool1d(4, 2, 2)
  between scales; MPD: per period, the signal reflect-padded to a multiple
  of it and folded, weight-normed (k, 1) convs, LeakyReLU(0.1);
- Adam (torch's formula) on the decoder and on every discriminator leaf
  (the MPD's weight_g and weight_v directly).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import codec as R
from benchmark.reference.layout import Row

SD = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# the discriminators' layout
# ---------------------------------------------------------------------------

def _msd_layers(sp: dict) -> list:
    """[(k, in, out, stride, groups)] of one scale discriminator."""
    ks = sp["kernel_sizes"]
    layers = [(ks[0], sp["in_channels"], sp["channels"], 1, 1)]
    cin, cout, groups = sp["channels"], sp["channels"], 4
    for ds in sp["downsample_scales"]:
        layers.append((ks[1], cin, cout, ds, groups))
        cin = cout
        cout = min(cin * 2, sp["max_downsample_channels"])
        groups = min(groups * 4, sp["max_groups"])
    cout = min(cin * 2, sp["max_downsample_channels"])
    layers.append((ks[2], cin, cout, 1, 1))
    layers.append((ks[3], cout, sp["out_channels"], 1, 1))
    return layers


def _mpd_layers(pp: dict) -> list:
    """[(k, in, out, stride)] of one period discriminator, and its output
    conv's (k2 - 1, in, out)."""
    layers = []
    cin, cout = pp["in_channels"], pp["channels"]
    for ds in pp["downsample_scales"]:
        layers.append((pp["kernel_sizes"][0], cin, cout, ds))
        cin = cout
        cout = min(cout * 4, pp["max_downsample_channels"])
    return layers, (max(pp["kernel_sizes"][1] - 1, 1), cin,
                    pp["out_channels"])


def _msd_key(i: int, j: int, n: int) -> str:
    return f"msd.discriminators.{i}.layers.{j}" + (".conv" if j == n - 1
                                                   else ".0.conv")


def disc_layout(dp: dict) -> List[Row]:
    """The HiFiGAN MSD + MPD state dict: the MSD's convs plain, the MPD's
    weight-normed."""
    rows: List[Row] = []
    sl = _msd_layers(dp["scale_discriminator_params"])
    for i in range(dp["scales"]):
        for j, (k, ci, co, _, g) in enumerate(sl):
            key = _msd_key(i, j, len(sl))
            rows.append(Row(key + ".weight", (co, ci // g, k), "w",
                            ci // g * k, "msd"))
            rows.append(Row(key + ".bias", (co,), "b", 0, "msd"))
    pl, (ok, oi, oo) = _mpd_layers(dp["period_discriminator_params"])
    for i in range(len(dp["periods"])):
        pre = f"mpd.discriminators.{i}"
        shapes = [(f"{pre}.convs.{j}.0.conv", k, ci, co)
                  for j, (k, ci, co, _) in enumerate(pl)]
        shapes.append((f"{pre}.output_conv.conv", ok, oi, oo))
        for key, k, ci, co in shapes:
            rows.append(Row(key + ".weight_g", (co, 1, 1, 1), "g", 0, "mpd"))
            rows.append(Row(key + ".weight_v", (co, ci, k, 1), "v", ci * k,
                            "mpd"))
            rows.append(Row(key + ".bias", (co,), "b", 0, "mpd"))
    return rows


# ---------------------------------------------------------------------------
# the discriminators
# ---------------------------------------------------------------------------

def msd(x, sd: SD, dp: dict) -> list:
    """x (B, 1, T) -> per scale, every layer's output (logits last)."""
    sp = dp["scale_discriminator_params"]
    slope = sp["nonlinear_activation_params"]["negative_slope"]
    pool = dp["scale_downsample_pooling_params"]
    layers = _msd_layers(sp)
    outs = []
    for i in range(dp["scales"]):
        h, maps = x, []
        for j, (k, _, _, stride, groups) in enumerate(layers):
            key = _msd_key(i, j, len(layers))
            h = F.conv1d(h, sd[key + ".weight"], sd[key + ".bias"],
                         stride=stride, padding=(k - 1) // 2, groups=groups)
            if j < len(layers) - 1:
                h = F.leaky_relu(h, slope)
            maps.append(h)
        outs.append(maps)
        x = F.avg_pool1d(x, pool["kernel_size"], pool["stride"],
                         pool["padding"])
    return outs


def _wn(sd: SD, key: str) -> torch.Tensor:
    v = sd[key + ".weight_v"]
    norm = v.flatten(1).norm(dim=1).reshape(-1, 1, 1, 1)
    return sd[key + ".weight_g"] * v / norm


def mpd(x, sd: SD, dp: dict) -> list:
    """x (B, 1, T) -> per period, every layer's output (logits flattened
    last)."""
    pp = dp["period_discriminator_params"]
    slope = pp["nonlinear_activation_params"]["negative_slope"]
    layers, (ok, _, _) = _mpd_layers(pp)
    outs = []
    for i, period in enumerate(dp["periods"]):
        b, c, t = x.shape
        h = x
        if t % period:
            h = F.pad(h, (0, period - t % period), mode="reflect")
        h = h.reshape(b, c, h.shape[-1] // period, period)
        pre, maps = f"mpd.discriminators.{i}", []
        for j, (k, _, _, ds) in enumerate(layers):
            key = f"{pre}.convs.{j}.0.conv"
            h = F.leaky_relu(F.conv2d(h, _wn(sd, key), sd[key + ".bias"],
                                      stride=(ds, 1),
                                      padding=((k - 1) // 2, 0)), slope)
            maps.append(h)
        key = f"{pre}.output_conv.conv"
        h = F.conv2d(h, _wn(sd, key), sd[key + ".bias"],
                     padding=((pp["kernel_sizes"][1] - 1) // 2, 0))
        maps.append(h.flatten(1))
        outs.append(maps)
    return outs


def discriminate(y, sd: SD, dp: dict) -> list:
    return msd(y, sd, dp) + mpd(y, sd, dp)


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------

def slaney_mel(sr: int, n_fft: int, n_mels: int, fmin: float,
               fmax: float) -> np.ndarray:
    """librosa.filters.mel(htk=False, norm="slaney"): (n_mels, 1 + n_fft
    // 2), triangles on the Slaney mel scale (linear below 1 kHz,
    logarithmic above), each of unit area."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4)
                                                              / 27.0)
        return np.where(f >= 1000.0, log, lin)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        lin = m * (200.0 / 3)
        log = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0))
        return np.where(m >= 15.0, log, lin)

    freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    edges = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                  n_mels + 2))
    fb = np.zeros((n_mels, len(freqs)))
    for m in range(n_mels):
        lo, mid, hi = edges[m], edges[m + 1], edges[m + 2]
        up = (freqs - lo) / (mid - lo)
        down = (hi - freqs) / (hi - mid)
        fb[m] = np.maximum(0, np.minimum(up, down)) * 2.0 / (hi - lo)
    return fb


def log_mel(y, mp: dict, fs: int):
    """y (B, 1, T) -> log mel (B, n_mels, frames)."""
    fft, hop, win = mp["fft_sizes"][0], mp["hop_sizes"][0], \
        mp["win_lengths"][0]
    spec = torch.stft(y[:, 0], fft, hop, win,
                      window=torch.hann_window(win, device=y.device),
                      center=True, pad_mode="reflect", return_complex=True)
    amp = torch.sqrt(torch.clamp(spec.real ** 2 + spec.imag ** 2,
                                 min=1e-10))
    fmax = mp["fmax"] if mp["fmax"] is not None else fs / 2
    fb = torch.from_numpy(slaney_mel(fs, fft, mp["num_mels"],
                                     mp["fmin"] or 0.0, fmax)).to(amp)
    return torch.log(torch.clamp(fb @ amp, min=1e-10))


def mel_loss(y_hat, y, cfg: dict):
    return torch.mean(torch.abs(log_mel(y_hat, cfg["mel_loss_params"],
                                        cfg["sampling_rate"])
                                - log_mel(y, cfg["mel_loss_params"],
                                          cfg["sampling_rate"])))


def gen_adv_loss(p_hat) -> torch.Tensor:
    return sum(torch.mean((o[-1] - 1.0) ** 2) for o in p_hat)


def feat_match_loss(p_hat, p) -> torch.Tensor:
    return sum(torch.mean(torch.abs(a - b.detach()))
               for oh, o in zip(p_hat, p) for a, b in zip(oh[:-1], o[:-1]))


def disc_loss(p_hat, p) -> torch.Tensor:
    return (sum(torch.mean((o[-1] - 1.0) ** 2) for o in p)
            + sum(torch.mean(o[-1] ** 2) for o in p_hat))


# ---------------------------------------------------------------------------
# Adam and the step
# ---------------------------------------------------------------------------

class Adam:
    """torch.optim.Adam's update, on named leaves."""

    def __init__(self, params: SD, lr: float, betas, eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, grads: SD):
        self.t += 1
        b1, b2 = self.betas
        for k, g in grads.items():
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(1 - b2 ** self.t)).add_(
                self.eps)
            self.params[k].data.addcdiv_(self.m[k], denom,
                                         value=-self.lr / (1 - b1 ** self.t))


class StepRecord(NamedTuple):
    mel_loss: float
    adversarial_loss: float
    discriminator_loss: float


class Trainer:
    """The adversarial stage from a generator and a discriminator state
    dict (weight norm kept as weight_g / weight_v); `step(x)` takes x (B,
    1, T)."""

    def __init__(self, gen: SD, disc: SD, cfg: dict):
        self.cfg = cfg
        self.gp, self.df = cfg["generator_params"], cfg["code_defaults"]
        self.dp = cfg["discriminator_params"]
        self.gen = {k: v.detach().clone() for k, v in gen.items()}
        self.disc = {k: v.detach().clone().requires_grad_(True)
                     for k, v in disc.items()}
        dec = {k: v.requires_grad_(True) for k, v in self.gen.items()
               if k.startswith("decoder.")}
        go = cfg["generator_optimizer_params"]
        do = cfg["discriminator_optimizer_params"]
        self.gen_opt = Adam(dec, go["lr"], tuple(go["betas"]))
        self.disc_opt = Adam(self.disc, do["lr"], tuple(do["betas"]))
        self.embed = R.codebooks(self.gen, self.gp)

    def _decode(self, x):
        with torch.no_grad():
            z = R.encode(x, self.gen, self.gp, self.df)
            zq = R.rvq_decode(R.rvq_encode(z, self.embed), self.embed)
        return R.decode(zq, self.gen, self.gp, self.df)

    def step(self, x) -> StepRecord:
        cfg = self.cfg
        y = self._decode(x)
        mel = mel_loss(y, x, cfg) * cfg["lambda_mel_loss"]
        p_hat = discriminate(y, self.disc, self.dp)
        with torch.no_grad():
            p = discriminate(x, self.disc, self.dp)
        adv = (gen_adv_loss(p_hat) + cfg["lambda_feat_match"]
               * feat_match_loss(p_hat, p)) * cfg["lambda_adv"]
        keys = list(self.gen_opt.params)
        grads = torch.autograd.grad(mel + adv,
                                    [self.gen_opt.params[k] for k in keys])
        self.gen_opt.step(dict(zip(keys, grads)))
        with torch.no_grad():
            y_ = self._decode(x)
        dloss = disc_loss(discriminate(y_, self.disc, self.dp),
                          discriminate(x, self.disc, self.dp))
        keys = list(self.disc)
        grads = torch.autograd.grad(dloss, [self.disc[k] for k in keys])
        self.disc_opt.step(dict(zip(keys, grads)))
        return StepRecord(mel.item(), adv.item(), dloss.item())
