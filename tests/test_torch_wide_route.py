"""The bf16 vocoder's resblocks above C = 32 on csrc/wide_stack_mma.cu, and
the kernel's walk through time, on the CPU.

The route (models/fast.py `_voc_use_wide`): a bf16 vocoder's stages above
C = 32 send each resblock, in both fusion forms, to
`folded_residual_stack` with the vocoder's units, which on the CPU runs
its plain version; an f32 vocoder and the symAD decoder keep their routes;
the wide route counts nothing in B1's vocoder-mode counters.

The kernel runs only on the card, where chip_smoke.py holds it to its
plain version.  Here `emulate` follows its walk step by step with numpy:
the work items and the warm tile of wide_split, the operand restaged with
its look-back from a multiple of 4 samples, a2's look-back carried from
tile to tile, each wgmma's
operands read through their shared-memory descriptors (the bytes the
packed weights and the staged rows put there), a stage's products summed
apart, and the epilogues; the rows the kernel must not read hold NaN.  It
matches the plain version within the bf16 operands' class, so the layout,
the descriptors' strides and the tile walk agree with the arithmetic.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from audiodec_tpu_torch.models import fast, vocoder
from audiodec_tpu_torch.models.autoencoder import GeneratorConfig
from audiodec_tpu_torch.models.vocoder import VocoderConfig
from audiodec_tpu_torch.ops.kernels import folded_stack as port

torch.set_num_threads(1)

# the bf16 class of a vocoder decode (tests/test_torch_vocoder.py): max
# error within 3e-2 of the peak
BF16_CLASS = 3e-2
# a stack's relative L2 from its plain version (chip_smoke.py WIDE_RL2)
WIDE_RL2 = 1e-3
# small vocoders with one stage above C = 32 (C = 64, 32, 16, 8)
GROUPED = dict(in_channels=8, channels=128, upsample_scales=(2, 2, 2, 2),
               upsample_kernel_sizes=(4, 4, 4, 4), resblock_kernel_sizes=(11,),
               resblock_dilations=((1, 3, 5),), groups=3)
MRF = dict(in_channels=8, channels=128, upsample_scales=(2, 2, 2, 2),
           upsample_kernel_sizes=(4, 4, 4, 4))


def _bf16_params(p):
    if isinstance(p, dict):
        return {k: _bf16_params(v) for k, v in p.items()}
    if isinstance(p, list):
        return [_bf16_params(v) for v in p]
    return p.to(torch.bfloat16)


def _vocoder(kw, seed=0):
    cfg = VocoderConfig(**kw)
    p = vocoder.vocoder_init(cfg, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    # weights that keep the activations near unit size, and biases
    for i, blk in enumerate(p["blocks"]):
        for rb in ([blk] if cfg.grouped else blk["blocks"]):
            for conv in rb["convs1"] + rb["convs2"]:
                w = conv["w"]
                conv["w"] = torch.randn(w.shape, generator=gen) / (
                    w.shape[1] * w.shape[2]) ** 0.5
                conv["b"] = 0.3 * torch.randn(w.shape[0], generator=gen)
    return cfg, p


def _spy(monkeypatch):
    calls = []
    real = fast.folded_residual_stack

    def spy(x, units, **kw):
        calls.append((x.shape[1], x.dtype, kw.get("act", "elu"),
                      kw["kernel_size"], kw.get("kernel_size2", 1),
                      tuple(kw["dilations"]), kw.get("biases") is not None))
        return real(x, units, **kw)

    monkeypatch.setattr(fast, "folded_residual_stack", spy)
    return calls


@pytest.mark.parametrize("kw,ks", [(GROUPED, (11, 11, 11)),
                                   (MRF, (3, 7, 11))], ids=["grouped", "mrf"])
def test_bf16_fusion_above_32_takes_the_stack(kw, ks, monkeypatch):
    """A bf16 fusion block at C = 64: each resblock goes to
    folded_residual_stack with the vocoder's units (LeakyReLU at the
    config's slope, biases, k = k2 = its size, its dilations), and the
    block matches the plain cuDNN-style route within the bf16 class."""
    cfg, p = _vocoder(kw)
    blk = _bf16_params(p["blocks"][0])
    x = torch.randn(2, 64, 96, generator=torch.Generator().manual_seed(5)
                    ).to(torch.bfloat16)
    assert fast._voc_use_wide(cfg, x)
    calls = _spy(monkeypatch)
    y = fast._voc_fusion_auto(blk, x, cfg)
    assert [c[3] for c in calls] == list(ks)
    assert all(c[:3] == (64, torch.bfloat16, "leaky_relu") and c[3] == c[4]
               and c[5] == (1, 3, 5) and c[6] for c in calls)
    ref = vocoder._fusion_apply(blk, x, cfg)
    assert y.dtype == ref.dtype == torch.bfloat16
    err = float((y.float() - ref.float()).abs().max())
    assert err < BF16_CLASS * float(ref.float().abs().max()), err


@pytest.mark.parametrize("kw", [GROUPED, MRF], ids=["grouped", "mrf"])
def test_bf16_vocoder_decode_on_the_wide_route(kw, monkeypatch):
    """The whole bf16 decode (vocoder_apply_folded): the stage above C = 32
    through the stack, the narrower ones on B1's rule, and the waveform
    within the bf16 class of the plain route's."""
    cfg, p = _vocoder(kw, seed=3)
    pb = _bf16_params(p)
    c = 0.5 * torch.randn(2, 12, 8, generator=torch.Generator().manual_seed(6))
    calls = _spy(monkeypatch)
    y = fast.vocoder_apply_folded(pb, c.to(torch.bfloat16), cfg)
    n = 3 if cfg.grouped else len(cfg.resblock_kernel_sizes)
    assert [cl[0] for cl in calls][:n + 1] == [64] * n + [32]
    ref = vocoder.vocoder_apply(pb, c.to(torch.bfloat16), cfg)
    err = float((y.float() - ref.float()).abs().max())
    assert err < BF16_CLASS * float(ref.float().abs().max()), err


def test_f32_vocoder_and_symad_decoder_keep_their_routes(monkeypatch):
    """An f32 vocoder keeps JAX's rule (plain convs above C = 32), and the
    symAD decoder in bf16 keeps its plain stacks above C = 32."""
    cfg, p = _vocoder(GROUPED)
    x = torch.randn(1, 64, 64, generator=torch.Generator().manual_seed(2))
    assert not fast._voc_use_wide(cfg, x)
    calls = _spy(monkeypatch)
    plain = []
    real = fast._fusion_apply
    monkeypatch.setattr(fast, "_fusion_apply",
                        lambda *a: plain.append(a[1].shape[1]) or real(*a))
    fast._voc_fusion_auto(p["blocks"][0], x, cfg)
    assert calls == [] and plain == [64]

    gcfg = GeneratorConfig(encode_channels=4, decode_channels=8,
                           code_dim=16, codebook_num=2, codebook_size=16)
    from audiodec_tpu_torch.models.autoencoder import generator_init
    params = _bf16_params(generator_init(gcfg,
                                         torch.Generator().manual_seed(0)))
    z = torch.randn(1, 6, 16).to(torch.bfloat16)
    fast.decoder_apply_folded(params["decoder"], z, gcfg)
    assert calls and all(ch <= 32 for ch, *_ in calls)
    assert max(gcfg.decode_channels * r for r in gcfg.dec_ratios) > 32


def test_the_wide_route_counts_nothing_in_b1(monkeypatch):
    """B1's vocoder-mode counters (`mma_voc_launches`, by k) count B1
    alone: the wide route's calls, the kernel stubbed, leave them as they
    were (mrf_stack_roofline multiplies its bound by them)."""
    launched = []

    def kernel(*args):
        launched.append(args)
        return 0

    monkeypatch.setattr(port, "_wide_kernel", lambda: kernel)
    monkeypatch.setattr(port, "_sm_count", lambda index: 132)
    monkeypatch.setattr(port, "mma_voc_launches_by_k", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))

    def via_kernel(x, units, *, dilations, kernel_size, kernel_size2, act,
                   act_param, biases, bf16_dots):
        mode = port._mode(kernel_size, kernel_size2, act, biases, False)
        assert mode == "vocoder"
        assert port.route(mode, x.shape[1], True, bf16_dots) == "wide"
        return port._wide_stack(x, units, dilations, act, act_param, biases,
                                "")

    monkeypatch.setattr(fast, "folded_residual_stack", via_kernel)
    before = port.mma_voc_launches
    cfg, p = _vocoder(MRF)
    x = torch.zeros(1, 64, 64, dtype=torch.bfloat16)
    fast._voc_fusion_auto(_bf16_params(p["blocks"][0]), x, cfg)
    assert len(launched) == 3
    assert port.mma_voc_launches_by_k == {} and port.mma_voc_launches == before


# ---------------------------------------------------------------------------
# the kernel's walk, emulated
# ---------------------------------------------------------------------------

def _bf(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _act(v, act, slope, bf16):
    if act == "leaky_relu":
        return np.where(v > 0, v, np.float32(slope) * v).astype(np.float32)
    e = (np.exp(np.minimum(v, 0)) - 1 if bf16
         else np.expm1(np.minimum(v, 0)))
    return np.where(v > 0, v, e).astype(np.float32)


def _desc(buf, start, lbo, sbo, rows):
    """The rows x 16 operand a K-major, unswizzled shared-memory descriptor
    reads from `buf` (bf16 elements; byte addresses): element (r, k) at
    start + (k // 8) lbo + (r // 8) sbo + (r % 8) 16 + (k % 8) 2."""
    r = np.arange(rows)[:, None]
    k = np.arange(16)[None, :]
    addr = start + (k // 8) * lbo + (r // 8) * sbo + (r % 8) * 16 + (k % 8) * 2
    assert (addr % 2 == 0).all()
    return buf[addr // 2]


def emulate(x, units, dilations, act="leaky_relu", slope=0.1, biases=None,
            sms=5):
    """csrc/wide_stack_mma.cu's walk in numpy at wide_geometry and
    wide_split's choices (see the module docstring)."""
    b, c, t = x.shape
    k, k2 = units[0][0].shape[-1], units[0][1].shape[-1]
    g = port.wide_geometry(c, k, k2, dilations)
    sp = port.wide_split(g, b, t, sms)
    w1, w2, bias = port._pack_wide(units, biases, c, g.cp, True)
    bf16 = x.dtype == torch.bfloat16
    cp, r_, n = g.cp, g.tile, g.n
    kc, nob = port.WIDE_KC, g.cp // port.WIDE_M
    nkb = g.cp // kc
    yr = r_ + (k - 1) * max(dilations) + port.WIDE_ALIGN
    ar = r_ + k2 - 1
    src = x.float().numpy()
    for u, d in enumerate(dilations):
        last = u == len(dilations) - 1
        out = np.full_like(src, np.nan)
        flat = (w1[u].float().numpy().ravel(), w2[u].float().numpy().ravel())
        bs = (np.zeros((2, cp), np.float32) if bias is None
              else bias[u].numpy())
        h1 = (k - 1) * d
        # a block's buffers: stale rows hold NaN
        y = np.full((cp // 8) * yr * 8, np.nan, np.float32)
        a2 = np.full((cp // 8) * ar * 8, np.nan, np.float32)

        def conv(op, orows, wflat, taps, step, ob):
            acc = np.zeros((port.WIDE_M, r_), np.float32)
            for j in range(taps):
                for kb in range(nkb):
                    off = ((ob * taps + j) * (cp // 8) + kb * (kc // 8)) * 512
                    stage = wflat[off:off + port.WIDE_M * kc]
                    for wg in range(g.warpgroups):
                        xb = (kb * (kc // 8) * orows + wg * n + j * step) * 16
                        dd = np.zeros((port.WIDE_M, n), np.float32)
                        for kk in range(kc // 16):
                            a = _desc(stage, kk * 2048, 1024, 128,
                                      port.WIDE_M)
                            bm = _desc(op, xb + kk * 2 * orows * 16,
                                       orows * 16, 128, n)
                            dd = dd + a @ bm.T
                        acc[:, wg * n:(wg + 1) * n] += dd
            return acc

        for item in range(b * sp.nseg):
            bb, lo = item // sp.nseg, (item % sp.nseg) * sp.seg
            hi = min(t, lo + sp.seg)
            if lo == 0:
                a2.reshape(cp // 8, ar, 8)[:, :k2 - 1] = 0
            for t0 in range(lo - r_ if lo > 0 else lo, hi, r_):
                warm = t0 < lo
                ys = y.reshape(cp // 8, yr, 8)
                # rows from t0 - h1 rounded down to a multiple of 4
                ta = (t0 - h1) & ~3
                yoff = t0 - h1 - ta
                nr = r_ + h1 + yoff
                tt = ta + np.arange(nr)
                live = (tt >= 0) & (tt < t)
                v = np.zeros((cp, nr), np.float32)
                v[:c, live] = src[bb][:, tt[live]]
                ys[:, :nr] = _bf(_act(v, act, slope, bf16)).reshape(
                    cp // 8, 8, nr).transpose(0, 2, 1)
                a2s = a2.reshape(cp // 8, ar, 8)
                for ob in range(nob):
                    acc = conv(y[yoff * 8:], yr, flat[0], k, d, ob)
                    o = ob * port.WIDE_M + np.arange(port.WIDE_M)
                    val = _bf(_act(acc + bs[0][o][:, None], act, slope, bf16))
                    a2s[o // 8, k2 - 1:k2 - 1 + r_, o % 8] = val
                if not warm:
                    for ob in range(nob):
                        acc = conv(a2, ar, flat[1], k2, 1, ob)
                        o = ob * port.WIDE_M + np.arange(port.WIDE_M)
                        yv = acc + bs[1][o][:, None]
                        keep = (o < c)[:, None] & (t0 + np.arange(r_) < t)
                        ts = t0 + np.arange(r_)
                        for i, oi in enumerate(o[o < c]):
                            cols = ts[keep[i]]
                            xv = src[bb, oi, cols]
                            yy = yv[i, keep[i]]
                            out[bb, oi, cols] = (_bf(xv) + _bf(yy) if bf16
                                                 else xv + yy)
                if t0 + r_ < hi:
                    a2s[:, :k2 - 1] = a2s[:, r_:r_ + k2 - 1]
        src = _bf(out) if (bf16 and last) else out
    return torch.from_numpy(src).to(x.dtype)


def _units(c, k, k2, n, seed, bias=True):
    gen = torch.Generator().manual_seed(seed)
    units = tuple((torch.randn(c, c, k, generator=gen) / (k * c) ** 0.5,
                   torch.randn(c, c, k2, generator=gen) / (k2 * c) ** 0.5)
                  for _ in range(n))
    biases = (tuple((0.5 * torch.randn(c, generator=gen),
                     0.5 * torch.randn(c, generator=gen)) for _ in range(n))
              if bias else None)
    return units, biases


@pytest.mark.parametrize("c,k,k2,dil,act,t,dtype", [
    (64, 11, 11, (1, 3, 5), "leaky_relu", 704, torch.bfloat16),
    (64, 11, 11, (1, 3, 5), "leaky_relu", 700, torch.float32),
    (48, 3, 3, (1, 3, 5), "leaky_relu", 333, torch.float32),
    (128, 7, 7, (1, 3, 5), "leaky_relu", 301, torch.bfloat16),
    (96, 7, 1, (1, 3, 9), "elu", 517, torch.float32),
    (64, 7, 1, (1, 3, 9), "elu", 40, torch.bfloat16),
], ids=["voc_k11", "voc_k11_t700", "voc_k3_f32", "voc_k7_c128", "ae_c96",
        "ae_short"])
def test_emulated_walk_matches_plain(c, k, k2, dil, act, t, dtype):
    """The kernel's walk (emulate) against folded_residual_stack_plain:
    several segments a row, each after the first with its warm tile, a
    row's last tile past T, channels padded to 64; within the bf16
    operands' relative L2 class and no stale row read (no NaN)."""
    units, biases = _units(c, k, k2, len(dil), seed=c + k + t,
                           bias=act == "leaky_relu")
    x = torch.randn(2, c, t, generator=torch.Generator().manual_seed(t)
                    ).to(dtype)
    g = port.wide_geometry(c, k, k2, dil)
    if t > 2 * g.tile:
        assert port.wide_split(g, 2, t, 5).nseg > 1
    out = emulate(x, units, dil, act=act, biases=biases)
    ref = port.folded_residual_stack_plain(x, units, dil, True, act=act,
                                           act_param=0.1, biases=biases)
    assert out.dtype == ref.dtype and torch.isfinite(out.float()).all()
    o, r = out.double(), ref.double()
    rl2 = float(((o - r) ** 2).sum() / (r ** 2).sum()) ** 0.5
    assert rl2 < WIDE_RL2, rl2


@pytest.mark.parametrize("c,k,k2", [(48, 11, 11), (200, 3, 1)])
def test_wide_pack_layout(c, k, k2):
    """_pack_wide: weight (o, i, tap) of unit u at [u, o // 64, tap, i // 8,
    (o % 64) // 8, o % 8, i % 8], bf16, zero on the padding."""
    units, biases = _units(c, k, k2, 2, seed=c)
    cp = -(-c // port.WIDE_M) * port.WIDE_M
    w1, w2, bias = port._pack_wide(units, biases, c, cp, True)
    assert w1.shape == (2, cp // 64, k, cp // 8, 8, 8, 8)
    assert w2.shape == (2, cp // 64, k2, cp // 8, 8, 8, 8)
    assert w1.dtype == torch.bfloat16 and bias.shape == (2, 2, cp)
    rng = np.random.default_rng(0)
    for _ in range(20):
        o, i, j = (int(rng.integers(c)), int(rng.integers(c)),
                   int(rng.integers(k)))
        assert w1[1, o // 64, j, i // 8, (o % 64) // 8, o % 8, i % 8] == \
            units[1][0][o, i, j].to(torch.bfloat16)
    full = w1.float().permute(0, 1, 4, 5, 2, 3, 6).reshape(2, cp, k, cp)
    assert not full[:, c:].any() and not full[..., c:].any()
