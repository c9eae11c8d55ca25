"""The port's fused residual stack against the JAX folded kernel.

On the CPU the port's wrapper runs its plain PyTorch version; JAX runs its
Pallas kernel in interpret mode.  The same numpy inputs feed both.  The
CUDA kernel itself is held to the plain version on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiodec_tpu.ops.pallas.folded_stack import (
    folded_residual_stack as jax_stack,
)
from audiodec_tpu_torch.ops.kernels import folded_stack as port

torch.set_num_threads(1)

DILATIONS = (1, 3, 9)


def _case(c, t, seed):
    rng = np.random.default_rng(seed)
    units = [(0.3 * rng.standard_normal((7, c, c)).astype(np.float32),
              0.3 * rng.standard_normal((1, c, c)).astype(np.float32))
             for _ in DILATIONS]
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    return x, units


def _port_units(units):
    # JAX (K, I, O) -> torch (O, I, K)
    return [(torch.from_numpy(w1).permute(2, 1, 0),
             torch.from_numpy(w2).permute(2, 1, 0)) for w1, w2 in units]


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("bf16_dots", [True, False])
@pytest.mark.parametrize("c,t", [(8, 1920), (32, 1920), (8, 1799),
                                 (32, 1799), (8, 50), (32, 50)])
def test_plain_matches_jax_kernel(c, t, bf16_dots, storage):
    x, units = _case(c, t, seed=c + t)
    ref = jax_stack(jnp.asarray(x).astype(storage),
                    tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in units),
                    dilations=DILATIONS, bf16_dots=bf16_dots,
                    interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    xt = torch.from_numpy(x).transpose(1, 2).to(getattr(torch, storage))
    out = port.folded_residual_stack(xt, _port_units(units),
                                     dilations=DILATIONS, bf16_dots=bf16_dots)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    out = out.float().transpose(1, 2).numpy()
    scale = float(np.max(np.abs(ref)))
    if storage == "float32" and not bf16_dots:
        # true f32 on both sides: only the order of the sums differs
        # (tests/test_folded_stack.py:73-75)
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=5e-5 * scale)
    else:
        # bf16 operands or storage: bf16-class error
        # (tests/test_folded_stack.py:89)
        assert float(np.max(np.abs(out - ref))) / scale < 0.03


VOC = {"act": "leaky_relu", "act_param": 0.1}


@pytest.mark.parametrize("kwargs", [
    {"act": "gelu"},
])
def test_off_path_modes_raise(kwargs):
    """An activation the TPU kernel rejects.  (LeakyReLU at k = k2 = 5
    raised here too, but the TPU kernel computes it: it is a parity case of
    the vocoder-mode test below, VOC_CASES; and so do the int8 modes at
    LeakyReLU or k2 = 7 units: parity cases of
    tests/test_torch_int8_stack.py::test_int8_unit_shapes_match_jax.)"""
    x, units = _case(8, 64, seed=0)
    with pytest.raises(NotImplementedError):
        port.folded_residual_stack(torch.from_numpy(x).transpose(1, 2),
                                   _port_units(units), **kwargs)


def test_cpu_call_launches_no_kernel():
    x, units = _case(8, 64, seed=1)
    for bf16_dots in (True, False):
        port.folded_residual_stack(torch.from_numpy(x).transpose(1, 2),
                                   _port_units(units), bf16_dots=bf16_dots)
    assert port.mma_launches == port.resunit_launches == 0


def test_bad_shapes_raise():
    x, units = _case(8, 64, seed=2)
    with pytest.raises(ValueError):
        port.folded_residual_stack(torch.from_numpy(x).transpose(1, 2),
                                   _port_units(units)[:2])
    with pytest.raises(ValueError):
        port.folded_residual_stack(torch.from_numpy(x)[:, :, :4]
                                   .transpose(1, 2), _port_units(units))


# ---------------------------------------------------------------------------
# vocoder mode: LeakyReLU, second conv with k taps, biases
# ---------------------------------------------------------------------------

VOC_DILATIONS = (1, 3, 5)


def _voc_case(c, t, k, bias, seed):
    """Weights scaled to keep the stack near unit size; biases large
    enough that the masking before t=0 shows if it is wrong."""
    rng = np.random.default_rng(seed)
    s = (k * c) ** -0.5
    units = [(s * rng.standard_normal((k, c, c)).astype(np.float32),
              s * rng.standard_normal((k, c, c)).astype(np.float32))
             for _ in VOC_DILATIONS]
    biases = ([(0.5 * rng.standard_normal(c).astype(np.float32),
                0.5 * rng.standard_normal(c).astype(np.float32))
               for _ in VOC_DILATIONS] if bias else None)
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    return x, units, biases


def _port_biases(biases):
    return (None if biases is None else
            [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in biases])


# a half fraction of K x biases x C x T (every pair of levels appears), each
# in true f32; four of them also with bf16 storage or bf16 operands, which
# between them take every level once more (JAX compiles its interpret-mode
# kernel anew for each case, 1.5-10 s on one CPU core); and k = 5, a width
# no shipped config uses, which the TPU kernel takes
VOC_CASES = [(3, True, 8, 1920), (3, True, 32, 1799), (3, False, 8, 1799),
             (3, False, 32, 1920), (11, True, 8, 1799), (11, True, 32, 1920),
             (11, False, 8, 1920), (11, False, 32, 1799), (5, True, 8, 1920)]
VOC_BF16_CASES = [((3, True, 8, 1920), "bfloat16"),
                  ((3, False, 32, 1920), "float32"),
                  ((11, True, 32, 1920), "float32"),
                  ((11, False, 32, 1799), "bfloat16")]


@pytest.mark.parametrize(
    "k,bias,c,t,storage,bf16_dots",
    [(*case, "float32", False) for case in VOC_CASES]
    + [(*case, storage, True) for case, storage in VOC_BF16_CASES])
def test_plain_vocoder_mode_matches_jax_kernel(k, bias, c, t, storage,
                                               bf16_dots):
    x, units, biases = _voc_case(c, t, k, bias, seed=k + c + t)
    ref = jax_stack(
        jnp.asarray(x).astype(storage),
        tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in units),
        dilations=VOC_DILATIONS, kernel_size=k, kernel_size2=k,
        act="leaky_relu", act_param=0.1,
        biases=(None if biases is None else
                tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in biases)),
        bf16_dots=bf16_dots, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    xt = torch.from_numpy(x).transpose(1, 2).to(getattr(torch, storage))
    out = port.folded_residual_stack(
        xt, _port_units(units), dilations=VOC_DILATIONS, kernel_size=k,
        kernel_size2=k, act="leaky_relu", act_param=0.1,
        biases=_port_biases(biases), bf16_dots=bf16_dots)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    out = out.float().transpose(1, 2).numpy()
    scale = float(np.max(np.abs(ref)))
    if not bf16_dots:
        # true f32 on both sides: only the order of the sums differs
        # (tests/test_folded_stack.py:196-197)
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=5e-5 * scale)
    else:
        # bf16 operands or storage: bf16-class error
        assert float(np.max(np.abs(out - ref))) / scale < 0.03


def test_plain_vocoder_mode_masks_before_t0():
    """With biases, each conv's output is zero before t=0: the stack's
    first samples equal those of a longer input cut at the same time,
    and a zero input gives the biases' response only from t=0 on."""
    x, units, biases = _voc_case(8, 64, 3, True, seed=4)
    units, biases = _port_units(units), _port_biases(biases)
    kw = dict(dilations=VOC_DILATIONS, kernel_size=3, kernel_size2=3,
              act="leaky_relu", act_param=0.1, biases=biases,
              bf16_dots=False)
    xt = torch.from_numpy(x).transpose(1, 2)
    full = port.folded_residual_stack(xt, units, **kw)
    part = port.folded_residual_stack(xt[..., :40].contiguous(), units, **kw)
    torch.testing.assert_close(part, full[..., :40], rtol=0, atol=0)
    # by hand, for one unit on a zero input: y(t) = conv2(act(b1)) over the
    # taps at t' >= 0, plus b2
    one = port.folded_residual_stack(torch.zeros(1, 8, 5), units[:1],
                                     **{**kw, "dilations": (1,),
                                        "biases": biases[:1]})
    m = torch.nn.functional.leaky_relu(biases[0][0], 0.1)
    w2 = units[0][1]
    for t in range(5):
        taps = [k for k in range(3) if t - (2 - k) >= 0]
        want = sum(w2[:, :, k] @ m for k in taps) + biases[0][1]
        torch.testing.assert_close(one[0, :, t], want, rtol=1e-5, atol=1e-6)


def test_cpu_vocoder_call_launches_no_kernel():
    x, units, biases = _voc_case(8, 64, 3, True, seed=5)
    port.folded_residual_stack(
        torch.from_numpy(x).transpose(1, 2), _port_units(units),
        dilations=VOC_DILATIONS, kernel_size=3, kernel_size2=3,
        act="leaky_relu", act_param=0.1, biases=_port_biases(biases))
    assert port.mma_voc_launches == 0 and port.resunit_launches == 0


def test_group_slices_hit_the_pack_cache():
    """A grouped resblock's weight slices are new views on every call; two
    views of one storage at one offset share a pack."""
    from audiodec_tpu_torch.models.vocoder import slice_group

    rng = np.random.default_rng(6)
    full = [{"w": torch.from_numpy(rng.standard_normal((24, 8, 3))
                                   .astype(np.float32)),
             "b": torch.zeros(24)} for _ in range(2)]

    def unit_views(g):
        a, b = (slice_group(cv, g, 8) for cv in full)
        return [(a["w"], b["w"])], [(a["b"], b["b"])]

    first = port._packed_unit(*unit_views(1), 8, 16)
    again = port._packed_unit(*unit_views(1), 8, 16)
    assert all(a is b for a, b in zip(first, again))
    other = port._packed_unit(*unit_views(2), 8, 16)
    assert not torch.equal(other[0], first[0])


def test_vocoder_mode_bound():
    """The vocoder mode's bound at AD v1's last stage, per launch: 0.98 GB
    of bf16 activation (0.29 ms at 3.35 TB/s) against 1.04e12 FLOP
    (1.05 ms at 989 TFLOP/s), so bound by operations."""
    from audiodec_tpu_torch.bin import kernel_bounds

    b = kernel_bounds.residual_stack(16, 480000, 32, k=11, k2=11,
                                     storage=2, weight=2, peak="bf16",
                                     bias=True)
    assert abs(b["bytes_ms"] - 0.2935) < 1e-4
    assert abs(b["operations_ms"] - 1.0496) < 1e-4
    assert b["bound_by"] == "operations"
    assert len({r[0] for r in kernel_bounds.rows()}) == 5


# ---------------------------------------------------------------------------
# the autoencoder mode above C = 32 (csrc/resunit_stack.cu on the card), and
# the JAX arguments fold and tile_rows
# ---------------------------------------------------------------------------

def _wide_case(c, t, seed):
    """Weights scaled so the stack's output stays near the JAX test's size
    at every width."""
    rng = np.random.default_rng(seed)
    s = 0.3 / np.sqrt(c / 8)
    units = [(s * rng.standard_normal((7, c, c)).astype(np.float32),
              s * rng.standard_normal((1, c, c)).astype(np.float32))
             for _ in DILATIONS]
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    return x, units


@pytest.mark.parametrize("c,t,fold,storage", [
    (64, 320, 2, "float32"), (64, 320, 4, "bfloat16"),
    (128, 160, 1, "bfloat16"), (128, 160, 2, "float32")])
def test_plain_wide_autoencoder_matches_jax(c, t, fold, storage):
    """bf16 dots at C = 64 and 128, JAX at the probe's folds.  Both round
    the dot operands to bf16, so one f32 ulp of difference (XLA's exp
    against PyTorch's expm1, the order of the sums) moves an operand one
    bf16 step now and then and the next product carries it on (ROADMAP §C,
    the bf16 trap): held in relative L2, within 1e-3 in f32 storage and
    1e-2 in bf16 storage (where a step of the residual itself is a bf16
    ulp), and within 0.03 of the peak everywhere."""
    x, units = _wide_case(c, t, seed=c + t)
    ref = jax_stack(jnp.asarray(x).astype(storage),
                    tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in units),
                    dilations=DILATIONS, bf16_dots=True, fold=fold,
                    interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    xt = torch.from_numpy(x).transpose(1, 2).to(getattr(torch, storage))
    out = port.folded_residual_stack(xt, _port_units(units),
                                     dilations=DILATIONS, bf16_dots=True,
                                     fold=fold, tile_rows=64)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    out = out.float().transpose(1, 2).numpy()
    rl2 = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert rl2 <= (1e-3 if storage == "float32" else 1e-2), rl2
    assert np.abs(out - ref).max() / np.abs(ref).max() < 0.03


def test_fold_and_tile_rows_leave_float_modes_unchanged():
    """In the autoencoder and vocoder modes fold and tile_rows only order
    the TPU kernel's sums: the port accepts them and computes the same."""
    x, units = _wide_case(64, 200, seed=7)
    xt = torch.from_numpy(x).transpose(1, 2)
    base = port.folded_residual_stack(xt, _port_units(units))
    for kw in ({"fold": 8}, {"tile_rows": 16}, {"fold": 1, "tile_rows": 7}):
        assert torch.equal(port.folded_residual_stack(
            xt, _port_units(units), **kw), base)
    xv, uv, bv = _voc_case(8, 64, 3, True, seed=8)
    kw = dict(dilations=VOC_DILATIONS, kernel_size=3, kernel_size2=3,
              act="leaky_relu", act_param=0.1, biases=_port_biases(bv))
    xvt = torch.from_numpy(xv).transpose(1, 2)
    assert torch.equal(
        port.folded_residual_stack(xvt, _port_units(uv), fold=2,
                                   tile_rows=32, **kw),
        port.folded_residual_stack(xvt, _port_units(uv), **kw))


def test_wide_autoencoder_cpu_and_device_checks():
    """On the CPU every width runs the plain version and launches nothing;
    a device with no kernel raises, and so do a negative fold or a
    tile_rows below 1."""
    x, units = _wide_case(256, 40, seed=9)
    xt = torch.from_numpy(x).transpose(1, 2)
    out = port.folded_residual_stack(xt.to(torch.bfloat16),
                                     _port_units(units))
    assert out.dtype == torch.bfloat16 and out.shape == xt.shape
    assert port.wide_launches == port.resunit_launches == 0
    with pytest.raises(ValueError, match="no kernel"):
        port.folded_residual_stack(
            xt.to("meta"), [(a.to("meta"), b.to("meta"))
                            for a, b in _port_units(units)])
    for kw in ({"fold": -2}, {"tile_rows": 0}):
        with pytest.raises(ValueError):
            port.folded_residual_stack(xt, _port_units(units), **kw)


@pytest.mark.parametrize("rounded", [True, False])
def test_packed_resunit_layout(rounded):
    """The weights of the kernels above C = 32: with bf16 operands
    csrc/wide_stack_mma.cu's (n, cp / 64, k, cp / 8, 8, 8, 8) bf16
    [u][c_out / 64][tap][c_in / 8][c_out % 64 / 8][c_out % 8][c_in % 8],
    channels padded to a multiple of 64; in true f32
    csrc/resunit_stack.cu's (n, cp, k, cp) f32 [u][c_in][tap][c_out],
    padded to a multiple of 16; zero in the padding, and the biases f32
    (n, 2, cp) either way."""
    c = 72
    rng = np.random.default_rng(10)
    w1, w2 = (torch.from_numpy(rng.standard_normal((c, c, k))
                               .astype(np.float32)) for k in (7, 1))
    b = [tuple(torch.from_numpy(rng.standard_normal(c).astype(np.float32))
               for _ in range(2))]
    if rounded:
        cp = port.wide_geometry(c, 7, 1, DILATIONS).cp
        p1, p2, pb = port._packed_wide([(w1, w2)], b, c, cp)
        assert cp == 128 and p1.dtype == p2.dtype == torch.bfloat16
        assert p1.shape == (1, cp // 64, 7, cp // 8, 8, 8, 8)
        assert p2.shape == (1, cp // 64, 1, cp // 8, 8, 8, 8)
        full = p1[0].permute(1, 0, 3, 4, 2, 5).reshape(7, cp, cp)
        want, real = w1.permute(2, 0, 1).bfloat16(), full[:, :c, :c]
    else:
        cp = port.unit_geometry(c, 7, 1, DILATIONS).cp
        p1, p2, pb = port._packed_unit([(w1, w2)], b, c, cp)
        assert cp == 80 and p1.dtype == p2.dtype == torch.float32
        assert p1.shape == (1, cp, 7, cp) and p2.shape == (1, cp, 1, cp)
        want, real = w1.permute(1, 2, 0), p1[0, :c, :, :c]
    assert torch.equal(real, want)
    assert p1.float().abs().sum() == real.float().abs().sum()
    assert pb.shape == (1, 2, cp) and pb.dtype == torch.float32
    assert torch.equal(pb[0, 1, :c], b[0][1]) and not pb[:, :, c:].any()
