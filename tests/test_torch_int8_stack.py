"""The port's int8 residual stack (plain version) against the JAX folded
kernel's int8 mode ("row" scales), in interpret mode.

The CUDA kernel (csrc/int8_mma_stack.cu) is held to the plain version on
the card by chip_smoke.py.

Tolerance against JAX.  The two do not agree bit for bit: XLA's f32 exp
differs from PyTorch's by an ulp on part of the arguments, and XLA fuses
some of the kernel's multiply-adds differently.  Where no int8 code moves,
that leaves an f32-rounding difference (about 1e-7 of the output's peak,
bound 1e-5 of it).  Where an ulp lands on a rounding boundary of the
quantizer, one activation's int8 code moves by one step, 1/127 of its
row's peak, and that step runs on through the later units.  So one unit
must agree within 1e-5 of the peak on 95% of its outputs, and every output
of one unit or of the whole stack within 1e-2 of the peak; a wrong scale
grouping or rounding misses the first bound on most outputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiodec_tpu.models.autoencoder import GeneratorConfig as JaxConfig
from audiodec_tpu.models.autoencoder import generator_init
from audiodec_tpu.models import fast as jax_fast
from audiodec_tpu.ops.pallas.folded_stack import fold_conv_weight
from audiodec_tpu.ops.pallas.folded_stack import (
    folded_residual_stack as jax_stack,
)
from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    res_stack_plain,
)
from audiodec_tpu_torch.models import fast
from audiodec_tpu_torch.ops.kernels import folded_stack as port
from audiodec_tpu_torch.utils.bridge import params_from_jax

torch.set_num_threads(1)

DILATIONS = (1, 3, 9)
T = 203           # not a multiple of any F
NEAR, STEP, SHARE = 1e-5, 1e-2, 0.95


def _case(c, t, dilations, seed, x_scale=1.0):
    rng = np.random.default_rng(seed)
    units = [((rng.standard_normal((7, c, c)) / np.sqrt(7 * c))
              .astype(np.float32),
              (rng.standard_normal((1, c, c)) / np.sqrt(c))
              .astype(np.float32)) for _ in dilations]
    x = (x_scale * rng.standard_normal((2, t, c))).astype(np.float32)
    return x, units


def _port_units(units):
    # JAX (K, I, O) -> torch (O, I, K)
    return [(torch.from_numpy(w1).permute(2, 1, 0),
             torch.from_numpy(w2).permute(2, 1, 0)) for w1, w2 in units]


def _run_both(x, units, dilations):
    ref = np.asarray(jax_stack(
        jnp.asarray(x), tuple((jnp.asarray(a), jnp.asarray(b))
                              for a, b in units),
        dilations=dilations, int8_dots=True, interpret=True))
    out = port.folded_residual_stack(
        torch.from_numpy(x).transpose(1, 2).contiguous(), _port_units(units),
        dilations=dilations, int8_dots=True)
    assert out.dtype == torch.float32 and tuple(out.shape) == (
        x.shape[0], x.shape[2], x.shape[1])
    return out.transpose(1, 2).numpy(), ref


@pytest.mark.parametrize("dilations", [(9,), DILATIONS])
@pytest.mark.parametrize("c", [32, 64, 128, 256])
def test_plain_matches_jax_int8_kernel(c, dilations):
    """Every fold F = 4, 2, 1, 1; T = 203 leaves a partial last row."""
    x, units = _case(c, T, dilations, seed=c)
    out, ref = _run_both(x, units, dilations)
    peak = float(np.abs(ref).max())
    err = np.abs(out - ref)
    assert err.max() <= STEP * peak
    if len(dilations) == 1:
        assert (err <= NEAR * peak).mean() >= SHARE


@pytest.mark.parametrize("c,fold,storage,dilations", [
    (32, 8, "float32", (9,)), (32, 16, "bfloat16", DILATIONS),
    (64, 4, "bfloat16", (9,)), (64, 8, "float32", DILATIONS),
    (128, 2, "bfloat16", DILATIONS)])
def test_plain_matches_jax_int8_kernel_at_fold(c, fold, storage, dilations):
    """The row scales at the probe's other folds (f * C = 256, 512), in f32
    and bf16 storage (where the residual is rounded as XLA rounds it:
    `storage_residual`), to the bounds above."""
    x, units = _case(c, T, dilations, seed=c + fold)
    ref = np.asarray(jax_stack(
        jnp.asarray(x).astype(storage),
        tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in units),
        dilations=dilations, int8_dots=True, fold=fold,
        interpret=True).astype(jnp.float32))
    xt = torch.from_numpy(x).transpose(1, 2).contiguous() \
        .to(getattr(torch, storage))
    out = port.folded_residual_stack(xt, _port_units(units),
                                     dilations=dilations, int8_dots=True,
                                     fold=fold, tile_rows=64)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    err = np.abs(out.float().transpose(1, 2).numpy() - ref)
    peak = float(np.abs(ref).max())
    assert err.max() <= STEP * peak
    if len(dilations) == 1:
        assert (err <= NEAR * peak).mean() >= SHARE


_jax_elu_jit = jax.jit(
    lambda v: jnp.where(v > 0, v, jnp.exp(jnp.minimum(v, 0.0)) - 1.0))


def _jax_elu(v: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's ELU with XLA's exp, on the CPU."""
    return torch.from_numpy(np.array(_jax_elu_jit(v.numpy())))


# (int8_scale, act, k, k2, biases, storage, C): the unit shapes the TPU
# kernel's int8 modes take beyond the int8 decode's, which the port's
# plain versions now compute; the last two were cases of
# test_torch_folded_stack.py::test_off_path_modes_raise
UNIT_SHAPES = [
    ("row", "leaky_relu", 3, 3, True, "float32", 32),
    ("tile", "leaky_relu", 3, 3, True, "float32", 32),
    ("row", "elu", 7, 3, False, "float32", 32),
    ("tile", "elu", 7, 3, False, "float32", 32),
    ("row", "leaky_relu", 3, 3, True, "bfloat16", 64),
    ("tile", "elu", 7, 3, False, "bfloat16", 64),
    ("row", "leaky_relu", 7, 7, False, "float32", 8),
    ("row", "elu", 7, 7, False, "float32", 8),
]


@pytest.mark.parametrize("scale,act,k,k2,bias,storage,c", UNIT_SHAPES)
def test_int8_unit_shapes_match_jax(scale, act, k, k2, bias, storage, c,
                                    monkeypatch):
    """The int8 modes at LeakyReLU (slope 0.1) and k2 > 1 units, with
    biases, against JAX's interpret-mode kernel (`folded_stack.py:293-368`:
    the second conv's own row or tile scales over `_fold_offsets(k2, 1,
    f)`, the bias added after the weight scale and masked before t=0).
    To the bounds above; with JAX's exp in the port's ELU the tile mode is
    bit-equal, and the row mode within 1e-5 of the peak on 95% of outputs
    (XLA fuses some multiply-adds of the row mode otherwise)."""
    dil = (1, 3, 5)
    t = 300
    rng = np.random.default_rng(c + k + k2)
    units = [((rng.standard_normal((k, c, c)) / np.sqrt(k * c))
              .astype(np.float32),
              (rng.standard_normal((k2, c, c)) / np.sqrt(k2 * c))
              .astype(np.float32)) for _ in dil]
    biases = ([tuple((0.3 * rng.standard_normal(c)).astype(np.float32)
                     for _ in range(2)) for _ in dil] if bias else None)
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    kw = dict(dilations=dil, kernel_size=k, kernel_size2=k2, act=act,
              act_param=0.1 if act == "leaky_relu" else 0.0, int8_dots=True,
              int8_scale=scale, tile_rows=64)
    ref = np.asarray(jax_stack(
        jnp.asarray(x).astype(storage),
        tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in units),
        biases=None if biases is None else tuple(
            (jnp.asarray(a), jnp.asarray(b)) for a, b in biases),
        interpret=True, **kw).astype(jnp.float32))
    xt = torch.from_numpy(x).transpose(1, 2).contiguous() \
        .to(getattr(torch, storage))
    pb = None if biases is None else [
        (torch.from_numpy(a), torch.from_numpy(b)) for a, b in biases]

    def run():
        out = port.folded_residual_stack(xt, _port_units(units), biases=pb,
                                         **kw)
        assert out.dtype == xt.dtype and out.shape == xt.shape
        return out.float().transpose(1, 2).numpy()

    peak = float(np.abs(ref).max())
    assert np.abs(run() - ref).max() <= STEP * peak
    monkeypatch.setattr(port, "elu_exp", _jax_elu)
    out = run()
    if scale == "tile":
        np.testing.assert_array_equal(out, ref)
    else:
        assert (np.abs(out - ref) <= NEAR * peak).mean() >= SHARE


@pytest.mark.parametrize("c", [2, 3, 264])
@pytest.mark.parametrize("scale", ["row", "tile"])
def test_int8_widths_match_jax(scale, c, monkeypatch):
    """Any width C >= 1: both int8 modes at C = 2, 3 and 264 (outside the
    4..256 the port took before; JAX's kernel takes any C), two units,
    T = 64, f32 storage, against JAX's interpret-mode kernel, to the bounds
    above; with JAX's exp the tile mode is bit-equal and the row mode
    within 1e-5 of the peak on 95% of outputs."""
    dil = (1, 3)
    rng = np.random.default_rng(c)
    units = [((rng.standard_normal((7, c, c)) / np.sqrt(7 * c))
              .astype(np.float32),
              (rng.standard_normal((1, c, c)) / np.sqrt(c))
              .astype(np.float32)) for _ in dil]
    x = rng.standard_normal((2, 64, c)).astype(np.float32)
    kw = dict(dilations=dil, int8_dots=True, int8_scale=scale, tile_rows=16)
    ref = np.asarray(jax_stack(
        jnp.asarray(x), tuple((jnp.asarray(a), jnp.asarray(b))
                              for a, b in units), interpret=True, **kw))
    xt = torch.from_numpy(x).transpose(1, 2).contiguous()

    def run():
        out = port.folded_residual_stack(xt, _port_units(units), **kw)
        assert out.dtype == xt.dtype and out.shape == xt.shape
        return out.transpose(1, 2).numpy()

    peak = float(np.abs(ref).max())
    assert np.abs(run() - ref).max() <= STEP * peak
    monkeypatch.setattr(port, "elu_exp", _jax_elu)
    out = run()
    if scale == "tile":
        np.testing.assert_array_equal(out, ref)
    else:
        assert (np.abs(out - ref) <= NEAR * peak).mean() >= SHARE


def test_plain_close_to_f32_chain():
    """The JAX test's bar (tests/test_folded_stack.py:240-266): with the
    JAX init's weights the int8 stack is within 2e-3 of the f32 chain at
    C=32 (fold 4) and C=64 (fold 2)."""
    jcfg = JaxConfig()
    jp = jax.tree_util.tree_map(np.asarray,
                                generator_init(jax.random.PRNGKey(0), jcfg))
    params = params_from_jax(jp)
    cfg = GeneratorConfig()
    for bi, scale in ((0, 1.0), (1, 4.0)):
        bp = params["encoder"]["blocks"][bi]
        c = bp["res"][0]["conv1"]["w"].shape[0]
        x = torch.from_numpy(scale * np.random.default_rng(bi)
                             .standard_normal((2, c, 900))
                             .astype(np.float32))
        ref = res_stack_plain(x, bp, cfg)
        out = port.folded_residual_stack(x, port.res_stack_params(bp),
                                         int8_dots=True)
        rel = float((out - ref).abs().max() / ref.abs().max())
        assert rel < 2e-3, f"C={c}: int8 rel err {rel:.2e}"


def test_row_outlier_needs_row_scales(monkeypatch):
    """One large value in a folded row of F = 4 samples coarsens the codes
    of the whole row.  The plain version agrees with JAX; the same
    arithmetic with one scale per sample does not."""
    x, units = _case(32, 64, (1,), seed=5)
    x[:, 21, 3] = 60.0          # row 5 holds samples 20..23
    out, ref = _run_both(x, units, (1,))
    peak = float(np.abs(ref).max())
    assert np.abs(out - ref).max() <= NEAR * peak
    monkeypatch.setattr(port, "int8_fold", lambda c: 1)
    per_sample = port.folded_residual_stack(
        torch.from_numpy(x).transpose(1, 2).contiguous(), _port_units(units),
        dilations=(1,), int8_dots=True).transpose(1, 2).numpy()
    assert np.abs(per_sample - ref)[:, 20:24].max() > 100 * NEAR * peak


@jax.jit
def _jax_weight_scale(wf):
    # the TPU kernel's expression (folded_stack.py:231-233), compiled as it
    # is inside the jitted folded_residual_stack: XLA turns the division by
    # the constant 127 into a product with its f32 reciprocal
    return jnp.maximum(jnp.max(jnp.abs(wf), axis=(0, 1)), 1e-12) / 127.


@pytest.mark.parametrize("c", [32, 128])
def test_weight_scales_match_jax(c):
    """Per output channel: the JAX kernel's per-lane absmax over all folded
    offset planes (folded_stack.py:230-238) gives the same scale in every
    lane of a channel, equal to the port's; at F = 1 the folded planes are
    the taps, so the int8 weights match too."""
    _, units = _case(c, 8, (3,), seed=c + 1)
    w1 = units[0][0]
    f = port.int8_fold(c)
    wf = fold_conv_weight(jnp.asarray(w1), 3, f)
    s_jax = np.asarray(_jax_weight_scale(wf))
    q, s = port.int8_weight_scales(torch.from_numpy(w1).permute(2, 1, 0))
    np.testing.assert_array_equal(s_jax.reshape(f, c),
                                  np.tile(s.numpy(), (f, 1)))
    if f == 1:
        q_jax = np.asarray(jnp.round(wf / s_jax))
        np.testing.assert_array_equal(q_jax, q.permute(2, 1, 0).numpy())
    assert float(q.abs().max()) == 127.0


@pytest.mark.parametrize("c", [4, 12, 32])
def test_packed_int8_layout(c):
    """The "tile" kernel's pack (csrc/int8_tile_mma.cu): conv1 (n, K,
    cp/32, cp/8, 32, 8) and the 1x1 conv (n, 1, ...) int8 in the mma's
    B-fragment order, channels zero-padded to cp = 32; scales (n, 2, cp),
    zero on the padding."""
    _, units = _case(c, 8, DILATIONS, seed=c)
    pu = _port_units(units)
    cp = -(-c // 32) * 32
    w1, w2, scales, _ = port._pack_int8_tile(pu, None, c, cp, False)
    assert w1.dtype == w2.dtype == torch.int8
    assert tuple(w1.shape) == (3, 7, cp // 32, cp // 8, 32, 8)
    assert tuple(w2.shape) == (3, 1, cp // 32, cp // 8, 32, 8)
    assert tuple(scales.shape) == (3, 2, cp)
    for u, (a, b) in enumerate(pu):
        qa, sa = port.int8_weight_scales(a)
        qb, sb = port.int8_weight_scales(b)
        for got, q in ((w1[u], qa), (w2[u], qb)):
            # lane 4 g + t4, byte 4 h + i: output 8 ot + g, input
            # 32 kc + 16 h + 4 t4 + i
            full = got.reshape(-1, cp // 32, cp // 8, 8, 4, 2, 4) \
                .permute(0, 2, 3, 1, 5, 4, 6).reshape(-1, cp, cp)
            assert torch.equal(full[:, :c, :c].float(), q.permute(2, 0, 1))
            assert not full[:, c:].any() and not full[:, :, c:].any()
        assert torch.equal(scales[u, 0, :c], sa)
        assert torch.equal(scales[u, 1, :c], sb)
        assert not scales[u, :, c:].any()


def test_int8_wrapper_checks_and_cpu_count():
    """CPU calls of both int8 modes launch nothing, in f32 and bf16
    storage (bf16 comes back bf16), at any width (C = 2 raised before); other
    dtypes, a negative fold and a tile_rows below 1 raise; a device with no
    kernel raises."""
    x, units = _case(8, 64, DILATIONS, seed=3)
    xt = torch.from_numpy(x).transpose(1, 2).contiguous()
    for scale in ("row", "tile"):
        for dtype in (torch.float32, torch.bfloat16):
            out = port.folded_residual_stack(xt.to(dtype), _port_units(units),
                                             int8_dots=True, int8_scale=scale)
            assert out.dtype == dtype and out.shape == xt.shape
    assert port.int8_launches == port.int8_tile_launches == 0
    with pytest.raises(TypeError):
        port.folded_residual_stack(xt.to(torch.float16),
                                   _port_units(units), int8_dots=True)
    for kw in ({"fold": -1}, {"tile_rows": 0}):
        with pytest.raises(ValueError):
            port.folded_residual_stack(xt, _port_units(units),
                                       int8_dots=True, **kw)
    with pytest.raises(ValueError, match="no kernel"):
        port.folded_residual_stack(xt.to("meta"),
                                   [(a.to("meta"), b.to("meta"))
                                    for a, b in _port_units(units)],
                                   int8_dots=True, int8_scale="tile")
    x2, units2 = _case(2, 64, DILATIONS, seed=3)
    for scale in ("row", "tile"):
        out = port.folded_residual_stack(
            torch.from_numpy(x2).transpose(1, 2).contiguous(),
            _port_units(units2), int8_dots=True, int8_scale=scale)
        assert out.shape == (2, 2, 64) and torch.isfinite(out).all()
    assert port.int8_launches == port.int8_tile_launches == 0


def test_int8_zero_input_stays_zero():
    """Zero rows scale by zero: a silent input gives a silent output of
    its own length."""
    _, units = _case(64, 8, DILATIONS, seed=4)
    x = torch.zeros(1, 64, 51)
    out = port.folded_residual_stack(x, _port_units(units), int8_dots=True)
    assert torch.equal(out, x)


def test_int8_stack_needs_plain_elu_and_warns_as_jax():
    """res_stack_auto(int8=True) with an ELU that has parameters: both
    packages warn with the same text and take the normal route."""
    kw = dict(encode_channels=4, decode_channels=4, code_dim=16,
              codebook_num=4, codebook_size=32,
              nonlinear_activation_params=(("alpha", 0.5),))
    jcfg = JaxConfig(**kw)
    jp = jax.tree_util.tree_map(np.asarray,
                                generator_init(jax.random.PRNGKey(0), jcfg))
    block = jp["decoder"]["blocks"][3]
    x = np.random.default_rng(6).standard_normal((1, 64, 4)).astype(
        np.float32)
    with pytest.warns(UserWarning) as jw:
        ref = jax_fast.res_stack_auto(jnp.asarray(x), block, jcfg,
                                      interpret=True, int8=True)
    cfg = GeneratorConfig(**kw)
    with pytest.warns(UserWarning) as w:
        out = fast.res_stack_auto(
            torch.from_numpy(x).transpose(1, 2),
            params_from_jax(jp)["decoder"]["blocks"][3], cfg, int8=True)
    assert [str(m.message) for m in w] == [str(m.message) for m in jw]
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-6)
