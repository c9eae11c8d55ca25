"""The folded stack at the unit shapes the TPU kernel takes beyond the
shipped configs': other k and k2, biases with either activation, and more
than three units.

JAX's `res_stack_auto` sends `cfg.res_kernel_size` and `cfg.res_dilations`
to its folded kernel unchanged (`audiodec_tpu/models/fast.py:49-54`,
`:64-67`), and that kernel takes any act, k, k2, biases and unit count
(`audiodec_tpu/ops/pallas/folded_stack.py:112-200`).  On the CPU the port's
wrapper runs its plain versions; JAX runs its kernel in interpret mode.  The
same numpy inputs feed both.  The kernels that run these shapes on the
card (csrc/folded_stack_mma.cu, csrc/wide_stack_mma.cu and
csrc/resunit_stack.cu) are held to the plain version by chip_smoke.py;
here their weight packs, launch geometries and the routing rule are
checked without a card.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiodec_tpu.models import fast as jax_fast
from audiodec_tpu.models.autoencoder import GeneratorConfig as JaxConfig
from audiodec_tpu.models.autoencoder import generator_init
from audiodec_tpu.ops.pallas.folded_stack import (
    folded_residual_stack as jax_stack,
)
from audiodec_tpu_torch.models import fast
from audiodec_tpu_torch.models.autoencoder import GeneratorConfig
from audiodec_tpu_torch.ops.kernels import folded_stack as port
from audiodec_tpu_torch.utils.bridge import params_from_jax

torch.set_num_threads(1)

SMALL = dict(encode_channels=4, decode_channels=4, code_dim=16,
             codebook_num=4, codebook_size=32)
C, T = 8, 480
# item shapes: (act, k, k2, biases, dilations)
SHAPES = {
    "elu_k5": ("elu", 5, 1, False, (1, 3, 9)),
    "elu_four_units": ("elu", 7, 1, False, (1, 3, 9, 27)),
    "elu_k3_k2_3_biases": ("elu", 3, 3, True, (1, 3, 5)),
    "leaky_k5_k2_5": ("leaky_relu", 5, 5, True, (1, 3, 5)),
}
SLOPE = 0.1


@pytest.mark.parametrize("field", [{"res_kernel_size": 5},
                                   {"res_dilations": (1, 3, 9, 27)}])
def test_folded_encoder_matches_jax(field):
    """gen_small's widths (every encoder stack at C = 4..32 goes to the
    folded stack) with the field set, seeded JAX init: the port's encoder
    gives JAX's, to test_torch_codec.py's folded-encoder tolerance."""
    jcfg = JaxConfig(**SMALL, **field)
    jparams = jax.tree_util.tree_map(
        np.asarray, generator_init(jax.random.PRNGKey(0), jcfg))
    x = (0.3 * np.random.default_rng(0)
         .standard_normal((1, 2400, 1))).astype(np.float32)
    ref = np.asarray(jax_fast.encoder_apply_folded(
        jparams["encoder"], jnp.asarray(x), jcfg, interpret=True))
    out = fast.encoder_apply_folded(params_from_jax(jparams)["encoder"],
                                    torch.from_numpy(x),
                                    GeneratorConfig(**SMALL, **field))
    assert out.shape == ref.shape == (1, 8, 64)
    np.testing.assert_allclose(out.numpy(), ref, rtol=5e-2, atol=5e-3)


def _units(name, c, seed):
    """Seeded numpy units (JAX layout (k, I, O)) and biases of a shape,
    scaled to keep the stack near unit size; biases large enough that a
    fault in the masking before t=0 shows."""
    act, k, k2, bias, dilations = SHAPES[name]
    rng = np.random.default_rng(seed)
    units = [((rng.standard_normal((k, c, c)) / np.sqrt(k * c))
              .astype(np.float32),
              (rng.standard_normal((k2, c, c)) / np.sqrt(k2 * c))
              .astype(np.float32)) for _ in dilations]
    biases = ([(0.5 * rng.standard_normal(c).astype(np.float32),
                0.5 * rng.standard_normal(c).astype(np.float32))
               for _ in dilations] if bias else None)
    return units, biases


def _torch_units(units, biases):
    # JAX (K, I, O) -> torch (O, I, K)
    tu = [(torch.from_numpy(a).permute(2, 1, 0),
           torch.from_numpy(b).permute(2, 1, 0)) for a, b in units]
    tb = (None if biases is None else
          [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in biases])
    return tu, tb


def _kwargs(name):
    act, k, k2, _, dilations = SHAPES[name]
    return dict(dilations=dilations, kernel_size=k, kernel_size2=k2,
                act=act, act_param=SLOPE if act == "leaky_relu" else 0.0)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("bf16_dots", [True, False])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_matches_jax_kernel(name, bf16_dots, storage):
    """The tolerances of tests/test_torch_folded_stack.py: true f32 rtol
    1e-4, atol 5e-5 of the peak (only the order of the sums differs);
    bf16 operands or storage within 0.03 of the peak."""
    units, biases = _units(name, C, seed=len(name))
    x = np.random.default_rng(1).standard_normal((2, T, C)) \
        .astype(np.float32)
    kw = _kwargs(name)
    ref = jax_stack(
        jnp.asarray(x).astype(storage),
        tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in units),
        biases=(None if biases is None else
                tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in biases)),
        bf16_dots=bf16_dots, interpret=True, **kw)
    ref = np.asarray(ref.astype(jnp.float32))
    tu, tb = _torch_units(units, biases)
    xt = torch.from_numpy(x).transpose(1, 2).to(getattr(torch, storage))
    out = port.folded_residual_stack(xt, tu, biases=tb, bf16_dots=bf16_dots,
                                     **kw)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    out = out.float().transpose(1, 2).numpy()
    scale = float(np.max(np.abs(ref)))
    if storage == "float32" and not bf16_dots:
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=5e-5 * scale)
    else:
        assert float(np.max(np.abs(out - ref))) / scale < 0.03


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_matches_jax_kernel_at_c48(name):
    """A width csrc/wide_stack_mma.cu pads (C = 48 to 64), JAX at fold 2,
    bf16 dots in f32 storage: within 0.03 of the peak, as
    test_plain_matches_jax_kernel holds bf16 operands."""
    c = 48
    units, biases = _units(name, c, seed=c + len(name))
    x = np.random.default_rng(3).standard_normal((1, T, c)) \
        .astype(np.float32)
    kw = _kwargs(name)
    ref = np.asarray(jax_stack(
        jnp.asarray(x),
        tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in units),
        biases=(None if biases is None else
                tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in biases)),
        bf16_dots=True, fold=2, interpret=True, **kw))
    tu, tb = _torch_units(units, biases)
    xt = torch.from_numpy(x).transpose(1, 2)
    out = port.folded_residual_stack(xt, tu, biases=tb, bf16_dots=True,
                                     fold=2, **kw)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    out = out.transpose(1, 2).numpy()
    assert float(np.max(np.abs(out - ref))) / float(np.max(np.abs(ref))) \
        < 0.03


# ---------------------------------------------------------------------------
# the int8 modes at k = 5: the shape res_stack_auto(int8=True) sends with
# res_kernel_size=5.  Bounds of tests/test_torch_int8_stack.py: every output
# within 1e-2 of the peak, 95% of one unit's within 1e-5 of it.
# ---------------------------------------------------------------------------

NEAR, STEP, SHARE = 1e-5, 1e-2, 0.95
K5 = 5


def _int8_case(c, t, dilations, seed):
    rng = np.random.default_rng(seed)
    units = [((rng.standard_normal((K5, c, c)) / np.sqrt(K5 * c))
              .astype(np.float32),
              (rng.standard_normal((1, c, c)) / np.sqrt(c))
              .astype(np.float32)) for _ in dilations]
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    return x, units


@functools.cache
def _jax_int8(c, t, dilations, scale):
    x, units = _int8_case(c, t, dilations, seed=c + t)
    return np.asarray(jax_stack(
        jnp.asarray(x), tuple((jnp.asarray(a), jnp.asarray(b))
                              for a, b in units),
        dilations=dilations, kernel_size=K5, int8_dots=True,
        int8_scale=scale, tile_rows=64, interpret=True))


def _port_int8(c, t, dilations, scale):
    x, units = _int8_case(c, t, dilations, seed=c + t)
    tu, _ = _torch_units(units, None)
    out = port.folded_residual_stack(
        torch.from_numpy(x).transpose(1, 2).contiguous(), tu,
        dilations=dilations, kernel_size=K5, int8_dots=True,
        int8_scale=scale, tile_rows=64)
    assert out.dtype == torch.float32
    return out.transpose(1, 2).numpy()


@pytest.mark.parametrize("scale,dilations", [
    ("row", (9,)), ("row", (1, 3, 9)), ("tile", (9,)), ("tile", (1, 3, 9))])
def test_int8_plain_matches_jax_at_k5(scale, dilations):
    ref = _jax_int8(32, 700, dilations, scale)
    out = _port_int8(32, 700, dilations, scale)
    peak = float(np.abs(ref).max())
    err = np.abs(out - ref)
    assert err.max() <= STEP * peak
    if len(dilations) == 1:
        assert (err <= NEAR * peak).mean() >= SHARE


def test_int8_tile_geometry_takes_k():
    """The tile mode's halo follows k: JAX's h_total rows at k = 5."""
    g5 = port.tile_geometry(32, 700, (1, 3, 9), 4, 64, kernel_size=K5)
    g7 = port.tile_geometry(32, 700, (1, 3, 9), 4, 64)
    # ceil(4 d / 4) and ceil(6 d / 4) rows per unit at f = 4
    assert (g5.halo, g7.halo) == (1 + 3 + 9, 2 + 5 + 14)


# ---------------------------------------------------------------------------
# csrc/folded_stack_mma.cu's operands, launch geometry and routing, without
# a card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,name", [(4, "elu_k3_k2_3_biases"),
                                    (12, "leaky_k5_k2_5"),
                                    (20, "elu_four_units")])
def test_mma_pack_layout_and_padding(c, name):
    """[u][tap][c_out][c_in] bf16 taps zero-padded to the next built width
    (16 or 32), f32 biases [u][conv][c_out]: on a zero-padded input they
    give the plain stack's result on the first C channels (bf16 operands)
    and keep the padded channels at exactly zero."""
    units, biases = _units(name, c, seed=c)
    tu, tb = _torch_units(units, biases)
    cp = port.mma_width(c)
    assert cp == (16 if c <= 16 else 32)
    w1, w2, b = port._pack_mma(tu, tb, c, cp, True)
    act, k, k2, _, dilations = SHAPES[name]
    n = len(dilations)
    assert w1.shape == (n, k, cp, cp) and w2.shape == (n, k2, cp, cp)
    assert w1.dtype == w2.dtype == torch.bfloat16
    assert torch.equal(w1[0, 1, :c, :c], tu[0][0][:, :, 1].bfloat16())
    assert not w1[:, :, c:].any() and not w1[:, :, :, c:].any()
    if tb is None:
        assert b is None
        packed_b = None
    else:
        assert b.shape == (n, 2, cp) and b.dtype == torch.float32
        assert torch.equal(b[1, 0, :c], tb[1][0]) and not b[:, :, c:].any()
        packed_b = [(bb[0], bb[1]) for bb in b]
    packed = [(a.float().permute(1, 2, 0), bb.float().permute(1, 2, 0))
              for a, bb in zip(w1, w2)]
    x = np.random.default_rng(2).standard_normal((1, c, 200)) \
        .astype(np.float32)
    xt = torch.from_numpy(x)
    xp = torch.nn.functional.pad(xt, (0, 0, 0, cp - c))
    kw = dict(act=act, act_param=SLOPE)
    out = port.folded_residual_stack_plain(xp, packed, dilations, True,
                                           biases=packed_b, **kw)
    ref = port.folded_residual_stack_plain(xt, tu, dilations, True,
                                           biases=tb, **kw)
    torch.testing.assert_close(out[:, :c], ref, rtol=1e-6, atol=1e-6)
    assert not out[:, c:].any()


def test_mma_pack_is_cached_until_changed():
    units, biases = _units("leaky_k5_k2_5", 8, seed=3)
    tu, tb = _torch_units(units, biases)
    first = port._packed_mma(tu, tb, 8, 16)
    assert all(a is b for a, b in zip(first, port._packed_mma(tu, tb, 8, 16)))
    tb[0][1].add_(1.0)  # an in-place update of a bias must repack
    assert not torch.equal(port._packed_mma(tu, tb, 8, 16)[2], first[2])


@pytest.mark.parametrize("k,k2,dilations,cp,tile", [
    (7, 1, (1, 3, 9), 32, 896),                # the autoencoder units
    (11, 11, (1, 3, 5), 32, 576),              # the vocoder units at k = 11
    (3, 3, (1, 3, 5), 32, 736),                # ... at k = 3
    (7, 1, (1, 3, 9, 27), 16, 1024),           # four units, C <= 16
])
def test_mma_geometry(k, k2, dilations, cp, tile):
    """One block per SM with the largest tile of whole warp steps (up to
    MMA_MAX_TILE) whose samples and halo fit the block's 227 KB; the
    shared memory sums csrc/folded_stack_mma.cu's buffers."""
    c = 32 if cp == 32 else 8
    g = port.mma_geometry(c, k, k2, dilations)
    halo = sum((k - 1) * d + k2 - 1 for d in dilations)
    assert (g.cp, g.tile, g.halo) == (cp, tile, halo)
    rs, vs = cp + 8, cp + 1
    per_row = rs * 2 * (1 if k2 == 1 else 2) + vs * 4
    taps = (k + 1 if k2 == 1 else max(k, k2)) * cp * rs * 2
    assert g.smem == (tile + halo) * per_row + taps + 2 * cp * 4
    assert g.smem <= port.BLOCK_SMEM
    assert (tile == port.MMA_MAX_TILE
            or port.BLOCK_SMEM < g.smem + port.MMA_STEP * per_row)


def test_mma_geometry_raises_where_the_halo_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        port.mma_geometry(32, 11, 11, (64, 128, 256))


@pytest.mark.parametrize("mode,c,bf16_storage,bf16_dots,want", [
    ("autoencoder", 32, False, True, "mma"),
    ("autoencoder", 32, True, False, "mma"),
    ("autoencoder", 4, False, False, "resunit"),
    ("vocoder", 32, True, True, "mma"),
    ("vocoder", 32, False, False, "resunit"),
    ("other", 8, False, True, "mma"),
    ("other", 8, True, False, "mma"),
    ("other", 8, False, False, "resunit"),
    ("autoencoder", 64, False, True, "wide"),
    ("autoencoder", 256, True, False, "wide"),
    ("autoencoder", 64, False, False, "resunit"),
    ("vocoder", 64, False, True, "wide"),
    ("vocoder", 64, False, False, "resunit"),
    ("other", 64, False, True, "wide"),
    ("int8", 32, False, False, "int8"),
    ("int8", 256, True, True, "int8"),
    ("autoencoder", 512, False, True, "wide"),
    ("autoencoder", 264, True, False, "wide"),
    ("vocoder", 512, False, False, "resunit"),
    ("other", 264, False, False, "resunit"),
    ("int8", 512, False, False, "int8"),
])
def test_route(mode, c, bf16_storage, bf16_dots, want):
    """With bf16 operands C <= 32 takes csrc/folded_stack_mma.cu and wider
    stacks csrc/wide_stack_mma.cu, at every unit shape; in true f32 every
    stack takes csrc/resunit_stack.cu (the narrow FMA kernels are gone);
    above C = 256, which raised before, the same routes."""
    assert port.route(mode, c, bf16_storage, bf16_dots) == want


@pytest.mark.parametrize("mode,c,bf16_dots,units,want", [
    ("autoencoder", 8, False, 3, "resunit"),
    ("autoencoder", 8, False, 4, "resunit"),
    ("vocoder", 32, False, 4, "resunit"),
    ("autoencoder", 8, True, 4, "mma"),
    ("autoencoder", 64, True, 4, "wide"),
])
def test_route_by_unit_count(mode, c, bf16_dots, units, want):
    """The unit count no longer picks a kernel (the FMA kernels' 1..3 units
    are gone): every kernel takes any count, and `route` has no count to
    take; the kernels' geometry at that many units fits."""
    assert port.route(mode, c, False, bf16_dots) == want
    dil = (1, 3, 9, 27)[:units]
    k, k2 = (11, 11) if mode == "vocoder" else (7, 1)
    geometry = {"resunit": port.unit_geometry, "wide": port.wide_geometry,
                "mma": port.mma_geometry}[want]
    assert geometry(c, k, k2, dil).smem <= port.BLOCK_SMEM


@pytest.mark.parametrize("kwargs,mode", [
    ({}, "autoencoder"),
    ({"kernel_size": 5}, "other"),
    ({"kernel_size2": 3}, "other"),
    ({"biases": ()}, "other"),
    ({"act": "leaky_relu", "kernel_size": 11, "kernel_size2": 11},
     "vocoder"),
    ({"act": "leaky_relu", "kernel_size": 5, "kernel_size2": 5}, "other"),
    ({"act": "leaky_relu", "kernel_size2": 1}, "other"),
    ({"int8_dots": True, "kernel_size": 5}, "int8"),
    ({"int8_dots": True, "act": "leaky_relu", "kernel_size": 3,
      "kernel_size2": 3, "biases": ()}, "int8"),
    ({"int8_dots": True, "kernel_size2": 3}, "int8"),
    ({"int8_dots": True, "biases": ()}, "int8"),
])
def test_mode(kwargs, mode):
    kw = dict(kernel_size=7, kernel_size2=1, act="elu", biases=None,
              int8_dots=False)
    kw.update(kwargs)
    assert port._mode(**kw) == mode


def test_plain_exact_sums_round_each_conv_once():
    """exact_sums=True keeps every rounding point and sums each conv's
    products in f64, rounded to f32 once: one unit by hand (ELU, k = 5,
    dilation 3, true f32)."""
    rng = np.random.default_rng(4)
    w1 = torch.from_numpy(rng.standard_normal((C, C, 5)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((C, C, 1)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((1, C, 64)).astype(np.float32))
    out = port.folded_residual_stack_plain(x, [(w1, w2)], (3,), False,
                                           exact_sums=True)
    a = torch.nn.functional.pad(torch.nn.functional.elu(x), (12, 0))
    acc = torch.nn.functional.conv1d(a.double(), w1.double(),
                                     dilation=3).float()
    y2 = torch.nn.functional.conv1d(
        torch.nn.functional.elu(acc).double(), w2.double()).float()
    assert torch.equal(out, x + y2)
    # the f32 sums differ from these by f32 roundoff only
    torch.testing.assert_close(
        port.folded_residual_stack_plain(x, [(w1, w2)], (3,), False), out,
        rtol=1e-5, atol=1e-5)
