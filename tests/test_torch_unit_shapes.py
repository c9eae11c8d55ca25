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


def test_mma_frag_pack_is_the_lanes_b_fragments():
    """csrc/folded_stack_mma.cu's weights for mma.sync: lane 4 g + t of n8
    tile nt holds, by kk then h, the input channels 16 kk + 8 h + 2 t (+1)
    of output channel 8 nt + g, the first conv's taps then the second's,
    zero-padded from C to cp; cached like the other packs."""
    for name, c, cp in (("leaky_k5_k2_5", 20, 32), ("elu_four_units", 8, 16)):
        units, biases = _units(name, c, seed=4)
        tu, tb = _torch_units(units, biases)
        w, b = port._packed_mma_taps(tu, tb, c, cp, False)
        w1, w2, b_ref = port._pack_mma(tu, tb, c, cp, True)
        taps = torch.cat([w1, w2], 1).float()
        assert tuple(w.shape) == (len(tu), taps.shape[1], cp // 8, 32,
                                  cp // 4)
        g, t = np.divmod(np.arange(32), 4)
        for kk in range(cp // 16):
            for h in range(2):
                for e in range(2):
                    ci = 16 * kk + 8 * h + 2 * t + e
                    co = 8 * np.arange(cp // 8)[:, None] + g[None, :]
                    want = taps[:, :, co, ci[None, :]]
                    assert torch.equal(w[..., 4 * kk + 2 * h + e].float(),
                                       want)
        assert (b is None) == (b_ref is None)
        assert b is None or torch.equal(b, b_ref)
        assert all(x is y for x, y in
                   zip((w, b), port._packed_mma_taps(tu, tb, c, cp, False)))


def test_mma_wgmma_pack_is_k_major_core_matrices():
    """csrc/folded_stack_mma.cu's weights for wgmma: each tap's B as
    K-major core matrices of 8 output x 8 input channels (128 bytes), the
    one of input block kb and output block nb at kb * cp / 8 + nb, as its
    no-swizzle descriptor reads them (k-adjacent 512 bytes apart,
    n-adjacent 128); cached apart from the mma.sync pack."""
    units, biases = _units("leaky_k5_k2_5", 20, seed=5)
    tu, tb = _torch_units(units, biases)
    w, _ = port._packed_mma_taps(tu, tb, 20, 32, True)
    w1, w2, _ = port._pack_mma(tu, tb, 20, 32, True)
    taps = torch.cat([w1, w2], 1)
    flat = w.reshape(len(tu), taps.shape[1], -1)
    co, ci = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    off = ((ci // 8) * 4 + co // 8) * 64 + (co % 8) * 8 + ci % 8
    assert torch.equal(flat[:, :, torch.from_numpy(off)], taps)
    assert w is not port._packed_mma_taps(tu, tb, 20, 32, False)[0]


def _mma_smem(cp, k, k2, dilations, resident, tile, ybufs=2):
    """csrc/folded_stack_mma.cu's buffers summed: the weights and biases of
    every unit (or one), the tile buffers each behind its longest look-back
    (the first conv's operand `ybufs` times with a 1x1 second conv), one
    look-back per conv."""
    rb = (cp + 8) * 2
    units = len(dilations) if resident else 1
    h1 = [(k - 1) * d for d in dilations]
    bufs = (ybufs * (tile + max(h1)) if k2 == 1
            else 2 * tile + max(h1) + k2 - 1)
    return (units * ((k + k2) * cp * cp * 2 + 2 * cp * 4) + bufs * rb
            + sum(h1) * rb + len(dilations) * (k2 - 1) * rb)


@pytest.mark.parametrize("k,k2,dilations,cp,warps,resident,blocks,wgmma", [
    (7, 1, (1, 3, 9), 32, 8, True, 2, True),        # the autoencoder units
    (11, 11, (1, 3, 5), 32, 12, True, 1, True),     # the vocoder units, k = 11
    (3, 3, (1, 3, 5), 32, 8, True, 2, False),       # ... at k = 3
    (7, 1, (1, 3, 9, 27), 16, 8, True, 2, False),   # four units, C <= 16
    (7, 1, (1, 64), 32, 16, True, 1, False),        # a look-back past a tile
    (11, 11, (1, 3, 5, 1, 3, 5), 32, 12, False, 1, True),  # a unit at a time
])
def test_mma_geometry(k, k2, dilations, cp, warps, resident, blocks, wgmma):
    """Two blocks of 8 warps (tiles of 256 samples) per SM with every
    unit's weights resident where both fit half the SM; else one block of
    the most warps that fit (whole warpgroups up to 12 on wgmma, which
    takes k2 = 1 only in the pair); one unit's weights at a time only where
    all of them do not fit; wgmma for the unrolled shapes (k = 7 with a 1x1
    second conv, k = k2 = 11) at cp = 32.  The shared memory sums
    csrc/folded_stack_mma.cu's buffers."""
    c = 32 if cp == 32 else 8
    g = port.mma_geometry(c, k, k2, dilations)
    halo = sum((k - 1) * d + k2 - 1 for d in dilations)
    assert (g.cp, g.warps, g.tile, g.halo, g.resident, g.blocks,
            g.wgmma) == (cp, warps, warps * port.MMA_WARP_ROWS, halo,
                         resident, blocks, wgmma)
    assert g.smem == _mma_smem(cp, k, k2, dilations, resident, g.tile)
    assert g.smem <= (port.MMA_PAIR_SMEM if blocks == 2
                      else port.BLOCK_SMEM)
    if blocks == 1:
        assert _mma_smem(cp, k, k2, dilations, True, 256) \
            > port.MMA_PAIR_SMEM
        most, step = ((port.MMA_WG_WARPS, 4) if wgmma
                      else (port.MMA_MAX_WARPS, 1))
        assert warps == most or _mma_smem(
            cp, k, k2, dilations, resident,
            (warps + step) * port.MMA_WARP_ROWS) > port.BLOCK_SMEM
    if not resident:
        assert _mma_smem(cp, k, k2, dilations, True, 128) > port.BLOCK_SMEM


def test_mma_geometry_raises_where_the_halo_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        port.mma_geometry(32, 11, 11, (64, 128, 256))


# the C <= 32 stacks of the shipped configs: symAD's encoder block 0 and
# decoder block 3 (C = 32; C = 16 in symAD_c16_vctk_48000_hop320), and the
# vocoders' last stage (C = 512 / 16 = 32) at each resblock kernel size of
# AudioDec v0-v3, dilations 1, 3, 5
@pytest.mark.parametrize("c,k,k2,dilations,warps,blocks,wgmma", [
    (32, 7, 1, (1, 3, 9), 8, 2, True),
    (16, 7, 1, (1, 3, 9), 8, 2, False),
    (32, 11, 11, (1, 3, 5), 12, 1, True),
    (32, 7, 7, (1, 3, 5), 16, 1, False),
    (32, 3, 3, (1, 3, 5), 8, 2, False),
])
def test_mma_geometry_of_the_shipped_stacks(c, k, k2, dilations, warps,
                                            blocks, wgmma):
    """Every shipped config's C <= 32 stack keeps all its units' weights in
    shared memory within the 232,448 bytes a block may use, with 16 warps
    an SM or 12: two blocks of 8 (each one's loads and barriers under the
    other's work) where they fit, else one block of the most warps; the
    taps of k = 7 (1x1 second conv) and k = k2 = 11 on wgmma."""
    g = port.mma_geometry(c, k, k2, dilations)
    assert g.smem <= port.BLOCK_SMEM and g.resident
    assert (g.warps, g.blocks, g.wgmma) == (warps, blocks, wgmma)
    assert g.warps * g.blocks >= 12


def _old_mma_tile(cp, k, k2, dilations):
    """The tile of the kernel this one replaced (one block of halo and
    tile per SM, f32 v in shared memory), or 0 where it raised."""
    rs, vs = cp + 8, cp + 1
    wtaps = k + 1 if k2 == 1 else max(k, k2)
    halo = sum((k - 1) * d + k2 - 1 for d in dilations)

    def smem(rows):
        return (2 * (wtaps * cp * rs + rows * rs * (1 if k2 == 1 else 2))
                + 4 * (2 * cp + rows * vs))

    rows = (port.BLOCK_SMEM - smem(0)) // (smem(1) - smem(0))
    tile = min(1024, (rows - halo) // 32 * 32)
    return tile if tile >= 32 else 0


@pytest.mark.parametrize("c", [8, 32])
def test_mma_geometry_takes_every_shape_the_old_kernel_took(c):
    """No unit shape that the kernel before the streamed design took is
    refused now: k = 1-11, k2 = 1 or 3 or k, one to 12 units, dilations up
    to 150 (the longest look-backs with one operand buffer)."""
    dil_sets = [(1,), (1, 3, 9), (1, 3, 9, 27), (1, 64), (81,), (150,),
                (1, 3, 5) * 4, (40, 80), (1, 2, 4, 8, 16, 32, 64)]
    for k in (1, 2, 3, 5, 7, 11):
        for k2 in sorted({1, 3, k}):
            for dil in dil_sets:
                cp = port.mma_width(c)
                if not _old_mma_tile(cp, k, k2, dil):
                    continue
                g = port.mma_geometry(c, k, k2, dil)
                assert g.smem <= port.BLOCK_SMEM, (k, k2, dil)
                assert g.smem == _mma_smem(cp, k, k2, dil, g.resident,
                                           g.tile, g.ybufs)


@pytest.mark.parametrize("shape,b,t,want", [
    ((7, 1, (1, 3, 9)), 16, 480000, (30208, 16, 256, 256)),
    ((11, 11, (1, 3, 5)), 16, 480000, (60288, 8, 384, 128)),
    ((11, 11, (1, 3, 5)), 1, 480000, (3840, 125, 384, 125)),
    ((7, 1, (1, 3, 9)), 2, 50, (256, 1, 256, 2)),
    ((7, 1, (1, 3, 9)), 300, 4801, (4864, 1, 256, 264)),
    ((7, 1, (1, 64)), 2, 513, (512, 2, 512, 4)),
])
def test_mma_split(shape, b, t, want):
    """Each row cut into whole tiles' segments, as many as the card's
    blocks hold rows of (132 SMs), at most one per tile; each stream starts
    its halo, in whole tiles, before its segment; the segments cover the
    row once; one block per item while they fit the card."""
    k, k2, dilations = shape
    g = port.mma_geometry(32, k, k2, dilations)
    sp = port.mma_split(g, b, t, 132)
    assert (sp.seg, sp.nseg, sp.warm, sp.grid) == want
    assert sp.seg % g.tile == 0 and sp.warm % g.tile == 0
    assert sp.warm >= g.halo
    assert sp.seg * (sp.nseg - 1) < t <= sp.seg * sp.nseg
    assert sp.grid == min(b * sp.nseg, g.blocks * 132)


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
