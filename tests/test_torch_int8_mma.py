"""The Python parts of the int8 modes' tensor-core kernels: the "row"
kernel's (csrc/int8_mma_stack.cu) weight pack, launch geometry and
per-phase offset schedule, and the "tile" kernel's (csrc/int8_tile_mma.cu)
fragment-order pack and geometry.  No JAX and no card: the kernels
themselves are held to the plain versions on the card by chip_smoke.py.
"""

import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audiodec_tpu_torch.ops.kernels import folded_stack as port
from audiodec_tpu_torch.ops.kernels.fold import fold_factor, fold_offsets

torch.set_num_threads(1)

DILATIONS = (1, 3, 9)
# the folds chip_smoke.py runs the int8 "row" mode at (besides each
# width's default): (C, fold)
SMOKE_FOLDS = ((4, 64), (32, 8), (32, 16), (64, 4), (64, 8), (128, 2),
               (128, 4), (256, 2))
# the int8 decode's unit shapes chip_smoke.py adds: (k, dilations)
UNIT_SHAPES = ((7, DILATIONS), (5, DILATIONS), (7, (1, 3, 9, 27)))


def _units(c, k=7, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.standard_normal((c, c, k))
                              .astype(np.float32)),
             torch.from_numpy(rng.standard_normal((c, c, 1))
                              .astype(np.float32))) for _ in range(n)]


@pytest.mark.parametrize("c", [4, 32, 96, 256])
def test_pack_round_trips_to_weight_scales(c):
    """(n, k, cp, cp) and (n, cp, cp) int8 as [u][tap][c_out][c_in] hold
    int8_weight_scales' integers, zero on the padding to the kernel's
    width cp; the scales (n, 2, cp) hold its scales, zero on the padding."""
    units = _units(c, seed=c)
    cp = port.int8_mma_geometry(c, fold_factor(c), 7, DILATIONS).cp
    w1, w2, scales, _ = port._pack_int8_mma(units, None, c, cp, False)
    assert w1.dtype == w2.dtype == torch.int8
    assert scales.dtype == torch.float32
    assert tuple(w1.shape) == (3, 7, cp, cp)
    assert tuple(w2.shape) == (3, 1, cp, cp)   # conv2's taps: k2 = 1
    assert tuple(scales.shape) == (3, 2, cp)
    for u, (a, b) in enumerate(units):
        qa, sa = port.int8_weight_scales(a)
        qb, sb = port.int8_weight_scales(b)
        assert torch.equal(w1[u, :, :c, :c].float(), qa.permute(2, 0, 1))
        assert torch.equal(w2[u, 0, :c, :c].float(), qb[:, :, 0])
        assert not w1[u, :, c:].any() and not w1[u, :, :, c:].any()
        assert not w2[u, :, c:].any() and not w2[u, :, :, c:].any()
        assert torch.equal(scales[u, 0, :c], sa)
        assert torch.equal(scales[u, 1, :c], sb)
        assert not scales[u, :, c:].any()


def _geometry_cases():
    for c in range(1, port.INT8_MMA_CHANNELS[-1] + 1):
        for k, dil in UNIT_SHAPES:
            yield c, fold_factor(c), k, dil
    for c in (32, 64, 128, 256):  # bin/folded_probe.py's folds
        for f in (fold_factor(c), 2 * fold_factor(c), 4 * fold_factor(c)):
            yield c, f, 7, DILATIONS
    for c, f in SMOKE_FOLDS:
        yield c, f, 7, DILATIONS


def test_geometry_fits_every_width_and_fold():
    """At every C from 1 to 512 at its default fold with the int8 decode's
    unit shapes, and at the folds of bin/folded_probe.py and chip_smoke.py:
    the block fits 227 KB, the tile is whole M tiles of 16 rows of every
    phase, the rounds cover it, and the stage and buffers are the
    kernel's."""
    for c, f, k, dil in _geometry_cases():
        g = port.int8_mma_geometry(c, f, k, dil)
        assert g.smem <= port.BLOCK_SMEM, (c, f, k, dil, g)
        assert g.tile % (16 * f) == 0 and g.tile % 16 == 0
        warps = port.int8_mma_warps(g.cp)
        per_round = warps // (g.cp // port.INT8_MMA_NW) * port.INT8_MMA_MT
        assert (g.rounds - 1) * per_round < g.tile // 16 <= \
            g.rounds * per_round
        assert g.cp in port.INT8_MMA_CHANNELS and c <= g.cp
        assert c > g.cp // 2 or g.cp == 32
        assert g.halo == max(-(-(k - 1) * d // f) for d in dil) * f
        assert g.buffers in (2, 3) and 1 <= g.taps_per_stage <= k
        assert g.cp % g.kc == 0 and g.kc % 32 == 0
        assert g.taps_per_stage == 1 or g.kc == g.cp
        assert g.launches == len(dil) and g.r1 == g.tile // f
        assert g.smem == port.int8_mma_smem(
            g.cp, c, g.buffers, g.taps_per_stage, g.kc, g.r1, f,
            g.r1 + g.halo // f, g.s_global)


def test_geometry_at_the_decoder_stacks():
    """The symAD decoder's four stacks: two 8-warp blocks per SM at
    C <= 64, whose shared memory fits half the SM's; one tile of 256, 128,
    128 and 64 samples in one round."""
    for c, tile in ((32, 256), (64, 128), (128, 128), (256, 64)):
        g = port.int8_mma_geometry(c, fold_factor(c), 7, DILATIONS)
        assert (g.tile, g.rounds, g.launches) == (tile, 1, 3)
        if c <= 64:
            assert port.int8_mma_warps(g.cp) == 8
            assert g.smem <= port.INT8_MMA_PAIR_SMEM


@pytest.mark.parametrize("c,f,dil", [(256, 1, (1, 3, 9, 200)),
                                     (32, 4, (1, 2000)), (4, 64, (2000,)),
                                     (4, 128, (2000,))])
def test_geometry_raises_where_the_halo_leaves_no_tile(c, f, dil):
    """A halo too long for the block (C = 4 at f = 128 with the decoder's
    dilations fits now: test_geometry_takes_every_unit_shape)."""
    with pytest.raises(ValueError, match="leaves no room"):
        port.int8_mma_geometry(c, f, 7, dil)


SCHEDULE_CASES = list(itertools.product((1, 3, 5, 7), (1, 2, 3, 9, 27),
                                        (1, 2, 4, 8, 16, 64)))


@pytest.mark.parametrize("k,d,f", SCHEDULE_CASES[::7])
def test_schedule_groups_taps_as_the_plain_conv(k, d, f):
    """Each phase's taps, grouped by offset: tap j of phase p at
    (p + j d - span) // f, ascending, every tap once, and the offsets of
    all phases the TPU kernel's `fold_offsets`.  The conv summed that way,
    each group an exact integer partial dequantized by its row's scale in
    ascending order, equals `_int8_conv` bit for bit."""
    span = (k - 1) * d
    sched = port.int8_offset_schedule(k, d, f)
    assert len(sched) == f
    offsets = set()
    for p, groups in enumerate(sched):
        assert [o for o, _ in groups] == sorted(o for o, _ in groups)
        assert sorted(j for _, js in groups for j in js) == list(range(k))
        for o, js in groups:
            assert all((p + j * d - span) // f == o for j in js)
            offsets.add(o)
    assert sorted(offsets) == fold_offsets(k, d, f)

    rng = np.random.default_rng(k * 100 + d * 10 + f)
    c, t = 3, 16 * f
    q = torch.from_numpy(rng.integers(-127, 128, (2, c, t))
                         .astype(np.float32))
    sd = torch.from_numpy(rng.random((2, t // f)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, (c, c, k))
                          .astype(np.float32))
    hrow = -(-span // f)
    qp = F.pad(q, (hrow * f, 0)).double()
    sdp = F.pad(sd, (hrow, 0))
    out = torch.zeros_like(q)
    for s in range(t):
        u, p = divmod(s, f)
        acc = torch.zeros(2, c)
        for o, js in sched[p]:
            part = sum(qp[:, :, hrow * f + s - span + j * d] @
                       wq[:, :, j].double().T for j in js)
            acc = port._fma(part.float(), sdp[:, u + hrow + o][:, None], acc)
        out[:, :, s] = acc
    assert torch.equal(out, port._int8_conv(q, sd, wq, d, f))


@pytest.mark.parametrize("c,k,d,f,want", [
    (256, 7, 9, 1, True), (32, 7, 1, 4, True), (64, 7, 1, 8, False),
    (256, 7, 1, 2, False), (128, 7, 1, 4, False), (4, 7, 1, 64, True)])
def test_exact_small_bound(c, k, d, f, want):
    """The fast int32 -> f32 conversion is taken exactly where 127^2 x C x
    the most taps of one offset stays below 2^22 (every decoder stack)."""
    taps = max(len(js) for ph in port.int8_offset_schedule(k, d, f)
               for _, js in ph)
    assert port.int8_exact_small(c, k, d, f) == want
    assert want == (127 * 127 * c * taps < 2 ** 22)


@pytest.mark.parametrize("units", [
    {"act": "leaky_relu", "act_param": 0.1, "biases": None},
    {"act": "elu", "act_param": 0.0, "biases": ()},
])
def test_card_shapes_raise_for_other_units(units):
    """The card's int8 kernels used to refuse LeakyReLU, biases and
    k2 > 1 (the check that raised for them is gone): now both kernels
    take every unit shape, so the activation has its kernel code, and the
    packs hold conv2's k2 taps and the biases."""
    assert units["act"] in port.MMA_ACT
    c = 8
    rng = np.random.default_rng(7)
    pu = [(torch.from_numpy(rng.standard_normal((c, c, 3))
                            .astype(np.float32)),) * 2 for _ in range(2)]
    biases = [(torch.ones(c), torch.full((c,), 2.0)) for _ in range(2)]
    w1, w2, _, b = port._pack_int8_mma(pu, biases, c, 32, False)
    assert tuple(w2.shape) == (2, 3, 32, 32) and torch.equal(w1, w2)
    t1, t2, _, tb = port._pack_int8_tile(pu, biases, c, 32, False)
    assert tuple(t2.shape) == (2, 3, 1, 4, 32, 8) and torch.equal(t1, t2)
    assert torch.equal(b, tb)
    assert tuple(b.shape) == (2, 2, 32) and float(b[1, 1, 0]) == 2.0
    assert not b[:, :, c:].any()


# A2: the unit shapes and folds the card refused before, (C, f, k, k2,
# dilations): LeakyReLU's vocoder units (k = k2 = 3, 7, 11), four units,
# k2 > 1 at a wide stack, and C = 4 at f = 128
SHAPES_REFUSED_BEFORE = [(32, 4, 3, 3, (1, 3, 5)), (32, 4, 11, 11, (1, 3, 5)),
                         (64, 2, 7, 7, (1, 3, 5)), (32, 4, 7, 1,
                                                    (1, 3, 9, 27)),
                         (256, 1, 11, 11, (1, 3, 5)), (4, 128, 7, 1,
                                                       DILATIONS)]


@pytest.mark.parametrize("c,f,k,k2,dil", SHAPES_REFUSED_BEFORE)
def test_geometry_takes_every_unit_shape(c, f, k, k2, dil):
    """Both int8 kernels' geometry at the unit shapes and the fold the card
    refused: no ValueError.  The row kernel's conv1 covers the tile and the
    rows conv2 reads before it, in whole M tiles; the tile kernel's tile
    and staged rows fit a block."""
    g = port.int8_mma_geometry(c, f, k, dil, k2)
    span2 = -fold_offsets(k2, 1, f)[0]
    assert g.r1 % 16 == 0 and g.tile // f + span2 <= g.r1 < \
        g.tile // f + span2 + 16
    assert g.smem <= port.BLOCK_SMEM and g.launches == len(dil)
    t = port.int8_tile_mma_geometry(c, k, k2, dil)
    assert t.smem <= port.BLOCK_SMEM and t.launches == 2 * len(dil) + 1


@pytest.mark.parametrize("c", [1, 2, 3, 32, 33, 64, 128, 256, 264, 512,
                               1024])
def test_tile_geometry(c):
    """csrc/int8_tile_mma.cu's launch: channels padded to a multiple of 32,
    4 M tiles a warp item from cp = 128, else 2; the tile a power of two
    from 16 to 256 samples with tile x cp within INT8_TILE_WORK[mt], the
    largest whose unit pass fits a block (the shared memory that
    `int8_tile_smem` sums); two launches per unit and one more."""
    g = port.int8_tile_mma_geometry(c, 7, 1, DILATIONS)
    work = port.INT8_TILE_WORK[g.mt]
    assert g.cp % 32 == 0 and c <= g.cp < c + 32
    assert g.mt == (4 if g.cp >= 128 else 2) and g.launches == 7
    assert g.ts in (16, 32, 64, 128, 256)
    assert g.ts * g.cp <= work or g.ts == 16
    assert g.smem == port.int8_tile_smem(g.cp, c, g.ts, 1, 54)
    assert g.smem <= port.BLOCK_SMEM
    if g.ts < port.INT8_TILE_MAX_TS and 2 * g.ts * g.cp <= work:
        assert port.int8_tile_smem(g.cp, c, 2 * g.ts, 1, 54) > \
            port.BLOCK_SMEM


def test_tile_geometry_raises_where_the_span_leaves_no_tile():
    with pytest.raises(ValueError, match="leaves no tile"):
        port.int8_tile_mma_geometry(32, 7, 1, (1, 3, 9, 20000))


@pytest.mark.parametrize("c", [2, 40, 264])
def test_fragment_order_round_trips(c):
    """`int8_fragment_order` puts output channel 8 ot + g and input channels
    32 kc + 16 h + 4 t4 + i at [kc][ot][4 g + t4][4 h + i], the B operand
    of mma.m16n8k32 s8, zero on the padding; the tile pack holds
    `int8_weight_scales`' integers so, and its scales."""
    cp = -(-c // 32) * 32
    units = _units(c, k=3, n=2, seed=c)
    w1, w2, scales, _ = port._pack_int8_tile(units, None, c, cp, False)
    assert tuple(w1.shape) == (2, 3, cp // 32, cp // 8, 32, 8)
    q, s = port.int8_weight_scales(units[1][0])
    frag = w1[1].long()
    rng = np.random.default_rng(c)
    for _ in range(64):
        j, o, i = (int(v) for v in (rng.integers(3), rng.integers(c),
                                    rng.integers(c)))
        ot, g = divmod(o, 8)
        kc, r = divmod(i, 32)
        h, r = divmod(r, 16)
        t4, b = divmod(r, 4)
        assert frag[j, kc, ot, 4 * g + t4, 4 * h + b] == q[o, i, j]
    unpacked = w1.reshape(2, 3, cp // 32, cp // 8, 8, 4, 2, 4) \
        .permute(0, 1, 3, 4, 2, 6, 5, 7).reshape(2, 3, cp, cp)
    assert not unpacked[:, :, c:].any() and not unpacked[:, :, :, c:].any()
    assert torch.equal(scales[1, 0, :c], s) and not scales[:, :, c:].any()
