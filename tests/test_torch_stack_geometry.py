"""Launch geometries and weight packs of the folded stack's two kernels that
take every unit shape: csrc/resunit_stack.cu (true f32 on the FMA units,
also the archived stack's kernel) and csrc/wide_stack_mma.cu (bf16 operands
on the tensor cores above C = 32), and the latter's split of the batch.

The kernels run only on the card, where chip_smoke.py holds them to their
plain versions; here, without a card, every width from 1 to WIDEST at the
unit shapes of the TPU kernel's configs and beyond either gets a geometry
whose shared memory fits a block, or raises a ValueError that names the
shape, and the packs put each weight where the kernels read it.
"""

import numpy as np
import pytest
import torch

from audiodec_tpu_torch.ops.kernels import folded_stack as port

torch.set_num_threads(1)

KERNEL_SIZES = (1, 3, 5, 7, 11)
KERNEL_SIZES2 = (1, 3, 7, 11)
DILATIONS = ((1, 3, 9), (1, 3, 9, 27))
WIDEST = 512   # the card took C <= 256 before


def _named(err: ValueError, c, k, k2, dilations) -> bool:
    msg = str(err)
    return (f"k={k}, k2={k2}, dilations={dilations}" in msg
            and f"C={c}" in msg)


@pytest.mark.parametrize("dilations", DILATIONS)
@pytest.mark.parametrize("k2", KERNEL_SIZES2)
@pytest.mark.parametrize("k", KERNEL_SIZES)
def test_unit_geometry_fits_or_raises(k, k2, dilations):
    """csrc/resunit_stack.cu: cp / 16 threads along the channels, 8
    samples each along time, conv1 over tile + k2 - 1 samples, the widest
    stages that fit at that tile, and the layout's shared memory within a
    block's."""
    d = max(dilations)
    for c in range(1, WIDEST + 1):
        try:
            g = port.unit_geometry(c, k, k2, dilations)
        except ValueError as err:
            assert _named(err, c, k, k2, dilations), err
            continue
        ny = g.cp // port.UNIT_TM
        assert g.cp % port.UNIT_TM == 0 and c <= g.cp < c + port.UNIT_TM
        assert 1 <= g.threads <= port.UNIT_THREADS and g.threads % ny == 0
        assert g.rows == port.UNIT_TN * (g.threads // ny)
        assert g.tile == g.rows - (k2 - 1) >= 1
        assert g.halo == (k - 1) * d + k2 - 1
        assert g.kc2 * k2 <= max(g.kc1 * k, k2)
        width = g.rows + (k - 1) * d
        assert g.smem == port.unit_smem(g.cp, k, k2, g.rows, width, g.kc1,
                                        g.kc2) <= port.BLOCK_SMEM
        if g.kc1 < port.UNIT_KC[0]:
            assert port.unit_smem(g.cp, k, k2, g.rows, width, 2 * g.kc1,
                                  g.kc2) > port.BLOCK_SMEM
        assert g.launches == len(dilations) and g.warps * 32 >= g.threads


@pytest.mark.parametrize("dilations", DILATIONS)
@pytest.mark.parametrize("k2", KERNEL_SIZES2)
@pytest.mark.parametrize("k", KERNEL_SIZES)
def test_wide_geometry_fits_or_raises(k, k2, dilations):
    """csrc/wide_stack_mma.cu: channels padded to a multiple of 64 (a
    wgmma's M), up to 2 consumer warpgroups, the most that fit, of 128
    samples or else of 64; the operand's
    rows cover the tile, the first conv's look-back and the alignment, a2's
    the tile and k2 - 1 more, and with the epilogue's staging and at least
    two weight stages fit a block's shared memory; the most warpgroups that
    fit, and as many stages as fit, up to WIDE_MAX_STAGES."""
    d = max(dilations)
    for c in range(1, WIDEST + 1):
        try:
            g = port.wide_geometry(c, k, k2, dilations)
        except ValueError as err:
            assert _named(err, c, k, k2, dilations), err
            continue
        assert g.cp % port.WIDE_M == 0 and c <= g.cp < c + port.WIDE_M
        assert g.n in port.WIDE_N and 1 <= g.warpgroups <= port.WIDE_MAX_WG
        assert g.tile == g.n * g.warpgroups >= k2 - 1
        assert g.halo == (k - 1) * d + k2 - 1
        assert g.cp % port.WIDE_KC == 0
        assert port.WIDE_MIN_STAGES <= g.stages <= port.WIDE_MAX_STAGES

        def rows(wgs, n=g.n):
            tile = n * wgs
            return tile + (k - 1) * d + port.WIDE_ALIGN, tile + k2 - 1

        assert g.smem == port.wide_smem(g.cp, *rows(g.warpgroups),
                                        g.warpgroups, g.stages)
        assert g.smem <= port.BLOCK_SMEM
        if g.stages < port.WIDE_MAX_STAGES:
            assert port.wide_smem(g.cp, *rows(g.warpgroups), g.warpgroups,
                                  g.stages + 1) > port.BLOCK_SMEM
        if g.warpgroups < port.WIDE_MAX_WG:
            wgs = port.WIDE_MAX_WG
            assert port.wide_smem(g.cp, *rows(wgs, min(port.WIDE_N)), wgs,
                                  port.WIDE_MIN_STAGES) > port.BLOCK_SMEM
        if g.n < port.WIDE_N[0]:
            assert port.wide_smem(g.cp, *rows(g.warpgroups, port.WIDE_N[0]),
                                  g.warpgroups,
                                  port.WIDE_MIN_STAGES) > port.BLOCK_SMEM
        assert g.launches == len(dilations)


@pytest.mark.parametrize("c,threads,rows,kc1,kc2", [
    (32, 256, 1024, 8, 16), (64, 256, 512, 8, 16), (128, 256, 256, 8, 16),
    (256, 256, 128, 4, 16)])
def test_unit_geometry_at_symad_stacks(c, threads, rows, kc1, kc2):
    """The archived stack's shapes (k = 7, a 1x1 second conv, dilations
    1, 3, 9): 256 threads at every width, the first conv's stage of 8 input
    channels but at C = 256, where a2 takes more of the block."""
    g = port.unit_geometry(c, 7, 1, (1, 3, 9))
    assert (g.cp, g.threads, g.rows, g.tile, g.kc1, g.kc2, g.halo) == (
        c, threads, rows, rows, kc1, kc2, 54)


@pytest.mark.parametrize("c,n,warpgroups,stages", [
    (48, 128, 2, 8), (64, 128, 2, 8), (128, 128, 2, 8), (256, 64, 2, 6),
    (512, 64, 1, 3)])
def test_wide_geometry_at_symad_stacks(c, n, warpgroups, stages):
    """The autoencoder units at the probe's widths (and C = 48, padded to
    64, and C = 512): two warpgroups of 128 samples to C = 128, two of 64
    at C = 256 and one of 64 at C = 512; the ring as deep as fits."""
    g = port.wide_geometry(c, 7, 1, (1, 3, 9))
    assert (g.n, g.warpgroups, g.tile, g.stages) == (
        n, warpgroups, n * warpgroups, stages)


@pytest.mark.parametrize("c,t,k,n,stages", [
    (256, 8000, 11, 64, 6), (256, 8000, 7, 64, 7), (256, 8000, 3, 64, 8),
    (128, 40000, 11, 128, 8), (128, 40000, 3, 128, 8),
    (64, 160000, 11, 128, 8), (64, 160000, 7, 128, 8)])
def test_wide_geometry_at_vocoder_stages(c, t, k, n, stages):
    """The vocoders' resblocks above C = 32 (k = k2, dilations 1, 3, 5) at
    B = 16 x 10 s: two warpgroups, of 128 samples to C = 128 and of 64 at
    C = 256, and a split of each row into 8 segments of whole tiles on 132
    SMs, one block a segment."""
    g = port.wide_geometry(c, k, k, (1, 3, 5))
    assert (g.cp, g.n, g.warpgroups, g.tile, g.stages) == (
        c, n, 2, 2 * n, stages)
    sp = port.wide_split(g, 16, t, 132)
    assert sp.nseg == 8 and sp.grid == 128 and sp.seg % g.tile == 0
    assert sp.seg * (sp.nseg - 1) < t <= sp.seg * sp.nseg


def _units(c, k, k2, n, seed):
    rng = np.random.default_rng(seed)
    units = [tuple(torch.from_numpy(rng.standard_normal((c, c, kk))
                                    .astype(np.float32)) for kk in (k, k2))
             for _ in range(n)]
    biases = [tuple(torch.from_numpy(rng.standard_normal(c)
                                     .astype(np.float32)) for _ in range(2))
              for _ in range(n)]
    return units, biases


@pytest.mark.parametrize("c,k,k2", [(5, 3, 3), (40, 5, 1), (200, 11, 11)])
def test_unit_pack_layout_and_padding(c, k, k2):
    """csrc/resunit_stack.cu's operands: (n, cp, k, cp) f32 [u][c_in][tap]
    [c_out] for each conv and (n, 2, cp) f32 biases, zero-padded from C to
    cp: turned back into torch weights they give the plain stack's result
    on the first C channels of a zero-padded input (to f32 rounding), and
    the padded channels stay exactly zero."""
    dilations = (1, 3)
    units, biases = _units(c, k, k2, len(dilations), seed=c)
    cp = port.unit_geometry(c, k, k2, dilations).cp
    w1, w2, b = port._pack_unit(units, biases, c, cp, False)
    assert w1.shape == (2, cp, k, cp) and w2.shape == (2, cp, k2, cp)
    assert torch.equal(w1[1, :c, :, :c], units[1][0].permute(1, 2, 0))
    assert torch.equal(w2[0, :c, :, :c], units[0][1].permute(1, 2, 0))
    assert torch.equal(b[1, 0, :c], biases[1][0]) and not b[:, :, c:].any()
    packed = [(a.permute(2, 0, 1), bb.permute(2, 0, 1))
              for a, bb in zip(w1, w2)]
    x = torch.from_numpy(np.random.default_rng(1)
                         .standard_normal((1, c, 64)).astype(np.float32))
    xp = torch.nn.functional.pad(x, (0, 0, 0, cp - c))
    kw = dict(act="leaky_relu", act_param=0.1)
    out = port.folded_residual_stack_plain(
        xp, packed, dilations, False, biases=[tuple(u) for u in b], **kw)
    ref = port.folded_residual_stack_plain(x, units, dilations, False,
                                           biases=biases, **kw)
    # the padded input channels add exact zeros; the CPU's convolution may
    # block its sums differently at the padded width
    torch.testing.assert_close(out[:, :c], ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    assert not out[:, c:].any()


def test_unit_pack_is_cached_until_changed():
    units, biases = _units(40, 7, 1, 3, seed=4)
    first = port._packed_unit(units, biases, 40, 48)
    assert all(a is b for a, b in
               zip(first, port._packed_unit(units, biases, 40, 48)))
    units[2][1].mul_(2.0)  # an in-place update of a weight must repack
    again = port._packed_unit(units, biases, 40, 48)
    assert torch.equal(again[1][2, :40, :, :40], units[2][1].permute(1, 2, 0))
    assert not torch.equal(again[1], first[1])
