"""The fused RVQ encode's host side: csrc/rvq_encode.cu's geometry
(`rvq_geometry`) and codebook pack (`pack_codebooks`), which the card runs
and the CPU can check, and the plain version at the shapes the kernel
newly takes (Q = 16, duplicated codes) against JAX.

The kernel itself runs only on the card, where chip_smoke.py holds it to
the plain version.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiodec_tpu.archive.vq_kernel import (
    rvq_encode_pallas as jax_rvq_encode,
)
from audiodec_tpu.ops.vq import rvq_forward_index as jax_rvq_forward_index
from audiodec_tpu.ops.vq import rvq_init
from audiodec_tpu_torch.archive import vq_kernel as port

torch.set_num_threads(1)

BLOCK_SMEM = 232448


@pytest.mark.parametrize("d", [8, 12, 16, 64, 256, 264, 512])
@pytest.mark.parametrize("n", [7, 2001, 25600])
def test_geometry_takes_every_width(n, d):
    g = port.rvq_geometry(n, d, 8, 1024)
    assert (g.rows_per_warp, g.frames) in port.TILES
    assert g.smem == port.rvq_smem(g.frames, g.d_pad, g.rows_per_warp,
                                   g.slice, g.stages, 8) <= BLOCK_SMEM
    assert g.d_pad == -(-d // 4) * 4 and g.slice % 4 == 0
    assert g.slice <= g.d_pad and g.stages in port.STAGES
    assert g.threads == g.frames // 8 // g.rows_per_warp * 32 <= 256
    assert g.chunk == 256 // g.rows_per_warp
    assert g.residency >= 1
    # every frame in exactly one block
    assert (g.blocks - 1) * g.frames < n <= g.blocks * g.frames


def test_geometry_raises_where_no_tile_fits():
    with pytest.raises(ValueError, match=r"N=10, D=5000, Q=8, NE=1024"):
        port.rvq_geometry(10, 5000, 8, 1024)
    # the widest D of the narrowest tile still runs
    assert port.rvq_geometry(10, 4600, 8, 1024).frames == 8


def test_even_grid_at_the_main_shape():
    # (16, 1600) frames of symAD: 128-frame blocks of 8 warps, two a
    # sub-partition, every block resident at once, and one ring stage a
    # chunk (the fastest of every tile and ring on the card)
    g = port.rvq_geometry(25600, 64, 8, 1024)
    assert (g.frames, g.rows_per_warp, g.slice, g.stages) == (128, 2, 64, 2)
    assert g.blocks <= port.SMS * g.residency
    assert (g.threads // 32) % 4 == 0


@pytest.mark.parametrize("n,d,want", [(6400, 64, (64, 1)),
                                      (2800, 512, (32, 1)),
                                      (25600, 512, (64, 1))])
def test_geometry_at_the_swept_shapes(n, d, want):
    # the tile that was fastest in the card's sweep at these shapes
    g = port.rvq_geometry(n, d, 8, 1024)
    assert (g.frames, g.rows_per_warp) == want


@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("q,ne,d", [(8, 1024, 64), (3, 1000, 12),
                                    (2, 16, 8)])
def test_pack_inverts_to_embed(chunk, q, ne, d):
    embed = torch.from_numpy(np.random.default_rng(q + ne + d)
                             .standard_normal((q, ne, d)).astype(np.float32))
    packed = port.pack_codebooks(embed, chunk)
    d_pad, nch = -(-d // 4) * 4, -(-ne // chunk)
    assert tuple(packed.shape) == (q, nch, d_pad + 1, chunk)
    flat = packed.transpose(2, 3).reshape(q, nch * chunk, d_pad + 1)
    assert torch.equal(flat[:, :ne, :d], embed)
    assert torch.equal(flat[:, :ne, d_pad], port.code_norms(embed))
    assert not flat[:, ne:].any() and not flat[:, :, d:d_pad].any()


def test_pack_is_cached_on_what_embed_holds():
    embed = torch.randn(2, 300, 16)
    first = port.pack_codebooks(embed, 128)
    assert port.pack_codebooks(embed, 128) is first
    assert port.pack_codebooks(embed, 256) is not first
    embed.mul_(2.0)  # an in-place update misses the cache
    again = port.pack_codebooks(embed, 128)
    assert again is not first
    assert torch.equal(again[:, 0, :16, 0], embed[:, 0])


def _z(bt, d, seed):
    return (np.random.default_rng(seed).standard_normal((*bt, d))
            .astype(np.float32))


def test_plain_at_16_codebooks_matches_jax():
    # hop-320's 16 codebooks
    params = jax.tree_util.tree_map(
        np.array, rvq_init(jax.random.PRNGKey(3), 16, 64, 16))
    z = _z((2, 20), 16, 3)
    zq, idx = port.rvq_encode_plain(torch.from_numpy(z),
                                    torch.from_numpy(params["embed"]))
    _, jidx = jax_rvq_forward_index(jnp.asarray(z), params)
    assert tuple(idx.shape) == (2, 20, 16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    # zq is the plain update: the gathered codes summed in layer order
    want = np.zeros_like(z)
    for q in range(16):
        want = want + params["embed"][q][idx.numpy()[..., q]]
    np.testing.assert_array_equal(zq.numpy(), want)


def test_plain_takes_the_lower_of_duplicated_codes_as_jax():
    # every code of the upper half repeats one of the lower half: each
    # minimum is an exact tie, which the lower index wins
    rng = np.random.default_rng(4)
    low = rng.standard_normal((2, 8, 8)).astype(np.float32)
    embed = np.concatenate([low, low[:, rng.permutation(8)]], axis=1)
    z = _z((1, 3), 8, 4)
    zq, idx = port.rvq_encode_plain(torch.from_numpy(z),
                                    torch.from_numpy(embed))
    jzq, jidx = jax_rvq_encode(jnp.asarray(z), jnp.asarray(embed),
                               interpret=True)
    _, fidx = jax_rvq_forward_index(jnp.asarray(z), {"embed": embed})
    assert int(idx.max()) < 8
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(fidx))
    np.testing.assert_array_equal(zq.numpy(), np.asarray(jzq))
