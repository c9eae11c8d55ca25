"""The port's int8 "tile" mode (plain version) against the JAX folded
kernel's (`int8_scale="tile"`), in interpret mode, and the port's copies of
the TPU kernel's tiling (`_pick_tile`, the time padding, the halo rows).

The CUDA kernel (csrc/int8_tile_mma.cu) is held to the plain version on
the card by chip_smoke.py.

Tolerance against JAX, in the form of tests/test_torch_int8_stack.py: every
output within 1e-2 of the peak, and 95% of them within 1e-5 of it.  The
known difference is XLA's f32 exp, which differs from PyTorch's by an ulp on
part of the arguments; where that ulp lands on a rounding boundary of the
quantizer an int8 code moves one step.  With JAX's own exp put in the
port's ELU, the port gives JAX's output bit for bit, which pins the tiling,
the padding, the scales, the exact integer sums and the rounding of the
residual (an fma in f32 storage; in bf16 storage the rounded product added
in f32, the sum read unrounded by the next unit's ELU).  A wrong tiling, a
scale without the halo or a padding to whole rows misses the first bound on
most outputs.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiodec_tpu.ops.pallas.folded_stack import _pick_tile as jax_pick_tile
from audiodec_tpu.ops.pallas.folded_stack import (
    folded_residual_stack as jax_stack,
)
from audiodec_tpu_torch.ops.kernels import fold
from audiodec_tpu_torch.ops.kernels import folded_stack as port

torch.set_num_threads(1)

DILATIONS = (1, 3, 9)
NEAR, STEP, SHARE = 1e-5, 1e-2, 0.95
# (C, T, fold, tile_rows): T under 256 folded rows (align 16) and over
# (align 256), every case with 8 or more tiles
CASES = [(32, 700, 4, 64), (32, 2100, 8, 64), (64, 700, 2, 64),
         (64, 700, 4, 64)]


def _case(c, t, seed):
    rng = np.random.default_rng(seed)
    units = [((rng.standard_normal((7, c, c)) / np.sqrt(7 * c))
              .astype(np.float32),
              (rng.standard_normal((1, c, c)) / np.sqrt(c))
              .astype(np.float32)) for _ in DILATIONS]
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    return x, units


@functools.cache
def _jax_ref(c, t, f, tile_rows, storage):
    """JAX's tile mode on the case's inputs (one interpret-mode compile per
    shape), as f32 numpy in (B, T, C)."""
    x, units = _case(c, t, seed=c + t)
    out = jax_stack(jnp.asarray(x).astype(storage),
                    tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in units),
                    dilations=DILATIONS, int8_dots=True, int8_scale="tile",
                    fold=f, tile_rows=tile_rows, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port(c, t, f, tile_rows, storage):
    x, units = _case(c, t, seed=c + t)
    xt = torch.from_numpy(x).transpose(1, 2).contiguous() \
        .to(getattr(torch, storage))
    pu = [(torch.from_numpy(a).permute(2, 1, 0),
           torch.from_numpy(b).permute(2, 1, 0)) for a, b in units]
    out = port.folded_residual_stack(xt, pu, dilations=DILATIONS,
                                     int8_dots=True, int8_scale="tile",
                                     fold=f, tile_rows=tile_rows)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    return out.float().transpose(1, 2).numpy()


def _near_share(out, ref):
    """(max error / peak, share of outputs within NEAR of the peak)."""
    peak = float(np.abs(ref).max())
    err = np.abs(out - ref)
    return float(err.max()) / peak, float((err <= NEAR * peak).mean())


_jax_elu_jit = jax.jit(
    lambda v: jnp.where(v > 0, v, jnp.exp(jnp.minimum(v, 0.0)) - 1.0))


def _jax_elu(v: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's ELU with XLA's exp, on the CPU."""
    return torch.from_numpy(np.array(_jax_elu_jit(v.numpy())))


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,t,f,tile_rows", CASES)
def test_tile_plain_matches_jax(c, t, f, tile_rows, storage, monkeypatch):
    ref = _jax_ref(c, t, f, tile_rows, storage)
    rel, share = _near_share(_port(c, t, f, tile_rows, storage), ref)
    assert rel <= STEP and share >= SHARE, (rel, share)
    monkeypatch.setattr(port, "elu_exp", _jax_elu)
    np.testing.assert_array_equal(_port(c, t, f, tile_rows, storage), ref)


@pytest.mark.parametrize("other", [16, 1024])
def test_another_tiling_misses(other):
    """The halo rows are recomputed in every tile with that tile's scales,
    so tile_rows changes the function: the port at another tile_rows (1024:
    one tile, the chain run once over the whole signal) misses JAX's at 64
    on most outputs, while the same tile_rows meets it."""
    c, t, f, tile_rows = CASES[1]
    ref = _jax_ref(c, t, f, tile_rows, "float32")
    assert fold.pick_tile(fold.padded_rows(t, f), other) != \
        fold.pick_tile(fold.padded_rows(t, f), tile_rows)
    _, share = _near_share(_port(c, t, f, other, "float32"), ref)
    assert share < SHARE, share


def test_scale_without_halo_misses(monkeypatch):
    """One scale per output tile, taken without the halo rows (the tile's
    own rows of the current window), misses JAX on most outputs."""
    c, t, f, tile_rows = CASES[2]
    ref = _jax_ref(c, t, f, tile_rows, "float32")
    g = port.tile_geometry(c, t, DILATIONS, f, tile_rows)
    own = g.rows_tile * g.f

    def own_rows_scale(y):
        s = y[..., -own:].abs().amax(dim=(1, 2), keepdim=True)
        r = torch.full_like(s, port.INT8_QMAX) / torch.clamp(s, min=1e-12)
        return torch.round(torch.clamp(y * r, -127, 127)), \
            s * (1.0 / port.INT8_QMAX)

    monkeypatch.setattr(port, "_quantize_windows", own_rows_scale)
    _, share = _near_share(_port(c, t, f, tile_rows, "float32"), ref)
    assert share < SHARE, share


def test_whole_row_padding_misses(monkeypatch):
    """T padded only to whole folded rows, not to a multiple of align * f
    rows: the row count, so the tiles and the last window's scale, change,
    and the port misses JAX on most outputs."""
    c, t, f, tile_rows = CASES[0]
    ref = _jax_ref(c, t, f, tile_rows, "float32")
    monkeypatch.setattr(port, "padded_rows", lambda t_, f_: -(-t_ // f_))
    _, share = _near_share(_port(c, t, f, tile_rows, "float32"), ref)
    assert share < SHARE, share


def test_pick_tile_matches_jax():
    for n_rows in list(range(1, 600)) + [8192, 10240, 20224, 40192, 80128,
                                         120064, 60160, 30208, 4096]:
        for target in (16, 64, 100, 256, 512, 1024):
            assert fold.pick_tile(n_rows, target) == \
                jax_pick_tile(n_rows, target), (n_rows, target)


def _jax_tiling(c, t, f, tile_rows, dilations):
    """(n_rows, rows_tile, n_tiles, h_total) of JAX's pallas_call, read from
    its jaxpr (no compile): the grid, the halo block and the row block."""
    units = tuple((jnp.zeros((7, c, c)), jnp.zeros((1, c, c)))
                  for _ in dilations)
    jaxpr = jax.make_jaxpr(lambda x: jax_stack(
        x, units, dilations=dilations, int8_dots=True, int8_scale="tile",
        fold=f, tile_rows=tile_rows, interpret=True))(jnp.zeros((1, t, c)))

    def find(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "pallas_call":
                return eqn
            for p in eqn.params.values():
                inner = getattr(p, "jaxpr", None)
                inner = getattr(inner, "jaxpr", inner)
                if inner is not None and hasattr(inner, "eqns"):
                    hit = find(inner)
                    if hit is not None:
                        return hit
        return None

    gm = find(jaxpr.jaxpr).params["grid_mapping"]

    def block(bm):
        return [getattr(b, "block_size", b) for b in bm.block_shape]

    halo, rows = gm.block_mappings[0], gm.block_mappings[1]
    return (rows.array_aval.shape[1], block(rows)[1], gm.grid[1],
            block(halo)[2])


@pytest.mark.parametrize("dilations", [(1, 3, 9), (2,)])
def test_padding_and_halo_match_jax(dilations):
    """The padded row count, the tile, the tile count and h_total against
    the shapes of JAX's pallas_call, over both align regimes, folds 1-16
    and ragged T."""
    for c, t, f, tile_rows in ((32, 700, 4, 64), (32, 2100, 8, 64),
                               (32, 4801, 16, 512), (64, 321, 2, 1024),
                               (64, 5000, 8, 100), (128, 203, 1, 64),
                               (128, 40000, 4, 512), (256, 8000, 2, 512),
                               (256, 8000, 1, 1024), (8, 4097, 0, 256)):
        g = port.tile_geometry(c, t, dilations, f, tile_rows)
        assert (g.n_rows, g.rows_tile, g.n_tiles, g.halo) == \
            _jax_tiling(c, t, f, tile_rows, dilations), (c, t, f, tile_rows)
