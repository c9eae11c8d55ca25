"""`ops/vq.py` `vq_distances_exact` and `rvq_shortlist_ranks` against the JAX
package's (`audiodec_tpu/ops/vq.py:96`, `:108`).

Inputs from a seeded numpy generator: codebooks of near neighbours (so a
bf16 first pass misranks some frames) and z drawn near their sums.  The
distances within rtol 1e-6, atol 1e-5 of JAX's (the same f32 expansion,
summed in another order); the ranks equal, with an f32 first pass (all 0)
and with a bf16 one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiodec_tpu.ops import vq as jax_vq
from audiodec_tpu_torch.ops import vq

torch.set_num_threads(1)

Q, N, D = 4, 64, 16


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    centres = rng.standard_normal((Q, 8, D))
    embed = (np.repeat(centres, N // 8, axis=1)
             + 0.01 * rng.standard_normal((Q, N, D))).astype(np.float32)
    pick = rng.integers(0, N, (2, 40, Q))
    z = sum(embed[q][pick[..., q]] for q in range(Q))
    z = (z + 0.005 * rng.standard_normal(z.shape)).astype(np.float32)
    return z, {"embed": embed}


def test_vq_distances_exact_matches_jax(case):
    z, params = case
    for q in range(Q):
        got = vq.vq_distances_exact(torch.from_numpy(z),
                                    torch.from_numpy(params["embed"][q]))
        want = np.asarray(jax_vq.vq_distances_exact(
            jnp.asarray(z), jnp.asarray(params["embed"][q])))
        assert got.shape == want.shape == (2, 40, N)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
        assert torch.equal(got, vq.vq_distances(
            torch.from_numpy(z), torch.from_numpy(params["embed"][q])))


@pytest.mark.parametrize("pass1", [None, "bfloat16"])
def test_rvq_shortlist_ranks_match_jax(case, pass1):
    z, params = case
    got = vq.rvq_shortlist_ranks(
        torch.from_numpy(z), {"embed": torch.from_numpy(params["embed"])},
        pass1_dtype=None if pass1 is None else getattr(torch, pass1))
    want = np.asarray(jax_vq.rvq_shortlist_ranks(
        jnp.asarray(z), {"embed": jnp.asarray(params["embed"])},
        pass1_dtype=None if pass1 is None else getattr(jnp, pass1)))
    assert got.dtype == torch.int32 and got.shape == want.shape == (2, 40, Q)
    np.testing.assert_array_equal(got.numpy(), want)
    if pass1 is None:
        assert not want.any()
    else:
        assert want.max() > 0


def test_shortlist_of_the_rank_bound_is_exact(case):
    """vq_nearest_2pass with k = max rank + 1 gives the exact argmin."""
    z, params = case
    zt, embed = torch.from_numpy(z), torch.from_numpy(params["embed"][0])
    ranks = vq.rvq_shortlist_ranks(zt, {"embed": embed[None]})
    k = int(ranks.max()) + 1
    assert torch.equal(vq.vq_nearest_2pass(zt, embed, k=k),
                       vq.vq_nearest(zt, embed))
