"""The port's fused RVQ encode against the JAX Pallas kernel
`audiodec_tpu/archive/vq_kernel.py rvq_encode_pallas`.

On the CPU the port's wrapper runs its plain PyTorch version; JAX runs its
kernel in interpret mode, at tests/test_pallas_vq.py's shapes (the last one
pads to a whole tile).  The CUDA kernel (csrc/rvq_encode.cu) is held to the
plain version on the card by chip_smoke.py.
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
from audiodec_tpu_torch.ops.vq import rvq_forward_index

torch.set_num_threads(1)

CASES = [((4, 32, 16), (2, 10), 0, 0), ((8, 1024, 64), (1, 300), 0, 0),
         ((2, 16, 8), (1, 3), 1, 1)]


def _case(q, n, d, bt, key, seed):
    params = jax.tree_util.tree_map(
        np.array, rvq_init(jax.random.PRNGKey(key), q, n, d))
    z = (np.random.default_rng(seed).standard_normal((*bt, d))
         .astype(np.float32))
    return params, z


@pytest.mark.parametrize("qnd,bt,key,seed", CASES)
def test_plain_matches_jax_kernel(qnd, bt, key, seed):
    params, z = _case(*qnd, bt, key, seed)
    jzq, jidx = jax_rvq_encode(jnp.asarray(z), jnp.asarray(params["embed"]),
                               interpret=True)
    zq, idx = port.rvq_encode_pallas(torch.from_numpy(z),
                                     torch.from_numpy(params["embed"]))
    assert idx.dtype == torch.int32 and zq.dtype == torch.float32
    assert tuple(idx.shape) == (*bt, qnd[0]) and tuple(zq.shape) == z.shape
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    # both gather exactly and update with the same subtraction and sum
    np.testing.assert_array_equal(zq.numpy(), np.asarray(jzq))


@pytest.mark.parametrize("qnd,bt,key,seed", CASES)
def test_fast_entry_and_forward_index_agree(qnd, bt, key, seed):
    params, z = _case(*qnd, bt, key, seed)
    zt = torch.from_numpy(z)
    tparams = {"embed": torch.from_numpy(params["embed"])}
    zq, idx = port.rvq_encode_pallas(zt, tparams["embed"])
    zq_f, idx_f = port.rvq_encode_fast(zt, tparams)
    assert torch.equal(zq_f, zq) and torch.equal(idx_f, idx)
    _, idx_ref = rvq_forward_index(zt, tparams)
    assert torch.equal(idx, idx_ref)
    _, jidx = jax_rvq_forward_index(jnp.asarray(z), params)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_rejects_what_the_kernel_does_not_take():
    embed = torch.zeros(2, 16, 8)
    with pytest.raises(TypeError, match="float32"):
        port.rvq_encode_pallas(torch.zeros(1, 3, 8, dtype=torch.float64),
                               embed)
    with pytest.raises(ValueError, match="does not fit"):
        port.rvq_encode_pallas(torch.zeros(1, 3, 4), embed)
    with pytest.raises(ValueError, match="no kernel"):
        port.rvq_encode_pallas(torch.zeros(1, 3, 8, device="meta"),
                               embed.to("meta"))
    assert port.launches == 0
