"""`audiodec_tpu_torch/entry.py` against `__graft_entry__.py`.

entry(): the port's fn on JAX's example params (carried across with
utils/bridge.py), on the example's zero input and on a seeded one of its
shape (with zero biases the zero input codes every frame alike), each of
(y, zq, vqloss) within rtol 1e-4 and an atol of 1e-4 of its peak of
JAX's, at the full symAD width, f32 on the CPU.
dryrun_multichip(2): two gloo ranks on the CPU run the three workloads;
a world of another size is refused.
"""

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as jax_entry
from audiodec_tpu_torch import entry
from audiodec_tpu_torch.models.autoencoder import GeneratorConfig
from audiodec_tpu_torch.utils.bridge import params_from_jax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_forward():
    """JAX's fn on its example params, jitted (eager JAX takes longer at
    this width), on its example input and on a seeded input of that shape
    -> (params, [(x, (y, zq, vqloss))])."""
    fn, (params, x) = jax_entry.entry()
    seeded = (0.1 * np.random.default_rng(0).standard_normal(x.shape)
              ).astype(np.float32)
    jfn = jax.jit(fn)
    runs = [(np.asarray(v), jax.tree_util.tree_map(np.asarray,
                                                   jfn(params, v)))
            for v in (x, seeded)]
    return jax.tree_util.tree_map(np.asarray, params), runs


@pytest.mark.parametrize("which", ["example", "seeded"])
def test_entry_matches_jax(jax_forward, which):
    params, runs = jax_forward
    x, (y, zq, vqloss) = runs[("example", "seeded").index(which)]
    fn, (ours, xt) = entry.entry("cpu")
    assert xt.device.type == "cpu" and tuple(xt.shape) == x.shape
    if which == "example":
        assert torch.equal(xt, torch.from_numpy(x))
    else:
        # the codes vary, so the RVQ and the decoder see more than one code
        assert len(np.unique(zq.reshape(-1, zq.shape[-1]), axis=0)) > 1
    got = fn(params_from_jax(params), torch.from_numpy(x))
    for g, w in zip(got, (y, zq, vqloss)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    # the port's own seeded params: the same shapes, finite
    own = fn(ours, xt)
    assert [tuple(t.shape) for t in own] == [w.shape for w in (y, zq, vqloss)]
    assert all(torch.isfinite(t).all() for t in own)
    assert ours["quantizer"]["embed"].shape == (
        GeneratorConfig().codebook_num, GeneratorConfig().codebook_size,
        GeneratorConfig().code_dim)


def test_dryrun_multichip_on_two_ranks():
    lines = entry.dryrun_multichip(2, "cpu")
    assert len(lines) == 2
    for line in lines:
        assert line.startswith("dryrun_multichip(2): ok - dp train step + "
                               "1x2 chunk-halo transcode (direct: indices "
                               "equal;"), line
        assert "gloo on cpu" in line


def test_dryrun_multichip_refuses_another_world(monkeypatch):
    """In torchrun's environment of one rank, a dryrun over two ranks is
    refused with how to start them."""
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    from audiodec_tpu_torch.bin.multihost_probe import free_port
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    try:
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
            entry.dryrun_multichip(2, "cpu")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
