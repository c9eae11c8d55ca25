"""The port's parallel codecs (parallel/codec.py `make_sharded_codec`,
`_left_halo`; parallel/tp.py `generator_tp_specs`, `make_tp_codec`) and
the runtime helpers (parallel/distributed.py `process_shard`,
`host_local_rows`, `global_to_host_local`) in eight gloo ranks, against the
JAX package on tests/test_parallel.py's tiny codec and input.

The port's side runs once: bin/multihost_probe.py's `codec_cases` worker in
eight ranks (each imports torch and the port only) runs every case on a
mesh of the first ranks it needs and writes the whole outputs.  JAX's
references are its unsharded functions, jitted once here, as
tests/test_parallel.py holds JAX's own sharded and channel-parallel codecs.

Bars (tests/test_parallel.py's): indices equal; the waveform within rtol
1e-5 / atol 1e-6 (1e-5 / 1e-5 with the shard-local folds, whose convs run
at other shapes); the mixed mode's indices equal to float32's and its
waveform within 0.05.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from audiodec_tpu.models.autoencoder import (
    GeneratorConfig,
    decoder_apply,
    encoder_apply,
    generator_init,
    projector_apply,
)
from audiodec_tpu.models.vocoder import VocoderConfig, vocoder_apply
from audiodec_tpu.ops.vq import rvq_forward_index, rvq_lookup
from audiodec_tpu.parallel import generator_tp_specs as jax_tp_specs
from audiodec_tpu_torch.bin.multihost_probe import run_ranks
from audiodec_tpu_torch.models import autoencoder as ae
from audiodec_tpu_torch.models import vocoder as voc
from audiodec_tpu_torch.parallel import (
    encoder_halo_samples,
    generator_tp_specs,
)
from audiodec_tpu_torch.parallel.codec import decoder_halo_frames
from audiodec_tpu_torch.train.optim import tree_leaves
from audiodec_tpu_torch.utils import bridge

torch.set_num_threads(1)

CFG = GeneratorConfig(encode_channels=4, decode_channels=4, code_dim=16,
                      codebook_num=2, codebook_size=32)
PORT_CFG = ae.GeneratorConfig(encode_channels=4, decode_channels=4,
                              code_dim=16, codebook_num=2, codebook_size=32)
VOC = dict(in_channels=16, channels=16, upsample_scales=(5, 5, 4, 3),
           upsample_kernel_sizes=(10, 10, 8, 6), resblock_kernel_sizes=(3,),
           resblock_dilations=((1, 3),), groups=2)
WORLD = 8

CASES = [
    dict(name="s2", kind="sharded", data=2, seq=2),
    dict(name="s4", kind="sharded", data=2, seq=4),
    dict(name="hop", kind="sharded", data=1, seq=8, input="x_hop"),
    dict(name="voc", kind="sharded", data=2, seq=4, vocoder=True),
    dict(name="fold2", kind="sharded", data=2, seq=2, encode_fold=2,
         decode_fold=2),
    dict(name="fold4", kind="sharded", data=2, seq=2, encode_fold=4,
         decode_fold=4),
    dict(name="voc_fold", kind="sharded", data=2, seq=2, vocoder=True,
         decode_fold=2),
    dict(name="mixed", kind="sharded", data=2, seq=2, dtype="mixed"),
    dict(name="tp2", kind="tp", data=2, model=2),
    dict(name="tp4", kind="tp", data=2, model=4),
    dict(name="bias_s2", kind="sharded", data=2, seq=2, params="biased"),
    dict(name="bias_hop", kind="sharded", data=1, seq=8, input="x_hop",
         params="biased"),
]


def _biased(params):
    """The params with every conv bias drawn from a seed at scale 3 (the
    init's are 0): a conv of zeros is then its bias, not 0, large enough
    against the init's 0.01 weights to move this tiny codebook's
    indices."""
    rng = np.random.default_rng(9)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (3.0 * rng.standard_normal(a.shape)).astype(
            np.float32) if getattr(path[-1], "key", None) == "b"
        else np.asarray(a), params)


@pytest.fixture(scope="module")
def setup():
    """tests/test_parallel.py's params and input, the multi-hop input
    (1, 8 shards x 2 frames), and a vocoder (the port's seeded draw, with
    the JAX package's init's shapes and scales, as a JAX tree: JAX's own
    draw compiles once per weight shape)."""
    params = generator_init(jax.random.PRNGKey(0), CFG)
    hop = CFG.hop_length
    x = (0.3 * np.random.default_rng(0).standard_normal(
        (2, 4 * 20 * hop, 1))).astype(np.float32)
    x_hop = (0.3 * np.random.default_rng(1).standard_normal(
        (1, WORLD * 2 * hop, 1))).astype(np.float32)
    voc_params = bridge.vocoder_params_to_jax(voc.vocoder_init(
        voc.VocoderConfig(**VOC), torch.Generator().manual_seed(7)))
    return params, x, x_hop, voc_params


def _unsharded(params, voc_params=None):
    """JAX's unsharded encode and decode (and vocode) of a tree, jitted."""

    @jax.jit
    def encode(v):
        h = encoder_apply(params["encoder"], v, CFG)
        z = projector_apply(params["projector"], h, CFG)
        return rvq_forward_index(z, params["quantizer"])[1]

    @jax.jit
    def decode(idx):
        return decoder_apply(params["decoder"],
                             rvq_lookup(idx, params["quantizer"]), CFG)

    @jax.jit
    def vocode(idx):
        return vocoder_apply(voc_params, rvq_lookup(idx, params["quantizer"]),
                             VocoderConfig(**VOC))

    return encode, decode, vocode


@pytest.fixture(scope="module")
def reference(setup):
    """JAX's unsharded indices and waveforms of both inputs."""
    params, x, x_hop, voc_params = setup
    encode, decode, vocode = _unsharded(params, voc_params)
    out = {}
    for name, v in (("x", x), ("x_hop", x_hop)):
        idx = encode(jnp.asarray(v))
        out[name] = (np.asarray(idx), np.asarray(decode(idx)),
                     np.asarray(vocode(idx)))
    return out


@pytest.fixture(scope="module")
def port(setup, tmp_path_factory):
    """Every case in eight gloo ranks -> [each rank's results]."""
    params, x, x_hop, voc_params = setup
    root = tmp_path_factory.mktemp("parallel_codec")
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    torch.save({"params": bridge.params_from_jax(np_tree),
                "biased": bridge.params_from_jax(_biased(params)),
                "cfg": PORT_CFG,
                "voc": (bridge.vocoder_params_from_jax(
                    jax.tree_util.tree_map(np.asarray, voc_params)),
                        voc.VocoderConfig(**VOC)),
                "x": x, "x_hop": x_hop, "cases": CASES, "reps": 0,
                "helpers_data": 2}, root / "in.pt")
    run_ranks(WORLD, ["--worker", "codec_cases", "--in", str(root / "in.pt"),
                      "--out", str(root), "--device", "cpu", "--threads",
                      "1"], timeout=300)
    return [torch.load(root / f"rank{i}.pt", weights_only=False)
            for i in range(WORLD)]


def _case(port, name):
    return port[0][name]


def test_the_multi_hop_cases_are_multi_hop(setup):
    """The halos outrun a shard where the tests say they do: seq = 4 over
    80 frames (20-frame shards) and the 2-frame shards of `hop`."""
    hop = CFG.hop_length
    assert encoder_halo_samples(PORT_CFG) > 20 * hop > 0
    assert decoder_halo_frames(PORT_CFG) > 20
    assert encoder_halo_samples(PORT_CFG) > 8 * 2 * hop


@pytest.mark.parametrize("name,inp", [("s2", "x"), ("s4", "x"),
                                      ("hop", "x_hop")])
def test_sharded_encode_decode_match_jax(port, reference, name, inp):
    idx_ref, y_ref, _ = reference[inp]
    got = _case(port, name)
    np.testing.assert_array_equal(got["idx"], idx_ref)
    np.testing.assert_allclose(got["y"], y_ref, rtol=1e-5, atol=1e-6)


def test_sharded_vocoder_decode_matches_jax(port, reference):
    idx_ref, _, v_ref = reference["x"]
    got = _case(port, "voc")
    np.testing.assert_array_equal(got["idx"], idx_ref)
    np.testing.assert_allclose(got["y"], v_ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["fold2", "fold4", "voc_fold"])
def test_shard_local_folds_match_jax(port, reference, name):
    """The batch folds inside each shard: the encoder fold exact for the
    causal encoder (indices equal), the decode fold to f32 rounding."""
    idx_ref, y_ref, v_ref = reference["x"]
    got = _case(port, name)
    np.testing.assert_array_equal(got["idx"], idx_ref)
    np.testing.assert_allclose(got["y"], v_ref if name == "voc_fold"
                               else y_ref, rtol=1e-5, atol=1e-5)


def test_mixed_mode_keeps_the_f32_indices(port):
    f32, mixed = _case(port, "s2"), _case(port, "mixed")
    np.testing.assert_array_equal(mixed["idx"], f32["idx"])
    assert mixed["y"].dtype == np.float32
    np.testing.assert_allclose(mixed["y"], f32["y"], rtol=0.05, atol=0.05)
    assert not np.array_equal(mixed["y"], f32["y"])


@pytest.mark.parametrize("name", ["tp2", "tp4"])
def test_tensor_parallel_codec_matches_jax(port, reference, name):
    """Channel-parallel: indices equal to the unsharded ones (JAX's own
    make_tp_codec's, tests/test_parallel.py); 0 flips allowed here."""
    idx_ref, y_ref, _ = reference["x"]
    got = _case(port, name)
    np.testing.assert_array_equal(got["idx"], idx_ref)
    np.testing.assert_allclose(got["y"], y_ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tp", [2, 4, 3])
def test_tp_specs_split_jax_s_axes(setup, tp):
    """Each leaf split where JAX's spec splits it, on the same channels:
    JAX's (K, I, O) output axis is the port's dim 0 of a conv and dim 1 of
    a transposed conv, its input axis dim 1; replicated where the width
    does not divide (tp = 3 replicates everything but none)."""
    params = setup[0]
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    ours = dict(tree_leaves(generator_tp_specs(
        bridge.params_from_jax(np_tree), PORT_CFG, tp)))
    theirs = jax_tp_specs(params, CFG, tp)
    flat = jax.tree_util.tree_flatten_with_path(
        theirs, is_leaf=lambda v: isinstance(v, P))[0]
    split = 0
    for path, spec in flat:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        if "quantizer" in key or "bn" in key:
            continue
        transposed = key.startswith("decoder/blocks/") and key.endswith(
            "conv/w")
        want = None
        if isinstance(spec, P) and "model" in tuple(spec):
            axis = tuple(spec).index("model")
            want = {2: 1 if transposed else 0, 1: 1, 0: 0}[axis]
        assert ours[key] == want, key
        split += want is not None
    assert (split > 0) == (tp != 3)


def test_runtime_helpers(port, setup):
    """process_shard strides the list over the world; host_local_rows
    gives each rank its data index's rows whole in time; every rank's
    global_to_host_local is the whole array."""
    x = setup[1]
    shards = [port[r]["helpers"]["shard"] for r in range(WORLD)]
    assert sorted(sum(shards, [])) == list(range(11))
    assert shards[3] == [3]
    for r in range(WORLD):
        h = port[r]["helpers"]
        d = h["coords"]["data"]
        assert h["lo"] == d
        np.testing.assert_array_equal(h["rows"], x[d:d + 1])
        np.testing.assert_array_equal(h["full"], x)


def test_sharded_encode_with_biases_matches_the_unsharded_one(port, setup):
    """With conv biases the first shard takes no halo and a shard nearer
    the start than the halo only the real samples before it, so the
    encoder pads each layer at the utterance's start as the batch path
    does: indices equal the unsharded ones (data 2 x seq 2, and 2-frame
    shards with the chained halo), the waveform within the bar.  JAX's
    sharded encode prepends zeros there (its parallel/codec.py:187-189),
    which a biased conv turns into other inputs for the next layer: on
    the same tree its indices differ (ROADMAP §C), so the case does test
    the difference."""
    from audiodec_tpu.parallel import make_mesh, make_sharded_codec

    params, x, x_hop = _biased(setup[0]), setup[1], setup[2]
    encode, decode, _ = _unsharded(params)
    for name, v in (("bias_s2", x), ("bias_hop", x_hop)):
        idx = np.asarray(encode(jnp.asarray(v)))
        got = _case(port, name)
        np.testing.assert_array_equal(got["idx"], idx)
        np.testing.assert_allclose(got["y"], np.asarray(decode(
            jnp.asarray(idx))), rtol=1e-5, atol=1e-6)
    jax_encode, _ = make_sharded_codec(make_mesh(data=2, seq=2), params, CFG)
    flips = int(np.sum(np.asarray(jax_encode(jnp.asarray(x)))
                       != np.asarray(encode(jnp.asarray(x)))))
    assert flips > 0
