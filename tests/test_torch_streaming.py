"""The port's streaming codec (ops/conv.py and models/*.py with `state=`,
streaming/engine.py) against the reference goldens' streaming outputs and
against the JAX package's streaming path.

Every golden comparison streams from the zero state on the CPU; the
tolerances are those of tests/test_generator_parity.py and
tests/test_vocoder_parity.py: indices 0 flips, z and zq rtol 1e-4 and atol
1e-4, the decoder's waveform rtol 1e-3 and atol 1e-4, the vocoder's rtol
1e-3 and atol 1e-5.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiodec_tpu.models import autoencoder as jax_ae
from audiodec_tpu.ops import conv as jax_conv
from audiodec_tpu.utils.torch_import import import_autoencoder
from audiodec_tpu_torch.models import autoencoder as ae
from audiodec_tpu_torch.models.autoencoder import GeneratorConfig
from audiodec_tpu_torch.models.vocoder import (
    VocoderConfig,
    vocoder_apply,
    vocoder_init,
    vocoder_state_init,
)
from audiodec_tpu_torch.ops import conv
from audiodec_tpu_torch.ops.vq import rvq_forward_index, rvq_lookup
from audiodec_tpu_torch.streaming import (
    StreamingCodec,
    scan_streaming_decode,
    scan_streaming_encode,
)
from audiodec_tpu_torch.utils.bridge import (
    params_from_jax,
    params_from_reference_sd,
    state_from_jax,
    state_to_jax,
    tree_map,
    vocoder_params_from_reference_sd,
)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SMALL = dict(encode_channels=4, decode_channels=4, code_dim=16,
             codebook_num=4, codebook_size=32)
# the goldens' configs (tests/test_generator_parity.py:29-41)
GEN = {"gen_small": GeneratorConfig(**SMALL),
       "gen_symaad": GeneratorConfig(**SMALL, codec="activate_audiodec"),
       "gen_symad": GeneratorConfig(),
       "gen_symad_trained": GeneratorConfig(),
       "gen_symad_trained_12k": GeneratorConfig(),
       "gen_symad_trained_20k": GeneratorConfig(),
       "gen_symad_trained_final": GeneratorConfig(),
       "gen_denoise_trained": GeneratorConfig()}
# tests/test_vocoder_parity.py:20-37
VOC = {"voc_mrf": VocoderConfig(
           in_channels=16, channels=32, upsample_scales=(5, 5, 4, 3),
           upsample_kernel_sizes=(10, 10, 8, 6)),
       "voc_group": VocoderConfig(
           in_channels=16, channels=32, upsample_scales=(5, 5, 4, 3),
           upsample_kernel_sizes=(10, 10, 8, 6), resblock_kernel_sizes=(11,),
           resblock_dilations=((1, 3, 5),), groups=3, stats=True),
       "voc_v1_small_trained": VocoderConfig(
           in_channels=64, channels=128, upsample_scales=(5, 5, 4, 3),
           upsample_kernel_sizes=(10, 10, 8, 6), resblock_kernel_sizes=(11,),
           resblock_dilations=((1, 3, 5),), groups=3, stats=True)}
# tests/test_streaming.py's config
CFG = GeneratorConfig(encode_channels=2, decode_channels=2, code_dim=8,
                      codebook_num=2, codebook_size=16)


def _sd(data):
    return {k[len("sd__"):]: data[k] for k in data.files
            if k.startswith("sd__")}


def _gen_case(name):
    data = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    cfg = GEN[name]
    return data, cfg, params_from_reference_sd(_sd(data), cfg)


def _x(data):
    return torch.from_numpy(np.ascontiguousarray(
        data["x"].transpose(0, 2, 1)))


# ---------------------------------------------------------------------------
# the goldens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GEN))
def test_encode_stream_golden(name):
    """Whole-signal streaming encode from the zero state: z_stream within
    1e-4, idx_stream (the reference's flat (Q, T') format) with 0 flips,
    zq_stream within 1e-4."""
    data, cfg, params = _gen_case(name)
    state = ae.codec_state_init(1, cfg)
    h, _ = ae.encoder_apply(params["encoder"], _x(data), cfg,
                            state=state["encoder"])
    z, _ = ae.projector_apply(params["projector"], h, cfg,
                              state=state["projector"])
    np.testing.assert_allclose(z.numpy().transpose(0, 2, 1),
                               data["z_stream"], rtol=1e-4, atol=1e-4)
    _, idx = rvq_forward_index(z, params["quantizer"], flatten=True)
    np.testing.assert_array_equal(idx[0].numpy().T, data["idx_stream"])
    zq = rvq_lookup(idx, params["quantizer"], flattened=True)
    np.testing.assert_allclose(zq.numpy(), data["zq_stream"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", sorted(GEN))
def test_decode_stream_golden(name):
    """StreamingCodec on the CPU: one encode and one decode call over the
    whole signal give idx_stream and y_stream (rtol 1e-3, atol 1e-4)."""
    data, cfg, params = _gen_case(name)
    codec = StreamingCodec(params, cfg, device="cpu")
    idx = codec.encode(_x(data))
    np.testing.assert_array_equal(idx[0].numpy().T, data["idx_stream"])
    y = codec.decode(idx)
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 1),
                               data["y_stream"], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", sorted(GEN))
def test_hop_by_hop_golden(name):
    """One hop per encode and per decode call: y_hops (rtol 1e-3, atol
    1e-4), through generator_encode / generator_decode with state."""
    data, cfg, params = _gen_case(name)
    hop, x = cfg.hop_length, _x(data)
    state = ae.codec_state_init(1, cfg)
    enc = {"encoder": state["encoder"], "projector": state["projector"]}
    dec = {"decoder": state["decoder"]}
    outs = []
    for i in range(int(data["n_hops"])):
        idx, enc = ae.generator_encode(params, x[:, i * hop:(i + 1) * hop],
                                       cfg, state=enc)
        y, dec = ae.generator_decode(params, idx, cfg, state=dec)
        outs.append(y.numpy())
    np.testing.assert_allclose(
        np.concatenate(outs, axis=1).transpose(0, 2, 1), data["y_hops"],
        rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", sorted(VOC))
def test_vocoder_stream_golden(name):
    """The vocoder from the zero state: the whole code sequence in one call
    (y_stream) and one frame per call (y_hops), rtol 1e-3, atol 1e-5."""
    data = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    cfg = VOC[name]
    params = vocoder_params_from_reference_sd(_sd(data), cfg)
    c = data["zq"] if "zq" in data.files else data["c"]
    c = torch.from_numpy(np.ascontiguousarray(c.transpose(0, 2, 1)))
    y, _ = vocoder_apply(params, c, cfg, state=vocoder_state_init(1, cfg))
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 1),
                               data["y_stream"], rtol=1e-3, atol=1e-5)
    state, outs = vocoder_state_init(1, cfg), []
    for i in range(data["y_hops"].shape[-1] // cfg.hop_length):
        y, state = vocoder_apply(params, c[:, i:i + 1], cfg, state=state)
        outs.append(y.numpy())
    np.testing.assert_allclose(
        np.concatenate(outs, axis=1).transpose(0, 2, 1), data["y_hops"],
        rtol=1e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """gen_small's weights for both packages."""
    data = np.load(os.path.join(GOLDEN, "gen_small.npz"))
    jcfg = jax_ae.GeneratorConfig(**SMALL)
    jparams = jax.tree_util.tree_map(np.asarray,
                                     import_autoencoder(_sd(data), jcfg))
    return jcfg, jparams, GeneratorConfig(**SMALL), params_from_jax(jparams)


def test_states_after_hops_match_jax(small):
    """Four hops of 2 frames through both packages' generator_encode /
    generator_decode with state: the indices equal, the waveforms within
    rtol 1e-4, atol 1e-6, and every state leaf within rtol 1e-5, atol 1e-6
    after the last hop (JAX's (B, L, C) against the port's (B, C, L))."""
    jcfg, jparams, cfg, params = small
    hop = cfg.hop_length
    x = (0.3 * np.random.default_rng(0)
         .standard_normal((2, 8 * hop, 1))).astype(np.float32)
    jstate = jax_ae.codec_state_init(2, jcfg)
    state = ae.codec_state_init(2, cfg)
    # the port starts from JAX's zero state, carried across
    state = state_from_jax(jax.tree_util.tree_map(np.asarray, jstate))
    jenc = {"encoder": jstate["encoder"], "projector": jstate["projector"]}
    jdec = {"decoder": jstate["decoder"]}
    enc = {"encoder": state["encoder"], "projector": state["projector"]}
    dec = {"decoder": state["decoder"]}
    for i in range(4):
        chunk = x[:, 2 * i * hop:2 * (i + 1) * hop]
        jidx, jenc = jax_ae.generator_encode(jparams, jnp.asarray(chunk),
                                             jcfg, state=jenc)
        jy, jdec = jax_ae.generator_decode(jparams, jidx, jcfg, state=jdec)
        idx, enc = ae.generator_encode(params, torch.from_numpy(chunk), cfg,
                                       state=enc)
        y, dec = ae.generator_decode(params, idx, cfg, state=dec)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                                   atol=1e-6)
    got = state_to_jax({**enc, **dec})
    want = jax.tree_util.tree_map(np.asarray, {**jenc, **jdec})
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    assert len(flat_got) > 30
    for (path, a), (_, b) in zip(flat_got, flat_want):
        assert a.shape == b.shape, path
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                   err_msg=str(path))
    # and back: the bridge is its own inverse
    back = state_to_jax(state_from_jax(want))
    for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                              flat_want):
        np.testing.assert_array_equal(a, b)


def test_conv1d_bn_streaming_matches_jax():
    """Eval-mode BN on the conv1d_bn streaming path (gen_symad_bn, B = 2):
    the port's streaming z equals JAX's within rtol 1e-5, atol 1e-6, and
    its indices JAX's; from the zero state both equal the batch eval z of
    the golden (rtol 1e-4, atol 1e-4), since BN is position-independent."""
    data = np.load(os.path.join(GOLDEN, "gen_symad_bn.npz"))
    kw = dict(SMALL, projector="conv1d_bn")
    jcfg, cfg = jax_ae.GeneratorConfig(**kw), GeneratorConfig(**kw)
    jparams = import_autoencoder(_sd(data), jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    x = np.ascontiguousarray(data["x"].transpose(0, 2, 1))
    jstate = jax_ae.codec_state_init(2, jcfg)
    jh, _ = jax_ae.encoder_apply(jparams["encoder"], jnp.asarray(x), jcfg,
                                 state=jstate["encoder"])
    jz, _ = jax_ae.projector_apply(jparams["projector"], jh, jcfg,
                                   state=jstate["projector"])
    jidx, _ = jax_ae.generator_encode(jparams, jnp.asarray(x), jcfg,
                                      state=jstate)
    state = ae.codec_state_init(2, cfg)
    h, _ = ae.encoder_apply(params["encoder"], torch.from_numpy(x), cfg,
                            state=state["encoder"])
    z, _ = ae.projector_apply(params["projector"], h, cfg,
                              state=state["projector"])
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(z.numpy().transpose(0, 2, 1), data["z"],
                               rtol=1e-4, atol=1e-4)
    idx, _ = ae.generator_encode(params, torch.from_numpy(x), cfg,
                                 state=state)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("k,s", [(10, 5), (8, 4), (6, 3), (4, 2), (16, 8)])
def test_stream_transpose_conv_matches_jax(k, s):
    """causal_conv_transpose1d with state against JAX's: three chunks from
    the zero state, outputs within rtol 1e-5, atol 1e-6, states equal; the
    zero state differs from the batch form's replication pad on the first
    frames, in both packages alike."""
    rng = np.random.default_rng(k * 10 + s)
    cin, cout = 3, 5
    x = rng.standard_normal((2, 9, cin)).astype(np.float32)
    w = (0.3 * rng.standard_normal((cin, cout, k))).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    p = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    jp = {"w": jnp.asarray(np.ascontiguousarray(
        np.transpose(w, (2, 0, 1))[::-1])), "b": jnp.asarray(b)}
    pad = -(-k // s) - 1
    state = conv.causal_transpose_state_init(2, cin, k, s)
    jstate = jax_conv.causal_transpose_state_init(2, cin, k, s)
    assert tuple(state.shape) == (2, cin, pad) and not state.any()
    outs = []
    for lo, hi in ((0, 4), (4, 5), (5, 9)):
        xt = torch.from_numpy(np.ascontiguousarray(
            x[:, lo:hi].transpose(0, 2, 1)))
        y, state = conv.causal_conv_transpose1d(xt, p, stride=s, state=state)
        jy, jstate = jax_conv.causal_conv_transpose1d(
            jnp.asarray(x[:, lo:hi]), jp, stride=s, state=jstate)
        assert tuple(y.shape) == (2, cout, (hi - lo) * s)
        np.testing.assert_allclose(y.numpy().transpose(0, 2, 1),
                                   np.asarray(jy), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(state.numpy().transpose(0, 2, 1),
                                      np.asarray(jstate))
        outs.append(y)
    y_stream = torch.cat(outs, dim=-1).numpy()
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))
    y_batch = conv.causal_conv_transpose1d(xt, p, stride=s).numpy()
    jy_batch = np.asarray(jax_conv.causal_conv_transpose1d(
        jnp.asarray(x), jp, stride=s)).transpose(0, 2, 1)
    np.testing.assert_allclose(y_batch, jy_batch, rtol=1e-5, atol=1e-6)
    # the frames after the first `pad` inputs no longer see the pad
    np.testing.assert_allclose(y_stream[..., pad * s:], y_batch[..., pad * s:],
                               rtol=1e-5, atol=1e-5)
    if pad:
        assert np.abs(y_stream[..., :pad * s]
                      - y_batch[..., :pad * s]).max() > 1e-3


@pytest.mark.parametrize("k,d,s", [(7, 1, 1), (7, 9, 1), (6, 1, 3),
                                   (1, 1, 1)])
def test_stream_conv_matches_jax(k, d, s):
    """causal_conv1d with state against JAX's over three chunks: outputs
    within rtol 1e-5, atol 1e-6, states equal; a 1x1 conv returns its
    (empty) state unchanged."""
    rng = np.random.default_rng(k + 10 * d + 100 * s)
    cin, cout = 3, 4
    x = rng.standard_normal((2, 12 * s, cin)).astype(np.float32)
    w = (0.3 * rng.standard_normal((cout, cin, k))).astype(np.float32)
    p = {"w": torch.from_numpy(w)}
    jp = {"w": jnp.asarray(np.ascontiguousarray(w.transpose(2, 1, 0)))}
    state = conv.causal_state_init(2, cin, k, d)
    jstate = jax_conv.causal_state_init(2, cin, k, d)
    for lo, hi in ((0, 3 * s), (3 * s, 4 * s), (4 * s, 12 * s)):
        xt = torch.from_numpy(np.ascontiguousarray(
            x[:, lo:hi].transpose(0, 2, 1)))
        before = state
        y, state = conv.causal_conv1d(xt, p, stride=s, dilation=d,
                                      state=state)
        jy, jstate = jax_conv.causal_conv1d(jnp.asarray(x[:, lo:hi]), jp,
                                            stride=s, dilation=d,
                                            state=jstate)
        np.testing.assert_allclose(y.numpy().transpose(0, 2, 1),
                                   np.asarray(jy), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(state.numpy().transpose(0, 2, 1),
                                      np.asarray(jstate))
        if k == 1:
            assert state is before


def test_bf16_stream_matches_jax(small):
    """StreamingCodec(dtype=bfloat16) at gen_small width against JAX's:
    dtype sets only the zero states, which the first hop promotes to
    float32, so over three hops the indices equal, the waveforms agree
    within rtol 1e-4, atol 1e-6, and every state ends in float32."""
    from audiodec_tpu.streaming import StreamingCodec as JaxStreamingCodec

    jcfg, jparams, cfg, params = small
    hop = cfg.hop_length
    x = _noise(4, (1, 3 * hop, 1))
    jcodec = JaxStreamingCodec(jparams, jcfg, dtype=jnp.bfloat16)
    codec = StreamingCodec(params, cfg, dtype=torch.bfloat16, device="cpu")
    assert all(s.dtype == torch.bfloat16 for s in _leaves(codec.enc_state))
    for i in range(3):
        chunk = x[:, i * hop:(i + 1) * hop]
        jidx = jcodec.encode(jnp.asarray(chunk))
        jy = jcodec.decode(jidx)
        idx = codec.encode(chunk)
        y = codec.decode(idx)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert y.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                                   atol=1e-6)
    for s in (*_leaves(codec.enc_state), *_leaves(codec.dec_state)):
        assert s.dtype == torch.float32


# ---------------------------------------------------------------------------
# the engine's identities (tests/test_streaming.py on the port)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return ae.generator_init(CFG, torch.Generator().manual_seed(3))


def _noise(seed, shape):
    return (0.2 * np.random.default_rng(seed)
            .standard_normal(shape)).astype(np.float32)


def test_hop_by_hop_equals_scan(params):
    hop, n = CFG.hop_length, 8
    x = _noise(0, (1, n * hop, 1))
    codec = StreamingCodec(params, CFG, device="cpu")
    idxs, ys = [], []
    for i in range(n):
        idx = codec.encode(x[:, i * hop:(i + 1) * hop])
        idxs.append(idx)
        ys.append(codec.decode(idx))
    idx_scan = scan_streaming_encode(params, CFG, x, device="cpu")
    assert torch.equal(torch.cat(idxs, dim=1), idx_scan)
    y_scan = scan_streaming_decode(params, CFG, idx_scan, device="cpu")
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), y_scan.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_streaming_precision_exact(params):
    """precision="exact" runs the two-pass argmin; with TF32 off both
    passes are f32, so the indices equal the default path's."""
    hop = CFG.hop_length
    x = _noise(5, (1, 6 * hop, 1))
    c_def = StreamingCodec(params, CFG, device="cpu")
    c_ex = StreamingCodec(params, CFG, precision="exact", device="cpu")
    assert c_ex.exact_k == 16 and c_def.exact_k is None
    for i in range(6):
        chunk = x[:, i * hop:(i + 1) * hop]
        assert torch.equal(c_def.encode(chunk), c_ex.encode(chunk))
    with pytest.raises(ValueError):
        StreamingCodec(params, CFG, precision="exact", dtype=torch.bfloat16,
                       device="cpu")
    with pytest.raises(ValueError):
        StreamingCodec(params, CFG, precision="fast", device="cpu")


def test_multi_hop_chunks_equal_single_hops(params):
    hop = CFG.hop_length
    x = _noise(1, (1, 4 * hop, 1))
    once = StreamingCodec(params, CFG, device="cpu")
    idx_once = once.encode(x)
    y_once = once.decode(idx_once)
    hops = StreamingCodec(params, CFG, device="cpu")
    idx_hops = [hops.encode(x[:, i * hop:(i + 1) * hop]) for i in range(4)]
    assert torch.equal(idx_once, torch.cat(idx_hops, dim=1))
    y_hops = torch.cat([hops.decode(i) for i in idx_hops], dim=1)
    np.testing.assert_allclose(y_once.numpy(), y_hops.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_streaming_vocoder_decode(params):
    # channels=16: tests/test_streaming.py's 8 leaves the last stage with
    # 8 // 16 = 0 channels, which JAX takes and torch's convs refuse
    voc_cfg = VocoderConfig(in_channels=CFG.code_dim, channels=16,
                            upsample_scales=(5, 5, 4, 3),
                            upsample_kernel_sizes=(10, 10, 8, 6),
                            resblock_kernel_sizes=(3,),
                            resblock_dilations=((1, 3),), groups=2)
    voc = vocoder_init(voc_cfg, torch.Generator().manual_seed(8))
    # weights at 0.3 so that the output is far from zero
    voc = tree_map(lambda a: a * 30.0, voc)
    p = dict(params, vocoder=voc)
    codec = StreamingCodec(p, CFG, voc_cfg=voc_cfg, device="cpu")
    hop = CFG.hop_length
    x = _noise(2, (1, 3 * hop, 1))
    idx = codec.encode(x)
    y = codec.decode(idx)
    assert tuple(y.shape) == (1, 3 * hop, 1) and y.abs().max() > 1e-3
    codec.reset()
    assert torch.equal(codec.encode(x), idx)
    y_scan = scan_streaming_decode(p, CFG, idx, voc_cfg=voc_cfg,
                                   device="cpu")
    np.testing.assert_allclose(y.numpy(), y_scan.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_batched_concurrent_streams_equal_independent(params):
    """StreamingCodec(batch=B): each row's indices equal that stream run
    alone at batch 1, and its waveform within rtol 1e-4, atol 1e-6."""
    hop, n, b = CFG.hop_length, 6, 3
    x = _noise(11, (b, n * hop, 1))
    batched = StreamingCodec(params, CFG, batch=b, device="cpu")
    idx_b, y_b = [], []
    for i in range(n):
        idx = batched.encode(x[:, i * hop:(i + 1) * hop])
        idx_b.append(idx)
        y_b.append(batched.decode(idx))
    idx_b, y_b = torch.cat(idx_b, dim=1), torch.cat(y_b, dim=1)
    for r in range(b):
        solo = StreamingCodec(params, CFG, device="cpu")
        idx_s = [solo.encode(x[r:r + 1, i * hop:(i + 1) * hop])
                 for i in range(n)]
        y_s = torch.cat([solo.decode(i) for i in idx_s], dim=1)
        assert torch.equal(torch.cat(idx_s, dim=1)[0], idx_b[r])
        np.testing.assert_allclose(y_s[0].numpy(), y_b[r].numpy(),
                                   rtol=1e-4, atol=1e-6)


def test_warmup_primes_the_state(params):
    """warmup streams zeros: the state moves off zero, reset zeroes it."""
    codec = StreamingCodec(params, CFG, device="cpu")
    codec.warmup(receptive_length=2 * CFG.hop_length)
    assert any(bool(s.any()) for s in _leaves(codec.dec_state))
    codec.reset()
    assert not any(bool(s.any()) for s in _leaves(codec.dec_state))
    assert not any(bool(s.any()) for s in _leaves(codec.enc_state))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_streaming_needs_causal_mode(params):
    cfg = dataclasses.replace(CFG, mode="noncausal")
    with pytest.raises(ValueError):
        StreamingCodec(params, cfg, device="cpu").encode(
            np.zeros((1, cfg.hop_length, 1), np.float32))


def test_entry_points_default_to_the_card(params, monkeypatch):
    """With no device given, the entry points ask for CUDA and raise on a
    machine without it: no silent fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingCodec(params, CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        scan_streaming_encode(params, CFG,
                              np.zeros((1, CFG.hop_length, 1), np.float32))
