"""Streaming codec engine: stateful hop-by-hop encode and decode (counterpart
of audiodec_tpu/streaming/engine.py: `_enc_step`, `_dec_step`,
`StreamingCodec`, `scan_streaming_encode`, `scan_streaming_decode`).

Each layer's causal state stays on the device as a nested dict of (B, C, L)
tensors (models/autoencoder.py, models/vocoder.py), the counterpart of the
JAX package's state pytree; each call replaces the state it holds, with no
host round trip.  The convs are plain cuDNN convs and the RVQ the plain
`ops/vq.py`, as JAX streams on XLA convs and its plain RVQ.  A symAD hop
at B = 1 is about 325 small launches (`chip_smoke.py` stream_path on an
H100 80GB HBM3 at 700 W); the same hop at B = 16 costs about the same,
and the device is busy for about a fifth of it, so the host bounds it
(`chip_smoke.py` stream_path's device_busy_share).

The wire format matches the reference: flattened RVQ indices per hop, layer
q offset by q * codebook_size (ref: utils/audiodec.py:100-106).
"""

from __future__ import annotations

from typing import Optional

import torch

from audiodec_tpu_torch.bin.codec_test import require_device
from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    decoder_state_init,
    decoder_stream_bct,
    encoder_state_init,
    encoder_stream_bct,
    projector_state_init,
    projector_stream_bct,
)
from audiodec_tpu_torch.models.vocoder import (
    VocoderConfig,
    vocoder_state_init,
    vocoder_stream_bct,
)
from audiodec_tpu_torch.ops.vq import rvq_forward_index, rvq_lookup
from audiodec_tpu_torch.utils.bridge import tree_map


def _on_device(params: dict, voc_cfg, device) -> dict:
    """The params a stream reads, in float32 on `device`."""
    keys = ["encoder", "projector", "quantizer",
            "decoder" if voc_cfg is None else "vocoder"]
    return {k: tree_map(lambda a: torch.as_tensor(a).to(device,
                                                        torch.float32),
                        params[k]) for k in keys}


def _enc_state(batch, cfg, dtype, device) -> dict:
    return {"encoder": encoder_state_init(batch, cfg, dtype, device),
            "projector": projector_state_init(batch, cfg, dtype, device)}


def _dec_state(batch, cfg, voc_cfg, dtype, device) -> dict:
    if voc_cfg is None:
        return {"decoder": decoder_state_init(batch, cfg, dtype, device)}
    return {"vocoder": vocoder_state_init(batch, voc_cfg, dtype, device)}


def _enc_step(params, cfg: GeneratorConfig, state, x, exact_k=None):
    """One streaming encode step: x (B, k * hop, C) -> (flattened indices
    (B, k, Q) int32, new state).  exact_k: the RVQ argmin runs the two-pass
    shortlist re-score (`vq_nearest_2pass`)."""
    h, se = encoder_stream_bct(params["encoder"], x.transpose(1, 2), cfg,
                               state["encoder"])
    z, sp = projector_stream_bct(params["projector"], h, cfg,
                                 state["projector"])
    _, idx = rvq_forward_index(z.transpose(1, 2),
                               params["quantizer"], flatten=True,
                               exact_k=exact_k)
    return idx, {"encoder": se, "projector": sp}


def _dec_step(params, cfg: GeneratorConfig, voc_cfg, state, idx):
    """One streaming decode step: flattened indices (B, k, Q) ->
    (waveform (B, k * hop, C), new state)."""
    zq = rvq_lookup(idx, params["quantizer"], flattened=True).transpose(1, 2)
    if voc_cfg is None:
        y, sd = decoder_stream_bct(params["decoder"], zq, cfg,
                                   state["decoder"])
        return y.transpose(1, 2), {"decoder": sd}
    y, sv = vocoder_stream_bct(params["vocoder"], zq, voc_cfg,
                               state["vocoder"])
    return y.transpose(1, 2), {"vocoder": sv}


class StreamingCodec:
    """Stateful streaming encoder and decoder for `batch` concurrent streams.

    params: generator params (the port's tree), with a "vocoder" entry when
    the receiving side is a HiFiGAN vocoder (voc_cfg given: the AD v1/v2
    pairing).  dtype: the zero states' dtype only, as in the JAX package.
    The params and the input are float32, so each state is promoted to
    float32 where the first hop joins it to its input, and the stream
    computes in float32 whatever dtype is.

    precision: "default", or "exact": the RVQ argmin runs the two-pass
    shortlist re-score with `exact_k` candidates (`ops/vq.py
    vq_nearest_2pass`); it needs dtype float32.  The JAX package's exact
    recipe also raises the encoder's matmul precision to "high"; the port
    always runs the encoder in true f32 (TF32 off, `require_device`), so
    that half holds in both modes.

    device: the card unless the caller asks for the CPU.
    """

    def __init__(self, params, cfg: GeneratorConfig,
                 voc_cfg: Optional[VocoderConfig] = None, batch: int = 1,
                 dtype=torch.float32, precision: str = "default",
                 exact_k: int = 16, device=None):
        if precision not in ("default", "exact"):
            raise ValueError(f"precision must be default|exact, "
                             f"got {precision!r}")
        if precision == "exact" and dtype != torch.float32:
            raise ValueError("precision='exact' needs dtype=float32, "
                             "as in the JAX package")
        self.device = require_device(device)
        self.cfg = cfg
        self.voc_cfg = voc_cfg
        self.batch = batch
        self.dtype = dtype
        self.exact_k = exact_k if precision == "exact" else None
        self.params = _on_device(params, voc_cfg, self.device)
        self.reset()

    def reset(self):
        """Zero all causal state (ref reset_buffer, AudioDec.py:250-256)."""
        self.enc_state = _enc_state(self.batch, self.cfg, self.dtype,
                                    self.device)
        self.dec_state = _dec_state(self.batch, self.cfg, self.voc_cfg,
                                    self.dtype, self.device)

    def warmup(self, receptive_length: int = 8192):
        """Prime the states by streaming zeros (ref initial_encoder /
        initial_decoder, AudioDec.py:216-226): one multi-hop call, then one
        single-hop call."""
        hop = self.cfg.hop_length
        for n in (max(1, receptive_length // hop) * hop, hop):
            z = torch.zeros(self.batch, n, self.cfg.input_channels,
                            device=self.device)
            self.decode(self.encode(z))

    def encode(self, x) -> torch.Tensor:
        """x: (B, k * hop, C) tensor or array -> flattened indices
        (B, k, Q) int32 on the device."""
        x = torch.as_tensor(x).to(self.device, torch.float32)
        with torch.inference_mode():
            idx, self.enc_state = _enc_step(self.params, self.cfg,
                                            self.enc_state, x, self.exact_k)
        return idx

    def decode(self, idx) -> torch.Tensor:
        """Flattened indices (B, k, Q) -> float32 waveform (B, k * hop, C)
        on the device."""
        idx = torch.as_tensor(idx).to(self.device)
        with torch.inference_mode():
            y, self.dec_state = _dec_step(self.params, self.cfg,
                                          self.voc_cfg, self.dec_state, idx)
        return y


def scan_streaming_encode(params, cfg: GeneratorConfig, x, exact_k=None,
                          device=None) -> torch.Tensor:
    """Whole-signal streaming encode in float32, one hop per step from a
    zero state.  x: (B, n_hops * hop, C) -> flattened indices
    (B, n_hops, Q), on the card unless device="cpu"."""
    device = require_device(device)
    x = torch.as_tensor(x).to(device, torch.float32)
    b, t, _ = x.shape
    hop = cfg.hop_length
    p = _on_device(params, None, device)
    state = _enc_state(b, cfg, torch.float32, device)
    idxs = []
    with torch.inference_mode():
        for i in range(t // hop):
            idx, state = _enc_step(p, cfg, state, x[:, i * hop:(i + 1) * hop],
                                   exact_k)
            idxs.append(idx)
    return torch.cat(idxs, dim=1)


def scan_streaming_decode(params, cfg: GeneratorConfig, idx,
                          voc_cfg: Optional[VocoderConfig] = None,
                          device=None) -> torch.Tensor:
    """Flattened indices (B, n_hops, Q) -> waveform (B, n_hops * hop, C),
    one hop per step from a zero state, in float32, on the card unless
    device="cpu"."""
    device = require_device(device)
    idx = torch.as_tensor(idx).to(device)
    p = _on_device(params, voc_cfg, device)
    state = _dec_state(idx.shape[0], cfg, voc_cfg, torch.float32, device)
    ys = []
    with torch.inference_mode():
        for i in range(idx.shape[1]):
            y, state = _dec_step(p, cfg, voc_cfg, state, idx[:, i:i + 1])
            ys.append(y)
    return torch.cat(ys, dim=1)
