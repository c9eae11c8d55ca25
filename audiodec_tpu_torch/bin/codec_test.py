"""Batch transcode: waveform -> RVQ indices -> waveform (counterpart of
audiodec_tpu/bin/codec_test.py `BatchTranscoder`).

Ported: stack="folded" (the residual stacks and vocoder resblocks the JAX
package runs in its folded kernel go to the CUDA kernels) and stack="plain"
(cuDNN convs throughout), dtype float32 or bfloat16, dec_dtype for the
mixed mode (f32 encoder and RVQ, bf16 decoder), and the vocoder receiver
(voc=(voc_params, voc_cfg): the AD v0/v1/v2 HiFiGAN decodes the codes in
place of the symAD decoder).  The mesh, int8 decode, the batch folds (the
JAX `vocoder_apply_batchfold` among them, ROADMAP A7), PCM16 I/O and the
command line with its YAML config and checkpoint files wait for later
slices.
"""

from __future__ import annotations

from functools import partial

import torch

from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    decoder_apply,
    encoder_apply,
    projector_apply,
)
from audiodec_tpu_torch.models.fast import (
    decoder_apply_folded,
    encoder_apply_folded,
    vocoder_apply_folded,
)
from audiodec_tpu_torch.models.vocoder import vocoder_apply
from audiodec_tpu_torch.ops.vq import rvq_forward_index, rvq_lookup
from audiodec_tpu_torch.utils.bridge import tree_map


def require_device(device=None) -> torch.device:
    """Resolve an entry point's device (CUDA unless the caller asks for the
    CPU) and set the port's precision policy.

    This is the one place that turns TF32 off: cuDNN runs float32 convs in
    TF32 by default, which would flip near-tie RVQ indices; the f32 paths
    must be true f32.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on "
                           "the CPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return device


class BatchTranscoder:
    """Batch encode/decode of (B, T, 1) waveforms.

    dtype: compute dtype of the encoder and projector (the RVQ runs in f32
    whatever it is); dec_dtype (default dtype) that of the decoder or
    vocoder.  voc: None, or (voc_params, VocoderConfig) to decode with the
    vocoder instead of params["decoder"].
    bf16_dots: operand rounding inside the fused stacks (the JAX default is
    True; False gives true-f32 stacks for parity runs)."""

    def __init__(self, params: dict, cfg: GeneratorConfig, *, voc=None,
                 dtype=torch.float32, dec_dtype=None, stack: str = "folded",
                 bf16_dots: bool = True, device=None):
        if stack not in ("folded", "plain"):
            raise ValueError(f"stack must be 'folded' or 'plain', got "
                             f"{stack!r}")
        self.device = require_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.dec_dtype = dtype if dec_dtype is None else dec_dtype
        if stack == "folded":
            self.enc_apply = partial(encoder_apply_folded,
                                     bf16_dots=bf16_dots)
            self.dec_apply = partial(decoder_apply_folded,
                                     bf16_dots=bf16_dots)
            voc_apply = partial(vocoder_apply_folded, bf16_dots=bf16_dots)
        else:
            self.enc_apply, self.dec_apply = encoder_apply, decoder_apply
            voc_apply = vocoder_apply
        # the decoder's or the vocoder's (params, zq, cfg) call
        self.dec_cfg = cfg if voc is None else voc[1]
        if voc is not None:
            self.dec_apply = voc_apply

        def on_device(tree, dt):
            return tree_map(lambda a: a.to(self.device, dt), tree)

        self.enc_params = on_device({"encoder": params["encoder"],
                                     "projector": params["projector"]},
                                    dtype)
        self.quantizer = on_device(params["quantizer"], torch.float32)
        self.dec_params = on_device(params["decoder"] if voc is None
                                    else voc[0], self.dec_dtype)

    def encode(self, x) -> torch.Tensor:
        """x: (B, T, 1) -> indices (B, T/hop, Q) int32."""
        x = torch.as_tensor(x, device=self.device).to(self.dtype)
        h = self.enc_apply(self.enc_params["encoder"], x, self.cfg)
        z = projector_apply(self.enc_params["projector"], h, self.cfg)
        _, idx = rvq_forward_index(z.float(), self.quantizer)
        return idx

    def decode(self, idx: torch.Tensor) -> torch.Tensor:
        """indices (B, T', Q) -> waveform (B, T' * hop, 1) float32."""
        zq = rvq_lookup(idx, self.quantizer).to(self.dec_dtype)
        return self.dec_apply(self.dec_params, zq, self.dec_cfg).float()

    def __call__(self, x):
        idx = self.encode(x)
        return idx, self.decode(idx)
