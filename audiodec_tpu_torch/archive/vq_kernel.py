"""Fused residual-VQ encode (counterpart of audiodec_tpu/archive/vq_kernel.py,
the TPU kernel `rvq_encode_pallas`, pallas_call at :78).

For each frame, the whole cascade: per layer q the f32 distance
(|r|^2 - 2 r.E_q^T) + |E_q|^2, the argmin with the lowest index on ties, an
exact gather of the code, and the plain update `r -= quant; zq += quant`
(`vq_kernel.py:36-57`).  That update is not `ops/vq.py`'s straight-through
form `quant = r + (quant - r)`, which rounds differently, so this module
keeps its own plain version, `rvq_encode_plain`.

On a CUDA tensor `rvq_encode_pallas` launches csrc/rvq_encode.cu (one
launch, counted in `launches`); on a CPU tensor it runs `rvq_encode_plain`.
The TPU kernel pads the frames to whole 256-frame tiles (`:72-74`); the
CUDA kernel masks them instead.  Any Q and N, and D up to 256.

Bound on the H100 at (16, 1600, 64) with 8 x 1024 codes: the cross terms'
2.7e10 FLOP on the f32 FMA units (67 TFLOP/s) against 8.6 MB moved: 0.401
ms, bound by operations (bin/kernel_bounds.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from audiodec_tpu_torch.ops.kernels import _build

MAX_DIM = 256

launches = 0   # calls that ran csrc/rvq_encode.cu


def code_norms(embed: torch.Tensor) -> torch.Tensor:
    """|E_q[n]|^2 in f32, (Q, N, D) -> (Q, N), as JAX computes it outside
    its kernel (`vq_kernel.py:75`)."""
    return torch.sum(embed.float() ** 2, dim=-1)


def rvq_encode_plain(z: torch.Tensor, embed: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's cascade in plain PyTorch.  z: (B, T, D) float32;
    embed: (Q, N, D) -> (zq (B, T, D) float32, idx (B, T, Q) int32)."""
    b, t, d = z.shape
    embed = embed.float()
    e2 = code_norms(embed)
    residual = z.reshape(b * t, d)
    zq = torch.zeros_like(residual)
    idxs = []
    for q in range(embed.shape[0]):
        r2 = torch.sum(residual * residual, dim=1, keepdim=True)
        cross = torch.matmul(residual, embed[q].transpose(0, 1))
        idx = torch.argmin(r2 - 2.0 * cross + e2[q][None, :], dim=1)
        quant = embed[q][idx]
        residual = residual - quant
        zq = zq + quant
        idxs.append(idx.to(torch.int32))
    return (zq.reshape(b, t, d),
            torch.stack(idxs, dim=-1).reshape(b, t, -1))


@functools.cache
def _kernel():
    fn = _build.load("rvq_encode").rvq_encode_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rvq_encode_pallas(z: torch.Tensor, embed: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """z: (B, T, D) float32; embed: (Q, N, D) -> (zq (B, T, D) float32,
    idx (B, T, Q) int32).  The name is the JAX function's; on the card it
    is the CUDA kernel."""
    global launches
    if z.dim() != 3 or z.dtype != torch.float32:
        raise TypeError(f"z must be (B, T, D) float32, got {tuple(z.shape)} "
                        f"{z.dtype}")
    b, t, d = z.shape
    if embed.dim() != 3 or embed.shape[-1] != d:
        raise ValueError(f"embed {tuple(embed.shape)} does not fit D={d}")
    if z.device.type == "cpu":
        return rvq_encode_plain(z, embed)
    if z.device.type != "cuda":
        raise ValueError(f"no kernel for device {z.device}")
    if embed.device != z.device:
        raise ValueError("embed must be on the device of z")
    if d > MAX_DIM:
        raise ValueError(f"the kernel takes D <= {MAX_DIM}, got {d}")
    num_q, n_embed, _ = embed.shape
    zf = z.reshape(b * t, d).contiguous()
    embed = embed.float().contiguous()
    e2 = code_norms(embed).contiguous()
    zq = torch.empty_like(zf)
    idx = torch.empty(b * t, num_q, dtype=torch.int32, device=z.device)
    if b * t:
        with torch.cuda.device(z.device):
            err = _kernel()(zf.data_ptr(), embed.data_ptr(), e2.data_ptr(),
                            zq.data_ptr(), idx.data_ptr(), b * t, num_q,
                            n_embed, d,
                            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"rvq_encode kernel: CUDA error {err}")
        launches += 1
    return zq.reshape(b, t, d), idx.reshape(b, t, num_q)


def rvq_encode_fast(z: torch.Tensor, params: dict
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RVQ encode through `rvq_encode_pallas`: the CUDA kernel on a CUDA
    tensor, its plain version on a CPU tensor.  JAX's version falls back to
    `rvq_forward_index` off the TPU (`vq_kernel.py:106-115`); this one
    never does.  -> (zq, idx)."""
    return rvq_encode_pallas(z, params["embed"])
