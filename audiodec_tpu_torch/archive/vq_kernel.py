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
CUDA kernel masks them instead.  It takes the codebooks packed once, in
chunks of codes, each k-major with its |E|^2 row (`pack_codebooks`, cached
on what `embed` holds), and the block geometry from `rvq_geometry`, which
shrinks the frame tile as D grows: any Q, N and NE, and any D while a
tile fits a block's shared memory (D up to about 4600 at Q = 8).

Bound on the H100 at (16, 1600, 64) with 8 x 1024 codes: the cross terms'
2.7e10 FLOP on the f32 FMA units (67 TFLOP/s) against 8.6 MB moved: 0.401
ms, bound by operations (bin/kernel_bounds.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from audiodec_tpu_torch.ops.kernels import _build
from audiodec_tpu_torch.ops.kernels.folded_stack import (
    BLOCK_SMEM,
    cached_pack,
)

launches = 0   # calls that ran csrc/rvq_encode.cu

# csrc/rvq_encode.cu's tiles: 8 frames x 8 codes a thread; a warp holds
# one or two rows of threads, so a chunk holds 256 or 128 codes.  The
# (rows per warp, frames a block) pairs it instantiates:
FRAMES_PER_THREAD = CODES_PER_THREAD = 8
TILES = ((2, 128), (2, 64), (1, 64), (1, 32), (1, 16), (1, 8))
STAGES = (4, 3, 2)      # ring stages, most first
SLICES = (64, 32, 16, 8, 4)   # rows of D a stage, widest first
MAX_REGS = 128          # its __launch_bounds__ hold a thread to 128
SMS = 132               # streaming multiprocessors of an H100 SXM
SM_SMEM = 233472        # shared memory of an SM; each block also takes 1 KB
SM_REGS = 65536
# the cost model of `rvq_geometry` (its constants fitted to a sweep of
# every tile and ring on the card): a warp's frames, times the rows of D
# plus EPILOGUE_ROWS a chunk (the distances and the argmin) and STEP_ROWS
# a ring stage, times 1 + FRAME_OVERHEAD / frames a block (the codebook
# streamed through each block), times 1 + LATENCY / the warps resident on
# an SM sub-partition (4 an SM)
EPILOGUE_ROWS = 6
STEP_ROWS = 4
FRAME_OVERHEAD = 16
LATENCY = 0.25


class RvqGeometry(NamedTuple):
    frames: int          # frames a block
    rows_per_warp: int   # rows of threads a warp: chunks of 256 / rows codes
    threads: int
    slice: int           # rows of D a ring stage
    stages: int          # stages of the ring
    smem: int            # bytes of dynamic shared memory
    blocks: int
    residency: int       # blocks an SM holds at once
    d_pad: int           # D rounded up to a multiple of 4

    @property
    def chunk(self) -> int:
        return 32 // self.rows_per_warp * CODES_PER_THREAD


def padded_dim(d: int) -> int:
    return -(-d // 4) * 4


def rvq_smem(frames: int, d_pad: int, rows_per_warp: int, slice_: int,
             stages: int, q: int) -> int:
    """Bytes of shared memory csrc/rvq_encode.cu takes (`smem_bytes`): the
    ring's barriers, the residuals (d_pad rows of frames + 4), the ring
    (slice_ rows and e2 a stage), r2 and the q layers' indices."""
    chunk = 32 // rows_per_warp * CODES_PER_THREAD
    return 64 + 4 * (d_pad * (frames + 4) + stages * (slice_ + 1) * chunk
                     + frames * (1 + q))


@functools.lru_cache(maxsize=None)
def rvq_geometry(n: int, d: int, q: int, ne: int) -> RvqGeometry:
    """How csrc/rvq_encode.cu runs n frames of D against Q codebooks of NE
    codes.  Of every tile in TILES and ring (STAGES x SLICES) that fits a
    block's shared memory, the one the cost model rates fastest: the
    busiest SM sub-partition's warps (ceil(blocks / SMS) blocks an SM, each
    spreading its warps over the 4 sub-partitions) times a warp's frames,
    times the rows of D, epilogue and ring steps a chunk, times the
    codebook's streaming per block, slowed where few warps a sub-partition
    are resident, times the share of padded codes in the chunks.  Ties go
    to the earlier tile, more stages, wider slices.  Raises ValueError
    naming the shape where no tile fits."""
    if min(n, d, q, ne) < 1:
        raise ValueError(f"rvq_encode: empty shape (N={n}, D={d}, Q={q}, "
                         f"NE={ne})")
    d_pad = padded_dim(d)
    best, best_cost = None, None
    for wr, frames in TILES:
        chunk = 32 // wr * CODES_PER_THREAD
        waste = -(-ne // chunk) * chunk / ne
        threads = frames // FRAMES_PER_THREAD // wr * 32
        warps = threads // 32
        blocks = -(-n // frames)
        per_sm = -(-blocks // SMS)
        busiest = per_sm * -(-warps // 4) * FRAMES_PER_THREAD * wr
        for stages in STAGES:
            for slice_ in SLICES:
                slice_ = min(slice_, d_pad)
                smem = rvq_smem(frames, d_pad, wr, slice_, stages, q)
                if smem > BLOCK_SMEM:
                    continue
                residency = min(SM_REGS // (threads * MAX_REGS),
                                SM_SMEM // (smem + 1024))
                resident = min(residency, per_sm) * -(-warps // 4)
                rows = (d_pad + EPILOGUE_ROWS
                        + STEP_ROWS * -(-d_pad // slice_))
                cost = (busiest * rows * (1 + FRAME_OVERHEAD / frames)
                        * (1 + LATENCY / resident) * waste)
                if best_cost is None or cost < best_cost:
                    best_cost = cost
                    best = RvqGeometry(frames, wr, threads, slice_, stages,
                                       smem, blocks, residency, d_pad)
    if best is None:
        raise ValueError(
            f"rvq_encode: no tile of frames fits a block's {BLOCK_SMEM} "
            f"bytes of shared memory at (N={n}, D={d}, Q={q}, NE={ne})")
    return best


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


def _pack_chunks(embed: torch.Tensor, d_pad: int, chunk: int,
                 _rounded: bool) -> torch.Tensor:
    num_q, n_embed, d = embed.shape
    nch = -(-n_embed // chunk)
    packed = embed.new_zeros(num_q, nch * chunk, d_pad + 1)
    packed[:, :n_embed, :d] = embed
    packed[:, :n_embed, d_pad] = code_norms(embed)
    return (packed.reshape(num_q, nch, chunk, d_pad + 1)
            .transpose(2, 3).contiguous())


def pack_codebooks(embed: torch.Tensor, chunk: int) -> torch.Tensor:
    """csrc/rvq_encode.cu's codebooks: (Q, N, D) float32 -> (Q, NCH, D' + 1,
    chunk), chunks of `chunk` (128 or 256) codes, each k-major: rows 0..D'-1
    the codes' values (D' = D rounded up to a multiple of 4), row D' their
    |E|^2 from `code_norms`, zero past N and D; so a ring stage, rows of
    one chunk, is one run of memory.  Packed once per codebook tensor and
    chunk through the folded stack's pack cache."""
    return cached_pack(_pack_chunks, (embed,), padded_dim(embed.shape[-1]),
                       chunk, False, embed)


@functools.cache
def _kernel():
    fn = _build.load("rvq_encode").rvq_encode_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(z: torch.Tensor, embed: torch.Tensor, geometry: RvqGeometry
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of csrc/rvq_encode.cu at the given geometry on (B, T, D)
    CUDA frames."""
    global launches
    b, t, d = z.shape
    num_q, n_embed, _ = embed.shape
    zf = z.reshape(b * t, d).contiguous()
    embed = embed.float().contiguous()
    packed = pack_codebooks(embed, geometry.chunk)
    zq = torch.empty_like(zf)
    idx = torch.empty(b * t, num_q, dtype=torch.int32, device=z.device)
    with torch.cuda.device(z.device):
        err = _kernel()(zf.data_ptr(), packed.data_ptr(), embed.data_ptr(),
                        zq.data_ptr(), idx.data_ptr(), b * t, num_q,
                        n_embed, d, geometry.d_pad, geometry.frames,
                        geometry.rows_per_warp, geometry.slice,
                        geometry.stages,
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rvq_encode kernel: CUDA error {err}")
    launches += 1
    return zq.reshape(b, t, d), idx.reshape(b, t, num_q)


def rvq_encode_pallas(z: torch.Tensor, embed: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """z: (B, T, D) float32; embed: (Q, N, D) -> (zq (B, T, D) float32,
    idx (B, T, Q) int32).  The name is the JAX function's; on the card it
    is the CUDA kernel."""
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
    num_q, n_embed, _ = embed.shape
    if not b * t:
        return (torch.empty_like(z),
                torch.empty(b, t, num_q, dtype=torch.int32, device=z.device))
    return _launch(z, embed, rvq_geometry(b * t, d, num_q, n_embed))


def rvq_encode_fast(z: torch.Tensor, params: dict
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RVQ encode through `rvq_encode_pallas`: the CUDA kernel on a CUDA
    tensor, its plain version on a CPU tensor.  JAX's version falls back to
    `rvq_forward_index` off the TPU (`vq_kernel.py:106-115`); this one
    never does.  -> (zq, idx)."""
    return rvq_encode_pallas(z, params["embed"])
