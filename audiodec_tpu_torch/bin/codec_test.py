"""Batch transcode of a directory of wav files: waveform -> RVQ indices ->
waveform (counterpart of audiodec_tpu/bin/codec_test.py: `plan_buckets`,
`load_planned_batch`, `bucket_batches`, `_pcm16`, `BatchTranscoder`,
`load_codec`, `main`).

    python -m audiodec_tpu_torch.bin.codec_test --encoder E.ckpt \\
        --decoder D.ckpt --data-path DIR --outdir OUT [--dtype int8-decode]

E.ckpt and D.ckpt are JAX-format checkpoints (utils/checkpoint.py), each
with its `config.yml` beside it; the same file for both is a symAD pair, a
HiFiGAN decoder config makes the AD v0/v1/v2 receiver.  Utterances are
bucketed by length from their headers, padded to a multiple of the hop and
transcoded in batches on the card (`--device cpu` runs the same code on
the CPU, with the kernels' plain versions).  A prefetch thread reads wavs
ahead, up to `--inflight` batches are queued on the device before the
oldest is fetched, and writer threads write `<uid>_output.wav` as PCM16.
The last line printed is the JAX CLI's JSON summary (`utterances`,
`audio_seconds`, `wall_seconds`, `rtf`, `hosts`).

`--stack folded` (the default) equals JAX `--stack folded`; `--stack
plain` equals JAX `--stack xla`, with the batch folds (`--encode-fold`,
`--decode-fold`, models/fast.py) on by the same rules.  `--profile DIR`
writes a torch.profiler trace of the transcode loop.

`--dp D --seq S` runs the chunk-halo sharded codec
(parallel/codec.py `make_sharded_codec`, whatever `--stack` says, as in
JAX) over a ('data', 'seq') mesh of D x S ranks, one per device: the
batch's rows split over 'data', each utterance's time over 'seq'.  Start
the ranks with torchrun (`torchrun --nproc-per-node N -m
audiodec_tpu_torch.bin.codec_test ...`) or run the command once per rank
with `--coordinator host:port --num-processes N --process-id I`, all with
the same arguments; parallel/distributed.py says which backend they use.
Every rank reads every batch and keeps its block; the first rank of each
seq line writes its rows, and the first rank prints the summary with the
slowest rank's wall clock.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import queue
import threading
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import torch

from audiodec_tpu_torch.data.dataset import SingleDataset
from audiodec_tpu_torch.data.wav import (
    read_wav_pcm16,
    wav_is_pcm16,
    write_wav,
)
from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    decoder_apply,
    encoder_apply,
    projector_apply,
)
from audiodec_tpu_torch.models.fast import (
    decoder_apply_batchfold,
    decoder_apply_folded,
    encoder_apply_batchfold,
    encoder_apply_folded,
    vocoder_apply_batchfold,
    vocoder_apply_folded,
)
from audiodec_tpu_torch.models.vocoder import vocoder_apply
from audiodec_tpu_torch.ops.vq import rvq_forward_index, rvq_lookup
from audiodec_tpu_torch.parallel.codec import make_sharded_codec
from audiodec_tpu_torch.parallel.distributed import (
    add_parallel_flags,
    global_mesh,
    host_local_rows,
    join_world,
    local_block,
    process_index,
    world_max,
    world_size,
)
from audiodec_tpu_torch.utils.bridge import (
    params_from_jax,
    tree_map,
    vocoder_params_from_jax,
)
from audiodec_tpu_torch.utils.checkpoint import load_only_params
from audiodec_tpu_torch.utils.config import (
    generator_config,
    load_config_near_checkpoint,
)
from audiodec_tpu_torch.utils.profiling import device_trace, span


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


# ---------------------------------------------------------------------------
# batches from a corpus
# ---------------------------------------------------------------------------

def plan_buckets(dataset, batch_size: int, chunk: int):
    """Batch plan [(indices, lens, padded_len)] from header-only length
    scans: utterances longest first, grouped into batches padded to a
    multiple of `chunk`."""
    order = sorted(range(len(dataset)),
                   key=lambda i: -dataset.num_frames(i))
    plans = []
    for i in range(0, len(order), batch_size):
        idxs = order[i:i + batch_size]
        lens = [dataset.num_frames(j) for j in idxs]
        padded = math.ceil(max(lens) / chunk) * chunk
        plans.append((idxs, lens, padded))
    return plans


def load_planned_batch(dataset, plan, pcm16_in=False):
    """Read and zero-pad one planned batch -> (uids, batch, lens).

    pcm16_in: when every file of the batch is PCM16, the batch holds the
    raw int16 samples (the transcoder normalizes them by 1/32768 on the
    device, exactly as the float read does, at half the bytes); if any file
    is not PCM16 the batch is float32."""
    idxs, lens, padded = plan
    uids = [dataset.utt_ids[j] for j in idxs]
    if (pcm16_in and dataset.load_fn == "audio"
            and all(wav_is_pcm16(dataset.filenames[j]) for j in idxs)):
        raws = [read_wav_pcm16(dataset.filenames[j]) for j in idxs]
        if all(r is not None for r in raws):
            batch = np.zeros((len(idxs), padded, raws[0][0].shape[-1]),
                             np.int16)
            for row, (x, _) in enumerate(raws):
                batch[row, :lens[row]] = x
            return uids, batch, lens

    def data(j):
        item = dataset[j]
        return item[1] if isinstance(item, tuple) else item

    first = data(idxs[0])
    batch = np.zeros((len(idxs), padded, first.shape[-1]), np.float32)
    batch[0, :lens[0]] = first
    for row, j in enumerate(idxs[1:], start=1):
        batch[row, :lens[row]] = data(j)
    return uids, batch, lens


def bucket_batches(dataset, batch_size: int, chunk: int, prefetch: int = 2,
                   pcm16_in: bool = False):
    """Yield (uids, batch, lens), read by a thread that runs `prefetch`
    batches ahead of the consumer; its exceptions are raised here."""
    plans = plan_buckets(dataset, batch_size, chunk)
    out: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()

    def producer():
        try:
            for plan in plans:
                if stop.is_set():
                    return
                out.put(load_planned_batch(dataset, plan, pcm16_in))
            out.put(None)
        except BaseException as e:  # re-raised in the consumer
            out.put(e)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = out.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while thread.is_alive():  # let a blocked put finish
            try:
                out.get(timeout=0.1)
            except queue.Empty:
                pass
        thread.join()


# ---------------------------------------------------------------------------
# the transcoder
# ---------------------------------------------------------------------------

def _fold_arg(v):
    """A fold flag as models/fast.py's fold= argument.  Identity checks:
    an explicit factor of 1 (== True) means "direct", not auto."""
    return None if (v is None or v is True) else v


def _pcm16(y: torch.Tensor) -> torch.Tensor:
    """PCM16 on the device, as write_wav quantizes on the host: scale 2^15,
    round half away from zero (exact in f32), clip."""
    v = y.float() * 32768.0
    q = torch.trunc(v + torch.where(v >= 0, 0.5, -0.5))
    return torch.clamp(q, -32768, 32767).to(torch.int16)


class BatchTranscoder:
    """Batch encode/decode of (B, T, 1) waveforms.

    dtype: compute dtype of the encoder and projector (the RVQ runs in f32
    whatever it is); dec_dtype (default dtype) that of the decoder or
    vocoder.  voc: None, or (voc_params, VocoderConfig) to decode with the
    vocoder instead of params["decoder"].
    bf16_dots: operand rounding inside the fused stacks (the JAX default is
    True; False gives true-f32 stacks for parity runs).
    int8_decode: every decoder residual stack in the kernel's int8 mode;
    the decoder's params and activations stay f32 whatever dec_dtype is.
    A vocoder or a config that is not causal audiodec cannot take it: it
    warns, as JAX does, and decodes in dec_dtype instead.
    stack="folded" sends the causal audiodec codec's residual stacks to
    the kernels and a vocoder's resblocks to the kernel's vocoder mode; a
    noncausal or activate_audiodec config runs the plain encoder and
    decoder, as in JAX.
    pcm16: decode returns int16 PCM, quantized on the device.
    exact_k: the RVQ argmin runs `vq_nearest_2pass` with this shortlist.
    An int16 batch is read as PCM16 and normalized by 1/32768 on the
    device, which equals the float read exactly.
    mesh: a ('data', 'seq') mesh of ranks (parallel/mesh.py): the
    transcoder then runs the sharded codec on this rank's block of each
    batch, whatever `stack` says, on the mesh's device; the int8 decode is
    refused with a warning, and the folds take the same rules.
    encode_fold / decode_fold: the batch folds of models/fast.py, as JAX's
    (None = auto, False = off, an int = that fold).  Off unless the stack
    is "plain"; the decode folds only a bf16 decoder or vocoder; the
    encode fold takes the causal audiodec codec.  The JAX package turns
    the encode fold off under a raised encoder precision; the port's
    encoder is always true f32, so its exact and highest CLIs pass
    encode_fold=False.  `fold_policy` says what was taken."""

    def __init__(self, params: dict, cfg: GeneratorConfig, *, voc=None,
                 dtype=torch.float32, dec_dtype=None, stack: str = "folded",
                 bf16_dots: bool = True, pcm16: bool = False,
                 int8_decode: bool = False, exact_k=None,
                 encode_fold=None, decode_fold=None, device=None,
                 mesh=None):
        if stack not in ("folded", "plain"):
            raise ValueError(f"stack must be 'folded' or 'plain', got "
                             f"{stack!r}")
        self.device = require_device(device if mesh is None
                                     else mesh.device)
        self.cfg = cfg
        self.mesh = mesh
        self.dtype = dtype
        self.dec_dtype = dtype if dec_dtype is None else dec_dtype
        self.pcm16 = pcm16
        self.exact_k = exact_k
        if int8_decode and (voc is not None or cfg.mode != "causal"
                            or cfg.codec != "audiodec"
                            or mesh is not None):
            # the int8 stacks exist for the causal audiodec decoder on the
            # unsharded path; anything else would get another mode than
            # asked for without a word (JAX codec_test.py:188-205)
            warnings.warn(
                "int8-decode cannot be honored for "
                + ("vocoder-pair decodes" if voc is not None
                   else "sharded (--dp/--seq) runs" if mesh is not None
                   else f"mode={cfg.mode}/codec={cfg.codec}")
                + "; running the non-int8 decoder instead")
            int8_decode = False
        self.int8_decode = int8_decode
        # the fold rules of JAX's codec_test.py:210-246, after the int8
        # downgrade above, so that a downgraded decode folds when it may
        causal_ad = cfg.mode == "causal" and cfg.codec == "audiodec"
        bf16_dec = self.dec_dtype == torch.bfloat16
        dec_fold = (decode_fold is not False and voc is None
                    and not int8_decode and stack != "folded" and bf16_dec
                    and causal_ad)
        voc_fold = (decode_fold is not False and voc is not None
                    and not int8_decode and stack != "folded" and bf16_dec
                    and getattr(voc[1], "mode", "causal") == "causal")
        enc_fold = (encode_fold is not False and stack != "folded"
                    and causal_ad)
        self.fold_policy = {"enc_fold": enc_fold,
                            "dec_fold": dec_fold or voc_fold,
                            "int8_decode": int8_decode}
        if mesh is not None:
            # the folds run inside each shard (make_sharded_codec)
            self._sharded = make_sharded_codec(
                mesh, params, cfg, vocoder=voc, dtype=dtype,
                dec_dtype=self.dec_dtype,
                encode_fold=_fold_arg(encode_fold) if enc_fold else False,
                decode_fold=(_fold_arg(decode_fold)
                             if dec_fold or voc_fold else False))
            return
        # the folded stacks take the causal audiodec codec only; any other
        # config runs the plain encoder and decoder, as in JAX
        # (codec_test.py:226-227)
        if stack == "folded" and causal_ad:
            self.enc_apply = partial(encoder_apply_folded,
                                     bf16_dots=bf16_dots)
            self.dec_apply = partial(decoder_apply_folded,
                                     bf16_dots=bf16_dots)
        else:
            self.enc_apply, self.dec_apply = encoder_apply, decoder_apply
        if enc_fold:
            self.enc_apply = partial(encoder_apply_batchfold,
                                     fold=_fold_arg(encode_fold))
        voc_apply = (partial(vocoder_apply_folded, bf16_dots=bf16_dots)
                     if stack == "folded" else vocoder_apply)
        if int8_decode:
            # the int8 quantization rounds from f32 (JAX codec_test.py:256-265)
            self.dec_apply = partial(decoder_apply_folded, int8=True)
            self.dec_dtype = torch.float32
        # the decoder's or the vocoder's (params, zq, cfg) call
        self.dec_cfg = cfg if voc is None else voc[1]
        if voc is not None:
            self.dec_apply = voc_apply
        if dec_fold:
            # decode_batchfold, whose RVQ lookup decode() makes
            self.dec_apply = partial(decoder_apply_batchfold,
                                     fold=_fold_arg(decode_fold))
        elif voc_fold:
            self.dec_apply = partial(vocoder_apply_batchfold,
                                     fold=_fold_arg(decode_fold))

        def on_device(tree, dt):
            return tree_map(lambda a: a.to(self.device, dt), tree)

        self.enc_params = on_device({"encoder": params["encoder"],
                                     "projector": params["projector"]},
                                    dtype)
        self.quantizer = on_device(params["quantizer"], torch.float32)
        self.dec_params = on_device(params["decoder"] if voc is None
                                    else voc[0], self.dec_dtype)

    def _to_device(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        x = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            # a pinned copy lets the upload queue behind earlier batches
            # instead of waiting for them
            return x.pin_memory().to(self.device, non_blocking=True)
        return x

    def encode(self, x) -> torch.Tensor:
        """x: (B, T, 1) float, or int16 PCM -> indices (B, T/hop, Q)
        int32; under a mesh, this rank's block of both."""
        with span("encode", self.device):
            x = self._to_device(x)
            if x.dtype == torch.int16:
                x = x.to(torch.float32) / 32768.0
            if self.mesh is not None:
                return self._sharded[0](x)
            with span("encoder", self.device):
                h = self.enc_apply(self.enc_params["encoder"],
                                   x.to(self.dtype), self.cfg)
            with span("projector", self.device):
                z = projector_apply(self.enc_params["projector"], h,
                                    self.cfg)
            with span("rvq", self.device):
                _, idx = rvq_forward_index(z.float(), self.quantizer,
                                           exact_k=self.exact_k)
            return idx

    def decode(self, idx: torch.Tensor) -> torch.Tensor:
        """indices (B, T', Q) -> waveform (B, T' * hop, 1), float32 or, with
        pcm16, int16; under a mesh, this rank's block of both."""
        with span("decode", self.device):
            if self.mesh is not None:
                y = self._sharded[1](idx)
                return _pcm16(y) if self.pcm16 else y.float()
            with span("lookup", self.device):
                zq = rvq_lookup(idx, self.quantizer).to(self.dec_dtype)
            with span("decoder", self.device):
                y = self.dec_apply(self.dec_params, zq, self.dec_cfg)
            with span("pcm16", self.device):
                return _pcm16(y) if self.pcm16 else y.float()

    def __call__(self, x):
        """A batch -> (indices, waveform); under a mesh, the batch is every
        rank's whole batch and the results are this rank's blocks: PCM16
        normalized on the host, the rows padded to a multiple of the data
        axis, then the rank's rows and time shard cut out."""
        if self.mesh is not None:
            x = np.asarray(x)
            if x.dtype == np.int16:
                x = x.astype(np.float32) / 32768.0
            pad = (-x.shape[0]) % self.mesh.shape["data"]
            if pad:
                x = np.concatenate(
                    [x, np.zeros((pad,) + x.shape[1:], x.dtype)])
            x = local_block(self.mesh, ("data", "seq", None), x)
        idx = self.encode(x)
        return idx, self.decode(idx)


def load_codec(encoder_ckpt: str, decoder_ckpt: str, **kwargs):
    """A BatchTranscoder from a checkpoint pair: one symAD checkpoint for
    both, or a symAD encoder and a HiFiGAN vocoder (each with the
    config.yml beside it).  kwargs go to BatchTranscoder.
    -> (transcoder, the encoder's config dict)."""
    enc_config = load_config_near_checkpoint(encoder_ckpt)
    cfg = generator_config(enc_config)
    tree, _ = load_only_params(encoder_ckpt, "gen")
    params = params_from_jax(tree)
    voc = None
    if os.path.abspath(decoder_ckpt) != os.path.abspath(encoder_ckpt):
        dec_config = load_config_near_checkpoint(decoder_ckpt)
        if dec_config.get("model_type") in ("HiFiGAN", "UnivNet"):
            vtree, _ = load_only_params(decoder_ckpt, "gen")
            voc = (vocoder_params_from_jax(vtree),
                   generator_config(dec_config))
    return BatchTranscoder(params, cfg, voc=voc, **kwargs), enc_config


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Batch transcode a directory of wav files.")
    p.add_argument("--encoder", required=True)
    p.add_argument("--decoder", required=True)
    p.add_argument("--data-path", default=None)
    p.add_argument("--subset", default="test")
    p.add_argument("--subset-num", type=int, default=-1,
                   help="only transcode the first N utterances")
    p.add_argument("--outdir", default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16", "mixed", "int8-decode"],
                   help="bfloat16: bf16 convs; mixed: f32 encoder and RVQ "
                        "(the indices of float32), bf16 decoder; "
                        "int8-decode: f32 encoder and RVQ, every decoder "
                        "residual stack with int8 dots, quantized from f32")
    p.add_argument("--stack", default="folded", choices=["folded", "plain"],
                   help="folded: residual stacks in the CUDA kernels where "
                        "the JAX package uses its folded kernel (JAX "
                        "--stack folded); plain: cuDNN convs throughout, "
                        "with the batch folds (JAX --stack xla)")
    p.add_argument("--precision", default="default",
                   choices=["default", "exact", "highest"],
                   help="exact: the RVQ argmin runs the two-pass shortlist "
                        "re-score (--exact-k); highest: --stack plain.  "
                        "Both run the direct encoder (--encode-fold off).  "
                        "TF32 is off either way, so every f32 product is "
                        "true f32")
    p.add_argument("--encode-fold", default="auto",
                   help="with --stack plain: the encoder with the time axis "
                        "folded into the batch (models/fast.py): 'auto' "
                        "(default), 'off', or a fold factor")
    p.add_argument("--decode-fold", default="auto",
                   help="with --stack plain and a bf16 decoder or vocoder "
                        "(--dtype mixed or bfloat16): the decode folded the "
                        "same way: 'auto' (default), 'off', or a factor")
    p.add_argument("--exact-k", type=int, default=16,
                   help="two-pass argmin shortlist size for --precision "
                        "exact")
    p.add_argument("--float-in", action="store_true",
                   help="convert PCM16 input to float32 on the host instead "
                        "of on the device (the same numbers)")
    p.add_argument("--float-out", action="store_true",
                   help="fetch float32 waveforms instead of PCM16 quantized "
                        "on the device (the same files)")
    p.add_argument("--inflight", type=int, default=2,
                   help="batches queued on the device before the oldest is "
                        "fetched; 1 = synchronous")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler trace of the transcode loop "
                        "into this directory")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--seq", type=int, default=1,
                   help="sequence-parallel ranks per utterance")
    add_parallel_flags(p, "data-parallel ranks (default: the rest of the "
                          "world)")
    return p


def _parse_fold(v: str):
    """A --encode-fold / --decode-fold value: 'auto' -> None, 'off' ->
    False, else the int."""
    return None if v == "auto" else False if v == "off" else int(v)


def transcoder_options(args, parser) -> dict:
    """BatchTranscoder's keyword arguments from the codec flags that
    codec_test and codec_serve share (--dtype, --stack, --precision,
    --exact-k, --encode-fold, --decode-fold).  exact and highest run the
    direct encoder (JAX turns the encode fold off with its raised encoder
    precision; the port's encoder is always true f32)."""
    stack, exact_k = args.stack, None
    encode_fold = _parse_fold(args.encode_fold)
    if args.precision == "highest":
        stack = "plain"
    elif args.precision == "exact":
        if args.dtype == "bfloat16":
            parser.error("--precision exact needs an f32 encoder (not "
                         "--dtype bfloat16)")
        exact_k = args.exact_k
    if args.precision != "default":
        encode_fold = False
    return {"dtype": (torch.bfloat16 if args.dtype == "bfloat16"
                      else torch.float32),
            "dec_dtype": (torch.bfloat16
                          if args.dtype in ("mixed", "int8-decode")
                          else None),
            "stack": stack, "int8_decode": args.dtype == "int8-decode",
            "exact_k": exact_k, "encode_fold": encode_fold,
            "decode_fold": _parse_fold(args.decode_fold)}


def main(argv=None) -> dict:
    """Run the command line; prints the JSON summary and returns it."""
    parser = _parser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    device = join_world(args, parser, require_device(args.device))
    mesh = None
    if world_size() > 1:
        mesh = global_mesh(data=-1 if args.dp <= 1 else args.dp,
                           seq=args.seq, device=device)
    if args.precision == "exact" and mesh is not None:
        parser.error("--precision exact is single-rank (unsharded) only")
    transcoder, config = load_codec(
        args.encoder, args.decoder, pcm16=not args.float_out,
        device=device, mesh=mesh, **transcoder_options(args, parser))
    sr = config.get("sampling_rate", 48000)

    data_path = args.data_path or os.path.join(
        config["data"]["path"], config["data"]["subset"][args.subset])
    dataset = SingleDataset(data_path, return_utt_id=True,
                            subset_num=args.subset_num)
    outdir = args.outdir or (
        os.path.splitext(os.path.basename(args.encoder))[0] + "-"
        + os.path.splitext(os.path.basename(args.decoder))[0])
    os.makedirs(outdir, exist_ok=True)

    # pipelined: the prefetch thread reads wavs ahead, up to --inflight
    # batches are queued on the device before the oldest is fetched
    # (.cpu() waits for it), and writer threads drain the files
    inflight: deque = deque()
    writes = []
    total_audio, n_utts = 0.0, 0
    with ThreadPoolExecutor(max_workers=2) as writer, \
            device_trace(args.profile, transcoder.device):
        def drain_one():
            uids, lens, batch_t, t_disp, y = inflight.popleft()
            if mesh is None:
                lo, y_np = 0, y.cpu().numpy()
            else:
                # this rank's rows, whole in time; the seq line's first
                # rank writes them
                lo, y_np = host_local_rows(mesh, y)
                if mesh.coords["seq"]:
                    y_np = y_np[:0]
            dt = time.perf_counter() - t_disp
            logging.info("batch of %d (T=%d): ready %.3fs after dispatch, "
                         "RTF>=%.1fx", len(uids), batch_t, dt,
                         sum(lens) / sr / dt)
            for j in range(y_np.shape[0]):
                if lo + j < len(uids):  # not a padding row of the data axis
                    writes.append(writer.submit(
                        write_wav,
                        os.path.join(outdir, f"{uids[lo + j]}_output.wav"),
                        y_np[j, :lens[lo + j]], sr))

        t_start = time.perf_counter()
        for uids, batch, lens in bucket_batches(
                dataset, args.batch_size,
                transcoder.cfg.hop_length * args.seq,
                prefetch=args.inflight, pcm16_in=not args.float_in):
            _, y = transcoder(batch)
            inflight.append((uids, lens, batch.shape[1],
                             time.perf_counter(), y))
            total_audio += sum(lens) / sr
            n_utts += len(uids)
            while len(inflight) > max(0, args.inflight - 1):
                drain_one()
        while inflight:
            drain_one()
        total_time = time.perf_counter() - t_start  # end-to-end wall clock
        for w in writes:
            w.result()
    # the slowest rank bounds the run; every rank transcoded every batch
    # (its block of it), so the audio totals are global already
    total_time = world_max(total_time)
    summary = {"utterances": n_utts, "audio_seconds": total_audio,
               "wall_seconds": total_time,
               "rtf": total_audio / total_time if total_time else 0.0,
               "hosts": world_size()}
    if process_index() == 0:
        print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
