"""Persistent batch-transcode server (counterpart of
audiodec_tpu/bin/codec_serve.py: `iter_stdin_jobs`, `iter_watch_jobs`,
`main`).

Keeps one codec loaded on the card and answers transcode jobs from stdin or
a watched directory:

  --stdin       one input wav path per line (or "in.wav<TAB>out.wav");
                writes <name>_output.wav to --outdir (or the given path)
                and prints one JSON line per file.
  --watch DIR   polls DIR for new wavs and transcodes each once, until a
                file DIR/.stop appears; a file is taken once its size is
                the same on two polls.

Jobs are micro-batched: paths arriving within --linger seconds (up to
--batch-size files) transcode as one batch of --batch-size rows, its time
axis padded to a multiple of the warmup length, so that the server sees
few shapes.  A bad input (unreadable, empty, wrong sample rate, a channel
count that differs from its batch's) gets a JSON error line and the
server goes on; only reading a file is guarded, never the transcode.

    ls *.wav | python -m audiodec_tpu_torch.bin.codec_serve \\
        --encoder E.ckpt --decoder D.ckpt --outdir out --stdin

The codec flags are `codec_test`'s (`--dtype`, `--stack folded|plain`,
`--precision`, `--encode-fold`, `--decode-fold`); `--device cpu` runs it
on the CPU.  JAX's compile cache has no counterpart here.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import sys
import threading
import time
from collections import OrderedDict

import numpy as np

from audiodec_tpu_torch.bin.codec_test import (
    load_codec,
    transcoder_options,
)
from audiodec_tpu_torch.data.wav import (
    read_wav,
    read_wav_pcm16,
    wav_is_pcm16,
    write_wav,
)

# outputs whose source is remembered for the name-collision rule
OUT_OWNER_CAP = 65536


def iter_stdin_jobs(linger_s: float):
    """Yield (src, dst) jobs from stdin, or None as an idle tick.

    A thread drains stdin, so a slow producer cannot hold back the linger
    deadline: while waiting the consumer gets None ticks and can flush a
    partial batch after --linger seconds."""
    q: queue.Queue = queue.Queue()
    eof = object()

    def reader():
        for line in sys.stdin:
            q.put(line)
        q.put(eof)

    threading.Thread(target=reader, daemon=True).start()
    tick = max(0.01, min(0.05, linger_s / 4 if linger_s > 0 else 0.05))
    while True:
        try:
            line = q.get(timeout=tick)
        except queue.Empty:
            yield None
            continue
        if line is eof:
            return
        line = line.strip()
        if not line:
            continue
        if "\t" in line:
            src, dst = line.split("\t", 1)
            yield src, dst
        else:
            yield line, None


def iter_watch_jobs(watch_dir: str, poll_s: float):
    """Yield (src, None) jobs from a directory, or None as an idle tick.

    A file is yielded once its size is the same on two polls (a writer may
    still be flushing it).  What is remembered is bounded by the
    directory's contents: a name that disappears is forgotten, so a file
    rotated in again transcodes again."""
    seen = set()
    sizes = {}
    while True:
        if os.path.exists(os.path.join(watch_dir, ".stop")):
            return
        listing = [n for n in sorted(os.listdir(watch_dir))
                   if n.endswith(".wav")]
        present = set(listing)
        seen &= present
        for name in list(sizes):
            if name not in present:
                del sizes[name]
        for name in listing:
            if name in seen:
                continue
            path = os.path.join(watch_dir, name)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            if sizes.get(name) == size:
                seen.add(name)
                sizes.pop(name, None)
                yield path, None
            else:
                sizes[name] = size
        yield None
        time.sleep(poll_s)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Serve transcode jobs from stdin or a directory.")
    p.add_argument("--encoder", required=True)
    p.add_argument("--decoder", required=True)
    p.add_argument("--outdir", default=".")
    p.add_argument("--stdin", action="store_true",
                   help="read input wav paths from stdin (the default)")
    p.add_argument("--watch", default=None,
                   help="poll this directory for new wavs instead")
    p.add_argument("--poll", type=float, default=0.5,
                   help="watch mode's poll interval in seconds")
    p.add_argument("--batch-size", type=int, default=8,
                   help="rows of every device batch (a partial batch is "
                        "zero-padded to it)")
    p.add_argument("--linger", type=float, default=0.2,
                   help="seconds to wait for more jobs before a partial "
                        "batch goes")
    p.add_argument("--dtype", default="mixed",
                   choices=["float32", "bfloat16", "mixed"],
                   help="as codec_test --dtype (serving default: mixed)")
    p.add_argument("--stack", default="folded", choices=["folded", "plain"],
                   help="as codec_test --stack: folded (the CUDA kernels) "
                        "or plain (JAX --stack xla, with the batch folds)")
    p.add_argument("--precision", default="default",
                   choices=["default", "exact", "highest"],
                   help="as codec_test --precision (exact: the two-pass "
                        "RVQ argmin; highest: --stack plain); both run the "
                        "direct encoder")
    p.add_argument("--exact-k", type=int, default=16,
                   help="two-pass argmin shortlist size for --precision "
                        "exact")
    p.add_argument("--encode-fold", default="auto",
                   help="auto/off/N, as codec_test --encode-fold")
    p.add_argument("--decode-fold", default="auto",
                   help="auto/off/N, as codec_test --decode-fold")
    p.add_argument("--warmup-seconds", type=float, default=10.0,
                   help="length of the warm-up transcode, and the unit the "
                        "time axis is padded to (0: no warm-up, pad to the "
                        "hop)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def main(argv=None):
    """Serve until stdin ends or the watched directory holds `.stop`."""
    parser = _parser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    transcoder, config = load_codec(
        args.encoder, args.decoder, pcm16=True, device=args.device,
        **transcoder_options(args, parser))
    sr_expect = config.get("sampling_rate", 48000)
    hop = transcoder.cfg.hop_length
    os.makedirs(args.outdir, exist_ok=True)

    # time axes are padded to a multiple of t_unit, batches to batch_size
    # rows, so that the server runs a small set of shapes
    t_unit = hop
    if args.warmup_seconds > 0:
        t_unit = max(hop, int(round(args.warmup_seconds * sr_expect
                                    / hop)) * hop)
        _, y = transcoder(np.zeros((args.batch_size, t_unit, 1), np.int16))
        y.cpu()
        logging.info("warmup done (batch %d x %.1fs)", args.batch_size,
                     t_unit / sr_expect)

    def emit(obj):
        print(json.dumps(obj), flush=True)

    def load_job(src):
        """-> (data, sr), or None once an error line is out."""
        try:
            x = sr = None
            if wav_is_pcm16(src):
                got = read_wav_pcm16(src)  # None on a truncated payload
                if got is not None:
                    x, sr = got
            if x is None:
                x, sr = read_wav(src)
        except Exception as e:  # unreadable, malformed or vanished
            emit({"input": src, "error": f"read failed: {e}"})
            return None
        if len(x) == 0:
            emit({"input": src, "error": "empty audio"})
            return None
        if sr != sr_expect:
            emit({"input": src, "error":
                  f"sample rate {sr} != model rate {sr_expect}"})
            return None
        return x, sr

    # Auto-named outputs (<base>_output.wav) of two sources with the same
    # basename would overwrite each other: remember which source made each
    # output (LRU-bounded); another source gets a numbered name, the same
    # source (watch-mode rotation) overwrites its own.
    out_owner: OrderedDict = OrderedDict()

    def output_path(src, dst):
        if dst:
            return dst
        base = os.path.splitext(os.path.basename(src))[0]
        out = os.path.join(args.outdir, f"{base}_output.wav")
        n = 2
        while out in out_owner and out_owner[out] != src:
            out = os.path.join(args.outdir, f"{base}_output.{n}.wav")
            n += 1
        out_owner[out] = src
        out_owner.move_to_end(out)
        while len(out_owner) > OUT_OWNER_CAP:
            out_owner.popitem(last=False)
        return out

    def flush(batch_jobs):
        """Transcode one micro-batch of (src, dst) jobs."""
        jobs, datas = [], []
        for src, dst in batch_jobs:
            got = load_job(src)
            if got is None:
                continue
            x, _ = got
            if datas and x.shape[-1] != datas[0].shape[-1]:
                emit({"input": src, "error":
                      f"channel count {x.shape[-1]} != batch's "
                      f"{datas[0].shape[-1]}"})
                continue
            jobs.append((src, dst))
            datas.append(x)
        if not datas:
            return
        lens = [len(x) for x in datas]
        padded = -(-max(lens) // t_unit) * t_unit
        i16 = all(d.dtype == np.int16 for d in datas)
        batch = np.zeros((args.batch_size, padded, datas[0].shape[-1]),
                         np.int16 if i16 else np.float32)
        for row, x in enumerate(datas):
            if i16 or x.dtype != np.int16:
                batch[row, :lens[row]] = x
            else:
                # a PCM16 row in a float batch: the /32768 the device
                # applies to an all-PCM16 batch
                batch[row, :lens[row]] = x.astype(np.float32) / 32768.0
        t0 = time.perf_counter()
        _, y = transcoder(batch)
        y_np = y.cpu().numpy()  # waits for the device's work
        dt = time.perf_counter() - t0
        for row, (src, dst) in enumerate(jobs):
            out = output_path(src, dst)
            write_wav(out, y_np[row, :lens[row]], sr_expect)
            emit({"input": src, "output": out,
                  "seconds": lens[row] / sr_expect,
                  "batch_rtf": round(sum(lens) / sr_expect / dt, 1)})

    jobs = (iter_watch_jobs(args.watch, args.poll) if args.watch
            else iter_stdin_jobs(args.linger))
    pending = []
    deadline = None
    for job in jobs:
        if job is not None:
            pending.append(job)
            if deadline is None:
                deadline = time.monotonic() + args.linger
        if pending and (len(pending) >= args.batch_size
                        or time.monotonic() > deadline):
            flush(pending[:args.batch_size])
            pending = pending[args.batch_size:]
            deadline = (time.monotonic() + args.linger) if pending else None
    while pending:
        flush(pending[:args.batch_size])
        pending = pending[args.batch_size:]


if __name__ == "__main__":
    main()
