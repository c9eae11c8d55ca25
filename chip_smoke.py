"""Smoke run of the PyTorch port on one NVIDIA H100: `python3 chip_smoke.py`.

Builds the port's eight CUDA kernels (the folded residual stack on the
tensor cores with bf16 operands at C <= 32 and above, at every unit shape;
its int8 "row" and "tile" modes on the int8 tensor cores, at every unit
shape; the archived per-tap residual stack in true f32, which is also every
true-f32 stack of the folded stack; the fused RVQ encode, the rate probe's
dot chain and the ablation probe's stack) from the sources in this
checkout, one nvcc each, all started together; holds each against its
plain PyTorch version;
checks the batch transcode, the fused transcode and the vocoder against
the reference goldens; then drives the paths once each, times them and
profiles one more transcode of each:

  - main_path (slice 1): symAD, B=16 x 10 s at 48 kHz, mixed mode (f32
    encoder and RVQ, bf16 decoder), its two C = 32 residual stacks through
    the tensor-core kernel (slice 8; the FMA kernel before);
  - ad_v1_path (slice 2): the AD v1 receiver, the same encoder and RVQ with
    the AudioDec_v1 48 kHz HiFiGAN vocoder (full width, random weights from
    a seed) decoding in bf16, its C=32 resblocks through the tensor-core
    kernel;
  - int8_path (slice 3): the same symAD transcode with the int8 decode
    (`BatchTranscoder(int8_decode=True)`), every decoder stack (C = 256,
    128, 64, 32) through the int8-mode kernel (slice 9: on the int8 tensor
    cores, csrc/int8_mma_stack.cu; the dp4a kernel before);
  - cli_path (slice 3): the batch command line (`bin/codec_test.py main`)
    on the trained golden written as a JAX-format checkpoint beside the
    symAD config, over seeded PCM16 wavs of 2-10 s, with --dtype
    int8-decode and with --dtype mixed.  It prints the CLI's JSON line;
  - fused_path (slice 4): `bin/fused_probe.py`'s fused_path, symAD in true
    f32 at B=16 x 10 s, every residual stack (C = 32/64/128/256, encoder
    and decoder) through csrc/resunit_stack.cu (slice 10: one CUDA launch
    per unit, asserted by tracing one call of each stack) and the RVQ through
    csrc/rvq_encode.cu, whose zq the decoder reads; beside it the true-f32
    plain_path on the same input (index flips, the two decoders on the
    plain indices, its time);
  - mxu_rate_path (slice 5): `bin/mxu_rate_probe.py`'s main at its
    defaults, the dot chain of 120 x 1024 rows through 64 (128, 128)
    products in bf16, int8 and f32, chained and independent, in
    csrc/dot_chain.cu (bf16 and int8 on the tensor cores) and in one
    PyTorch product per dot;
  - ablate_path (slice 5): `bin/folded_ablate.py`'s main at
    (16, 32, 480000), the five ablation variants in csrc/ablate_stack.cu
    (tensor cores), one F.elu pass and the autoencoder-mode kernel with
    bf16 dots; then (slice 7) the default variant at C = 32 in bf16
    storage and at the symAD stacks' (16, C, T) = (16, 64, 160000),
    (16, 128, 40000), (16, 256, 8000) in both storages (the kernel's wide
    route, one CUDA launch per unit);
  - folded_probe_path (slice 6): `bin/folded_probe.py`'s main with --int8
    in float32 and in bfloat16 at B = 16: at every symAD stack shape
    (C, T) = (32, 480000), (64, 160000), (128, 40000), (256, 8000) and each
    of the tool's folds, the plain chain, the autoencoder mode with bf16
    dots (csrc/folded_stack_mma.cu at C = 32, csrc/wide_stack_mma.cu
    above), and the int8 mode with "row" (csrc/int8_mma_stack.cu) and
    "tile" scales (csrc/int8_tile_mma.cu, slice 11; the dp4a
    csrc/int8_tile_stack.cu before).

The checks of slice 4: `resunit_kernel_vs_plain` (random units at C = 4 to
256 with ragged T, and the trained golden's eight stacks at B=2, f32
tolerance), `rvq_kernel_vs_plain` (random codebooks at the JAX test's
shapes and the trained golden's on the true-f32 encoder's z at
(16, 1600, 64): every index flip, counted at its first layer, a near tie
in f64, zq bit-equal on agreeing frames) and `fused_golden` (the fused
path on gen_symad and gen_symad_trained: 0 index flips, y within rtol
1e-3, atol 1e-4).

The checks of slice 5: `dot_chain_vs_plain` (the 6 dtype x mode cases at
(64 rows, 4 dots, 3 tiles) and at the probe's full size on its inputs,
with an int8 row that wraps: int8 bit-equal, f32 within 5e-5 of the peak,
bf16 relative L2 within 1e-3 independent and 3e-4 per dot chained) and
`ablate_kernel_vs_plain` (the five variants at C = 32 and 16 with B = 2,
T = 4000 and B = 1, T = 64, and at (16, 32, 480000): relative L2 within
5e-4, max error within 1e-2 of the peak).

The checks of slice 7: `ablate_kernel_vs_plain` gains bf16 storage for
every case, the wide route at C = 33, 48, 64, 96, 128 and 256 (B = 2,
T = 3996 and 60) in both storages, and the default variant at the timed
shapes, with the same bar; `kernel_vs_plain`, `voc_kernel_vs_plain` and
`wide_kernel_vs_plain` hold the repaired bf16-storage residual (the next
unit's activation reads the f32 sum, ops/kernels/folded_stack.py
storage_residual) to the plain version's.

The checks of slice 8: `mma_kernel_vs_plain` (csrc/folded_stack_mma.cu
with bf16 operands: the autoencoder and vocoder units at C = 4-32 and
T = 1920, 50, 48001, the golden's autoencoder weights, the vocoder units
at k = 3, 7, 11 with and without biases, the unit shapes no shipped config
uses, and the full size (16, 32, 480000), each in f32 and bf16 storage;
relative L2 within 5e-4 of the same function with exact sums, and of the
plain version within the larger of 5e-4 and 1.5 x the plain version's own
distance from exact sums; max error below BF16_REL of the peak); the
bf16-operand cases of `kernel_vs_plain` and `voc_kernel_vs_plain` now
reach the tensor-core kernel and are held to the same bar; their true-f32
cases hold csrc/resunit_stack.cu bit-equal (slice 11; the narrow FMA
kernels to F32_RTOL before).
`golden_parity` prints, beside the bf16-operand flips on
gen_symad_trained, those of the same encode through the plain version.

The checks of slice 9: `int8_kernel_vs_plain` gains the int8 decode's
other unit shapes (k = 5 at C = 32 and 128, four units at C = 32 and 256)
and two widths between the kernel's built ones (C = 96, 160), each in f32
and bf16 storage, held to INT8_REL like its other cases (bit equality
expected: the integer sums are exact in any order); the `profile` phase
names the launches of its traced transcode.

The checks of slice 10: `wide_kernel_vs_plain` (every unit shape of
WIDE_SHAPES, C = 48, 64, 96, 128, 256, T = 1999 and 50, B = 2: with bf16
dots in f32 and bf16 storage csrc/wide_stack_mma.cu, held as check_wide
says; in true f32 csrc/resunit_stack.cu to the f32 tolerance, with the
bit-equal count); `f32_unit_kernel_vs_plain` (true f32 at C = 4, 8, 20,
32 at the unit shapes no shipped config uses, csrc/resunit_stack.cu's);
`resunit_kernel_vs_plain` gains k = 1, 3, 5,
11, one and four units and C = 1, 33, 200, with the bit-equal count;
`probe_kernel_rows` gains the wide route in bf16 storage and the true-f32
route at the probe's shapes, each call's CUDA launches asserted.

The checks of slice 11: `int8_kernel_vs_plain` and
`int8_tile_kernel_vs_plain` gain every unit shape of INT8_NEW_SHAPES
(LeakyReLU k = k2 = 3, 7, 11 with biases, ELU k = 5, four units) in both
storages and the widths the card refused (C = 2, 3, 264, and for the tile
mode 512, at two folds and two tile_rows; C = 4 at f = 128 for the row
mode), each with the bit-equal count; `wide_c_kernel_vs_plain` runs every
mode above C = 256 (C = 264 and 512: true f32 and the archived stack
bit-equal, bf16 operands in both storages at check_wide's bar, both int8
modes) and times one call of each at WIDE_C_TIMED; `f32_timing` times the
true-f32 route at (16, 32, 480000), the autoencoder units and the vocoder
units at k = 11 (the narrow FMA kernels' shapes), held bit-equal; the true
f32 cases of `kernel_vs_plain`, `voc_kernel_vs_plain`, `golden_parity` and
`voc_golden` take csrc/resunit_stack.cu.

The checks of slice 12: `ablate_kernel_vs_plain` gains the redesigned
wide route (csrc/ablate_stack.cu on csrc/wide_stack_mma.cu's design, its
geometry from ablate_wide_geometry) at C = 264 and 1312, the route's
widest, beside C = 33-256, every variant in both storages, at B = 2,
T = 3996 and 60, with the same bars; the narrow im2col reads its operand
from the staged rows.  `dot_chain_vs_plain` holds the wgmma route (bf16
and int8) also at a ragged M (700 rows, 8 dots), with the same bars;
`ablate_path` prints beside each timed default-variant call its bound and
csrc/wide_stack_mma.cu's time at the same shape and storage
(`folded_residual_stack(bf16_dots=True)`, timed after the path's launch
counts are read).

The checks of slice 13: `rvq_kernel_vs_plain` gains csrc/rvq_encode.cu
(redesigned: register tiles, a bulk-copy codebook ring, its geometry
from rvq_geometry) at D = 512 (refused by the card before) and 12, Q = 16,
NE = 1000, 7 frames (below a tile) and a frame count one past whole tiles,
with the same bars, and at a codebook whose upper half repeats its lower
half, where every index must lie in the lower half; `rvq_timing` prints
the geometry beside the ms.

The phases of slice 16 (training: `bin/codec_train.py`'s two stages on
cuDNN and torch.autograd, no kernel of the port, as JAX trains on XLA
convs; every launch count 0 over each training window): `train_golden`
replays tests/golden/train_step.npz (3 metric, then 2 adversarial steps)
at tests/test_train_step_parity.py's bars (per leaf median |diff| <=
5e-7, q99 <= 5e-6, max <= 1.05 x the learning-rate budget), the frozen
encoder and projector and the codebook unmoved, and the disc_hifigan and
disc_univnet goldens at rtol 1e-3 / atol 1e-4; `train_path` trains the
symAD config at its full widths and batch (16 x 9600) for 20 metric and 20
adversarial steps on a seeded corpus under build/chip_smoke_train/
(removed afterwards) and prints a line of step ms p50 / p90 per stage
(CUDA events, after 3 warm-up steps), seconds of audio trained per
second, peak memory and the first and last logged losses beside the
card's name and power limit; it checks the log is finite, the encoder,
projector and codebook bit-equal across the adversarial stage while the
decoder and discriminator moved, --resume from step 20 to 40, and the
final checkpoint through `codec_test` (1 s at f32), and profiles one step
of each stage; `train_univ_path` runs the symADuniv config (MRSD + MPD),
2 + 2 steps, with the same checks.  The steps are timed by wrapping the
trainer's step functions; `train_path` also reports what the process
holds before it trains (threads, objects tracked by the garbage
collector, device memory reserved): the metric step waits on the host.
`python3 chip_smoke.py train` builds the kernels and runs only the
training phases (slices 16 and 17), in a fresh process, and prints no
`kernels` line and no result line.

The phases of slice 17 (the rest of training, no kernel of the port while
training; they run between train_path and train_univ_path, which removes
build/chip_smoke_train/): `voc_train_golden` and `denoise_train_golden`
replay tests/golden/voc_train_step.npz (a metric step, then 2 adversarial
steps) and denoise_train_step.npz (3 steps) at the parity test's bars,
the analyzer, the vocoder's `mean` and `scale`, and the denoiser's
quantizer and decoder bit-equal to their start; `stats_path` runs
`bin/codec_stats.py` over train_path's corpus with its final symAD
checkpoint as the analyzer and holds the moments to one whole-utterance
encode of the corpus (within STATS_REL of the largest entry);
`voc_train_path` trains the AD v1 vocoder config at its full widths and
batch on those codes and statistics, 10 metric and 10 adversarial steps,
prints a line of step ms p50 / p90 per stage, audio seconds per second and
peak memory beside the card's name and power limit, checks the analyzer
and statistics unmoved and the vocoder and discriminator moved, profiles
one step of each stage, and decodes through the port's `codec_test` with
the symAD encoder and the trained vocoder (default stack, --dtype mixed:
B1's vocoder units launched, their count in the `kernels` line as
`voc_train_path`); `denoise_train_path` trains the denoise config (symAD
at full width, warm-started from train_path's checkpoint) for 10 steps on
(noisy, clean) pairs, the noisy side train_path's corpus plus seeded
noise, the quantizer and decoder bit-equal to the warm start, the encoder
moved.

The phases of slice 18 (parallelism: the ranks of bin/multihost_probe.py
in child processes on the one card, bound to cuda:0; several ranks share
it, so they take gloo, and the halo shifts and gathers go through the
host; no kernel of the port, as JAX's sharded codecs and training run no
pallas_call: every rank asserts all eleven wrapper counts and both
libraries' CUDA counters 0 on every parallel path; files under
build/chip_smoke_parallel/, removed afterwards), each printing a line
`<phase> {...}` with the card's name and power limit, the backend and
the collectives staged through the host:

  - parallel_codec: one world of four ranks runs the tiny probe of
    bin/multihost_probe.py (a 2 x 2 transcode, a 1 x 4 chained halo, two
    data-parallel GAN steps with the params equal on every rank), then
    symAD at its published widths with the trained golden on B = 4 x 10 s:
    the chunk-halo sharded codec at data 2 x seq 2 in float32 and in mixed
    mode, the AD v1 receiver's sharded decode (float32, seeded weights),
    seq = 4 shards of 6000 samples (below the 7500-sample encoder halo and
    the 28-frame decoder halo: the chained halo), and the channel-parallel
    codec at data 2 x model 2 (one call, checked and timed).  Bars:
    float32 indices equal to this
    process's unsharded transcode of the same batch (`BatchTranscoder(
    stack="plain")`, folds off), waveforms at tests/test_parallel.py:73's
    rtol 1e-5 / atol 1e-6, the mixed mode's indices equal to float32's and
    its waveform within 0.05.  Per case: each rank's ms per call (host
    clock after a synchronize) beside the unsharded ms, the collectives
    and bytes of one call, each rank's peak memory;
  - parallel_train: one world of two ranks runs `codec_train --dp 2`,
    symAD at its widths and batch (16 x 9600), 2 metric + 2 adversarial
    steps, every rank stepping on one global batch with its params equal
    to every other's after every step, then `codec_stats --dp 2` on its
    final checkpoint; the final params against one rank at
    the same global batch at tests/test_parallel_fullsize.py's bars
    (median 5e-7, q99 5e-6, max 1.05 x 2 lr per leaf; the quantizer: at
    most 1e-3 of its entries off by more than 1e-6, none by 0.05); step ms
    of each rank beside the single rank's;
  - parallel_cli: that world's `codec_stats --dp 2` equal to `--dp 1`
    within 1e-5 of the largest entry; `codec_test` in a world of one rank
    joined with --coordinator (nccl, asserted) within 1 LSB of the plain
    command line.
`python3 chip_smoke.py parallel` builds the kernels and runs only these
phases.

The checks of slice 6: `int8_kernel_vs_plain` gains folds with f * C =
256 and 512 and bf16 storage; `int8_tile_kernel_vs_plain` (C = 32, 64,
128, 256, ragged T under and over 256 folded rows, two folds and two
tile_rows each, f32 and bf16, and the golden's decoder stacks: bit
equality expected, bar INT8_REL of the peak); `wide_kernel_vs_plain`
(the autoencoder mode at C = 48-256 with bf16 dots in both storages,
relative L2 within 1e-3 and max error within 1e-2 of the peak, and in
true f32 at the f32 tolerance); and at the probe's full size each tile
call and wide call of the `kernels` line against its plain version.

Each phase prints one JSON line with its own seconds; any failure raises,
so the script exits non-zero and prints no result.  Without a CUDA device
it exits non-zero at once.

Output, in order: the card's name and power limit as nvidia-smi gives
them, one JSON line per phase, a `{"kernels": [...]}` line, and last
`{"ok": true, "device": {...}}`.

Every path sets the eleven launch counts to 0 just before it and reads
them just after (mma, mma_voc, mma_other: csrc/folded_stack_mma.cu by unit
shape, autoencoder, vocoder or other; int8, int8_tile, wide
(csrc/wide_stack_mma.cu), resunit_f32 (the folded stack's calls of
csrc/resunit_stack.cu, every true-f32 stack): all
ops/kernels/folded_stack.py; resunit: archive/resunit_kernel.py (the same
CUDA kernel); rvq: archive/vq_kernel.py; dot_chain:
ops/kernels/dot_chain.py; ablate: ops/kernels/ablate_stack.py; one per
wrapper call), and each path must leave the counts named here and 0 for
the rest: main_path 2 mma; ad_v1_path 1 mma and 3 mma_voc; int8_path 1
mma and 4 int8; cli_path 0 or 4 int8 and no resunit or rvq; fused_path 8
resunit and 1 rvq; mxu_rate_path 24 dot_chain (6 cases, one warm-up and 3
timed calls each); ablate_path 7 mma and 84 ablate (7 calls of each of the
five variants and of the autoencoder units with bf16 dots, and 7 of the
default variant at each of 7 timed shapes); folded_probe_path per dtype
60 mma, 160 wide, 220 int8 and 220 int8_tile (11 (C, fold) cases, 3 of
them at C = 32, each mode 20 calls: the error, a warm-up and 3 x 6 timed).
The true-f32 golden phases count too: golden_parity 4 resunit_f32 and 2
mma, voc_golden only resunit_f32.  In the `kernels` line, `launches` is
the count from the run of the path that brought the kernel in (the
tensor-core kernel's autoencoder units: main_path; its vocoder units:
ad_v1_path; its other shapes, which no path runs: mma_kernel_vs_plain;
int8 mode: int8_path; the archived stack and the RVQ encode: fused_path;
the dot chain: mxu_rate_path; the ablation stack: ablate_path; the tile
mode and the wide tensor-core route: folded_probe_path, both dtypes; the
folded stack's true-f32 calls of csrc/resunit_stack.cu: golden_parity,
the true-f32 transcode),
`launches_by_path` the counts of every
path, and `replaces` the TPU kernel's pallas_call.  `ms`, `plain_ms`,
`chain_ms` and `bound_ms` add up that path's launches at their shapes
(the tensor-core kernel's autoencoder units: one f32 stack in the encoder
and one bf16 stack in the decoder, both (16, 32, 480000); its vocoder
units: the three groups' resblocks of the last stage, (16, 32, 480000)
bf16; its other shapes: ELU k = 5 and LeakyReLU k = k2 = 5 with biases at
(16, 32, 480000) bf16; int8: the four decoder stacks, (16, C, T) f32 at
C = 256/128/64/32 and T = 8000/40000/160000/480000; archived stack: the
eight stacks of the fused transcode, (16, C, T) f32; RVQ: one encode of
(16, 1600, 64) with 8 x 1024 codes; dot chain: one call of each of the
6 cases at (122880, 128) x 64 dots; ablation stack: one call of each of
the five variants at (16, 32, 480000) f32 and of the default variant at
each timed shape; tile mode: one call at each probe
shape, (16, C, T) f32 at the default fold, its plain version timed once;
wide route: one call at C = 64, 128, 256 in f32 and in bf16 storage; the
folded stack's true-f32 route: one call of f32_timing's two shapes at
C = 32 and one at the wide route's shapes, bound at the f32 FMA peak).
`bound_ms` is the larger of bytes over 3.35 TB/s and operations over the
peak of the dots' type (989 TFLOP/s bf16, 1979 TOP/s int8, 67 TFLOP/s
f32), per launch
(bin/kernel_bounds.py).  `library_ms` is the dot chain's torch chain
(one `torch.matmul` or `torch._int_mm` per dot, the probe's `torch`
impl); it is null for the rest: no single PyTorch call computes a stack or
the RVQ cascade.  `chain_ms` is the same units as F.elu / F.conv1d calls
in the working dtype (f32 for the int8 modes and the archived stack), and
for the RVQ `ops/vq.py rvq_forward_index` on cuBLAS with TF32 off; the
rate probe has none.  Peaks are the H100 SXM data sheet's,
at 700 W.

The phases of slice 14, which run no kernel of the port (JAX streams on
XLA convs and runs its plain path for every config but causal audiodec,
with no pallas_call; each asserts that every launch count stays 0 but
where named):

  - stream_golden: gen_symad_trained streamed on the card from the zero
    state (idx_stream 0 flips, z_stream and zq_stream within rtol 1e-4,
    atol 1e-4, y_stream and y_hops, one hop per call, within rtol 1e-3,
    atol 1e-4) and the three vocoder goldens' y_stream and y_hops (rtol
    1e-3, atol 1e-5);
  - stream_path: symAD with the trained golden's weights through
    `streaming.StreamingCodec`, B = 1, 10 s of seeded noise, one hop (300
    samples) per encode and per decode call, each timed with CUDA events;
    a line `stream_path {...}` with the card's name and power limit, the
    encode and decode ms p50 / p99, the hop's 6.25 ms of audio, the
    real-time factor, the CUDA kernels per hop and their device ms per hop
    (torch.profiler over 16 hops), and the device's busy share of a hop
    (that device ms over the hop's p50); the indices against the plain batch encode and against 8-hop
    chunks (flips at most 0.1%), the waveform against 8-hop chunks' decode
    of the same indices (rtol 1e-3, atol 1e-4); then B = 16 streams of 2 s,
    each row's indices against that stream alone at B = 1 (flips at most
    0.1%);
  - stream_ad_v1_path: the AD v1 receiver's vocoder at 512 channels
    (seeded weights, as ad_v1_path) decoding 2 s of the stream's indices
    one hop per call, a line `stream_ad_v1_path {...}` as above, against
    4-hop chunks (rtol 1e-3, atol 1e-5, and within 1e-3 of its peak);
  - variants_path: `BatchTranscoder(stack="folded")`, B = 16 x 10 s,
    mixed, seeded weights: symAAD (plain, 0 launches), the hop-320
    16-codebook config (2 tensor-core launches) and symAD's widths in
    noncausal mode (plain, 0 launches), each with its transcode ms and RTF;
  - demo_file_path: `bin/demo_file.py main` on the trained golden written
    as a JAX-format checkpoint under build/chip_smoke_demo_file/ (removed
    afterwards): a 10 s seeded PCM16 wav to a wav of the same length with
    --codes-out, then --codes-in; the .adtc's indices equal a
    StreamingCodec's on the same wav; its bitrate.

The phases of slice 15, the serving surface, each with a line
`<phase> {...}` that carries the card's name and power limit:

  - batchfold_path: `bench.py`'s workload (symAD with the trained golden's
    weights, B = 16 x 10 s, mixed) on `stack="plain"`, JAX's `--stack
    xla` route, with the batch folds at auto (fold 8, unfold_after and
    fold_from 2) against the folds off, in turns (fold, off, off, fold):
    the medians of encode, decode and transcode; at most 20 of 204800
    index flips and the bf16 decode fold within a relative L2 of 1e-2 of
    the direct bf16 decode (and its PCM16 difference); the same for the
    AD v1 receiver through vocoder_apply_batchfold; `--precision exact`
    turns the encode fold off; no kernel launched;
  - serve_path: `bin/codec_serve.py main` on the trained golden as a
    JAX-format checkpoint under build/chip_smoke_serve/ (removed
    afterwards), 24 seeded PCM16 wavs of 2-10 s and three bad inputs
    (unreadable, 16 kHz, stereo in a mono batch) on stdin, `--dtype mixed
    --batch-size 8`, the default stack and warmup: an output of each good
    file's length, one JSON error line per bad input, 2 launches of the
    tensor-core kernel per transcode (warmup included) and no other;
    against `codec_test.main` on the same files (which pads each batch to
    its longest file, not to 10 s: cuDNN picks the bf16 decoder's
    algorithms by shape, so relative L2 1e-2 there) and, fed codec_test's
    batches in its order with `--warmup-seconds 0` (the same shapes),
    within 1 LSB, each with the count of byte-identical files; the warmup
    time, `batch_rtf`, files
    per second and the time from the first job to the last line; then
    `--watch` with a `.stop` file on 4 of the files;
  - stream_tools_path: `SimulatedStreamer` on 10 s in 8-hop frames,
    bit-equal to a StreamingCodec fed the same frames; at real-time pace
    in 1-hop frames for 3 s (drops and latency, no bar);
    `CodecTransmitter` and `CodecReceiver` over a socketpair in two
    threads, bit-equal to a direct decode of the same indices;
    `DeviceStreamer` on a stand-in audio driver for 1 s; no kernel
    launched.

The phases of slice 19, after cli_path (which since then also reads its
wavs through the native WAV codec, csrc/wavio.cpp, bit-equal to the numpy
reader, and runs the command line with --float-in once with each reader,
in turns), each with a line `<phase> {...}` that carries the card's name
and power limit where it times anything:

  - import_path: reference-layout .pkl files ({"model": {"generator":
    sd}, "steps", "epochs"}) written with torch.save from the goldens'
    state dicts, converted by bin/import_ckpt.py with
    tools/ref_configs/symAD_short.yaml and vocoder_v1_small.yaml; the
    symAD checkpoint through codec_test's loader and the default
    stack="folded" in true f32, the golden's indices with 0 flips and y
    within golden_parity's bars, B1's true-f32 route launched; the vocoder
    through vocoder_apply_folded in true f32, y within voc_golden's bar;
  - blocked_path: archive/fast_experiments.py's blocked encoder and
    decoder (archive/blocked.py, plain convs) on main_path's input in f32:
    ms, peak memory, no launch; held to the plain f32 transcode of the
    same input (features and the blocked decoder's waveform on the plain
    codes within 1e-4 of the peak, at most 0.1% index flips); the flips
    against main_path's indices printed;
  - entry_path: entry.py's entry() fn on the card against the same fn on
    the CPU (rtol 1e-4, atol 1e-4 of each output's peak), on the example's
    zero input and on a seeded one, then dryrun_multichip(4), four ranks
    of the card on gloo;
  - pipeline_path: bin/codec_pipeline.py --start 0 --stop 4, five
    processes, on the shipped configs cut to a few steps on batches of 4,
    each stage's output read back.

`python3 chip_smoke.py modules` runs, after the build, main_path,
cli_path, these four phases and batchfold_path.

`python3 chip_smoke.py wide` builds csrc/wide_stack_mma.cu and the kernels
its phases compare, runs `wide_kernel_vs_plain`, `wide_c_kernel_vs_plain`,
`wide_voc_kernel_vs_plain` (the vocoders' resblocks above C = 32 at their
own shapes, checked and timed beside their bounds) and `wide_parent_ab`:
the streamed wgmma kernel timed against the per-unit mma.sync kernel it
replaced (PARENT_WIDE_COMMIT's source, from git or placed beforehand in
build/parent_wide/ where the checkout has no git, refused unless its
sha256 and its header's are PARENT_WIDE_SHA256 and
PARENT_WIDE_HEADER_SHA256).

`python3 chip_smoke.py mma` builds csrc/folded_stack_mma.cu alone, runs
`mma_kernel_vs_plain` and then `mma_parent_ab`: the streamed kernel timed
against the one-block-per-SM kernel it replaced (PARENT_MMA_COMMIT's
source, from git or placed beforehand in build/parent_mma/ where the
checkout has no git, and refused unless its sha256 is PARENT_MMA_SHA256).

Needs only torch, numpy and the repo's `audiodec_tpu_torch` package (no
JAX, no PyYAML) and nvcc; the builds go to build/audiodec_tpu_torch/.
"""

import contextlib
import ctypes
import gc
import hashlib
import io
import json
import shutil
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile, schedule

from audiodec_tpu_torch.archive import fast_experiments, resunit_kernel
from audiodec_tpu_torch.archive import vq_kernel
from audiodec_tpu_torch import entry
from audiodec_tpu_torch.bin import (
    codec_pipeline,
    codec_serve,
    codec_stats,
    codec_test,
    codec_train,
    demo_file,
    folded_ablate,
    folded_probe,
    fused_probe,
    import_ckpt,
    kernel_bounds,
    multihost_probe,
    mxu_rate_probe,
)
from audiodec_tpu_torch.bin.codec_test import BatchTranscoder, require_device
from audiodec_tpu_torch.bin.kernel_bounds import bound_ms
from audiodec_tpu_torch.models import discriminators as D
from audiodec_tpu_torch.models import fast
from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    codec_state_init,
    decoder_apply,
    decoder_stream_bct,
    encoder_apply,
    encoder_stream_bct,
    generator_init,
    projector_apply,
    projector_stream_bct,
)
from audiodec_tpu_torch.models.vocoder import (
    VocoderConfig,
    config_from_yaml,
    group_params,
    vocoder_init,
    vocoder_state_init,
    vocoder_stream_bct,
)
from audiodec_tpu_torch.ops.kernels import (
    _build,
    ablate_stack,
    dot_chain,
    folded_stack,
)
from audiodec_tpu_torch.data.dataset import SingleDataset
from audiodec_tpu_torch.data import dataset as dataset_module
from audiodec_tpu_torch.data.wav import (
    read_wav,
    read_wav_pcm16,
    read_wav_plain,
    write_wav,
)
from audiodec_tpu_torch.ops.vq import rvq_forward_index, rvq_lookup
from audiodec_tpu_torch.parallel.codec import (
    decoder_halo_frames,
    encoder_halo_samples,
)
from audiodec_tpu_torch.streaming import (
    DeviceStreamer,
    SimulatedStreamer,
    StreamingCodec,
)
from audiodec_tpu_torch.streaming.net import CodecReceiver, CodecTransmitter
from audiodec_tpu_torch.utils.bitstream import unpack_codes
from audiodec_tpu_torch.ops.norms import resolve_params
from audiodec_tpu_torch.train.criterion import build_criterion
from audiodec_tpu_torch.train.optim import tree_leaves
from audiodec_tpu_torch.train.steps import (
    make_autoencoder_steps,
    make_denoise_steps,
    make_vocoder_steps,
    train_state,
)
from audiodec_tpu_torch.utils.bridge import (
    hifigan_disc_params_from_reference_sd,
    mrsd_params_from_reference_sd,
    params_from_reference_sd,
    params_to_jax,
    tree_map,
    vocoder_params_from_jax,
    vocoder_params_from_reference_sd,
)
from audiodec_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_only_params,
    save_checkpoint,
)
from audiodec_tpu_torch.utils.config import (
    dump_yaml,
    generator_config,
    load_config,
)

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
SYMAD_YAML = ROOT / "configs" / "autoencoder" / "symAD_vctk_48000_hop300.yaml"
CLI_DIR = ROOT / "build" / "chip_smoke_cli"
DEMO_DIR = ROOT / "build" / "chip_smoke_demo_file"
SERVE_DIR = ROOT / "build" / "chip_smoke_serve"
SYMAAD_YAML = ROOT / "configs" / "autoencoder" / "symAAD_vctk_48000_hop300.yaml"
C16_YAML = ROOT / "configs" / "autoencoder" / "symAD_c16_vctk_48000_hop320.yaml"
STREAM_SECONDS, STREAM_BATCH = 10, 16
# slice 15: the batch folds' bars (JAX measured 0 flips at fold 8,
# audiodec_tpu/models/fast.py:325-327, and 5.2e-3 for the bf16 decode
# fold, :160-163), and the server's jobs
FOLD_FLIPS = 20              # of B x 1600 frames x 8 codebooks = 204800
FOLD_REL_L2 = 1e-2
SERVE_JOBS, SERVE_BATCH = 24, 8
CLI_SECONDS = (10.0, 8.5, 7.0, 5.5, 4.0, 2.0)
SR = 48000
BATCH, SECONDS = 16, 10
DILATIONS = (1, 3, 9)
SEED = 0
PROFILE_TOP = 15
KERNELS = ("int8_mma_stack", "resunit_stack", "wide_stack_mma",
           "rvq_encode", "dot_chain", "ablate_stack", "int8_tile_mma",
           "folded_stack_mma")
VOC_DILATIONS = (1, 3, 5)
VOC_SLOPE = 0.1
# true f32: only the order of the sums differs (tests/test_folded_stack.py
# :73-75); bf16 operands or storage: max error relative to the output's peak
F32_RTOL, F32_ATOL_REL, BF16_REL = 1e-4, 5e-5, 1e-2
# int8 mode: the kernel and the plain version make the same f32 roundings
# (the plain version's fma is exact f64 arithmetic rounded once, which can
# differ from fmaf by an ulp in about 2^-29 of cases); max error relative to
# the output's peak
INT8_REL = 1e-5
# the symAD decoder's stacks at B=16 x 10 s: (C, T)
INT8_SHAPES = ((256, 8000), (128, 40000), (64, 160000), (32, 480000))
# slice 9: the int8 decode at the configs' other unit shapes, (C, T, k,
# dilations): res_kernel_size 5 at a narrow and a wide stack, and four
# dilations; and two widths between the kernel's built ones (C = 96 and
# 160 run padded to 128 and 256)
INT8_UNIT_SHAPES = ((32, 4803, 5, DILATIONS), (128, 803, 5, DILATIONS),
                    (32, 4803, 7, (1, 3, 9, 27)),
                    (256, 1601, 7, (1, 3, 9, 27)),
                    (96, 1601, 7, DILATIONS), (160, 803, 7, DILATIONS))
# slice 11: the int8 modes at every unit shape of the TPU kernel, (name:
# act, k, k2, biases, dilations, C, T), LeakyReLU k = k2 = 3, 7, 11 with
# biases (the vocoder's units), ELU k = 5 and four units; and at the
# widths the modes refused before, (C, T, folds, tile_rows), two folds and
# two tile_rows each
INT8_NEW_SHAPES = {
    "leaky_relu k=k2=3, biases": ("leaky_relu", 3, 3, True, VOC_DILATIONS,
                                  32, 1201),
    "leaky_relu k=k2=7, biases": ("leaky_relu", 7, 7, True, VOC_DILATIONS,
                                  64, 801),
    "leaky_relu k=k2=11, biases": ("leaky_relu", 11, 11, True,
                                   VOC_DILATIONS, 32, 1201),
    "elu k=5": ("elu", 5, 1, False, DILATIONS, 128, 403),
    "elu, four units": ("elu", 7, 1, False, (1, 3, 9, 27), 32, 1201),
}
INT8_NEW_WIDTHS = ((2, 1201, (0, 16), (16, 1024)),
                   (3, 1201, (0, 8), (16, 1024)),
                   (264, 333, (0, 2), (16, 1024)),
                   (512, 333, (0, 4), (16, 1024)))
# slice 11: every mode above C = 256, checked at (2, C, T) and timed at
# WIDE_C_TIMED (B, C, T)
WIDE_C = ((264, 333), (512, 203))
WIDE_C_TIMED = (16, 512, 8000)
# the int8 decode against the true-f32 decode, relative to its peak
INT8_DECODE_REL = 5e-2
# the fused RVQ encode: a flipped index (at its first layer) must be a near
# tie, the two codes' f64 distances within this fraction of |r|^2 + |E|^2
RVQ_TIE_REL = 1e-5
# the fused transcode against the true-f32 plain transcode: index flips as a
# share of the indices, and the two decoders on the same indices relative to
# the peak
FUSED_FLIP_SHARE, FUSED_DECODE_REL = 1e-3, 1e-3
# slice 5.  The dot chain against its plain version: int8 bit-equal; f32
# within this share of the peak (the same products summed in another
# order, up to 128 x 64 terms); bf16 in relative L2 (a one-ulp flip is
# 3.9e-3 relative and a chained step carries it into the next product, so
# the chained bar grows with the number of dots)
DOT_F32_REL, DOT_BF16_RL2, DOT_BF16_RL2_PER_DOT = 5e-5, 1e-3, 3e-4
DOT_FULL = (1024, 64, 120)          # the probe's rows, dots, tiles
# slice 12: a ragged M for the wgmma route, 700 rows (192-row tiles)
DOT_RAGGED = (100, 8, 7)
# the ablation stack against its plain version: bf16 operand flips, see
# tests/test_torch_folded_ablate.py
ABLATE_RL2, ABLATE_MAX_REL = 5e-4, 1e-2
# slice 7.  The ablation stack's wide route (C > 32) checked at these
# widths (slice 12: up to its widest, 1312), and the default variant timed at the symAD stacks' (C, T) and at
# C = 32 in bf16 storage (B = 16)
ABLATE_WIDE = (33, 48, 64, 96, 128, 256, 264, 1312)
# The wide route sums in the plain version's association, but each
# product in 16-term groups on the tensor cores, where the plain version's
# BLAS chains fmas.  From C = 64 the bf16 flips of f32 summation error put
# the plain version itself further than ABLATE_RL2 from the same function
# with exact sums (ablate_stack_plain(exact_sums=True)): 9.4e-4 at C = 256
# in f32 storage, 1.8e-3 in bf16 (PERF.md §6, PR 10).  So at C > 32 a
# case's relative L2 bar is the larger of ABLATE_RL2 and this factor times
# the plain version's own distance from exact sums, on the case or on its
# T = 3996 sibling (at T = 66 a few flips make the case's own distance
# erratic), and it holds the kernel both to the plain version and to the
# exact sums; the max bar stays ABLATE_MAX_REL.
ABLATE_FLOOR_FACTOR = 1.5
ABLATE_TIMED = ((32, 480000, torch.bfloat16),
                *((c, t, dtype) for c, t in ((64, 160000), (128, 40000),
                                             (256, 8000))
                  for dtype in (torch.float32, torch.bfloat16)))
# slice 6.  The autoencoder mode above C = 32 (csrc/resunit_stack.cu)
# against its plain version: relative L2 and a loose max, for bf16 operand
# flips (ROADMAP §C): the kernel sums in another order than cuDNN, so an
# f32 ulp now and then moves an operand across a bf16 rounding boundary
# (3.9e-3 relative) and the next product carries it on
WIDE_RL2, WIDE_MAX_REL = 1e-3, 1e-2
# slice 8.  csrc/folded_stack_mma.cu (bf16 operands) against the plain
# version and against the same function with exact sums
# (folded_residual_stack_plain(exact_sums=True)), both in relative L2 within
# B4's bar: MMA_RL2, or ABLATE_FLOOR_FACTOR times the plain version's own
# distance from exact sums where that is larger (the rule of B4's wide
# cases).  At C <= 32 that raises the bar where the plain version (cuDNN's
# f32 sums) is more than 3.3e-4 from exact sums: the LeakyReLU units at k >= 5 in bf16
# storage, up to 7.1e-4 at k = 11, where the kernel is at most 5.0e-4 from
# exact sums and 7.7e-4 from the plain version (PERF.md §6); max error below
# BF16_REL of the peak.  A case shorter than the stack's halo holds a few
# thousand outputs, where a handful of bf16 flips moves its relative L2 by
# up to 1e-3 (0 in most short cases here, 1.07e-3 in one): its
# relative L2 bar applies to the phase's short cases pooled (one relative
# L2 over all their outputs), and each keeps its own max-error bar
MMA_RL2 = 5e-4
# the unit shapes no shipped config uses: (act, k, k2, biases, dilations)
MMA_OTHER_SHAPES = {
    "elu k=5": ("elu", 5, 1, False, (1, 3, 9)),
    "elu, four units": ("elu", 7, 1, False, (1, 3, 9, 27)),
    "elu k=k2=3, biases": ("elu", 3, 3, True, (1, 3, 5)),
    "leaky_relu k=k2=5, biases": ("leaky_relu", 5, 5, True, (1, 3, 5)),
}
# the streamed tensor-core kernel: a look-back longer than a tile
# (dilation 150: 900 samples, with one operand buffer), and a stack whose
# weights do not all fit in shared memory, staged one unit at a time (six
# k = 11 units, on wgmma)
MMA_STREAM_SHAPES = {
    "elu, dilation 150": ("elu", 7, 1, False, (1, 150)),
    "leaky_relu k=k2=11, six units, biases": (
        "leaky_relu", 11, 11, True, (1, 3, 5, 1, 3, 5)),
}
# the A/B against the kernel the streamed one replaced: the commit that
# holds it last and its sha256, where it is built, its launch interface
# (x, out, w1, w2, bias, B, C, T, cp, n_units, dil, k, k2, act, slope,
# tile, storage_bf16, stream) and its planner's tiles for the shipped unit
# shapes (cp, k, k2), dilations DILATIONS and VOC_DILATIONS
PARENT_MMA_COMMIT = "c78f23f"
PARENT_MMA_SHA256 = ("f8b0fbc1e8d78370c4d5d1bb44da71aa"
                     "99dffdbf99851add67bb4be2795e3819")
PARENT_MMA = ROOT / "build" / "parent_mma"
PARENT_MMA_TILES = {(32, 7, 1): 896, (16, 7, 1): 1024, (32, 11, 11): 576}
# the vocoders' resblocks above C = 32 (csrc/wide_stack_mma.cu in bf16) at
# B = 16 x 10 s: (C, T) of AD v1's and AD v0's upsampling stages, and the
# resblocks' kernel sizes (AD v1: 11; AD v0: 3, 7 and 11)
WIDE_VOC_STAGES = kernel_bounds.VOC_WIDE_STAGES
WIDE_VOC_KS = (11, 7, 3)
# the A/B against the wide kernel the streamed wgmma one replaced: the
# commit that holds it last, the sha256 of its source and of the header it
# includes (csrc/wide_mma.cuh, which B4 still uses), where it is built, and
# its launch interface (x, out, scratch, w1, w2, bias, B, C, T, cp,
# n_units, dil, k, k2, act, slope, warps_m, kc, nbuf, storage_bf16, stream)
PARENT_WIDE_COMMIT = "8923040"
PARENT_WIDE_SHA256 = ("cd777757364b74700fb88be17998503b"
                      "42b998de88848efb59f4013c6c91a9ef")
PARENT_WIDE_HEADER_SHA256 = ("38c6273711b1c78506a0bae72da75796"
                             "97900892a1c14849a297c572ecf0fbbf")
PARENT_WIDE = ROOT / "build" / "parent_wide"
PARENT_WIDE_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                    + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3
                    + [ctypes.c_float] + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])
PARENT_MMA_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
# the tensor-core kernel's launch counts, by unit shape
MMA_COUNTERS = {"autoencoder": "mma", "vocoder": "mma_voc",
                "other": "mma_other"}
# RVQ shapes of tests/test_pallas_vq.py: ((Q, N, D), (B, T)); slice 13:
# D = 512 (the card refused D > 256 before) and D = 12 (not a multiple of
# 4), Q = 16 (hop-320's codebooks), NE = 1000 (not a multiple of a
# chunk), and 7 frames (below any tile of csrc/rvq_encode.cu)
RVQ_SHAPES = (((4, 32, 16), (2, 10)), ((8, 1024, 64), (1, 300)),
              ((2, 16, 8), (1, 3)), ((8, 1024, 512), (4, 700)),
              ((8, 1024, 12), (2, 333)), ((16, 1024, 64), (4, 500)),
              ((8, 1000, 64), (2, 1000)), ((8, 1024, 64), (1, 7)))
# slice 13: the frames of the case one frame past whole tiles are the
# first count from RVQ_PAST_FROM up whose tile, as rvq_geometry picks it,
# leaves one frame over; the duplicated codebook's shape ((Q, N, D), (B, T))
RVQ_PAST_FROM = 2000
RVQ_DUPLICATED = ((8, 1024, 64), (2, 1000))

# generator_params of configs/vocoder/AudioDec_v1_symAD_vctk_48000_hop300_
# clean.yaml, as it stands (the card has no PyYAML; a test holds the two
# equal)
AD_V1_VOCODER = {
    "in_channels": 64,
    "out_channels": 1,
    "channels": 512,
    "kernel_size": 7,
    "upsample_scales": [5, 5, 4, 3],
    "upsample_kernel_sizes": [10, 10, 8, 6],
    "resblock_kernel_sizes": [11],
    "resblock_dilations": [[1, 3, 5]],
    "groups": 3,
    "bias": True,
    "use_additional_convs": True,
    "nonlinear_activation": "LeakyReLU",
    "nonlinear_activation_params": {"negative_slope": 0.1},
    "use_weight_norm": True,
    "stats": "stats/symAD_vctk_48000_hop300_clean.npy",
}
# the vocoder goldens' configs (tests/test_vocoder_parity.py:20-37)
VOC_GOLDENS = {
    "voc_mrf": dict(in_channels=16, channels=32,
                    upsample_scales=(5, 5, 4, 3),
                    upsample_kernel_sizes=(10, 10, 8, 6)),
    "voc_group": dict(in_channels=16, channels=32,
                      upsample_scales=(5, 5, 4, 3),
                      upsample_kernel_sizes=(10, 10, 8, 6),
                      resblock_kernel_sizes=(11,),
                      resblock_dilations=((1, 3, 5),), groups=3, stats=True),
    "voc_v1_small_trained": dict(in_channels=64, channels=128,
                                 upsample_scales=(5, 5, 4, 3),
                                 upsample_kernel_sizes=(10, 10, 8, 6),
                                 resblock_kernel_sizes=(11,),
                                 resblock_dilations=((1, 3, 5),), groups=3,
                                 stats=True),
}


def emit(phase: str, t0: float, **fields):
    print(json.dumps({"phase": phase, "seconds": time.perf_counter() - t0,
                      **fields}), flush=True)


def load_golden(name: str):
    data = np.load(GOLDEN / f"{name}.npz")
    sd = {k[len("sd__"):]: data[k] for k in data.files
          if k.startswith("sd__")}
    return data, params_from_reference_sd(sd, GeneratorConfig())


def stack_units(params, where: str, device, dtype):
    """Unit weights of the two C=32 stacks: encoder block 0, decoder
    block 3."""
    bp = (params["encoder"]["blocks"][0] if where == "encoder"
          else params["decoder"]["blocks"][3])
    return tuple((u["conv1"]["w"].to(device, dtype),
                  u["conv2"]["w"].to(device, dtype)) for u in bp["res"])


def cuda_ms(fn, reps: int) -> float:
    fn()  # warm-up
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def chain(x, units, dilations=DILATIONS, act="elu", slope=0.0, biases=None):
    """The yardstick: the same units as plain activation / F.conv1d calls
    in the working dtype, with no rounding emulation."""
    fn = F.elu if act == "elu" else (lambda v: F.leaky_relu(v, slope))
    v = x
    for j, ((w1, w2), d) in enumerate(zip(units, dilations)):
        b1, b2 = biases[j] if biases is not None else (None, None)
        y = F.conv1d(F.pad(fn(v), ((w1.shape[-1] - 1) * d, 0)), w1, b1,
                     dilation=d)
        v = v + F.conv1d(F.pad(fn(y), (w2.shape[-1] - 1, 0)), w2, b2)
    return v


def check_close(out, ref, x, bf16_dots: bool):
    """A kernel's output against its plain version's; returns (abs, rel)."""
    torch.cuda.synchronize()
    out, ref = out.float(), ref.float()
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    if not torch.isfinite(out).all():
        raise AssertionError("kernel output is not finite")
    if torch.equal(out, x.float()):
        raise AssertionError("kernel returned its input unchanged")
    if x.dtype == torch.float32 and not bf16_dots:
        torch.testing.assert_close(out, ref, rtol=F32_RTOL,
                                   atol=F32_ATOL_REL * scale)
    elif err / scale >= BF16_REL:
        raise AssertionError(f"bf16-mode relative error {err / scale:.3g} "
                             f">= {BF16_REL}")
    return err, err / scale


def plain_of(x, units, kw, exact_sums=False):
    """The plain version of a wrapper call's keyword arguments."""
    return folded_stack.folded_residual_stack_plain(
        x, units, kw.get("dilations", DILATIONS), kw.get("bf16_dots", True),
        act=kw.get("act", "elu"), act_param=kw.get("act_param", 0.0),
        biases=kw.get("biases"), exact_sums=exact_sums)


def sq(a, b=None) -> float:
    """The squared L2 norm of a (or of a - b), in f64."""
    a = a.double() if b is None else a.double() - b.double()
    return float((a * a).sum())


def mma_bars(sums: dict, base: float = MMA_RL2) -> dict:
    """The relative L2s of squared sums (check_mma) and their bar: within
    the larger of `base` and ABLATE_FLOOR_FACTOR times the plain version's
    own distance from exact sums, of the plain version and of the exact
    sums."""
    rec = {"rel_l2": (sums["d_plain"] / sums["plain"]) ** 0.5,
           "exact_rl2": (sums["d_exact"] / sums["exact"]) ** 0.5,
           "plain_exact_rl2": (sums["d_plain_exact"] / sums["exact"]) ** 0.5}
    rec["bar_rl2"] = max(base, ABLATE_FLOOR_FACTOR
                         * rec["plain_exact_rl2"])
    rec["passed"] = max(rec["exact_rl2"], rec["rel_l2"]) <= rec["bar_rl2"]
    return rec


def check_pool(pool: list, base: float = MMA_RL2) -> dict:
    """The relative L2 bar on a phase's short cases pooled (mma_bars)."""
    if not pool:
        return {"cases": 0}
    rec = mma_bars({k: sum(p[k] for p in pool) for k in pool[0]}, base)
    if not rec["passed"]:
        raise AssertionError(f"tensor-core kernel, the {len(pool)} cases "
                             f"shorter than the halo pooled: {rec}")
    return {"cases": len(pool), **rec}


def check_mma(x, units, pool: list | None = None, **kw) -> dict:
    """csrc/folded_stack_mma.cu through the stack's wrapper (bf16 operands:
    bf16_dots or bf16 storage) against its plain version and against the
    same function with exact sums: the relative L2 bar of mma_bars and a
    max error within BF16_REL of the peak.  A case shorter than the halo
    adds its squared sums to `pool` for check_pool instead of meeting the
    relative L2 bar alone (MMA_RL2).  The call must launch the kernel
    once, counted by its unit shape."""
    counter = MMA_COUNTERS[folded_stack._mode(
        kw.get("kernel_size", 7), kw.get("kernel_size2", 1),
        kw.get("act", "elu"), kw.get("biases"), False)]
    before = read_launches()[counter]
    out = folded_stack.folded_residual_stack(x, units, **kw)
    torch.cuda.synchronize()
    if read_launches()[counter] != before + 1:
        raise AssertionError(f"{counter}: the tensor-core kernel was not "
                             f"launched")
    if out.dtype != x.dtype or out.shape != x.shape:
        raise AssertionError(f"tensor-core kernel gave {out.dtype} "
                             f"{tuple(out.shape)}")
    ref = plain_of(x, units, kw)
    exact = plain_of(x, units, kw, exact_sums=True)
    o, r = out.float(), ref.float()
    if not torch.isfinite(o).all():
        raise AssertionError("tensor-core kernel output is not finite")
    if torch.equal(o, x.float()):
        raise AssertionError("tensor-core kernel returned its input")
    err, peak = float((o - r).abs().max()), float(r.abs().max())
    sums = {"d_plain": sq(out, ref), "plain": sq(ref),
            "d_exact": sq(out, exact), "exact": sq(exact),
            "d_plain_exact": sq(ref, exact)}
    rec = {**mma_bars(sums), "max_abs_err": err, "max_rel_err": err / peak}
    halo = sum((kw.get("kernel_size", 7) - 1) * d + kw.get("kernel_size2", 1)
               - 1 for d in kw.get("dilations", DILATIONS))
    if x.shape[-1] < halo:
        if pool is None:
            raise ValueError("a case shorter than the halo needs a pool")
        pool.append(sums)
        rec["pooled"] = True
    elif not rec["passed"]:
        raise AssertionError(f"tensor-core kernel at {tuple(x.shape)} "
                             f"{x.dtype} {kw}: {rec}")
    if not err < BF16_REL * peak:
        raise AssertionError(f"tensor-core kernel at {tuple(x.shape)} "
                             f"{x.dtype} {kw}: max error {err / peak:.3g} "
                             f"of the peak")
    return rec


def check_f32(x, units, **kw) -> dict:
    """True f32 (f32 storage, bf16_dots=False), the route of
    csrc/resunit_stack.cu, against the plain version: bit-equal (the
    kernel keeps cuDNN's fmaf order), and one launch of the route."""
    before = folded_stack.resunit_launches
    out = folded_stack.folded_residual_stack(x, units, bf16_dots=False, **kw)
    if folded_stack.resunit_launches != before + 1:
        raise AssertionError("csrc/resunit_stack.cu was not launched")
    ref = plain_of(x, units, {**kw, "bf16_dots": False})
    err, rel = check_close(out, ref, x, False)
    if not torch.equal(out, ref):
        raise AssertionError(f"true f32 at {tuple(x.shape)} {kw}: not "
                             f"bit-equal to the plain version ({err:.3g})")
    return {"max_abs_err": err, "max_rel_err": rel, "bit_equal": True}


def check_stack(x, units, bf16_dots: bool, pool=None, **kw) -> dict:
    """Units of any shape (kw: the wrapper's keyword arguments): with bf16
    operands the tensor-core kernel (check_mma); in true f32
    csrc/resunit_stack.cu, bit-equal (check_f32)."""
    if bf16_dots or x.dtype == torch.bfloat16:
        return {"kernel": "mma",
                **check_mma(x, units, pool, bf16_dots=bf16_dots, **kw)}
    return {"kernel": "resunit", **check_f32(x, units, **kw)}


def shape_units(c, act, k, k2, bias, dilations, device, dtype, gen):
    """Seeded units of any shape at width C, scaled to keep the stack's
    outputs near unit size, with biases large enough that a fault in the
    masking before t=0 shows; and the wrapper's keyword arguments for
    them."""
    units = tuple((torch.randn(c, c, k, generator=gen, device=device)
                   .div((k * c) ** 0.5).to(dtype),
                   torch.randn(c, c, k2, generator=gen, device=device)
                   .div((k2 * c) ** 0.5).to(dtype)) for _ in dilations)
    biases = (tuple((0.5 * torch.randn(c, generator=gen, device=device)
                     .to(dtype),
                     0.5 * torch.randn(c, generator=gen, device=device)
                     .to(dtype)) for _ in dilations) if bias else None)
    return units, dict(dilations=dilations, kernel_size=k, kernel_size2=k2,
                       act=act, act_param=VOC_SLOPE, biases=biases)


def random_units(c: int, device, dtype, gen):
    """Seeded autoencoder units (ELU, k = 7, 1x1) at width C."""
    return shape_units(c, "elu", 7, 1, False, DILATIONS, device, dtype,
                       gen)[0]


def phase_kernel_vs_plain(params, device):
    """The autoencoder units: C=32 with the golden weights at the main
    path's length, one more and one shorter than the halo; C = 4, 8, 16 and
    12 (padded to 16) with random weights; with bf16 operands the
    tensor-core kernel, in true f32 csrc/resunit_stack.cu, bit-equal."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    shapes = ([(32, t) for t in (48000, 48001, 50)]
              + [(c, t) for c in (4, 8, 16, 12) for t in (1920, 50)])
    cases, pool = [], []
    for c, t in shapes:
        for storage in (torch.float32, torch.bfloat16):
            if c == 32:
                units = stack_units(params, "encoder"
                                    if storage == torch.float32
                                    else "decoder", device, storage)
            else:
                units = random_units(c, device, storage, gen)
            x = torch.randn(2, c, t, generator=gen, device=device)
            for bf16_dots in (True, False):
                cases.append({"C": c, "T": t, "storage": str(storage)[6:],
                              "bf16_dots": bf16_dots,
                              **check_stack(x.to(storage), units,
                                            bf16_dots, pool)})
    emit("kernel_vs_plain", t0, tolerance=mma_tolerance(),
         short_cases_pooled=check_pool(pool), cases=cases)


def mma_tolerance() -> dict:
    return {"f32 (csrc/resunit_stack.cu)": "bit-equal",
            "bf16 operands (tensor-core kernel)":
                f"rel_l2 and exact_rl2 <= bar_rl2 = max({MMA_RL2}, "
                f"{ABLATE_FLOOR_FACTOR} x plain_exact_rl2), per case, or "
                f"over the cases shorter than the halo pooled; max error < "
                f"{BF16_REL} x peak per case"}


def phase_voc_kernel_vs_plain(device):
    """The vocoder units against their plain version, as
    phase_kernel_vs_plain: K = 3, 7, 11 (the v2, v1-style and v0 sizes,
    K2 = K), every built width (C = 4, 8, 16, 32 and 12 padded to 16),
    T = 1920 and 50 (shorter than the halo), both storage dtypes and both
    bf16_dots, with biases; without biases at K=11, C=32; and once at the
    AD v1 path's shape (16, 32, 480000) in bf16."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    shapes = [(k, c, t, True) for k in (3, 7, 11) for c in (4, 8, 16, 32, 12)
              for t in (1920, 50)] + [(11, 32, 1920, False)]
    cases, pool = [], []
    for k, c, t, bias in shapes:
        for storage in (torch.float32, torch.bfloat16):
            units, kw = shape_units(c, "leaky_relu", k, k, bias,
                                    VOC_DILATIONS, device, storage, gen)
            x = torch.randn(2, c, t, generator=gen, device=device)
            for bf16_dots in (True, False):
                cases.append({"K": k, "C": c, "T": t, "biases": bias,
                              "storage": str(storage)[6:],
                              "bf16_dots": bf16_dots,
                              **check_stack(x.to(storage), units, bf16_dots,
                                            pool, **kw)})
    units, kw = shape_units(32, "leaky_relu", 11, 11, True, VOC_DILATIONS,
                            device, torch.bfloat16, gen)
    x = torch.randn(BATCH, 32, SECONDS * SR, generator=gen,
                    device=device).to(torch.bfloat16)
    cases.append({"K": 11, "C": 32, "T": SECONDS * SR, "B": BATCH,
                  "biases": True, "storage": "bfloat16", "bf16_dots": True,
                  **check_stack(x, units, True, **kw)})
    emit("voc_kernel_vs_plain", t0, tolerance=mma_tolerance(),
         short_cases_pooled=check_pool(pool), cases=cases)


def phase_mma_kernel_vs_plain(params, device):
    """csrc/folded_stack_mma.cu against its plain version (check_mma), bf16
    operands: the autoencoder units and the vocoder units at k = 11 with
    biases, C = 4, 8, 12, 16, 32 and T = 1920, 50 (shorter than the halo),
    48001, B = 2; the autoencoder units with the golden's weights at C = 32
    (encoder block 0 in f32, decoder block 3 in bf16 storage); the vocoder
    units at k = 3, 7, 11 with and without biases; the unit shapes no
    shipped config uses (MMA_OTHER_SHAPES) at C = 8 and 32; each of these
    in f32 and bf16 storage; and at full size (16, 32, 480000) the
    autoencoder units in f32 and bf16 and the vocoder units in bf16.  For
    the streamed design: T = 250 (under one tile) and 513 (one past two),
    B = 1, B = 300 (more rows than the card's blocks, so a block walks
    several items), a look-back longer than a tile and weights staged one
    unit at a time (MMA_STREAM_SHAPES).
    Returns the launch counts of the phase and the `kernels` line's rows of
    the other shapes: two of them timed at full size in bf16."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    storages = (torch.float32, torch.bfloat16)
    reset_launches()
    cases, pool = [], []

    def case(x, units, kw, **fields):
        cases.append({**fields, "shape": list(x.shape),
                      "storage": str(x.dtype)[6:],
                      **check_mma(x, units, pool, **kw)})

    for c in (4, 8, 12, 16, 32):
        for t in (1920, 50, 48001):
            for dtype in storages:
                x = torch.randn(2, c, t, generator=gen,
                                device=device).to(dtype)
                case(x, random_units(c, device, dtype, gen), {},
                     stack="autoencoder")
                units, kw = shape_units(c, "leaky_relu", 11, 11, True,
                                        VOC_DILATIONS, device, dtype, gen)
                case(x, units, kw, stack="vocoder k=11")
    for dtype, where in ((torch.float32, "encoder"),
                         (torch.bfloat16, "decoder")):
        x = torch.randn(2, 32, 48000, generator=gen, device=device).to(dtype)
        case(x, stack_units(params, where, device, dtype), {},
             stack=f"autoencoder, golden {where}")
    for k in (3, 7, 11):
        for bias in (True, False):
            for dtype in storages:
                units, kw = shape_units(32, "leaky_relu", k, k, bias,
                                        VOC_DILATIONS, device, dtype, gen)
                x = torch.randn(2, 32, 4801, generator=gen,
                                device=device).to(dtype)
                case(x, units, kw, stack=f"vocoder k={k}", biases=bias)
    for name, (act, k, k2, bias, dil) in MMA_OTHER_SHAPES.items():
        for c, t in ((8, 1920), (32, 4801)):
            for dtype in storages:
                units, kw = shape_units(c, act, k, k2, bias, dil, device,
                                        dtype, gen)
                x = torch.randn(2, c, t, generator=gen,
                                device=device).to(dtype)
                case(x, units, kw, stack=name)
    for bsz, t in ((8, 250), (2, 513), (1, 48001), (300, 4801)):
        for dtype in storages:
            x = torch.randn(bsz, 32, t, generator=gen, device=device) \
                .to(dtype)
            case(x, random_units(32, device, dtype, gen), {},
                 stack="autoencoder")
            units, kw = shape_units(32, "leaky_relu", 11, 11, True,
                                    VOC_DILATIONS, device, dtype, gen)
            case(x, units, kw, stack="vocoder k=11")
    for name, (act, k, k2, bias, dil) in MMA_STREAM_SHAPES.items():
        for c, t in ((8, 1920), (32, 4801)):
            for dtype in storages:
                units, kw = shape_units(c, act, k, k2, bias, dil, device,
                                        dtype, gen)
                x = torch.randn(2, c, t, generator=gen, device=device) \
                    .to(dtype)
                case(x, units, kw, stack=name)
    b, c, t = BATCH, 32, SECONDS * SR
    for dtype, where in ((torch.float32, "encoder"),
                         (torch.bfloat16, "decoder")):
        x = torch.randn(b, c, t, generator=gen, device=device).to(dtype)
        case(x, stack_units(params, where, device, dtype), {},
             stack=f"autoencoder, golden {where}")
    x = torch.randn(b, c, t, generator=gen, device=device) \
        .to(torch.bfloat16)
    units, kw = shape_units(c, "leaky_relu", 11, 11, True, VOC_DILATIONS,
                            device, torch.bfloat16, gen)
    case(x, units, kw, stack="vocoder k=11")
    rows = []
    for name in ("elu k=5", "leaky_relu k=k2=5, biases"):
        act, k, k2, bias, dil = MMA_OTHER_SHAPES[name]
        units, kw = shape_units(c, act, k, k2, bias, dil, device,
                                torch.bfloat16, gen)
        row = {"units": name, "shape": [b, c, t], "dtype": "bfloat16",
               **check_mma(x, units, **kw),
               "ms": cuda_ms(lambda: folded_stack.folded_residual_stack(
                   x, units, **kw), reps=5),
               "plain_ms": cuda_ms(lambda: plain_of(x, units, kw), reps=2),
               "chain_ms": cuda_ms(lambda: chain(
                   x, units, dil, act, VOC_SLOPE, kw["biases"]), reps=3)}
        row.update(kernel_bounds.mma_stack(b, t, c, k=k, k2=k2,
                                           storage=2, bias=bias,
                                           units=len(dil)))
        rows.append(row)
    del x
    launches = read_launches()
    emit("mma_kernel_vs_plain", t0, tolerance=mma_tolerance(),
         short_cases_pooled=check_pool(pool), launches=launches, cases=cases,
         other_shape_rows=rows)
    return launches, rows


def parent_mma_kernel():
    """The replaced kernel (PARENT_MMA_COMMIT's csrc/folded_stack_mma.cu)
    built into PARENT_MMA, its source from git or a copy already there.
    Exits where neither is at hand or the source is another."""
    src = PARENT_MMA / "folded_stack_mma.cu"
    path = "audiodec_tpu_torch/csrc/folded_stack_mma.cu"
    if not src.exists() and shutil.which("git"):
        proc = subprocess.run(["git", "show", f"{PARENT_MMA_COMMIT}:{path}"],
                              cwd=ROOT, capture_output=True)
        if proc.returncode == 0:
            PARENT_MMA.mkdir(parents=True, exist_ok=True)
            src.write_bytes(proc.stdout)
    if not src.exists():
        sys.exit(f"chip_smoke mma: no {src}: place {PARENT_MMA_COMMIT}'s "
                 f"{path} there")
    if hashlib.sha256(src.read_bytes()).hexdigest() != PARENT_MMA_SHA256:
        sys.exit(f"chip_smoke mma: {src} is not {PARENT_MMA_COMMIT}'s "
                 f"{path}, whose launch interface PARENT_MMA_ARGS states")
    lib = PARENT_MMA / "libfolded_stack_mma.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).folded_stack_mma_forward
    fn.argtypes = PARENT_MMA_ARGS
    fn.restype = ctypes.c_int
    return fn


def phase_mma_parent_ab(params, device):
    """The shipped unit shapes at full size (16, C, 480000), ms of one call
    of the replaced kernel (parent_mma_kernel) and of this one, in turns
    (parent, new, new, parent), 5 calls each: at C = 32 the autoencoder
    units with the golden's weights in f32 (encoder block 0) and bf16
    storage (decoder block 3) and the vocoder units at k = 11 in bf16; at
    C = 16 (the C = 16 autoencoder's first encoder and last decoder
    blocks) seeded autoencoder units in f32 and bf16.  With each output's
    relative L2 from the plain version and whether the two outputs are
    equal bit for bit."""
    t0 = time.perf_counter()
    parent = parent_mma_kernel()
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    b, t = BATCH, SECONDS * SR
    rows = []
    for name, c, dtype in (("autoencoder, golden encoder", 32, torch.float32),
                           ("autoencoder, golden decoder", 32, torch.bfloat16),
                           ("vocoder k=11", 32, torch.bfloat16),
                           ("autoencoder", 16, torch.float32),
                           ("autoencoder", 16, torch.bfloat16)):
        x = torch.randn(b, c, t, generator=gen, device=device).to(dtype)
        if name.startswith("vocoder"):
            units, kw = shape_units(c, "leaky_relu", 11, 11, True,
                                    VOC_DILATIONS, device, dtype, gen)
        elif c == 32:
            where = "encoder" if dtype == torch.float32 else "decoder"
            units, kw = stack_units(params, where, device, dtype), {}
        else:
            units, kw = random_units(c, device, dtype, gen), {}
        cp = folded_stack.mma_width(c)
        k, k2 = units[0][0].shape[-1], units[0][1].shape[-1]
        dil = kw.get("dilations", DILATIONS)
        biases = kw.get("biases")
        w1, w2, bias = folded_stack._packed_mma(units, biases, c, cp)
        cdil = (ctypes.c_int * len(dil))(*dil)
        out = torch.empty_like(x)

        def old():
            err = parent(x.data_ptr(), out.data_ptr(), w1.data_ptr(),
                         w2.data_ptr(),
                         None if bias is None else bias.data_ptr(), b, c, t,
                         cp, len(dil), cdil, k, k2,
                         folded_stack.MMA_ACT[kw.get("act", "elu")],
                         float(kw.get("act_param", 0.0)),
                         PARENT_MMA_TILES[cp, k, k2],
                         int(dtype == torch.bfloat16),
                         torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"parent kernel: CUDA error {err}")
            return out

        def new():
            return folded_stack.folded_residual_stack(x, units, **kw)

        ref = plain_of(x, units, kw)
        rl2 = {"parent_rel_l2": (sq(old(), ref) / sq(ref)) ** 0.5,
               "new_rel_l2": (sq(new(), ref) / sq(ref)) ** 0.5,
               "bit_equal": torch.equal(old(), new())}
        ms = [cuda_ms(fn, reps=5) for fn in (old, new, new, old)]
        rows.append({"units": name, "shape": [b, c, t],
                     "storage": str(dtype)[6:], "parent_ms": [ms[0], ms[3]],
                     "new_ms": [ms[1], ms[2]], **rl2,
                     "bound_ms": kernel_bounds.mma_stack(
                         b, t, c, k=k, k2=k2, storage=x.element_size(),
                         bias=biases is not None, units=len(dil))["bound_ms"]})
        del x, out, ref
    emit("mma_parent_ab", t0, commit=PARENT_MMA_COMMIT, rows=rows)


def phase_golden(device):
    """The symAD goldens through BatchTranscoder(stack="folded"): in true
    f32 (csrc/resunit_stack.cu) the golden indices with 0 flips and y
    within rtol 1e-3, atol 1e-4; with bf16 operands (the tensor-core
    kernel) the encode's index flips, 0 on gen_symad, and on
    gen_symad_trained beside the flips of the same encode through the
    plain version.  Returns the launch counts of the phase: 2 resunit_f32
    launches per true-f32 transcode and 1 tensor-core launch per
    bf16-operand encode."""
    t0 = time.perf_counter()
    cfg = GeneratorConfig()
    results = {}
    reset_launches()
    for name in ("gen_symad", "gen_symad_trained"):
        data, params = load_golden(name)
        x = data["x"].transpose(0, 2, 1)
        # idx_stream is (Q, T') in the reference's flat format (layer q
        # offset by q*N)
        flat = np.arange(cfg.codebook_num)[:, None] * cfg.codebook_size
        idx, y = BatchTranscoder(params, cfg, stack="folded",
                                 bf16_dots=False, device=device)(x)
        np.testing.assert_array_equal(idx[0].cpu().numpy().T + flat,
                                      data["idx_stream"])
        np.testing.assert_allclose(y.cpu().numpy().transpose(0, 2, 1),
                                   data["y"], rtol=1e-3, atol=1e-4)
        idx16 = BatchTranscoder(params, cfg, stack="folded",
                                device=device).encode(x)
        flips = int((idx16[0].cpu().numpy().T + flat
                     != data["idx_stream"]).sum())
        if name == "gen_symad" and flips:
            raise AssertionError(f"{flips} index flips with bf16 operands")
        results[name] = {"f32_index_flips": 0, "bf16_dots_index_flips": flips,
                         "frames": int(data["idx_stream"].shape[1])}
        if name == "gen_symad_trained":
            kernel_stack = fast.folded_residual_stack
            fast.folded_residual_stack = (
                lambda x, units, **kw: plain_of(x, units, kw))
            try:
                idx_p = BatchTranscoder(params, cfg, stack="folded",
                                        device=device).encode(x)
            finally:
                fast.folded_residual_stack = kernel_stack
            results[name]["plain_bf16_dots_index_flips"] = int(
                (idx_p[0].cpu().numpy().T + flat
                 != data["idx_stream"]).sum())
            moved = (idx16 != idx_p).nonzero().tolist()
            results[name]["kernel_vs_plain_moved"] = moved[:64]
    torch.cuda.synchronize()
    launches = read_launches()
    if launches != launch_counts(resunit_f32=4, mma=2):
        raise AssertionError(f"kernel launches {launches}, expected 4 "
                             f"resunit_f32 and 2 tensor-core")
    emit("golden_parity", t0, goldens=results, launches=launches)
    return launches


def phase_voc_golden(device):
    """vocoder_apply_folded on the card in true f32 against the reference's
    batch `y` (rtol 1e-3, atol 1e-5, tests/test_vocoder_parity.py:56,85);
    the trained golden's biases exercise the masking before t=0.  Returns
    the launch counts of the phase, all of csrc/resunit_stack.cu."""
    t0 = time.perf_counter()
    results = {}
    reset_launches()
    for name, kw in VOC_GOLDENS.items():
        data = np.load(GOLDEN / f"{name}.npz")
        sd = {k[len("sd__"):]: data[k] for k in data.files
              if k.startswith("sd__")}
        cfg = VocoderConfig(**kw)
        p = tree_map(lambda a: a.to(device),
                     vocoder_params_from_reference_sd(sd, cfg))
        c = data["zq"] if "zq" in data.files else data["c"]
        c = torch.from_numpy(c.transpose(0, 2, 1)).to(device)
        before = folded_stack.resunit_launches
        y = fast.vocoder_apply_folded(p, c, cfg, bf16_dots=False)
        torch.cuda.synchronize()
        launches = folded_stack.resunit_launches - before
        if launches == 0:
            raise AssertionError(f"{name}: no true-f32 kernel launch")
        y = y.cpu().numpy().transpose(0, 2, 1)
        np.testing.assert_allclose(y, data["y"], rtol=1e-3, atol=1e-5)
        results[name] = {"samples": int(data["y"].shape[-1]),
                         "max_abs_err": float(np.abs(y - data["y"]).max()),
                         "resunit_f32_launches": launches}
    launches = read_launches()
    if launches != launch_counts(resunit_f32=launches["resunit_f32"]):
        raise AssertionError(f"kernel launches {launches}: a true-f32 "
                             f"vocoder took another kernel")
    emit("voc_golden", t0, goldens=results, launches=launches)
    return launches


def kernel_timing(params, device, dtype, gen):
    """The autoencoder units at (16, 32, 480000) with the golden's weights
    as the main path runs them (bf16 operands): the tensor-core kernel's
    ms, the plain version's and the chain's, and the bound."""
    b, c, t = BATCH, 32, SECONDS * SR
    units = stack_units(params, "encoder" if dtype == torch.float32
                        else "decoder", device, dtype)
    x = torch.randn(b, c, t, generator=gen, device=device).to(dtype)
    row = {
        "shape": [b, c, t], "dtype": str(dtype)[6:],
        **check_stack(x, units, bf16_dots=True),
        "ms": cuda_ms(lambda: folded_stack.folded_residual_stack(x, units),
                      reps=5),
        "plain_ms": cuda_ms(lambda: folded_stack.folded_residual_stack_plain(
            x, units, DILATIONS), reps=3),
        "chain_ms": cuda_ms(lambda: chain(x, units), reps=3),
    }
    row.update(kernel_bounds.mma_stack(b, t, c, storage=x.element_size()))
    return row


def voc_kernel_timing(p_block, cfg: VocoderConfig, device, gen):
    """Per group of the AD v1 path's last stage at (16, 32, 480000) bf16:
    the tensor-core kernel's ms, the plain version's and the chain's, and
    the bound."""
    c = cfg.stage_channels(len(cfg.upsample_scales) - 1)
    b, t = BATCH, SECONDS * SR
    k = cfg.resblock_kernel_sizes[0]
    dil = tuple(cfg.resblock_dilations[0])
    slope = dict(cfg.nonlinear_activation_params)["negative_slope"]
    x = torch.randn(b, c, t, generator=gen, device=device).to(torch.bfloat16)
    rows = []
    for g in range(cfg.groups):
        units, biases = fast._voc_resblock_params(group_params(p_block, g, c))
        kw = dict(dilations=dil, kernel_size=k, kernel_size2=k,
                  act="leaky_relu", act_param=slope, biases=biases)
        row = {"group": g, "shape": [b, c, t], "dtype": "bfloat16",
               **check_mma(x, units, **kw),
               "ms": cuda_ms(lambda: folded_stack.folded_residual_stack(
                   x, units, **kw), reps=5),
               "plain_ms": cuda_ms(lambda: plain_of(x, units, kw), reps=2),
               "chain_ms": cuda_ms(lambda: chain(x, units, dil, "leaky_relu",
                                                 slope, biases), reps=2)}
        row.update(kernel_bounds.mma_stack(b, t, c, k=k, k2=k, storage=2,
                                           bias=biases is not None,
                                           units=len(dil)))
        rows.append(row)
    return rows


def f32_timing(params, device, gen):
    """True f32 at C = 32, the route of csrc/resunit_stack.cu there (PR 14;
    the narrow FMA kernels before), at (16, 32, 480000) f32: the
    autoencoder units with the golden's encoder weights and the vocoder
    units at k = 11 with seeded weights and biases, each held bit-equal to
    the plain version, with the plain version's and the chain's ms and the
    bound at the f32 FMA peak."""
    b, c, t = BATCH, 32, SECONDS * SR
    x = torch.randn(b, c, t, generator=gen, device=device)
    ae = stack_units(params, "encoder", device, torch.float32)
    voc, voc_kw = shape_units(c, "leaky_relu", 11, 11, True, VOC_DILATIONS,
                              device, torch.float32, gen)
    rows = []
    for name, units, kw in (("autoencoder", ae, {}),
                            ("vocoder k=11, biases", voc, voc_kw)):
        kw = {"dilations": DILATIONS, **kw}
        k, k2 = kw.get("kernel_size", 7), kw.get("kernel_size2", 1)
        row = {"units": name, "shape": [b, c, t], "dtype": "float32",
               "bf16_dots": False, **check_f32(x, units, **kw),
               "ms": cuda_ms(lambda: folded_stack.folded_residual_stack(
                   x, units, bf16_dots=False, **kw), reps=3),
               "plain_ms": cuda_ms(lambda: plain_of(
                   x, units, {**kw, "bf16_dots": False}), reps=2),
               "chain_ms": cuda_ms(lambda: chain(
                   x, units, kw["dilations"], kw.get("act", "elu"),
                   VOC_SLOPE, kw.get("biases")), reps=2)}
        row.update(kernel_bounds.residual_stack(
            b, t, c, k=k, k2=k2, storage=4, weight=4, peak="f32",
            bias=kw.get("biases") is not None))
        rows.append(row)
    return rows


def read_launches() -> dict:
    return {"mma": folded_stack.mma_launches,
            "mma_voc": folded_stack.mma_voc_launches,
            "mma_other": folded_stack.mma_other_launches,
            "int8": folded_stack.int8_launches,
            "resunit": resunit_kernel.launches,
            "rvq": vq_kernel.launches,
            "dot_chain": dot_chain.launches,
            "ablate": ablate_stack.launches,
            "int8_tile": folded_stack.int8_tile_launches,
            "wide": folded_stack.wide_launches,
            "resunit_f32": folded_stack.resunit_launches}


def launch_counts(**nonzero) -> dict:
    """The counts a path must leave: those named, and 0 for every other
    kernel."""
    counts = dict.fromkeys(read_launches(), 0)
    counts.update(nonzero)
    return counts


def reset_launches():
    folded_stack.mma_launches = folded_stack.mma_voc_launches = 0
    folded_stack.mma_other_launches = 0
    folded_stack.int8_launches = folded_stack.int8_tile_launches = 0
    folded_stack.wide_launches = folded_stack.resunit_launches = 0
    resunit_kernel.launches = vq_kernel.launches = 0
    dot_chain.launches = ablate_stack.launches = 0


def check_transcode(idx, y, x, cfg: GeneratorConfig):
    frames = x.shape[1] // cfg.hop_length
    if tuple(idx.shape) != (x.shape[0], frames, cfg.codebook_num):
        raise AssertionError(f"indices {tuple(idx.shape)}")
    if int(idx.min()) < 0 or int(idx.max()) >= cfg.codebook_size:
        raise AssertionError("index out of range")
    if tuple(y.shape) != tuple(x.shape) or not torch.isfinite(y).all():
        raise AssertionError("decoded waveform not finite or misshapen")


def time_transcoder(tc, x, idx) -> dict:
    torch.cuda.reset_peak_memory_stats()
    transcode_ms = cuda_ms(lambda: tc(x), reps=3)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    return {"transcode_ms": transcode_ms,
            "encode_ms": cuda_ms(lambda: tc.encode(x), reps=3),
            "decode_ms": cuda_ms(lambda: tc.decode(idx), reps=3),
            "rtf": BATCH * SECONDS / (transcode_ms / 1e3),
            "peak_memory_gib": peak_gib}


def phase_main_path(device):
    t0 = time.perf_counter()
    cfg = GeneratorConfig()
    _, params = load_golden("gen_symad_trained")
    tc = BatchTranscoder(params, cfg, dtype=torch.float32,
                         dec_dtype=torch.bfloat16, stack="folded",
                         device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = 0.3 * torch.randn(BATCH, SECONDS * SR, 1, generator=gen,
                          device=device)

    reset_launches()
    idx, y = tc(x)
    torch.cuda.synchronize()
    launches = read_launches()
    if launches != launch_counts(mma=2):
        raise AssertionError(f"kernel launches {launches}, expected 2 of "
                             f"the tensor-core kernel (autoencoder units) "
                             f"and no other")
    check_transcode(idx, y, x, cfg)

    times = time_transcoder(tc, x, idx)
    rows = [kernel_timing(params, device, dt, gen)
            for dt in (torch.float32, torch.bfloat16)]
    emit("main_path", t0, batch=BATCH, seconds_of_audio=BATCH * SECONDS,
         **times, launches=launches, folded_stack=rows)
    return launches, rows, tc, x, idx, params


def phase_ad_v1_path(device, params, x, idx_symad):
    """The AD v1 receiver: the symAD encoder and RVQ with the trained
    golden's weights, the AudioDec_v1 48 kHz vocoder at full width with
    random weights from a seed (normal at scale 0.01, zero biases, stats 0
    and 1, as the JAX vocoder_init), mixed mode, stack="folded"."""
    t0 = time.perf_counter()
    cfg = GeneratorConfig()
    vcfg = config_from_yaml(AD_V1_VOCODER, stats=True)
    gen = torch.Generator(device=device).manual_seed(SEED)
    voc = vocoder_init(vcfg, gen)
    tc = BatchTranscoder(params, cfg, voc=(voc, vcfg), dtype=torch.float32,
                         dec_dtype=torch.bfloat16, stack="folded",
                         device=device)

    reset_launches()
    idx, y = tc(x)
    torch.cuda.synchronize()
    launches = read_launches()
    if launches != launch_counts(mma=1, mma_voc=3, wide=9):
        raise AssertionError(f"kernel launches {launches}, expected 4 of "
                             f"the tensor-core kernel (1 autoencoder and 3 "
                             f"vocoder units), 9 of the wide one (3 groups "
                             f"at each stage above C = 32) and no other")
    check_transcode(idx, y, x, cfg)
    if not torch.equal(idx, idx_symad):
        raise AssertionError("the AD v1 path's indices differ from the "
                             "main path's (same encoder, same input)")
    # the mixed-mode decode against the true-f32 one on 2 rows x 1 s
    short = idx[:2, :SR // cfg.hop_length]
    ref = BatchTranscoder(params, cfg, voc=(voc, vcfg), stack="folded",
                          bf16_dots=False, device=device).decode(short)
    got = tc.decode(short)
    mixed_rel = float((got - ref).abs().max() / ref.abs().max())
    if not mixed_rel < 0.05:
        raise AssertionError(f"mixed decode off the f32 decode by "
                             f"{mixed_rel:.3g} of its peak")

    times = time_transcoder(tc, x, idx)
    last = len(vcfg.upsample_scales) - 1
    rows = voc_kernel_timing(tc.dec_params["blocks"][last], vcfg, device,
                             gen)
    emit("ad_v1_path", t0, batch=BATCH, seconds_of_audio=BATCH * SECONDS,
         **times, launches=launches, peak_abs_y=float(y.abs().max()),
         mixed_vs_f32_decode_rel_err=mixed_rel, resblock_stack=rows)
    return launches, rows, tc


def int8_kw(units, dilations, kw) -> dict:
    """The wrapper's keyword arguments of a unit shape (shape_units' kw,
    or ELU units of the weights' k)."""
    return {"dilations": dilations, "kernel_size": units[0][0].shape[-1],
            "kernel_size2": units[0][1].shape[-1], "act": "elu",
            "act_param": 0.0, "biases": None, **kw}


def check_int8(x, units, fold: int = 0, dilations=DILATIONS, **kw):
    """int8-mode kernel ("row" scales) vs its plain version on the same
    inputs (ELU units of the weights' k, or the unit shape of kw); returns
    (max abs error, the same relative to the peak, the kernel's error
    relative to the f32 chain's peak)."""
    kw = int8_kw(units, dilations, kw)
    out = folded_stack.folded_residual_stack(x, units, int8_dots=True,
                                             fold=fold, **kw)
    ref = folded_stack.folded_residual_stack_int8_plain(
        x, units, dilations, fold, act=kw["act"], act_param=kw["act_param"],
        biases=kw["biases"])
    f32 = chain(x.float(), units, dilations, kw["act"], kw["act_param"],
                kw["biases"])  # f32, no quantization
    torch.cuda.synchronize()
    if out.dtype != x.dtype or out.shape != x.shape:
        raise AssertionError(f"int8 kernel gave {out.dtype} "
                             f"{tuple(out.shape)}")
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError("int8 kernel output is not finite")
    if torch.equal(out, x.float()):
        raise AssertionError("int8 kernel returned its input unchanged")
    err = float((out - ref).abs().max())
    rel = err / float(ref.abs().max())
    if not rel <= INT8_REL:
        raise AssertionError(f"int8 kernel off its plain version by "
                             f"{rel:.3g} of the peak (bound {INT8_REL})")
    return err, rel, float((out - f32).abs().max() / f32.abs().max())


def check_int8_tile(x, units, fold: int = 0,
                    tile_rows: int = folded_stack.DEFAULT_TILE_ROWS,
                    dilations=DILATIONS, **kw) -> dict:
    """The tile-mode kernel (csrc/int8_tile_mma.cu) vs its plain version on
    the same inputs (ELU units of the weights' k, or the unit shape of
    kw): bit equality is expected, the bar is INT8_REL of the peak (the
    plain version's f64 fma can round twice where fmaf rounds once, in
    about 2^-29 of the residual updates); returns the errors and the count
    of differing outputs."""
    kw = int8_kw(units, dilations, kw)
    before = folded_stack.int8_tile_launches
    out = folded_stack.folded_residual_stack(
        x, units, int8_dots=True, int8_scale="tile", fold=fold,
        tile_rows=tile_rows, **kw)
    if folded_stack.int8_tile_launches != before + 1:
        raise AssertionError("csrc/int8_tile_mma.cu was not launched")
    ref = folded_stack.folded_residual_stack_int8_tile_plain(
        x, units, dilations, fold, tile_rows, act=kw["act"],
        act_param=kw["act_param"], biases=kw["biases"])
    torch.cuda.synchronize()
    if out.dtype != x.dtype or out.shape != x.shape:
        raise AssertionError(f"tile kernel gave {out.dtype} "
                             f"{tuple(out.shape)}")
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError("tile kernel output is not finite")
    if torch.equal(out, x.float()):
        raise AssertionError("tile kernel returned its input unchanged")
    diff = (out - ref).abs()
    err, peak = float(diff.max()), float(ref.abs().max())
    if not err <= INT8_REL * peak:
        raise AssertionError(f"tile kernel at {tuple(x.shape)} {x.dtype}, "
                             f"fold {fold}, tile_rows {tile_rows}: off its "
                             f"plain version by {err / peak:.3g} of the "
                             f"peak (bound {INT8_REL})")
    return {"max_abs_err": err, "max_rel_err": err / peak,
            "differing": int((diff > 0).sum())}


def decoder_units(params, block: int, device):
    """Unit weights of a symAD decoder block's stack, f32."""
    bp = params["decoder"]["blocks"][block]
    return tuple((u["conv1"]["w"].to(device), u["conv2"]["w"].to(device))
                 for u in bp["res"])


def phase_int8_kernel_vs_plain(params, device):
    """The int8-mode kernel against its plain version: random weights at
    C = 4, 32, 64, 128 and 256 with ragged T (T not a multiple of the fold
    F = 128 // C, one T shorter than the halo), the same at larger folds
    and in bf16 storage, and the trained golden's four decoder stacks at
    their main-path lengths (B=2)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    cases = []
    for c, t in ((4, 1999), (4, 50), (32, 4803), (64, 1601), (128, 803),
                 (256, 161), (256, 8001)):
        units = random_units(c, device, torch.float32, gen)
        x = torch.randn(2, c, t, generator=gen, device=device)
        err, rel, chain_rel = check_int8(x, units)
        cases.append({"C": c, "T": t, "weights": "random",
                      "max_abs_err": err, "max_rel_err": rel,
                      "rel_err_vs_f32_chain": chain_rel})
    for block, (c, t) in enumerate(INT8_SHAPES):
        units = decoder_units(params, block, device)
        x = torch.randn(2, c, t, generator=gen, device=device)
        err, rel, chain_rel = check_int8(x, units)
        cases.append({"C": c, "T": t, "weights": f"decoder block {block}",
                      "max_abs_err": err, "max_rel_err": rel,
                      "rel_err_vs_f32_chain": chain_rel})
    # slice 6: folds with f * C = 256 and 512 and bf16 storage
    for c, t, f in ((4, 1999, 64), (32, 4803, 8), (32, 4803, 16),
                    (64, 1601, 4), (64, 1601, 8), (128, 803, 2),
                    (128, 803, 4), (256, 8001, 2), (32, 4803, 0),
                    (256, 161, 0)):
        units = random_units(c, device, torch.float32, gen)
        x = torch.randn(2, c, t, generator=gen, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            if f == 0 and dtype == torch.float32:
                continue
            err, rel, chain_rel = check_int8(x.to(dtype), units, f)
            cases.append({"C": c, "T": t,
                          "fold": f or folded_stack.int8_fold(c),
                          "storage": str(dtype)[6:], "weights": "random",
                          "max_abs_err": err, "max_rel_err": rel,
                          "rel_err_vs_f32_chain": chain_rel})
    # slice 9: the int8 decode's other unit shapes (cfg.res_kernel_size,
    # cfg.res_dilations), which raised on the card before
    for c, t, k, dil in INT8_UNIT_SHAPES:
        units, _ = shape_units(c, "elu", k, 1, False, dil, device,
                               torch.float32, gen)
        x = torch.randn(2, c, t, generator=gen, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            err, rel, chain_rel = check_int8(x.to(dtype), units,
                                             dilations=dil)
            cases.append({"C": c, "T": t, "k": k, "dilations": list(dil),
                          "storage": str(dtype)[6:], "weights": "random",
                          "max_abs_err": err, "max_rel_err": rel,
                          "rel_err_vs_f32_chain": chain_rel})
    # slice 11: every unit shape, the widths refused before (C = 2, 3 and
    # 264) and C = 4 at f = 128, whose tile of 16 rows of every phase
    # outgrew a block before
    for name, (act, k, k2, bias, dil, c, t) in INT8_NEW_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            units, kw = shape_units(c, act, k, k2, bias, dil, device,
                                    torch.float32, gen)
            x = torch.randn(2, c, t, generator=gen, device=device).to(dtype)
            err, rel, chain_rel = check_int8(x, units, **kw)
            cases.append({"units": name, "C": c, "T": t,
                          "storage": str(dtype)[6:], "weights": "random",
                          "max_abs_err": err, "max_rel_err": rel,
                          "rel_err_vs_f32_chain": chain_rel})
    for c, t, folds, _ in INT8_NEW_WIDTHS[:3] + ((4, 1999, (128,), ()),):
        units = random_units(c, device, torch.float32, gen)
        x = torch.randn(2, c, t, generator=gen, device=device)
        for f in folds:
            for dtype in (torch.float32, torch.bfloat16):
                err, rel, chain_rel = check_int8(x.to(dtype), units, f)
                cases.append({"C": c, "T": t,
                              "fold": f or folded_stack.int8_fold(c),
                              "storage": str(dtype)[6:], "weights": "random",
                              "max_abs_err": err, "max_rel_err": rel,
                              "rel_err_vs_f32_chain": chain_rel})
    emit("int8_kernel_vs_plain", t0,
         tolerance=f"max error < {INT8_REL} x peak (bit-equal expected)",
         bit_equal=f"{sum(c['max_abs_err'] == 0 for c in cases)} of "
                   f"{len(cases)}", cases=cases)


def phase_int8_tile_kernel_vs_plain(params, device):
    """csrc/int8_tile_mma.cu against its plain version: random weights at
    C = 32, 64, 128 and 256, two ragged T per C (under and over 256 folded
    rows, so both paddings), two folds and two tile_rows (one giving 3 or
    more tiles), f32 and bf16 storage; the trained golden's four decoder
    stacks at their main-path lengths (B=2) at the defaults; and (slice
    11) every unit shape of INT8_NEW_SHAPES in both storages and the
    widths of INT8_NEW_WIDTHS (C = 2, 3, 264, 512) at two folds and two
    tile_rows in both storages."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    grid = {32: ((700, 4803), (4, 8), (64, 1024)),
            64: ((700, 1601), (2, 4), (64, 1024)),
            128: ((200, 803), (1, 2), (64, 1024)),
            256: ((161, 8001), (1, 2), (64, 512))}
    cases = []
    for c, (ts, fs, trs) in grid.items():
        units = random_units(c, device, torch.float32, gen)
        for t in ts:
            x = torch.randn(2, c, t, generator=gen, device=device)
            for f in fs:
                for tr in trs:
                    g = folded_stack.tile_geometry(c, t, DILATIONS, f, tr)
                    for dtype in (torch.float32, torch.bfloat16):
                        cases.append({
                            "C": c, "T": t, "fold": f, "tile_rows": tr,
                            "tiles": g.n_tiles, "rows": g.n_rows,
                            "storage": str(dtype)[6:], "weights": "random",
                            **check_int8_tile(x.to(dtype), units, f, tr)})
    for block, (c, t) in enumerate(INT8_SHAPES):
        units = decoder_units(params, block, device)
        x = torch.randn(2, c, t, generator=gen, device=device)
        cases.append({"C": c, "T": t, "weights": f"decoder block {block}",
                      "storage": "float32", **check_int8_tile(x, units)})
    for name, (act, k, k2, bias, dil, c, t) in INT8_NEW_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            units, kw = shape_units(c, act, k, k2, bias, dil, device,
                                    torch.float32, gen)
            x = torch.randn(2, c, t, generator=gen, device=device).to(dtype)
            cases.append({"units": name, "C": c, "T": t,
                          "storage": str(dtype)[6:], "weights": "random",
                          **check_int8_tile(x, units, tile_rows=64, **kw)})
    for c, t, folds, trs in INT8_NEW_WIDTHS:
        units = random_units(c, device, torch.float32, gen)
        x = torch.randn(2, c, t, generator=gen, device=device)
        for f in folds:
            for tr in trs:
                for dtype in (torch.float32, torch.bfloat16):
                    cases.append({
                        "C": c, "T": t, "fold": f or folded_stack.int8_fold(c),
                        "tile_rows": tr, "storage": str(dtype)[6:],
                        "weights": "random",
                        **check_int8_tile(x.to(dtype), units, f, tr)})
    emit("int8_tile_kernel_vs_plain", t0,
         tolerance=f"bit-equal expected; max error <= {INT8_REL} x peak",
         bit_equal=f"{sum(c['differing'] == 0 for c in cases)} of "
                   f"{len(cases)}", cases=cases)


def check_wide(x, units, pool: list | None = None, **kw) -> dict:
    """A stack above C = 32 through the wrapper against its plain version.
    With bf16 operands or storage (csrc/wide_stack_mma.cu, counted in
    `wide`): relative L2 within the larger of WIDE_RL2 and
    ABLATE_FLOOR_FACTOR times the plain version's own distance from exact
    sums, to the plain version and to the exact sums (mma_bars), and max
    error within WIDE_MAX_REL of the peak.  Given a `pool`, a case shorter
    than the halo adds its squared sums there for check_pool instead of
    meeting the relative L2 bar alone, as check_mma pools; without one
    every case meets it alone.  In true f32 (csrc/resunit_stack.cu, counted
    in `resunit_f32`) the f32 tolerance of check_close, and whether the two
    are bit-equal."""
    bf16_dots = kw.get("bf16_dots", True)
    counter = ("wide" if bf16_dots or x.dtype == torch.bfloat16
               else "resunit_f32")
    kw = {"dilations": DILATIONS, **kw}
    before = read_launches()[counter]
    out = folded_stack.folded_residual_stack(x, units, **kw)
    ref = plain_of(x, units, kw)
    torch.cuda.synchronize()
    if read_launches()[counter] != before + 1:
        raise AssertionError(f"{counter}: the kernel was not launched")
    if out.dtype != x.dtype or out.shape != x.shape:
        raise AssertionError(f"{counter} kernel gave {out.dtype} "
                             f"{tuple(out.shape)}")
    if counter == "resunit_f32":
        err, rel = check_close(out, ref, x, False)
        return {"max_abs_err": err, "max_rel_err": rel,
                "bit_equal": bool(torch.equal(out, ref))}
    exact = plain_of(x, units, kw, exact_sums=True)
    o, r = out.float(), ref.float()
    if not torch.isfinite(o).all():
        raise AssertionError("wide kernel output is not finite")
    if torch.equal(o, x.float()):
        raise AssertionError("wide kernel returned its input")
    err, peak = float((o - r).abs().max()), float(r.abs().max())
    sums = {"d_plain": sq(out, ref), "plain": sq(ref),
            "d_exact": sq(out, exact), "exact": sq(exact),
            "d_plain_exact": sq(ref, exact)}
    rec = {**mma_bars(sums, WIDE_RL2), "max_abs_err": err,
           "max_rel_err": err / peak}
    halo = sum((kw.get("kernel_size", 7) - 1) * d + kw.get("kernel_size2", 1)
               - 1 for d in kw["dilations"])
    if x.shape[-1] < halo and pool is not None:
        pool.append(sums)
        rec["pooled"] = True
    elif not rec["passed"]:
        raise AssertionError(f"wide kernel at {tuple(x.shape)} {x.dtype} "
                             f"{kw}: {rec}")
    if not err <= WIDE_MAX_REL * peak:
        raise AssertionError(f"wide kernel at {tuple(x.shape)} {x.dtype} "
                             f"{kw}: max error {err / peak:.3g} of the peak")
    return rec


# the unit shapes of the wide cases: the four no shipped config uses, the
# vocoder units at k = k2 = 3, 7, 11 with and without biases, and the
# autoencoder units
WIDE_SHAPES = {
    **MMA_OTHER_SHAPES,
    **{f"vocoder k={k}{', biases' if bias else ''}":
       ("leaky_relu", k, k, bias, VOC_DILATIONS)
       for k in (3, 7, 11) for bias in (True, False)},
    "autoencoder": ("elu", 7, 1, False, DILATIONS),
}


def phase_wide_kernel_vs_plain(device):
    """Every unit shape of WIDE_SHAPES at C = 48, 64, 96, 128 and 256,
    T = 1999 and 50 (shorter than most halos), B = 2: with bf16 dots in f32
    and bf16 storage csrc/wide_stack_mma.cu, and in true f32
    csrc/resunit_stack.cu, each against its plain version (check_wide).
    The autoencoder units, which this phase checked before the other
    shapes, hold every case to the relative L2 bar alone; the other shapes'
    cases shorter than the halo are pooled.  Returns the launch counts of
    the phase."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    reset_launches()
    cases, pool = [], []
    for name, (act, k, k2, bias, dil) in WIDE_SHAPES.items():
        for c in (48, 64, 96, 128, 256):
            for t in (1999, 50):
                for dtype, bf16_dots in ((torch.float32, True),
                                         (torch.bfloat16, True),
                                         (torch.float32, False)):
                    units, kw = shape_units(c, act, k, k2, bias, dil, device,
                                            dtype, gen)
                    x = torch.randn(2, c, t, generator=gen,
                                    device=device).to(dtype)
                    cases.append({"units": name, "C": c, "T": t,
                                  "storage": str(dtype)[6:],
                                  "bf16_dots": bf16_dots,
                                  **check_wide(
                                      x, units,
                                      None if name == "autoencoder" else pool,
                                      bf16_dots=bf16_dots, **kw)})
    launches = read_launches()
    f32 = [c for c in cases if not c["bf16_dots"]]
    emit("wide_kernel_vs_plain", t0, tolerance={
        "bf16 operands": f"rel_l2 and exact_rl2 <= bar_rl2 = max({WIDE_RL2}, "
                         f"{ABLATE_FLOOR_FACTOR} x plain_exact_rl2), per "
                         f"case (the autoencoder units at every T), or over "
                         f"the other shapes' cases shorter than the halo "
                         f"pooled; max error <= {WIDE_MAX_REL} x peak",
        "f32": f"rtol {F32_RTOL}, atol {F32_ATOL_REL} x peak"},
        short_cases_pooled=check_pool(pool, WIDE_RL2),
        pooled_over_own_bar=[c for c in cases
                             if c.get("pooled") and not c["passed"]],
        launches=launches,
        f32_bit_equal=f"{sum(c['bit_equal'] for c in f32)} of {len(f32)}",
        cases=cases)
    return launches


def phase_wide_c_kernel_vs_plain(device):
    """Every mode above C = 256, which the card refused before (slice 11),
    at WIDE_C's (2, C, T): the autoencoder units and the vocoder units at
    k = 11 with biases in true f32 (csrc/resunit_stack.cu, bit-equal) and
    with bf16 dots in f32 and bf16 storage (csrc/wide_stack_mma.cu,
    check_wide's bar, each case alone); the int8 "row" and "tile" modes in
    both storages (bit equality expected, INT8_REL); the archived stack
    (archive/resunit_kernel.py, bit-equal).  Then one call of each mode
    timed at WIDE_C_TIMED with random autoencoder units, beside its bound,
    its plain version's time and the F.elu / F.conv1d chain's in the
    working dtype (speed above C = 256 is not judged yet)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    cases = []
    for c, t in WIDE_C:
        for name in ("autoencoder", "vocoder k=11, biases"):
            act, k, k2, bias, dil = WIDE_SHAPES[name]
            for dtype, bf16_dots in ((torch.float32, True),
                                     (torch.bfloat16, True),
                                     (torch.float32, False)):
                units, kw = shape_units(c, act, k, k2, bias, dil, device,
                                        dtype, gen)
                x = torch.randn(2, c, t, generator=gen,
                                device=device).to(dtype)
                rec = check_wide(x, units, bf16_dots=bf16_dots, **kw)
                if not rec.get("bit_equal", True):
                    raise AssertionError(f"true f32 at C={c} ({name}) is "
                                         f"not bit-equal")
                cases.append({"mode": "wide" if bf16_dots else "true f32",
                              "units": name, "C": c, "T": t,
                              "storage": str(dtype)[6:], **rec})
        units = random_units(c, device, torch.float32, gen)
        x = torch.randn(2, c, t, generator=gen, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            err, rel, _ = check_int8(x.to(dtype), units)
            cases.append({"mode": "int8 row", "C": c, "T": t,
                          "storage": str(dtype)[6:], "max_abs_err": err,
                          "max_rel_err": rel})
            cases.append({"mode": "int8 tile", "C": c, "T": t,
                          "storage": str(dtype)[6:],
                          **check_int8_tile(x.to(dtype), units,
                                            tile_rows=64)})
        out = resunit_kernel.fused_residual_stack_bct(x, units)
        ref = resunit_kernel.fused_residual_stack_plain(x, units, DILATIONS)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"the archived stack at C={c} is not "
                                 f"bit-equal")
        cases.append({"mode": "archived stack", "C": c, "T": t,
                      "storage": "float32", "bit_equal": True})
    b, c, t = WIDE_C_TIMED
    units = random_units(c, device, torch.float32, gen)
    x = torch.randn(b, c, t, generator=gen, device=device)
    xb = x.to(torch.bfloat16)
    unitsb = tuple((w1.to(torch.bfloat16), w2.to(torch.bfloat16))
                   for w1, w2 in units)
    stack = folded_stack.folded_residual_stack
    plain = folded_stack.folded_residual_stack_plain
    int8_plain = folded_stack.folded_residual_stack_int8_plain
    tile_plain = folded_stack.folded_residual_stack_int8_tile_plain
    # name: (the kernel's call, its plain version's, the chain's in the
    # working dtype, the bound)
    timed = {
        "true f32 (csrc/resunit_stack.cu)": (
            lambda: stack(x, units, bf16_dots=False),
            lambda: plain(x, units, DILATIONS, False),
            lambda: chain(x, units), kernel_bounds.resunit_stack(b, t, c)),
        "bf16 dots, f32 storage (csrc/wide_stack_mma.cu)": (
            lambda: stack(x, units), lambda: plain(x, units, DILATIONS),
            lambda: chain(x, units), kernel_bounds.mma_stack(b, t, c)),
        "bf16 storage (csrc/wide_stack_mma.cu)": (
            lambda: stack(xb, unitsb), lambda: plain(xb, unitsb, DILATIONS),
            lambda: chain(xb, unitsb),
            kernel_bounds.mma_stack(b, t, c, storage=2)),
        "int8 row (csrc/int8_mma_stack.cu)": (
            lambda: stack(x, units, int8_dots=True),
            lambda: int8_plain(x, units, DILATIONS),
            lambda: chain(x, units), kernel_bounds.int8_stack(b, t, c)),
        "int8 tile (csrc/int8_tile_mma.cu)": (
            lambda: stack(x, units, int8_dots=True, int8_scale="tile"),
            lambda: tile_plain(x, units, DILATIONS),
            lambda: chain(x, units), kernel_bounds.int8_stack(b, t, c)),
        "archived stack (csrc/resunit_stack.cu)": (
            lambda: resunit_kernel.fused_residual_stack_bct(x, units),
            lambda: resunit_kernel.fused_residual_stack_plain(x, units,
                                                              DILATIONS),
            lambda: chain(x, units), kernel_bounds.resunit_stack(b, t, c)),
    }
    times = {name: {"shape": [b, c, t], "ms": cuda_ms(fn, reps=2),
                    "plain_ms": cuda_ms(plain_fn, reps=1),
                    "chain_ms": cuda_ms(chain_fn, reps=2), **bound}
             for name, (fn, plain_fn, chain_fn, bound) in timed.items()}
    emit("wide_c_kernel_vs_plain", t0,
         tolerance={"true f32, archived stack": "bit-equal",
                    "bf16 operands": f"check_wide: rel_l2 <= max({WIDE_RL2},"
                                     f" {ABLATE_FLOOR_FACTOR} x plain_exact_"
                                     f"rl2) per case, max error <= "
                                     f"{WIDE_MAX_REL} x peak",
                    "int8": f"max error <= {INT8_REL} x peak (bit-equal "
                            f"expected)"},
         cases=cases, timed=times)


def phase_wide_voc_kernel_vs_plain(device):
    """The vocoders' resblocks above C = 32 at their own shapes, B = 16 x
    10 s at WIDE_VOC_STAGES, k = k2 in WIDE_VOC_KS, dilations 1, 3, 5, seeded
    biases, LeakyReLU 0.1, bf16 storage: csrc/wide_stack_mma.cu against its
    plain version at check_wide's bars, each case alone; then ms of one
    call beside its bound and the F.leaky_relu / F.conv1d chain's in bf16
    (what the vocoder's plain route runs)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    rows = []
    for c, t in WIDE_VOC_STAGES:
        for k in WIDE_VOC_KS:
            units, kw = shape_units(c, "leaky_relu", k, k, True,
                                    VOC_DILATIONS, device, torch.bfloat16,
                                    gen)
            x = torch.randn(BATCH, c, t, generator=gen, device=device) \
                .to(torch.bfloat16)
            row = {"units": f"vocoder k={k}, biases", "shape": [BATCH, c, t],
                   "storage": "bfloat16", **check_wide(x, units, **kw),
                   "ms": cuda_ms(lambda: folded_stack.folded_residual_stack(
                       x, units, **kw), reps=5),
                   "chain_ms": cuda_ms(lambda: chain(
                       x, units, VOC_DILATIONS, "leaky_relu", VOC_SLOPE,
                       kw["biases"]), reps=3),
                   **kernel_bounds.mma_stack(BATCH, t, c, k=k, k2=k,
                                             storage=2, bias=True)}
            row["roofline_pct"] = 100 * row["bound_ms"] / row["ms"]
            rows.append(row)
            del x
    emit("wide_voc_kernel_vs_plain", t0,
         tolerance=f"check_wide: rel_l2 and exact_rl2 <= max({WIDE_RL2}, "
                   f"{ABLATE_FLOOR_FACTOR} x plain_exact_rl2), max error <= "
                   f"{WIDE_MAX_REL} x peak",
         ms_ad_v1=sum(r["ms"] for r in rows if r["units"].startswith(
             "vocoder k=11")) * 3,
         ms_ad_v0=sum(r["ms"] for r in rows), rows=rows)
    return rows


def parent_wide_geometry(c, k, k2, dilations):
    """The replaced kernel's planner (PARENT_WIDE_COMMIT's
    ops/kernels/folded_stack.py wide_geometry): channels padded to a
    multiple of 32, a warp per 32 output channels, rows of 4 m16 tiles up
    to 16 warps and 256 samples, the widest stage of (128, 64, 32) input
    channels and the most buffers (3, then 2) that fit.  Returns (cp,
    warps_m, kc, nbuf)."""
    d = max(dilations)
    cp = -(-c // 32) * 32
    wn = cp // 32
    for wm in range(min(16 // wn, 4), 0, -1):
        rows = 64 * wm
        yrows = max(rows + (k - 1) * d, rows + k2 - 1)
        for kc in (v for v in (128, 64, 32) if cp % v == 0):
            for nbuf in (3, 2):
                if 2 * (yrows * (cp + 8) + nbuf * cp * (kc + 8)) <= 232448:
                    return cp, wm, kc, nbuf
    raise ValueError(f"the replaced wide kernel takes no C={c}, k={k}")


def parent_wide_kernel():
    """The replaced wide kernel (PARENT_WIDE_COMMIT's
    csrc/wide_stack_mma.cu, with the csrc/wide_mma.cuh it includes) built
    into PARENT_WIDE, its source from git or a copy already there.  Exits
    where neither is at hand or a file is another."""
    path = "audiodec_tpu_torch/csrc/wide_stack_mma.cu"
    src = PARENT_WIDE / "wide_stack_mma.cu"
    if not src.exists() and shutil.which("git"):
        proc = subprocess.run(["git", "show", f"{PARENT_WIDE_COMMIT}:{path}"],
                              cwd=ROOT, capture_output=True)
        if proc.returncode == 0:
            PARENT_WIDE.mkdir(parents=True, exist_ok=True)
            src.write_bytes(proc.stdout)
    if not src.exists():
        sys.exit(f"chip_smoke wide: no {src}: place {PARENT_WIDE_COMMIT}'s "
                 f"{path} there")
    header = _build.CSRC / "wide_mma.cuh"
    for f, want in ((src, PARENT_WIDE_SHA256),
                    (header, PARENT_WIDE_HEADER_SHA256)):
        if hashlib.sha256(f.read_bytes()).hexdigest() != want:
            sys.exit(f"chip_smoke wide: {f} is not {PARENT_WIDE_COMMIT}'s, "
                     f"whose launch interface PARENT_WIDE_ARGS states")
    lib = PARENT_WIDE / "libwide_stack_mma.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                    f"-I{_build.CSRC}", "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).wide_stack_forward
    fn.argtypes = PARENT_WIDE_ARGS
    fn.restype = ctypes.c_int
    return fn


def phase_wide_parent_ab(device):
    """The vocoders' resblocks above C = 32 at full size (WIDE_VOC_STAGES,
    k = k2 in WIDE_VOC_KS, bf16 storage, seeded biases): ms of one call of
    the replaced wide kernel (parent_wide_kernel) and of this one, in turns
    (parent, new, new, parent), 5 calls each, with each output's relative
    L2 from the plain version."""
    t0 = time.perf_counter()
    parent = parent_wide_kernel()
    gen = torch.Generator(device=device).manual_seed(SEED + 17)
    rows = []
    for c, t in WIDE_VOC_STAGES:
        for k in WIDE_VOC_KS:
            units, kw = shape_units(c, "leaky_relu", k, k, True,
                                    VOC_DILATIONS, device, torch.bfloat16,
                                    gen)
            x = torch.randn(BATCH, c, t, generator=gen, device=device) \
                .to(torch.bfloat16)
            cp, wm, kc, nbuf = parent_wide_geometry(c, k, k, VOC_DILATIONS)
            w1, w2, bias = folded_stack._packed_mma(units, kw["biases"], c,
                                                    cp)
            cdil = (ctypes.c_int * 3)(*VOC_DILATIONS)
            out = torch.empty_like(x)
            scratch = torch.empty((2,) + tuple(x.shape), device=device)

            def old():
                err = parent(x.data_ptr(), out.data_ptr(),
                             scratch.data_ptr(), w1.data_ptr(),
                             w2.data_ptr(), bias.data_ptr(), BATCH, c, t,
                             cp, 3, cdil, k, k,
                             folded_stack.MMA_ACT["leaky_relu"], VOC_SLOPE,
                             wm, kc, nbuf, 1,
                             torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"parent wide kernel: CUDA error "
                                       f"{err}")
                return out

            def new():
                return folded_stack.folded_residual_stack(x, units, **kw)

            ref = plain_of(x, units, kw)
            rl2 = {"parent_rel_l2": (sq(old(), ref) / sq(ref)) ** 0.5,
                   "new_rel_l2": (sq(new(), ref) / sq(ref)) ** 0.5}
            ms = [cuda_ms(fn, reps=5) for fn in (old, new, new, old)]
            bound = kernel_bounds.mma_stack(BATCH, t, c, k=k, k2=k,
                                            storage=2, bias=True)
            rows.append({"units": f"vocoder k={k}, biases",
                         "shape": [BATCH, c, t], "storage": "bfloat16",
                         "parent_ms": [ms[0], ms[3]],
                         "new_ms": [ms[1], ms[2]], **rl2,
                         "bound_ms": bound["bound_ms"],
                         "speedup": (ms[0] + ms[3]) / (ms[1] + ms[2])})
            del x, out, scratch, ref
    emit("wide_parent_ab", t0, commit=PARENT_WIDE_COMMIT, rows=rows)
    return rows


def phase_f32_unit_kernel_vs_plain(device):
    """True f32 at C <= 32 through csrc/resunit_stack.cu: the unit shapes
    no shipped config uses (MMA_OTHER_SHAPES) and the autoencoder and
    vocoder units with four units, at C = 4, 8, 20 and 32, T = 1999 and 50,
    B = 2, each to the f32 tolerance of check_close."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    shapes = {**MMA_OTHER_SHAPES,
              "autoencoder, four units": ("elu", 7, 1, False,
                                          (1, 3, 9, 27)),
              "vocoder k=11, biases, four units": ("leaky_relu", 11, 11,
                                                   True, (1, 3, 5, 7))}
    cases = []
    for name, (act, k, k2, bias, dil) in shapes.items():
        for c in (4, 8, 20, 32):
            for t in (1999, 50):
                units, kw = shape_units(c, act, k, k2, bias, dil, device,
                                        torch.float32, gen)
                x = torch.randn(2, c, t, generator=gen, device=device)
                cases.append({"units": name, "C": c, "T": t,
                              **check_wide(x, units, bf16_dots=False, **kw)})
    emit("f32_unit_kernel_vs_plain", t0,
         tolerance=f"rtol {F32_RTOL}, atol {F32_ATOL_REL} x peak",
         bit_equal=f"{sum(c['bit_equal'] for c in cases)} of {len(cases)}",
         cases=cases)


def int8_kernel_timing(params, device, gen):
    """Per decoder stack of the int8 path: the int8-mode kernel's ms in
    f32 and in bf16 storage, its launch geometry, the plain and f32-chain
    ms and the bound at (16, C, T) f32."""
    rows = []
    for block, (c, t) in enumerate(INT8_SHAPES):
        units = decoder_units(params, block, device)
        x = torch.randn(BATCH, c, t, generator=gen, device=device)
        xb = x.to(torch.bfloat16)
        err, _, _ = check_int8(x, units)
        row = {
            "shape": [BATCH, c, t], "dtype": "float32", "max_abs_err": err,
            "ms": cuda_ms(lambda: folded_stack.folded_residual_stack(
                x, units, dilations=DILATIONS, int8_dots=True), reps=5),
            "bf16_storage_ms": cuda_ms(
                lambda: folded_stack.folded_residual_stack(
                    xb, units, dilations=DILATIONS, int8_dots=True), reps=5),
            "plain_ms": cuda_ms(
                lambda: folded_stack.folded_residual_stack_int8_plain(
                    x, units, DILATIONS), reps=2),
            "chain_ms": cuda_ms(lambda: chain(x, units), reps=3),
            "cuda_launches_per_call": len(units),
            "geometry": folded_stack.int8_mma_geometry(
                c, folded_stack.int8_fold(c), 7, DILATIONS)._asdict(),
        }
        # each input read once (x f32, int8 weights), the output written
        # once; the dots' operations at the int8 tensor-core peak
        nbytes = 2 * x.numel() * x.element_size() + sum(
            w.numel() for u in units for w in u)
        ops = len(units) * (7 + 1) * c * c * 2 * BATCH * t
        row.update(bound_ms(nbytes, ops, "int8"))
        rows.append(row)
    return rows


def phase_int8_path(device, params, x, idx_main):
    """symAD with the int8 decode, B=16 x 10 s: the f32 encoder and RVQ
    (its C=32 stack in the autoencoder-mode kernel) and every decoder
    stack in the int8-mode kernel, f32 params, as `codec_test --dtype
    int8-decode` builds it (dec_dtype bf16, overridden to f32)."""
    t0 = time.perf_counter()
    cfg = GeneratorConfig()
    tc = BatchTranscoder(params, cfg, dtype=torch.float32,
                         dec_dtype=torch.bfloat16, int8_decode=True,
                         stack="folded", device=device)
    if not tc.int8_decode or tc.dec_dtype != torch.float32:
        raise AssertionError("the int8 decode was not taken")

    reset_launches()
    idx, y = tc(x)
    torch.cuda.synchronize()
    launches = read_launches()
    if launches != launch_counts(mma=1, int8=4):
        raise AssertionError(f"kernel launches {launches}, expected 1 of "
                             f"the tensor-core kernel (autoencoder units) "
                             f"and 4 int8-mode")
    check_transcode(idx, y, x, cfg)
    if not torch.equal(idx, idx_main):
        raise AssertionError("the int8 path's indices differ from the main "
                             "path's (same encoder, same input)")
    ref = BatchTranscoder(params, cfg, stack="folded", bf16_dots=False,
                          device=device).decode(idx)
    rel = float((y - ref).abs().max() / ref.abs().max())
    if not rel < INT8_DECODE_REL:
        raise AssertionError(f"int8 decode off the f32 decode by {rel:.3g} "
                             f"of its peak (bound {INT8_DECODE_REL})")

    times = time_transcoder(tc, x, idx)
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    rows = int8_kernel_timing(params, device, gen)
    emit("int8_path", t0, batch=BATCH, seconds_of_audio=BATCH * SECONDS,
         **times, launches=launches, int8_vs_f32_decode_rel_err=rel,
         int8_stack=rows)
    return launches, rows, tc


def phase_cli_path(params):
    """The command line on the card: the trained golden as a JAX-format
    checkpoint with the symAD config beside it, seeded PCM16 wavs of 2-10 s,
    `main` with --dtype int8-decode and with --dtype mixed."""
    t0 = time.perf_counter()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    exp, wavs = CLI_DIR / "exp", CLI_DIR / "wavs"
    exp.mkdir(parents=True)
    wavs.mkdir()
    shutil.copyfile(SYMAD_YAML, exp / "config.yml")
    ckpt = exp / "checkpoint-golden.ckpt"
    save_checkpoint(str(ckpt), {"gen": params_to_jax(params)}, 0)
    rng = np.random.default_rng(SEED)
    lengths = {}
    for i, sec in enumerate(CLI_SECONDS):
        n = int(sec * SR)
        x = np.clip(0.3 * rng.standard_normal((n, 1)), -1, 1)
        write_wav(str(wavs / f"utt{i}.wav"), x.astype(np.float32), SR)
        lengths[f"utt{i}_output.wav"] = n
    runs = {}
    for dtype in ("int8-decode", "mixed"):
        outdir = CLI_DIR / f"out_{dtype}"
        reset_launches()
        summary = codec_test.main([
            "--encoder", str(ckpt), "--decoder", str(ckpt),
            "--data-path", str(wavs), "--outdir", str(outdir),
            "--dtype", dtype, "--batch-size", "16"])
        launches = read_launches()
        files = sorted(p.name for p in outdir.iterdir())
        if files != sorted(lengths):
            raise AssertionError(f"--dtype {dtype} wrote {files}")
        for name, n in lengths.items():
            got = read_wav_pcm16(str(outdir / name))
            if got is None or got[0].shape != (n, 1) or got[1] != SR:
                raise AssertionError(f"--dtype {dtype}: {name} is not a "
                                     f"{n}-sample PCM16 wav")
            if not np.abs(got[0]).max() > 0:
                raise AssertionError(f"--dtype {dtype}: {name} is silent")
        want = 4 if dtype == "int8-decode" else 0
        if (launches["int8"] != want or launches["resunit"]
                or launches["rvq"]):
            raise AssertionError(f"--dtype {dtype}: {launches}")
        runs[dtype] = {"cli": summary, "launches": launches,
                       "files": len(files)}
    runs["readers"] = cli_readers(ckpt, wavs)
    print("cli_path " + json.dumps(runs["readers"]), flush=True)
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    emit("cli_path", t0, runs=runs)


def cli_readers(ckpt: Path, wavs: Path) -> dict:
    """The native WAV codec on cli_path's wavs: its samples bit-equal to the
    numpy reader's; then the command line with --float-in (every read
    through data/wav.py read_wav), --dtype mixed, once with the native
    reader and once with the numpy one -> each run's RTF."""
    paths = sorted(str(p) for p in wavs.iterdir())
    for path in paths:
        got, sr = read_wav(path)
        want, sr_plain = read_wav_plain(path)
        if sr != sr_plain or not np.array_equal(got, want):
            raise AssertionError(f"cli_path: the native read of {path} "
                                 f"differs from the numpy one")
    readers = {"native": read_wav, "plain": read_wav_plain}
    rtf = {name: [] for name in readers}
    for name in ("native", "plain", "plain", "native"):
        dataset_module.read_wav = readers[name]
        try:
            summary = codec_test.main([
                "--encoder", str(ckpt), "--decoder", str(ckpt),
                "--data-path", str(wavs), "--outdir",
                str(CLI_DIR / f"out_{name}"), "--dtype", "mixed",
                "--batch-size", "16", "--float-in"])
        finally:
            dataset_module.read_wav = read_wav
        rtf[name].append(summary["rtf"])
    return {"bit_equal_files": len(paths),
            "order": "native, plain, plain, native",
            **{f"{name}_rtf": v for name, v in rtf.items()}}


# ---------------------------------------------------------------------------
# slice 4: the fused transcode (archived residual-stack and RVQ kernels)
# ---------------------------------------------------------------------------

def symad_stacks(params, device):
    """The eight residual stacks of the symAD transcode, in path order:
    (name, unit weights f32, (C, T) at B=16 x 10 s)."""
    stacks = []
    for where, blocks in (("encoder", range(4)), ("decoder", range(4))):
        for i in blocks:
            bp = params[where]["blocks"][i]
            j = i if where == "encoder" else 3 - i
            stacks.append((f"{where} block {i}",
                           tuple((u["conv1"]["w"].to(device),
                                  u["conv2"]["w"].to(device))
                                 for u in bp["res"]),
                           kernel_bounds.SYMAD_STACKS[j]))
    return stacks


def check_resunit(x, units, dilations=DILATIONS):
    """The archived stack's kernel against its plain version, true f32, at
    the units' conv width; returns (max abs error, the same relative to the
    peak, whether the two are bit-equal)."""
    out = resunit_kernel.fused_residual_stack_bct(
        x, units, dilations=dilations, kernel_size=units[0][0].shape[-1])
    ref = resunit_kernel.fused_residual_stack_plain(x, units, dilations)
    err, rel = check_close(out, ref, x, bf16_dots=False)
    return err, rel, bool(torch.equal(out, ref))


def phase_resunit_kernel_vs_plain(params, device):
    """csrc/resunit_stack.cu against its plain version in f32: random units
    at C = 1, 4, 8, 32, 33, 64, 128, 200 and 256 with ragged T (1999, and
    50, shorter than a dilation-9 span); k = 1, 3, 5 and 11 at C = 33 and
    200; one unit and four at C = 1, 33 and 200; and the trained golden's
    eight stacks at their full lengths (B=2).  Each launch is one unit, so
    a call makes one CUDA launch per unit."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    shapes = [(c, t, 7, DILATIONS) for c in (1, 4, 8, 32, 33, 64, 128, 200,
                                              256) for t in (1999, 50)]
    shapes += [(c, 1999, k, DILATIONS) for k in (1, 3, 5, 11)
               for c in (33, 200)]
    shapes += [(c, t, 7, dil) for dil in ((3,), (1, 3, 9, 27))
               for c in (1, 33, 200) for t in (1999, 50)]
    cases = []
    for c, t, k, dil in shapes:
        units = shape_units(c, "elu", k, 1, False, dil, device,
                            torch.float32, gen)[0]
        x = torch.randn(2, c, t, generator=gen, device=device)
        before = resunit_kernel.launches
        cuda = folded_stack.cuda_launches("resunit_stack")
        err, rel, equal = check_resunit(x, units, dil)
        if (resunit_kernel.launches != before + 1
                or folded_stack.cuda_launches("resunit_stack")
                != cuda + len(dil)):
            raise AssertionError(f"csrc/resunit_stack.cu: not one call of "
                                 f"one CUDA launch per unit ({len(dil)})")
        cases.append({"C": c, "T": t, "k": k, "dilations": list(dil),
                      "weights": "random", "max_abs_err": err,
                      "max_rel_err": rel, "bit_equal": equal})
    for name, units, (c, t) in symad_stacks(params, device):
        x = torch.randn(2, c, t, generator=gen, device=device)
        err, rel, equal = check_resunit(x, units)
        cases.append({"C": c, "T": t, "k": 7, "dilations": list(DILATIONS),
                      "weights": name, "max_abs_err": err,
                      "max_rel_err": rel, "bit_equal": equal})
    emit("resunit_kernel_vs_plain", t0,
         tolerance=f"rtol {F32_RTOL}, atol {F32_ATOL_REL} x peak",
         bit_equal=f"{sum(c['bit_equal'] for c in cases)} of {len(cases)}",
         cases=cases)


def rvq_residuals(z, embed, idx):
    """The residual entering each layer under the indices `idx`, with the
    plain update: (N, D), (Q, NE, D), (N, Q) -> (Q, N, D)."""
    r = z
    out = []
    for q in range(embed.shape[0]):
        out.append(r)
        r = r - embed[q][idx[:, q].long()]
    return torch.stack(out)


def check_rvq(z, embed):
    """csrc/rvq_encode.cu against its plain version on (B, T, D) frames.
    Each frame whose indices differ is counted once, at its first differing
    layer, where both saw the same residual r; the two codes' distances to
    r, recomputed in f64, must be within RVQ_TIE_REL * (|r|^2 + |E|^2).
    zq must be bit-equal on every frame whose indices all agree.  Returns
    (frames with a flip, the largest flip's gap in units of its bound, the
    max abs difference of zq over all frames)."""
    zq, idx = vq_kernel.rvq_encode_pallas(z, embed)
    zq_p, idx_p = vq_kernel.rvq_encode_plain(z, embed)
    torch.cuda.synchronize()
    d, num_q = z.shape[-1], embed.shape[0]
    idx, idx_p = idx.reshape(-1, num_q), idx_p.reshape(-1, num_q)
    if int(idx.min()) < 0 or int(idx.max()) >= embed.shape[1]:
        raise AssertionError("rvq kernel: index out of range")
    agree = (idx == idx_p).all(dim=1)
    err = float((zq - zq_p).abs().max()) if zq.numel() else 0.0
    if not torch.equal(zq.reshape(-1, d)[agree], zq_p.reshape(-1, d)[agree]):
        raise AssertionError("rvq kernel: zq differs on frames whose "
                             "indices agree")
    frames = (~agree).nonzero().flatten()
    if not len(frames):
        return 0, 0.0, err
    first = (idx[frames] != idx_p[frames]).int().argmax(dim=1)
    r = rvq_residuals(z.reshape(-1, d), embed.float(), idx_p)[first, frames]
    e_k = embed[first, idx[frames, first].long()].double()
    e_p = embed[first, idx_p[frames, first].long()].double()
    r = r.double()
    gap = ((r - e_k).square().sum(1) - (r - e_p).square().sum(1)).abs()
    scale = r.square().sum(1) + torch.maximum(e_k.square().sum(1),
                                              e_p.square().sum(1))
    worst = float((gap / (RVQ_TIE_REL * scale)).max())
    if worst > 1.0:
        raise AssertionError(f"rvq kernel: an index flip is no near tie "
                             f"({worst:.3g} x the bound)")
    return len(frames), worst, err


def main_input(device):
    """main_path's seeded input, (16, 480000, 1) at 0.3."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    return 0.3 * torch.randn(BATCH, SECONDS * SR, 1, generator=gen,
                             device=device)


def on_device(params, device):
    return tree_map(lambda a: a.to(device, torch.float32), params)


def phase_rvq_kernel_vs_plain(params, device):
    """csrc/rvq_encode.cu against its plain version: seeded random
    codebooks and z at RVQ_SHAPES (tests/test_pallas_vq.py's shapes, and
    slice 13's wider, ragged and smaller ones), at a frame count one past
    whole tiles, at a duplicated-row codebook, and the trained golden's
    codebooks on the true-f32 encoder's z of main_path's input
    (16, 1600, 64)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    cases = []

    def case(embed, z, codebooks):
        q, n, d = embed.shape
        flips, worst, err = check_rvq(z, embed)
        frames = z.shape[0] * z.shape[1]
        cases.append({"Q": q, "N": n, "D": d, "frames": frames,
                      "codebooks": codebooks, "flipped_frames": flips,
                      "worst_flip_vs_bound": worst, "zq_max_abs_err": err,
                      "tile": vq_kernel.rvq_geometry(frames, d, q,
                                                     n).frames})

    # slice 13: frames one past whole tiles of the geometry's own choice
    past = next(f for f in range(RVQ_PAST_FROM, 2 * RVQ_PAST_FROM)
                if f % vq_kernel.rvq_geometry(f, 64, 8, 1024).frames == 1)
    for (q, n, d), bt in RVQ_SHAPES + (((8, 1024, 64), (1, past)),):
        embed = torch.randn(q, n, d, generator=gen, device=device)
        z = torch.randn(*bt, d, generator=gen, device=device)
        case(embed, z, "random")
    # slice 13: every code of the upper half repeats one of the lower half,
    # so every minimum is an exact tie and the lower index must win, as
    # the plain version's argmin takes it
    (q, n, d), bt = RVQ_DUPLICATED
    low = torch.randn(q, n // 2, d, generator=gen, device=device)
    perm = torch.randperm(n // 2, generator=gen, device=device)
    embed = torch.cat([low, low[:, perm]], dim=1)
    z = torch.randn(*bt, d, generator=gen, device=device)
    case(embed, z, "duplicated rows")
    _, idx = vq_kernel.rvq_encode_pallas(z, embed)
    if int(idx.max()) >= n // 2:
        raise AssertionError("rvq kernel: an exact tie took the higher "
                             "index")
    cfg = GeneratorConfig()
    p = on_device(params, device)
    h = encoder_apply(p["encoder"], main_input(device), cfg)
    z = projector_apply(p["projector"], h, cfg).contiguous()
    case(p["quantizer"]["embed"], z, "gen_symad_trained")
    emit("rvq_kernel_vs_plain", t0,
         tolerance=f"flips only at near ties (f64 gap <= {RVQ_TIE_REL} x "
                   f"(|r|^2 + |E|^2)), zq bit-equal on agreeing frames; "
                   f"duplicated rows: every index in the lower half",
         cases=cases)
    return z


def phase_fused_golden(device):
    """bin/fused_probe.py's fused_path on the card in f32 against the
    goldens: idx_stream with 0 flips, y within rtol 1e-3, atol 1e-4."""
    t0 = time.perf_counter()
    cfg = GeneratorConfig()
    flat = np.arange(cfg.codebook_num)[:, None] * cfg.codebook_size
    results = {}
    for name in ("gen_symad", "gen_symad_trained"):
        data, params = load_golden(name)
        x = torch.from_numpy(data["x"].transpose(0, 2, 1).copy()).to(device)
        reset_launches()
        idx, y = fused_probe.fused_path(on_device(params, device), x, cfg)
        torch.cuda.synchronize()
        launches = read_launches()
        flips = int((idx[0].cpu().numpy().T + flat
                     != data["idx_stream"]).sum())
        if flips:
            raise AssertionError(f"{name}: {flips} index flips on the fused "
                                 f"path")
        y = y.cpu().numpy().transpose(0, 2, 1)
        np.testing.assert_allclose(y, data["y"], rtol=1e-3, atol=1e-4)
        if launches["resunit"] != 8 or launches["rvq"] != 1:
            raise AssertionError(f"{name}: kernel launches {launches}")
        results[name] = {"index_flips": 0,
                         "frames": int(data["idx_stream"].shape[1]),
                         "max_abs_err": float(np.abs(y - data["y"]).max()),
                         "launches": launches}
    emit("fused_golden", t0, goldens=results)


def resunit_timing(params, device, gen):
    """Per stack of the fused transcode: csrc/resunit_stack.cu's, the plain
    version's and the F.elu / F.conv1d chain's ms at (16, C, T) f32 with
    the trained golden's weights, and the bound."""
    rows = []
    for name, units, (c, t) in symad_stacks(params, device):
        x = torch.randn(BATCH, c, t, generator=gen, device=device)
        err, _, equal = check_resunit(x, units)
        row = {
            "stack": name, "shape": [BATCH, c, t], "dtype": "float32",
            "max_abs_err": err, "bit_equal": equal,
            "ms": cuda_ms(lambda: resunit_kernel.fused_residual_stack_bct(
                x, units, dilations=DILATIONS), reps=3),
            "plain_ms": cuda_ms(
                lambda: resunit_kernel.fused_residual_stack_plain(
                    x, units, DILATIONS), reps=2),
            "chain_ms": cuda_ms(lambda: chain(x, units), reps=2),
            "cuda_launches_per_call": cuda_launches_per_call(
                lambda: resunit_kernel.fused_residual_stack_bct(
                    x, units, dilations=DILATIONS), "resunit_stack",
                len(units)),
        }
        b, c, t = x.shape
        row.update(kernel_bounds.resunit_stack(b, t, c))
        rows.append(row)
    return rows


def rvq_timing(z, embed):
    """csrc/rvq_encode.cu's, the plain version's and ops/vq.py
    rvq_forward_index's (cuBLAS, TF32 off) ms on (16, 1600, 64) frames, the
    bound, and rvq_geometry's tile, blocks and residency."""
    flips, _, err = check_rvq(z, embed)
    geometry = vq_kernel.rvq_geometry(z.shape[0] * z.shape[1], z.shape[2],
                                      embed.shape[0], embed.shape[1])
    row = {
        "shape": list(z.shape), "codebooks": list(embed.shape),
        "max_abs_err": err, "flipped_frames": flips,
        "geometry": geometry._asdict(),
        "ms": cuda_ms(lambda: vq_kernel.rvq_encode_pallas(z, embed), reps=5),
        "plain_ms": cuda_ms(lambda: vq_kernel.rvq_encode_plain(z, embed),
                            reps=3),
        "chain_ms": cuda_ms(lambda: rvq_forward_index(z, {"embed": embed}),
                            reps=3),
        "cuda_launches_per_call": 1,
    }
    row.update(kernel_bounds.rvq_encode(z.shape[0] * z.shape[1],
                                        d=z.shape[2], q=embed.shape[0],
                                        codes=embed.shape[1]))
    return row


def phase_fused_path(device, params, x, z_main):
    """The slice at full width: bin/fused_probe.py's fused_path on the
    trained golden's weights (f32) with main_path's input, B=16 x 10 s:
    every stack in csrc/resunit_stack.cu, the RVQ in csrc/rvq_encode.cu;
    beside it the true-f32 plain_path on the same input."""
    t0 = time.perf_counter()
    cfg = GeneratorConfig()
    p = on_device(params, device)

    def fused(x):
        return fused_probe.fused_path(p, x, cfg)

    def plain(x):
        return fused_probe.plain_path(p, x, cfg)

    def encode(x):
        h = fast_experiments.encoder_apply_fused(p["encoder"], x, cfg)
        z = projector_apply(p["projector"], h, cfg)
        return vq_kernel.rvq_encode_pallas(z, p["quantizer"]["embed"])

    reset_launches()
    cuda = folded_stack.cuda_launches("resunit_stack")
    idx, y = fused(x)
    torch.cuda.synchronize()
    launches = read_launches()
    units = sum(len(bp["res"]) for where in ("encoder", "decoder")
                for bp in p[where]["blocks"])
    cuda = folded_stack.cuda_launches("resunit_stack") - cuda
    if launches != launch_counts(resunit=8, rvq=1) or cuda != units:
        raise AssertionError(f"kernel launches {launches} and {cuda} CUDA "
                             f"launches of csrc/resunit_stack.cu, expected "
                             f"8 resunit_stack ({units} CUDA launches, one "
                             f"per unit) and 1 rvq_encode")
    check_transcode(idx, y, x, cfg)
    idx_p, y_p = plain(x)
    flips = int((idx != idx_p).sum())
    if flips > FUSED_FLIP_SHARE * idx.numel():
        raise AssertionError(f"{flips} index flips against the plain f32 "
                             f"path (bound {FUSED_FLIP_SHARE} of "
                             f"{idx.numel()})")
    # the plain path's indices through both decoders
    zq = rvq_lookup(idx_p, p["quantizer"])
    y_f = fast_experiments.decoder_apply_fused(p["decoder"], zq, cfg)
    dec_rel = float((y_f - y_p).abs().max() / y_p.abs().max())
    if not dec_rel <= FUSED_DECODE_REL:
        raise AssertionError(f"fused decoder off the plain one by "
                             f"{dec_rel:.3g} of the peak")

    zq_k, _ = encode(x)
    torch.cuda.reset_peak_memory_stats()
    transcode_ms = cuda_ms(lambda: fused(x), reps=3)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    times = {
        "transcode_ms": transcode_ms,
        "encode_ms": cuda_ms(lambda: encode(x), reps=3),
        "decode_ms": cuda_ms(lambda: fast_experiments.decoder_apply_fused(
            p["decoder"], zq_k, cfg), reps=3),
        "rtf": BATCH * SECONDS / (transcode_ms / 1e3),
        "peak_memory_gib": peak_gib,
        "plain_transcode_ms": cuda_ms(lambda: plain(x), reps=2),
    }
    times["plain_rtf"] = BATCH * SECONDS / (times["plain_transcode_ms"] / 1e3)
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    rows = resunit_timing(params, device, gen)
    rvq_row = rvq_timing(z_main, p["quantizer"]["embed"])
    emit("fused_path", t0, batch=BATCH, seconds_of_audio=BATCH * SECONDS,
         **times, launches=launches, resunit_cuda_launches=cuda,
         index_flips_vs_plain=flips,
         indices=idx.numel(), fused_vs_plain_decode_rel_err=dec_rel,
         resunit_stack=rows, rvq_encode=rvq_row)
    return launches, rows, [rvq_row], fused


# ---------------------------------------------------------------------------
# slice 5: the tensor-core probes (dot chain and ablation stack)
# ---------------------------------------------------------------------------

def dot_bf16_bar(n_dots: int, independent: bool) -> float:
    """The bf16 chain's bar on relative L2 against its plain version: one
    bf16 ulp is 3.9e-3 relative, and a chained step's one-ulp flips are
    carried into the next product, so the bar grows with the chain."""
    return DOT_BF16_RL2 if independent else DOT_BF16_RL2_PER_DOT * n_dots


def check_dot_chain(x, w, independent: bool) -> dict:
    """csrc/dot_chain.cu against its plain version on the same inputs:
    int8 bit-equal, f32 within DOT_F32_REL of the peak, bf16 within
    dot_bf16_bar in relative L2."""
    out = dot_chain.dot_chain(x, w, independent)
    ref = dot_chain.dot_chain_plain(x, w, independent)
    torch.cuda.synchronize()
    o, r = out.float(), ref.float()
    if out.dtype != x.dtype or out.shape != x.shape:
        raise AssertionError(f"dot chain gave {out.dtype} {tuple(out.shape)}")
    if not torch.isfinite(o).all():
        raise AssertionError("dot chain output is not finite")
    err, peak = float((o - r).abs().max()), float(r.abs().max())
    rl2 = float((o - r).norm() / r.norm())
    what = f"{x.dtype} {'independent' if independent else 'chained'}"
    if x.dtype == torch.int8:
        if not torch.equal(out, ref):
            raise AssertionError(f"{what}: int8 chain not bit-equal")
    elif x.dtype == torch.float32:
        if not err <= DOT_F32_REL * peak:
            raise AssertionError(f"{what}: error {err / peak:.3g} of the "
                                 f"peak (bar {DOT_F32_REL})")
    elif not rl2 <= dot_bf16_bar(w.shape[0], independent):
        raise AssertionError(f"{what}: relative L2 {rl2:.3g} (bar "
                             f"{dot_bf16_bar(w.shape[0], independent)})")
    return {"max_abs_err": err, "max_rel_err": err / peak, "rel_l2": rl2}


def dot_inputs(rng, dtype, m: int, n_dots: int, device):
    """The probe's inputs; for int8, row 0 of x and column 0 of w[0] set to
    79, so the chained step's d // 4096 = 128 * 79^2 // 4096 = 195 wraps."""
    x, w = mxu_rate_probe.probe_inputs(rng, dtype, m, n_dots, device)
    if dtype == torch.int8:
        x[0], w[0, :, 0] = 79, 79
        q = int((x[0].long() * w[0, :, 0].long()).sum() // dot_chain.INT8_SHIFT)
        if q != 195:
            raise AssertionError(f"wrap row gives {q}")
    return x, w


def phase_dot_chain_vs_plain(device):
    """csrc/dot_chain.cu against its plain version in the 6 dtype x mode
    cases, at (64 rows, 4 dots, 3 tiles), at DOT_RAGGED and at the probe's
    full (1024, 64, 120) on its own inputs (the int8 wrap row added)."""
    t0 = time.perf_counter()
    cases, rows = [], []
    for (rows_, dots, tiles), seed in (((64, 4, 3), SEED + 7),
                                       (DOT_RAGGED, SEED + 13),
                                       (DOT_FULL, SEED)):
        rng = np.random.default_rng(seed)
        m = rows_ * tiles
        for dtype_s, dtype, peak in mxu_rate_probe.DTYPES:
            x, w = dot_inputs(rng, dtype, m, dots, device)
            for mode, independent in mxu_rate_probe.MODES:
                res = check_dot_chain(x, w, independent)
                case = {"dtype": dtype_s, "mode": mode, "rows": rows_,
                        "dots": dots, "tiles": tiles, **res}
                cases.append(case)
                if (rows_, dots, tiles) == DOT_FULL:
                    case["plain_ms"] = cuda_ms(
                        lambda: dot_chain.dot_chain_plain(x, w, independent),
                        reps=2)
                    rows.append({**case, "shape": [m, 128, dots],
                                 **kernel_bounds.dot_chain(m, dots, peak)})
    emit("dot_chain_vs_plain", t0, tolerance={
        "int8": "bit-equal",
        "f32": f"max error <= {DOT_F32_REL} x peak",
        "bf16": f"relative L2 <= {DOT_BF16_RL2} (independent), "
                f"{DOT_BF16_RL2_PER_DOT} x dots (chained)"}, cases=cases)
    return rows


def phase_mxu_rate_path(rows):
    """bin/mxu_rate_probe.py's main at its defaults: each (dtype, mode)
    runs the kernel and the torch chain once to warm up and ITERS times
    timed.  Fills `ms`, `library_ms` and TFLOP/s into the rows."""
    t0 = time.perf_counter()
    reset_launches()
    records = mxu_rate_probe.main([])
    torch.cuda.synchronize()
    launches = read_launches()
    want = len(rows) * (1 + mxu_rate_probe.ITERS)
    if launches != launch_counts(dot_chain=want):
        raise AssertionError(f"kernel launches {launches}, expected {want} "
                             f"dot_chain")
    by_case = {(r["impl"], r["dtype"], r["mode"]): r for r in records}
    for row in rows:
        kern = by_case["kernel", row["dtype"], row["mode"]]
        row.update(ms=kern["ms"], tflops=kern["tflops"],
                   library_ms=by_case["torch", row["dtype"], row["mode"]]
                   ["ms"])
    emit("mxu_rate_path", t0, launches=launches, records=records)
    return launches, rows


def rel_l2(out, ref) -> float:
    out, ref = out.float(), ref.float()
    return float((out - ref).norm() / ref.norm())


def check_ablate(x, units, variant: str, floor: float = 0.0) -> dict:
    """csrc/ablate_stack.cu against its plain version on the same inputs, in
    either storage dtype: relative L2 <= ABLATE_RL2 and max error <=
    ABLATE_MAX_REL x peak (bf16 operand flips, see
    tests/test_torch_folded_ablate.py); at C > 32 the relative L2 bar is
    ABLATE_FLOOR_FACTOR x the plain version's distance from exact sums (or
    `floor`, its sibling's) where that is larger, and the kernel is held to
    the exact sums too."""
    out = ablate_stack.ablate_stack(x, units, DILATIONS, variant)
    ref = ablate_stack.ablate_stack_plain(x, units, DILATIONS, variant)
    torch.cuda.synchronize()
    if out.dtype != x.dtype or out.shape != x.shape:
        raise AssertionError(f"{variant}: kernel gave {out.dtype} "
                             f"{tuple(out.shape)} for {x.dtype} "
                             f"{tuple(x.shape)}")
    rec, bar = {}, ABLATE_RL2
    if x.shape[1] > ablate_stack.NARROW_CHANNELS:
        exact = ablate_stack.ablate_stack_plain(x, units, DILATIONS, variant,
                                                exact_sums=True)
        rec = {"plain_exact_rl2": rel_l2(ref, exact),
               "exact_rl2": rel_l2(out, exact)}
        bar = max(bar, ABLATE_FLOOR_FACTOR * max(rec["plain_exact_rl2"],
                                                 floor))
        rec["bar_rl2"] = bar
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{variant}: output not finite")
    if torch.equal(out, x.float()):
        raise AssertionError(f"{variant}: kernel returned its input")
    err, peak = float((out - ref).abs().max()), float(ref.abs().max())
    rl2 = rel_l2(out, ref)
    if not (max(rl2, rec.get("exact_rl2", 0.0)) <= bar
            and err <= ABLATE_MAX_REL * peak):
        raise AssertionError(f"{variant} at {tuple(x.shape)} {x.dtype}: "
                             f"relative L2 {rl2:.3g} (bar {bar:.3g}; "
                             f"{rec}), max {err / peak:.3g} of the peak")
    return {"max_abs_err": err, "max_rel_err": err / peak, "rel_l2": rl2,
            **rec}


def ablate_inputs(c: int, t: int, dtype, device, b: int = BATCH):
    """Seeded units and x at (b, c, t) in the tool's recipe (weights
    0.1 * N(0, 1), x 0.3 * N(0, 1)), x in the storage dtype."""
    gen = torch.Generator(device=device).manual_seed(SEED + c)
    units = tuple((0.1 * torch.randn(c, c, 7, generator=gen, device=device),
                   0.1 * torch.randn(c, c, 1, generator=gen, device=device))
                  for _ in DILATIONS)
    x = 0.3 * torch.randn(b, c, t, generator=gen, device=device)
    return units, x.to(dtype)


def ablate_chain_ms(x, units) -> float:
    """The same units as F.elu / F.conv1d calls in x's dtype."""
    units = tuple((w1.to(x.dtype), w2.to(x.dtype)) for w1, w2 in units)
    return cuda_ms(lambda: chain(x, units), reps=3)


def phase_ablate_kernel_vs_plain(device):
    """csrc/ablate_stack.cu against its plain version: the five variants
    at C = 32 and 16 (f = 4 and 8) with B = 2, T = 4000 (13 of the narrow
    kernel's 320-sample tiles, the last one ragged) and B = 1, T = 64
    (shorter than the halo); at C = 33, 48, 64, 96, 128, 256, 264 and 1312
    (the wide route, f = 3, 2, 2, 1, 1, 1, 1, 1) with B = 2, T = 3996 (a
    multiple of every fold, ragged in every tile; the epilogue's 4-sample
    accesses) and T = 66 (shorter than the halo, and not a multiple of 4:
    the epilogue's single samples), which takes its T = 3996 sibling's
    floor (check_ablate); all of them in f32 and in bf16 storage.  At full size: the five variants at
    (16, 32, 480000) f32 on bin/folded_ablate.py's inputs, and the default
    variant at ABLATE_TIMED's shapes, each with its plain version's and
    the chain's ms.  Returns the `kernels` line's rows, their `ms` still
    to be timed by phase_ablate_path."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    cases, rows = [], []
    shapes = ([(c, b, t) for c in (32, 16) for b, t in ((2, 4000), (1, 64))]
              + [(c, 2, t) for c in ABLATE_WIDE for t in (3996, 66)])
    floors = {}  # (C, storage, variant): the plain version's distance
    # from exact sums at T = 3996
    for c, b, t in shapes:
        units = tuple((0.1 * torch.randn(c, c, 7, generator=gen,
                                         device=device),
                       0.1 * torch.randn(c, c, 1, generator=gen,
                                         device=device)) for _ in DILATIONS)
        x = 0.3 * torch.randn(b, c, t, generator=gen, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            for v in ablate_stack.VARIANTS:
                key = (c, dtype, v)
                case = {"variant": v, "shape": [b, c, t],
                        "storage": str(dtype)[6:],
                        **check_ablate(x.to(dtype), units, v,
                                       floors.get(key, 0.0))}
                floors.setdefault(key, case.get("plain_exact_rl2", 0.0))
                cases.append(case)
    b, c, t = BATCH, 32, SECONDS * SR
    units, x = folded_ablate.probe_inputs(b, t, c, device)
    chain_ms = ablate_chain_ms(x, units)
    for v in ablate_stack.VARIANTS:
        case = {"variant": v, "shape": [b, c, t], "storage": "float32",
                **check_ablate(x, units, v)}
        cases.append(case)
        case["plain_ms"] = cuda_ms(lambda: ablate_stack.ablate_stack_plain(
            x, units, DILATIONS, v), reps=1)
        rows.append({**case, "chain_ms": chain_ms,
                     **kernel_bounds.ablate_stack(b, t, c)})
    del x
    for c, t, dtype in ABLATE_TIMED:
        units, x = ablate_inputs(c, t, dtype, device)
        case = {"variant": "default", "shape": [BATCH, c, t],
                "storage": str(dtype)[6:],
                **check_ablate(x, units, "default",
                               floors.get((c, dtype, "default"), 0.0))}
        cases.append(case)
        case["plain_ms"] = cuda_ms(lambda: ablate_stack.ablate_stack_plain(
            x, units, DILATIONS), reps=1)
        rows.append({**case, "chain_ms": ablate_chain_ms(x, units),
                     **kernel_bounds.ablate_stack(BATCH, t, c,
                                                  x.element_size())})
        del x
    emit("ablate_kernel_vs_plain", t0, tolerance=(
        f"relative L2 <= {ABLATE_RL2} (C > 32: or {ABLATE_FLOOR_FACTOR} x "
        f"plain_exact_rl2, also for exact_rl2), max error <= "
        f"{ABLATE_MAX_REL} x peak"), cases=cases)
    return rows


def phase_ablate_path(rows, device):
    """bin/folded_ablate.py's main at (16, 32, 480000): the five variants,
    one F.elu pass and the autoencoder-mode kernel with bf16 dots, each
    once to warm up and ITERS times timed; then the default variant at
    ABLATE_TIMED's shapes, once to warm up and ITERS times timed.  After
    the launch counts are read, the wide shapes are timed once more
    through csrc/wide_stack_mma.cu (the folded stack's autoencoder mode
    with bf16 dots, the same units and storage), the yardstick of the
    ablation stack's wide route."""
    t0 = time.perf_counter()
    probe = [r for r in rows if r["shape"][1] == folded_ablate.CHANNELS
             and r["storage"] == "float32"]
    reset_launches()
    records = folded_ablate.main([])
    for c, t, dtype in ABLATE_TIMED:
        units, x = ablate_inputs(c, t, dtype, device)
        row = next(r for r in rows if r["shape"] == [BATCH, c, t]
                   and r["storage"] == str(dtype)[6:])
        row["ms"] = cuda_ms(lambda: ablate_stack.ablate_stack(
            x, units, DILATIONS), reps=folded_ablate.ITERS)
        del x
    torch.cuda.synchronize()
    launches = read_launches()
    calls = 1 + folded_ablate.ITERS
    want = launch_counts(mma=calls,
                         ablate=(len(probe) + len(ABLATE_TIMED)) * calls)
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    by_name = {r["ablate"]: r for r in records}
    for row in probe:
        row["ms"] = by_name[row["variant"]]["ms"]
    default = {}
    for c, t, dtype in ABLATE_TIMED:
        row = next(r for r in rows if r["shape"] == [BATCH, c, t]
                   and r["storage"] == str(dtype)[6:])
        rec = default[f"{row['shape']} {row['storage']}"] = {
            "ms": row["ms"], "bound_ms": row["bound_ms"]}
        if c > ablate_stack.NARROW_CHANNELS:
            units, x = ablate_inputs(c, t, dtype, device)
            rec["wide_stack_ms"] = cuda_ms(
                lambda: folded_stack.folded_residual_stack(
                    x, units, dilations=DILATIONS, bf16_dots=True),
                reps=folded_ablate.ITERS)
            rec["ratio"] = row["ms"] / rec["wide_stack_ms"]
            del x
    emit("ablate_path", t0, launches=launches, records=records,
         default_variant=default,
         timed_calls_ms=sum(r["ms"] for r in rows))
    return launches, rows


# ---------------------------------------------------------------------------
# slice 6: the folded-stack probe (tile scales, every width and fold)
# ---------------------------------------------------------------------------

def probe_launches(shapes) -> dict:
    """The wrapper calls bin/folded_probe.py's main makes with --int8: per
    (C, T, fold) and mode one call for the error, one warm-up and LOOPS x
    ITERS timed; the autoencoder mode at C <= 32 in
    csrc/folded_stack_mma.cu, above in csrc/resunit_stack.cu."""
    calls = 2 + folded_probe.LOOPS * folded_probe.ITERS
    cases = [(c, f) for c, t in shapes for f in folded_probe.folds(c, t)]
    narrow = sum(c <= folded_stack.MMA_CHANNELS[-1] for c, _ in cases)
    return launch_counts(mma=calls * narrow,
                         wide=calls * (len(cases) - narrow),
                         int8=calls * len(cases),
                         int8_tile=calls * len(cases))


def phase_folded_probe_path():
    """bin/folded_probe.py's main with --int8, in float32 and in bfloat16,
    at full size: every (C, T, fold) of the tool's grid, the chain and the
    three modes timed.  Checks the launch counts of each run and that every
    error is finite; returns the two runs' counts summed and the records."""
    t0 = time.perf_counter()
    want = probe_launches(folded_probe.SHAPES)
    total = dict.fromkeys(want, 0)
    records = []
    for dtype in folded_probe.DTYPES:
        reset_launches()
        recs = folded_probe.main(["--int8", "--dtype", dtype])
        torch.cuda.synchronize()
        launches = read_launches()
        if launches != want:
            raise AssertionError(f"--dtype {dtype}: kernel launches "
                                 f"{launches}, expected {want}")
        errs = [r[k] for r in recs
                for k in ("rel_max_err", "int8_rel_err", "int8t_rel_err")]
        if not all(np.isfinite(errs)):
            raise AssertionError(f"--dtype {dtype}: an error is not finite")
        for k, n in launches.items():
            total[k] += n
        records += recs
    emit("folded_probe_path", t0, launches=total, records=records)
    return total, records


def device_ms_by_kernel(fn) -> dict:
    """One call of fn under torch.profiler: device ms summed by kernel
    name (copies included), largest first.  The call is traced after a
    traced warm-up call: the tracer misses the first launches of a window
    it has just started (a tile call's first four of nine, on the card)."""
    traced = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.extend(
                     e for e in p.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
                 ) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    traced.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {e.key[:80]: e.self_device_time_total / 1e3 for e in traced}


def probe_kernel_rows(records, device):
    """The tile mode's and the wide routes' rows of the `kernels` line at
    the probe's shapes, default fold: the kernel's and the chain's ms from
    the probe's records, the plain version timed once, its error against
    the kernel at full size, the bound, for the tile mode one call's
    device time by kernel, and for the wide routes the CUDA launches of one
    call (asserted, one per unit).  The tile mode in f32; the wide
    tensor-core route (csrc/wide_stack_mma.cu) in f32 and bf16 storage;
    the same units in true f32 through csrc/resunit_stack.cu, timed here.
    Beside them, not in the `kernels` line, the row mode at the probe's
    other folds the same way."""
    tile_rows, wide_rows, fold_rows, f32_rows = [], [], [], []
    by_shape = {(r["C"], r["fold"]): r for r in records
                if r["dtype"] == "float32"}
    for c, t in folded_probe.SHAPES:
        rec = by_shape[c, folded_stack.int8_fold(c)]
        units, x = folded_probe.probe_inputs(c, t, BATCH, torch.float32,
                                             device)
        for f in folded_probe.folds(c, t):
            if f == rec["fold"]:
                continue
            err, rel, _ = check_int8(x, units, f)
            row = {"shape": [BATCH, c, t], "dtype": "float32", "fold": f,
                   "max_abs_err": err, "max_rel_err": rel,
                   "ms": by_shape[c, f]["int8_ms"],
                   "chain_ms": rec["chain_ms"],
                   "plain_ms": cuda_ms(
                       lambda: folded_stack.folded_residual_stack_int8_plain(
                           x, units, DILATIONS, f), reps=1)}
            row.update(kernel_bounds.int8_stack(BATCH, t, c))
            fold_rows.append(row)
        row = {"shape": [BATCH, c, t], "dtype": "float32",
               "fold": rec["fold"], "tile_rows": rec["tile_rows"],
               **check_int8_tile(x, units, rec["fold"], rec["tile_rows"]),
               "ms": rec["int8t_ms"], "chain_ms": rec["chain_ms"],
               "plain_ms": cuda_ms(
                   lambda: folded_stack.folded_residual_stack_int8_tile_plain(
                       x, units, DILATIONS, rec["fold"], rec["tile_rows"]),
                   reps=1),
               "row_mode_ms": rec["int8_ms"],
               "cuda_launches_per_call": 2 * len(units) + 1,
               "device_ms_by_kernel": device_ms_by_kernel(
                   lambda: folded_stack.folded_residual_stack(
                       x, units, dilations=DILATIONS, int8_dots=True,
                       int8_scale="tile", fold=rec["fold"],
                       tile_rows=rec["tile_rows"]))}
        row.update(kernel_bounds.int8_stack(BATCH, t, c))
        tile_rows.append(row)
        if c <= folded_stack.MMA_CHANNELS[-1]:
            continue
        for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
            name = str(dtype)[6:]
            rec_d = next(r for r in records if r["dtype"] == name
                         and r["C"] == c and r["fold"] == rec["fold"])
            xd = x.to(dtype)
            ud = tuple((a.to(dtype), b.to(dtype)) for a, b in units)
            row = {"shape": [BATCH, c, t], "dtype": name, "bf16_dots": True,
                   **check_wide(xd, ud), "ms": rec_d["folded_ms"],
                   "chain_ms": rec_d["chain_ms"],
                   "plain_ms": cuda_ms(
                       lambda: folded_stack.folded_residual_stack_plain(
                           xd, ud, DILATIONS, True), reps=1),
                   "cuda_launches_per_call": cuda_launches_per_call(
                       lambda: folded_stack.folded_residual_stack(
                           xd, ud, dilations=DILATIONS), "wide_stack_mma",
                       len(units))}
            row.update(kernel_bounds.mma_stack(BATCH, t, c, storage=size))
            wide_rows.append(row)
        del xd
        row = {"shape": [BATCH, c, t], "dtype": "float32", "bf16_dots": False,
               **check_wide(x, units, bf16_dots=False),
               "ms": cuda_ms(lambda: folded_stack.folded_residual_stack(
                   x, units, dilations=DILATIONS, bf16_dots=False), reps=3),
               "chain_ms": rec["chain_ms"],
               "plain_ms": cuda_ms(
                   lambda: folded_stack.folded_residual_stack_plain(
                       x, units, DILATIONS, False), reps=1),
               "cuda_launches_per_call": cuda_launches_per_call(
                   lambda: folded_stack.folded_residual_stack(
                       x, units, dilations=DILATIONS, bf16_dots=False),
                   "resunit_stack", len(units))}
        row.update(kernel_bounds.resunit_stack(BATCH, t, c))
        f32_rows.append(row)
    return tile_rows, wide_rows, fold_rows, f32_rows


def cuda_launches_per_call(fn, source: str, want: int) -> int:
    """The CUDA launches one call of fn makes in the library of `source`
    (folded_stack.cuda_launches, counted by the library), which must be
    `want` (one per unit)."""
    before = folded_stack.cuda_launches(source)
    fn()
    torch.cuda.synchronize()
    n = folded_stack.cuda_launches(source) - before
    if n != want:
        raise AssertionError(f"{source}: {n} CUDA launches in one call, "
                             f"expected {want}")
    return n


def is_kernel(e) -> bool:
    """A device event of the profiler that is work, not a user annotation
    (the optimizer's step range is one)."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def device_busy_ms(prof) -> float:
    """The union of the traced kernels' intervals, in ms: the device's busy
    time even where kernels overlap (a library's side streams)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if is_kernel(e))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def phase_profile(path: str, tc, x):
    """One more transcode of a path (or a call of any fn(x)) under
    torch.profiler: its wall time, the device time summed over all kernels,
    the device's busy time (the union of the kernels' intervals) and idle
    share, the kernels with the most device time, the CUDA kernel count
    and the launch counts of the traced call (its wrapper calls by kernel,
    which name the CUDA kernels of `top`)."""
    t0 = time.perf_counter()
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        tc(x)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t1)
    launches = {k: n for k, n in read_launches().items() if n}
    kernels = [e for e in prof.key_averages() if is_kernel(e)]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    t2 = time.perf_counter()
    busy_ms = device_busy_ms(prof)
    walk_ms = 1e3 * (time.perf_counter() - t2)
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    emit("profile", t0, path=path, wall_ms=wall_ms, device_ms=device_ms,
         idle_share=1.0 - busy_ms / wall_ms, busy_ms=busy_ms,
         busy_walk_ms=walk_ms,
         launches=launches, cuda_kernels=sum(e.count for e in kernels),
         top=[{"name": e.key[:120], "calls": e.count,
               "device_ms": e.self_device_time_total / 1e3}
              for e in kernels[:PROFILE_TOP]])


# ---------------------------------------------------------------------------
# slice 14: streaming, demo_file and the batch autoencoder's variants
# ---------------------------------------------------------------------------

def no_kernel_launches(phase: str):
    """Streaming and the variants' plain path run no kernel of the port,
    as JAX's streaming path and plain path run no pallas_call."""
    launches = read_launches()
    if launches != launch_counts():
        raise AssertionError(f"{phase}: kernel launches {launches}, "
                             f"expected none")
    return launches


def percentiles(ms: list) -> dict:
    a = np.asarray(ms)
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)),
            "mean": float(a.mean())}


def stream_hops(codec, x, hop: int, chunk: int = 1, decode_only=None):
    """Stream x (B, n * hop, 1) through `codec`, `chunk` hops per encode
    and per decode call (or decode the indices `decode_only`), timing each
    call with CUDA events.  -> (indices, waveform, encode ms per call,
    decode ms per call, wall seconds)."""
    n = (x.shape[1] if decode_only is None
         else decode_only.shape[1] * hop) // (hop * chunk)
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
             for _ in range(n)]
    idxs, ys = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, (e0, e1, e2) in enumerate(marks):
        e0.record()
        if decode_only is None:
            idx = codec.encode(x[:, i * chunk * hop:(i + 1) * chunk * hop])
        else:
            idx = decode_only[:, i * chunk:(i + 1) * chunk]
        e1.record()
        ys.append(codec.decode(idx))
        e2.record()
        idxs.append(idx)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (torch.cat(idxs, dim=1), torch.cat(ys, dim=1),
            [e0.elapsed_time(e1) for e0, e1, _ in marks],
            [e1.elapsed_time(e2) for _, e1, e2 in marks], wall)


def launches_per_call(fn, calls: int = 16) -> dict:
    """Device kernels and copies per call of fn, and the device time they
    take per call (summed over kernels and copies, one stream, so nothing
    overlaps), from torch.profiler over `calls` calls after one warm-up
    call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = copies = 0
    device_us = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        device_us += e.self_device_time_total
        if e.key.startswith(("Memcpy", "Memset")):
            copies += e.count
        else:
            kernels += e.count
    if kernels == 0 or device_us <= 0:
        raise AssertionError("the profiler saw no kernel")
    return {"kernels": kernels / calls, "copies": copies / calls,
            "device_ms": device_us / 1e3 / calls}


def flat_offsets(cfg: GeneratorConfig, device):
    return (torch.arange(cfg.codebook_num, device=device, dtype=torch.int32)
            * cfg.codebook_size)


def phase_stream_golden(device):
    """gen_symad_trained streamed on the card from the zero state, the
    whole signal in one call: z_stream and zq_stream within rtol 1e-4,
    atol 1e-4, idx_stream with 0 flips, y_stream within rtol 1e-3, atol
    1e-4; y_hops with one hop per StreamingCodec call (same bars); the
    vocoder goldens' y_stream and y_hops within rtol 1e-3, atol 1e-5."""
    t0 = time.perf_counter()
    cfg = GeneratorConfig()
    data, params = load_golden("gen_symad_trained")
    p = on_device(params, device)
    reset_launches()
    x = torch.from_numpy(data["x"]).to(device)          # (1, 1, T)
    state = codec_state_init(1, cfg, device=device)
    with torch.inference_mode():
        h, _ = encoder_stream_bct(p["encoder"], x, cfg, state["encoder"])
        z, _ = projector_stream_bct(p["projector"], h, cfg,
                                    state["projector"])
        _, idx = rvq_forward_index(z.transpose(1, 2), p["quantizer"],
                                   flatten=True)
        zq = rvq_lookup(idx, p["quantizer"], flattened=True)
        y, _ = decoder_stream_bct(p["decoder"], zq.transpose(1, 2), cfg,
                                  state["decoder"])
    flips = int((idx[0].cpu().numpy().T != data["idx_stream"]).sum())
    if flips:
        raise AssertionError(f"{flips} index flips against idx_stream")
    np.testing.assert_allclose(z.cpu().numpy(), data["z_stream"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(zq.cpu().numpy(), data["zq_stream"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y.cpu().numpy(), data["y_stream"], rtol=1e-3,
                               atol=1e-4)
    codec = StreamingCodec(params, cfg, device=device)
    hop = cfg.hop_length
    x_hops = x.transpose(1, 2)
    y_hops = torch.cat([codec.decode(codec.encode(
        x_hops[:, i * hop:(i + 1) * hop]))
        for i in range(int(data["n_hops"]))], dim=1)
    np.testing.assert_allclose(y_hops.cpu().numpy().transpose(0, 2, 1),
                               data["y_hops"], rtol=1e-3, atol=1e-4)
    results = {"gen_symad_trained": {
        "frames": int(idx.shape[1]), "index_flips": flips,
        "y_stream_max_abs_err": float(np.abs(y.cpu().numpy()
                                             - data["y_stream"]).max()),
        "y_hops_max_abs_err": float(np.abs(
            y_hops.cpu().numpy().transpose(0, 2, 1)
            - data["y_hops"]).max())}}
    for name, kw in VOC_GOLDENS.items():
        vdata = np.load(GOLDEN / f"{name}.npz")
        sd = {k[len("sd__"):]: vdata[k] for k in vdata.files
              if k.startswith("sd__")}
        vcfg = VocoderConfig(**kw)
        vp = on_device(vocoder_params_from_reference_sd(sd, vcfg), device)
        c = vdata["zq"] if "zq" in vdata.files else vdata["c"]
        c = torch.from_numpy(c).to(device)                # (1, C, T')
        with torch.inference_mode():
            ys, _ = vocoder_stream_bct(vp, c, vcfg,
                                       vocoder_state_init(1, vcfg,
                                                          device=device))
            st, outs = vocoder_state_init(1, vcfg, device=device), []
            for i in range(vdata["y_hops"].shape[-1] // vcfg.hop_length):
                yh, st = vocoder_stream_bct(vp, c[..., i:i + 1], vcfg, st)
                outs.append(yh)
        yh = torch.cat(outs, dim=-1).cpu().numpy()
        np.testing.assert_allclose(ys.cpu().numpy(), vdata["y_stream"],
                                   rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(yh, vdata["y_hops"], rtol=1e-3,
                                   atol=1e-5)
        results[name] = {
            "y_stream_max_abs_err": float(np.abs(ys.cpu().numpy()
                                                 - vdata["y_stream"]).max()),
            "y_hops_max_abs_err": float(np.abs(yh - vdata["y_hops"]).max()),
            "hops": len(outs)}
    torch.cuda.synchronize()
    emit("stream_golden", t0, goldens=results,
         launches=no_kernel_launches("stream_golden"))


def phase_stream_path(device, params, card: str):
    """symAD with the trained golden's weights through StreamingCodec on the
    card: B = 1, 10 s of seeded noise, one hop (300 samples) per encode and
    per decode call; then B = 16 concurrent streams of 2 s."""
    t0 = time.perf_counter()
    cfg = GeneratorConfig()
    hop = cfg.hop_length
    hop_ms = 1e3 * hop / SR
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    x = 0.3 * torch.randn(1, STREAM_SECONDS * SR, 1, generator=gen,
                          device=device)
    reset_launches()
    codec = StreamingCodec(params, cfg, device=device)
    codec.warmup()
    codec.reset()
    t1 = time.perf_counter()
    idx, y, enc_ms, dec_ms, wall = stream_hops(codec, x, hop)
    launches = no_kernel_launches("stream_path")
    steps = {"b1_stream": time.perf_counter() - t1}
    t1 = time.perf_counter()
    hops = idx.shape[1]
    if (tuple(idx.shape) != (1, STREAM_SECONDS * SR // hop, cfg.codebook_num)
            or tuple(y.shape) != tuple(x.shape)
            or not torch.isfinite(y).all()):
        raise AssertionError(f"stream shapes {tuple(idx.shape)}, "
                             f"{tuple(y.shape)}")

    # the indices against the port's plain batch encode of the signal
    batch = BatchTranscoder(params, cfg, stack="plain", device=device)
    idx_batch = batch.encode(x) + flat_offsets(cfg, device)
    batch_flips = int((idx_batch != idx).sum())
    # the hop-by-hop stream against 8-hop chunks, the same indices decoded
    chunked = StreamingCodec(params, cfg, device=device)
    idx8, _, enc8_ms, _, _ = stream_hops(chunked, x, hop, chunk=8)
    chunked.reset()
    _, y8, _, dec8_ms, _ = stream_hops(chunked, None, hop, chunk=8,
                                       decode_only=idx)
    chunk_flips = int((idx8 != idx).sum())
    np.testing.assert_allclose(y8.cpu().numpy(), y.cpu().numpy(), rtol=1e-3,
                               atol=1e-4)
    bar = 1e-3 * idx.numel()
    if batch_flips > bar or chunk_flips > bar:
        raise AssertionError(f"stream index flips: {batch_flips} against "
                             f"the batch encode, {chunk_flips} against 8-hop "
                             f"chunks, bar {bar:.0f}")

    codec.reset()
    x1 = x[:, :hop]

    def one_hop():
        codec.decode(codec.encode(x1))

    t2 = time.perf_counter()
    per_hop = launches_per_call(one_hop)
    codec.reset()
    enc_launches = launches_per_call(lambda: codec.encode(x1))
    steps["profiles"] = time.perf_counter() - t2

    steps["b1_checks"] = time.perf_counter() - t1

    # B = 16 concurrent streams of 2 s, one hop per call, each row against
    # that stream alone at B = 1 (in 8-hop chunks, which the B = 1 stream
    # above equals)
    t1 = time.perf_counter()
    xb = 0.3 * torch.randn(STREAM_BATCH, 2 * SR, 1, generator=gen,
                           device=device)
    many = StreamingCodec(params, cfg, batch=STREAM_BATCH, device=device)
    idx_b, _, enc_b_ms, dec_b_ms, wall_b = stream_hops(many, xb, hop)
    row_flips = []
    solo = StreamingCodec(params, cfg, device=device)
    for r in range(STREAM_BATCH):
        solo.reset()
        idx_r = torch.cat([solo.encode(xb[r:r + 1, i * 8 * hop:
                                          (i + 1) * 8 * hop])
                           for i in range(idx_b.shape[1] // 8)], dim=1)
        row_flips.append(int((idx_r[0] != idx_b[r]).sum()))
    if sum(row_flips) > 1e-3 * idx_b.numel():
        raise AssertionError(f"B = {STREAM_BATCH} rows against their solo "
                             f"streams: {row_flips} flips")
    torch.cuda.synchronize()
    no_kernel_launches("stream_path")
    steps["b16"] = time.perf_counter() - t1

    enc_p, dec_p = percentiles(enc_ms), percentiles(dec_ms)
    hop_p = percentiles([a + b for a, b in zip(enc_ms, dec_ms)])
    summary = {"card": card, "hop_audio_ms": hop_ms,
               "encode_ms_p50": enc_p["p50"], "encode_ms_p99": enc_p["p99"],
               "decode_ms_p50": dec_p["p50"], "decode_ms_p99": dec_p["p99"],
               "rtf": STREAM_SECONDS / wall,
               "launches_per_hop": per_hop["kernels"],
               "copies_per_hop": per_hop["copies"],
               "device_ms_per_hop": per_hop["device_ms"],
               "device_busy_share": per_hop["device_ms"] / hop_p["p50"]}
    print("stream_path " + json.dumps(summary), flush=True)
    emit("stream_path", t0, batch=1, seconds_of_audio=STREAM_SECONDS,
         hops=hops, hop_audio_ms=hop_ms, encode_ms=enc_p, decode_ms=dec_p,
         hop_ms=hop_p, wall_seconds=wall, rtf=STREAM_SECONDS / wall,
         launches_per_hop=per_hop, launches_per_encode=enc_launches,
         index_flips_vs_batch=batch_flips, index_flips_vs_8_hop_chunks=
         chunk_flips, indices=int(idx.numel()),
         chunk8_encode_ms=percentiles(enc8_ms),
         chunk8_decode_ms=percentiles(dec8_ms),
         y_vs_8_hop_chunks_max_abs_err=float((y8 - y).abs().max()),
         batch16={"streams": STREAM_BATCH, "seconds": 2,
                  "encode_ms": percentiles(enc_b_ms),
                  "decode_ms": percentiles(dec_b_ms),
                  "rtf": STREAM_BATCH * 2 / wall_b,
                  "row_flips_vs_solo": row_flips,
                  "indices": int(idx_b.numel())},
         host_seconds=steps, launches=launches)
    return idx


def phase_stream_ad_v1_path(device, params, idx, card: str):
    """The AD v1 receiver's vocoder at 512 channels (seeded weights, as
    ad_v1_path) decoding the symAD stream's first 2 s of indices on the
    card, one hop per call; against 4-hop chunks."""
    t0 = time.perf_counter()
    cfg = GeneratorConfig()
    vcfg = config_from_yaml(AD_V1_VOCODER, stats=True)
    voc = vocoder_init(vcfg, torch.Generator(device=device).manual_seed(SEED))
    hop = vcfg.hop_length
    idx = idx[:, :2 * SR // hop]
    reset_launches()
    codec = StreamingCodec(dict(params, vocoder=voc), cfg, voc_cfg=vcfg,
                           device=device)
    codec.decode(idx[:, :1])    # warm-up
    codec.reset()
    _, y, _, dec_ms, wall = stream_hops(codec, None, hop, decode_only=idx)
    codec.reset()
    _, y4, _, dec4_ms, _ = stream_hops(codec, None, hop, chunk=4,
                                       decode_only=idx)
    np.testing.assert_allclose(y4.cpu().numpy(), y.cpu().numpy(), rtol=1e-3,
                               atol=1e-5)
    # the seeded weights' output is small: hold it to its peak as well
    if not float((y4 - y).abs().max()) <= 1e-3 * float(y.abs().max()):
        raise AssertionError("4-hop chunks off the hop-by-hop decode by "
                             "more than 1e-3 of its peak")
    if tuple(y.shape) != (1, idx.shape[1] * hop, 1) or not torch.isfinite(
            y).all():
        raise AssertionError(f"vocoder stream {tuple(y.shape)}")
    codec.reset()
    per_hop = launches_per_call(lambda: codec.decode(idx[:, :1]))
    torch.cuda.synchronize()
    launches = no_kernel_launches("stream_ad_v1_path")
    dec_p = percentiles(dec_ms)
    summary = {"card": card, "hop_audio_ms": 1e3 * hop / SR,
               "decode_ms_p50": dec_p["p50"], "decode_ms_p99": dec_p["p99"],
               "rtf": idx.shape[1] * hop / SR / wall,
               "launches_per_hop": per_hop["kernels"],
               "copies_per_hop": per_hop["copies"],
               "device_ms_per_hop": per_hop["device_ms"],
               "device_busy_share": per_hop["device_ms"] / dec_p["p50"]}
    print("stream_ad_v1_path " + json.dumps(summary), flush=True)
    emit("stream_ad_v1_path", t0, batch=1, hops=int(idx.shape[1]),
         decode_ms=dec_p, chunk4_decode_ms=percentiles(dec4_ms),
         wall_seconds=wall, rtf=summary["rtf"], launches_per_hop=per_hop,
         peak_abs_y=float(y.abs().max()),
         y_vs_4_hop_chunks_max_abs_err=float((y4 - y).abs().max()),
         y_vs_4_hop_chunks_rel_err=float((y4 - y).abs().max()
                                         / y.abs().max()),
         launches=launches)


def phase_variants_path(device):
    """BatchTranscoder(stack="folded") at B = 16 x 10 s, mixed mode, seeded
    weights, on configs other than symAD's: symAAD (plain: 0 kernel
    launches, as in JAX), the hop-320 16-codebook config (its two C = 32
    stacks through the tensor-core kernel) and symAD's widths in noncausal
    mode (plain)."""
    t0 = time.perf_counter()
    cases = {
        "symAAD": (generator_config(load_config(str(SYMAAD_YAML))), {}),
        "c16_hop320": (generator_config(load_config(str(C16_YAML))),
                       {"mma": 2}),
        "noncausal": (GeneratorConfig(mode="noncausal"), {}),
    }
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = 0.3 * torch.randn(BATCH, SECONDS * SR, 1, generator=gen,
                          device=device)
    results = {}
    for name, (cfg, want) in cases.items():
        params = generator_init(cfg, torch.Generator(
            device=device).manual_seed(SEED))
        tc = BatchTranscoder(params, cfg, dtype=torch.float32,
                             dec_dtype=torch.bfloat16, stack="folded",
                             device=device)
        reset_launches()
        idx, y = tc(x)
        torch.cuda.synchronize()
        launches = read_launches()
        if launches != launch_counts(**want):
            raise AssertionError(f"{name}: kernel launches {launches}, "
                                 f"expected {want or 'none'}")
        check_transcode(idx, y, x, cfg)
        times = time_transcoder(tc, x, idx)
        results[name] = {"codec": cfg.codec, "mode": cfg.mode,
                         "hop": cfg.hop_length,
                         "codebooks": cfg.codebook_num, **times,
                         "launches": launches}
        del tc
    emit("variants_path", t0, batch=BATCH, seconds_of_audio=BATCH * SECONDS,
         configs=results)


def phase_demo_file_path(device, params):
    """bin/demo_file.py on the card: the trained golden as a JAX-format
    checkpoint beside the symAD config, a 10 s seeded PCM16 wav to a wav of
    the same length, then --codes-out and --codes-in: the .adtc's indices
    equal those of a StreamingCodec on the same wav."""
    t0 = time.perf_counter()
    cfg = GeneratorConfig()
    shutil.rmtree(DEMO_DIR, ignore_errors=True)
    DEMO_DIR.mkdir(parents=True)
    shutil.copyfile(SYMAD_YAML, DEMO_DIR / "config.yml")
    ckpt = DEMO_DIR / "checkpoint-golden.ckpt"
    save_checkpoint(str(ckpt), {"gen": params_to_jax(params)}, 0)
    n = STREAM_SECONDS * SR
    rng = np.random.default_rng(SEED)
    write_wav(str(DEMO_DIR / "in.wav"),
              np.clip(0.3 * rng.standard_normal((n, 1)), -1, 1)
              .astype(np.float32), SR)
    common = ["--encoder", str(ckpt), "--decoder", str(ckpt)]
    reset_launches()
    t1 = time.perf_counter()
    res = demo_file.main(common + ["-i", str(DEMO_DIR / "in.wav"),
                                   "-o", str(DEMO_DIR / "out.wav"),
                                   "--codes-out", str(DEMO_DIR / "c.adtc")])
    wav_seconds = time.perf_counter() - t1
    res_in = demo_file.main(common + ["--codes-in", str(DEMO_DIR / "c.adtc"),
                                      "-o", str(DEMO_DIR / "decoded.wav")])
    launches = no_kernel_launches("demo_file_path")
    for name, want in (("out.wav", n), ("decoded.wav", n)):
        got = read_wav_pcm16(str(DEMO_DIR / name))
        if got is None or got[0].shape != (want, 1) or got[1] != SR:
            raise AssertionError(f"{name} is not a {want}-sample PCM16 wav")
        if not np.abs(got[0]).max() > 0:
            raise AssertionError(f"{name} is silent")
    raw, info = unpack_codes((DEMO_DIR / "c.adtc").read_bytes())
    x, _ = read_wav(str(DEMO_DIR / "in.wav"))
    ref = StreamingCodec(params, cfg, device=device).encode(x[None])
    streamed = (ref[0] - flat_offsets(cfg, device)).cpu().numpy()
    if not np.array_equal(raw, streamed):
        raise AssertionError(f"{int((raw != streamed).sum())} indices of "
                             f"the .adtc differ from the stream's")
    size = (DEMO_DIR / "c.adtc").stat().st_size
    shutil.rmtree(DEMO_DIR, ignore_errors=True)
    emit("demo_file_path", t0, seconds_of_audio=STREAM_SECONDS,
         wav_to_wav_seconds=wav_seconds, frames=info["n_frames"],
         adtc_bytes=size, kbps=res["kbps"], payload_kbps=info["kbps"],
         codes_in_samples=res_in["samples"], launches=launches)


# ---------------------------------------------------------------------------
# slice 15: the batch folds, the transcode server and the streaming tools
# ---------------------------------------------------------------------------

def pcm16_max_diff(a, b) -> int:
    return int((codec_test._pcm16(a).int() - codec_test._pcm16(b).int())
               .abs().max())


def fold_ab(fold, off, x, idx, reps: int) -> dict:
    """The folds against the direct route in one process, fold, off, off,
    fold: per run and median encode, decode (of the direct route's
    indices) and transcode ms."""
    runs = {"fold": [], "off": []}
    for name, tc in (("fold", fold), ("off", off), ("off", off),
                     ("fold", fold)):
        runs[name].append({
            "encode_ms": cuda_ms(lambda: tc.encode(x), reps),
            "decode_ms": cuda_ms(lambda: tc.decode(idx), reps),
            "transcode_ms": cuda_ms(lambda: tc(x), reps)})
    return {name: {**{k: float(np.median([r[k] for r in rs]))
                      for k in rs[0]}, "runs": rs}
            for name, rs in runs.items()}


def check_folds(fold, off, x, cfg, what: str) -> dict:
    """One transcode through the folds and one direct, no kernel launched:
    the encode fold's index flips and the bf16 decode fold against the
    direct bf16 decode of the same (direct) indices."""
    want = {"enc_fold": True, "dec_fold": True, "int8_decode": False}
    if (fold.fold_policy != want or off.fold_policy
            != dict.fromkeys(want, False)):
        raise AssertionError(f"{what}: fold policies {fold.fold_policy}, "
                             f"{off.fold_policy}")
    reset_launches()
    idx_f, y_f = fold(x)
    idx_o, y_o = off(x)
    torch.cuda.synchronize()
    launches = no_kernel_launches(f"batchfold_path {what}")
    check_transcode(idx_f, y_f, x, cfg)
    flips = int((idx_f != idx_o).sum())
    y_fd = fold.decode(idx_o)
    rel = rel_l2(y_fd, y_o)
    if flips > FOLD_FLIPS or not rel <= FOLD_REL_L2:
        raise AssertionError(f"{what}: {flips} index flips (bar "
                             f"{FOLD_FLIPS}), decode fold relative L2 "
                             f"{rel:.3g} (bar {FOLD_REL_L2})")
    return {"index_flips": flips, "indices": int(idx_o.numel()),
            "decode_rel_l2": rel, "decode_pcm16_max_diff":
            pcm16_max_diff(y_fd, y_o), "peak_abs_y": float(y_o.abs().max()),
            "launches": launches, "idx": idx_o}


def phase_batchfold_path(device, params, x, card: str):
    """`bench.py`'s workload on the port's JAX `--stack xla` route: symAD
    with the trained golden's weights, B = 16 x 10 s, mixed, stack="plain"
    with the batch folds at auto (fold 8, unfold_after and fold_from auto)
    against the folds off; then the AD v1 receiver (seeded vocoder, as
    ad_v1_path) through vocoder_apply_batchfold.  No kernel launches."""
    t0 = time.perf_counter()
    cfg = GeneratorConfig()
    n = x.shape[1] // cfg.hop_length
    if (fast.batchfold_auto(n), fast.encoder_unfold_auto(cfg),
            fast.decoder_fold_from_auto(cfg)) != (8, 2, 2):
        raise AssertionError("the auto policy at the bench shape")
    mixed = dict(dtype=torch.float32, dec_dtype=torch.bfloat16,
                 stack="plain", device=device)
    off_kw = dict(encode_fold=False, decode_fold=False, **mixed)
    args = codec_test._parser().parse_args([
        "--encoder", "-", "--decoder", "-", "--stack", "plain", "--dtype",
        "mixed", "--precision", "exact"])
    exact = BatchTranscoder(params, cfg, device=device,
                            **codec_test.transcoder_options(args, None))
    if exact.fold_policy["enc_fold"] or not exact.fold_policy["dec_fold"]:
        raise AssertionError(f"--precision exact: {exact.fold_policy}")

    fold = BatchTranscoder(params, cfg, **mixed)
    off = BatchTranscoder(params, cfg, **off_kw)
    symad = check_folds(fold, off, x, cfg, "symAD")
    symad["ab"] = fold_ab(fold, off, x, symad.pop("idx"), reps=3)
    del fold, off

    vcfg = config_from_yaml(AD_V1_VOCODER, stats=True)
    voc = (vocoder_init(vcfg, torch.Generator(device=device)
                        .manual_seed(SEED)), vcfg)
    fold = BatchTranscoder(params, cfg, voc=voc, **mixed)
    off = BatchTranscoder(params, cfg, voc=voc, **off_kw)
    ad_v1 = check_folds(fold, off, x, cfg, "AD v1")
    ad_v1["ab"] = fold_ab(fold, off, x, ad_v1.pop("idx"), reps=2)
    summary = {"card": card}
    for name, r in (("symad", symad), ("ad_v1", ad_v1)):
        summary[name] = {f"{side}_{k}": r["ab"][side][k]
                         for side in ("fold", "off")
                         for k in ("encode_ms", "decode_ms", "transcode_ms")}
        summary[name]["index_flips"] = r["index_flips"]
        summary[name]["decode_rel_l2"] = r["decode_rel_l2"]
    print("batchfold_path " + json.dumps(summary), flush=True)
    emit("batchfold_path", t0, batch=BATCH, seconds_of_audio=BATCH * SECONDS,
         precision_exact_policy=exact.fold_policy, symad=symad,
         ad_v1=ad_v1)
    return symad["launches"]


class TimedLines(io.TextIOBase):
    """A stdout that keeps each line with the time it was written."""

    def __init__(self):
        self.buf, self.lines = "", []

    def write(self, s):
        self.buf += s
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(s)

    def json(self):
        return [(t, json.loads(line)) for t, line in self.lines
                if line.startswith("{")]


@contextlib.contextmanager
def counted_transcodes():
    """Record each BatchTranscoder call: its start, its end after the
    device is done (the server waits for it right after anyway) and its
    batch shape."""
    calls, orig = [], BatchTranscoder.__call__

    def counted(self, x):
        t = time.perf_counter()
        out = orig(self, x)
        torch.cuda.synchronize()
        calls.append({"start": t, "end": time.perf_counter(),
                      "shape": list(x.shape)})
        return out

    BatchTranscoder.__call__ = counted
    try:
        yield calls
    finally:
        BatchTranscoder.__call__ = orig


def compare_outputs(outputs: dict, ref_dir: Path) -> dict:
    """{input wav: output wav} against the wavs of the same names under
    ref_dir: the largest PCM16 difference, the largest relative L2 and the
    byte-identical files."""
    worst, rel, identical = 0, 0.0, 0
    for out in outputs.values():
        ref = ref_dir / Path(out).name
        a = read_wav_pcm16(out)[0].astype(np.int64)
        b = read_wav_pcm16(str(ref))[0].astype(np.int64)
        worst = max(worst, int(np.abs(a - b).max()))
        rel = max(rel, float(np.linalg.norm(a - b) / np.linalg.norm(b)))
        identical += Path(out).read_bytes() == ref.read_bytes()
    return {"files": len(outputs), "max_lsb": worst, "max_rel_l2": rel,
            "byte_identical_files": identical}


def serve(argv, stdin_text=None):
    """codec_serve.main on argv -> (JSON lines with their times, transcoder
    calls, launch counts, start time)."""
    out = TimedLines()
    old_stdin = sys.stdin
    if stdin_text is not None:
        sys.stdin = io.StringIO(stdin_text)
    reset_launches()
    try:
        with counted_transcodes() as calls, contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            codec_serve.main(argv)
    finally:
        sys.stdin = old_stdin
    launches = read_launches()
    if launches != launch_counts(mma=2 * len(calls)):
        raise AssertionError(f"codec_serve: kernel launches {launches} for "
                             f"{len(calls)} transcodes, expected 2 mma each")
    return out.json(), calls, launches, t0


def phase_serve_path(device, params, card: str):
    """bin/codec_serve.py on the card: the trained golden as a JAX-format
    checkpoint beside the symAD config, 24 seeded PCM16 wavs of 2-10 s and
    three bad inputs (unreadable, 16 kHz, stereo in a mono batch) on stdin,
    --dtype mixed --batch-size 8, the default stack (folded) and warmup
    (10 s); against codec_test.main on the same wavs, which pads each
    batch to its longest file where the server pads to 10 s: cuDNN picks
    the bf16 decoder's algorithms by shape, so the bar there is the bf16
    class (relative L2 1e-2), and at codec_test's own batches and shapes
    (the jobs in its order, --warmup-seconds 0) 1 LSB; then --watch with
    a .stop file on 4 of them."""
    t0 = time.perf_counter()
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    exp, wavs, bad = SERVE_DIR / "exp", SERVE_DIR / "wavs", SERVE_DIR / "bad"
    for d in (exp, wavs, bad):
        d.mkdir(parents=True)
    shutil.copyfile(SYMAD_YAML, exp / "config.yml")
    ckpt = str(exp / "checkpoint-golden.ckpt")
    save_checkpoint(ckpt, {"gen": params_to_jax(params)}, 0)
    rng = np.random.default_rng(SEED + 15)
    lengths = {}
    for i, n in enumerate(rng.integers(2 * SR, 10 * SR + 1, SERVE_JOBS)):
        path = str(wavs / f"job{i:02d}.wav")
        write_wav(path, np.clip(0.3 * rng.standard_normal((int(n), 1)), -1,
                                1).astype(np.float32), SR)
        lengths[path] = int(n)
    tone = np.clip(0.3 * rng.standard_normal((SR, 1)), -1, 1).astype(
        np.float32)
    bad_inputs = {str(bad / "unreadable.wav"): "read failed",
                  str(bad / "rate16k.wav"): "sample rate",
                  str(bad / "stereo.wav"): "channel count"}
    (bad / "unreadable.wav").write_bytes(b"not a RIFF file")
    write_wav(str(bad / "rate16k.wav"), tone, 16000)
    write_wav(str(bad / "stereo.wav"), np.repeat(tone, 2, axis=1), SR)
    feed = list(lengths)
    for pos, path in zip((3, 12, 21), bad_inputs):   # one per full batch
        feed.insert(pos, path)
    common = ["--encoder", ckpt, "--decoder", ckpt, "--dtype", "mixed",
              "--batch-size", str(SERVE_BATCH)]

    lines, calls, launches, t_main = serve(
        common + ["--stdin", "--outdir", str(SERVE_DIR / "out")],
        "\n".join(feed) + "\n")
    by_input = {}
    for _, line in lines:
        by_input.setdefault(line["input"], []).append(line)
    if sorted(by_input) != sorted(feed) or any(
            len(v) != 1 for v in by_input.values()):
        raise AssertionError(f"{len(lines)} JSON lines for {len(feed)} jobs")
    for path, text in bad_inputs.items():
        if text not in by_input[path][0].get("error", ""):
            raise AssertionError(f"{path}: {by_input[path][0]}")
    for path, n in lengths.items():
        line = by_input[path][0]
        got = read_wav_pcm16(line.get("output", ""))
        if got is None or got[0].shape != (n, 1) or got[1] != SR:
            raise AssertionError(f"{path}: {line}")
    if any(c["shape"] != [SERVE_BATCH, 10 * SR, 1] for c in calls):
        raise AssertionError(f"transcode shapes {calls}")
    warm = calls[0]
    t_last = lines[-1][0]
    rtfs = sorted({line["batch_rtf"] for _, line in lines
                   if "batch_rtf" in line})

    reset_launches()
    ct_out = SERVE_DIR / "codec_test"
    summary = codec_test.main(common + ["--data-path", str(wavs),
                                        "--outdir", str(ct_out)])
    ct_launches = read_launches()
    if ct_launches != launch_counts(mma=2 * -(-SERVE_JOBS // SERVE_BATCH)):
        raise AssertionError(f"codec_test: kernel launches {ct_launches}")
    versus = compare_outputs(
        {path: by_input[path][0]["output"] for path in lengths}, ct_out)
    if not versus["max_rel_l2"] <= FOLD_REL_L2:
        raise AssertionError(f"codec_serve off codec_test: {versus}")

    # the same batches as codec_test's (its plan, in its order, padded to
    # the hop): the same shapes, so the same cuDNN algorithms
    dataset = SingleDataset(str(wavs))
    plan = codec_test.plan_buckets(dataset, SERVE_BATCH,
                                   GeneratorConfig().hop_length)
    ordered = [dataset.filenames[j] for idxs, _, _ in plan for j in idxs]
    same_lines, same_calls, same_launches, _ = serve(
        common + ["--stdin", "--warmup-seconds", "0", "--outdir",
                  str(SERVE_DIR / "same")], "\n".join(ordered) + "\n")
    same = compare_outputs({line["input"]: line["output"]
                            for _, line in same_lines}, ct_out)
    if same["max_lsb"] > 1 or len(same_lines) != SERVE_JOBS:
        raise AssertionError(f"codec_serve at codec_test's shapes: {same}")

    watch, wout = SERVE_DIR / "watch", SERVE_DIR / "watch_out"
    watch.mkdir()
    picked = list(lengths)[:4]

    def feeder():
        for path in picked:
            shutil.copy(path, watch / Path(path).name)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and len(
                list(wout.glob("*.wav")) if wout.exists() else []) < 4:
            time.sleep(0.05)
        (watch / ".stop").touch()

    feed_thread = threading.Thread(target=feeder, daemon=True)
    feed_thread.start()
    wlines, wcalls, wlaunches, _ = serve(
        common + ["--watch", str(watch), "--poll", "0.1", "--outdir",
                  str(wout)])
    feed_thread.join(timeout=10)
    watch_identical = 0
    for path in picked:
        out = wout / (Path(path).stem + "_output.wav")
        got = read_wav_pcm16(str(out))
        if got is None or got[0].shape != (lengths[path], 1):
            raise AssertionError(f"--watch: {out}")
        watch_identical += out.read_bytes() == Path(
            by_input[path][0]["output"]).read_bytes()
    shutil.rmtree(SERVE_DIR, ignore_errors=True)

    result = {"card": card, "jobs": len(feed), "good": len(lengths),
              "transcodes": len(calls), "warmup_s": warm["end"]
              - warm["start"], "load_s": warm["start"] - t_main,
              "batch_rtf": rtfs, "files_per_s": len(lengths)
              / (t_last - warm["end"]), "first_job_to_last_line_s":
              t_last - warm["end"], "audio_seconds": sum(lengths.values())
              / SR,
              "codec_test_rtf": summary["rtf"],
              "vs_codec_test": versus, "at_codec_test_shapes": same}
    print("serve_path " + json.dumps(result), flush=True)
    emit("serve_path", t0, **result, launches=launches,
         codec_test_launches=ct_launches, watch={
             "files": len(picked), "transcodes": len(wcalls),
             "lines": len(wlines), "launches": wlaunches,
             "byte_identical_to_stdin_run": watch_identical})
    return launches


class FakeSoundDevice:
    """A stand-in for the sounddevice package (not installed on the card's
    machine): a duplex Stream whose context calls the callback with seeded
    microphone frames at the audio rate from a thread."""

    def __init__(self, n_frames: int):
        fake = self
        self.n_frames = n_frames

        class Stream:
            def __init__(self, device, samplerate, blocksize, dtype,
                         latency, channels, callback):
                self.blocksize, self.callback = blocksize, callback
                self.frame_s = blocksize / samplerate

            def __enter__(self):
                def drive():
                    rng = np.random.default_rng(SEED)
                    for _ in range(fake.n_frames):
                        indata = (0.1 * rng.standard_normal(
                            (self.blocksize, 1))).astype(np.float32)
                        outdata = np.zeros((self.blocksize, 1), np.float32)
                        self.callback(indata, outdata, self.blocksize, None,
                                      None)
                        time.sleep(self.frame_s)

                self.thread = threading.Thread(target=drive, daemon=True)
                self.thread.start()
                return self

            def __exit__(self, *exc):
                self.thread.join()

        self.Stream = Stream


def stream_frames(codec, x, frame: int):
    """x (T, 1)'s whole frames through `codec` from the zero state, one
    encode and one decode each -> (indices, waveform (T', 1))."""
    codec.reset()
    idxs, ys = [], []
    for i in range(len(x) // frame):
        idxs.append(codec.encode(x[None, i * frame:(i + 1) * frame]))
        ys.append(codec.decode(idxs[-1]))
    return torch.cat(idxs, dim=1), torch.cat(ys, dim=1)[0].cpu().numpy()


def phase_stream_tools_path(device, params, card: str):
    """The streaming tools on StreamingCodec with the trained golden's
    weights: SimulatedStreamer on 10 s in 8-hop frames (its encoder and
    decoder threads share one codec), bit-equal to the codec fed the same
    frames; the same at real-time pace in 1-hop frames for 3 s (drops and
    latency, no bar); CodecTransmitter and CodecReceiver over a
    socketpair in two threads, bit-equal to a direct decode of the same
    indices; DeviceStreamer on a fake audio driver for 1 s.  No kernel
    launches."""
    t0 = time.perf_counter()
    cfg = GeneratorConfig()
    hop = cfg.hop_length
    x = np.clip(0.3 * np.random.default_rng(SEED + 16).standard_normal(
        (STREAM_SECONDS * SR, 1)), -1, 1).astype(np.float32)
    reset_launches()

    def codec():
        return StreamingCodec(params, cfg, device=device)

    sim = SimulatedStreamer(codec(), frame_size=8 * hop, max_latency_ms=1e9)
    t1 = time.perf_counter()
    y = sim.run(x)
    sim_s = time.perf_counter() - t1
    _, y_ref = stream_frames(codec(), x, 8 * hop)
    if not np.array_equal(y, y_ref):
        raise AssertionError(f"SimulatedStreamer off the stream by "
                             f"{np.abs(y - y_ref).max():.3g}")

    rt = SimulatedStreamer(codec(), frame_size=hop, realtime=True)
    t1 = time.perf_counter()
    rt.run(x[:3 * SR])
    rt_s = time.perf_counter() - t1

    frame = 10 * hop
    a, b = socket.socketpair()
    rx = {}
    rx_thread = threading.Thread(target=lambda: rx.update(zip(
        ("y", "stats"), CodecReceiver(codec()).run(b))))
    rx_thread.start()
    t1 = time.perf_counter()
    tx_stats = CodecTransmitter(codec(), frame_size=frame).run(x, a)
    rx_thread.join(timeout=300)
    net_s = time.perf_counter() - t1
    a.close()
    b.close()
    idx, _ = stream_frames(codec(), x, frame)
    dec = codec()
    y_net = torch.cat([dec.decode(idx[:, i:i + frame // hop])
                       for i in range(0, idx.shape[1], frame // hop)],
                      dim=1)[0].cpu().numpy()
    if not np.array_equal(rx["y"], y_net):
        raise AssertionError(f"the receiver off a direct decode by "
                             f"{np.abs(rx['y'] - y_net).max():.3g}")

    frames = SR // (8 * hop)
    live = DeviceStreamer(codec(), frame_size=8 * hop,
                          sd_module=FakeSoundDevice(frames))
    with contextlib.redirect_stdout(io.StringIO()):
        live.run(duration=1.0)
    live_stats = live.stats()
    if live_stats["frames"] != frames:
        raise AssertionError(f"DeviceStreamer: {live_stats}")
    torch.cuda.synchronize()
    launches = no_kernel_launches("stream_tools_path")
    summary = {"card": card,
               "simulated_10s": {**sim.stats(), "wall_s": sim_s,
                                 "rtf": STREAM_SECONDS / sim_s},
               "realtime_1hop_3s": {**rt.stats(), "wall_s": rt_s},
               "net": {**tx_stats, **{f"rx_{k}": v
                                      for k, v in rx["stats"].items()},
                       "wall_s": net_s},
               "device_streamer_1s": live_stats}
    print("stream_tools_path " + json.dumps(summary), flush=True)
    emit("stream_tools_path", t0, **summary, launches=launches)


# ---------------------------------------------------------------------------
# slice 16: training (bin/codec_train.py's two stages; no kernel of the port)
# ---------------------------------------------------------------------------

# tests/test_train_step_parity.py's config (the reference trainer's golden)
TRAIN_GOLDEN_CONFIG = {
    "sampling_rate": 48000,
    "use_mel_loss": True,
    "mel_loss_params": {"fs": 48000, "fft_sizes": [512], "hop_sizes": [150],
                        "win_lengths": [512], "num_mels": 16, "fmin": 0,
                        "fmax": 24000, "log_base": None},
    "use_stft_loss": False,
    "use_shape_loss": False,
    "use_feat_match_loss": True,
    "feat_match_loss_params": {"average_by_discriminators": False,
                               "average_by_layers": False},
    "generator_adv_loss_params": {"average_by_discriminators": False},
    "discriminator_adv_loss_params": {"average_by_discriminators": False},
    "lambda_adv": 1.0, "lambda_feat_match": 2.0, "lambda_vq_loss": 1.0,
    "lambda_mel_loss": 45.0,
    "generator_optimizer_type": "Adam",
    "generator_optimizer_params": {"lr": 1.0e-4, "betas": [0.5, 0.9],
                                   "weight_decay": 0.0},
    "generator_scheduler_type": "StepLR",
    "generator_scheduler_params": {"step_size": 2, "gamma": 0.5},
    "generator_grad_norm": -1,
    "discriminator_optimizer_type": "Adam",
    "discriminator_optimizer_params": {"lr": 2.0e-4, "betas": [0.5, 0.9],
                                       "weight_decay": 0.0},
    "discriminator_scheduler_type": "MultiStepLR",
    "discriminator_scheduler_params": {"milestones": [1], "gamma": 0.5},
    "discriminator_grad_norm": -1,
}
TRAIN_GOLDEN_GEN = GeneratorConfig(encode_channels=4, decode_channels=4,
                                   code_dim=16, codebook_num=4,
                                   codebook_size=32)
TRAIN_GOLDEN_DISC = D.HiFiGANDiscriminatorConfig(
    msd=D.MultiScaleConfig(scales=2, follow_official_norm=False,
                           discriminator=D.ScaleDiscriminatorConfig(
                               channels=16, max_downsample_channels=32,
                               max_groups=4)),
    mpd=D.MultiPeriodConfig(periods=(2, 3),
                            discriminator=D.PeriodDiscriminatorConfig(
                                channels=4, max_downsample_channels=16)))
TRAIN_DIR = ROOT / "build" / "chip_smoke_train"
SYMADUNIV_YAML = (ROOT / "configs" / "autoencoder"
                  / "symADuniv_vctk_48000_hop300.yaml")
TRAIN_WARMUP = 3


def _sub(data, prefix):
    return {k[len(prefix):]: data[k] for k in data.files
            if k.startswith(prefix)}


def library_launches() -> dict:
    """The CUDA launches the kernel libraries that count their own have
    made in this process (ops/kernels/folded_stack.py cuda_launches)."""
    return {src: folded_stack.cuda_launches(src)
            for src in ("resunit_stack", "wide_stack_mma")}


def no_training_launches(phase: str, before: dict) -> dict:
    """Training runs no kernel of the port, as JAX's runs no pallas_call:
    every wrapper count 0 and no library launch since `before`."""
    launches = no_kernel_launches(phase)
    cuda = {k: n - before[k] for k, n in library_launches().items()}
    if any(cuda.values()):
        raise AssertionError(f"{phase}: CUDA launches {cuda}")
    return {**launches, "library_cuda_launches": cuda}


def parity_bars(ours, ref, lr_budget: float, label: str) -> dict:
    """tests/test_train_step_parity.py's bars per leaf: median |diff| <=
    5e-7, q99 <= 5e-6, max <= 1.05 x the learning-rate budget -> the worst
    of each over the leaves."""
    ours, ref = dict(tree_leaves(ours)), dict(tree_leaves(ref))
    if sorted(ours) != sorted(ref):
        raise AssertionError(f"{label}: trees differ")
    worst = {"median": 0.0, "q99": 0.0, "max": 0.0}
    for path in ours:
        d = np.abs(ours[path].detach().double().cpu().numpy()
                   - ref[path].detach().double().cpu().numpy())
        got = {"median": float(np.median(d)),
               "q99": float(np.quantile(d, 0.99)), "max": float(d.max())}
        bars = {"median": 5e-7, "q99": 5e-6, "max": 1.05 * lr_budget}
        for k in got:
            if got[k] > bars[k]:
                raise AssertionError(f"{label}{path}: {k} |diff| {got[k]} "
                                     f"over {bars[k]}")
            worst[k] = max(worst[k], got[k])
    return worst


def disc_golden(name, cfg, params_of, apply, device) -> float:
    """A discriminator golden on the card at the JAX test's rtol 1e-3 /
    atol 1e-4 -> the largest error over every feature map."""
    data = np.load(GOLDEN / f"{name}.npz")
    eff, _ = resolve_params(tree_map(lambda t: t.to(device),
                                     params_of(_sub(data, "sd__"))))
    x = torch.from_numpy(data["x"].transpose(0, 2, 1).copy()).to(device)
    with torch.no_grad():
        outs = apply(eff, x, cfg)
    worst = 0.0
    for i, branch in enumerate(outs):
        for j, t in enumerate(branch):
            ref = data[f"out_{i}_{j}"]
            got = t.cpu().numpy()
            if got.shape != ref.shape or not np.allclose(got, ref, rtol=1e-3,
                                                         atol=1e-4):
                raise AssertionError(f"{name}: branch {i} layer {j}")
            worst = max(worst, float(np.abs(got - ref).max()))
    return worst


def phase_train_golden(device):
    """The reference trainer's golden (tests/golden/train_step.npz) on the
    card: 3 metric steps, then 2 adversarial steps, through
    train/steps.py, held to the parity test's bars; the frozen encoder and
    projector, and the codebook, unmoved by the adversarial steps; the
    HiFiGAN and UnivNet discriminator goldens.  No kernel launches."""
    t0 = time.perf_counter()
    data = np.load(GOLDEN / "train_step.npz")
    on = partial(tree_map, lambda t: t.to(device))
    gen = on(params_from_reference_sd(_sub(data, "sd0_gen__"),
                                      TRAIN_GOLDEN_GEN))
    disc = on(hifigan_disc_params_from_reference_sd(
        _sub(data, "sd0_disc__"), TRAIN_GOLDEN_DISC, fold=False))
    state = train_state(gen, disc, TRAIN_GOLDEN_CONFIG)
    steps = make_autoencoder_steps(
        TRAIN_GOLDEN_GEN,
        lambda p, x: D.hifigan_discriminator_apply(p, x, TRAIN_GOLDEN_DISC),
        TRAIN_GOLDEN_CONFIG, build_criterion(TRAIN_GOLDEN_CONFIG))
    x_all = torch.from_numpy(data["x_all"].transpose(0, 1, 3, 2).copy()
                             ).to(device)
    n_metric, n_adv = int(data["n_metric"]), int(data["n_adv"])
    reset_launches()
    cuda = library_launches()
    for i in range(n_metric):
        state, _ = steps["metric"](state, x_all[i])

    def ref_gen(key):
        return params_from_reference_sd(_sub(data, key), TRAIN_GOLDEN_GEN)

    bars = {"metric_gen": parity_bars(state["gen"], ref_gen("sdm_gen__"),
                                      3 * 1e-4, "metric:gen:")}
    codebook = state["gen"]["quantizer"]["embed"].clone()
    records = []
    for i in range(n_metric, n_metric + n_adv):
        state, rec = steps["adv"](state, x_all[i])
        records.append({k: float(v) for k, v in rec.items()})
    torch.cuda.synchronize()
    launches = no_training_launches("train_golden", cuda)
    if not all(np.isfinite(v) for r in records for v in r.values()):
        raise AssertionError(f"train_golden: losses {records}")
    ref_a = ref_gen("sda_gen__")
    for sub in ("encoder", "projector"):
        bars[f"adv_frozen_{sub}"] = parity_bars(
            {sub: state["gen"][sub]}, {sub: ref_a[sub]}, 3 * 1e-4,
            "adv:frozen:")
    embed = state["gen"]["quantizer"]["embed"]
    if not torch.equal(embed, codebook) or not np.allclose(
            embed.cpu().numpy(), ref_a["quantizer"]["embed"].numpy(),
            rtol=1e-4, atol=1e-5):
        raise AssertionError("train_golden: the codebook moved in the "
                             "adversarial stage")
    bars["adv_decoder"] = parity_bars(
        {"decoder": state["gen"]["decoder"]}, {"decoder": ref_a["decoder"]},
        3 * 1e-4 + 2 * 5e-5, "adv:gen:")
    bars["adv_disc"] = parity_bars(
        state["disc"], hifigan_disc_params_from_reference_sd(
            _sub(data, "sda_disc__"), TRAIN_GOLDEN_DISC, fold=False),
        2e-4 + 1e-4, "adv:disc:")

    hifigan = D.HiFiGANDiscriminatorConfig(
        msd=D.MultiScaleConfig(follow_official_norm=False,
                               discriminator=D.ScaleDiscriminatorConfig(
                                   channels=16, max_downsample_channels=64)),
        mpd=D.MultiPeriodConfig(discriminator=D.PeriodDiscriminatorConfig(
            channels=8, max_downsample_channels=64)))
    mrsd = D.MultiResolutionSpectralConfig(
        discriminator=D.SpectralDiscriminatorConfig(channels=16))
    golden = {"disc_hifigan": disc_golden(
        "disc_hifigan", hifigan,
        lambda sd: hifigan_disc_params_from_reference_sd(sd, hifigan),
        D.hifigan_discriminator_apply, device)}
    golden["disc_univnet"] = disc_golden(
        "disc_univnet", mrsd,
        lambda sd: mrsd_params_from_reference_sd(sd, mrsd),
        D.mrsd_apply, device)
    emit("train_golden", t0, steps={"metric": n_metric, "adv": n_adv},
         worst_per_leaf=bars, adv_records=records,
         disc_golden_max_abs_err=golden, launches=launches)


def train_corpus(root: Path, rng):
    """Seeded 48 kHz wavs: 32 of 1 s to train on, 16 of 0.5 s to
    evaluate on (one batch of 16)."""
    for sub, n, seconds in (("train", 32, 1.0), ("valid", 16, 0.5)):
        (root / sub).mkdir(parents=True)
        for i in range(n):
            x = 0.3 * np.sin(np.arange(int(seconds * SR))
                             * rng.uniform(0.01, 0.2))
            x = x + 0.05 * rng.standard_normal(x.shape)
            write_wav(str(root / sub / f"u{i:02d}.wav"),
                      x[:, None].astype(np.float32), SR)


def timed_steps(trainer) -> dict:
    """Wrap the trainer's training steps (metric and adversarial, or the
    denoiser's one) so that each call is timed with CUDA events ->
    {stage: [(start, end), ...]}, filled as the run goes."""
    marks = {stage: [] for stage in ("metric", "adv", "train")
             if stage in trainer.steps_fns}
    for stage, out in marks.items():
        def timed(state, *x, step=trainer.steps_fns[stage], out=out):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            result = step(state, *x)
            end.record()
            out.append((start, end))
            return result
        trainer.steps_fns[stage] = timed
    return marks


def host_census() -> dict:
    """What else the process holds when a host-bound step is timed: its
    live threads, the objects the garbage collector tracks, and the
    device memory the caching allocator keeps."""
    return {"threads": sorted(t.name for t in threading.enumerate()),
            "gc_objects": len(gc.get_objects()),
            "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30}


def cut_config(yaml_path: Path, corpus: Path, metric: int, adv: int,
               **over) -> dict:
    """A shipped config with only the data paths (train, valid and test
    under `corpus`), step counts and `over` changed; the adversarial stage
    starts at step `metric`."""
    cfg = load_config(str(yaml_path))
    cfg["data"] = {"path": str(corpus), "subset": {
        "train": "train", "valid": "valid", "test": "test"}}
    cfg["start_steps"] = dict(cfg.get("start_steps", {}),
                              discriminator=metric)
    if "discriminator_train_start_steps" in cfg:
        # the vocoder's gate is `>`
        cfg["discriminator_train_start_steps"] = metric - 1
    cfg.update(train_max_steps=metric, adv_train_max_steps=metric + adv,
               **over)
    return cfg


def train_run(yaml_path: Path, tag: str, metric: int, adv: int, **over):
    """codec_train's trainer on a config with only the data and checkpoint
    paths, step counts and intervals changed, each step timed -> (trainer,
    config, seconds, peak GiB, launches, {stage: step ms}, host census
    before the run).  The adversarial stage starts at step `metric`."""
    argv = over.pop("argv", [])
    cfg = cut_config(yaml_path, TRAIN_DIR / "data", metric, adv, **over)
    cfg_path = TRAIN_DIR / f"{tag}.yaml"
    cfg_path.write_text(dump_yaml(cfg))
    census = host_census()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    cuda = library_launches()
    t1 = time.perf_counter()
    trainer = codec_train.build_trainer(["--config", str(cfg_path), "--tag",
                                         str(TRAIN_DIR / tag)] + argv)
    steps = dict(trainer.steps_fns)
    marks = timed_steps(trainer)
    trainer.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    trainer.steps_fns = steps
    launches = no_training_launches(tag, cuda)
    ms = {stage: [a.elapsed_time(b) for a, b in pairs]
          for stage, pairs in marks.items()}
    return (trainer, cfg, seconds,
            torch.cuda.max_memory_allocated() / 2 ** 30, launches, ms,
            census)


def logged_losses(tag: str) -> list:
    with open(TRAIN_DIR / tag / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    bad = [r for r in recs if not all(np.isfinite(v) for v in r.values())]
    if bad:
        raise AssertionError(f"{tag}: a logged loss is not finite: {bad[0]}")
    return recs


def stage_changes(tag: str, before: str) -> dict:
    """Which subtrees moved between two checkpoints of a run: the frozen
    ones must be bit-equal, the decoder and discriminator must have
    moved."""
    a, _ = load_checkpoint(str(TRAIN_DIR / tag / before))
    b, _ = load_checkpoint(str(TRAIN_DIR / tag / "checkpoint-final.ckpt"))
    moved = {}
    for sub in ("gen/encoder", "gen/projector", "gen/quantizer",
                "gen/decoder", "disc"):
        key = sub.split("/")
        ta, tb = a, b
        for k in key:
            ta, tb = ta[k], tb[k]
        la, lb = dict(tree_leaves(ta)), dict(tree_leaves(tb))
        moved[sub] = sum(not np.array_equal(la[p], lb[p]) for p in la)
    frozen = [s for s in ("gen/encoder", "gen/projector", "gen/quantizer")
              if moved[s]]
    if frozen or not moved["gen/decoder"] or not moved["disc"]:
        raise AssertionError(f"{tag}: leaves moved in the adversarial "
                             f"stage {moved}")
    return moved


def step_stats(step_ms: dict, audio_seconds_per_step: float) -> dict:
    """Per stage: step ms p50 / p90 (CUDA events, after TRAIN_WARMUP
    steps) and seconds of audio trained per second."""
    out = {}
    for stage, ms in step_ms.items():
        ms = ms[TRAIN_WARMUP:] or ms
        if not ms:
            continue
        p50 = float(np.percentile(ms, 50))
        out[stage] = {"steps": len(ms), "p50_ms": p50,
                      "p90_ms": float(np.percentile(ms, 90)),
                      "audio_s_per_s": audio_seconds_per_step / p50 * 1e3}
    return out


def phase_train_path(card: str):
    """bin/codec_train.py on the symAD config at its full widths and batch
    (16 x 9600): 20 metric steps, then 20 adversarial steps against the
    full HiFiGAN MSD + MPD, an eval at step 40, checkpoints at 20 and 40
    and the final one; then --resume from step 20 to step 40, and the
    final checkpoint through the port's codec_test (1 s at f32); one more
    step of each stage profiled.  Every kernel count reads 0 over the
    training windows and the profiled steps."""
    t0 = time.perf_counter()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    train_corpus(TRAIN_DIR / "data", np.random.default_rng(SEED))
    trainer, cfg, seconds, peak, launches, ms, census = train_run(
        SYMAD_YAML, "symad", 20, 20, save_interval_steps=20,
        eval_interval_steps=40, log_interval_steps=5)
    if trainer.steps != 40:
        raise AssertionError(f"train_path: stopped at {trainer.steps}")
    recs = logged_losses("symad")
    train = [r for r in recs if "train/generator_loss" in r]
    evals = [r for r in recs if "eval/generator_loss" in r]
    if len(evals) != 1 or "train/discriminator_loss" not in train[-1]:
        raise AssertionError(f"train_path: log {recs}")
    moved = stage_changes("symad", "checkpoint-20steps.ckpt")
    audio = cfg["batch_size"] * cfg["batch_length"] / SR
    stats = step_stats(ms, audio)
    summary = {"card": card, "batch": [cfg["batch_size"],
                                       cfg["batch_length"]],
               **{f"{k}_{m}": v[m] for k, v in stats.items()
                  for m in ("p50_ms", "p90_ms", "audio_s_per_s")},
               "peak_gib": peak, "first_log": train[0], "last_log": train[-1]}
    print("train_path " + json.dumps(summary), flush=True)
    x = 0.3 * torch.randn(cfg["batch_size"], cfg["batch_length"], 1,
                          generator=torch.Generator(device=trainer.device)
                          .manual_seed(SEED), device=trainer.device)
    for stage in ("metric", "adv"):
        step = trainer.steps_fns[stage]
        cuda = library_launches()
        phase_profile(f"train_path_{stage}_step",
                      lambda v: step(trainer.state, v), x)
        no_training_launches(f"train_path_{stage}_step", cuda)

    resumed, _, resume_seconds, _, resume_launches, _, _ = train_run(
        SYMAD_YAML, "symad_resumed", 20, 20, save_interval_steps=20,
        eval_interval_steps=40, log_interval_steps=5,
        argv=["--resume", str(TRAIN_DIR / "symad" /
                              "checkpoint-20steps.ckpt")])
    _, header = load_checkpoint(str(TRAIN_DIR / "symad_resumed" /
                                    "checkpoint-final.ckpt"))
    if resumed.steps != 40 or header["steps"] != 40:
        raise AssertionError(f"train_path: resumed to {resumed.steps}, "
                             f"header {header}")

    wavs = TRAIN_DIR / "codec_test"
    wavs.mkdir()
    x = 0.3 * np.sin(np.arange(SR) * 0.05)
    write_wav(str(wavs / "one.wav"), x[:, None].astype(np.float32), SR)
    final = str(TRAIN_DIR / "symad" / "checkpoint-final.ckpt")
    reset_launches()
    summary_cli = codec_test.main(["--encoder", final, "--decoder", final,
                                   "--data-path", str(wavs), "--outdir",
                                   str(TRAIN_DIR / "codec_test_out"),
                                   "--dtype", "float32"])
    cli_launches = read_launches()
    y, sr = read_wav(str(TRAIN_DIR / "codec_test_out" / "one_output.wav"))
    if y.shape != (SR, 1) or sr != SR or not np.all(np.isfinite(y)):
        raise AssertionError(f"train_path: codec_test wrote {y.shape}")
    shutil.rmtree(TRAIN_DIR / "symad_resumed", ignore_errors=True)
    emit("train_path", t0, config=str(SYMAD_YAML.relative_to(ROOT)),
         seconds_of_training=seconds, steps=stats, peak_gib=peak,
         moved_leaves=moved, launches=launches, host=census,
         resume={"steps": resumed.steps, "seconds": resume_seconds,
                 "launches": resume_launches},
         codec_test={"summary": summary_cli, "launches": cli_launches,
                     "peak_abs_y": float(np.abs(y).max())})


# ---------------------------------------------------------------------------
# slice 17: vocoder and denoise training, codec_stats (no kernel of the
# port while training, as in JAX; B1's vocoder units in the codec_test
# decode of the trained vocoder)
# ---------------------------------------------------------------------------

# tests/test_train_step_parity.py's vocoder and denoise configs
VOC_GOLDEN_CONFIG = dict(TRAIN_GOLDEN_CONFIG, generator_scheduler_params={
    "step_size": 1, "gamma": 0.5})
VOC_GOLDEN_CFG = VocoderConfig(
    in_channels=16, out_channels=1, channels=32, kernel_size=7,
    upsample_scales=(5, 5, 4, 3), upsample_kernel_sizes=(10, 10, 8, 6),
    resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),), groups=2,
    stats=True)
VOCODER_YAML = (ROOT / "configs" / "vocoder"
                / "AudioDec_v1_symAD_vctk_48000_hop300_clean.yaml")
DENOISE_YAML = ROOT / "configs" / "denoise" / "symAD_vctk_48000_hop300.yaml"
STATISTIC_YAML = (ROOT / "configs" / "statistic"
                  / "symAD_vctk_48000_hop300_clean.yaml")
# what stats_path holds its windowed moments to: a whole-utterance encode
STATS_REL = 1e-5


def bit_equal(ours: dict, ref: dict, label: str) -> int:
    """Every leaf of `ours` equal to `ref`'s bit for bit -> the count."""
    ours, ref = dict(tree_leaves(ours)), dict(tree_leaves(ref))
    if sorted(ours) != sorted(ref):
        raise AssertionError(f"{label}: trees differ")
    for path, t in ours.items():
        if not torch.equal(t.detach().cpu(), ref[path].detach().cpu()):
            raise AssertionError(f"{label}{path} moved")
    return len(ours)


def phase_voc_train_golden(device):
    """The reference trainer's vocoder golden (tests/golden/
    voc_train_step.npz) on the card: a metric step on batch 1, adversarial
    steps on batches 2 and 3 (the reference's first call is a no-op, its
    `>` gate at step 0), held to the parity test's bars; the analyzer and
    the stats `mean` and `scale` bit-equal to their start.  No kernel
    launches."""
    t0 = time.perf_counter()
    data = np.load(GOLDEN / "voc_train_step.npz")
    on = partial(tree_map, lambda t: t.to(device))

    def voc(key):
        return vocoder_params_from_reference_sd(_sub(data, key),
                                                VOC_GOLDEN_CFG, fold=False)

    def disc(key):
        return hifigan_disc_params_from_reference_sd(
            _sub(data, key), TRAIN_GOLDEN_DISC, fold=False)

    analyzer = on(params_from_reference_sd(_sub(data, "sd_analyzer__"),
                                           TRAIN_GOLDEN_GEN))
    frozen0 = tree_map(torch.clone, {"analyzer": analyzer})
    gen = on(voc("sd0_gen__"))
    stats0 = tree_map(torch.clone, {k: gen[k] for k in ("mean", "scale")})
    state = train_state(gen, on(disc("sd0_disc__")), VOC_GOLDEN_CONFIG,
                        analyzer=analyzer)
    steps = make_vocoder_steps(
        VOC_GOLDEN_CFG, TRAIN_GOLDEN_GEN,
        lambda p, x: D.hifigan_discriminator_apply(p, x, TRAIN_GOLDEN_DISC),
        VOC_GOLDEN_CONFIG, build_criterion(VOC_GOLDEN_CONFIG))
    x_all = torch.from_numpy(data["x_all"].transpose(0, 1, 3, 2).copy()
                             ).to(device)
    reset_launches()
    cuda = library_launches()
    state, _ = steps["metric"](state, x_all[1])
    bars = {"metric_gen": parity_bars(state["gen"], voc("sdm_gen__"),
                                      2 * 1e-4, "voc:metric:")}
    records = []
    for i in (2, 3):
        state, rec = steps["adv"](state, x_all[i])
        records.append({k: float(v) for k, v in rec.items()})
    torch.cuda.synchronize()
    launches = no_training_launches("voc_train_golden", cuda)
    if not all(np.isfinite(v) for r in records for v in r.values()):
        raise AssertionError(f"voc_train_golden: losses {records}")
    bars["adv_gen"] = parity_bars(state["gen"], voc("sda_gen__"),
                                  2 * (1e-4 + 5e-5 + 2.5e-5), "voc:adv:gen:")
    bars["adv_disc"] = parity_bars(state["disc"], disc("sda_disc__"),
                                   2 * (2e-4 + 1e-4), "voc:adv:disc:")
    unmoved = bit_equal({k: state["gen"][k] for k in ("mean", "scale")},
                        stats0, "voc_train_golden: ")
    unmoved += bit_equal({"analyzer": state["analyzer"]}, frozen0,
                         "voc_train_golden: ")
    emit("voc_train_golden", t0, steps={"metric": 1, "adv": 2},
         worst_per_leaf=bars, adv_records=records,
         bit_equal_leaves=unmoved, launches=launches)


def phase_denoise_train_golden(device):
    """The reference trainer's denoise golden (tests/golden/
    denoise_train_step.npz) on the card: its n_steps (noisy, clean) steps,
    the encoder and projector held to the parity test's bars, the
    quantizer (its EMA buffers included) and the decoder bit-equal to
    their start.  No kernel launches."""
    t0 = time.perf_counter()
    data = np.load(GOLDEN / "denoise_train_step.npz")
    gen = tree_map(lambda t: t.to(device), params_from_reference_sd(
        _sub(data, "sd0_gen__"), TRAIN_GOLDEN_GEN))
    frozen0 = tree_map(torch.clone, {k: gen[k]
                                     for k in ("quantizer", "decoder")})
    state = train_state(gen, None, TRAIN_GOLDEN_CONFIG)
    steps = make_denoise_steps(TRAIN_GOLDEN_GEN, TRAIN_GOLDEN_CONFIG,
                               build_criterion(TRAIN_GOLDEN_CONFIG))
    x_n, x_c = (torch.from_numpy(data[k].transpose(0, 1, 3, 2).copy()
                                 ).to(device)
                for k in ("x_noisy", "x_clean"))
    reset_launches()
    cuda = library_launches()
    records = []
    for i in range(int(data["n_steps"])):
        state, rec = steps["train"](state, x_n[i], x_c[i])
        records.append({k: float(v) for k, v in rec.items()})
    torch.cuda.synchronize()
    launches = no_training_launches("denoise_train_golden", cuda)
    if not all(np.isfinite(v) for r in records for v in r.values()):
        raise AssertionError(f"denoise_train_golden: losses {records}")
    ref = params_from_reference_sd(_sub(data, "sd1_gen__"), TRAIN_GOLDEN_GEN)
    keys = ("encoder", "projector")
    bars = parity_bars({k: state["gen"][k] for k in keys},
                       {k: ref[k] for k in keys}, 2 * (2 * 1e-4 + 5e-5),
                       "denoise:")
    unmoved = bit_equal({k: state["gen"][k] for k in frozen0}, frozen0,
                        "denoise_train_golden: ")
    emit("denoise_train_golden", t0, steps=len(records),
         worst_per_leaf=bars, records=records, bit_equal_leaves=unmoved,
         launches=launches)


def phase_stats_path(device, card: str) -> Path:
    """bin/codec_stats.py over train_path's corpus (32 utterances of 1 s)
    with train_path's final symAD checkpoint as the analyzer, its windowed
    moments held to one whole-utterance encode of the same corpus on the
    card (mean and standard deviation within STATS_REL of the largest
    entry; the written scale gives a constant feature 1, as the
    reference's StandardScaler).  No kernel launches -> the stats file."""
    t0 = time.perf_counter()
    analyzer_ckpt = TRAIN_DIR / "symad" / "checkpoint-final.ckpt"
    out = TRAIN_DIR / "stats" / "stats.npy"
    reset_launches()
    t1 = time.perf_counter()
    stats = codec_stats.main(["--config", str(STATISTIC_YAML), "--analyzer",
                              str(analyzer_ckpt), "--data-path",
                              str(TRAIN_DIR / "data" / "train"), "--out",
                              str(out)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    launches = no_kernel_launches("stats_path")
    params, cfg = codec_train.load_analyzer(str(analyzer_ckpt), device)
    dataset = SingleDataset(str(TRAIN_DIR / "data" / "train"))
    x = torch.from_numpy(np.stack([dataset[i] for i in range(len(dataset))])
                         ).to(device)
    with torch.no_grad():
        zq = rvq_forward_index(projector_apply(
            params["projector"], encoder_apply(params["encoder"], x, cfg),
            cfg), params["quantizer"])[0]
    whole = codec_stats.RunningMoments(cfg.code_dim)
    whole.update(zq.reshape(-1, cfg.code_dim).cpu().numpy().astype(
        np.float64))
    want = np.stack([whole.mean, np.sqrt(whole.m2 / whole.n)])
    got = np.stack([stats[0], np.where(stats[1] == 1.0, 0.0, stats[1])])
    constant = int(np.sum(stats[1] == 1.0))
    # a feature the written stats call constant holds 0 beside the whole
    # encode's standard deviation, which must be as small
    err = np.abs(got - want)
    tol = STATS_REL * float(np.abs(want).max())
    if err.max() > tol or not np.all(np.isfinite(stats)):
        raise AssertionError(f"stats_path: |windowed - whole| {err.max()} "
                             f"over {tol}")
    summary = {"card": card, "utterances": len(dataset),
               "frames": int(whole.n), "seconds": seconds,
               "max_abs_err": float(err.max()), "tolerance": tol,
               "constant_features": constant,
               "scale_range": [float(stats[1].min()),
                               float(stats[1].max())]}
    print("stats_path " + json.dumps(summary), flush=True)
    emit("stats_path", t0, **summary, launches=launches)
    return out


def phase_voc_train_path(card: str, stats: Path) -> dict:
    """bin/codec_train.py on the AD v1 vocoder config at its full widths
    (512 channels, 3 groups, full HiFiGAN MSD + MPD) and batch (16 x 9600),
    train_path's final symAD checkpoint as the analyzer and stats_path's
    statistics: 10 metric steps, then 10 adversarial steps, an eval at
    step 20, checkpoints at 10 and 20; the log finite, the analyzer and
    the statistics in the checkpoint unmoved, the vocoder and the
    discriminator moved; one step of each stage profiled.  Then the port's
    codec_test with the symAD checkpoint as the encoder and the vocoder's
    as the decoder, the default stack, --dtype mixed: B1's vocoder-unit
    kernel launched, the output finite -> codec_test's launch counts."""
    t0 = time.perf_counter()
    analyzer_ckpt = TRAIN_DIR / "symad" / "checkpoint-final.ckpt"
    cfg = load_config(str(VOCODER_YAML))
    gp = dict(cfg["generator_params"], stats=str(stats))
    trainer, cfg, seconds, peak, launches, ms, _ = train_run(
        VOCODER_YAML, "vocoder", 10, 10, analyzer=str(analyzer_ckpt),
        generator_params=gp, save_interval_steps=10,
        eval_interval_steps=20, log_interval_steps=5)
    if trainer.steps != 20:
        raise AssertionError(f"voc_train_path: stopped at {trainer.steps}")
    recs = logged_losses("vocoder")
    train = [r for r in recs if "train/generator_loss" in r]
    if ("train/discriminator_loss" in train[1]
            or "train/discriminator_loss" not in train[-1]):
        raise AssertionError(f"voc_train_path: log {recs}")
    final = TRAIN_DIR / "vocoder" / "checkpoint-final.ckpt"
    a, _ = load_checkpoint(str(TRAIN_DIR / "vocoder" /
                               "checkpoint-10steps.ckpt"))
    b, _ = load_checkpoint(str(final))
    an, _ = load_checkpoint(str(analyzer_ckpt))
    written = np.load(stats)
    moved = {sub: sum(not np.array_equal(la, lb) for (_, la), (_, lb) in
                      zip(tree_leaves(a[sub]), tree_leaves(b[sub])))
             for sub in ("gen", "disc")}
    same = (all(np.array_equal(la, lb) for (_, la), (_, lb) in
                zip(tree_leaves(b["analyzer"]), tree_leaves(an["gen"])))
            and np.array_equal(b["gen"]["mean"], written[0])
            and np.array_equal(b["gen"]["scale"], written[1]))
    if not same or not all(moved.values()):
        raise AssertionError(f"voc_train_path: moved {moved}, analyzer and "
                             f"stats unmoved {same}")
    audio = cfg["batch_size"] * cfg["batch_length"] / SR
    stats_ms = step_stats(ms, audio)
    summary = {"card": card, "batch": [cfg["batch_size"],
                                       cfg["batch_length"]],
               **{f"{k}_{m}": v[m] for k, v in stats_ms.items()
                  for m in ("p50_ms", "p90_ms", "audio_s_per_s")},
               "peak_gib": peak, "first_log": train[0], "last_log": train[-1]}
    print("voc_train_path " + json.dumps(summary), flush=True)
    x = 0.3 * torch.randn(cfg["batch_size"], cfg["batch_length"], 1,
                          generator=torch.Generator(device=trainer.device)
                          .manual_seed(SEED), device=trainer.device)
    for stage in ("metric", "adv"):
        step = trainer.steps_fns[stage]
        cuda = library_launches()
        phase_profile(f"voc_train_path_{stage}_step",
                      lambda v: step(trainer.state, v), x)
        no_training_launches(f"voc_train_path_{stage}_step", cuda)

    out = TRAIN_DIR / "voc_codec_test_out"
    reset_launches()
    summary_cli = codec_test.main(["--encoder", str(analyzer_ckpt),
                                   "--decoder", str(final), "--data-path",
                                   str(TRAIN_DIR / "codec_test"), "--outdir",
                                   str(out), "--dtype", "mixed"])
    cli_launches = read_launches()
    y, sr = read_wav(str(out / "one_output.wav"))
    if y.shape != (SR, 1) or sr != SR or not np.all(np.isfinite(y)):
        raise AssertionError(f"voc_train_path: codec_test wrote {y.shape}")
    if cli_launches["mma_voc"] == 0:
        raise AssertionError(f"voc_train_path: codec_test launched "
                             f"{cli_launches}, no vocoder unit")
    emit("voc_train_path", t0, config=str(VOCODER_YAML.relative_to(ROOT)),
         seconds_of_training=seconds, steps=stats_ms, peak_gib=peak,
         moved_leaves=moved, launches=launches,
         codec_test={"summary": summary_cli, "launches": cli_launches,
                     "peak_abs_y": float(np.abs(y).max())})
    return cli_launches


def noisy_corpus(root: Path, rng):
    """noisy_train and noisy_valid: train_corpus's wavs plus seeded noise,
    file for file."""
    for sub in ("train", "valid"):
        (root / f"noisy_{sub}").mkdir()
        for wav in sorted((root / sub).iterdir()):
            x, sr = read_wav(str(wav))
            x = x + 0.05 * rng.standard_normal(x.shape)
            write_wav(str(root / f"noisy_{sub}" / wav.name),
                      x.astype(np.float32), sr)


def phase_denoise_train_path(card: str):
    """bin/codec_train.py on the denoise config (symAD at its full widths,
    B = 16 x 9600) warm-started from train_path's final checkpoint on
    (noisy, clean) pairs, the clean side train_path's corpus: 10 steps,
    checkpoints at 5 and 10; the log finite, the quantizer and decoder
    bit-equal to the warm start, the encoder moved."""
    t0 = time.perf_counter()
    noisy_corpus(TRAIN_DIR / "data", np.random.default_rng(SEED + 1))
    initial = TRAIN_DIR / "symad" / "checkpoint-final.ckpt"
    data = {"path": str(TRAIN_DIR / "data"),
            "subset": {"clean_train": "train", "clean_valid": "valid",
                       "noisy_train": "noisy_train",
                       "noisy_valid": "noisy_valid"}}
    trainer, cfg, seconds, peak, launches, ms, _ = train_run(
        DENOISE_YAML, "denoise", 10, 0, initial=str(initial), data=data,
        save_interval_steps=5, eval_interval_steps=10, log_interval_steps=5)
    if trainer.steps != 10:
        raise AssertionError(f"denoise_train_path: stopped at "
                             f"{trainer.steps}")
    recs = logged_losses("denoise")
    start, _ = load_checkpoint(str(initial))
    end, _ = load_checkpoint(str(TRAIN_DIR / "denoise" /
                                 "checkpoint-final.ckpt"))
    moved = {sub: sum(not np.array_equal(la, lb) for (_, la), (_, lb) in
                      zip(tree_leaves(start["gen"][sub]),
                          tree_leaves(end["gen"][sub])))
             for sub in ("encoder", "projector", "quantizer", "decoder")}
    if moved["quantizer"] or moved["decoder"] or not moved["encoder"]:
        raise AssertionError(f"denoise_train_path: moved {moved}")
    audio = cfg["batch_size"] * cfg["batch_length"] / SR
    stats_ms = step_stats(ms, audio)
    summary = {"card": card, "batch": [cfg["batch_size"],
                                       cfg["batch_length"]],
               **{f"{k}_{m}": v[m] for k, v in stats_ms.items()
                  for m in ("p50_ms", "p90_ms", "audio_s_per_s")},
               "peak_gib": peak, "last_log": recs[-1]}
    print("denoise_train_path " + json.dumps(summary), flush=True)
    emit("denoise_train_path", t0, config=str(DENOISE_YAML.relative_to(ROOT)),
         seconds_of_training=seconds, steps=stats_ms, peak_gib=peak,
         moved_leaves=moved, launches=launches)


def phase_train_univ_path(card: str):
    """The symADuniv config (UnivNet's MRSD + MPD) at its widths and batch:
    2 metric steps and 2 adversarial steps, with the finiteness and the
    freezing checks."""
    t0 = time.perf_counter()
    trainer, cfg, seconds, peak, launches, ms, _ = train_run(
        SYMADUNIV_YAML, "symaduniv", 2, 2, save_interval_steps=2,
        eval_interval_steps=10 ** 6, log_interval_steps=1)
    if trainer.steps != 4:
        raise AssertionError(f"train_univ_path: stopped at {trainer.steps}")
    recs = logged_losses("symaduniv")
    moved = stage_changes("symaduniv", "checkpoint-2steps.ckpt")
    summary = {"card": card, "metric_ms": ms["metric"], "adv_ms": ms["adv"],
               "peak_gib": peak, "last_log": recs[-1]}
    print("train_univ_path " + json.dumps(summary), flush=True)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    emit("train_univ_path", t0, config=str(SYMADUNIV_YAML.relative_to(ROOT)),
         seconds_of_training=seconds, moved_leaves=moved, launches=launches)


def train_phases(device, card: str) -> dict:
    """The training phases of slices 16 and 17, in the order their files
    need (train_univ_path removes build/chip_smoke_train/) -> the launch
    counts of voc_train_path's codec_test."""
    phase_train_golden(device)
    phase_voc_train_golden(device)
    phase_denoise_train_golden(device)
    phase_train_path(card)
    stats = phase_stats_path(device, card)
    launches = phase_voc_train_path(card, stats)
    phase_denoise_train_path(card)
    phase_train_univ_path(card)
    return launches


# ---------------------------------------------------------------------------
# slice 18: the parallel paths, in ranks of their own on the one card
# (bin/multihost_probe.py; no kernel of the port, as JAX's sharded codecs
# and training run no pallas_call)
# ---------------------------------------------------------------------------

PAR_DIR = ROOT / "build" / "chip_smoke_parallel"
PAR_BATCH, PAR_SECONDS = 4, 10
# the multi-hop case: seq = 4 shards of this many samples, below the
# default config's 7500-sample encoder halo (and 20 frames, below its
# 28-frame decoder halo)
PAR_HOP_SHARD = 6000
PAR_REPS = 3
PAR_RTOL, PAR_ATOL = 1e-5, 1e-6   # tests/test_parallel.py:73
PAR_MIXED = 0.05                   # tests/test_parallel.py's mixed bar
PAR_STATS_REL = 1e-5
# a world of one rank on a machine with a card of its own takes nccl
# (parallel/distributed.py backend_for)
PAR_ONE_RANK_BACKEND = "nccl"


def par_ranks(n: int, argv: list, out: Path, timeout: float = 400) -> list:
    """bin/multihost_probe.py's ranks on the card (each binds cuda:0), their
    logs kept under `out`."""
    out.mkdir(parents=True, exist_ok=True)
    logs = multihost_probe.run_ranks(n, argv, timeout=timeout)
    for i, log in enumerate(logs):
        (out / f"rank{i}.log").write_text(log)
    return [json.loads((out / f"rank{i}.json").read_text())
            for i in range(n)]


def no_rank_launches(phase: str, launches: dict):
    """A rank's kernel counts, every one 0 (the library CUDA counters
    too)."""
    if any(launches.values()):
        raise AssertionError(f"{phase}: kernel launches in a rank "
                             f"{launches}, expected none")


def par_close(got: np.ndarray, ref: np.ndarray) -> dict:
    """The waveform against its unsharded reference at
    tests/test_parallel.py:73's rtol 1e-5 / atol 1e-6."""
    err = np.abs(got.astype(np.float64) - ref)
    over = err - (PAR_ATOL + PAR_RTOL * np.abs(ref))
    return {"max_abs_err": float(err.max()),
            "worst_over_bar": float(over.max()),
            "within_bar": bool(over.max() <= 0)}


def phase_parallel_codec(device, card: str) -> dict:
    """The chunk-halo sharded codec and the channel-parallel codec on symAD
    at its published widths with the trained golden, in one world of four
    ranks on the one card (gloo, the halo shifts and gathers staged through
    the host), after the tiny probe of bin/multihost_probe.py in the same
    world: data 2 x seq 2 on B = 4 x 10 s in float32 and in mixed mode,
    the AD v1 receiver's sharded decode (float32, seeded weights), seq = 4
    shards of PAR_HOP_SHARD samples (the chained halo), and model = 2 x
    data 2.  Bars: float32 indices equal to this process's unsharded
    transcode of the same batch (`BatchTranscoder(stack="plain")`, folds
    off), the mixed mode's equal to float32's, waveforms at rtol 1e-5 /
    atol 1e-6 (the mixed mode within 0.05 of float32's); every rank's
    kernel counts 0.  Prints per case each rank's ms per call (host clock
    after a synchronize, PAR_REPS calls) beside the unsharded ms, the
    collectives per call and their bytes, and each rank's peak memory."""
    t0 = time.perf_counter()
    cfg = GeneratorConfig()
    if not (PAR_HOP_SHARD < encoder_halo_samples(cfg)
            and PAR_HOP_SHARD // cfg.hop_length < decoder_halo_frames(cfg)):
        raise AssertionError("parallel_codec: the multi-hop shards are not "
                             "shorter than the halos")
    _, params = load_golden("gen_symad_trained")
    vcfg = config_from_yaml(AD_V1_VOCODER, stats=True)
    voc = vocoder_init(vcfg, torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    x = (0.3 * rng.standard_normal((PAR_BATCH, int(PAR_SECONDS * SR), 1))
         ).astype(np.float32)
    x_hop = (0.3 * rng.standard_normal((PAR_BATCH, 4 * PAR_HOP_SHARD, 1))
             ).astype(np.float32)
    cases = [dict(name="d2_s2_f32", kind="sharded", data=2, seq=2),
             dict(name="d2_s2_mixed", kind="sharded", data=2, seq=2,
                  dtype="mixed"),
             dict(name="d2_s2_ad_v1", kind="sharded", data=2, seq=2,
                  vocoder=True),
             dict(name="d1_s4_multi_hop", kind="sharded", data=1, seq=4,
                  input="x_hop"),
             dict(name="d2_model2_tp", kind="tp", data=2, model=2,
                  reps=0)]
    out = PAR_DIR / "codec"
    out.mkdir(parents=True, exist_ok=True)
    torch.save({"params": params, "cfg": cfg, "voc": (voc, vcfg), "x": x,
                "x_hop": x_hop, "cases": cases, "reps": PAR_REPS,
                "probe_seq": 2}, out / "in.pt")
    t1 = time.perf_counter()
    ranks = par_ranks(4, ["--worker", "codec_cases", "--in",
                          str(out / "in.pt"), "--out", str(out), "--device",
                          "cuda"], out)
    world_s = time.perf_counter() - t1
    got = torch.load(out / "rank0.pt", weights_only=False)
    for r in ranks:
        for name, st in r["cases"].items():
            if st["member"]:
                no_rank_launches(f"parallel_codec {name}", st["launches"])

    # the unsharded references, on this process's card
    ref = BatchTranscoder(params, cfg, stack="plain", encode_fold=False,
                          decode_fold=False, device=device)
    ref_v1 = BatchTranscoder(params, cfg, voc=(voc, vcfg), stack="plain",
                             encode_fold=False, decode_fold=False,
                             device=device)
    reset_launches()
    xs = {k: torch.from_numpy(v).to(device) for k, v in
          (("x", x), ("x_hop", x_hop))}
    idx_ref, y_ref = ref(xs["x"])
    idx_hop, y_hop = ref(xs["x_hop"])
    v1_ref = ref_v1.decode(idx_ref)
    single_ms = {"d2_s2_f32": cuda_ms(lambda: ref(xs["x"]), PAR_REPS),
                 "d2_s2_ad_v1": cuda_ms(lambda: ref_v1(xs["x"]), PAR_REPS),
                 "d1_s4_multi_hop": cuda_ms(lambda: ref(xs["x_hop"]),
                                            PAR_REPS)}
    no_kernel_launches("parallel_codec (unsharded references)")
    single_ms["d2_model2_tp"] = single_ms["d2_s2_f32"]
    idx_ref, idx_hop = idx_ref.cpu().numpy(), idx_hop.cpu().numpy()
    want = {"d2_s2_f32": (idx_ref, y_ref), "d2_s2_ad_v1": (idx_ref, v1_ref),
            "d1_s4_multi_hop": (idx_hop, y_hop),
            "d2_model2_tp": (idx_ref, y_ref)}
    report = {}
    for name, (ri, ry) in want.items():
        flips = int(np.sum(got[name]["idx"] != ri))
        wave = par_close(got[name]["y"], ry.double().cpu().numpy())
        report[name] = {"index_flips": flips, **wave}
        if flips or not wave["within_bar"]:
            raise AssertionError(f"parallel_codec {name}: {flips} index "
                                 f"flips, waveform {wave}")
    mixed, f32 = got["d2_s2_mixed"], got["d2_s2_f32"]
    mixed_err = float(np.abs(mixed["y"] - f32["y"]).max())
    report["d2_s2_mixed"] = {"index_flips_vs_f32": int(np.sum(
        mixed["idx"] != f32["idx"])), "max_abs_err_vs_f32": mixed_err}
    if (report["d2_s2_mixed"]["index_flips_vs_f32"]
            or not np.all(np.isfinite(mixed["y"]))
            or not np.all(np.abs(mixed["y"] - f32["y"])
                          <= PAR_MIXED + PAR_MIXED * np.abs(f32["y"]))):
        raise AssertionError(f"parallel_codec mixed: {report['d2_s2_mixed']}")
    per_case = {}
    for c in cases:
        name = c["name"]
        members = [r["cases"][name] for r in ranks
                   if r["cases"][name]["member"]]
        per_case[name] = {
            "ranks": len(members),
            "ms_per_call_by_rank": [float(np.mean(m["ms"]))
                                    for m in members],
            "unsharded_ms": single_ms.get(name),
            "collectives_per_call": members[0]["comm_per_call"]["calls"],
            "bytes_per_call_by_rank": [m["comm_per_call"]["bytes"]
                                       for m in members],
            "staged": members[0]["comm_per_call"]["staged"]}
    summary = {"card": card, "backend": ranks[0]["backend"],
               "staged_through_host": ranks[0]["staged"],
               "world_seconds": world_s,
               "peak_gib_by_rank": [r["peak_gib"] for r in ranks],
               "cases": per_case}
    print("parallel_codec " + json.dumps(summary), flush=True)
    emit("parallel_codec", t0, checks=report, **summary)
    return summary


def _par_train_config(root: Path) -> Path:
    """symAD's config at its widths and batch (16 x 9600), 2 metric and 2
    adversarial steps, a checkpoint at the end only."""
    cfg = load_config(str(SYMAD_YAML))
    cfg["data"] = {"path": str(root / "data"),
                   "subset": {"train": "train", "valid": "valid"}}
    cfg["start_steps"] = dict(cfg.get("start_steps", {}), discriminator=2)
    cfg.update(train_max_steps=2, adv_train_max_steps=4,
               save_interval_steps=4, eval_interval_steps=10 ** 6,
               log_interval_steps=1)
    path = root / "symad_dp.yaml"
    path.write_text(dump_yaml(cfg))
    return path


def _synced_ms(trainer) -> dict:
    """The trainer's steps timed as the ranks time theirs: host clock
    around the step, after a synchronize on each side."""
    marks = {}

    def wrap(name, fn):
        def step(state, *batch):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(state, *batch)
            torch.cuda.synchronize()
            marks.setdefault(name, []).append(
                1e3 * (time.perf_counter() - t1))
            return out
        return step

    trainer.steps_fns = {k: wrap(k, f) for k, f in trainer.steps_fns.items()}
    return marks


def _par_stats_argv(root: Path) -> list:
    """codec_stats on the data-parallel run's final checkpoint."""
    return ["--config", str(STATISTIC_YAML), "--analyzer",
            str(root / "dp" / "checkpoint-final.ckpt"), "--data-path",
            str(root / "data" / "train")]


def phase_parallel_train(device, card: str) -> tuple:
    """`codec_train --dp 2`, then `codec_stats --dp 2` on its checkpoint,
    in one world of two ranks on the one card; the training against one
    rank in this process at the same global batch (symAD at its widths,
    B = 16 x 9600, 2 metric + 2 adversarial steps, one seed): every rank
    steps on one global batch and holds equal params after every step
    (checked in the ranks), the final params within
    tests/test_parallel_fullsize.py's bars of the single rank's (median
    5e-7, q99 5e-6, max 1.05 x 2 lr per leaf; the quantizer's
    sparse-divergence gate: at most 1e-3 of its entries off by more than
    1e-6, none by more than 0.05); no kernel launches -> (the final
    checkpoint of the two ranks, their codec_stats records, the world's
    seconds)."""
    t0 = time.perf_counter()
    root = PAR_DIR / "train"
    train_corpus(root / "data", np.random.default_rng(SEED))
    cfg_path = _par_train_config(root)
    common = ["--config", str(cfg_path), "--seed", str(SEED)]
    t1 = time.perf_counter()
    both = par_ranks(2, ["--worker", "cli", "--cli", "codec_train", "--cli",
                         "codec_stats", "--device", "cuda", "--out",
                         str(root / "ranks"), "--"] + common
                     + ["--tag", str(root / "dp"), "--dp", "2", "--"]
                     + _par_stats_argv(root)
                     + ["--dp", "2", "--out", str(PAR_DIR / "stats_dp.npy")],
                     root / "ranks")
    world_s = time.perf_counter() - t1
    ranks = [r["codec_train"] for r in both]
    for r in ranks:
        no_rank_launches("parallel_train", r["launches"])
        if not r["in_sync_after_every_step"] or r["steps"] != 4:
            raise AssertionError(f"parallel_train: rank {r}")
    reset_launches()
    cuda = library_launches()
    torch.cuda.reset_peak_memory_stats()
    trainer = codec_train.build_trainer(common + ["--tag",
                                                  str(root / "one")])
    single_ms = _synced_ms(trainer)
    trainer.run()
    no_training_launches("parallel_train (one rank)", cuda)
    single_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    config = load_config(str(cfg_path))
    lrs = {"gen": config["generator_optimizer_params"]["lr"],
           "disc": config["discriminator_optimizer_params"]["lr"]}
    dp_state, _ = load_checkpoint(str(root / "dp" / "checkpoint-final.ckpt"))
    one_state, _ = load_checkpoint(str(root / "one" /
                                       "checkpoint-final.ckpt"))
    worst, quantizer = {}, {}
    for key in ("gen", "disc"):
        ours = dict(tree_leaves(dp_state[key]))
        ref = dict(tree_leaves(one_state[key]))
        if sorted(ours) != sorted(ref):
            raise AssertionError("parallel_train: trees differ")
        w = {"median": 0.0, "q99": 0.0, "max": 0.0}
        for path in ours:
            d = np.abs(np.asarray(ours[path], np.float64)
                       - np.asarray(ref[path], np.float64))
            if path.startswith("quantizer/"):
                frac = float((d > 1e-6).mean())
                quantizer[path] = {"frac_over_1e-6": frac,
                                   "max": float(d.max())}
                if frac > 1e-3 or d.max() > 0.05:
                    raise AssertionError(f"parallel_train: quantizer "
                                         f"{path} {quantizer[path]}")
                continue
            got = {"median": float(np.median(d)),
                   "q99": float(np.quantile(d, 0.99)), "max": float(d.max())}
            bars = {"median": 5e-7, "q99": 5e-6, "max": 1.05 * 2 * lrs[key]}
            for k in got:
                if got[k] > bars[k]:
                    raise AssertionError(f"parallel_train: {key}/{path} "
                                         f"{k} {got[k]} over {bars[k]}")
                w[k] = max(w[k], got[k])
        worst[key] = w
    summary = {"card": card, "backend": ranks[0]["backend"],
               "staged_through_host": ranks[0]["comm"]["staged"],
               "collectives_per_step": {
                   k: v / 4 for k, v in ranks[0]["comm"]["calls"].items()},
               "bytes_per_step_by_rank": [r["comm"]["bytes"] / 4
                                          for r in ranks],
               "world_seconds_with_stats": world_s,
               "step_ms_by_rank": [r["step_ms"] for r in ranks],
               "single_rank_step_ms": single_ms,
               "peak_gib_by_rank": [r["peak_gib"] for r in ranks],
               "single_rank_peak_gib": single_peak,
               "worst_per_leaf": worst, "quantizer": quantizer}
    print("parallel_train " + json.dumps(summary), flush=True)
    emit("parallel_train", t0, **summary)
    return (root / "dp" / "checkpoint-final.ckpt",
            [r["codec_stats"] for r in both])


def phase_parallel_cli(device, card: str, ckpt: Path, stats_ranks: list):
    """The data-parallel world's `codec_stats --dp 2` (phase_parallel_train)
    against one rank in this process (within 1e-5 of the largest entry),
    then codec_test in a world of one rank joined with --coordinator
    --num-processes 1 --process-id 0, whose backend must be nccl, against
    the plain command line in this process (PCM16 within 1 LSB); --stack
    plain, so that no kernel launches."""
    t0 = time.perf_counter()
    root = PAR_DIR / "train"
    data = root / "data"
    for r in stats_ranks:
        no_rank_launches("parallel_stats", r["launches"])
    one = codec_stats.main(_par_stats_argv(root)
                           + ["--out", str(PAR_DIR / "stats_1.npy")])
    two = np.load(PAR_DIR / "stats_dp.npy")
    stats_err = float(np.abs(two - one).max())
    stats_tol = PAR_STATS_REL * float(np.abs(one).max())
    if stats_err > stats_tol:
        raise AssertionError(f"parallel_stats: --dp 2 off --dp 1 by "
                             f"{stats_err} over {stats_tol}")

    argv = ["--encoder", str(ckpt), "--decoder", str(ckpt), "--data-path",
            str(data / "valid"), "--stack", "plain"]
    t1 = time.perf_counter()
    (nccl,) = par_ranks(1, ["--worker", "cli", "--cli", "codec_test",
                            "--device", "cuda", "--out",
                            str(PAR_DIR / "nccl"), "--"] + argv
                        + ["--outdir", str(PAR_DIR / "nccl_out")],
                        PAR_DIR / "nccl")
    nccl = nccl["codec_test"]
    nccl_s = time.perf_counter() - t1
    no_rank_launches("parallel_nccl", nccl["launches"])
    if (nccl["backend"] != PAR_ONE_RANK_BACKEND
            or nccl["summary"]["hosts"] != 1):
        raise AssertionError(f"parallel_nccl: {nccl}")
    reset_launches()
    plain = codec_test.main(argv + ["--outdir", str(PAR_DIR / "plain_out")])
    no_kernel_launches("parallel_nccl (plain)")
    files = sorted(p.name for p in (PAR_DIR / "plain_out").iterdir())
    if (files != sorted(p.name for p in (PAR_DIR / "nccl_out").iterdir())
            or not files):
        raise AssertionError("parallel_nccl: the two runs wrote other files")
    lsb = max(int(np.abs(
        read_wav_pcm16(str(PAR_DIR / "nccl_out" / f))[0].astype(np.int32)
        - read_wav_pcm16(str(PAR_DIR / "plain_out" / f))[0]).max())
        for f in files)
    if lsb > 1:
        raise AssertionError(f"parallel_nccl: {lsb} LSB from the plain CLI")
    summary = {"card": card,
               "stats": {"backend": stats_ranks[0]["backend"],
                         "collectives_by_rank": [r["comm"]
                                                 for r in stats_ranks],
                         "max_abs_err": stats_err, "tolerance": stats_tol},
               "nccl_world_of_one": {"backend": nccl["backend"],
                                     "seconds": nccl_s, "files": len(files),
                                     "max_lsb_vs_plain": lsb,
                                     "rtf": nccl["summary"]["rtf"],
                                     "plain_rtf": plain["rtf"]}}
    print("parallel_cli " + json.dumps(summary), flush=True)
    emit("parallel_cli", t0, **summary)


def parallel_phases(device, card: str):
    """Slice 18's phases, their files under build/chip_smoke_parallel/
    (removed afterwards)."""
    shutil.rmtree(PAR_DIR, ignore_errors=True)
    PAR_DIR.mkdir(parents=True)
    phase_parallel_codec(device, card)
    ckpt, stats_ranks = phase_parallel_train(device, card)
    phase_parallel_cli(device, card, ckpt, stats_ranks)
    shutil.rmtree(PAR_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# slice 19: reference checkpoints, the blocked archive, the entry points,
# the five-stage pipeline (the native WAV codec is in cli_path)
# ---------------------------------------------------------------------------

IMPORT_DIR = ROOT / "build" / "chip_smoke_import"
PIPE_DIR = ROOT / "build" / "chip_smoke_pipeline"
REF_CONFIGS = ROOT / "tools" / "ref_configs"
ENTRY_RTOL = 1e-4                 # and an atol of 1e-4 of each output's peak
# the blocked codec against the plain f32 one: f32 sums in another order
BLOCKED_ATOL = 1e-4               # of the plain output's peak
BLOCKED_FLIPS = 204               # 0.1% of B = 16 x 10 s's 204800 indices
PIPE_STEPS = (1, 1)               # metric, adversarial steps per training
PIPE_BATCH = 4                    # of the configs' 16 (x 9600 samples)


def reference_pkl(path: Path, name: str, steps: int, epochs: int):
    """A golden's reference state dict written as the reference trainer
    writes a checkpoint: {"model": {"generator": sd}, "steps", "epochs"}."""
    data = np.load(GOLDEN / f"{name}.npz")
    sd = {k[len("sd__"):]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("sd__")}
    torch.save({"model": {"generator": sd}, "steps": steps,
                "epochs": epochs}, path)
    return data


def phase_import_path(device):
    """bin/import_ckpt.py on reference-layout .pkl files written from the
    goldens' state dicts, then the imported checkpoints on the card: the
    trained symAD (tools/ref_configs/symAD_short.yaml) through the CLI's
    loader and its default stack="folded" in true f32, the golden's
    indices with 0 flips and y within golden_parity's bars, B1's true-f32
    route launched; the trained HiFiGAN vocoder (vocoder_v1_small.yaml)
    through vocoder_apply_folded in true f32 on the golden's codes, y
    within voc_golden's bar.  Returns the launch counts of the phase."""
    t0 = time.perf_counter()
    shutil.rmtree(IMPORT_DIR, ignore_errors=True)
    IMPORT_DIR.mkdir(parents=True)
    cfg = GeneratorConfig()
    results = {}
    reset_launches()
    data = reference_pkl(IMPORT_DIR / "symad.pkl", "gen_symad_trained",
                         steps=3000, epochs=12)
    ckpt = IMPORT_DIR / "symad" / "checkpoint-3000steps.ckpt"
    import_ckpt.main(["--torch", str(IMPORT_DIR / "symad.pkl"), "--config",
                      str(REF_CONFIGS / "symAD_short.yaml"), "--out",
                      str(ckpt)])
    _, header = load_checkpoint(str(ckpt))
    if header != {"steps": 3000, "imported_from": "symad.pkl",
                  "epochs": 12}:
        raise AssertionError(f"import_path: header {header}")
    tc, _ = codec_test.load_codec(str(ckpt), str(ckpt), stack="folded",
                                  bf16_dots=False, device=device)
    before = read_launches()["resunit_f32"]
    idx, y = tc(data["x"].transpose(0, 2, 1))
    torch.cuda.synchronize()
    b1 = read_launches()["resunit_f32"] - before
    flat = np.arange(cfg.codebook_num)[:, None] * cfg.codebook_size
    flips = int((idx[0].cpu().numpy().T + flat != data["idx_stream"]).sum())
    y = y.cpu().numpy().transpose(0, 2, 1)
    if flips or b1 == 0:
        raise AssertionError(f"import_path: {flips} index flips, {b1} B1 "
                             f"launches")
    np.testing.assert_allclose(y, data["y"], rtol=1e-3, atol=1e-4)
    results["gen_symad_trained"] = {
        "index_flips": flips, "frames": int(data["idx_stream"].shape[1]),
        "max_abs_err": float(np.abs(y - data["y"]).max()),
        "resunit_f32_launches": b1}

    data = reference_pkl(IMPORT_DIR / "voc.pkl", "voc_v1_small_trained",
                         steps=3000, epochs=12)
    vckpt = IMPORT_DIR / "voc" / "checkpoint-3000steps.ckpt"
    import_ckpt.main(["--torch", str(IMPORT_DIR / "voc.pkl"), "--config",
                      str(REF_CONFIGS / "vocoder_v1_small.yaml"), "--out",
                      str(vckpt)])
    vcfg = generator_config(load_config(str(vckpt.parent / "config.yml")))
    tree, _ = load_only_params(str(vckpt))
    p = tree_map(lambda a: a.to(device), vocoder_params_from_jax(tree))
    before = read_launches()["resunit_f32"]
    yv = fast.vocoder_apply_folded(
        p, torch.from_numpy(data["zq"].transpose(0, 2, 1)).to(device), vcfg,
        bf16_dots=False)
    torch.cuda.synchronize()
    b1 = read_launches()["resunit_f32"] - before
    yv = yv.cpu().numpy().transpose(0, 2, 1)
    if b1 == 0:
        raise AssertionError("import_path: the vocoder launched no B1")
    np.testing.assert_allclose(yv, data["y"], rtol=1e-3, atol=1e-5)
    results["voc_v1_small_trained"] = {
        "samples": int(data["y"].shape[-1]),
        "max_abs_err": float(np.abs(yv - data["y"]).max()),
        "resunit_f32_launches": b1}
    launches = read_launches()
    if launches != launch_counts(resunit_f32=launches["resunit_f32"]):
        raise AssertionError(f"import_path: kernel launches {launches}")
    shutil.rmtree(IMPORT_DIR, ignore_errors=True)
    emit("import_path", t0, imported=results, launches=launches)
    return launches


def phase_blocked_path(device, params, x, idx_main, card: str):
    """archive/fast_experiments.py's blocked encoder and decoder
    (archive/blocked.py's block-packed stacks, plain convs) on main_path's
    input in f32: ms and peak memory; no kernel launched, as JAX's blocked
    path runs no pallas_call.  Held to the plain f32 transcode
    (autoencoder.py's encoder_apply / decoder_apply) of the same input:
    the encoder's features within BLOCKED_ATOL of their peak, at most
    BLOCKED_FLIPS index flips, and the blocked decoder on the plain
    transcode's codes within BLOCKED_ATOL of the plain waveform's peak.
    The flips of both against main_path's indices are printed."""
    t0 = time.perf_counter()
    cfg = GeneratorConfig()
    p = on_device(params, device)
    blocked = (fast_experiments.encoder_apply_blocked,
               fast_experiments.decoder_apply_blocked)

    @torch.no_grad()
    def transcode(v, enc, dec):
        h = enc(p["encoder"], v, cfg)
        z = projector_apply(p["projector"], h, cfg)
        zq, i = rvq_forward_index(z, p["quantizer"])
        return h, zq, i, dec(p["decoder"], zq, cfg)

    reset_launches()
    h, _, idx, y = transcode(x, *blocked)
    torch.cuda.synchronize()
    launches = no_kernel_launches("blocked_path")
    check_transcode(idx, y, x, cfg)
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: transcode(x, *blocked), reps=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del y
    h_plain, zq_plain, idx_plain, y_plain = transcode(x, encoder_apply,
                                                      decoder_apply)
    with torch.no_grad():
        y_cross = blocked[1](p["decoder"], zq_plain, cfg)
    errs = {"features": float((h - h_plain).abs().max()
                              / h_plain.abs().max()),
            "waveform": float((y_cross - y_plain).abs().max()
                              / y_plain.abs().max())}
    flips = int((idx != idx_plain).sum())
    summary = {"card": card, "transcode_ms": ms,
               "rtf": BATCH * SECONDS / (ms / 1e3),
               "peak_memory_gib": peak,
               "max_abs_err_over_peak_vs_plain_f32": errs,
               "index_flips_vs_plain_f32": flips,
               "index_flips_vs_main_path": int((idx != idx_main).sum()),
               "plain_f32_index_flips_vs_main_path": int(
                   (idx_plain != idx_main).sum()),
               "indices": int(idx.numel())}
    print("blocked_path " + json.dumps(summary), flush=True)
    if max(errs.values()) > BLOCKED_ATOL or flips > BLOCKED_FLIPS:
        raise AssertionError(
            f"blocked_path: against the plain f32 transcode {errs} (bar "
            f"{BLOCKED_ATOL} of the peak), {flips} index flips (bar "
            f"{BLOCKED_FLIPS})")
    emit("blocked_path", t0, **summary, launches=launches)
    return launches


def phase_entry_path(device, card: str):
    """entry.py on the card: entry()'s fn (symAD's eval forward at full
    width) on the example's zero input and on a seeded input of its shape
    (with the zero biases of generator_init the zero input codes every
    frame alike), each against the same fn on the CPU within ENTRY_RTOL
    and an atol of 1e-4 of each output's peak, timed on the seeded input;
    then dryrun_multichip(4), four ranks of this card on gloo."""
    t0 = time.perf_counter()
    fn, (params, x) = entry.entry(device)
    seeded = torch.from_numpy((0.1 * np.random.default_rng(SEED)
                               .standard_normal(tuple(x.shape)))
                              .astype(np.float32)).to(device)
    reset_launches()
    outs = [fn(params, v) for v in (x, seeded)]
    torch.cuda.synchronize()
    launches = no_kernel_launches("entry_path")
    ms = cuda_ms(lambda: fn(params, seeded), reps=3)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    errs = {}
    for which, v, out in zip(("example", "seeded"), (x, seeded), outs):
        ref = fn(cpu_params, v.cpu())
        for name, got, want in zip(("y", "zq", "vqloss"), out, ref):
            got, want = got.cpu().numpy(), want.numpy()
            np.testing.assert_allclose(got, want, rtol=ENTRY_RTOL,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=f"entry_path {which} {name}")
            errs[f"{which}_{name}"] = float(np.abs(got - want).max())
    zq = outs[1][1].reshape(-1, outs[1][1].shape[-1])
    codes = int(torch.unique(zq, dim=0).shape[0])
    if codes < 2:
        raise AssertionError("entry_path: the seeded input coded every "
                             "frame alike")
    t1 = time.perf_counter()
    lines = entry.dryrun_multichip(4, device)
    summary = {"card": card, "forward_ms_seeded": ms,
               "max_abs_err_vs_cpu": errs, "distinct_codes_seeded": codes,
               "dryrun_seconds": time.perf_counter() - t1,
               "dryrun": lines[0]}
    print("entry_path " + json.dumps(summary), flush=True)
    emit("entry_path", t0, **summary, launches=launches)


def phase_pipeline_path(card: str):
    """bin/codec_pipeline.py --start 0 --stop 4 on the card: the shipped
    symAD, statistic and AD v1 vocoder configs at their full widths, cut to
    PIPE_STEPS steps of each training stage on batches of PIPE_BATCH, over
    train_path's seeded corpus (and 2 test wavs of 1 s); each stage a
    process of its own.  Every stage's output is read back: the final
    checkpoints, the statistics, the two decodes' wavs (finite, the test
    wavs' lengths)."""
    t0 = time.perf_counter()
    shutil.rmtree(PIPE_DIR, ignore_errors=True)
    data = PIPE_DIR / "data"
    rng = np.random.default_rng(SEED + 19)
    train_corpus(data, rng)
    (data / "test").mkdir()
    for i in range(2):
        write_wav(str(data / "test" / f"t{i}.wav"), 0.3 * np.sin(
            np.arange(SR) * rng.uniform(0.01, 0.2))[:, None], SR)
    metric, adv = PIPE_STEPS
    steps = dict(save_interval_steps=metric + adv,
                 eval_interval_steps=metric + adv, log_interval_steps=1)
    ae_tag, voc_tag = PIPE_DIR / "ae", PIPE_DIR / "voc"
    stats = PIPE_DIR / "stats.npy"
    ae = cut_config(SYMAD_YAML, data, metric, adv, batch_size=PIPE_BATCH,
                    **steps)
    st = dict(load_config(str(STATISTIC_YAML)), data=ae["data"],
              stats=str(stats))
    voc = cut_config(VOCODER_YAML, data, metric, adv, batch_size=PIPE_BATCH,
                     analyzer=str(ae_tag / "checkpoint-final.ckpt"),
                     **steps)
    voc["generator_params"] = dict(voc["generator_params"], stats=str(stats))
    paths = {}
    for name, cfg in (("ae", ae), ("stats", st), ("voc", voc)):
        paths[name] = PIPE_DIR / f"{name}.yaml"
        paths[name].write_text(dump_yaml(cfg))
    out = ROOT / "checkpoint-final-checkpoint-final"  # codec_test's default
    shutil.rmtree(out, ignore_errors=True)
    try:
        ran = codec_pipeline.main([
            "--start", "0", "--stop", "4", "--ae_config", str(paths["ae"]),
            "--voc_config", str(paths["voc"]), "--stats_config",
            str(paths["stats"]), "--ae_tag", str(ae_tag), "--voc_tag",
            str(voc_tag)])
        if ran != [0, 1, 2, 3, 4]:
            raise AssertionError(f"pipeline_path: ran stages {ran}")
        headers = {tag.name: load_checkpoint(
            str(tag / "checkpoint-final.ckpt"))[1]["steps"]
            for tag in (ae_tag, voc_tag)}
        if headers != {"ae": metric + adv, "voc": metric + adv}:
            raise AssertionError(f"pipeline_path: final steps {headers}")
        written = np.load(stats)
        if written.shape != (2, 64) or not np.all(np.isfinite(written)):
            raise AssertionError(f"pipeline_path: stats {written.shape}")
        for i in range(2):
            y, sr = read_wav(str(out / f"t{i}_output.wav"))
            if y.shape != (SR, 1) or sr != SR or not np.all(np.isfinite(y)):
                raise AssertionError(f"pipeline_path: t{i} decoded to "
                                     f"{y.shape}")
    finally:
        shutil.rmtree(out, ignore_errors=True)
        shutil.rmtree(PIPE_DIR, ignore_errors=True)
    summary = {"card": card, "stages": ran, "steps": list(PIPE_STEPS),
               "seconds": time.perf_counter() - t0}
    print("pipeline_path " + json.dumps(summary), flush=True)
    emit("pipeline_path", t0, **summary)


def module_phases(device, card: str, params, x, idx_main) -> dict:
    """Slice 19's phases after cli_path -> their launch counts by path."""
    launches = {"import_path": phase_import_path(device),
                "blocked_path": phase_blocked_path(device, params, x,
                                                   idx_main, card)}
    phase_entry_path(device, card)
    phase_pipeline_path(card)
    return launches


def phase_build(kernels=KERNELS):
    """One nvcc per kernel source, all started together."""
    t0 = time.perf_counter()

    def build(name):
        t1 = time.perf_counter()
        lib = _build.build(name)
        _build.load(name)
        return {"library": str(lib), "seconds": time.perf_counter() - t1}

    with ThreadPoolExecutor(len(kernels)) as pool:
        built = dict(zip(kernels, pool.map(build, kernels)))
    emit("build", t0, kernels=built)


def kernel_entry(name, mode, counter, source, replaces, rows,
                 launches_by_path, path):
    """One kernel's entry of the `kernels` line: its launches on `path` and
    on every path (read from the `counter` count), and its rows' times and
    bounds summed."""
    worst = max(rows, key=lambda r: r["bound_ms"])
    return {
        "name": name,
        "mode": mode,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches_by_path[path][counter],
        "launches_by_path": {p: n[counter]
                             for p, n in launches_by_path.items()},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": worst["bound_by"],
        "library_ms": summed(rows, "library_ms"),
        "chain_ms": summed(rows, "chain_ms"),
        "per_launch": rows,
    }


def summed(rows, key):
    """The rows' `key` summed, or None where a row has none."""
    vals = [r.get(key) for r in rows]
    return None if None in vals else sum(vals)


def main():
    if sys.argv[1:] not in ([], ["train"], ["parallel"], ["modules"],
                            ["mma"], ["wide"]):
        sys.exit("usage: python3 chip_smoke.py [train | parallel | "
                 "modules | mma | wide]")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    t0 = time.perf_counter()
    device = require_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit("device", t0, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvidia_smi=card)

    if sys.argv[1:] == ["mma"]:
        phase_build(("folded_stack_mma",))
        params = load_golden("gen_symad_trained")[1]
        phase_mma_kernel_vs_plain(params, device)
        phase_mma_parent_ab(params, device)
        return
    if sys.argv[1:] == ["wide"]:
        phase_build(("wide_stack_mma", "resunit_stack", "int8_mma_stack",
                     "int8_tile_mma"))
        phase_wide_kernel_vs_plain(device)
        phase_wide_c_kernel_vs_plain(device)
        phase_wide_voc_kernel_vs_plain(device)
        phase_wide_parent_ab(device)
        return
    phase_build()
    if sys.argv[1:] == ["train"]:
        train_phases(device, card)
        return
    if sys.argv[1:] == ["parallel"]:
        parallel_phases(device, card)
        return
    if sys.argv[1:] == ["modules"]:
        _, _, tc, x, idx, params = phase_main_path(device)
        del tc
        phase_cli_path(params)
        module_phases(device, card, params, x, idx)
        phase_batchfold_path(device, params, x, card)
        return
    _, trained = load_golden("gen_symad_trained")
    phase_kernel_vs_plain(trained, device)
    phase_voc_kernel_vs_plain(device)
    mma_counts, other_rows = phase_mma_kernel_vs_plain(trained, device)
    phase_int8_kernel_vs_plain(trained, device)
    phase_int8_tile_kernel_vs_plain(trained, device)
    wide_counts = phase_wide_kernel_vs_plain(device)
    phase_wide_c_kernel_vs_plain(device)
    phase_wide_voc_kernel_vs_plain(device)
    phase_f32_unit_kernel_vs_plain(device)
    phase_resunit_kernel_vs_plain(trained, device)
    z_main = phase_rvq_kernel_vs_plain(trained, device)
    dot_rows = phase_dot_chain_vs_plain(device)
    ablate_rows = phase_ablate_kernel_vs_plain(device)
    golden_launches = phase_golden(device)
    voc_golden_launches = phase_voc_golden(device)
    t1 = time.perf_counter()
    narrow_f32_rows = f32_timing(
        trained, device, torch.Generator(device=device).manual_seed(SEED + 12))
    emit("f32_timing", t1, rows=narrow_f32_rows)
    phase_fused_golden(device)
    ae_launches, ae_rows, tc, x, idx, params = phase_main_path(device)
    phase_profile("main_path", tc, x)
    voc_launches, voc_rows, tc_v1 = phase_ad_v1_path(device, params, x, idx)
    phase_profile("ad_v1_path", tc_v1, x)
    del tc_v1
    int8_launches, int8_rows, tc_int8 = phase_int8_path(device, params, x,
                                                        idx)
    phase_profile("int8_path", tc_int8, x)
    del tc_int8
    phase_cli_path(params)
    module_launches = module_phases(device, card, params, x, idx)
    fused_launches, resunit_rows, rvq_rows, fused = phase_fused_path(
        device, params, x, z_main)
    phase_profile("fused_path", fused, x)
    del fused
    mxu_launches, dot_rows = phase_mxu_rate_path(dot_rows)
    ablate_launches, ablate_rows = phase_ablate_path(ablate_rows, device)
    probe_counts, probe_records = phase_folded_probe_path()
    t1 = time.perf_counter()
    tile_rows, wide_rows, fold_rows, f32_rows = probe_kernel_rows(
        probe_records, device)
    emit("probe_kernel_rows", t1, int8_tile_mma=tile_rows,
         wide_autoencoder=wide_rows, true_f32_autoencoder=f32_rows,
         int8_stack_at_folds=fold_rows)
    phase_stream_golden(device)
    stream_idx = phase_stream_path(device, params, card)
    phase_stream_ad_v1_path(device, params, stream_idx, card)
    phase_variants_path(device)
    phase_demo_file_path(device, params)
    phase_batchfold_path(device, params, x, card)
    serve_launches = phase_serve_path(device, params, card)
    phase_stream_tools_path(device, params, card)
    voc_train_launches = train_phases(device, card)
    parallel_phases(device, card)

    by_path = {"main_path": ae_launches, "ad_v1_path": voc_launches,
               "int8_path": int8_launches, "fused_path": fused_launches,
               "mxu_rate_path": mxu_launches, "ablate_path": ablate_launches,
               "folded_probe_path": probe_counts,
               "serve_path": serve_launches,
               "voc_train_path": voc_train_launches,
               "golden_parity": golden_launches,
               "voc_golden": voc_golden_launches,
               "mma_kernel_vs_plain": mma_counts,
               "wide_kernel_vs_plain": wide_counts, **module_launches}
    folded = "audiodec_tpu/ops/pallas/folded_stack.py:372"
    mma = "audiodec_tpu_torch/csrc/folded_stack_mma.cu"
    print(json.dumps({"kernels": [
        kernel_entry("folded_residual_stack",
                     "tensor cores, autoencoder units", "mma", mma, folded,
                     ae_rows, by_path, "main_path"),
        kernel_entry("folded_residual_stack", "tensor cores, vocoder units",
                     "mma_voc", mma, folded, voc_rows, by_path,
                     "ad_v1_path"),
        kernel_entry("folded_residual_stack",
                     "tensor cores, other unit shapes", "mma_other", mma,
                     folded, other_rows, by_path, "mma_kernel_vs_plain"),
        kernel_entry("folded_residual_stack", "int8", "int8",
                     "audiodec_tpu_torch/csrc/int8_mma_stack.cu", folded,
                     int8_rows, by_path, "int8_path"),
        kernel_entry("fused_residual_stack", "f32", "resunit",
                     "audiodec_tpu_torch/csrc/resunit_stack.cu",
                     "audiodec_tpu/archive/resunit_kernel.py:118",
                     resunit_rows, by_path, "fused_path"),
        kernel_entry("rvq_encode_pallas", "f32", "rvq",
                     "audiodec_tpu_torch/csrc/rvq_encode.cu",
                     "audiodec_tpu/archive/vq_kernel.py:78", rvq_rows,
                     by_path, "fused_path"),
        kernel_entry("make_pallas_chain", "bf16/int8/f32 x chained/"
                     "independent", "dot_chain",
                     "audiodec_tpu_torch/csrc/dot_chain.cu",
                     "tools/mxu_rate_probe.py:64", dot_rows, by_path,
                     "mxu_rate_path"),
        kernel_entry("build", "default/tree/im2col/noelu/noshift", "ablate",
                     "audiodec_tpu_torch/csrc/ablate_stack.cu",
                     "tools/folded_ablate.py:138", ablate_rows, by_path,
                     "ablate_path"),
        kernel_entry("folded_residual_stack", "int8, tile scales",
                     "int8_tile", "audiodec_tpu_torch/csrc/int8_tile_mma.cu",
                     folded, tile_rows, by_path, "folded_probe_path"),
        kernel_entry("folded_residual_stack",
                     "C > 32, bf16 operands, every unit shape", "wide",
                     "audiodec_tpu_torch/csrc/wide_stack_mma.cu", folded,
                     wide_rows, by_path, "folded_probe_path"),
        kernel_entry("folded_residual_stack",
                     "true f32, every width and unit shape", "resunit_f32",
                     "audiodec_tpu_torch/csrc/resunit_stack.cu", folded,
                     narrow_f32_rows + f32_rows, by_path, "golden_parity"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
