#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rtfs_net_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root; needs one CUDA card and nvcc

Phases (any failure exits non-zero before the final line):

1. preconditions: a CUDA card; prints ``nvidia-smi``'s name and power limit.
2. build: the four kernel sources (``csrc/sru_stack_layer.cu``, the
   inference SRU kernel K1; ``csrc/sru_train.cu``, the training SRU
   kernels K2; ``csrc/dw_conv.cu``, the depthwise stencil K3;
   ``csrc/sru_direction.cu``, the per-direction SRU kernel K4) with one
   ``nvcc`` each, started together, into
   ``rtfs_net_tpu_torch/csrc/build/``, and beside them the native PESQ and
   crc32c extension from ``native/`` (g++), timed.
3. kernel K1: against its plain PyTorch version on the card, at the
   shapes the serving forward gives it at B = 1, 4, 16 (float32 and
   bfloat16) and B = 128 (bfloat16), with times, the bound and sums per
   forward; and at edge shapes (``SRU_EDGE``: L = 1 and 2, rows 125, 63
   and 500, k = 3 and 4, one and two directions, a slice at an odd offset)
   in both dtypes. Fails unless both the ring and the narrow kernel ran.
   ``torch.library.opcheck`` of the registered op ``rtfs::sru_stack_layer``
   on small edge shapes (k = 3 and 4, one direction, bfloat16 at an odd
   offset): schema, fake implementation against the kernel's outputs,
   autograd registration, AOT dispatch.
4. kernel K3: against its plain version at (B, 64, 251, 129) and
   (B, 64, 125, 64) for B = 16 and 128 with the 4x4 kernel and pads (1, 2)
   of the main path, and at small shapes with a 3x3, a 2x3 and a 7x2
   kernel, float32 and bfloat16, with times, the bound and the time of
   ``F.pad`` + ``F.conv2d(groups=C)`` on the same inputs; its backward
   against autograd through the plain version; edge cases (odd F, T not a
   multiple of the band, B*C = 1, x a slice at an odd offset, uneven pads,
   other kernels), forward and dx, in both dtypes; ``opcheck`` of
   ``rtfs::dw_conv2d_same`` on three edge cases.
5. kernel K4: against its plain version at the serving shapes of B = 1,
   4, 16 ((57, 125 B, 32) and (118, 64 B, 32)), both directions, on slices
   of one projection, float32 and bfloat16, with times and the bound; and
   at edge shapes (``SRU_DIR_EDGE``: L = 1 and 2, rows 125, 63 and 500, odd
   H, slices at odd offsets). Fails unless both the ring and the narrow
   kernel ran. ``opcheck`` of ``rtfs::sru_direction`` on slices, one at an
   odd offset.
6. serving: RTFS-Net-4 at full width (random weights from seed 0) answers
   requests of 2 s mixtures plus (B, 512, 50) lip embeddings at B = 1, 4,
   16 through ``separate()``; K1 must launch exactly 32 times and K3
   exactly 40 times per forward, K2 and K4 never; B=1 in float32 is held
   against the same model on the CPU; ms per forward and per utterance in
   float32 and bfloat16. Then the JAX package's ``bench.py`` serving point:
   (128, 512, 50) lip embeddings in bfloat16, timed as ``bench.py`` times
   it (one warm-up call, then the minimum of 6 calls, each on distinct
   inputs, beside their median), with the launch counts of every call and
   peak memory.
7. serving from frames: the same model behind the FRCNN video model
   (ResNet-18 trunk, random weights from seed 0) answers requests of 2 s
   mixtures plus raw (B, 1, 50, 88, 88) mouth-ROI frames at B = 1, 4, 16 in
   float32 and bfloat16 and at B = 128 in bfloat16, with the same launch
   counts; B=1 in float32 against the two models on the CPU; ms per
   forward and per utterance, and peak memory at B = 128.
8. the per-direction pass: the B=16 float32 request from frames with
   ``DEFAULT_SRU_BACKEND = "pallas"``: exactly 64 K4 launches, no K1, the
   output held against the ``"scan"`` pass; ms per forward of both.
9. profile: ``torch.profiler`` over a few forwards per (dtype, B), from
   embeddings and from frames: wall and device busy time, idle share,
   kernel launches, device time by kernel category and the top kernels;
   fails if K1's or K3's category shows no time.
10. kernel K2: its forward and backward against their plain versions at
   the four shapes the B=4 and B=16 train steps give them, k = 3 and 4,
   float32 and bfloat16, with times and bounds; and at edge shapes (rows
   125, 63 and 500, L = 1 and 2, k = 3 and 4, one and two directions,
   operands sliced at an odd offset) in both dtypes; ``opcheck`` of
   ``rtfs::sru_train_forward`` and ``rtfs::sru_train_backward`` on K1's
   edge cases.
11. training: ``System.train_step`` of RTFS-Net-4 at full width (AdamW lr
   1e-3, wd 0.1, clip 5.0, PIT neg-SNR; the target is the mixture) at
   B = 4 and 16, in float32 and with ``compute_dtype=bfloat16``: each step
   launches K2's forward exactly 64 times (32 layers, and again in the
   checkpointed blocks' recompute), its backward 32 times, K3 120 times
   (40 convs, their recompute, and the 40 input gradients) and K1 never;
   loss and grad norm finite; median ms per step and peak memory.
12. train parity: one float32 B=1 step (dropout off) on the card against
   the same step on the CPU: the loss and every gradient.
13. train profile: ``torch.profiler`` over one B=16 bfloat16 step; fails
   if K2's or K3's category shows no time.
14. fit: the training entry point ``rtfs_net_tpu_torch.train.main`` on a
   synthetic LRS2-style manifest in a temporary directory (16 train and 8 validation
   target-speaker items: 2 s wavs and 50x96x96 uint8 mouth tracks), at full
   width with the FRCNN video model from frames (frozen, weights from seed
   0: the config's pretrained backbone is not in the repository), batch 4,
   float32, process loader workers, 2 epochs. Every train step launches K2
   forward 64 times, K2 backward 32, K3 120 and K1 never; every validation
   batch K1 32 and K3 40. Losses finite; the ledger, ``last.json``, the
   TensorBoard events and ``best_model.pth`` on disk. Then a third epoch
   that SIGTERM interrupts after its second step ('preempt' saved), and a
   fresh run that resumes from it (parameters and optimizer state equal to
   the checkpoint's, bit for bit) and finishes the epoch. The exported
   ``best_model.pth``, reloaded with ``serialization.load_model``, holds
   the checkpoint's tensors and separates a validation batch exactly as
   the checkpoint's model does, both run with cuDNN's deterministic
   algorithms (without them two runs of one model differ by ~2e-7). A ``fit``
   line: ms per train step and validation batch, epoch wall time, the share
   of it spent waiting on the loaders, launches per step, peak memory.
15. evaluate: the evaluation entry point ``rtfs_net_tpu_torch.test.main`` on
   the experiment ``fit`` exported, over a synthetic LRS2-style test
   manifest (12 mixtures of 1.2-4.0 s, 24 target-speaker items with uint8
   mouth tracks; the dataset crops each to 2 s, as the reference's does),
   buckets of 4000 samples, eval batch 8 (the fit batch x 2), float32.
   Every batch launches K1 32 and K3 40 times and nothing else;
   ``metrics.csv`` has 24 rows plus ``avg``/``std`` with finite SI-SNR,
   SDR, STOI and PESQ, PESQ from the native extension; ``results.csv`` has
   the JAX CLI's rows; the first 6 items run again one at a time through
   the engine give SI-SNR and SDR within 1e-3 dB of the batched run. An
   ``evaluate`` line: utterances per second, device ms per batch, the
   host's wait on the card and the scoring pool's idle time, scoring ms per
   utterance, peak memory, beside the card's name and power limit.
16. separate: ``rtfs_net_tpu_torch.separate`` on a 6 s wav with its mouth
   track, plain and in 2 s chunks, each one forward of K1 32 and K3 40
   launches; the outputs finite and of the input's length.
17. export: ``python -m rtfs_net_tpu_torch.export_serving`` on the
   experiment ``fit`` exported, float32, buckets (1, 4), traced on the
   card: each bucket's graph holds 32 ``rtfs::sru_stack_layer`` and 40
   ``rtfs::dw_conv2d_same`` nodes and no other ``rtfs::`` node. Loaded with
   ``export.load_artifact``, it serves requests of B = 1, 3 (padded to 4),
   4 and 5 (4 + 1), each within 1e-5·max|ref| of the same weights run
   eagerly under cuDNN's deterministic algorithms, each bucket call
   launching K1 32 and K3 40 times and nothing else. ``separate --model
   model.rtfsx`` on 2 s of phase 16's wav with its 50 frames (one B=1
   call: finite, the input's length), and its refusal of the 6 s wav
   without ``--chunk-seconds``. Then the serving phase's random-weight
   model exported at B = 128 in bfloat16 (``bench.py``'s point), timed
   beside the eager model in turns; an ``export`` line: export seconds per
   bucket, artifact MB, load seconds, ms per call eager and artifact at
   B=1 float32 and B=128 bfloat16, launches, peak memory.
18. ctcnet: CTCNet-16 (``configs/lrs2_CTCNet_16_layer.yaml``, the paper's
   time-domain baseline: Conv1d encoder, 16 repeats of one weight-shared
   FRCNN block, a BatchNorm1d video FRCNN, ConcatFusion, ConvTranspose1d
   decoder) at full width, random weights from seed 0. It runs none of
   K1-K4 (no SRU; its depthwise convs are 1-D), and every call below
   launches none of them. ``separate()`` from (B, 512, 50) embeddings at
   B = 1, 4, 16 and from (4, 1, 50, 88, 88) frames through the video model,
   float32 and bfloat16; B=1 float32 against the same model on the CPU
   within 5e-4·max|ref|; ms per forward (median of 7). ``System.train_step``
   at B = 4 in both dtypes: finite loss and grad norm, the video FRCNN's
   BatchNorm statistics moved; ms per step; a float32 B=1 step against the
   CPU (phase 12's tolerances). ``train.main`` with the CTCNet YAML for one
   epoch on ``fit``'s manifest (batch 4, float32); its ``best_model.pth``
   reloaded with ``load_model`` and exported by ``export_serving`` at B=1
   float32 (no ``rtfs::`` node), one call within 1e-5·max|ref| of eager
   under cuDNN's deterministic algorithms. ``test.main`` on that
   experiment over the evaluate phase's manifest (finite metrics) and the
   ``separate`` CLI on phase 16's 6 s wav. MACs of a 2 s forward within 5%
   of the paper's 167.2 G; a ``profile`` line of a B=16 bfloat16 forward; a
   ``ctcnet`` line (ms per forward and per utterance, ms per step, peak
   memory, MACs, parameters, device busy and idle share, the card).
19. video_zoo: the video front-end's other backbones and the last two
   CLIs. K3 against its plain version at ShuffleNetV2's planes (B = 4:
   (200, 58, 11, 11), (200, 116, 6, 6), (200, 232, 3, 3), 3x3, pads (1, 1)),
   forward and dx, both dtypes, with device times (median of 6), the bound
   and ``F.conv2d(groups=C, padding=1)``'s time. RTFS-Net-4 served from
   frames through the FRCNN video model with a ShuffleNetV2 trunk (width
   1.0, a 1024-channel embedding) at B = 1, 4, 16 in both dtypes and 128 in
   bfloat16: K1 32 and K3 53 launches a forward (40 audio, 13 video); B=1
   float32 against the CPU; ms per forward and peak memory; a ``profile``
   line of the B=128 bfloat16 forward. The video model alone at each width (0.5, 1.0, 1.5, 2.0), B=1 against the CPU. ``train_autoencoder.main`` on a
   synthetic mouth-track manifest (2 epochs, batch 4): finite losses,
   ``best_model.ckpt`` and ``best_k_models.json``; the checkpoint loaded
   into ``AEVideoModel`` through ``train.build_video_model``; RTFS-Net-4
   with a 1936-channel embedding (a 1x1 video bottleneck to 512 channels)
   served through it at B = 1, 4 in both
   dtypes (B=1 float32 against the CPU), and one ``System.train_step`` at
   B = 4 with ``train_video_model`` (K2 64 + 32, K3 120) that moves every
   AE parameter. ``find_unused_params.main`` at full width on the card (K2
   32 + 32, K3 80) lists what it lists on the CPU. A ``video_zoo`` line.
20. bench: the port's benchmark, ``python -m rtfs_net_tpu_torch.bench``, in
   a process of its own (the JAX package's ``bench.py`` point: serving
   RTFS-Net-4 from (128, 512, 50) embeddings in bfloat16, and
   ``System.train_step`` in bfloat16 at B = 4 and 16; one warm-up, then
   the minimum of 6 calls on distinct inputs): its last line has exactly
   ``bench.py``'s nine keys, every value finite, its serving time per
   utterance within 15% of phase 6's benchmark point in this run; K1 32
   and K3 40 launches per serving call, K2 64 + 32 and K3 120 per step,
   nothing else. A ``bench`` line, then the bench's own line.
21. parallel: NCCL over ``torch.cuda.device_count()`` ranks, meeting
   through a file (one card: this process is rank 0 of 1): a DDP +
   SyncBatchNorm train step of RTFS-Net-4 at full width (B = 4, float32,
   SGD: the card's plain step is itself nondeterministic at ~1e-7·max|g|,
   which AdamW's first update magnifies) against the plain
   ``System.train_step`` on the same batch and seed under cuDNN's
   deterministic algorithms: loss, parameters and BatchNorm buffers within
   1e-6, gradients within 1e-6·max|g|; K2 64 + 32 and K3 120 launches; a
   second DDP step; ``dryrun.dryrun_multichip`` over the ranks (one step
   from raw frames with the video model training, then the sharded
   evaluation); ``train.main`` for one epoch on phase 14's manifest,
   data-parallel. A ``parallel`` line with the card count (a run over two
   or more cards is still to come).
22. layer_zoo: the layers no shipped config uses, at full width.
   RTFS-Net-4 with LSTM DualPathRNNs (``rnn_type: LSTM``, cuDNN's
   recurrence in float32) served from embeddings at B = 1, 4, 16 in both
   dtypes (K3 40 a forward, no K1; B=1 float32 against the CPU) and one
   bfloat16 ``System.train_step`` at B = 4 (K3 120, no K2); one
   DualPathRNN alone at B = 16 with the LSTM against the SRU (K1), and
   the LSTM module against ``nn.LSTM`` with flattened weights (what the
   per-call weight list costs). An AVNet whose audio net is a DPTNet
   (hid 64, 4 shared repeats at the full 251 x 129 plane: an SRU
   DualPathRNN along F, a GRU one along T, a GlobalAttention2D with its
   group FFN) and whose video net is a 1-D DPTNet (GlobalAttentionRNN, a
   GlobalAttention with a ConvolutionalRNN FFN), served the same way and
   trained a step at B = 4, with the K1, K2 and K3 launches its config
   gives (``dpt_launches``), K1, K2 and K3 held first against their plain
   versions at its shapes (``check_zoo_kernels``). Every other new layer
   alone at C = 64, B = 2
   (BiLSTM2D, GlobalGALR, CBAMBlock, ShuffleAttention, CoTAttention, MLP,
   Permutator, DepthwiseSeparableConvolution and ConvolutionalRNN in 2-D,
   DualPathRNN Attn with its FFN): float32 against the CPU within
   5e-4·max|ref|, bfloat16 finite, K3 where a 2-D depthwise conv runs.
   All 29 optimizer names, 7 steps each over RTFS-Net-4's parameters
   with one gradient, the card against the CPU within 1e-5·max|p|; a
   ``System.train_step`` with ``ranger`` and one with ``adafactor``. A
   ``layer_zoo`` line.
23. a ``{"kernels": [...]}`` line (with each kernel's launches on every
   path), then ``{"ok": true, "device": {...}}`` last.

Every comparison on the card runs with TF32 off (cuDNN convolutions and
matmuls in full float32), and so do the float32 timings.
"""
import collections
import concurrent.futures
import copy
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "rtfs_net_tpu_torch", "configs", "lrs2_RTFSNet_4_layer.yaml")
CTCNET_CONFIG = os.path.join(HERE, "rtfs_net_tpu_torch", "configs",
                             "lrs2_CTCNet_16_layer.yaml")

# H100 SXM peaks (NVIDIA data sheet): HBM rate and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per SRU output element: two gates (3 + sigmoid's 4
# each), the carry update (4), the highway mix (4)
SRU_OPS_PER_ELEMENT = 22
# and per element of the backward sweep (sru_train.cu): the two gates
# again (14), dm (5), dct (2), da (5), du0 and dskip (4), the four gate
# sums (6), the carry (5)
SRU_BWD_OPS_PER_ELEMENT = 41
H = 32
SRU_PASSES = [(57, 125), (118, 64)]  # (L, rows per utterance): the F pass, the T pass
TRAIN_BATCHES = (4, 16)
# (L, rows) of the F and T passes at each train batch
TRAIN_SHAPES = [(L, per_utt * B) for B in TRAIN_BATCHES for L, per_utt in SRU_PASSES]
TRAIN_STEPS = 6  # timed steps per (dtype, B), after one counted step
SRU_LAYERS = {4: 1, 3: 3}  # layers per 4-layer stack with k=4 and k=3 chunks
REPEATS = 4                # TDANet repeats per forward (1 fused + 3 audio-only)
SERVE_BATCHES = (1, 4, 16)
SERVE_REPS = 7  # timed forwards per (dtype, B); small batches are host-bound and noisy
BIG_BATCH = 128  # the batch the JAX package's serving benchmark runs, in bfloat16
BENCH_CALLS = 6  # timed calls at the benchmark's serving point (bench.py: min of 6)
# the fit phase: target-speaker items per split (two per mixture), epochs,
# the reference's per-GPU batch, loader worker processes per split, and
# the epoch and step of the third epoch at which SIGTERM arrives
FIT_ITEMS = {"tr": 16, "cv": 8}
FIT_EPOCHS, FIT_BATCH, FIT_WORKERS, FIT_PREEMPT = 2, 4, 4, (2, 1)
VIDEO_FRAMES, MOUTH_SIZE = 50, 88  # 2 s of 25 fps mouth-ROI frames
# the evaluate phase: mixtures of the test manifest (two target-speaker
# items each), their lengths' range in seconds, the items run again one at a
# time (the first three mixtures), and the separate CLI's input length
EVAL_MIXTURES, EVAL_SECONDS, SERIAL_ITEMS = 12, (1.2, 4.0), 6
EVAL_ITEMS = 2 * EVAL_MIXTURES
EVAL_BUCKET = 4000  # the evaluation entry point's default bucket, samples
SEPARATE_SECONDS, SEPARATE_CHUNK = 6, 2
# the export phase: the bucketed float32 artifact's batch sizes and the
# request batches served through it (3 padded to 4, 5 in chunks of 4 and 1)
EXPORT_BUCKETS, EXPORT_REQUESTS = (1, 4), (1, 3, 4, 5)
# the ctcnet phase: the paper's MACs per 2 s forward (tests/test_macs_paper.py),
# the train batch and timed steps per dtype, the batch served from frames
CTCNET_PAPER_GMACS, CTCNET_TRAIN_BATCH, CTCNET_TRAIN_STEPS, CTCNET_FRAMES_BATCH = 167.2, 4, 3, 4
# the video_zoo phase: ShuffleNet's width served in full and the widths
# checked alone (at seed weights its embedding is ~1e-5 of the mixture's
# scale, so the served output barely sees it); its stride-1 depthwise convs (K3) per video forward by
# (H, W) plane and their channels at width 1.0 (88x88 frames: 44 after the
# front-end conv, 22 after its max-pool, then 11, 6 and 3 through the three
# stages, whose first block downsamples); the batch K3 is timed at there;
# the autoencoder's epochs and batch, its embedding's channels (16 x 11 x
# 11), and the video bottleneck RTFS-Net-4 takes it through: the fusion's
# grouped convs need a multiple of the audio's 256 channels, which 1936 is
# not, so a 1x1 conv to the 512 of the ResNet embedding
SHUFFLE_WIDTH, SHUFFLE_WIDTHS = 1.0, (0.5, 1.0, 1.5, 2.0)
SHUFFLE_DW = {(11, 11): (3, 58), (6, 6): (7, 116), (3, 3): (3, 232)}
SHUFFLE_DW_LAUNCHES = sum(n for n, _ in SHUFFLE_DW.values())  # 13 per video forward
SHUFFLE_PLANE_BATCH, PLANE_TIMINGS = 4, 6
AE_EPOCHS, AE_BATCH, AE_SERVE_BATCHES, AE_EMBEDDING = 2, 4, (1, 4), 1936
AE_VIDEO_BN = {"kernel_size": 1, "out_chan": 512}
# the bench phase: its run's limit in seconds and how far its serving time
# may lie from check_bench_point's; each call's launches: a serving call's
# (the float32 sanity slice, the warm-up and the timed calls) and a train
# step's (the warm-up and the timed steps)
BENCH_TIMEOUT_S, BENCH_SERVING_RTOL, BENCH_TIMED = 600, 0.15, 6
# the parallel phase: the global batch of the DDP step, and its tolerance
# against the plain step (at world size 1 the two are the same arithmetic)
PARALLEL_BATCH, PARALLEL_TOL = 4, 1e-6
# the layer_zoo phase: its DualPathRNN's (C, T, F) plane at B = 16 (the
# TDANet's global features: the F pass is 57 windows of 125·B rows, the T
# pass 118 of 64·B), the batch of the layers alone, the steps each
# optimizer takes (the ranger variants' lookahead syncs at the 6th) and
# the tolerance of the card against the CPU there
ZOO_PLANE, ZOO_LAYER_BATCH, ZOO_OPT_STEPS, ZOO_OPT_TOL = (64, 125, 64), 2, 7, 1e-5
# the DPTNet AVNet's kernel shapes at the full 251 x 129 plane: its SRU
# DualPathRNN along F runs 122 windows of 251·B rows; its group FFN's 5x5
# depthwise refiner runs on 128 channels
ZOO_SRU_PASS, ZOO_DW_CHANNELS, ZOO_DW_KERNEL = (122, 251), 128, (5, 5)
CHANNELS = 64  # TDANet hid_chan: the depthwise convs' channels
DW_PLANES = {(251, 129): 3, (125, 64): 7}  # K3 launches per TDANet block, by (T, F)
DW_KERNEL, DW_PADS = (4, 4), ((1, 2), (1, 2))
DW_LAUNCHES = REPEATS * sum(DW_PLANES.values())  # 40 per forward
SRU_LAUNCHES = REPEATS * 2 * sum(SRU_LAYERS.values())  # 32 per forward: 2 DualPathRNNs
# small K3 cases: (shape, kernel, pads); the last takes the generic kernel
DW_SMALL = [((2, 5, 33, 17), (3, 3), ((1, 1), (1, 1))),
            ((3, 4, 19, 40), (2, 3), ((0, 1), (1, 1))),
            ((2, 3, 21, 9), (7, 2), ((3, 3), (0, 1)))]
# K3 edge cases, forward and dx: (shape, kernel, pads, offset): odd F (129,
# 7), T not a multiple of the band's rows, B*C = 1, x a contiguous slice at
# an odd element offset, uneven pads, other kernels (7x2: the generic one)
DW_EDGE = [((2, 3, 45, 129), (4, 4), ((1, 2), (1, 2)), 0),
           ((2, 3, 45, 7), (4, 4), ((2, 1), (2, 1)), 1),
           ((1, 1, 50, 129), (4, 4), ((0, 3), (0, 3)), 3),
           ((1, 1, 251, 129), (4, 4), ((1, 2), (1, 2)), 1),
           ((3, 2, 37, 64), (3, 3), ((1, 1), (1, 1)), 0),
           ((2, 5, 21, 9), (2, 3), ((0, 1), (1, 1)), 1),
           ((2, 3, 21, 9), (7, 2), ((3, 3), (0, 1)), 0)]
# K1 and K2 edge cases (K2 forward and backward): (L, rows, k, ndir,
# offset); odd rows and a slice at an odd offset take the narrow kernel in
# bfloat16
SRU_EDGE = [(L, rows, k, ndir, 0) for L in (1, 2) for rows in (125, 63, 500)
            for k in (3, 4) for ndir in (1, 2)] + [(57, 500, 3, 2, 1), (57, 125, 4, 2, 0)]
# K4 edge cases: (L, rows, H, offset) of slices of one (L, rows, 4, 2H)
# projection; odd H and an odd offset take the narrow kernel in bfloat16
SRU_DIR_EDGE = [(L, rows, H, 0) for L in (1, 2) for rows in (125, 63, 500)] + [
    (57, 125, 33, 0), (57, 63, 7, 0), (57, 500, 32, 1), (118, 64, 32, 3)]
PROFILE_ITERS, PROFILE_TOP = 3, 6  # profiled forwards per (dtype, B); kernels listed
PROFILE_CATEGORIES = [  # kernel name regexes, first match wins
    ("sru_kernel", r"sru_stack_layer"),
    ("sru_train_kernel", r"sru_train"),
    ("sru_direction_kernel", r"sru_direction"),
    ("dw_conv_kernel", r"dw_conv_(band|generic)"),
    ("fft", r"fft"),
    ("softmax", r"softmax"),
    ("norm_reduce", r"norm|reduce|welford|moments"),
    ("matmul", r"gemm|cutlass|xmma_gemm|sm90_xmma|cublas"),
    ("conv", r"conv|cudnn|implicit|winograd|dgrad|wgrad|xmma|depthwise"),
    ("copy_layout", r"copy|cat|transpose|permute|pad|upsample|index|gather|scatter"),
    ("elementwise", r"elementwise|vectorized|unrolled|prelu|sigmoid|relu|add|mul"),
]
# the kernel categories a serving forward and a train step launch
SERVING_CATEGORIES = ("sru_kernel", "dw_conv_kernel")
TRAIN_CATEGORIES = ("sru_train_kernel", "dw_conv_kernel")
SAMPLES, LIP_CHANNELS, LIP_FRAMES = 32000, 512, 50
# bf16 kernel vs the plain version on the same bf16 inputs: both carry and
# compute in float32 and round once, so they differ by one bf16 ulp where
# the float32 results straddle a rounding boundary. One ulp is 2^-8 to
# 2^-7 of the value, so the limit 2^-7*|ref| + 1e-5 admits one to two ulps.
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5


# cycles of the sleep kernel that timed launches queue behind: ~6 ms, more
# than the host takes to launch 20 wrapper calls
QUEUE_CYCLES = 10_000_000


def fail(msg):
    raise RuntimeError(msg)


def event_ms(fn, reps, warmup=2):
    """Device ms per call of ``fn``: CUDA events around ``reps`` calls that
    queue behind a sleep kernel, so the card runs them back to back and the
    host's time to launch them (tens of us per wrapper call, more than a
    small kernel takes) is not counted."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_modules():
    from rtfs_net_tpu_torch.ops.kernels import dw_conv, sru, sru_direction, sru_train

    return sru, sru_train, dw_conv, sru_direction


def launch_counts():
    """Every wrapper's count of kernel launches, by kernel."""
    from rtfs_net_tpu_torch.bench import launch_counts

    return launch_counts()


def reset_launch_counts():
    ksru, ktrain, kdw, kdir = kernel_modules()
    ksru.launches = ktrain.forward_launches = ktrain.backward_launches = 0
    kdw.launches = kdir.launches = 0


def launches_of(fn, want, what):
    """Run ``fn``, synchronise, and fail unless it launched each kernel
    exactly ``want`` times (kernels not named: never)."""
    import torch

    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    got = {k: n - before[k] for k, n in launch_counts().items()}
    if got != {k: want.get(k, 0) for k in got}:
        fail(f"{what}: launches {got}, want {want} and no others")
    return out


def host_ms(fn, reps):
    """Sorted host-clock times of ``reps`` synchronised calls, in ms."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)


def dtype_name(dtype):
    return str(dtype).split(".")[-1]


def sru_inputs(L, rows, k, dtype, gen, copies):
    import torch

    O = 2 * H
    sets = []
    for _ in range(copies):
        u = torch.randn((L, k * O, rows), generator=gen, device="cuda").to(dtype)
        skip = torch.randn((L, O, rows), generator=gen, device="cuda").to(dtype) if k == 3 else None
        sets.append((u, skip))
    v = 0.5 * torch.randn(2 * O, generator=gen, device="cuda")
    b = 0.5 * torch.randn(2 * O, generator=gen, device="cuda")
    return sets, v, b


def sru_tolerance_ok(got, want, dtype):
    """K1's check: float32 within 1e-5 absolute, bfloat16 ``BF16_ATOL`` +
    ``BF16_RTOL``*|ref|; and finite."""
    import torch

    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        ok = float(err.max()) <= 1e-5
    else:
        ok = bool((err <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())
    return ok and bool(torch.isfinite(got).all()), float(err.max())


def check_sru_kernel():
    """The SRU layer kernel against its plain version at the shapes the
    serving forward gives it at B = 1, 4, 16 (both dtypes) and B = 128
    (bfloat16), with times and bounds (the plain version timed at B = 16),
    then at the ``SRU_EDGE`` shapes. Fails unless both the ring and the
    narrow kernel ran. Returns the sums over the 32 launches of a B=16
    float32 forward."""
    import torch

    from rtfs_net_tpu_torch.ops.kernels import sru as ksru

    gen = torch.Generator(device="cuda").manual_seed(0)
    sums = collections.defaultdict(collections.Counter)  # per (B, dtype) forward
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    depths = set()
    O = 2 * H
    for B in SERVE_BATCHES + (BIG_BATCH,):
        for (L, per_utt), k in itertools.product(SRU_PASSES, (4, 3)):
            rows = per_utt * B
            for dtype in (torch.bfloat16,) if B == BIG_BATCH else (torch.float32, torch.bfloat16):
                item = torch.tensor([], dtype=dtype).element_size()
                nbytes = (k * O + O + (O if k == 3 else 0)) * L * rows * item
                # rotate through input copies totalling > 100 MB so each
                # launch reads from HBM, not from the 50 MB L2
                copies = 1 + int(100e6 // (nbytes - O * L * rows * item))
                sets, v, b = sru_inputs(L, rows, k, dtype, gen, copies)
                u, skip = sets[0]
                depths.add(ksru.launch_plan(rows, O, item))
                got = ksru.sru_stack_layer(u, skip, v, b, H=H, k=k, ndir=2)
                torch.cuda.synchronize()
                want = ksru.sru_stack_layer_ref(u, skip, v, b, H=H, k=k, ndir=2)
                ok, max_abs = sru_tolerance_ok(got, want, dtype)
                if not ok:
                    fail(f"sru_stack_layer L={L} rows={rows} k={k} {dtype}: "
                         f"max_abs_err {max_abs} out of tolerance")
                max_err[dtype] = max(max_err[dtype], max_abs)
                it = itertools.count()

                def kernel():
                    uu, ss = sets[next(it) % copies]
                    ksru.sru_stack_layer(uu, ss, v, b, H=H, k=k, ndir=2)

                ms = event_ms(kernel, reps=20)
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = SRU_OPS_PER_ELEMENT * L * O * rows / FP32_OPS_PER_S * 1e3
                row = {"B": B, "L": L, "rows": rows, "k": k, "dtype": dtype_name(dtype),
                       "depth": ksru.launch_plan(rows, O, item), "max_abs_err": max_abs,
                       "ms": ms, "bound_ms": max(bytes_ms, ops_ms),
                       "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                       "GB_per_s": nbytes / ms / 1e6}
                if B == 16:
                    row["plain_ms"] = event_ms(
                        lambda: ksru.sru_stack_layer_ref(u, skip, v, b, H=H, k=k, ndir=2),
                        reps=2, warmup=1)
                print("sru_stack_layer " + json.dumps(row))
                n = REPEATS * SRU_LAYERS[k]
                acc = sums[(B, dtype_name(dtype))]
                for key, value in (("ms", ms), ("plain_ms", row.get("plain_ms", 0.0)),
                                   ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                    acc[key] += n * value
                del sets, u, skip, got, want
    check_sru_edges(gen, max_err, depths)
    opcheck("sru_stack_layer", sru_op_cases(gen))
    if not (0 in depths and depths - {0}):
        fail(f"sru_stack_layer: launch plans {sorted(depths)} did not run both the ring "
             "and the narrow kernel")
    print(f"sru_stack_layer: max_abs_err float32 {max_err[torch.float32]} "
          f"(tol 1e-5), bfloat16 {max_err[torch.bfloat16]} "
          f"(tol {BF16_ATOL} + {BF16_RTOL}*|ref|); ring depths run {sorted(depths)}")
    return forward_sums("sru_stack_layer", sums, max_err, 32)


def forward_sums(name, sums, max_err, launches):
    """Prints a kernel's sums over the launches of one forward per (B,
    dtype), from ``sums[(B, dtype)]`` of ms, plain_ms (timed at B = 16
    only), bytes_ms and ops_ms; returns the B=16 float32 forward's."""
    import torch

    out = {}
    for (B, dtype), acc in sums.items():
        bytes_ms, ops_ms = acc.pop("bytes_ms"), acc.pop("ops_ms")
        if B != 16:
            acc.pop("plain_ms")
        out[(B, dtype)] = {"max_abs_err": max_err[getattr(torch, dtype)], **acc,
                           "bound_ms": max(bytes_ms, ops_ms),
                           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        print(f"{name} per B={B} {dtype} forward ({launches} launches): "
              + json.dumps(out[(B, dtype)]))
    return out[(16, "float32")]


def check_sru_edges(gen, max_err, depths):
    """K1 against its plain version at the ``SRU_EDGE`` shapes, both dtypes,
    with K1's tolerance; ``offset`` > 0 makes u and skip slices at that
    element offset. Adds each launch's ring depth to ``depths``."""
    import torch

    from rtfs_net_tpu_torch.ops.kernels import sru as ksru

    for L, rows, k, ndir, offset in SRU_EDGE:
        O = H * ndir
        for dtype in (torch.float32, torch.bfloat16):
            u = edge_operand((L, k * O, rows), dtype, offset, gen)
            skip = edge_operand((L, O, rows), dtype, offset, gen) if k == 3 else None
            v, b = (0.5 * torch.randn(2 * O, generator=gen, device="cuda") for _ in range(2))
            depth = ksru.launch_plan(rows, O, u.element_size(), ksru._aligned(u, skip))
            depths.add(depth)
            got = ksru.sru_stack_layer(u, skip, v, b, H=H, k=k, ndir=ndir)
            torch.cuda.synchronize()
            ok, err = sru_tolerance_ok(
                got, ksru.sru_stack_layer_ref(u, skip, v, b, H=H, k=k, ndir=ndir), dtype)
            print("sru_stack_layer edge " + json.dumps({
                "L": L, "rows": rows, "k": k, "ndir": ndir, "offset": offset,
                "dtype": dtype_name(dtype), "depth": depth, "max_abs_err": err}))
            if not ok:
                fail(f"sru_stack_layer edge L={L} rows={rows} k={k} ndir={ndir} "
                     f"offset={offset} {dtype}: max_abs_err {err} out of tolerance")
            max_err[dtype] = max(max_err[dtype], err)


def sru_op_cases(gen):
    """Argument tuples of the SRU layer ops at small edge shapes: k = 3 with
    skip, k = 4 without, one direction, and bfloat16 operands at an odd
    element offset (the narrow kernel)."""
    import torch

    cases = []
    for L, rows, k, ndir, offset, dtype in ((2, 63, 3, 2, 0, torch.float32),
                                            (1, 125, 4, 1, 0, torch.float32),
                                            (2, 125, 3, 2, 1, torch.bfloat16)):
        O = H * ndir
        u = edge_operand((L, k * O, rows), dtype, offset, gen)
        skip = edge_operand((L, O, rows), dtype, offset, gen) if k == 3 else None
        v, b = (0.5 * torch.randn(2 * O, generator=gen, device="cuda") for _ in range(2))
        cases.append((u, skip, v, b, H, k, ndir))
    return cases


def edge_operand(shape, dtype, offset, gen):
    """A contiguous ``shape`` tensor that starts ``offset`` elements into
    its storage (odd offsets misalign a bfloat16 tensor's 4-byte words)."""
    import torch

    flat = torch.randn(math.prod(shape) + offset, generator=gen, device="cuda")
    return flat.to(dtype)[offset:].view(shape)


def opcheck(op, cases):
    """``torch.library.opcheck`` of the registered op ``rtfs::<op>`` on each
    of ``cases`` (argument tuples of CUDA tensors): its schema, its fake
    implementation against the kernel's outputs, its autograd registration
    and tracing through AOT dispatch. Any failure fails the run."""
    import torch

    overload = getattr(torch.ops.rtfs, op).default
    for args in cases:
        result = torch.library.opcheck(overload, args)
        if set(result.values()) != {"SUCCESS"}:
            fail(f"opcheck rtfs::{op}: {result}")
    print(f"opcheck rtfs::{op}: {len(cases)} cases on {torch.cuda.get_device_name(0)}, "
          "schema, fake tensor, autograd registration, aot dispatch: SUCCESS")


def dw_library(x, w, pads):
    """The one PyTorch call that computes K3's function: ``F.pad`` (torch's
    conv takes no asymmetric padding) + ``F.conv2d(groups=C)``."""
    import torch.nn.functional as F

    (lo_t, hi_t), (lo_f, hi_f) = pads
    return F.conv2d(F.pad(x, (lo_f, hi_f, lo_t, hi_t)), w, groups=x.shape[1])


def check_dw_conv_kernel():
    """The depthwise stencil against its plain version: the main path's
    shapes at B = 16 and 128 with times, the bound and the library call's
    time; small shapes with other kernels; the backward at one shape.
    Returns the sums over the 40 launches of a B=16 float32 forward."""
    import torch

    _, _, kdw, _ = kernel_modules()
    gen = torch.Generator(device="cuda").manual_seed(9)
    per_forward = collections.Counter()
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    main = [((B, CHANNELS, T, Fq), DW_KERNEL, DW_PADS)
            for B in (16, BIG_BATCH) for T, Fq in DW_PLANES]
    for shape, kernel, pads in main + DW_SMALL:
        timed = shape[1] == CHANNELS
        for dtype in (torch.float32, torch.bfloat16):
            item = torch.tensor([], dtype=dtype).element_size()
            n = math.prod(shape)
            # rotate through inputs totalling > 100 MB so each launch
            # reads from HBM, not from the 50 MB L2
            copies = 1 + int(100e6 // (n * item)) if timed else 1
            xs = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                  for _ in range(copies)]
            w = torch.randn((shape[1], 1, *kernel), generator=gen, device="cuda")
            x = xs[0]
            got = kdw.dw_conv2d_same(x, w, pads)
            torch.cuda.synchronize()
            want = kdw.dw_conv2d_same_ref(x, w, pads)
            ok, err = tolerance_ok(got, want, dtype)
            name = f"x={shape} k={kernel} pads={pads} {dtype}"
            if not ok:
                fail(f"dw_conv2d_same {name}: max_abs_err {err} out of tolerance")
            max_err[dtype] = max(max_err[dtype], err)
            row = {"x": shape, "k": kernel, "pads": pads, "dtype": dtype_name(dtype),
                   "max_abs_err": err}
            if timed:
                it = itertools.count()
                w_lib = w.to(dtype)
                ms = event_ms(lambda: kdw.dw_conv2d_same(xs[next(it) % copies], w, pads),
                              reps=20)
                library_ms = event_ms(lambda: dw_library(xs[next(it) % copies], w_lib, pads),
                                      reps=20)
                plain_ms = event_ms(lambda: kdw.dw_conv2d_same_ref(x, w, pads),
                                    reps=2, warmup=1)
                nbytes = 2 * n * item + w.numel() * 4
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = 2 * math.prod(kernel) * n / FP32_OPS_PER_S * 1e3
                row.update({"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                            "bound_ms": max(bytes_ms, ops_ms),
                            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                            "GB_per_s": nbytes / ms / 1e6})
                if dtype == torch.float32 and shape[0] == 16:
                    calls = REPEATS * DW_PLANES[shape[2:]]
                    for key, value in (("ms", ms), ("plain_ms", plain_ms),
                                       ("library_ms", library_ms), ("bytes_ms", bytes_ms),
                                       ("ops_ms", ops_ms)):
                        per_forward[key] += calls * value
            print("dw_conv2d_same " + json.dumps(row))
            del xs, x, got, want

    # the backward: dx through the kernel, dw through PyTorch's convolution
    # backward, against autograd through the plain version
    shape = (4, CHANNELS, 125, 64)
    x = torch.randn(shape, generator=gen, device="cuda")
    w = torch.randn((CHANNELS, 1, *DW_KERNEL), generator=gen, device="cuda")
    g = torch.randn(shape, generator=gen, device="cuda")
    grads = []
    for fn in (kdw.dw_conv2d_same, kdw.dw_conv2d_same_ref):
        xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
        before = kdw.launches
        fn(xi, wi, DW_PADS).backward(g)
        grads.append((xi.grad, wi.grad, kdw.launches - before))
    (dx, dw, n_launched), (dx_ref, dw_ref, _) = grads
    if n_launched != 2:
        fail(f"dw_conv2d_same forward + backward launched the kernel {n_launched} times, want 2")
    ok, dx_err = tolerance_ok(dx, dx_ref, torch.float32)
    dw_err, dw_tol = float((dw - dw_ref).abs().max()), 1e-4 * float(dw_ref.abs().max())
    print("dw_conv2d_same backward " + json.dumps({
        "x": shape, "dx_max_abs_err": dx_err, "dw_max_abs_err": dw_err, "dw_tol": dw_tol}))
    if not ok or not dw_err <= dw_tol:
        fail("dw_conv2d_same backward disagrees with autograd through the plain version")

    check_dw_conv_edges(gen, max_err)
    opcheck("dw_conv2d_same", [
        (edge_operand(shape, dtype, offset, gen),
         torch.randn((shape[1], 1, *kernel), generator=gen, device="cuda"),
         [p for lo_hi in pads for p in lo_hi])
        for (shape, kernel, pads, offset), dtype in zip(DW_EDGE[:3], (torch.float32,
                                                                      torch.bfloat16,
                                                                      torch.float32))])
    print(f"dw_conv2d_same: max_abs_err float32 {max_err[torch.float32]} "
          f"(tol 1e-5 + 1e-5*|ref|), bfloat16 {max_err[torch.bfloat16]} "
          f"(tol {BF16_ATOL} + {BF16_RTOL}*|ref|)")
    bytes_ms, ops_ms = per_forward.pop("bytes_ms"), per_forward.pop("ops_ms")
    out = {"max_abs_err": max_err[torch.float32], **per_forward,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    print(f"dw_conv2d_same per B=16 float32 forward ({DW_LAUNCHES} launches): "
          + json.dumps(out))
    return out


def check_dw_conv_edges(gen, max_err):
    """K3's forward and its dx (the autograd Function's backward, which runs
    the kernel on dy with the flipped kernel) against the plain version at
    the ``DW_EDGE`` shapes, both dtypes; x is a contiguous slice of a larger
    tensor at ``offset`` elements."""
    import torch

    for shape, kernel, pads, offset in DW_EDGE:
        for dtype in (torch.float32, torch.bfloat16):
            err, dx_err = check_dw_forward_dx(shape, kernel, pads, offset, dtype, gen, "edge")
            print("dw_conv2d_same edge " + json.dumps({
                "x": shape, "k": kernel, "pads": pads, "offset": offset,
                "dtype": dtype_name(dtype), "max_abs_err": err, "dx_max_abs_err": dx_err}))
            max_err[dtype] = max(max_err[dtype], err, dx_err)


def check_dw_forward_dx(shape, kernel, pads, offset, dtype, gen, what):
    """K3's forward and dx (two launches through the autograd Function)
    against the plain version on random x, a contiguous slice of a larger
    tensor at ``offset`` elements; fails out of tolerance. Returns the two
    max abs errors."""
    import torch

    _, _, kdw, _ = kernel_modules()
    (lo_t, hi_t), (lo_f, hi_f) = pads
    dx_pads = ((kernel[0] - 1 - lo_t, kernel[0] - 1 - hi_t),
               (kernel[1] - 1 - lo_f, kernel[1] - 1 - hi_f))
    n = math.prod(shape)
    x = torch.randn(n + offset, generator=gen, device="cuda").to(dtype)[offset:]
    x = x.view(shape).requires_grad_()
    dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    w = torch.randn((shape[1], 1, *kernel), generator=gen, device="cuda")
    before = kdw.launches
    y = kdw.dw_conv2d_same(x, w, pads)
    y.backward(dy)
    torch.cuda.synchronize()
    if kdw.launches - before != 2:
        fail(f"dw_conv2d_same {what} x={shape}: {kdw.launches - before} launches, want 2")
    with torch.no_grad():
        ok, err = tolerance_ok(y, kdw.dw_conv2d_same_ref(x, w, pads), dtype)
        dx_ok, dx_err = tolerance_ok(x.grad, kdw.dw_conv2d_same_ref(
            dy, w.flip(2, 3), dx_pads), dtype)
    if not (ok and dx_ok):
        fail(f"dw_conv2d_same {what} x={shape} k={kernel} pads={pads} offset={offset} "
             f"{dtype}: max_abs_err {err}, dx {dx_err} out of tolerance")
    return err, dx_err


def check_sru_direction_kernel():
    """The per-direction SRU kernel against its plain version at the serving
    shapes of B = 1, 4, 16, both directions, both dtypes, on the slices of
    one (L, rows, 4, O) projection that the route gives it, with times and
    bounds (the plain version timed at B = 16); then at the ``SRU_DIR_EDGE``
    shapes. Fails unless both the ring and the narrow kernel ran. Returns
    the sums over the 64 launches of a B=16 float32 forward."""
    import torch

    _, _, _, kdir = kernel_modules()
    gen = torch.Generator(device="cuda").manual_seed(10)
    O = 2 * H
    sums = collections.defaultdict(collections.Counter)  # per (B, dtype) forward
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    depths = set()
    for B, (L, per_utt) in itertools.product(SERVE_BATCHES, SRU_PASSES):
        rows = per_utt * B
        for dtype in (torch.float32, torch.bfloat16):
            item = torch.tensor([], dtype=dtype).element_size()
            nbytes = 5 * L * rows * H * item
            copies = 1 + int(100e6 // (4 * L * rows * H * item))
            us = [torch.randn((L, rows, 4, O), generator=gen, device="cuda").to(dtype)
                  for _ in range(copies)]
            gates = [0.5 * torch.randn(H, generator=gen, device="cuda") for _ in range(4)]
            depths.add(kdir.launch_plan(rows, H, item))
            for reverse in (False, True):
                sl = slice(H, O) if reverse else slice(0, H)

                def operands(u):
                    return [u[:, :, c, sl] for c in range(4)]

                got = kdir.sru_direction(*operands(us[0]), *gates, reverse=reverse)
                torch.cuda.synchronize()
                want = kdir.sru_direction_ref(*operands(us[0]), *gates, reverse=reverse)
                ok, err = tolerance_ok(got, want, dtype)
                if not ok:
                    fail(f"sru_direction L={L} rows={rows} reverse={reverse} {dtype}: "
                         f"max_abs_err {err} out of tolerance")
                max_err[dtype] = max(max_err[dtype], err)
                it = itertools.count()
                ms = event_ms(lambda: kdir.sru_direction(*operands(us[next(it) % copies]),
                                                         *gates, reverse=reverse), reps=20)
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = SRU_OPS_PER_ELEMENT * L * rows * H / FP32_OPS_PER_S * 1e3
                row = {"B": B, "L": L, "rows": rows, "H": H, "reverse": reverse,
                       "dtype": dtype_name(dtype), "depth": kdir.launch_plan(rows, H, item),
                       "max_abs_err": err, "ms": ms, "bound_ms": max(bytes_ms, ops_ms),
                       "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                       "GB_per_s": nbytes / ms / 1e6}
                if B == 16:
                    row["plain_ms"] = event_ms(lambda: kdir.sru_direction_ref(
                        *operands(us[0]), *gates, reverse=reverse), reps=2, warmup=1)
                print("sru_direction " + json.dumps(row))
                calls = REPEATS * sum(SRU_LAYERS.values())  # per direction and pass
                acc = sums[(B, dtype_name(dtype))]
                for key, value in (("ms", ms), ("plain_ms", row.get("plain_ms", 0.0)),
                                   ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                    acc[key] += calls * value
            del us
    check_sru_direction_edges(gen, max_err, depths)
    opcheck("sru_direction", sru_direction_op_cases(gen))
    if not (0 in depths and depths - {0}):
        fail(f"sru_direction: launch plans {sorted(depths)} did not run both the ring "
             "and the narrow kernel")
    print(f"sru_direction: max_abs_err float32 {max_err[torch.float32]} "
          f"(tol 1e-5 + 1e-5*|ref|), bfloat16 {max_err[torch.bfloat16]} "
          f"(tol {BF16_ATOL} + {BF16_RTOL}*|ref|); ring depths run {sorted(depths)}")
    return forward_sums("sru_direction", sums, max_err, 64)


def check_sru_direction_edges(gen, max_err, depths):
    """K4 against its plain version at the ``SRU_DIR_EDGE`` shapes, both
    directions and dtypes, on slices of one (L, rows, 4, 2*H) projection
    whose storage starts ``offset`` elements in. Adds each launch's ring
    depth to ``depths``."""
    import torch

    _, _, _, kdir = kernel_modules()
    for L, rows, Hd, offset in SRU_DIR_EDGE:
        for dtype, reverse in itertools.product((torch.float32, torch.bfloat16), (False, True)):
            u = edge_operand((L, rows, 4, 2 * Hd), dtype, offset, gen)
            sl = slice(Hd, 2 * Hd) if reverse else slice(0, Hd)
            ops = [u[:, :, c, sl] for c in range(4)]
            gates = [0.5 * torch.randn(Hd, generator=gen, device="cuda") for _ in range(4)]
            depth = kdir.launch_plan(rows, Hd, u.element_size(),
                                     all(kdir._words_aligned(t) for t in ops))
            depths.add(depth)
            got = kdir.sru_direction(*ops, *gates, reverse=reverse)
            torch.cuda.synchronize()
            ok, err = tolerance_ok(got, kdir.sru_direction_ref(*ops, *gates, reverse=reverse),
                                   dtype)
            print("sru_direction edge " + json.dumps({
                "L": L, "rows": rows, "H": Hd, "offset": offset, "reverse": reverse,
                "dtype": dtype_name(dtype), "depth": depth, "max_abs_err": err}))
            if not ok:
                fail(f"sru_direction edge L={L} rows={rows} H={Hd} offset={offset} "
                     f"reverse={reverse} {dtype}: max_abs_err {err} out of tolerance")
            max_err[dtype] = max(max_err[dtype], err)


def sru_direction_op_cases(gen):
    """Argument tuples of ``rtfs::sru_direction`` at small edge shapes: slices
    of one projection, float32 forward and bfloat16 reversed at an odd
    element offset (the narrow kernel)."""
    import torch

    cases = []
    for L, rows, Hd, offset, dtype, reverse in ((2, 63, 7, 0, torch.float32, False),
                                                (2, 125, 32, 1, torch.bfloat16, True)):
        u = edge_operand((L, rows, 4, 2 * Hd), dtype, offset, gen)
        gates = [0.5 * torch.randn(Hd, generator=gen, device="cuda") for _ in range(4)]
        cases.append((*(u[:, :, c, :Hd] for c in range(4)), *gates, reverse))
    return cases


def serving_setup():
    """RTFS-Net-4 and its video model at full width on the card, and one
    request per batch size: (mixture, lip embedding) and (mixture, frames)."""
    import torch
    import yaml

    from rtfs_net_tpu_torch.models import build_model, build_video_model

    with open(CONFIG) as f:
        conf = yaml.safe_load(f)
    model = build_model(conf, device="cuda", generator=torch.Generator().manual_seed(0))
    video = build_video_model(conf, device="cuda", generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    requests = {B: (torch.randn((B, SAMPLES), generator=gen, device="cuda"),
                    0.1 * torch.randn((B, LIP_CHANNELS, LIP_FRAMES), generator=gen,
                                      device="cuda"))
                for B in SERVE_BATCHES}
    frame_requests = {B: (torch.randn((B, SAMPLES), generator=gen, device="cuda"),
                          torch.randn((B, 1, VIDEO_FRAMES, MOUTH_SIZE, MOUTH_SIZE),
                                      generator=gen, device="cuda"))
                      for B in SERVE_BATCHES + (BIG_BATCH,)}
    return model, video, requests, frame_requests


def check_serving(label, model, requests, video=None, want=None):
    """One serving path: a counted forward per request (float32; bfloat16
    at the big batch), each launching the kernels ``want`` says (default:
    K1 32, K3 40), then B=1 against the CPU, then timings. ``requests``
    maps B to (mixture, lip embedding), or with ``video`` to (mixture,
    frames). Returns the path's launch counts, its outputs by B and its
    timings by dtype and B."""
    import torch

    from rtfs_net_tpu_torch.utils.separator import separate

    def dtypes(B):
        return (torch.bfloat16,) if B == BIG_BATCH else (torch.float32, torch.bfloat16)

    def forward(B, dtype):
        mix, third = requests[B]
        return separate(model, mix, third, video_model=video, dtype=dtype)

    want = want or {"K1": SRU_LAUNCHES, "K3": DW_LAUNCHES}
    reset_launch_counts()
    outs = {B: launches_of(lambda: forward(B, dtypes(B)[0]), want, f"{label} B={B}")
            for B in requests}
    launches = launch_counts()
    print(f"main path launches ({label}): " + json.dumps(launches))
    for B, out in outs.items():
        if tuple(out.shape) != (B, 1, SAMPLES) or not bool(torch.isfinite(out).all()):
            fail(f"{label} B={B}: output {tuple(out.shape)}, "
                 f"finite={bool(torch.isfinite(out).all())}")
    print(f"{label}: outputs " + ", ".join(str(tuple(o.shape)) for o in outs.values())
          + ", all finite")

    # B=1 float32 against the same models on the CPU (plain versions of the kernels)
    mix, third = requests[1]
    ref = separate(copy.deepcopy(model).cpu(), mix.cpu(), third.cpu(), device="cpu",
                   video_model=None if video is None else copy.deepcopy(video).cpu())
    err = float((outs[1].cpu() - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"{label} B=1 float32 vs CPU: max_abs_err {err}, max|ref| {scale}, "
          f"tol 5e-4*max|ref| = {5e-4 * scale}")
    if not err <= 5e-4 * scale:
        fail(f"{label}: B=1 float32 output disagrees with the CPU forward")

    timings = {}
    for dtype in (torch.float32, torch.bfloat16):
        for B in requests:
            if dtype not in dtypes(B):
                continue
            torch.cuda.reset_peak_memory_stats()
            if not bool(torch.isfinite(forward(B, dtype)).all()):  # warm-up
                fail(f"{label} B={B} {dtype}: non-finite output")
            times = host_ms(lambda: forward(B, dtype), SERVE_REPS)
            median = times[len(times) // 2]
            row = timings[f"{dtype_name(dtype)}_B{B}"] = {
                "ms_per_forward_median": median, "ms_per_forward_min": times[0],
                "ms_per_utt_median": median / B,
                "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2 ** 30}
            print(f"{label} " + json.dumps({"dtype": dtype_name(dtype), "B": B, **row}))
    return launches, outs, timings


def check_bench_point(model):
    """``bench.py``'s serving point: RTFS-Net-4 from (128, 512, 50) lip
    embeddings in bfloat16, one warm-up call, then ``BENCH_CALLS`` timed
    calls, each on its own inputs (``utils/profiling.py:timed``); every call
    launches K1 32 and K3 40 times. Returns the minimum ms per utterance."""
    import torch

    from rtfs_net_tpu_torch.utils.separator import separate

    gen = torch.Generator(device="cuda").manual_seed(8)
    requests = [(torch.randn((BIG_BATCH, SAMPLES), generator=gen, device="cuda"),
                 0.1 * torch.randn((BIG_BATCH, LIP_CHANNELS, LIP_FRAMES), generator=gen,
                                   device="cuda"))
                for _ in range(1 + BENCH_CALLS)]
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i, (mix, emb) in enumerate(requests):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = launches_of(lambda: separate(model, mix, emb, dtype=torch.bfloat16),
                          {"K1": 32, "K3": DW_LAUNCHES}, f"serving B={BIG_BATCH} call {i}")
        if i:  # call 0 is the warm-up
            times.append((time.perf_counter() - t0) * 1e3)
        if tuple(out.shape) != (BIG_BATCH, 1, SAMPLES) or not bool(torch.isfinite(out).all()):
            fail(f"serving B={BIG_BATCH}: output {tuple(out.shape)}, "
                 f"finite={bool(torch.isfinite(out).all())}")
    times.sort()
    print("serving " + json.dumps({
        "dtype": "bfloat16", "B": BIG_BATCH, "timing": "bench.py: min of 6 distinct inputs",
        "ms_per_forward_min": times[0], "ms_per_forward_median": times[len(times) // 2],
        "ms_per_utt_min": times[0] / BIG_BATCH, "utt_per_s": BIG_BATCH / times[0] * 1e3,
        "launches_per_forward": {"K1": 32, "K3": DW_LAUNCHES},
        "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2 ** 30}))
    return times[0] / BIG_BATCH


def check_direction_pass(model, video, request, scan_out):
    """The per-direction route: the B=16 float32 request from frames with
    ``DEFAULT_SRU_BACKEND = "pallas"`` set for the pass and restored after.
    Returns the pass's launch counts."""
    import torch

    from rtfs_net_tpu_torch.ops import rnn
    from rtfs_net_tpu_torch.utils.separator import separate

    mix, frames = request

    def forward():
        return separate(model, mix, frames, video_model=video)

    def with_backend(backend, fn):
        rnn.DEFAULT_SRU_BACKEND = backend
        try:
            return fn()
        finally:
            rnn.DEFAULT_SRU_BACKEND = "scan"

    reset_launch_counts()
    out = with_backend("pallas", lambda: launches_of(
        forward, {"K4": 64, "K3": DW_LAUNCHES}, "per-direction pass"))
    launches = launch_counts()
    print("main path launches (per-direction pass): " + json.dumps(launches))
    err = float((out - scan_out).abs().max())
    tol = 1e-5 + 1e-4 * float(scan_out.abs().max())
    print(f"per-direction pass vs scan pass: max_abs_err {err}, tol {tol}")
    if not err <= tol or not bool(torch.isfinite(out).all()):
        fail("the per-direction pass disagrees with the scan pass")
    times = {"scan": [], "pallas": []}
    for backend in ("scan", "pallas", "pallas", "scan"):
        times[backend] += with_backend(backend, lambda: host_ms(forward, SERVE_REPS // 2 + 1))
    print("per-direction pass " + json.dumps({
        "dtype": "float32", "B": mix.shape[0],
        **{f"{b}_ms_per_forward_median": sorted(t)[len(t) // 2] for b, t in times.items()},
        **{f"{b}_ms_per_forward_min": min(t) for b, t in times.items()}}))
    return launches


def category(name):
    low = name.lower()
    return next((cat for cat, pattern in PROFILE_CATEGORIES if re.search(pattern, low)),
                "other")


def profile_line(label, fn, iters, launched):
    """``torch.profiler`` over ``iters`` calls of ``fn`` (after one warm-up
    call); prints one ``profile`` line and returns its numbers. Device busy time is the sum of
    kernel times (the port runs on one stream). Fails unless each category
    in ``launched``, the kernels ``fn`` launches, shows device time: a
    renamed kernel would otherwise fall silently into another category."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels = collections.Counter()
    n_launches = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] += e.device_time_total / 1e3 / iters
            n_launches += 1
    if not kernels:
        fail(f"profile {label}: the profiler saw no device time")
    busy = sum(kernels.values())
    by_cat = collections.Counter()
    for name, ms in kernels.items():
        by_cat[category(name)] += ms
    stats = {**label, "wall_ms": wall_ms,
             "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
             "kernel_launches": n_launches / iters,
             "by_category_ms": dict(by_cat.most_common()),
             "top_kernels_ms": [[n[:80], ms] for n, ms in kernels.most_common(PROFILE_TOP)]}
    print("profile " + json.dumps(stats))
    missing = [cat for cat in launched if not by_cat.get(cat, 0.0) > 0.0]
    if missing:
        fail(f"profile {label}: no device time in {missing}, whose kernels it launched")
    return stats


def profile_serving(model, video, requests, frame_requests):
    """Where a forward's time goes, per (dtype, B), from ``torch.profiler``:
    from lip embeddings at every batch, and from frames at B = 16 in
    float32 and at the big batch in bfloat16."""
    import torch

    from rtfs_net_tpu_torch.utils.separator import separate

    for dtype in (torch.float32, torch.bfloat16):
        for B, (mix, mouth) in requests.items():
            profile_line({"dtype": dtype_name(dtype), "B": B},
                         lambda: separate(model, mix, mouth, dtype=dtype), PROFILE_ITERS,
                         SERVING_CATEGORIES)
    for dtype, B in ((torch.float32, 16), (torch.bfloat16, BIG_BATCH)):
        mix, frames = frame_requests[B]
        profile_line({"from": "frames", "dtype": dtype_name(dtype), "B": B},
                     lambda: separate(model, mix, frames, video_model=video, dtype=dtype),
                     PROFILE_ITERS if B <= 16 else 1, SERVING_CATEGORIES)


def tolerance_ok(got, want, dtype):
    """Elementwise: float32 1e-5 + 1e-5*|ref|; bfloat16 K1's 1e-5 + 2^-7*|ref|."""
    import torch

    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (BF16_RTOL, BF16_ATOL)
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all()) and bool(torch.isfinite(got).all())
    return ok, float(err.max())


def check_sru_train_kernel():
    """K2's forward and backward against their plain versions at the train
    shapes, with times and bounds; returns the per-step sums of a B=16
    float32 step for the kernels line."""
    import torch

    from rtfs_net_tpu_torch.ops.kernels import sru_train as ktrain

    gen = torch.Generator(device="cuda").manual_seed(2)
    O = 2 * H
    per_step = {"forward": collections.Counter(), "backward": collections.Counter()}
    max_err = {"forward": 0.0, "backward": 0.0}
    for L, rows in TRAIN_SHAPES:
        for k in (4, 3):
            for dtype in (torch.float32, torch.bfloat16):
                item = torch.tensor([], dtype=dtype).element_size()
                skip_ch = O if k == 3 else 0
                fwd_bytes = (k * O + skip_ch + 2 * O) * L * rows * item
                bwd_bytes = ((k * O + 2 * O + skip_ch) + (k * O + skip_ch)) * L * rows * item \
                    + 4 * O * rows * 4
                # rotate through input copies totalling > 100 MB so each
                # launch reads from HBM, not from the 50 MB L2
                copies = 1 + int(100e6 // ((k * O + 2 * O + skip_ch) * L * rows * item))
                sets, v, b = sru_inputs(L, rows, k, dtype, gen, copies)
                sets = [(u, sk, torch.randn((L, O, rows), generator=gen, device="cuda").to(dtype))
                        for u, sk in sets]
                u, skip, dh = sets[0]
                kw = dict(H=H, k=k, ndir=2)
                h, c = ktrain.sru_train_forward(u, skip, v, b, **kw)
                got_b = ktrain.sru_train_backward(u, skip, c, v, b, dh, **kw)
                torch.cuda.synchronize()
                want_h, want_c = ktrain.sru_train_forward_ref(u, skip, v, b, **kw)
                want_b = ktrain.sru_train_backward_ref(u, skip, c, v, b, dh, **kw)
                name = f"L={L} rows={rows} k={k} {dtype}"
                errs = {}
                for part, g, w in (("h", h, want_h), ("c", c, want_c), ("du", got_b[0], want_b[0]),
                                   ("dskip", got_b[1], want_b[1])):
                    if w is None:
                        continue
                    ok, errs[part] = tolerance_ok(g, w, dtype)
                    if not ok:
                        fail(f"sru_train {part} {name}: max_abs_err {errs[part]} out of tolerance")
                gate_rtol = 1e-4 if dtype == torch.float32 else 1e-3
                for part, g, w in (("dv", got_b[2], want_b[2]), ("db", got_b[3], want_b[3])):
                    errs[part] = float((g - w).abs().max())
                    if not errs[part] <= gate_rtol * float(w.abs().max()):
                        fail(f"sru_train {part} {name}: max_abs_err {errs[part]} > "
                             f"{gate_rtol}*max|ref| = {gate_rtol * float(w.abs().max())}")
                cs = [ktrain.sru_train_forward(uu, ss, v, b, **kw)[1] for uu, ss, _ in sets]
                it = itertools.count()

                def fwd():
                    uu, ss, _ = sets[next(it) % copies]
                    ktrain.sru_train_forward(uu, ss, v, b, **kw)

                def bwd():
                    i = next(it) % copies
                    uu, ss, gg = sets[i]
                    ktrain.sru_train_backward(uu, ss, cs[i], v, b, gg, **kw)

                times = {
                    "forward": (event_ms(fwd, reps=20), event_ms(
                        lambda: ktrain.sru_train_forward_ref(u, skip, v, b, **kw),
                        reps=2, warmup=1), fwd_bytes, SRU_OPS_PER_ELEMENT),
                    "backward": (event_ms(bwd, reps=20), event_ms(
                        lambda: ktrain.sru_train_backward_ref(u, skip, c, v, b, dh, **kw),
                        reps=2, warmup=1), bwd_bytes, SRU_BWD_OPS_PER_ELEMENT),
                }
                for which, (ms, plain_ms, nbytes, ops) in times.items():
                    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                    ops_ms = ops * L * O * rows / FP32_OPS_PER_S * 1e3
                    parts = ("h", "c") if which == "forward" else ("du", "dskip", "dv", "db")
                    err = max(errs[p] for p in parts if p in errs)
                    print(f"sru_train_{which} " + json.dumps({
                        "L": L, "rows": rows, "k": k, "dtype": str(dtype).split(".")[-1],
                        "max_abs_err": err, "errors": {p: errs[p] for p in parts if p in errs},
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                        "GB_per_s": nbytes / ms / 1e6}))
                    if dtype == torch.float32:
                        max_err[which] = max(max_err[which], err)
                    if dtype == torch.float32 and rows in (125 * 16, 64 * 16):
                        # a step runs each layer's forward twice (the
                        # checkpointed recompute) and its backward once
                        n = REPEATS * SRU_LAYERS[k] * (2 if which == "forward" else 1)
                        acc = per_step[which]
                        acc["ms"] += n * ms
                        acc["plain_ms"] += n * plain_ms
                        acc["bytes_ms"] += n * bytes_ms
                        acc["ops_ms"] += n * ops_ms
                del sets, cs, u, skip, dh, h, c, got_b, want_b
    check_sru_train_edges(gen)
    cases = sru_op_cases(gen)
    opcheck("sru_train_forward", cases)
    backward_cases = []
    for u, skip, v, b, Hd, k, ndir in cases:
        _, c = ktrain.sru_train_forward(u, skip, v, b, H=Hd, k=k, ndir=ndir)
        dh = torch.randn(c.shape, generator=gen, device="cuda").to(c.dtype)
        backward_cases.append((u, skip, c, v, b, dh, Hd, k, ndir))
    opcheck("sru_train_backward", backward_cases)
    out = {}
    for which, acc in per_step.items():
        row = {"max_abs_err": max_err[which], "ms": acc["ms"], "plain_ms": acc["plain_ms"],
               "bound_ms": max(acc["bytes_ms"], acc["ops_ms"]),
               "bound_by": "bytes" if acc["bytes_ms"] >= acc["ops_ms"] else "operations"}
        print(f"sru_train_{which} per B=16 float32 step: " + json.dumps(row))
        out[which] = row
    return out


def check_sru_train_edges(gen):
    """K2's forward and backward against their plain versions at the
    ``SRU_EDGE`` shapes, both dtypes: the forward within ``tolerance_ok``;
    the gradients within 2e-4*max(1, max|ref|), except bfloat16 du and
    dskip, which are rounded to bfloat16 (one ulp is 2^-8 of the value) and
    take ``tolerance_ok``'s one to two ulps. ``offset`` > 0 makes every
    operand a slice at that element offset."""
    import torch

    from rtfs_net_tpu_torch.ops.kernels import sru_train as ktrain

    for L, rows, k, ndir, offset in SRU_EDGE:
        O = H * ndir
        for dtype in (torch.float32, torch.bfloat16):
            u = edge_operand((L, k * O, rows), dtype, offset, gen)
            skip = edge_operand((L, O, rows), dtype, offset, gen) if k == 3 else None
            dh = edge_operand((L, O, rows), dtype, offset, gen)
            v, b = (0.5 * torch.randn(2 * O, generator=gen, device="cuda") for _ in range(2))
            kw = dict(H=H, k=k, ndir=ndir)
            before = (ktrain.forward_launches, ktrain.backward_launches)
            h, c = ktrain.sru_train_forward(u, skip, v, b, **kw)
            if offset:  # the backward's c a slice at the offset too
                c = edge_operand(c.shape, dtype, offset, gen).copy_(c)
            got = ktrain.sru_train_backward(u, skip, c, v, b, dh, **kw)
            torch.cuda.synchronize()
            launched = (ktrain.forward_launches - before[0], ktrain.backward_launches - before[1])
            if launched != (1, 1):
                fail(f"sru_train edge L={L} rows={rows}: launches {launched}")
            want_h, want_c = ktrain.sru_train_forward_ref(u, skip, v, b, **kw)
            want = ktrain.sru_train_backward_ref(u, skip, c, v, b, dh, **kw)
            errs, bad = {}, []
            for part, g, w in (("h", h, want_h), ("c", c, want_c)):
                ok, errs[part] = tolerance_ok(g, w, dtype)
                bad += [] if ok else [part]
            for part, g, w in zip(("du", "dskip", "dv", "db"), got, want):
                if w is None:
                    continue
                if dtype == torch.bfloat16 and part in ("du", "dskip"):
                    ok, errs[part] = tolerance_ok(g, w, dtype)
                else:
                    errs[part] = float((g.float() - w.float()).abs().max())
                    ok = errs[part] <= 2e-4 * max(1.0, float(w.float().abs().max()))
                bad += [] if ok else [part]
            print("sru_train edge " + json.dumps({
                "L": L, "rows": rows, "k": k, "ndir": ndir, "offset": offset,
                "dtype": dtype_name(dtype), "errors": errs}))
            if bad:
                fail(f"sru_train edge L={L} rows={rows} k={k} ndir={ndir} offset={offset} "
                     f"{dtype}: {bad} out of tolerance ({errs})")


def rtfs4_conf(dropout=None):
    import yaml

    with open(CONFIG) as f:
        conf = yaml.safe_load(f)["audionet"]
    if dropout is not None:
        conf["video_params"]["layers"]["layer_1"]["dropout"] = dropout
    return conf


def make_system(model, dtype, config=None, optimizer=None):
    """``System`` with the optimizer of ``config`` (default: RTFS-Net-4's),
    or the one named by ``optimizer`` with that config's settings."""
    import torch

    from rtfs_net_tpu_torch.losses import PITLossWrapper, pairwise_neg_sisdr, pairwise_neg_snr
    from rtfs_net_tpu_torch.system import System, make_optimizer

    import yaml

    with open(config or CONFIG) as f:
        optim = yaml.safe_load(f)["optim"]
    if optimizer is not None:
        optim["optimizer"] = optimizer
    return System(model, make_optimizer(model.parameters(), **optim),
                  {"train": PITLossWrapper(pairwise_neg_snr),
                   "val": PITLossWrapper(pairwise_neg_sisdr)},
                  compute_dtype=None if dtype == torch.float32 else dtype)


def train_batch(B, gen):
    """A (mix, target, mouths) batch; the target is the mixture, as the JAX
    package's train benchmark has it."""
    import torch

    mix = torch.randn((B, SAMPLES), generator=gen, device="cuda")
    mouth = 0.1 * torch.randn((B, LIP_CHANNELS, LIP_FRAMES), generator=gen, device="cuda")
    return mix, mix[:, None], mouth


def check_training():
    """The training path: per (dtype, B), one counted step (K2 forward 64,
    K2 backward 32, K3 120: the 40 convs, their checkpointed recompute and
    the 40 input gradients; K1 and K4 0), then timed steps and peak memory.
    Returns the path's launch counts."""
    import torch

    from rtfs_net_tpu_torch.models import build_model

    base = build_model(rtfs4_conf(), device="cuda", generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(3)
    batches = {B: train_batch(B, gen) for B in TRAIN_BATCHES}
    runs = [(dtype, B) for dtype in (torch.float32, torch.bfloat16) for B in TRAIN_BATCHES]
    systems = {run: make_system(copy.deepcopy(base), run[0]) for run in runs}

    def step(run):
        out = systems[run].train_step(batches[run[1]],
                                      generator=torch.Generator(device="cuda").manual_seed(4))
        loss, gnorm = float(out["loss"]), float(out["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"train {run}: loss {loss}, grad_norm {gnorm}")
        return loss, gnorm

    reset_launch_counts()
    for run in runs:
        launches_of(lambda: step(run), {"K2_forward": 64, "K2_backward": 32,
                                        "K3": 3 * DW_LAUNCHES}, f"train {run}")
    launches = launch_counts()
    print("main path launches (training): " + json.dumps(launches))

    for run in runs:
        dtype, B = run
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(run)[0])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        print("train " + json.dumps({
            "dtype": str(dtype).split(".")[-1], "B": B,
            "ms_per_step_median": times[len(times) // 2], "ms_per_step_min": times[0],
            "utt_per_s": B / times[len(times) // 2] * 1e3,
            "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
            "loss_first_last": [losses[0], losses[-1]]}))
    del systems
    return base, launches


def check_train_parity(conf=None, config=None, label="train"):
    """One float32 B=1 step, dropout off: the card against the CPU. ``conf``
    is the model's (default: RTFS-Net-4's, dropout off), ``config`` its
    YAML for the optimizer."""
    import torch

    from rtfs_net_tpu_torch.models import build_model

    cpu_model = build_model(conf or rtfs4_conf(dropout=0.0), device="cpu",
                            generator=torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).cuda()
    batch = train_batch(1, torch.Generator(device="cuda").manual_seed(5))
    loss_gpu = float(make_system(gpu_model, torch.float32, config).backward(batch))
    loss_cpu = float(make_system(cpu_model, torch.float32, config).backward(
        tuple(t.cpu() for t in batch)))
    grads = {n: p.grad for n, p in cpu_model.named_parameters()}
    scale = max(float(g.abs().max()) for g in grads.values())
    worst, worst_name = 0.0, None
    for n, p in gpu_model.named_parameters():
        err = float((p.grad.cpu() - grads[n]).abs().max())
        if err > worst:
            worst, worst_name = err, n
    print(f"{label} B=1 float32 vs CPU: " + json.dumps({
        "loss_gpu": loss_gpu, "loss_cpu": loss_cpu, "loss_tol": 1e-4 * abs(loss_cpu),
        "grad_max_abs_err": worst, "worst_param": worst_name, "max_abs_grad": scale,
        "grad_tol": 1e-3 * scale}))
    if not abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu):
        fail(f"{label}: B=1 float32 train loss disagrees with the CPU")
    if not worst <= 1e-3 * scale:
        fail(f"{label}: B=1 float32 gradient of {worst_name} disagrees with the CPU")


def profile_training(base):
    """torch.profiler over one B=16 bfloat16 train step."""
    import torch

    system = make_system(copy.deepcopy(base), torch.bfloat16)
    batch = train_batch(16, torch.Generator(device="cuda").manual_seed(6))
    gen = torch.Generator(device="cuda").manual_seed(7)
    profile_line({"train": True, "dtype": "bfloat16", "B": 16},
                 lambda: system.train_step(batch, generator=gen), 1, TRAIN_CATEGORIES)


def write_fit_manifest(root):
    """An LRS2-style manifest per split under ``root``: mixtures of 2 s
    (mix, s1, s2 wavs) with a 50x96x96 uint8 mouth track per speaker, two
    target-speaker items per mixture. Returns ``{split: directory}``."""
    import numpy as np

    from rtfs_net_tpu_torch.datas import wavio

    rng = np.random.default_rng(9)
    dirs = {}
    for split, items in FIT_ITEMS.items():
        d = dirs[split] = os.path.join(root, split)
        os.makedirs(d)
        rows = {"mix": [], "s1": [], "s2": []}
        for i in range(items // 2):
            wavs = {}
            for name in rows:
                wavs[name] = os.path.join(d, f"{name}_{i}.wav")
                wavio.write(wavs[name], 0.1 * rng.standard_normal(SAMPLES).astype(np.float32),
                            16000)
            rows["mix"].append([wavs["mix"], SAMPLES])
            for spk in ("s1", "s2"):
                mouth = os.path.join(d, f"{spk}_{i}.npz")
                np.savez_compressed(mouth, data=rng.integers(
                    0, 256, (VIDEO_FRAMES, 96, 96), dtype=np.uint8))
                rows[spk].append([wavs[spk], mouth, SAMPLES])
        for name, data in rows.items():
            with open(os.path.join(d, f"{name}.json"), "w") as f:
                json.dump(data, f)
    return dirs


class FitWatch:
    """Wraps ``System.train_step`` and ``System.val_step`` for one run of
    the entry point: each call's kernel launches are recorded, and the call
    is bracketed by two CUDA events, so that the loop runs with no host sync
    added; ``ms`` reads each call's device span (from the stream reaching
    its first work to its last, idle gaps included) after the run.
    ``before_first_step``, when set, is called with the system before its
    first train step."""

    def __init__(self, before_first_step=None):
        self.steps, self.vals = [], []
        self.before_first_step = before_first_step

    def _record(self, into, fn):
        import torch

        before = launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        into.append(({k: n - before[k] for k, n in launch_counts().items()}, (start, end)))
        return out

    @staticmethod
    def ms(calls):
        import torch

        torch.cuda.synchronize()
        return [start.elapsed_time(end) for _, (start, end) in calls]

    def __enter__(self):
        from rtfs_net_tpu_torch.system.core import System

        self.original = System.train_step, System.val_step
        train_step, val_step = self.original
        watch = self

        def watched_train_step(system, batch, generator=None):
            if watch.before_first_step is not None and not watch.steps:
                watch.before_first_step(system)
            return watch._record(watch.steps, lambda: train_step(system, batch, generator))

        def watched_val_step(system, batch):
            return watch._record(watch.vals, lambda: val_step(system, batch))

        System.train_step, System.val_step = watched_train_step, watched_val_step
        return self

    def __exit__(self, *exc):
        from rtfs_net_tpu_torch.system.core import System

        System.train_step, System.val_step = self.original

    def check_launches(self, what, want_step=None, want_val=None):
        """Fail unless every train step and validation batch launched each
        kernel as often as wanted (default: RTFS-Net-4's counts)."""
        if want_step is None:
            want_step = {"K2_forward": 64, "K2_backward": 32, "K3": 3 * DW_LAUNCHES}
        if want_val is None:
            want_val = {"K1": 32, "K3": DW_LAUNCHES}
        for calls, want, kind in ((self.steps, want_step, "train step"),
                                  (self.vals, want_val, "validation batch")):
            if not calls:
                fail(f"{what}: no {kind} ran")
            for i, (got, _) in enumerate(calls):
                if got != {k: want.get(k, 0) for k in got}:
                    fail(f"{what}: {kind} {i} launched {got}, want {want} and no others")


class PreemptingLoader:
    """A training loader that sends this process SIGTERM while handing out
    batch ``at[1]`` of epoch ``at[0]``: the trainer's handler flags the
    loop, that step still runs, and the loop saves 'preempt' after it."""

    def __init__(self, loader, at):
        self.loader, self.at, self.epoch = loader, at, -1

    def set_epoch(self, epoch):
        self.epoch = epoch
        self.loader.set_epoch(epoch)

    def __iter__(self):
        import signal

        for i, batch in enumerate(self.loader):
            if (self.epoch, i) == self.at:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    def close(self):
        self.loader.close()


def tensors_equal(got, want, what):
    """Fail unless two (nested) state dicts hold bit-equal tensors."""
    import torch

    if isinstance(want, dict):
        if set(got) != set(want):
            fail(f"{what}: keys differ")
        for k in want:
            tensors_equal(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        for i, (g, w) in enumerate(zip(got, want)):
            tensors_equal(g, w, f"{what}[{i}]")
    elif isinstance(want, torch.Tensor):
        if not torch.equal(got, want.to(got.device)):
            fail(f"{what}: differs")
    elif got != want:
        fail(f"{what}: {got} != {want}")


def check_fit(root):
    """The training entry point, end to end on the card (phase 14), in the
    directory ``root``. Returns the experiment directory it exported and the
    path's launch counts."""
    import glob

    import torch

    from rtfs_net_tpu_torch import train
    from rtfs_net_tpu_torch.models import build_model, serialization
    from rtfs_net_tpu_torch.utils.separator import separate

    dirs = write_fit_manifest(root)
    argv = ["--conf-dir", CONFIG, "--train_dir", dirs["tr"], "--valid_dir", dirs["cv"],
            "--path", os.path.join(root, "log"), "--batch_size", str(FIT_BATCH),
            "--num_workers", str(FIT_WORKERS), "--device", "cuda",
            # the seed's frozen backbone: no published weights are read
            "--pretrain", ""]
    conf = train.parse_conf(argv + ["--epochs", str(FIT_EPOCHS)])
    exp_dir = os.path.join(conf["log"]["path"], conf["log"]["exp_name"])

    # two epochs from scratch
    torch.cuda.reset_peak_memory_stats()
    with FitWatch() as watch:
        trainer = train.main(conf)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    watch.check_launches("fit")
    steps_per_epoch = FIT_ITEMS["tr"] // FIT_BATCH
    batches_per_epoch = steps_per_epoch + FIT_ITEMS["cv"] // FIT_BATCH
    if [h["epoch"] for h in trainer.history] != list(range(FIT_EPOCHS)) or \
            trainer.system.step != FIT_EPOCHS * steps_per_epoch:
        fail(f"fit: history {trainer.history}, {trainer.system.step} steps")
    for h in trainer.history:
        if not (math.isfinite(h["train_loss"]) and math.isfinite(h["val_loss"])):
            fail(f"fit: epoch {h['epoch']} losses {h['train_loss']}, {h['val_loss']}")
    for name in ("best_k_models.json", "checkpoints/last.json", "best_model.pth",
                 "conf.yaml"):
        if not os.path.isfile(os.path.join(exp_dir, name)):
            fail(f"fit: {name} missing")
    if not glob.glob(os.path.join(exp_dir, "tb", "*", "*", "events.out.tfevents.*")):
        fail("fit: no TensorBoard events")
    step_ms, val_ms = watch.ms(watch.steps), sorted(watch.ms(watch.vals))
    first_step_ms = step_ms[0]  # cuDNN's first choices of algorithm
    step_ms.sort()
    launches_per_step, launches_per_val = watch.steps[0][0], watch.vals[0][0]
    launches = {k: sum(got[k] for got, _ in watch.steps + watch.vals) for k in launch_counts()}
    print("main path launches (fit): " + json.dumps(launches))
    history = trainer.history
    del trainer, watch
    print("fit " + json.dumps({
        "dtype": "float32", "B": FIT_BATCH, "items": FIT_ITEMS, "epochs": FIT_EPOCHS,
        "workers": FIT_WORKERS, "video_model": "FRCNNVideoModel from frames",
        "ms_per_train_step_median": step_ms[len(step_ms) // 2],
        "ms_per_train_step_min": step_ms[0],
        "ms_first_train_step": first_step_ms,
        "ms_per_val_batch_median": val_ms[len(val_ms) // 2],
        "epoch_wall_s": [h["wall_s"] for h in history],
        # epoch 0's wait holds the spawn of both loaders' worker pools
        "loader_wait_share": [h["loader_wait_s"] / h["wall_s"] for h in history],
        "loader_wait_ms_per_batch": [h["loader_wait_s"] * 1e3 / batches_per_epoch
                                     for h in history],
        "train_loss": [h["train_loss"] for h in history],
        "val_loss": [h["val_loss"] for h in history],
        "launches_per_step": launches_per_step, "launches_per_val_batch": launches_per_val,
        "peak_mem_GiB": peak}))

    # a third epoch, interrupted by SIGTERM after FIT_PREEMPT[1] + 1 steps
    conf = train.parse_conf(argv + ["--epochs", str(FIT_EPOCHS + 1)])
    build_dataloaders = train.build_dataloaders

    def preempting(c, *shard):
        train_loader, val_loader = build_dataloaders(c, *shard)
        return PreemptingLoader(train_loader, FIT_PREEMPT), val_loader

    train.build_dataloaders = preempting
    try:
        preempted = train.main(conf)
    finally:
        train.build_dataloaders = build_dataloaders
    with open(os.path.join(exp_dir, "checkpoints", "last.json")) as f:
        last = json.load(f)
    want_steps = FIT_EPOCHS * steps_per_epoch + FIT_PREEMPT[1] + 1
    if last["name"] != "preempt" or last["epoch"] != FIT_EPOCHS - 1 or \
            preempted.system.step != want_steps:
        fail(f"preempt: last.json {last}, {preempted.system.step} steps, "
             f"want {want_steps}")
    saved = torch.load(os.path.join(exp_dir, "checkpoints", "preempt.pt"),
                       map_location="cpu", weights_only=True)
    tensors_equal(preempted.system.state_dict(), saved, "preempt checkpoint")
    del preempted

    # a fresh run resumes from 'preempt' and finishes the third epoch
    def resumed_as_saved(system):
        tensors_equal(system.state_dict(), saved, "resumed state")
        print(f"resume: {system.step} steps; parameters and optimizer state equal to "
              "the preempt checkpoint's, bit for bit")

    with FitWatch(before_first_step=resumed_as_saved) as watch:
        resumed = train.main(conf)
    watch.check_launches("resumed fit")
    # the interrupted epoch restarts from the mid-epoch state
    if resumed.start_epoch != FIT_EPOCHS or [h["epoch"] for h in resumed.history] != [
            FIT_EPOCHS] or resumed.system.step != want_steps + steps_per_epoch:
        fail(f"resume: start epoch {resumed.start_epoch}, history {resumed.history}, "
             f"{resumed.system.step} steps")

    # the exported best model against the checkpoint it came from
    best = resumed.ckpt.best_name()
    video = resumed.system.video_model
    ckpt_model = build_model(conf["audionet"], device="cuda")
    ckpt_model.load_state_dict(resumed.ckpt.restore(best, map_location="cpu")["model"])
    exported, package = serialization.load_model(os.path.join(exp_dir, "best_model.pth"),
                                                 device="cuda")
    _, val_loader = build_dataloaders(conf)
    try:
        mix, _, frames, _ = next(iter(val_loader))
    finally:
        val_loader.close()
    device = next(ckpt_model.parameters()).device
    mix, frames = torch.from_numpy(mix).to(device), torch.from_numpy(frames).to(device)
    tensors_equal(exported.state_dict(), ckpt_model.state_dict(), "best_model.pth")
    # under cuDNN's deterministic algorithms equal weights give equal outputs
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want, got = (separate(m, mix, frames, video_model=video)
                     for m in (ckpt_model, exported))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    err = float((got - want).abs().max())
    print(f"export: best_model.pth ({package['model_name']}, from {best}) vs its "
          f"checkpoint on a validation batch {tuple(frames.shape)}: state dicts equal; "
          f"separate() max_abs_err {err} (tol 0), max|ref| {float(want.abs().max())}, "
          "float32")
    if err != 0 or not bool(torch.isfinite(got).all()):
        fail("export: best_model.pth separates differently from its checkpoint")
    del resumed, ckpt_model, exported
    return exp_dir, launches


def write_eval_manifest(root):
    """An LRS2-style ``tt`` manifest under ``root``: ``EVAL_MIXTURES``
    mixtures whose lengths are drawn from ``EVAL_SECONDS`` (mix, s1, s2
    wavs), with a 96x96 uint8 mouth track of the matching 25 fps length per
    speaker. Returns its directory."""
    import numpy as np

    from rtfs_net_tpu_torch.datas import wavio

    rng = np.random.default_rng(10)
    d = os.path.join(root, "tt")
    os.makedirs(d)
    rows = {"mix": [], "s1": [], "s2": []}
    for i in range(EVAL_MIXTURES):
        n = int(rng.uniform(*EVAL_SECONDS) * 16000)
        wavs = {name: os.path.join(d, f"{name}_{i}.wav") for name in rows}
        for name, path in wavs.items():
            wavio.write(path, 0.1 * rng.standard_normal(n).astype(np.float32), 16000)
        rows["mix"].append([wavs["mix"], n])
        for spk in ("s1", "s2"):
            mouth = os.path.join(d, f"{spk}_{i}.npz")
            np.savez_compressed(mouth, data=rng.integers(
                0, 256, (-(-n * 25 // 16000), 96, 96), dtype=np.uint8))
            rows[spk].append([wavs[spk], mouth, n])
    for name, data in rows.items():
        with open(os.path.join(d, f"{name}.json"), "w") as f:
            json.dump(data, f)
    return d


class EvalWatch:
    """Wraps ``evaluation.forward_batch`` for one run of the evaluation
    engine: each batch's kernel launches and size are recorded."""

    def __enter__(self):
        from rtfs_net_tpu_torch import evaluation

        self.original, self.calls = evaluation.forward_batch, []

        def watched(model, video_apply, mix, mouths):
            before = launch_counts()
            out = self.original(model, video_apply, mix, mouths)
            self.calls.append(({k: n - before[k] for k, n in launch_counts().items()},
                               mix.shape[0]))
            return out

        evaluation.forward_batch = watched
        return self

    def __exit__(self, *exc):
        from rtfs_net_tpu_torch import evaluation

        evaluation.forward_batch = self.original

    def check_launches(self, stats):
        """Every batch launched K1 32 and K3 ``DW_LAUNCHES`` times and
        nothing else, and the engine timed the batches on the card."""
        want = {"K1": 32, "K3": DW_LAUNCHES}
        for i, (got, size) in enumerate(self.calls):
            if got != {k: want.get(k, 0) for k in got}:
                fail(f"evaluate: batch {i} (of {size}) launched {got}, want {want} and no others")
        if stats["batch_clock"] != "cuda_events":
            fail(f"evaluate: batches timed by {stats['batch_clock']}")
        return want


def metric_rows(path):
    """metrics.csv's utterance rows, by key: the sorted SI-SNR and SDR values
    of the key's rows (a mixture's two target-speaker items share its key)."""
    import csv

    with open(path) as f:
        rows = list(csv.DictReader(f))
    by_key = collections.defaultdict(lambda: ([], []))
    for r in rows:
        if r["snt_id"] not in ("avg", "std"):
            by_key[r["snt_id"]][0].append(float(r["si-snr"]))
            by_key[r["snt_id"]][1].append(float(r["sdr"]))
    return rows, {k: (sorted(a), sorted(b)) for k, (a, b) in by_key.items()}


def check_evaluate(root, exp_dir, smi):
    """The evaluation entry point on the experiment ``fit`` exported (phase
    15). Returns the path's launch counts."""
    import numpy as np
    import torch

    from rtfs_net_tpu_torch import test as evaluate_cli
    from rtfs_net_tpu_torch import train
    from rtfs_net_tpu_torch.datas import AVSpeechDataset
    from rtfs_net_tpu_torch.evaluation import normalize_mouths, run_batched_eval
    from rtfs_net_tpu_torch.losses import PITLossWrapper, pairwise_neg_sisdr
    from rtfs_net_tpu_torch.metrics import ALLMetricsTracker, pesq_backend
    from rtfs_net_tpu_torch.models.serialization import load_model

    test_dir = write_eval_manifest(root)
    conf = evaluate_cli.parse_conf(["--conf-dir", os.path.join(exp_dir, "conf.yaml"),
                                    "--test-dir", test_dir, "--device", "cuda"])
    eval_batch = 2 * conf["training"]["batch_size"]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with EvalWatch() as watch:
        t0 = time.perf_counter()
        out = evaluate_cli.main(conf)
        main_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print("main path launches (evaluate): " + json.dumps(launches))
    stats = out["eval"]
    want = watch.check_launches(stats)
    sizes = [size for _, size in watch.calls]
    if sum(sizes) != EVAL_ITEMS or max(sizes) != eval_batch or stats["batches"] != len(sizes):
        fail(f"evaluate: batches {sizes}, stats {stats}")

    rows, batched = metric_rows(os.path.join(out["save_dir"], "metrics.csv"))
    if len(rows) != EVAL_ITEMS + 2 or [r["snt_id"] for r in rows[-2:]] != ["avg", "std"]:
        fail(f"evaluate: metrics.csv has {len(rows)} rows, ending {rows[-2:]}")
    if pesq_backend() != "native":
        fail(f"evaluate: PESQ came from {pesq_backend()!r}, not the native extension")
    for r in rows[:-2]:
        for col in ("si-snr", "sdr", "stoi", "pesq"):
            if not math.isfinite(float(r[col])):
                fail(f"evaluate: {r['snt_id']} {col} = {r[col]}")
    keys = [k for k, _ in out["results"]]
    head = ["Model", "Params (M)", "MACs (G, 2s)", "Videomodel MACs (G, 2s)",
            "si-snr_i", "sdr_i", "pesq", "stoi", "si-snr", "sdr"]
    if keys[:len(head)] != head or "enc_dec_params_win" not in keys:
        fail(f"evaluate: results.csv rows {keys}")
    with open(os.path.join(out["save_dir"], "results.csv")) as f:
        if f.readline().strip() != "Key,Value" or len(f.readlines()) != len(keys):
            fail("evaluate: results.csv on disk differs from the rows returned")

    # the first SERIAL_ITEMS utterances again, one at a time, through the engine
    model, _ = load_model(os.path.join(exp_dir, "best_model.pth"), device="cuda", conf=conf)
    video = train.build_video_model(conf, "cuda")
    test_set = AVSpeechDataset(test_dir, n_src=1, sample_rate=16000, segment=None,
                               normalize_audio=conf["data"]["normalize_audio"])
    serial_csv = os.path.join(root, "serial.csv")
    tracker = ALLMetricsTracker(save_file=serial_csv)
    run_batched_eval(model, [test_set[i] for i in range(SERIAL_ITEMS)], tracker,
                     PITLossWrapper(pairwise_neg_sisdr), lambda m: video(normalize_mouths(m)),
                     EVAL_BUCKET, 1, 16000, progress_every=0)
    tracker.final()
    _, serial = metric_rows(serial_csv)
    err = max(abs(a - b) for key, pair in serial.items()
              for got, ref in zip(pair, batched[key]) for a, b in zip(got, ref))
    print(f"evaluate: {SERIAL_ITEMS} utterances one at a time vs the batched run: "
          f"SI-SNR and SDR max_abs_err {err} dB (tol 1e-3)")
    if not err <= 1e-3:
        fail("evaluate: the serial pass disagrees with the batched run")
    del model, video

    means = {r[0]: r[1] for r in out["results"][4:10]}
    print("evaluate " + json.dumps({
        "card": smi, "dtype": "float32", "video_model": "FRCNNVideoModel from frames",
        "items": EVAL_ITEMS, "seconds": EVAL_SECONDS, "bucket": EVAL_BUCKET,
        "eval_batch_size": eval_batch, "batch_sizes": sizes,
        "utt_per_s": stats["utterances"] / stats["wall_s"], "eval_wall_s": stats["wall_s"],
        "test_main_wall_s": main_s,
        "batch_ms_median": float(np.median(stats["batch_ms"])), "batch_ms": stats["batch_ms"],
        "wait_for_device_s": stats["wait_for_device_s"],
        "scoring_idle_s": stats["scoring_idle_s"], "drain_s": stats["drain_s"],
        "score_ms_per_utt": stats["score_ms_per_utt"], "pesq_backend": pesq_backend(),
        "launches_per_batch": want, "peak_mem_GiB": peak, "means": means,
        "macs": dict(out["results"][2:4])}))
    return launches


def check_separate_cli(root, exp_dir):
    """The separation entry point on the experiment ``fit`` exported (phase
    16): a ``SEPARATE_SECONDS`` s wav with its mouth track, plain and in
    ``SEPARATE_CHUNK`` s chunks. Returns the path's launch counts."""
    import numpy as np

    from rtfs_net_tpu_torch import separate as separate_cli
    from rtfs_net_tpu_torch.datas import wavio

    rng = np.random.default_rng(11)
    n = SEPARATE_SECONDS * 16000
    wav, mouth = os.path.join(root, "long.wav"), os.path.join(root, "long.npz")
    wavio.write(wav, 0.1 * rng.standard_normal(n).astype(np.float32), 16000)
    np.savez_compressed(mouth, data=rng.integers(0, 256, (SEPARATE_SECONDS * 25, 96, 96),
                                                 dtype=np.uint8))
    reset_launch_counts()
    times = {}
    for chunk in (0, SEPARATE_CHUNK):
        argv = ["--model", os.path.join(exp_dir, "best_model.pth"), "--input", wav,
                "--mouth", mouth, "--videonet-conf", os.path.join(exp_dir, "conf.yaml"),
                "--output", os.path.join(root, f"separated_{chunk}"),
                "--chunk-seconds", str(chunk), "--device", "cuda"]
        t0 = time.perf_counter()
        (path,) = launches_of(lambda: separate_cli.main(separate_cli.parse_args(argv)),
                              {"K1": 32, "K3": DW_LAUNCHES}, f"separate chunk={chunk}")
        times[chunk] = (time.perf_counter() - t0) * 1e3
        out, sr = wavio.read(path)
        if sr != 16000 or out.shape != (n,) or not np.isfinite(out).all() or \
                not np.abs(out).max() > 0:
            fail(f"separate chunk={chunk}: {path} holds {out.shape} at {sr} Hz")
    launches = launch_counts()
    print("main path launches (separate): " + json.dumps(launches))
    print("separate " + json.dumps({
        "seconds": SEPARATE_SECONDS, "dtype": "float32", "with": "mouth npz, FRCNN video model",
        "ms_plain": times[0], f"ms_chunks_of_{SEPARATE_CHUNK}s": times[SEPARATE_CHUNK],
        "timing": "host clock around the CLI's main: load, video model, one forward, wav write",
        "output": "finite, the input's length"}))
    return launches


def bucket_calls(n, buckets=EXPORT_BUCKETS):
    """The bucket calls an artifact makes for a request of ``n``: the
    smallest bucket that fits, else chunks of the largest."""
    calls = []
    while n > 0:
        b = next((s for s in buckets if s >= n), buckets[-1])
        calls.append(b)
        n -= min(n, b)
    return calls


def eager_serving(model, dtype):
    """What an artifact computes, run eagerly: float32 in, the model in
    ``dtype``, float32 out (``export._Serving``)."""
    import torch

    def forward(mix, emb):
        with torch.inference_mode():
            return model(mix.to(dtype), emb.to(dtype)).float()

    return forward


def turns_ms(fns, requests):
    """Host-clock ms of synchronised calls of each of ``fns`` (name -> fn of
    one request), in turns: one warm-up each, then the first, second,
    second, first over ``requests`` split in halves, each request once per
    fn. Returns sorted times by name."""
    import torch

    (a, fa), (b, fb) = fns.items()
    times = {a: [], b: []}
    half = len(requests) // 2
    for fn in (fa, fb):
        fn(*requests[0])
    for name, fn, reqs in ((a, fa, requests[1:1 + half]), (b, fb, requests[1:1 + half]),
                           (b, fb, requests[1 + half:]), (a, fa, requests[1 + half:])):
        for mix, emb in reqs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(mix, emb)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: sorted(t) for name, t in times.items()}


def check_export(root, exp_dir, smi):
    """The serving artifact on the card (phase 17): ``export_serving``'s CLI on
    the experiment ``fit`` exported (float32, buckets ``EXPORT_BUCKETS``) and
    on the serving phase's random-weight model (bfloat16, B = 128); each
    bucket's graph holds ``SRU_LAUNCHES`` K1 and ``DW_LAUNCHES`` K3 op nodes
    and no other ``rtfs::`` node; each bucket call launches those kernels
    that often and nothing else. Returns the launch counts of the path's
    artifact calls (the served requests and ``separate --model
    model.rtfsx``), counted from 0 just before them."""
    import numpy as np
    import torch
    import yaml

    from rtfs_net_tpu_torch import export, export_serving
    from rtfs_net_tpu_torch import separate as separate_cli
    from rtfs_net_tpu_torch.datas import wavio
    from rtfs_net_tpu_torch.models import build_model, serialization

    want_nodes = {"sru_stack_layer": SRU_LAUNCHES, "dw_conv2d_same": DW_LAUNCHES}
    per_call = {"K1": SRU_LAUNCHES, "K3": DW_LAUNCHES}

    def exported(ckpt, out, *flags):
        argv = ["--ckpt", ckpt, "--out", out, "--device", "cuda", *flags]
        path, seconds = export_serving.main(argv)
        t0 = time.perf_counter()
        art = export.load_artifact(path)
        for b in art.batch_sizes:
            art.module(b)  # each bucket's program deserialized and placed on the card
        load_s = time.perf_counter() - t0
        for b in art.batch_sizes:
            nodes = export.op_counts(art.program(b))
            print(f"export {os.path.basename(out)} B={b}: rtfs op nodes {json.dumps(nodes)}")
            if nodes != want_nodes:
                fail(f"export B={b}: op nodes {nodes}, want {want_nodes}")
        if art.header["platforms"] != ["cuda"]:
            fail(f"export: platforms {art.header['platforms']}")
        return art, {"export_s": {str(b): s for b, s in seconds.items()},
                     "artifact_MB": os.path.getsize(path) / 1e6, "load_s": load_s}

    # the experiment's float32 artifact with buckets, against the same weights eagerly
    best = os.path.join(exp_dir, "best_model.pth")
    art, fp32 = exported(best, os.path.join(root, "model.rtfsx"), "--batch-sizes",
                         ",".join(map(str, EXPORT_BUCKETS)), "--dtype", "float32")
    model, _ = serialization.load_model(best, device="cuda")
    eager = eager_serving(model, torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(12)
    served = [(torch.randn((n, SAMPLES), generator=gen, device="cuda"),
               0.1 * torch.randn((n, LIP_CHANNELS, LIP_FRAMES), generator=gen, device="cuda"))
              for n in EXPORT_REQUESTS]
    # under cuDNN's deterministic algorithms, as fit compares its exported model
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        wants = [eager(mix, emb).cpu().numpy() for mix, emb in served]
        reset_launch_counts()
        for (mix, emb), want in zip(served, wants):
            n = mix.shape[0]
            calls = bucket_calls(n)
            got = launches_of(lambda: art(mix, emb),
                              {k: v * len(calls) for k, v in per_call.items()},
                              f"artifact B={n}")
            err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
            print(f"export float32 B={n} (bucket calls {calls}) vs eager: max_abs_err {err}, "
                  f"max|ref| {scale}, tol 1e-5*max|ref| = {1e-5 * scale}")
            if got.shape != (n, 1, SAMPLES) or not np.isfinite(got).all() or \
                    not err <= 1e-5 * scale:
                fail(f"export float32 B={n}: the artifact disagrees with the eager model")
    finally:
        torch.backends.cudnn.deterministic = deterministic

    # separate --model model.rtfsx: 2 s of the separate phase's wav with its 50 frames
    wav, sr = wavio.read(os.path.join(root, "long.wav"))
    frames = np.load(os.path.join(root, "long.npz"))["data"]
    cut, cut_mouth = os.path.join(root, "cut.wav"), os.path.join(root, "cut.npz")
    wavio.write(cut, wav[:SAMPLES], sr)
    np.savez_compressed(cut_mouth, data=frames[:LIP_FRAMES])
    argv = ["--model", os.path.join(root, "model.rtfsx"), "--mouth", cut_mouth,
            "--videonet-conf", os.path.join(exp_dir, "conf.yaml"), "--device", "cuda"]
    t0 = time.perf_counter()
    (path,) = launches_of(lambda: separate_cli.main(separate_cli.parse_args(
        argv + ["--input", cut, "--output", os.path.join(root, "separated_rtfsx")])),
        per_call, "separate --model model.rtfsx")
    separate_ms = (time.perf_counter() - t0) * 1e3
    out, _ = wavio.read(path)
    if out.shape != (SAMPLES,) or not np.isfinite(out).all() or not np.abs(out).max() > 0:
        fail(f"separate --model model.rtfsx: {path} holds {out.shape}")
    try:
        separate_cli.main(separate_cli.parse_args(
            argv + ["--input", os.path.join(root, "long.wav"), "--output", root]))
        fail("separate --model model.rtfsx took a 6 s wav without --chunk-seconds")
    except SystemExit as exc:
        if "exceeds the artifact's exported segment" not in str(exc):
            raise
        print(f"separate --model model.rtfsx refuses the 6 s wav: {exc}")
    launches = launch_counts()
    print("main path launches (export): " + json.dumps(launches))

    # ms per call at B=1 float32: eager against the artifact, in turns
    requests = [(torch.randn((1, SAMPLES), generator=gen, device="cuda"),
                 0.1 * torch.randn((1, LIP_CHANNELS, LIP_FRAMES), generator=gen,
                                   device="cuda")) for _ in range(1 + 2 * SERVE_REPS)]
    b1 = turns_ms({"eager": eager, "artifact": art}, requests)
    del art, model, eager, requests
    torch.cuda.empty_cache()

    # bench.py's serving point through an artifact: the serving phase's model
    with open(CONFIG) as f:
        conf = yaml.safe_load(f)
    model = build_model(conf, device="cuda", generator=torch.Generator().manual_seed(0))
    ckpt = os.path.join(root, "serving", "best_model.pth")
    serialization.save_model(ckpt, "AVNet", conf["audionet"], model.state_dict())
    art, bf16 = exported(ckpt, os.path.join(root, "serving", "model.rtfsx"),
                         "--batch-size", str(BIG_BATCH), "--dtype", "bfloat16")
    requests = [(torch.randn((BIG_BATCH, SAMPLES), generator=gen, device="cuda"),
                 0.1 * torch.randn((BIG_BATCH, LIP_CHANNELS, LIP_FRAMES), generator=gen,
                                   device="cuda")) for _ in range(1 + BENCH_CALLS)]
    out = launches_of(lambda: art(*requests[0]), per_call, f"artifact B={BIG_BATCH}")
    if out.shape != (BIG_BATCH, 1, SAMPLES) or not np.isfinite(out).all():
        fail(f"artifact B={BIG_BATCH} bfloat16: output {out.shape}")
    torch.cuda.reset_peak_memory_stats()
    big = turns_ms({"eager": eager_serving(model, torch.bfloat16), "artifact": art},
                   requests)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    def timing(times):
        return {"min": times[0], "median": times[len(times) // 2], "calls": len(times)}

    print("export " + json.dumps({
        "card": smi, "float32_buckets": list(EXPORT_BUCKETS), **{f"float32_{k}": v for k, v in
                                                                   fp32.items()},
        **{f"bfloat16_B{BIG_BATCH}_{k}": v for k, v in bf16.items()},
        "ms_per_call_float32_B1": {k: timing(t) for k, t in b1.items()},
        f"ms_per_call_bfloat16_B{BIG_BATCH}": {k: timing(t) for k, t in big.items()},
        f"peak_mem_GiB_B{BIG_BATCH}": peak,
        "timing": "host clock around synchronised calls, in turns (eager, artifact, "
                  "artifact, eager) after a warm-up each, distinct inputs; eager is the "
                  "model call the artifact holds, without separate()'s rescale",
        "separate_rtfsx_ms": separate_ms,
        "launches_per_bucket_call": per_call}))
    return launches


def check_ctcnet(root, smi):
    """CTCNet-16 (``CTCNET_CONFIG``, the paper's baseline) at full width with
    random weights from seed 0 (phase 18), in the directory ``root`` that
    holds the ``fit``, ``evaluate`` and ``separate`` phases' data. It runs
    none of K1-K4: every call
    below launches none of them, and the phase fails otherwise. Returns the
    path's launch counts, counted from 0 just before it."""
    import numpy as np
    import torch
    import yaml

    from rtfs_net_tpu_torch import export, export_serving
    from rtfs_net_tpu_torch import separate as separate_cli
    from rtfs_net_tpu_torch import test as evaluate_cli
    from rtfs_net_tpu_torch import train
    from rtfs_net_tpu_torch.datas import wavio
    from rtfs_net_tpu_torch.models import build_model, build_video_model, serialization
    from rtfs_net_tpu_torch.utils.flops import conv_dot_macs, count_params
    from rtfs_net_tpu_torch.utils.separator import separate

    with open(CTCNET_CONFIG) as f:
        conf = yaml.safe_load(f)
    model = build_model(conf, device="cuda", generator=torch.Generator().manual_seed(0))
    video = build_video_model(conf, device="cuda", generator=torch.Generator().manual_seed(0))
    emb_chan = conf["audionet"]["pretrained_vout_chan"]
    gen = torch.Generator(device="cuda").manual_seed(13)

    def request(B):
        return (torch.randn((B, SAMPLES), generator=gen, device="cuda"),
                0.1 * torch.randn((B, emb_chan, LIP_FRAMES), generator=gen, device="cuda"))

    requests = {B: request(B) for B in SERVE_BATCHES}
    frames = (torch.randn((CTCNET_FRAMES_BATCH, SAMPLES), generator=gen, device="cuda"),
              torch.randn((CTCNET_FRAMES_BATCH, 1, VIDEO_FRAMES, MOUTH_SIZE, MOUTH_SIZE),
                          generator=gen, device="cuda"))
    dtypes = (torch.float32, torch.bfloat16)
    calls = {(B, dtype): (lambda mix=mix, third=third, dtype=dtype:
                          separate(model, mix, third, dtype=dtype))
             for B, (mix, third) in requests.items() for dtype in dtypes}
    calls.update({("frames", dtype): (lambda dtype=dtype: separate(
        model, *frames, video_model=video, dtype=dtype)) for dtype in dtypes})

    # serving: each call once, counted (no kernel may launch), then B=1 against the CPU
    reset_launch_counts()
    outs = {key: launches_of(fn, {}, f"ctcnet {key}") for key, fn in calls.items()}
    for key, out in outs.items():
        B = frames[0].shape[0] if key[0] == "frames" else key[0]
        if tuple(out.shape) != (B, 1, SAMPLES) or not bool(torch.isfinite(out).all()):
            fail(f"ctcnet {key}: output {tuple(out.shape)}, "
                 f"finite={bool(torch.isfinite(out).all())}")
    mix, emb = requests[1]
    ref = separate(copy.deepcopy(model).cpu(), mix.cpu(), emb.cpu(), device="cpu")
    err = float((outs[(1, torch.float32)].cpu() - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"ctcnet B=1 float32 vs CPU: max_abs_err {err}, max|ref| {scale}, "
          f"tol 5e-4*max|ref| = {5e-4 * scale}")
    if not err <= 5e-4 * scale:
        fail("ctcnet: B=1 float32 output disagrees with the CPU forward")
    del outs, ref
    serving = {}
    for key, fn in calls.items():
        torch.cuda.reset_peak_memory_stats()
        times = host_ms(fn, SERVE_REPS)
        B = frames[0].shape[0] if key[0] == "frames" else key[0]
        serving[f"{key[0]}_{dtype_name(key[1])}"] = {
            "ms_per_forward_median": times[len(times) // 2], "ms_per_forward_min": times[0],
            "ms_per_utt_median": times[len(times) // 2] / B,
            "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2 ** 30}

    # training: a counted step per dtype (the video FRCNN's BatchNorm statistics
    # must move), then timed steps; one float32 B=1 step against the CPU
    mix, emb = request(CTCNET_TRAIN_BATCH)
    batch = (mix, mix[:, None], emb)
    training = {}
    for dtype in dtypes:
        system = make_system(copy.deepcopy(model), dtype, CTCNET_CONFIG)
        stats = {n: b.clone() for n, b in system.model.named_buffers()
                 if n.endswith(("running_mean", "running_var"))}

        def step():
            out = system.train_step(batch, generator=torch.Generator(device="cuda").manual_seed(4))
            loss, gnorm = float(out["loss"]), float(out["grad_norm"])
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                fail(f"ctcnet train {dtype}: loss {loss}, grad_norm {gnorm}")
            return loss, gnorm

        torch.cuda.reset_peak_memory_stats()
        loss, gnorm = launches_of(step, {}, f"ctcnet train {dtype}")
        buffers = dict(system.model.named_buffers())
        still = [n for n, b in stats.items() if torch.equal(b, buffers[n])]
        if not stats or still:
            fail(f"ctcnet train {dtype}: BatchNorm statistics unmoved: {still or 'none'}")
        times = host_ms(step, CTCNET_TRAIN_STEPS)
        training[dtype_name(dtype)] = {
            "B": CTCNET_TRAIN_BATCH, "ms_per_step_median": times[len(times) // 2],
            "ms_per_step_min": times[0], "loss": loss, "grad_norm": gnorm,
            "batchnorm_buffers_moved": len(stats),
            "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2 ** 30}
        del system
    torch.cuda.empty_cache()
    check_train_parity(conf["audionet"], CTCNET_CONFIG, "ctcnet train")

    # the training entry point for one epoch on the fit phase's manifest; its
    # best_model.pth reloaded and exported, one artifact call against eager
    argv = ["--conf-dir", CTCNET_CONFIG, "--train_dir", os.path.join(root, "tr"),
            "--valid_dir", os.path.join(root, "cv"), "--path", os.path.join(root, "ctcnet"),
            "--batch_size", str(FIT_BATCH), "--num_workers", str(FIT_WORKERS),
            "--device", "cuda", "--pretrain", "", "--epochs", "1"]
    fit_conf = train.parse_conf(argv)
    torch.cuda.reset_peak_memory_stats()
    with FitWatch() as watch:
        trainer = train.main(fit_conf)
    watch.check_launches("ctcnet fit", want_step={}, want_val={})
    history = trainer.history
    if len(history) != 1 or not (math.isfinite(history[0]["train_loss"])
                                 and math.isfinite(history[0]["val_loss"])):
        fail(f"ctcnet fit: history {history}")
    step_ms = sorted(watch.ms(watch.steps))
    fit = {"B": FIT_BATCH, "dtype": "float32", "epoch_wall_s": history[0]["wall_s"],
           "ms_per_train_step_median": step_ms[len(step_ms) // 2],
           "train_loss": history[0]["train_loss"], "val_loss": history[0]["val_loss"],
           "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2 ** 30}
    del trainer, watch
    best = os.path.join(fit_conf["log"]["path"], fit_conf["log"]["exp_name"], "best_model.pth")
    loaded, _ = serialization.load_model(best, device="cuda")
    path, seconds = export_serving.main(["--ckpt", best, "--out",
                                         os.path.join(root, "ctcnet.rtfsx"), "--device", "cuda",
                                         "--batch-size", "1", "--dtype", "float32"])
    art = export.load_artifact(path)
    nodes = export.op_counts(art.program(1))
    if nodes:
        fail(f"ctcnet export: rtfs op nodes {nodes}, want none")
    mix, emb = request(1)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want = eager_serving(loaded, torch.float32)(mix, emb).cpu().numpy()
        got = launches_of(lambda: art(mix, emb), {}, "ctcnet artifact B=1")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    print(f"ctcnet export float32 B=1 vs eager: max_abs_err {err}, max|ref| {scale}, "
          f"tol 1e-5*max|ref| = {1e-5 * scale}")
    if got.shape != (1, 1, SAMPLES) or not np.isfinite(got).all() or not err <= 1e-5 * scale:
        fail("ctcnet export: the artifact disagrees with the eager model")
    exported = {"export_s": seconds, "artifact_MB": os.path.getsize(path) / 1e6,
                "max_abs_err": err}
    del art, loaded

    # the evaluation and separation entry points on that experiment: the
    # evaluate phase's test manifest, and the separate phase's 6 s wav
    exp_dir = os.path.dirname(best)
    eval_conf = evaluate_cli.parse_conf(["--conf-dir", os.path.join(exp_dir, "conf.yaml"),
                                         "--test-dir", os.path.join(root, "tt"),
                                         "--device", "cuda"])
    evaluated = launches_of(lambda: evaluate_cli.main(eval_conf), {}, "ctcnet test.main")
    rows, _ = metric_rows(os.path.join(evaluated["save_dir"], "metrics.csv"))
    if len(rows) != EVAL_ITEMS + 2 or not all(
            math.isfinite(float(r[col])) for r in rows[:-2]
            for col in ("si-snr", "sdr", "stoi", "pesq")):
        fail(f"ctcnet test.main: metrics.csv has {len(rows)} rows, or a non-finite one")
    argv = ["--model", best, "--input", os.path.join(root, "long.wav"),
            "--mouth", os.path.join(root, "long.npz"),
            "--videonet-conf", os.path.join(exp_dir, "conf.yaml"),
            "--output", os.path.join(root, "ctcnet_separated"), "--device", "cuda"]
    t0 = time.perf_counter()
    (path,) = launches_of(lambda: separate_cli.main(separate_cli.parse_args(argv)), {},
                          "ctcnet separate")
    separate_ms = (time.perf_counter() - t0) * 1e3
    out, _ = wavio.read(path)
    if out.shape != (SEPARATE_SECONDS * 16000,) or not np.isfinite(out).all():
        fail(f"ctcnet separate: {path} holds {out.shape}")
    stats = evaluated["eval"]
    entry_points = {"test_utt_per_s": stats["utterances"] / stats["wall_s"],
                    "test_items": EVAL_ITEMS, f"separate_{SEPARATE_SECONDS}s_ms": separate_ms}

    # MACs of one 2 s forward (a CPU copy), and where a B=16 bfloat16 forward's time goes
    macs = conv_dot_macs(model, *requests[1])
    print(f"ctcnet MACs per 2 s forward: {macs / 1e9:.2f} G (paper {CTCNET_PAPER_GMACS} G)")
    if not abs(macs / 1e9 - CTCNET_PAPER_GMACS) <= 0.05 * CTCNET_PAPER_GMACS:
        fail(f"ctcnet: {macs / 1e9} GMACs, not within 5% of the paper's {CTCNET_PAPER_GMACS}")
    mix, emb = requests[16]
    profile = launches_of(lambda: profile_line(
        {"model": "CTCNet-16", "dtype": "bfloat16", "B": 16},
        lambda: separate(model, mix, emb, dtype=torch.bfloat16), PROFILE_ITERS, ()),
        {}, "ctcnet profile")
    launches = launch_counts()
    print("main path launches (ctcnet): " + json.dumps(launches))
    if any(launches.values()):
        fail(f"ctcnet: kernels launched {launches}, want none")
    print("ctcnet " + json.dumps({
        "card": smi, "config": os.path.basename(CTCNET_CONFIG),
        "params": count_params(model), "gmacs_per_2s_forward": macs / 1e9,
        "serving": serving, "frames_batch": CTCNET_FRAMES_BATCH, "train": training,
        "fit": fit, "export_B1_float32": exported, "entry_points": entry_points,
        "profile_bfloat16_B16": {k: profile[k] for k in (
            "wall_ms", "device_busy_ms", "idle_share", "kernel_launches")},
        "timing": "host clock around synchronised calls (serving: median of 7, train: "
                  f"of {CTCNET_TRAIN_STEPS}); fit step: CUDA events",
        "launches": launches}))
    del model, video
    torch.cuda.empty_cache()
    return launches


def check_dw_conv_planes():
    """K3 at ShuffleNet's planes: (50·B, C, H, W) for B = 4 frames at width
    1.0, 3x3, pads (1, 1). Forward and dx (through the autograd Function)
    against the plain version in both dtypes; device times of each (median
    of ``PLANE_TIMINGS`` runs of 20 launches, inputs rotated past the L2),
    the bytes bound and ``F.conv2d(groups=C, padding=1)``'s time. Returns
    the rows."""
    import torch
    import torch.nn.functional as F

    _, _, kdw, _ = kernel_modules()
    gen = torch.Generator(device="cuda").manual_seed(14)
    pads, frames = ((1, 1), (1, 1)), SHUFFLE_PLANE_BATCH * VIDEO_FRAMES
    rows = []

    def median_ms(fn):
        times = sorted(event_ms(fn, reps=20) for _ in range(PLANE_TIMINGS))
        return times[len(times) // 2]

    for (Hp, Wp), (_, C) in SHUFFLE_DW.items():
        shape = (frames, C, Hp, Wp)
        for dtype in (torch.float32, torch.bfloat16):
            err, dx_err = check_dw_forward_dx(shape, (3, 3), pads, 0, dtype, gen, "plane")
            n, item = math.prod(shape), torch.tensor([], dtype=dtype).element_size()
            w = torch.randn((C, 1, 3, 3), generator=gen, device="cuda")
            copies = 1 + int(100e6 // (n * item))
            xs = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                  for _ in range(copies)]
            it, wt, w_lib = itertools.count(), w.flip(2, 3), w.to(dtype)
            with torch.no_grad():
                ms = median_ms(lambda: kdw.dw_conv2d_same(xs[next(it) % copies], w, pads))
                dx_ms = median_ms(lambda: kdw.dw_conv2d_same(xs[next(it) % copies], wt, pads))
                library_ms = median_ms(lambda: F.conv2d(xs[next(it) % copies], w_lib,
                                                        padding=1, groups=C))
            bytes_ms = (2 * n * item + w.numel() * 4) / HBM_BYTES_PER_S * 1e3
            ops_ms = 2 * 9 * n / FP32_OPS_PER_S * 1e3
            row = {"x": shape, "dtype": dtype_name(dtype), "max_abs_err": err,
                   "dx_max_abs_err": dx_err, "ms": ms, "dx_ms": dx_ms,
                   "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                   "slower_than_library": ms > library_ms}
            print("dw_conv2d_same shufflenet plane " + json.dumps(row))
            rows.append(row)
            del xs
    return rows


def zoo_conf(videonet, emb_chan):
    """RTFS-Net-4's YAML with ``videonet`` over its video block and the
    audio model's embedding channels set to ``emb_chan``."""
    import yaml

    with open(CONFIG) as f:
        conf = yaml.safe_load(f)
    conf["videonet"] = {**conf["videonet"], **videonet}
    conf["audionet"]["pretrained_vout_chan"] = emb_chan
    return conf


def frame_requests_for(batches, gen):
    import torch

    return {B: (torch.randn((B, SAMPLES), generator=gen, device="cuda"),
                torch.randn((B, 1, VIDEO_FRAMES, MOUTH_SIZE, MOUTH_SIZE), generator=gen,
                            device="cuda"))
            for B in batches}


def check_video_zoo(root, smi):
    """Phase 19: the video front-end's other backbones and the last two
    CLIs, in the directory ``root``. K3 at ShuffleNet's planes against its
    plain version; RTFS-Net-4 served from frames through ShuffleNetV2 (53 K3
    launches a forward); each width's video model alone against the CPU; ``train_autoencoder.main`` on a synthetic mouth-track manifest, its
    checkpoint loaded into ``AEVideoModel``, which then serves and trains
    under RTFS-Net-4; ``find_unused_params.main`` on the card against the
    CPU. Returns each path's launch counts, counted from 0 just before it."""
    import torch

    from rtfs_net_tpu_torch import find_unused_params, train, train_autoencoder
    from rtfs_net_tpu_torch.losses import PITLossWrapper, pairwise_neg_sisdr, pairwise_neg_snr
    from rtfs_net_tpu_torch.models import build_model, build_video_model
    from rtfs_net_tpu_torch.system import System, make_optimizer
    from rtfs_net_tpu_torch.utils.separator import separate

    planes = check_dw_conv_planes()
    paths, out = {}, {"card": smi, "k3_planes": planes}
    gen = torch.Generator(device="cuda").manual_seed(15)

    # ShuffleNetV2 at width 1.0 behind RTFS-Net-4: 32 K1 and 40 + 13 K3 a forward
    conf = zoo_conf({"backbone_type": "shufflenet", "width_mult": SHUFFLE_WIDTH}, 1024)
    model = build_model(conf, device="cuda", generator=torch.Generator().manual_seed(0))
    video = build_video_model(conf, device="cuda", generator=torch.Generator().manual_seed(0))
    requests = frame_requests_for(SERVE_BATCHES + (BIG_BATCH,), gen)
    paths["shufflenet_serving"], outs, out["shufflenet_serving"] = check_serving(
        "serving from frames (shufflenet)", model, requests, video,
        {"K1": SRU_LAUNCHES, "K3": DW_LAUNCHES + SHUFFLE_DW_LAUNCHES})
    del outs
    mix, frames = requests[BIG_BATCH]
    profile = profile_line({"from": "frames (shufflenet)", "dtype": "bfloat16", "B": BIG_BATCH},
                           lambda: separate(model, mix, frames, video_model=video,
                                            dtype=torch.bfloat16), 1, SERVING_CATEGORIES)
    out["shufflenet_profile_bfloat16_B128"] = {k: profile[k] for k in (
        "wall_ms", "device_busy_ms", "idle_share", "kernel_launches", "by_category_ms")}
    del model, video, requests, mix, frames
    torch.cuda.empty_cache()

    # each width's video model alone, B=1 float32 against the CPU
    reset_launch_counts()
    frames = torch.randn((1, 1, VIDEO_FRAMES, MOUTH_SIZE, MOUTH_SIZE), generator=gen,
                         device="cuda")
    widths = {}
    for width in SHUFFLE_WIDTHS:
        video = build_video_model({**conf["videonet"], "width_mult": width}, device="cuda",
                                  generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            got = launches_of(lambda: video(frames), {"K3": SHUFFLE_DW_LAUNCHES},
                              f"shufflenet width {width}")
            ref = copy.deepcopy(video).cpu()(frames.cpu())
        err, scale = float((got.cpu() - ref).abs().max()), float(ref.abs().max())
        widths[str(width)] = {"max_abs_err": err, "max_abs_ref": scale,
                              "shape": list(got.shape)}
        print(f"shufflenet width {width} B=1 float32 vs CPU: max_abs_err {err}, "
              f"max|ref| {scale}, tol 5e-4*max|ref| = {5e-4 * scale}")
        if tuple(got.shape) != (1, video.backend_out, VIDEO_FRAMES) or not err <= 5e-4 * scale:
            fail(f"shufflenet width {width}: {tuple(got.shape)} disagrees with the CPU")
    paths["shufflenet_widths"] = launch_counts()
    out["shufflenet_widths"] = widths
    del video

    # the autoencoder: train_autoencoder.main on mouth tracks, then its
    # encoder as AEVideoModel behind RTFS-Net-4, serving and in a train step
    data = write_fit_manifest(os.path.join(root, "ae_data"))
    exp = os.path.join(root, "autoencoder")
    args = train_autoencoder.parse_args([
        "--train-dir", data["tr"], "--valid-dir", data["cv"], "--exp-dir", exp,
        "--epochs", str(AE_EPOCHS), "--batch-size", str(AE_BATCH), "--device", "cuda"])
    reset_launch_counts()
    trained = launches_of(lambda: train_autoencoder.main(args), {}, "train_autoencoder")
    paths["train_autoencoder"] = launch_counts()
    history = trained["history"]
    if (len(history) != AE_EPOCHS or not all(math.isfinite(h["train_loss"])
                                            and math.isfinite(h["val_loss"]) for h in history)
            or trained["best_model"] is None
            or not os.path.exists(os.path.join(exp, "best_k_models.json"))):
        fail(f"train_autoencoder: history {history}, best {trained['best_model']}")
    out["train_autoencoder"] = {"B": AE_BATCH, "history": history}
    conf = zoo_conf({"model_name": "AEVideoModel", "in_channels": 1, "base_channels": 4,
                     "num_layers": 3, "pretrain": trained["best_model"]}, AE_EMBEDDING)
    conf["main_args"], conf["audionet"]["video_bn_params"] = {}, AE_VIDEO_BN
    video = train.build_video_model(conf, device="cuda")
    saved = torch.load(trained["best_model"], weights_only=True)
    if any(not torch.equal(video.state_dict()[f"encoder.{k}"].cpu(), t) for k, t in saved.items()):
        fail("AEVideoModel does not hold the checkpoint's encoder")
    model = build_model(conf, device="cuda", generator=torch.Generator().manual_seed(0))
    paths["autoencoder_serving"], outs, out["autoencoder_serving"] = check_serving(
        "serving from frames (autoencoder)", model, frame_requests_for(AE_SERVE_BATCHES, gen),
        video)
    del outs

    # one train step at B=4 with the backbone unfrozen: its parameters move
    system = System(model, make_optimizer(model.parameters(), **conf["optim"]),
                    {"train": PITLossWrapper(pairwise_neg_snr),
                     "val": PITLossWrapper(pairwise_neg_sisdr)},
                    video_model=video, train_video_model=True)
    mix, frames = frame_requests_for((TRAIN_BATCHES[0],), gen)[TRAIN_BATCHES[0]]
    before = {k: t.clone() for k, t in video.state_dict().items()}

    def step():
        result = system.train_step((mix, mix[:, None], frames),
                                   generator=torch.Generator(device="cuda").manual_seed(4))
        loss, gnorm = float(result["loss"]), float(result["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"autoencoder train step: loss {loss}, grad_norm {gnorm}")
        return loss

    reset_launch_counts()
    loss = launches_of(step, {"K2_forward": 64, "K2_backward": 32, "K3": 3 * DW_LAUNCHES},
                       "autoencoder train step")
    paths["autoencoder_train"] = launch_counts()
    still = [k for k, t in video.state_dict().items() if torch.equal(t, before[k])]
    if still:
        fail(f"autoencoder train step: AEVideoModel parameters unmoved: {still}")
    times = host_ms(step, 3)
    out["autoencoder_train_step"] = {"B": TRAIN_BATCHES[0], "dtype": "float32", "loss": loss,
                                     "ms_per_step_median": times[1], "ms_per_step_min": times[0],
                                     "params_moved": len(before)}
    del system, model, video
    torch.cuda.empty_cache()

    # find_unused_params at full width: the card's list against the CPU's
    reset_launch_counts()
    argv = ["--conf-dir", CONFIG]
    unused = launches_of(
        lambda: find_unused_params.main(find_unused_params.parse_args(argv + ["--device",
                                                                              "cuda"])),
        {"K2_forward": SRU_LAUNCHES, "K2_backward": SRU_LAUNCHES, "K3": 2 * DW_LAUNCHES},
        "find_unused_params")
    paths["find_unused_params"] = launch_counts()
    on_cpu = find_unused_params.main(find_unused_params.parse_args(argv + ["--device", "cpu"]))
    print(f"find_unused_params: {len(unused)} unused on the card, {len(on_cpu)} on the CPU")
    if unused != on_cpu:
        fail(f"find_unused_params: the card lists {unused}, the CPU {on_cpu}")
    out["find_unused_params"] = {"unused": len(unused), "names": unused}
    out["launches"] = paths
    print("video_zoo " + json.dumps(out))
    return paths


def check_bench(bench_point_ms_per_utt):
    """The port's benchmark, ``python -m rtfs_net_tpu_torch.bench``, in a
    process of its own: its last line has exactly ``bench.py``'s keys, every
    value finite, and its serving time per utterance lies within
    ``BENCH_SERVING_RTOL`` of ``check_bench_point``'s in this run; its
    launches are K1 32 and K3 40 per serving call, K2 64 + 32 and K3 120
    per train step, and nothing else. Prints the bench's line; returns its
    launches by kernel."""
    import torch

    from rtfs_net_tpu_torch import bench

    torch.cuda.empty_cache()  # the bench's own process needs the card's memory
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "rtfs_net_tpu_torch.bench"], cwd=HERE,
                          capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode:
        fail(f"bench: exit {proc.returncode}: {proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1])
    launches = json.loads(next(line for line in reversed(lines)
                               if line.startswith("launches "))[len("launches "):])
    if list(result) != list(bench.KEYS):
        fail(f"bench: keys {list(result)}, want {list(bench.KEYS)}")
    if not all(math.isfinite(v) for k, v in result.items() if k not in ("metric", "unit")):
        fail(f"bench: non-finite values {result}")
    step = {"K2_forward": 64, "K2_backward": 32, "K3": 3 * DW_LAUNCHES}
    per_call = {"serving": ({"K1": SRU_LAUNCHES, "K3": DW_LAUNCHES}, 2 + BENCH_TIMED),
                "train_b4": (step, 1 + BENCH_TIMED), "train_b16": (step, 1 + BENCH_TIMED)}
    for phase, (counts, calls) in per_call.items():
        want = {k: counts.get(k, 0) * calls for k in launch_counts()}
        if launches.get(phase) != want:
            fail(f"bench {phase}: launches {launches.get(phase)}, want {want}")
    ratio = result["inference_ms_per_utt"] / bench_point_ms_per_utt
    print("bench " + json.dumps({
        "wall_s": wall, "check_bench_point_ms_per_utt": bench_point_ms_per_utt,
        "serving_ratio": ratio, "serving_rtol": BENCH_SERVING_RTOL, "launches": launches}))
    print("bench line " + lines[-1])
    if abs(ratio - 1) > BENCH_SERVING_RTOL:
        fail(f"bench: serving {result['inference_ms_per_utt']} ms/utt, check_bench_point "
             f"{bench_point_ms_per_utt} ms/utt")
    return {k: sum(counts[k] for counts in launches.values()) for k in launch_counts()}


def parallel_rank(root):
    """The parallel phase on this rank of the process group: a DDP +
    SyncBatchNorm train step of RTFS-Net-4 at full width (float32, SGD
    with the config's lr and weight decay, dropout as configured) on this
    rank's shard of a global batch of ``PARALLEL_BATCH``, against the plain
    ``System.train_step`` on the whole batch from the same weights and
    generator seed, both under cuDNN's deterministic algorithms: loss,
    parameters and BatchNorm buffers within ``PARALLEL_TOL``, gradients
    within ``PARALLEL_TOL``·max|g|; K2 64 + 32 and K3 120 launches. (Not
    AdamW: two plain steps on the card already differ by ~1e-7·max|g| in
    their gradients, PyTorch's ``adaptive_avg_pool2d`` backward having no
    deterministic implementation, and AdamW's first update, lr·g/(|g| +
    eps), turns that into up to ~3e-4 where |g| is near zero; both spreads
    are measured and printed.) A second DDP step (DDP is built without
    ``find_unused_parameters`` and raises in it if the first left a
    parameter without gradient); then ``dryrun_multichip`` over the group;
    then ``train.main`` for one epoch on the fit phase's manifest under
    ``root`` (global batch 4), training data-parallel through the trainer
    (every step K2 64 + 32 and K3 120, every validation batch K1 32 and K3
    40). Returns the comparison, the dry run's and the epoch's results and
    the launches from the DDP steps on (the plain steps' not counted)."""
    import torch
    import torch.distributed as dist

    from rtfs_net_tpu_torch import train
    from rtfs_net_tpu_torch.dryrun import dryrun_multichip
    from rtfs_net_tpu_torch.models import build_model
    from rtfs_net_tpu_torch.parallel import make_mesh, make_parallel_train_step, shard_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        base = build_model(rtfs4_conf(), device="cuda",
                           generator=torch.Generator().manual_seed(0))
        batch = train_batch(PARALLEL_BATCH, torch.Generator(device="cuda").manual_seed(12))

        def worst(a, b):
            return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))

        def stepped(system):
            out = system.train_step(batch, torch.Generator(device="cuda").manual_seed(13))
            return system, out, list(system.model.parameters())

        plain, want, plain_params = stepped(make_system(copy.deepcopy(base), torch.float32,
                                                        optimizer="sgd"))
        # the plain step's own run-to-run spread: gradients (SGD) and, through
        # AdamW's first update, parameters
        _, _, again = stepped(make_system(copy.deepcopy(base), torch.float32, optimizer="sgd"))
        _, _, adam0 = stepped(make_system(copy.deepcopy(base), torch.float32))
        _, _, adam1 = stepped(make_system(copy.deepcopy(base), torch.float32))
        noise = {"plain_vs_plain_grad_diff": worst([p.grad for p in again],
                                                   [p.grad for p in plain_params]),
                 "adamw_plain_vs_plain_param_diff": worst([p.detach() for p in adam0],
                                                          [p.detach() for p in adam1])}
        del again, adam0, adam1
        system = make_system(copy.deepcopy(base), torch.float32, optimizer="sgd")
        mesh = make_mesh(batch_size=PARALLEL_BATCH)
        step = make_parallel_train_step(system, mesh)
        local = shard_batch(batch, mesh)
        reset_launch_counts()
        step_launches = {"K2_forward": 64, "K2_backward": 32, "K3": 3 * DW_LAUNCHES}
        got = launches_of(lambda: step(local, torch.Generator(device="cuda").manual_seed(13)),
                          step_launches, "parallel: DDP step")
        sync_bn = sum(type(m).__name__ == "SyncBatchNorm" for m in system.model.modules())
        if type(system.replica).__name__ != "DistributedDataParallel" or not sync_bn:
            fail(f"parallel: replica {type(system.replica).__name__}, {sync_bn} SyncBatchNorms")

        params = list(system.model.parameters())
        compared = {
            "loss": float(got["loss"]), "loss_plain": float(want["loss"]),
            "max_param_diff": worst([p.detach() for p in params],
                                    [p.detach() for p in plain_params]),
            "max_buffer_diff": worst(list(system.model.buffers()),
                                     list(plain.model.buffers())),
            "max_grad_diff": worst([p.grad for p in params], [p.grad for p in plain_params]),
            "max_abs_grad": max(float(p.grad.abs().max()) for p in plain_params),
            "sync_batchnorms": sync_bn, "mesh": [mesh.size, mesh.index], **noise}
        if not (abs(compared["loss"] - compared["loss_plain"])
                <= PARALLEL_TOL * abs(compared["loss_plain"])
                and compared["max_param_diff"] <= PARALLEL_TOL
                and compared["max_buffer_diff"] <= PARALLEL_TOL
                and compared["max_grad_diff"] <= PARALLEL_TOL * compared["max_abs_grad"]):
            fail(f"parallel: the DDP step differs from the plain step: {compared}")
        launches_of(lambda: step(local, torch.Generator(device="cuda").manual_seed(14)),
                    step_launches, "parallel: second DDP step")
        del base, plain, system, step
        dry = dryrun_multichip(dist.get_world_size())

        argv = ["--conf-dir", CONFIG, "--train_dir", os.path.join(root, "tr"),
                "--valid_dir", os.path.join(root, "cv"),
                "--path", os.path.join(root, "ddp_log"), "--batch_size", str(FIT_BATCH),
                "--num_workers", "2", "--device", "cuda", "--pretrain", "", "--epochs", "1"]
        with FitWatch() as watch:
            trainer = train.main(train.parse_conf(argv))
        watch.check_launches("parallel fit")
        epoch = {"steps": trainer.system.step, "mesh": [trainer.mesh.size, trainer.mesh.index],
                 "replica": type(trainer.system.replica).__name__,
                 "history": trainer.history}
        if trainer.system.step != FIT_ITEMS["tr"] // FIT_BATCH or \
                epoch["replica"] != "DistributedDataParallel" or not all(
                    math.isfinite(h[k]) for h in trainer.history
                    for k in ("train_loss", "val_loss")):
            fail(f"parallel fit: {epoch}")
        return {"ddp_step": compared, "dryrun": dry, "fit": epoch, "launches": launch_counts()}
    finally:
        torch.backends.cudnn.deterministic = deterministic


def check_parallel(root):
    """The data-parallel path over ``torch.cuda.device_count()`` ranks, NCCL
    meeting through a file under ``root``: with one card this process is
    rank 0 of 1 (and no collective crosses a card); with more, every rank is
    a process of its own (``parallel.launch``). Runs ``parallel_rank`` on
    each and prints a ``parallel`` line. Returns rank 0's launches."""
    import torch

    from rtfs_net_tpu_torch import parallel

    cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    if cards == 1:
        parallel.initialize("cuda", init_method="file://" + os.path.join(root, "rendezvous"),
                            world_size=1, rank=0)
        try:
            results = [parallel_rank(root)]
        finally:
            parallel.shutdown()
    else:
        results = parallel.launch(parallel_rank, cards, (root,), device="cuda")
    print("parallel " + json.dumps({
        "cards": cards, "world_size": len(results), "backend": "nccl",
        "wall_s": time.perf_counter() - t0, "ddp_step": results[0]["ddp_step"],
        "tolerance": PARALLEL_TOL, "dryrun": results[0]["dryrun"], "fit": results[0]["fit"],
        "launches": results[0]["launches"],
        "still_to_come": "a data-parallel run over two or more cards" if cards == 1 else None}))
    return results[0]["launches"]


def lstm_conf():
    """RTFS-Net-4's ``audionet`` with ``rnn_type: LSTM`` in both DualPathRNNs."""
    conf = rtfs4_conf()
    for name in ("layer_1", "layer_2"):
        conf["audio_params"]["layers"][name]["rnn_type"] = "LSTM"
    return conf


def dpt_conf():
    """RTFS-Net-4's ``audionet`` with DPTNet separators: the audio one 2-D at
    hid 64 over the bottleneck's 256 channels, 4 shared repeats of an SRU
    DualPathRNN along F (hid 32, 4 layers), a GRU one along T and a
    GlobalAttention2D with its group FFN; the video one 1-D, a
    GlobalAttentionRNN and a GlobalAttention with a ConvolutionalRNN FFN."""
    conf = rtfs4_conf()
    srnn = conf["audio_params"]["layers"]["layer_1"]
    conf["audio_params"] = {
        "audio_net": "DPTNet", "hid_chan": 64, "repeats": 4, "shared": True, "is2d": True,
        "layers": {
            "layer_1": srnn,
            "layer_2": {**srnn, "dim": 3, "rnn_type": "GRU", "num_layers": 1},
            "layer_3": {"layer_type": "GlobalAttention2D", "kernel_size": 5,
                        "group_ffn": True}}}
    conf["video_params"] = {
        "video_net": "DPTNet", "hid_chan": 64, "repeats": 1, "shared": True, "is2d": False,
        "layers": {"layer_1": {"layer_type": "GlobalAttentionRNN"},
                   "layer_2": {"layer_type": "GlobalAttention", "kernel_size": 3,
                               "ffn_name": "ConvolutionalRNN"}}}
    return conf


def dpt_launches(conf):
    """K1 and K3 launches of one serving forward of an AVNet whose audio net
    is the DPTNet of ``conf``: every repeat runs each SRU DualPathRNN layer
    (one K1 launch each) and each GlobalAttention2D's group FFN twice (one
    K3 launch each: its 2-D depthwise refiner). A train step launches K2
    forward twice per layer (the checkpointed block runs again in the
    backward), K2 backward once, and K3 three times per conv (forward,
    recompute, input gradient)."""
    params = conf["audio_params"]
    layers = params["layers"].values()
    k1 = params["repeats"] * sum(l["num_layers"] for l in layers
                                 if l["layer_type"] == "DualPathRNN" and l["rnn_type"] == "SRU")
    k3 = params["repeats"] * sum(2 for l in layers
                                 if l["layer_type"] == "GlobalAttention2D" and l["group_ffn"])
    return ({"K1": k1, "K3": k3},
            {"K2_forward": 2 * k1, "K2_backward": k1, "K3": 3 * k3})


def zoo_train_step(label, model, want, dtype=None, optimizer=None):
    """One counted ``System.train_step`` at B = TRAIN_BATCHES[0] (dropout
    masks from a card generator), then 3 timed ones; fails on a non-finite
    loss or an unmoved parameter. Returns the step's launches and numbers."""
    import torch

    dtype = dtype or torch.float32
    system = make_system(model, dtype, optimizer=optimizer)
    batch = train_batch(TRAIN_BATCHES[0], torch.Generator(device="cuda").manual_seed(21))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    def step():
        out = system.train_step(batch, generator=torch.Generator(device="cuda").manual_seed(4))
        loss, gnorm = float(out["loss"]), float(out["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"{label}: loss {loss}, grad_norm {gnorm}")
        return loss

    reset_launch_counts()
    loss = launches_of(step, want, label)
    launches = launch_counts()
    unmoved = [n for n, p in model.named_parameters() if torch.equal(p, before[n])]
    if len(unmoved) == len(before):
        fail(f"{label}: no parameter moved")
    torch.cuda.reset_peak_memory_stats()
    times = host_ms(step, 3)
    return launches, {"B": TRAIN_BATCHES[0], "dtype": dtype_name(dtype), "loss": loss,
                      "ms_per_step_median": times[1], "ms_per_step_min": times[0],
                      "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2 ** 30}


def compare_rnn_routes():
    """One DualPathRNN along F at RTFS-Net-4's plane, B = 16: the LSTM
    (cuDNN in float32; cuDNN takes no bfloat16 RNN, so PyTorch's per-step
    CUDA cells there) against the SRU (K1), device ms by CUDA events; and
    the port's LSTM, which passes its weights cast per call as a list, against
    ``nn.LSTM`` on one flattened buffer, on the same windows."""
    import torch

    from rtfs_net_tpu_torch.models import init_weights
    from rtfs_net_tpu_torch.models.layers import DualPathRNN
    from rtfs_net_tpu_torch.ops.conv import unfold_1d

    C, T, F_ = ZOO_PLANE
    B = SERVE_BATCHES[-1]
    layer = rtfs4_conf()["audio_params"]["layers"]["layer_1"]
    kw = {k: v for k, v in layer.items() if k != "layer_type"}
    x = torch.randn((B, C, T, F_), generator=torch.Generator(device="cuda").manual_seed(22),
                    device="cuda")
    out = {"bf16_cudnn_acceptable": bool(torch.backends.cudnn.is_acceptable(
        x.to(torch.bfloat16)))}
    for rnn_type in ("SRU", "LSTM"):
        m = init_weights(DualPathRNN(C, **{**kw, "rnn_type": rnn_type}),
                         torch.Generator().manual_seed(0)).cuda().eval()
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            with torch.no_grad():
                out[f"{rnn_type}_{dtype_name(dtype)}_ms"] = event_ms(lambda: m(xd), 5)
    lstm = m.rnn
    ref = torch.nn.LSTM(C * kw["kernel_size"], kw["hid_chan"], kw["num_layers"],
                        bidirectional=True).cuda()
    ref.load_state_dict(lstm.state_dict())
    seq = unfold_1d(x.transpose(-2, -1).permute(0, 3, 1, 2).reshape(B * T, C, F_),
                    kw["kernel_size"], kw["stride"]).permute(2, 0, 1).contiguous()
    with torch.no_grad():
        err = float((lstm(seq) - ref(seq)[0]).abs().max())
        out["lstm_weight_list_ms"] = event_ms(lambda: lstm(seq), 5)
        out["lstm_flattened_ms"] = event_ms(lambda: ref(seq), 5)
    out["lstm_vs_nn_lstm_max_abs_err"] = err
    if not err <= 1e-5:
        fail(f"the port's LSTM differs from nn.LSTM by {err}")
    print("layer_zoo rnn routes " + json.dumps(out))
    return out


def zoo_layers():
    """The new layers alone at C = CHANNELS, B = ZOO_LAYER_BATCH, on
    RTFS-Net-4's (125, 64) plane: name -> (module, K3 launches a forward)."""
    from rtfs_net_tpu_torch.models import layers as L

    C, T, F_ = ZOO_PLANE
    return {
        "BiLSTM2D": (L.BiLSTM2D(C, 32), 0),
        "GlobalGALR": (L.GlobalGALR(C, group_ffn=True), 1),
        "CBAMBlock": (L.CBAMBlock(C), 0),
        "ShuffleAttention": (L.ShuffleAttention(C), 0),
        "CoTAttention": (L.CoTAttention(C), 0),
        "MLP": (L.MLP(C, (T, F_), 8), 0),
        "Permutator": (L.Permutator(C, (T, F_), 8), 0),
        "DepthwiseSeparableConvolution": (L.DepthwiseSeparableConvolution(
            C, C, 5, norm_type="gLN", act_type="PReLU", is2d=True), 1),
        "ConvolutionalRNN": (L.ConvolutionalRNN(C, 2 * C, 5, is2d=True), 2),
        "DualPathRNN_Attn_ffn": (L.DualPathRNN(C, 32, 3, rnn_type="Attn", apply_ffn=True), 0),
    }


def check_zoo_layers():
    """Each layer of ``zoo_layers`` in float32 against the CPU within
    5e-4·max|ref|, in bfloat16 finite, with its K3 launches."""
    import torch

    from rtfs_net_tpu_torch.models import init_weights

    C, T, F_ = ZOO_PLANE
    x = torch.randn((ZOO_LAYER_BATCH, C, T, F_),
                    generator=torch.Generator(device="cuda").manual_seed(23), device="cuda")
    rows = {}
    reset_launch_counts()
    for name, (module, k3) in zoo_layers().items():
        module = init_weights(module, torch.Generator().manual_seed(0)).eval()
        ref_module = copy.deepcopy(module)
        module = module.cuda()
        with torch.no_grad():
            got = launches_of(lambda: module(x), {"K3": k3}, f"layer_zoo {name}")
            ref = ref_module(x.cpu())
            half = module(x.to(torch.bfloat16))
        err, scale = float((got.cpu() - ref).abs().max()), float(ref.abs().max())
        rows[name] = {"max_abs_err": err, "max_abs_ref": scale, "K3": k3,
                      "bf16_finite": bool(torch.isfinite(half).all())}
        print(f"layer_zoo {name} B={ZOO_LAYER_BATCH} float32 vs CPU: max_abs_err {err}, "
              f"max|ref| {scale}, tol 5e-4*max|ref| = {5e-4 * scale}")
        if tuple(got.shape) != tuple(x.shape) or not err <= 5e-4 * scale:
            fail(f"layer_zoo {name}: {tuple(got.shape)} disagrees with the CPU")
        if not rows[name]["bf16_finite"]:
            fail(f"layer_zoo {name}: non-finite bfloat16 output")
    return launch_counts(), rows


def check_zoo_optimizers():
    """Every optimizer name of the registry, ZOO_OPT_STEPS steps over
    RTFS-Net-4's parameters with one gradient (one B=1 backward), on the
    card and on the CPU from the same start: within ZOO_OPT_TOL·max|p|."""
    import torch

    from rtfs_net_tpu_torch.models import build_model
    from rtfs_net_tpu_torch.system import make_optimizer, optimizers

    model = build_model(rtfs4_conf(dropout=0.0), device="cuda",
                        generator=torch.Generator().manual_seed(0))
    make_system(model, torch.float32).backward(
        train_batch(1, torch.Generator(device="cuda").manual_seed(24)))
    start = [p.detach().clone() for p in model.parameters()]
    grads = [p.grad.clone() for p in model.parameters()]
    optim = rtfs4_optim()
    rows = {}
    for name in optimizers.NAMES:
        result = {}
        for device in ("cuda", "cpu"):
            params = [torch.nn.Parameter(p.to(device).clone()) for p in start]
            opt = make_optimizer(params, **{**optim, "optimizer": name})
            t0 = time.perf_counter()
            for _ in range(ZOO_OPT_STEPS):
                for p, g in zip(params, grads):
                    p.grad = g.to(device)
                opt.step()
            if device == "cuda":
                torch.cuda.synchronize()
            result[device] = ([p.detach().cpu() for p in params],
                              (time.perf_counter() - t0) * 1e3 / ZOO_OPT_STEPS)
        scale = max(float(p.abs().max()) for p in result["cpu"][0])
        err = max(float((a - b).abs().max()) for a, b in zip(*(result[d][0] for d in
                                                                 ("cuda", "cpu"))))
        moved = max(float((a - b.cpu()).abs().max()) for a, b in zip(result["cuda"][0], start))
        rows[name] = {"max_abs_err": err, "max_abs_p": scale, "max_move": moved,
                      "ms_per_step_card": result["cuda"][1]}
        if not (err <= ZOO_OPT_TOL * scale and moved > 0):
            fail(f"optimizer {name}: card vs CPU {err} (tol {ZOO_OPT_TOL * scale}), "
                 f"moved {moved}")
    worst = max(rows, key=lambda n: rows[n]["max_abs_err"] / rows[n]["max_abs_p"])
    print(f"layer_zoo optimizers: {len(rows)} names, {ZOO_OPT_STEPS} steps each, card vs CPU "
          f"worst {worst}: {json.dumps(rows[worst])}")
    return rows


def rtfs4_optim():
    import yaml

    with open(CONFIG) as f:
        return yaml.safe_load(f)["optim"]


def check_zoo_kernels():
    """K1, K2 and K3 against their plain versions at the DPTNet AVNet's
    shapes: K1 at (122, k·64, 251·B) for B = 1, 4, 16, K2's forward and
    backward at B = TRAIN_BATCHES[0], k = 4 and 3, and K3's forward and dx
    at (B, 128, 251, 129) with the 5x5 kernel for the serving and the train
    batch, in both dtypes; K3's device time at B = 16 beside
    ``F.conv2d(groups=C)``'s. Returns the rows."""
    import torch
    import torch.nn.functional as F

    ksru, ktrain, kdw, _ = kernel_modules()
    gen = torch.Generator(device="cuda").manual_seed(25)
    L, per_utt = ZOO_SRU_PASS
    rows = []
    for B, k, dtype in itertools.product(SERVE_BATCHES, (4, 3), (torch.float32, torch.bfloat16)):
        sets, v, b = sru_inputs(L, per_utt * B, k, dtype, gen, 1)
        u, skip = sets[0]
        got = ksru.sru_stack_layer(u, skip, v, b, H=H, k=k, ndir=2)
        ok, err = sru_tolerance_ok(got, ksru.sru_stack_layer_ref(u, skip, v, b, H=H, k=k,
                                                                ndir=2), dtype)
        rows.append({"kernel": "K1", "B": B, "k": k, "dtype": dtype_name(dtype),
                     "max_abs_err": err})
        if not ok:
            fail(f"sru_stack_layer at the DPTNet shape B={B} k={k} {dtype}: {err}")
    B = TRAIN_BATCHES[0]
    for k, dtype in itertools.product((4, 3), (torch.float32, torch.bfloat16)):
        sets, v, b = sru_inputs(L, per_utt * B, k, dtype, gen, 1)
        u, skip = sets[0]
        dh = torch.randn((L, 2 * H, per_utt * B), generator=gen, device="cuda").to(dtype)
        kw = dict(H=H, k=k, ndir=2)
        h, c = ktrain.sru_train_forward(u, skip, v, b, **kw)
        grads = ktrain.sru_train_backward(u, skip, c, v, b, dh, **kw)
        want_h, want_c = ktrain.sru_train_forward_ref(u, skip, v, b, **kw)
        want = ktrain.sru_train_backward_ref(u, skip, c, v, b, dh, **kw)
        errs = {}
        for part, g, w in (("h", h, want_h), ("c", c, want_c), ("du", grads[0], want[0]),
                           ("dskip", grads[1], want[1])):
            if w is not None:
                ok, errs[part] = tolerance_ok(g, w, dtype)
                if not ok:
                    fail(f"sru_train {part} at the DPTNet shape k={k} {dtype}: {errs[part]}")
        gate_rtol = 1e-4 if dtype == torch.float32 else 1e-3
        for part, g, w in (("dv", grads[2], want[2]), ("db", grads[3], want[3])):
            errs[part] = float((g - w).abs().max())
            if not errs[part] <= gate_rtol * float(w.abs().max()):
                fail(f"sru_train {part} at the DPTNet shape k={k} {dtype}: {errs[part]}")
        rows.append({"kernel": "K2", "B": B, "k": k, "dtype": dtype_name(dtype),
                     "errors": errs})
    pads = tuple(((kk - 1) // 2, kk - 1 - (kk - 1) // 2) for kk in ZOO_DW_KERNEL)
    for B, dtype in itertools.product((SERVE_BATCHES[-1], TRAIN_BATCHES[0]),
                                      (torch.float32, torch.bfloat16)):
        shape = (B, ZOO_DW_CHANNELS, *next(iter(DW_PLANES)))  # the full (251, 129) plane
        err, dx_err = check_dw_forward_dx(shape, ZOO_DW_KERNEL, pads, 0, dtype, gen,
                                          "DPTNet group FFN")
        row = {"kernel": "K3", "x": shape, "dtype": dtype_name(dtype), "max_abs_err": err,
               "dx_max_abs_err": dx_err}
        if B == SERVE_BATCHES[-1]:
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = torch.randn((shape[1], 1, *ZOO_DW_KERNEL), generator=gen, device="cuda")
            w_lib = w.to(dtype)
            with torch.no_grad():
                row["ms"] = event_ms(lambda: kdw.dw_conv2d_same(x, w, pads), reps=10)
                row["library_ms"] = event_ms(
                    lambda: F.conv2d(x, w_lib, padding=pads[0][0], groups=shape[1]), reps=10)
        rows.append(row)
    print("layer_zoo kernels at the DPTNet shapes " + json.dumps(rows))
    return rows


def check_layer_zoo(smi):
    """Phase 22: the layer zoo at full width. Returns each path's launch
    counts, counted from 0 just before it."""
    import torch

    from rtfs_net_tpu_torch.models import build_model

    paths, out = {}, {"card": smi}
    gen = torch.Generator(device="cuda").manual_seed(20)
    requests = {B: (torch.randn((B, SAMPLES), generator=gen, device="cuda"),
                    0.1 * torch.randn((B, LIP_CHANNELS, LIP_FRAMES), generator=gen,
                                      device="cuda"))
                for B in SERVE_BATCHES}

    # (a) RTFS-Net-4 with LSTM DualPathRNNs: K3 only
    model = build_model(lstm_conf(), device="cuda", generator=torch.Generator().manual_seed(0))
    paths["lstm_serving"], outs, out["lstm_serving"] = check_serving(
        "layer_zoo serving (LSTM)", model, requests, want={"K3": DW_LAUNCHES})
    del outs
    paths["lstm_train"], out["lstm_train"] = zoo_train_step(
        "layer_zoo train step (LSTM)", model, {"K3": 3 * DW_LAUNCHES}, torch.bfloat16)
    del model
    torch.cuda.empty_cache()
    out["rnn_routes"] = compare_rnn_routes()

    # (b) the DPTNet AVNet: its kernels at its shapes, then the model
    out["dpt_kernels"] = check_zoo_kernels()
    conf = dpt_conf()
    serve_want, train_want = dpt_launches(conf)
    model = build_model(conf, device="cuda", generator=torch.Generator().manual_seed(0))
    paths["dpt_serving"], outs, out["dpt_serving"] = check_serving(
        "layer_zoo serving (DPTNet)", model, requests, want=serve_want)
    del outs
    paths["dpt_train"], out["dpt_train"] = zoo_train_step(
        "layer_zoo train step (DPTNet)", model, train_want)
    out["dpt_launches"] = {"serving": serve_want, "train": train_want}
    del model, requests
    torch.cuda.empty_cache()

    # (c) every other layer alone; (d) the optimizers
    paths["layers"], out["layers"] = check_zoo_layers()
    out["optimizers"] = check_zoo_optimizers()
    for name in ("ranger", "adafactor"):
        model = build_model(rtfs4_conf(), device="cuda", generator=torch.Generator().manual_seed(0))
        paths[f"train_{name}"], out[f"train_{name}"] = zoo_train_step(
            f"layer_zoo train step ({name})", model,
            {"K2_forward": 2 * SRU_LAUNCHES, "K2_backward": SRU_LAUNCHES,
             "K3": 3 * DW_LAUNCHES}, optimizer=name)
        del model
    torch.cuda.empty_cache()
    out["launches"] = paths
    print("layer_zoo " + json.dumps(out))
    return paths


def main():
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from rtfs_net_tpu_torch.ops.kernels import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    from rtfs_net_tpu_torch._native import load_native

    t0 = time.perf_counter()
    sources = [m.SOURCE for m in kernel_modules()]
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 1) as pool:
        # the native PESQ/crc32c extension (native/, g++) builds beside the kernels
        native = pool.submit(load_native)
        list(pool.map(lambda src: build.build(build.CSRC / src), sources))
        if native.result() is None:
            fail("build: the native extension (native/) did not build")
    for src in sources:
        build.load(src)
    print(f"build: {', '.join(sources)} and the native extension built and loaded in "
          f"{time.perf_counter() - t0:.3f} s")
    sru = check_sru_kernel()
    dw = check_dw_conv_kernel()
    direction = check_sru_direction_kernel()
    model, video, requests, frame_requests = serving_setup()
    launches, _, _ = check_serving("serving", model, requests)
    bench_point = check_bench_point(model)
    frame_launches, frame_outs, _ = check_serving("serving from frames", model,
                                                  frame_requests, video)
    direction_launches = check_direction_pass(model, video, frame_requests[16],
                                              frame_outs[16])
    del frame_outs
    profile_serving(model, video, requests, frame_requests)
    del model, video, requests, frame_requests
    torch.cuda.empty_cache()
    sru_train = check_sru_train_kernel()
    base, train_launches = check_training()
    check_train_parity()
    profile_training(base)
    del base
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        exp_dir, fit_launches = check_fit(root)
        torch.cuda.empty_cache()
        eval_launches = check_evaluate(root, exp_dir, smi)
        separate_launches = check_separate_cli(root, exp_dir)
        torch.cuda.empty_cache()
        export_launches = check_export(root, exp_dir, smi)
        torch.cuda.empty_cache()
        ctcnet_launches = check_ctcnet(root, smi)
        torch.cuda.empty_cache()
        zoo_launches = check_video_zoo(root, smi)
        torch.cuda.empty_cache()
        bench_launches = check_bench(bench_point)
        torch.cuda.empty_cache()
        parallel_launches = check_parallel(root)
    zoo = check_layer_zoo(smi)
    by_path = {"serving": launches, "serving_from_frames": frame_launches,
               "per_direction": direction_launches, "train": train_launches,
               "fit": fit_launches, "evaluate": eval_launches, "separate": separate_launches,
               "export": export_launches, "ctcnet": ctcnet_launches,
               **{f"video_zoo_{path}": counts for path, counts in zoo_launches.items()},
               "bench": bench_launches, "parallel": parallel_launches,
               **{f"layer_zoo_{path}": counts for path, counts in zoo.items()}}

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    # no single PyTorch call computes an SRU recurrence or its backward;
    # F.pad + F.conv2d(groups=C) computes the depthwise stencil
    summary = [{"name": "sru_stack_layer", "route": "cuda",
                "source": "rtfs_net_tpu_torch/csrc/sru_stack_layer.cu",
                "replaces": "rtfs_net_tpu/ops/pallas/sru_kernel_v3.py:234",
                "launches": launches["K1"], **{key: sru[key] for key in keys},
                "library_ms": None}]
    for which, line in (("forward", 154), ("backward", 177)):
        summary.append({"name": f"sru_train_{which}", "route": "cuda",
                        "source": "rtfs_net_tpu_torch/csrc/sru_train.cu",
                        "replaces": f"rtfs_net_tpu/ops/pallas/sru_train.py:{line}",
                        "launches": train_launches[f"K2_{which}"],
                        **{key: sru_train[which][key] for key in keys},
                        "library_ms": None})
    summary.append({"name": "dw_conv2d_same", "route": "cuda",
                    "source": "rtfs_net_tpu_torch/csrc/dw_conv.cu",
                    "replaces": "rtfs_net_tpu/ops/pallas/dw_conv.py:131",
                    "launches": frame_launches["K3"], **{key: dw[key] for key in keys},
                    "library_ms": dw["library_ms"]})
    summary.append({"name": "sru_direction", "route": "cuda",
                    "source": "rtfs_net_tpu_torch/csrc/sru_direction.cu",
                    "replaces": "rtfs_net_tpu/ops/pallas/sru_kernel.py:92",
                    "launches": direction_launches["K4"],
                    **{key: direction[key] for key in keys}, "library_ms": None})
    # each kernel's launches on every path that ran it, each path counted
    # from 0 just before it and read just after
    for entry, count in zip(summary, ("K1", "K2_forward", "K2_backward", "K3", "K4")):
        entry["launches_by_path"] = {path: counts[count] for path, counts in by_path.items()
                                     if counts[count]}
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # any failed phase: report it and exit non-zero
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}", file=sys.stderr)
        sys.exit(1)
