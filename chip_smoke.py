#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Thirteen phases, each of which raises on a
failed check (the script then exits non-zero and prints no result):

1. Device and build: needs a CUDA device; prints the card's name and power
   limit as ``nvidia-smi`` gives them, builds the CUDA kernels from
   ``asf_tpu_torch/csrc`` with ``nvcc`` and prints the build time, each
   kernel's registers and spills, and the count of tensor-core instructions
   (``HGMMA``, ``HMMA``) in the SASS of each wrapper's kernels
   (``cuobjdump -sass``; the run fails without it).
2. Kernels: each log-mel kernel against its plain PyTorch version at the
   shapes the main paths give it, the last record short (n_valid = S/3):
   the flagship geometry (24 kHz, n_fft 2048, win 240: a 256-tap support,
   256 frames, 128 mels) for ``logmel_f32`` and ``logmel_bf16``, and the
   wide-window geometry (win 2048, effective hop 120: a 2048-tap support)
   for ``logmel_bf16_wide`` and for the other two at batch 8, and the
   EPIC-KITCHENS geometry (1.999 s clips, 47,975 samples: 400 frames, three
   128-frame tiles and a 16-frame tail) for ``logmel_bf16`` at B = 32 and
   at B = 16, its train and ragged val batches, and at 320 rows, the GRU's
   16 chains of 20 windows, and at B = 120, the last batch of the
   whole-video sliding windows. Times: warm,
   CUDA events around a run of back-to-back launches over their count
   (median of 5 runs); cold, single launches each after a 512 MB write that
   evicts the 50 MB L2 (the write outside the timed window). The bound: the
   larger of the operations over the card's peak rate for their type and
   the bytes over its memory rate, counting the operations the function
   needs (the window's nonzero taps, the frequencies that feed a mel bin),
   not those a kernel runs. Also the rate at which ``torch.sum``
   reads a tensor held in L2, beside the weight bytes each launch pulls
   through L2. For ``logmel_f32`` also its plan (frames a block, frequency
   slices, blocks, waves) and the other branch of the plan (frequency
   slices where the plan takes none, none where it takes some), held to
   the same tolerance and timed, and two launches that must agree bit for
   bit. For the bf16 kernels how many values leave
   ``logmel_bf16_tc_model``, the model of their sums (evidence of where
   they round, not a gate).
3. Eval slice: the port's ``entry`` serves 4 batches of 8 clips with the
   float32 front end and 3 batches of 128 with the bf16 one through the
   VGG-Sound SlowFast-R50 at full width and depth (weights from a seed).
   The launch counts are zeroed just before and read just after; the
   probabilities must be finite rows that sum to 1. The gate
   (``PROB_TOL``): for the first and the last request, a float32 copy of
   the served model judges the spectrogram the served pipeline made through
   the kernel against the one the plain front end makes, and a control, the
   plain log-mel 1 % off, which must exceed ``PROB_TOL``. The bf16 model's
   distance between the two is printed, not gated. Then clips/s at batch
   128.
4. Train slice: ``train_entry(batch=64)`` trains the same SlowFast-R50 at
   full width and depth (bf16 trunk and front end, SpecAugment on, nesterov
   SGD with the cosine LR): 5 steps at the flagship geometry (``logmel_bf16``)
   and 3 at the wide-window one (``logmel_bf16_wide``), the launch counts
   zeroed before and read after each, the dropout draws from a fixed seed.
   Losses and gradient norms must be
   finite and positive, every parameter and BN statistic must move, and the
   optimizer must hold the policy's LR. One step from a copy of each state,
   SpecAugment off, must give the loss of the same step with the plain
   front end. Then ms per step, clips/s and peak memory at batch 64.
5. ``train(cfg)``: the port's training entry point on a synthetic VGG-Sound
   set written into a temporary directory (mono int16 wav files at 24 kHz,
   2.0 s each, 192 train and 96 val, 309 classes; list-of-dicts annotation
   pickles), the flagship SlowFast-R50 at B = 64 with the bf16 front end,
   precise BN over 2 batches and a val epoch and checkpoint every epoch,
   the loader reading in 8 worker processes.
   Run 1 trains one epoch; run 2, with two epochs in the same output
   directory, must auto-resume at epoch 2 and step 3 and end at step 6.
   ``logmel_bf16`` must launch exactly 7 times a run (3 train, 2 precise
   BN, 2 val batches of 64 and 32), the model must live on the card, every
   logged loss must be finite and the val top-1 error in [0, 100], the
   checkpoints of epochs 1 and 2 and the best must exist, epoch 1's must
   load into a fresh model equal to run 1's bit for bit, and the first
   prefetched batch must equal its host batch bit for bit (int16 kept).
   Prints ms per train and val iteration and the data wait (the host
   times in the loop's ``json_stats`` records), epoch wall seconds, and
   ``train_entry``'s ms per step from phase 4 beside them.
6. ``test(cfg)``: phase 5's final checkpoint scores 32 more synthetic
   2 s files in 10 views each (320 items, 5 batches of 64) through
   ``logmel_bf16``, which must launch exactly 5 times. Every clip must
   have its 10 views (each ensembled row finite and summing to 10 within
   1e-3, no ``test_warn`` record), the score pickle ``{output, labels}``
   must hold the result, and top-1 and top-5 recomputed from it must equal
   the meter's. The same test then runs through ``python -m
   asf_tpu_torch.tools.run_net`` with a YAML config written at run time; it
   must exit 0 and its scores must lie within ``CLI_TOL`` of the in-process
   run's. Before that, while the test loader's 8 workers read, neither
   ``nvidia-smi`` nor ``/proc/<pid>/fd`` may show a worker holding the card
   (this process, the control, must). Prints ms per test iteration and
   clip views/s at B = 64, and the cores the workers share.
7. EPIC-KITCHENS verb/noun (``entry.epic_cfg``: the flagship trunk with
   97 verb and 300 noun classes, 400 frames, B = 32, BN frozen, precise BN,
   the bf16 front end, 10 test views) on a synthetic set written into the
   temporary directory: 8 videos of 120 s of int16 noise at 24 kHz as
   ``<video>.wav``, list-of-dicts annotations with ``narration_id``; 320
   train rows (a third shorter than a clip, a quarter with a
   ``transformation``, so the split reads float32), 80 val rows (int16,
   the last batch 16), 32 test rows. ``train(cfg)`` runs one epoch
   fine-tuned from phase 5's last checkpoint (``TRAIN.CHECKPOINT_FILE_PATH``,
   ``CHECKPOINT_EPOCH_RESET``): exactly the two head projections are
   skipped with a warning (so every trunk leaf loaded), the run starts at
   epoch 1 and step 0, the frozen BN parameters end equal to the
   checkpoint's, and ``logmel_bf16`` launches exactly once a batch (10
   train, 10 precise BN, 3 val). ``test(cfg)`` from that run's checkpoint
   scores the 32 rows in 10 views (10 launches), while no loader worker
   holds the card; the score pickle must hold ``verb_output`` (32, 97),
   ``noun_output`` (32, 300), the labels and the 32 narration ids in
   order, each row the sum of 10 probability rows, and the meter's top-k
   must follow from it; ``run_net`` must give the same scores within
   ``CLI_TOL``. Prints ms per train, val and test iteration, the data
   wait, clip views/s and the first batch's wait.
8. The GRU sequence model (``entry.epic_gru_cfg``: ``AudioSlowFastGRU``,
   the flagship trunk with a 2-layer bidirectional GRU of H = 512, 97 verbs
   and 300 nouns, B = 16 chains of up to 20 windows of 400 frames, BN
   frozen, precise BN, the bf16 front end) on chains over phase 7's
   videos: 192 train, 40 val and 24 test rows whose lengths put the train
   batches, in the loader's order, into every bucket of 1, 2, 4, 8, 16 and
   20 windows twice (two steps of 320 rows). ``train(cfg)`` runs one epoch
   fine-tuned from phase 7's checkpoint: exactly ``head.gru`` and
   ``head.projection_to_dim_in`` are skipped with a warning, frozen BN
   parameters end equal to the checkpoint's, and ``logmel_bf16`` launches
   once a batch (12 train, 12 precise BN, 3 val). Then, on the trained
   state, one step of each bucket is timed (CUDA events, host wall and the
   host's queueing time; chains/s and windows/s; the peak memory at 20
   windows), the input pipeline at 320 rows is held to the plain front end
   (padded windows read log(1e-6)), one 320-row step runs under
   ``torch.profiler`` (busy ms, idle share, the GRU's kernels), and
   torch's sync debug mode lists the calls that make the host wait for the
   card: none may come from the GRU model's forward.
   ``test(cfg)`` scores the 24 chains in one view each (2 launches): the
   pickle's verb (24, 97) and noun (24, 300) rows each sum to 1, with the
   narration ids and labels in order and the meter's top-k; ``run_net``
   must give the same scores within ``CLI_TOL``.
9. The state head, on phase 7's videos with PDDL labels: ``attributes.csv``
   from the port's ``parse_pddl("pddl/full_domain.pddl")`` (30
   attributes), each row's verb mapped onto one of its 33 actions for
   ``precs_vec``/``posts_vec``, and a seeded 512-wide ``noun_embedding``
   a chain. The GRU state model (``entry.epic_gru_state_cfg``: phase 8's
   model with the three state projections and the embedding as the GRU's
   h0) on phase 8's chains: ``train(cfg)`` fine-tuned from phase 7's
   checkpoint skips exactly ``head.gru``, ``head.projection_to_dim_in``
   and the three projections, frozen BN stays put, ``logmel_bf16``
   launches once a batch, and the val record carries the 14
   ``Val/state/*`` means. On the trained state: one 320-row step timed
   beside phase 8's action-only one and profiled (busy ms, idle share),
   the sync debug mode's list (none
   from the train or eval forward with h0 or from the loss with its state
   labels), the (16, 20, 30, 3) state output whose 3 classes sum to 1 in
   eval mode, and the host time of the val flush's state labels and
   ``state_metrics`` for that batch. Then the single-clip state model
   (``entry.epic_state_cfg``, B = 128) on phase 7's rows: ``train(cfg)``
   (2 steps, precise BN, val) with the same gates, one step timed with
   its peak memory and profiled. Each model's ``test(cfg)`` (its few
   batches read in process) pickles verb and noun rows that sum to their
   views, and ``run_net`` gives them within ``CLI_TOL``.
10. The single-pathway ResNet and sliding-window testing. The Slow-only and
   the Fast-only ResNet (``entry.resnet_cfg``: R50 at ``WIDTH_PER_GROUP``
   64, 309 classes, the bf16 trunk, weights from a seed; all 256 frames in
   one pathway), each: phase 3's eval gates (2 batches of 8 through the
   float32 front end, 2 of 128 through the bf16 one, the float32 copy's gate
   and its control), phase 4's train step at B = 64 (5 steps, the plain
   front end's loss, ms per step and clips/s) with its card, wall and
   queueing times, one step under ``torch.profiler`` (busy ms, idle share,
   the groups of kernels) and the peak memory; ``train(cfg)`` of one epoch
   on phase 5's set (7 launches: 3 train, 2 precise BN, 2 val; the loader
   in this process), then ``test(cfg)`` of phase 6's set from its
   checkpoint (10 views, 5 launches, every clip with its views, top-k from
   the pickle); the Fast-only one also through ``run_net`` within
   ``CLI_TOL``. Then sliding-window ``test(cfg)`` (``entry.epic_slide_cfg``,
   B = 128 windows of 400 frames, one view) over phase 7's videos from
   phase 7's checkpoint, with a video-durations csv written for them: the
   whole-video mode (windows of 1 s every 0.5 s: 8 x 239 = 1,912 windows,
   15 batches, the last of 120; the loader's 8 workers off the card), then
   the action-bounds and per-instance modes on phase 7's 32 test rows. In
   each mode the windows, their samples and their labels (4 a whole-video
   window, the first repeated in the unused slots) equal a plain
   reference's (``slide_windows``), ``logmel_bf16`` launches once a batch,
   the pickle holds the annotated windows' verb (97) and noun (300) rows,
   each summing to 1, with their labels, and the meter's top-k follow from
   it by the slide metrics; whole-video windows carry their video's row
   number as ``narration_id``. ``run_net --cfg
   models/asf/config/slide/asf-original-whole-video-1s.yaml`` (the data
   paths, the checkpoint, ``TRAIN.ENABLE False`` and phase 7's trunk as
   overrides) must give the in-process scores within ``CLI_TOL``. Prints
   ms per test iteration, windows/s and the first batch's wait.
11. Batch-norm types and ranks. One process: 3 train steps of the flagship
   at B = 64 (``train_entry``, bf16) with ``batchnorm`` and with each of
   ``sub_batchnorm`` S = 2 and 4 and ``sync_batchnorm`` (world size 1, the
   biased running variance): every norm is of the type asked, each
   ``logmel_bf16`` launch counted, and in the first step every grouped
   norm's output and running statistics are held to float64 of the same
   function of its captured input (``BN_OUT_TOL``, ``BN_STAT_TOL``); ms a
   step of each type beside ``batchnorm``'s, and the sync debug mode's list
   for the ``batchnorm`` step. NCCL at world size 1: phase 5's first run,
   one epoch in a process group started through the port's per-rank entry
   (``tools/run_net.py:run_rank``, ``backend="nccl"``): the model wrapped in
   ``DistributedDataParallel``, the port's collectives issued, 7 launches,
   its losses and final model within ``DDP_TOL`` of phase 5's run without a
   group, and a step through the wrapper with no synchronizing call that
   the step without a group lacks. Two gloo ranks on ``cuda:0`` (spawned,
   ``run_rank`` with ``backend="gloo"``), float32 with TF32 off, dropout
   off, LR 1e-3: one ``train(cfg)`` epoch of one step at a global B = 64
   (the first 64 clips of phase 5's set; the running statistics take the
   step's batch statistics whole, no precise BN; then val on phase 5's
   64 + 32) with ``batchnorm`` against one process with
   ``batchnorm``, and with ``sync_batchnorm`` k = 1 against one process with
   ``sub_batchnorm`` S = 2 (running variances rescaled by n/(n-1), n a
   split's count): the loss, the step's update of the parameters together
   and the running statistics together (``GLOO_*_TOL``: a float32 step at
   the random start is itself 1.6 % from float64, and later steps grow any
   such gap); each rank launches ``logmel_bf16`` 3 times a run; then a
   two-rank ``test(cfg)`` of phase 6's set writes one pickle whose scores
   lie within ``GLOO_SCORE_TOL`` of one process's (5 launches a rank).
12. The tools. ``predict`` (``tools/predict.py``, in this process) over one
   of phase 7's 120 s videos with phase 7's checkpoint (``NUM_FRAMES`` 384,
   so that the head's pools keep the ratio ALPHA): the bf16 front end
   launches ``logmel_bf16`` once over the whole file (1 x 24,001 frames),
   ``GPU.DSP_PRECISION`` HIGHEST ``logmel_f32`` once; phase 5's flagship
   checkpoint on a file shorter than a clip (0.5 s, edge-padded to 256
   frames), and on another 120 s video at the wide-window geometry, where
   the front end picks ``logmel_bf16``, not ``logmel_bf16_wide``, above 512
   frames. In each: the one launch counted, the ``.npz`` holding the
   returned scores, the kernel's log-mel at that shape within
   ``BF16_TOL``/``F32_TOL`` of its plain version, timed warm and cold with
   its bound, and the probabilities of its spectrogram within ``PROB_TOL``
   of the plain front end's through ``float32_copy`` (the 1 % control is
   printed, not gated). Then ``asf_tpu_torch.main``'s ``main`` with
   ``--train`` (in this process): the dataset preparation from phase 7's
   list-of-dict rows as the originals (24 of 97 verbs, the domain's
   actions first; balanced augmentation; ``pddl/domain.pddl``; the seeded
   CLIP fallback), one epoch fine-tuned from phase 5's checkpoint with the
   loader in this process, TensorBoard and W&B on (a stand-in ``wandb``
   module that records its calls, so the watch histograms run on the
   card) and ``GPU.PROFILE_DIR``, then the test with a config read afresh
   (2 views): the lists, ``attributes.csv`` and the score pickle written,
   ``logmel_bf16`` once a batch, the histograms every ``LOG_PERIOD`` steps
   with each leaf's counts summing to its size, the live sinks printed, and
   the Chrome trace holding ``logmel_tc_kernel`` events (one a traced step at
   most). Then
   ``stress_test`` (n = 8192, 5 s; its TFLOP/s printed), and the spectrogram
   dumper's ``_item_pathways`` on one item (one ``logmel_bf16`` launch)
   within ``BF16_TOL`` of the plain pipeline on the CPU.
13. The instruction gates: ``HGMMA`` in the SASS of both bf16 kernels, and
   both above the card's float32 CUDA-core peak at their main-path shapes
   (``logmel_bf16`` flagship at B = 64 and 128, ``logmel_bf16_wide`` at
   B = 64); no ``HGMMA`` and no ``HMMA`` in the SASS of ``logmel_f32``'s
   kernels, whose function is IEEE float32. They are checked after the
   slices, so that a run against an older tree of the kernels (a
   parent-versus-change comparison) still prints all its times before it
   fails.
14. One ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import copy
import json
import math
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import types
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Dense peaks by card (NVIDIA's data sheets; rates at the full power limit):
# float32 outside the tensor cores, bf16 in them, device memory bytes/s.
PEAKS = {
    "H100 PCIe": (51e12, 756e12, 2.0e12),
    "H100": (67e12, 989e12, 3.35e12),  # SXM
}

# The TPU kernel each CUDA kernel replaces (function definition).
REPLACES = {
    "logmel_f32": "asf_tpu/ops/logmel_pallas.py:284",  # _partial_mel (+ sum and log, :458-464)
    "logmel_bf16": "asf_tpu/ops/logmel_pallas.py:232",  # _resident_logmel
    "logmel_bf16_wide": "asf_tpu/ops/logmel_pallas.py:156",  # _hopblock_logmel
}
# The kernel functions each wrapper launches (a substring of their SASS
# names): logmel_f32's main and reduce kernels, the bf16 symbols' one.
DEVICE_FN = {"logmel_f32": "logmel_f32", "logmel_bf16": "logmel_tc_kernel",
             "logmel_bf16_wide": "logmel_tc_kernel"}
# (kernel, geometry, batch): main-path shapes that must beat the float32
# CUDA-core peak, which only the tensor cores can.
TENSOR_CORE_ROWS = [("logmel_bf16", "flagship", 64), ("logmel_bf16", "flagship", 128),
                    ("logmel_bf16_wide", "wide", 64)]
FLUSH_BYTES = 512 * 2**20  # written before each cold launch: ten times the L2
# (kernel, precision, geometry, batches): the main paths' shapes (eval: f32
# at 8, bf16 at 128; train: bf16 at 64, flagship and wide; train(cfg): bf16
# at 64 and at 32, its ragged last val batch; EPIC: bf16 at 32 and at 16,
# its ragged last val batch; the GRU: bf16 at 320 rows, 16 chains of 20
# windows; the single-clip state head and the sliding windows: bf16 at 128,
# and the last whole-video slide batch of 120), and the 2048-tap supports of
# logmel_f32 and logmel_bf16 at 8.
KERNEL_CASES = [
    ("logmel_f32", "HIGHEST", "flagship", (8, 128)),
    ("logmel_bf16", "BFLOAT16", "flagship", (8, 32, 64, 128)),
    ("logmel_bf16", "BFLOAT16", "epic", (16, 32, 120, 128, 320)),
    ("logmel_f32", "HIGHEST", "wide", (8,)),
    ("logmel_bf16", "BFLOAT16", "wide", (8,)),
    ("logmel_bf16_wide", "BFLOAT16", "wide", (8, 64)),
]
# The geometry and batch of each kernel's row in the kernels line: the eval
# slice's for K1 and K2 (as before), the train slice's for K3.
LINE_BATCH = {"logmel_f32": ("flagship", 128), "logmel_bf16": ("flagship", 128),
              "logmel_bf16_wide": ("wide", 64)}
F32_TOL = 1e-4  # log domain, max abs: float32 FMA in another summation order
# max and mean abs: the same bf16 roundings in another order. A magnitude
# whose bf16 rounding flips moves its mel bin by at most log(1 + 2**-8) ~ 3.9e-3;
# such flips are rare, so the mean stays near 1e-8.
BF16_TOL = (1e-2, 1e-6)
# Probabilities, kernel front end vs plain front end, through a float32 copy
# of the served model (same weights and BN statistics, eval mode, TF32 off).
# The bf16 trunk is no judge: a log-mel value whose bf16 rounding at the
# model's input flips moves its random-weight probabilities by up to 0.15-0.23,
# and noise of 1e-7 flips some (PERF.md, Findings). Through the float32
# trunk a relative change of 1e-6 of the log-mel moves the probabilities by
# far less than 1e-4 (tests/test_torch_port_logmel_plan.py), so the gate
# holds each kernel to the float32 plain version (logmel_f32_plain,
# logmel_bf16_plain): stricter about error than the bf16 trunk, and blind to
# where a kernel rounds its sums. The control shows that it can fail: the
# plain log-mel scaled by 1 + CONTROL must move the probabilities by more
# than PROB_TOL.
PROB_TOL = 1e-3
CONTROL = 0.01
# Train loss (CE over 309 classes, ~5.7 at these random weights), kernel front
# end vs plain front end, one step from the same state with the same dropout
# draws: the two log-mel inputs differ by the rare bf16 flips of BF16_TOL,
# which the bf16 trunk (8-bit mantissa, ~0.4 % per rounding) carries into
# the logits; the mean over 64 clips keeps the loss within 1e-2.
LOSS_TOL = 1e-2
TRAIN_BATCH = 64
# The synthetic VGG-Sound set of phase 5: 3 train batches of 64, val 64 + 32.
TRAIN_FILES, VAL_FILES, FILE_SECS = 192, 96, 2.0
# logmel_bf16 launches of one train(cfg) epoch: 3 train + 2 precise-BN + 2 val batches.
EPOCH_LAUNCHES = 7
LOADER_WORKERS = 8  # the loader's worker processes in phases 5 and 6
# Phase 6's test set: 32 clips of FILE_SECS in 10 views, 320 items in 5 batches of 64.
TEST_FILES, TEST_VIEWS, TEST_BATCH = 32, 10, 64
TEST_LAUNCHES = TEST_FILES * TEST_VIEWS // TEST_BATCH
# Ensembled scores of one checkpoint, test(cfg) in this process against the
# run_net CLI in another: the same kernels on the same inputs.
CLI_TOL = 1e-4
# Phase 7's synthetic EPIC-KITCHENS set: videos of EPIC_VIDEO_SECS; train rows
# in 10 batches of 32, val 2 x 32 + 16, test rows in 10 views (10 batches).
EPIC_VIDEOS, EPIC_VIDEO_SECS = 8, 120.0
EPIC_TRAIN, EPIC_VAL, EPIC_TEST = 320, 80, 32
EPIC_TRANSFORMS = ("polarity_inversion", "gaussian_noise", "pitch_shift")
# Phase 8's chains over phase 7's videos, 16 a batch: the longest chain of
# each batch is set so that the batch pads to the bucket named here (train
# in the loader's epoch order), so every bucket of MAX_NB_SPECTROGRAMS = 20
# runs twice in train; val 16 + 16 + 8 chains, test 16 + 8.
GRU_TRAIN_BUCKETS = (20, 1, 2, 4, 8, 16, 20, 16, 8, 4, 2, 1)
GRU_VAL_BUCKETS = (20, 8, 4)
GRU_TEST_BUCKETS = (16, 20)
GRU_RAGGED = 8  # chains in the last val and test batches
# Phase 10's sliding windows over phase 7's videos: the csv of their
# durations (EPICKITCHENS.VIDEO_DURS), and the annotations a whole-video
# window keeps.
SLIDE_DURATIONS = "EPIC_100_video_info.csv"
SLIDE_OVERLAP = 4
# Phase 11: train steps of each grouped batch-norm type in one process at
# B = TRAIN_BATCH, the first held to float64.
BN_TYPES = (("sub_batchnorm", 2), ("sub_batchnorm", 4), ("sync_batchnorm", 1))
BN_STEPS = 3
# A norm's bf16 output against float64 of the same function of its captured
# input: half a bf16 ulp (up to 2**-8 of the value) plus the float32
# statistics' error (1e-5 of the value, 1e-4 near 0).
BN_OUT_TOL = (2.0 ** -8 + 1e-5, 1e-4)
# Its running statistics after the step against the float64 update: float32
# statistics of up to 2M values a channel, then one float32 rounding.
BN_STAT_TOL = (1e-5, 1e-6)
# NCCL at world size 1 against phase 5's first run without a group (the same
# batches, seeds and bf16 trunk; cuDNN may sum in another order): each
# train_iter loss (absolute) and each leaf (relative L2).
DDP_TOL = 1e-2
# Two gloo ranks on the one card against one process, float32 with TF32 off,
# over an epoch of one step (the first TRAIN_BATCH clips of phase 5's list),
# the running statistics taking each step's batch statistics whole
# (BN.MOMENTUM_OVERRIDE 1) and no precise BN (it would read them off models
# that one step has already parted). On an H100, ``python -m
# asf_tpu_torch.tools.step_noise`` finds a float32 step of the flagship at its
# random start 1.6 % (its whole gradient) from float64, the two-rank step as
# far, and later steps growing any gap (one process against itself under
# other cuDNN algorithms: 8e-6 after one step, 0.2 after three; two ranks
# 0.02, then 0.7). So the gate holds the
# one step: its loss (relative), its update of the parameters together
# (relative L2, 3 x the float32 noise of a step), and the running means and
# variances it left (each kind together, relative L2); a wrong split or
# gradient average moves these by 1-100 %. Then the test scores of one set
# of weights (max abs).
GLOO_RANKS, GLOO_SCORE_TOL, GLOO_TRAIN_LIST = 2, 1e-4, "train_one_step.pkl"
GLOO_UPDATE_TOL, GLOO_LOSS_TOL, GLOO_STAT_TOL = 0.05, 1e-5, 1e-5
# The same two ranks, then one process, take one train step of the flagship
# in float64 on the same front-end output of the TRAIN_BATCH clips of
# ``_example`` (dropout and SpecAugment off, ``batchnorm``: the grouped norm
# over the two ranks against ``nn.BatchNorm2d``): the ranks' averaged
# gradients (every parameter together and each alone, relative L2), the
# running statistics after the step (each kind together) and the loss
# (relative) within GLOO_F64_TOL. Float64 on the same bits leaves only
# rounding between the two (1.5e-13 on an H100), so a wrong row split, norm
# group, loss mean or gradient average shows orders of magnitude above this
# bound. A rank's own float32 front end (its K1 launch at 32 rows, its
# share of SpecAugment's draws) differs from the host batch's rows in the
# last bits of a log-mel (4.8e-7 there; GLOO_FRONT_TOL, max abs), which
# this step, at its random start, turns into 0.3 % of the float64 gradient:
# the float32 gaps above are that sensitivity, not the split.
GLOO_F64_TOL, GLOO_FRONT_TOL = 1e-9, 1e-5
# logmel_bf16 launches a rank in that epoch: 1 train, 2 val.
GLOO_LAUNCHES = 3
# Phase 12: predict on a file shorter than a clip, main's verb subset (of 97),
# its test views and its logging period (the watch histograms' too), and the
# stress test's matrix size and seconds.
PREDICT_SHORT_SECS = 0.5
PREDICT_EPIC_FRAMES = 384  # NUM_FRAMES of the whole-file EPIC predict (phase_tools)
MAIN_VERBS, MAIN_VIEWS, MAIN_LOG_PERIOD = 24, 2, 2
STRESS_N, STRESS_SECS = 8192, 5.0
# The device of phase 12's runs: the card ("cpu" rehearses the phase's code
# on the CPU, where its launch checks fail, as they must).
TOOLS_DEVICE = "cuda"


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _events():
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def cuda_ms(fn, reps: int, warmup: int = 3, runs: int = 5) -> float:
    """Milliseconds per call of ``fn()``: CUDA events around ``reps``
    back-to-back calls over ``reps``, the median of ``runs`` such runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = _events()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def cold_ms(fn, flush: torch.Tensor, reps: int) -> float:
    """Median milliseconds of single calls of ``fn()``, each after ``flush``
    (larger than the L2) is written; the write runs before the start event,
    and lasts longer than the host takes to queue ``fn``."""
    fn()
    times = []
    for i in range(reps):
        flush.fill_(i)
        start, end = _events()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sass_counts(lib: Path) -> dict:
    """{kernel function: (HGMMA, HMMA) instruction counts} from ``cuobjdump
    -sass``."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    check(os.path.exists(tool), "cuobjdump not found: the tensor-core instructions cannot be shown")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = [0, 0]
        elif fn is not None and "HGMMA" in line:
            counts[fn][0] += 1
        elif fn is not None and "HMMA" in line:
            counts[fn][1] += 1
    return counts


def l2_read_gbs() -> float:
    """GB/s at which ``torch.sum`` reads a 24 MB float32 tensor held in the
    50 MB L2: a lower bound on the card's L2 read rate."""
    x = torch.rand(6 * 2**20, device="cuda")
    return x.numel() * 4 / cuda_ms(lambda: x.sum(), reps=200) / 1e6


def peaks(name: str):
    """(float32, bf16, bytes/s) peaks of the card; the H100 SXM's for an unknown name."""
    return next((v for k, v in PEAKS.items() if k in name), PEAKS["H100"])


def float32_copy(model: torch.nn.Module, cfg) -> torch.nn.Module:
    """The model of ``cfg`` computing in float32, with ``model``'s parameters
    and BN statistics (``load_state_dict(strict=True)``), on its device and
    in its train or eval mode: a well-conditioned judge of two inputs to a
    bf16 model."""
    from asf_tpu_torch.models import build_model

    cfg = cfg.clone()
    cfg.GPU.COMPUTE_DTYPE = "float32"
    twin = build_model(cfg, next(model.parameters()).device)
    twin.load_state_dict(model.state_dict(), strict=True)
    return twin.train(model.training)


def zero_launches() -> None:
    from asf_tpu_torch.ops import logmel as ops

    for name in REPLACES:
        getattr(ops, name).launches = 0


def read_launches() -> dict:
    from asf_tpu_torch.ops import logmel as ops

    return {name: getattr(ops, name).launches for name in REPLACES}


def phase_device() -> tuple[str, dict]:
    """Checks the device and builds the kernels; returns the card's name and
    power limit as ``nvidia-smi`` gives them, which tags every number, and
    {wrapper: (kernel functions, HGMMA, HMMA)} from the SASS of its kernels."""
    check(torch.cuda.is_available(), "no CUDA device")
    check((ROOT / "asf_tpu_torch" / "csrc").is_dir(),
          f"{ROOT} is not a checkout of the repository (asf_tpu_torch/ is missing)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)
    card = smi[0]
    sys.path.insert(0, str(ROOT))
    from asf_tpu_torch.ops import _build

    t0 = time.perf_counter()
    log = _build.build("logmel")
    print(f"[build] logmel {'built' if log is not None else 'already built'} in "
          f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}", flush=True)
    for line in (log or "").splitlines():
        if any(k in line for k in ("registers", "spill", "bytes stack", "C75")):
            print(f"[build] {line.strip()}")
    counts = sass_counts(_build.library_path("logmel"))
    sass = {}
    for name, fn in DEVICE_FN.items():
        mine = [c for f, c in counts.items() if fn in f]
        sass[name] = (len(mine), sum(c[0] for c in mine), sum(c[1] for c in mine))
        print(f"[build] {name}: {sass[name][1]} HGMMA, {sass[name][2]} HMMA in the SASS "
              f"of its kernels ({fn}, {len(mine)} function(s))", flush=True)
    return card, sass


def geometry_cfg(geometry: str):
    """The config of a ``KERNEL_CASES`` geometry."""
    from asf_tpu_torch.entry import epic_cfg, flagship_cfg, wide_window

    return {"flagship": flagship_cfg, "wide": lambda: wide_window(flagship_cfg()),
            "epic": epic_cfg}[geometry]()


def kernel_work(p, args: tuple, geo: dict, card: str) -> dict:
    """The bound of one log-mel launch on ``args`` (wave, w_cos, w_sin,
    mel_w): the work the function must do, the DFT over the window's
    nonzero taps (239 of the aligned 256 at the flagship geometry, 2047 of
    2048 at the wide one) for the frequencies that feed a mel bin (1,024 of
    1 + n_fft/2 at both: not the DC bin) and their mel product, over the
    card's peak for the kernel's type, against each input read once and the
    output written once over its memory rate; the larger."""
    f32_peak, bf16_peak, mem_rate = peaks(card)
    frames = args[0].shape[0] * geo["n_frames"]
    taps = p.support[1] - p.support[0]
    n_freqs = int((p.mel_w.float().abs().sum(dim=1) > 0).sum())
    flops = frames * (2 * 2 * taps * n_freqs + 2 * n_freqs * p.n_mels)
    nbytes = sum(t.numel() * t.element_size() for t in args) + frames * p.n_mels * 4
    op_ms = flops / (bf16_peak if p.fast else f32_peak) * 1e3
    byte_ms = nbytes / mem_rate * 1e3
    return dict(bound_ms=max(op_ms, byte_ms),
                bound_by="operations" if op_ms >= byte_ms else "bytes",
                gflop=flops / 1e9, mbytes=nbytes / 1e6)


def phase_kernels(card: str) -> dict:
    from asf_tpu_torch.dsp.logmel import LogMelParams
    from asf_tpu_torch.ops import logmel as ops
    from asf_tpu_torch.utils.torch_setup import disable_tf32

    disable_tf32()
    l2_gbs = l2_read_gbs()
    print(f"[kernel] L2 read rate (torch.sum over 24 MB held in L2): {l2_gbs:.0f} GB/s "
          f"| {card}", flush=True)
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    results = {name: {"max_abs_err": 0.0, "rows": {}} for name in REPLACES}
    for name, precision, geometry, batches in KERNEL_CASES:
        cfg = geometry_cfg(geometry)
        cfg.GPU.DSP_PRECISION = precision
        p = LogMelParams(cfg, "cuda")
        check(p.ksup == (2048 if geometry == "wide" else 256), f"support {p.ksup} taps")
        kernel, plain = getattr(ops, name), getattr(ops, f"{name}_plain")
        for batch in batches:
            tag = f"{name} {geometry} B={batch}"
            wave = np.random.default_rng(batch).standard_normal((batch, p.clip_samples))
            wave[-1, p.clip_samples // 3 :] = 0.0  # a short record, zero-padded by its host
            wave = torch.from_numpy((wave * 0.1).astype(np.float32)).cuda().to(p.dtype)
            geo = p.geometry(p.clip_samples)
            args = (wave, p.w_cos, p.w_sin, p.mel_w)
            got = kernel(*args, **geo)
            want = plain(*args, **geo)
            torch.cuda.synchronize()
            check(got.shape == (batch, cfg.AUDIO_DATA.NUM_FRAMES, 128),
                  f"{tag} shape {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), f"{tag} gave non-finite values")
            err = (got - want).abs()
            max_err, mean_err = err.max().item(), err.mean().item()
            if p.fast:
                check(max_err <= BF16_TOL[0] and mean_err <= BF16_TOL[1],
                      f"{tag}: max {max_err} mean {mean_err} > {BF16_TOL}")
                # The same bf16 inputs without the magnitude rounding (:221):
                # a kernel that skips that rounding lands nearer this.
                unrounded = ops.logmel_f32_plain(*args, **geo)
                miss = (got - unrounded).abs().mean().item()
                check(mean_err < miss, f"{tag}: mean {mean_err} from the plain "
                      f"version, {miss} from it without the magnitude rounding")
                ref = ops.logmel_bf16_tc_model(*args, **geo)
                print(f"[kernel] {tag}: mean abs {miss:.3g} from the plain version "
                      f"without the magnitude rounding; {int((got != ref).sum())} of "
                      f"{got.numel()} values leave logmel_bf16_tc_model, the model of the "
                      f"tensor cores' sums (mean abs {(got - ref).abs().mean().item():.3g})",
                      flush=True)
                del ref
            else:
                check(max_err <= F32_TOL, f"{tag}: max {max_err} > {F32_TOL}")
            ms = cuda_ms(lambda: kernel(*args, **geo), reps=25)
            cold = cold_ms(lambda: kernel(*args, **geo), flush, reps=15)
            plain_ms = cuda_ms(lambda: plain(*args, **geo), reps=20, runs=3)
            row = dict(ms=ms, cold_ms=cold, plain_ms=plain_ms, max_abs_err=max_err,
                       **kernel_work(p, args, geo, card))
            row["tflops"] = row["gflop"] / ms
            print(f"[kernel] {tag}: max_abs_err {max_err:.3g} mean {mean_err:.3g} | "
                  f"{ms:.4f} ms warm, {cold:.4f} ms cold (plain {plain_ms:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms by {row['bound_by']}, {row['bound_ms'] / ms:.3f} of "
                  f"it; {row['tflops']:.2f} TFLOP/s) | {card}", flush=True)
            if p.fast:  # the tensor-core kernel
                tile = ops.tc_frames_per_block(geo["hop"], p.ksup)
                tiles = batch * -(-geo["n_frames"] // tile)
                l2_gb = tiles * sum(t.numel() * t.element_size() for t in args[1:]) / 1e9
                print(f"[kernel] {tag}: weights through L2 {l2_gb:.3f} GB a launch "
                      f"({tiles} tiles of {tile} frames), {l2_gb / ms * 1e3:.0f} GB/s "
                      f"warm | {card}", flush=True)
            else:  # the frequency-split kernel
                row.update(f32_branches(tag, card, args, geo, got, ms))
                max_err = max(max_err, row["other_branch"]["max_abs_err"])
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], max_err)
            results[name]["rows"][(geometry, batch)] = row
    del flush
    return results


def f32_branches(tag: str, card: str, args: tuple, geo: dict, got: torch.Tensor,
                 ms: float) -> dict:
    """``logmel_f32``'s plan at this shape (printed with the weight bytes a
    launch pulls through L2: every block reads its slice of the weights, so
    a launch reads them once per frame tile); a second launch, which must
    give ``got`` bit for bit; and the other branch of the plan (8 frequency
    slices where it takes one, one where it takes more), held to the plain
    version within ``F32_TOL`` and timed."""
    from asf_tpu_torch.ops import logmel as ops

    wave, w_cos = args[0], args[1]
    batch, (ksup, kf) = wave.shape[0], w_cos.shape
    frames, splits = ops.f32_device_plan(batch, geo["n_frames"], geo["hop"], ksup, kf,
                                         wave.device)
    tiles = batch * -(-geo["n_frames"] // frames)
    n_sms = torch.cuda.get_device_properties(wave.device).multi_processor_count
    l2_gb = tiles * sum(t.numel() * t.element_size() for t in args[1:]) / 1e9
    widths = [k1 - k0 for k0, k1 in ops.f32_slices(kf, splits)]
    print(f"[kernel] {tag}: plan {frames} frames a block x {splits} frequency slice(s) of "
          f"{min(widths)}-{max(widths)} frequencies: {tiles * splits} blocks on {n_sms} SMs "
          f"({tiles * splits / n_sms:.2f} waves); weights through L2 {l2_gb:.3f} GB a launch, "
          f"{l2_gb / ms * 1e3:.0f} GB/s warm | {card}", flush=True)
    check(torch.equal(got, ops.logmel_f32(*args, **geo)), f"{tag}: two launches differ")
    other = 1 if splits > 1 else min(8, kf // ops.FREQ_CHUNK)
    want = ops.logmel_f32_plain(*args, **geo)
    other_got = ops._launch_f32(*args, **geo, splits=other)
    other_err = (other_got - want).abs().max().item()
    check(other_err <= F32_TOL, f"{tag} with {other} slice(s): max {other_err} > {F32_TOL}")
    other_ms = cuda_ms(lambda: ops._launch_f32(*args, **geo, splits=other), reps=25)
    print(f"[kernel] {tag}: the other branch, {other} frequency slice(s): max_abs_err "
          f"{other_err:.3g} mean {(other_got - want).abs().mean().item():.3g} | {other_ms:.4f} "
          f"ms warm | {card}", flush=True)
    return dict(other_branch=dict(splits=other, ms=other_ms, max_abs_err=other_err))


def check_instructions(card: str, sass: dict, kernels: dict) -> None:
    """Phase 13: both bf16 kernels hold HGMMA and beat the float32 CUDA-core
    peak at their main-path shapes; logmel_f32's kernels hold no tensor-core
    instruction."""
    n_fns, hgmma, hmma = sass["logmel_f32"]
    check(n_fns > 0 and hgmma == hmma == 0,
          f"logmel_f32: {n_fns} kernel functions with {hgmma} HGMMA and {hmma} HMMA in their "
          "SASS; its function is IEEE float32 on the CUDA cores")
    f32_peak = peaks(card)[0] / 1e12
    for name, geometry, batch in TENSOR_CORE_ROWS:
        check(sass[name][1] > 0, f"{name}: no HGMMA in its kernel's SASS")
        tflops = kernels[name]["rows"][(geometry, batch)]["tflops"]
        check(tflops > f32_peak, f"{name} {geometry} B={batch}: "
              f"{tflops:.2f} TFLOP/s, not above the float32 CUDA-core peak {f32_peak:.0f}")


def phase_slice(card: str, cfg=None, tag: str = "slice", n8: int = 4,
                n128: int = 3) -> tuple[dict, dict]:
    """Phase 3 (``cfg`` None: the flagship SlowFast-R50), and the eval gates
    of phase 10 (a ResNet's ``cfg``): ``n8`` requests of 8 clips through the
    float32 front end and ``n128`` of 128 through the bf16 one, checked and
    gated; returns the launch counts and the times at B = 8 and 128."""
    from asf_tpu_torch.dsp.logmel import edge_pad
    from asf_tpu_torch.engine.pipeline import pack_pathways
    from asf_tpu_torch.entry import entry
    from asf_tpu_torch.ops import logmel as ops

    t0 = time.perf_counter()
    serve8, (model8, _, _) = entry(batch=8, dsp_precision="HIGHEST", cfg=cfg)
    serve128, (model128, _, _) = entry(batch=128, dsp_precision="BFLOAT16", cfg=cfg)
    torch.cuda.synchronize()
    mcfg = serve8.pipeline.cfg
    model_name = f"{mcfg.MODEL.MODEL_NAME} ({mcfg.MODEL.ARCH}, R{mcfg.RESNET.DEPTH})"
    n_classes = mcfg.MODEL.NUM_CLASSES[0]
    print(f"[{tag}] two {model_name} models built in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in model8.parameters()) / 1e6:.2f} M parameters)", flush=True)

    s = serve8.pipeline.params.clip_samples
    rng = np.random.default_rng(1234)

    def request(batch, int16):
        n_valid = rng.integers(s // 4, s + 1, batch).astype(np.int32)
        n_valid[0] = s
        wave = rng.standard_normal((batch, s)) * 0.1
        wave[np.arange(s)[None, :] >= n_valid[:, None]] = 0.0  # hosts zero-pad short records
        wave = (wave * 32768).astype(np.int16) if int16 else wave.astype(np.float32)
        return torch.from_numpy(wave).cuda(), torch.from_numpy(n_valid).cuda()

    requests = [(serve8, model8, request(8, int16=i == n8 - 1)) for i in range(n8)]
    requests += [(serve128, model128, request(128, int16=i == n128 - 1)) for i in range(n128)]
    torch.cuda.synchronize()

    zero_launches()
    outputs = [serve(model, *req) for serve, model, req in requests]
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"[{tag}] launches on the main path: {launches}", flush=True)
    check(launches == {"logmel_f32": n8, "logmel_bf16": n128, "logmel_bf16_wide": 0},
          f"[{tag}] expected one launch per batch ({n8} float32, {n128} bf16), got {launches}")

    for (serve, _, (wave, _)), probs in zip(requests, outputs):
        check(probs.shape == (wave.shape[0], n_classes),
              f"probabilities of shape {tuple(probs.shape)}")
        check(bool(torch.isfinite(probs).all()), "non-finite probabilities")
        sums = probs.sum(dim=1)
        check(bool(((sums - 1).abs() <= 1e-3).all()), f"rows sum to {sums.min()}..{sums.max()}")

    # The gate, for the first request (float32 front end) and the last (bf16):
    # a float32 copy of the served model judges the spectrogram the served
    # pipeline made through the kernel against the plain front end's, and
    # the plain one CONTROL off against it, which the gate must refuse.
    gate, control, bf16_trunk = {}, {}, {}
    for idx, front in ((0, ops.logmel_f32_plain), (len(requests) - 1, ops.logmel_bf16_plain)):
        serve, model, (wave, n_valid) = requests[idx]
        pipe = serve.pipeline
        p, cfg = pipe.params, pipe.cfg
        twin = float32_copy(model, cfg)
        name = front.__name__
        with torch.inference_mode():
            x = wave.float() / 32768.0 if wave.dtype == torch.int16 else wave
            log_mel = front(x.to(p.dtype).contiguous(), p.w_cos, p.w_sin, p.mel_w,
                            **p.geometry(x.shape[1]))

            def paths(spec):
                return pack_pathways(cfg, edge_pad(spec, n_valid, p.hop,
                                                   cfg.AUDIO_DATA.NUM_FRAMES))

            plain_paths = paths(log_mel)
            want = twin(plain_paths)
            gate[name] = (twin(pipe(wave, n_valid)) - want).abs().max().item()
            control[name] = (twin(paths(log_mel * (1 + CONTROL))) - want).abs().max().item()
            bf16_trunk[name] = (outputs[idx] - model(plain_paths)).abs().max().item()
        del twin
    print(f"[{tag}] max abs difference of the probabilities, kernel front end vs each plain "
          f"front end, through a float32 copy of the model (gated at {PROB_TOL}): {gate}; "
          f"the plain log-mel {CONTROL:.0%} off through it (the control, must exceed "
          f"{PROB_TOL}): {control}; through the served bf16 model (not gated): {bf16_trunk}",
          flush=True)
    for front, diff in gate.items():
        check(diff <= PROB_TOL, f"[{tag}] against {front}: probabilities differ by {diff} "
              "through the float32 model")
        check(control[front] > PROB_TOL, f"[{tag}] the control of {front} ({CONTROL:.0%} "
              f"off) moves the probabilities by {control[front]}: the gate cannot tell it from "
              "the plain front end")

    timing = {}
    for label, (serve, model, (wave, n_valid)) in (("B=8 float32 DSP", requests[0]),
                                                   ("B=128 bf16 DSP", requests[-1])):
        ms = cuda_ms(lambda: serve(model, wave, n_valid), reps=10, warmup=2, runs=3)
        timing[label] = dict(ms=ms, clips_per_s=wave.shape[0] / ms * 1e3)
        print(f"[{tag}] {label}: {ms:.3f} ms per batch, {wave.shape[0] / ms * 1e3:.1f} clips/s "
              f"(bf16 {model_name} trunk) | {card}", flush=True)
    print(f"[{tag}] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"| {card}")
    return launches, timing


def train_run(card: str, label: str, cfg, n_steps: int, kernel: str,
              profile: bool = False) -> tuple[dict, dict]:
    """``n_steps`` train steps of ``train_entry(batch=64, cfg=cfg)`` with their
    checks, the plain-front-end comparison and the step's time; with
    ``profile`` also its card, wall and queueing times (``step_times``) and
    one step under ``torch.profiler`` (``step_profile``)."""
    from asf_tpu_torch.dsp.logmel import edge_pad
    from asf_tpu_torch.engine.optimizer import get_lr
    from asf_tpu_torch.engine.pipeline import pack_pathways
    from asf_tpu_torch.engine.steps import init_state, make_train_step
    from asf_tpu_torch.entry import train_entry
    from asf_tpu_torch.models.losses import cross_entropy
    from asf_tpu_torch.ops import logmel as ops
    from asf_tpu_torch.utils.lr_policy import get_lr_at_epoch

    # The head's dropout draws come from the global generators, which the
    # process seeds at random: a fixed seed makes each run repeat the last,
    # the loss comparison below included.
    torch.manual_seed(0)
    step, (state, example) = train_entry(batch=TRAIN_BATCH, cfg=cfg)
    scfg = step.pipeline.cfg
    check(scfg.GPU.SPEC_AUGMENT and scfg.SOLVER.NESTEROV and scfg.SOLVER.LR_POLICY == "cosine",
          "the train step runs SpecAugment and nesterov SGD with the cosine LR")
    model = state.model
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    # The default SOLVER's cosine (BASE_LR 0.1 over 300 epochs), read at
    # epochs 200, 210, ...: each step takes a new LR.
    lrs = [get_lr_at_epoch(scfg, 200.0 + 10.0 * i) for i in range(n_steps)]
    torch.cuda.synchronize()

    zero_launches()
    outs = []
    for lr in lrs:
        outs.append(step(state, example, lr))
        check(get_lr(state.optimizer) == lr, f"[{label}] optimizer LR differs from the policy's")
    torch.cuda.synchronize()
    launches = read_launches()
    want = {k: (n_steps if k == kernel else 0) for k in REPLACES}
    print(f"[train] {label}: launches {launches}", flush=True)
    check(launches == want, f"[{label}] expected {want}, got {launches}")
    check(state.step == n_steps, f"[{label}] step count {state.step}")

    losses = [parts["loss"].item() for parts, _ in outs]
    norms = [parts["grad_norm"].item() for parts, _ in outs]
    for name, vals in (("loss", losses), ("grad_norm", norms)):
        check(all(math.isfinite(v) and v > 0 for v in vals), f"[{label}] {name} {vals}")
    after = model.state_dict()
    params = {n for n, _ in model.named_parameters()}
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    unmoved = [k for k in params | set(stats) if torch.equal(after[k], before[k])]
    check(not unmoved, f"[{label}] {len(unmoved)} tensors did not move, e.g. {unmoved[:3]}")
    print(f"[train] {label}: losses {[round(v, 4) for v in losses]}, grad norms "
          f"{[round(v, 3) for v in norms]}, param norm {outs[-1][0]['param_norm'].item():.3f}; "
          f"{len(params)} parameters and {len(stats)} BN statistics moved; LRs "
          f"{[round(v, 5) for v in lrs]}", flush=True)

    # One step from a copy of this state, SpecAugment off on both sides:
    # through the kernel (the step itself) and through the plain front end.
    ncfg = scfg.clone()
    ncfg.GPU.SPEC_AUGMENT = False
    nstep = make_train_step(ncfg, example["waveform"].device)
    p = nstep.pipeline.params
    kstate = init_state(ncfg, copy.deepcopy(model))
    torch.manual_seed(7)  # the head's dropout draws
    kloss = nstep(kstate, example, lrs[-1])[0]["loss"].item()
    with torch.no_grad():
        args = (example["waveform"].to(p.dtype).contiguous(), p.w_cos, p.w_sin, p.mel_w)
        geo = p.geometry(args[0].shape[1])
        got = getattr(ops, kernel)(*args, **geo)
        log_mel = getattr(ops, f"{kernel}_plain")(*args, **geo)
    paths = pack_pathways(ncfg, edge_pad(log_mel, example["n_valid"], p.hop,
                                         ncfg.AUDIO_DATA.NUM_FRAMES))
    torch.manual_seed(7)
    loss = cross_entropy(copy.deepcopy(model).train()(paths),
                         example["labels"]["class_id"]).item()
    diff = abs(kloss - loss)
    # What the front ends feed the model differs mostly where a bf16
    # rounding of the magnitude went the other way.
    print(f"[train] {label}: loss {kloss:.6f} through {kernel}, {loss:.6f} through its plain "
          f"version (SpecAugment off), difference {diff:.3g}; the log-mels differ in "
          f"{int((got != log_mel).sum())} of {log_mel.numel()} values", flush=True)
    check(diff <= LOSS_TOL, f"[{label}] losses differ by {diff} > {LOSS_TOL}")

    ms = cuda_ms(lambda: step(state, example, lrs[-1]), reps=10, warmup=2, runs=3)
    timing = dict(ms=ms, clips_per_s=TRAIN_BATCH / ms * 1e3, loss_diff=diff)
    print(f"[train] {label}: {ms:.3f} ms per step, {timing['clips_per_s']:.1f} clips/s at "
          f"B={TRAIN_BATCH} (bf16 {scfg.MODEL.MODEL_NAME} {scfg.MODEL.ARCH} R{scfg.RESNET.DEPTH}, "
          f"SpecAugment, nesterov SGD) | {card}", flush=True)
    if profile:
        t = step_times(lambda: step(state, example, lrs[-1]))
        timing.update(t)
        print(f"[train] {label}: {t['ms']:.3f} ms a step on the card (CUDA events, median of 3 "
              f"runs of 2 after one), wall {t['wall_ms']:.3f} ms, queued in "
              f"{t['dispatch_ms']:.3f} ms | {card}", flush=True)
        step_profile(f"train {label}", card, lambda: step(state, example, lrs[-1]), t["wall_ms"])
    return launches, timing


def phase_train(card: str) -> tuple[dict, dict]:
    from asf_tpu_torch.entry import flagship_cfg, wide_window

    torch.cuda.reset_peak_memory_stats()
    launches, timing = {}, {}
    for label, cfg, n_steps, kernel in (("flagship", flagship_cfg(), 5, "logmel_bf16"),
                                        ("wide window", wide_window(flagship_cfg()), 3,
                                         "logmel_bf16_wide")):
        launches[label], timing[label] = train_run(card, label, cfg, n_steps, kernel)
    print(f"[train] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"| {card}", flush=True)
    return launches, timing


def check_prefetch(cfg) -> None:
    """The train loader's first batch through the prefetcher equals the same
    batch read on the host, bit for bit and dtype for dtype."""
    from asf_tpu_torch.data.loader import construct_loader, shuffle_dataset
    from asf_tpu_torch.data.prefetch import prefetch

    ld = construct_loader(cfg, "train")
    try:
        shuffle_dataset(ld, 0)
        t0 = time.perf_counter()
        host = next(iter(ld))
        host_ms = (time.perf_counter() - t0) * 1e3
        with prefetch(ld, "cuda") as src:
            t0 = time.perf_counter()
            dev = next(iter(src))
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            pairs = [(dev["waveform"], host["waveform"]), (dev["n_valid"], host["n_valid"]),
                     (dev["labels"]["class_id"], host["labels"]["class_id"]),
                     (dev["index"], host["index"])]
            for got, want in pairs:
                want = torch.from_numpy(want)
                check(got.is_cuda and got.dtype == want.dtype and torch.equal(got.cpu(), want),
                      f"prefetched {tuple(got.shape)} {got.dtype} differs from its host batch")
    finally:
        ld.close()
    check(dev["waveform"].dtype == torch.int16, "the waveform left the host as "
          f"{dev['waveform'].dtype}, not int16")
    print(f"[train(cfg)] the first prefetched batch equals its host batch bit for bit "
          f"(waveform {tuple(dev['waveform'].shape)} int16, labels int64); the host batch "
          f"took {host_ms:.1f} ms (the loader's {LOADER_WORKERS} worker processes started), "
          f"the first batch through a new prefetcher {first_ms:.1f} ms (read, collate, pin, "
          f"copy)", flush=True)


def phase_train_cfg(card: str, step_ms: float, root: str):
    """Phase 5: ``train(cfg)`` twice in ``root``, the second resuming the
    first; returns the launch counts of both runs together, the config (its
    ``OUTPUT_DIR`` holds the checkpoints) and run 1's ``train_iter`` losses."""
    from asf_tpu_torch.checkpoint import manager as cu
    from asf_tpu_torch.engine import train
    from asf_tpu_torch.entry import flagship_cfg
    from asf_tpu_torch.models import build_model
    from asf_tpu_torch.tools.loop_probe import StatsLog, write_vggsound

    cfg = flagship_cfg()
    cfg.GPU.DSP_PRECISION = "BFLOAT16"
    cfg.TRAIN.BATCH_SIZE = TRAIN_BATCH
    cfg.BN.USE_PRECISE_STATS = True
    cfg.BN.NUM_BATCHES_PRECISE = 2
    cfg.TRAIN.EVAL_PERIOD = cfg.TRAIN.CHECKPOINT_PERIOD = 1
    cfg.LOG_PERIOD = 1
    cfg.LOG_MODEL_INFO = False
    cfg.DATA_LOADER.NUM_WORKERS = LOADER_WORKERS

    stats = StatsLog()
    stats.__enter__()
    launches = {name: 0 for name in REPLACES}
    walls = []  # per run: seconds in train(cfg), and from "Start epoch" to the train_epoch record
    try:
        t0 = time.perf_counter()
        write_vggsound(root, cfg, TRAIN_FILES, VAL_FILES, FILE_SECS)
        cfg.OUTPUT_DIR = os.path.join(root, "out")
        print(f"[train(cfg)] wrote {TRAIN_FILES} + {VAL_FILES} wav files of {FILE_SECS} s in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        check_prefetch(cfg)
        ckpts = os.path.join(cfg.OUTPUT_DIR, "checkpoints")
        for run, max_epoch in ((1, 1), (2, 2)):
            cfg.SOLVER.MAX_EPOCH = max_epoch
            since = len(stats.records)
            torch.cuda.synchronize()
            zero_launches()
            t0 = time.perf_counter()
            state = train(cfg)
            torch.cuda.synchronize()
            counts = read_launches()
            wall = time.perf_counter() - t0
            for name, n in counts.items():
                launches[name] += n
            iters = stats.of("train_iter", since)
            epochs = stats.of("train_epoch", since)
            if run == 1:
                run1_losses = [r["loss"] for r in iters]
            check(len(epochs) == 1, f"run {run} logged {len(epochs)} train epochs")
            # The epoch's record follows the flush that waits for its last step.
            walls.append((wall, epochs[0]["_at"] - stats.starts[-1]))
            print(f"[train(cfg)] run {run}: MAX_EPOCH {max_epoch}, train_iter records "
                  f"{[(r['epoch'], r['iter']) for r in iters]}, last step {state.step}, "
                  f"launches {counts}, {wall:.1f} s in train(cfg)", flush=True)
            want = {name: (EPOCH_LAUNCHES if name == "logmel_bf16" else 0) for name in REPLACES}
            check(counts == want, f"run {run}: launches {counts}, expected {want}")
            check(all(p.is_cuda for p in state.model.parameters()),
                  f"run {run}: parameters off the card")
            # Run 2 resumes at epoch 2: its 3 steps are that epoch's and end at step 6.
            check([(r["epoch"], r["iter"]) for r in iters]
                  == [(f"{run}/{max_epoch}", f"{i}/3") for i in (1, 2, 3)]
                  and state.step == 3 * run,
                  f"run {run} logged {iters} and ended at step {state.step}")
            if run == 1:
                fresh = build_model(cfg, "cuda")
                fresh.load_state_dict(cu.load_checkpoint(
                    os.path.join(ckpts, "checkpoint_epoch_00001.pyth"))["model_state"])
                want_sd = state.model.state_dict()
                differ = [k for k, v in fresh.state_dict().items()
                          if not torch.equal(v, want_sd[k])]
                check(not differ, f"checkpoint_epoch_00001.pyth differs from run 1's model "
                      f"in {len(differ)} tensors, e.g. {differ[:3]}")
                del fresh
            del state
        names = sorted(os.listdir(ckpts))
        for name in ("checkpoint_epoch_00001.pyth", "checkpoint_epoch_00002.pyth",
                     "checkpoint_best.pyth"):
            check(name in names, f"{name} missing from {names}")
    finally:
        stats.__exit__()

    losses = [r["loss"] for r in stats.of("train_iter") + stats.of("train_epoch")]
    check(len(losses) == 2 * (3 + 1) and all(math.isfinite(v) for v in losses),
          f"logged losses {losses}")
    vals = stats.of("val_epoch")
    check(len(vals) == 2 and all(0.0 <= r["top1_err"] <= 100.0 for r in vals),
          f"val records {vals}")
    print(f"[train(cfg)] train_epoch {stats.of('train_epoch')}; val_epoch {vals}", flush=True)

    def ms(values):
        return statistics.median(values) * 1e3

    # Host clock, taken at each iteration's iter_toc (no sync a step); the
    # first iteration of each run fills the prefetch queue.
    iters, viters = stats.of("train_iter"), stats.of("val_iter")
    steady = [r for r in iters if not r["iter"].startswith("1/")]
    it_ms, wait_ms = ms([r["dt"] for r in steady]), ms([r["dt_data"] for r in steady])
    print(f"[train(cfg)] ms per train iteration {it_ms:.3f} (median of {len(steady)}, the "
          f"first of each run left out; host clock, no sync a step), data wait {wait_ms:.3f} ms "
          f"({wait_ms / it_ms:.3f} of it); every iteration (s, wait s): "
          f"{[(round(r['dt'], 5), round(r['dt_data'], 5)) for r in iters]} | {card}", flush=True)
    vsteady = [r for r in viters if not r["iter"].startswith("1/")]
    print(f"[train(cfg)] ms per val iteration {ms([r['dt'] for r in vsteady]):.3f} (median of "
          f"{len(vsteady)}: the ragged batch of 32), "
          f"{ms([r['dt'] - r['dt_data'] for r in viters]):.3f} without the data wait (median of "
          f"all {len(viters)}); every one (s, wait s): "
          f"{[(round(r['dt'], 5), round(r['dt_data'], 5)) for r in viters]} | {card}", flush=True)
    firsts = [r["dt"] for r in iters if r["iter"].startswith("1/")]
    print(f"[train(cfg)] epoch wall seconds (from train's 'Start epoch' to its train_epoch "
          f"record, which waits for the last step): {[round(e, 4) for _, e in walls]}; first "
          f"iterations {[round(f, 4) for f in firsts]} s; seconds in train(cfg) "
          f"{[round(w, 2) for w, _ in walls]}; train_entry at B={TRAIN_BATCH} (phase 4): "
          f"{step_ms:.3f} ms per step; loop / train_entry {it_ms / step_ms:.3f} (3-step epochs: "
          f"not a steady state) | {card}", flush=True)
    return launches, cfg, run1_losses


def _device_fds(pid: int) -> int:
    """How many of process ``pid``'s open files are ``/dev/nvidia*``: a
    process with a CUDA context holds some."""
    fds = 0
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            fds += os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia")
        except OSError:  # closed since the listing
            pass
    return fds


def check_loader_workers(card: str, cfg) -> None:
    """While the test loader's workers read, none of them holds a CUDA
    context: ``nvidia-smi`` lists no worker among the card's compute
    processes (and one process at most), and no worker has a ``/dev/nvidia*``
    file open, while this process, the control, has."""
    from asf_tpu_torch.data.loader import construct_loader

    ld = construct_loader(cfg, "test")
    try:
        it = iter(ld)
        next(it)
        workers = ld.worker_pids()
        smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        listed = {int(x) for x in smi.stdout.split() if x.strip().isdigit()}
        fds = {pid: _device_fds(pid) for pid in [os.getpid(), *workers]}
    finally:
        ld.close()
    cores = len(os.sched_getaffinity(0))
    print(f"[test(cfg)] loader: {len(workers)} worker processes on {cores} cores "
          f"(os.sched_getaffinity); nvidia-smi compute processes {sorted(listed)} (rc "
          f"{smi.returncode}), this process {os.getpid()} "
          f"{'listed' if os.getpid() in listed else 'not listed (another pid namespace)'}; "
          f"/dev/nvidia* files open: {fds} | {card}", flush=True)
    check(len(workers) == LOADER_WORKERS, f"{len(workers)} live workers, not {LOADER_WORKERS}")
    check(not listed & set(workers) and len(listed) <= 1,
          f"nvidia-smi lists {sorted(listed)}: a loader worker holds a CUDA context")
    check(fds[os.getpid()] > 0 and not any(fds[pid] for pid in workers),
          f"/dev/nvidia* files open by process: {fds}")
    check(not ld.worker_pids(), "workers alive after close()")


def phase_test_cfg(card: str, cfg) -> dict:
    """Phase 6: ``test(cfg)`` from phase 5's final checkpoint, in this
    process and then through the ``run_net`` CLI; returns the in-process
    run's launch counts."""
    from asf_tpu_torch.tools.loop_probe import write_vggsound

    cfg = cfg.clone()
    root = os.path.dirname(cfg.OUTPUT_DIR)
    cfg.TEST.NUM_ENSEMBLE_VIEWS = TEST_VIEWS
    cfg.TEST.BATCH_SIZE = TEST_BATCH
    cfg.TEST.CHECKPOINT_FILE_PATH = os.path.join(cfg.OUTPUT_DIR, "checkpoints",
                                                 "checkpoint_epoch_00002.pyth")
    cfg.TEST.SAVE_RESULTS_PATH = "test_scores.pkl"
    t0 = time.perf_counter()
    write_vggsound(root, cfg, 0, 0, FILE_SECS, n_test=TEST_FILES)
    print(f"[test(cfg)] wrote {TEST_FILES} wav files of {FILE_SECS} s in "
          f"{time.perf_counter() - t0:.1f} s; {TEST_VIEWS} views each, batches of {TEST_BATCH}",
          flush=True)
    check_loader_workers(card, cfg)
    launches, preds, labels = vgg_test(card, cfg, "test(cfg)")
    vgg_cli(cfg, preds, labels, "test(cfg)")
    return launches


def vgg_test(card: str, cfg, tag: str) -> tuple[dict, np.ndarray, np.ndarray]:
    """``test(cfg)`` of phase 6's set (``TEST_FILES`` clips in ``TEST_VIEWS``
    views, batches of ``TEST_BATCH``) with its gates: ``TEST_LAUNCHES`` of
    ``logmel_bf16``, every clip with its views, the pickle and the meter's
    top-k from it. Returns the launch counts, the scores and the labels."""
    from asf_tpu_torch.engine import test
    from asf_tpu_torch.tools.loop_probe import StatsLog

    with StatsLog() as stats:
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        preds, labels = test(cfg)
        torch.cuda.synchronize()
        launches = read_launches()
        wall = time.perf_counter() - t0
    print(f"[{tag}] launches {launches}, {wall:.2f} s in test(cfg)", flush=True)
    want = {name: (TEST_LAUNCHES if name == "logmel_bf16" else 0) for name in REPLACES}
    check(launches == want, f"{tag}: launches {launches}, expected {want}")
    check(preds.shape == (TEST_FILES, cfg.MODEL.NUM_CLASSES[0]) and labels.shape == (TEST_FILES,),
          f"scores {preds.shape}, labels {labels.shape}")
    check(bool(np.isfinite(preds).all()), "non-finite ensembled scores")
    sums = preds.sum(axis=1)
    check(bool((np.abs(sums - TEST_VIEWS) <= 1e-3).all()),
          f"ensembled rows sum to {sums.min()}..{sums.max()}, not {TEST_VIEWS} (one probability "
          "row a view)")
    check(not stats.of("test_warn"), f"clips with missing views: {stats.of('test_warn')}")
    (final,) = stats.of("test_final")
    path = os.path.join(cfg.OUTPUT_DIR, "scores", cfg.TEST.SAVE_RESULTS_PATH)
    with open(path, "rb") as f:
        saved = pickle.load(f)
    check(set(saved) == {"output", "labels"}, f"score pickle keys {sorted(saved)}")
    check(np.array_equal(saved["output"], preds) and np.array_equal(saved["labels"], labels),
          "the score pickle differs from test(cfg)'s result")
    top = torch.topk(torch.from_numpy(saved["output"]), 5, dim=1).indices
    hit = top == torch.from_numpy(saved["labels"])[:, None]
    recomputed = {f"top{k}_acc": f"{hit[:, :k].any(dim=1).double().mean().item() * 100:.2f}"
                  for k in (1, 5)}
    check(recomputed == {k: final[k] for k in recomputed},
          f"top-k from the pickle {recomputed}, the meter's {final}")
    iters = stats.of("test_iter")
    check(len(iters) == TEST_LAUNCHES, f"{len(iters)} test_iter records")
    steady = [r["time_diff"] for r in iters[1:]]
    it_ms = statistics.median(steady) * 1e3
    print(f"[{tag}] {TEST_FILES} clips x {TEST_VIEWS} views: ensembled rows sum to "
          f"{sums.min():.6f}..{sums.max():.6f}; {final}; ms per test iteration {it_ms:.3f} "
          f"(B={TEST_BATCH}, median of iterations 2-{len(iters)}, host clock, no sync a batch), "
          f"{TEST_BATCH / it_ms * 1e3:.1f} clip views/s; every iteration (s, wait s): "
          f"{[(round(r['time_diff'], 5), round(r['dt_data'], 5)) for r in iters]}; "
          f"{TEST_FILES / wall:.2f} ensembled clips/s over all of test(cfg) | {card}", flush=True)
    return launches, preds, labels


def vgg_cli(cfg, preds: np.ndarray, labels: np.ndarray, tag: str) -> None:
    """``test(cfg)`` of ``cfg`` through ``python -m asf_tpu_torch.tools.run_net``
    from a YAML written at run time: exit 0 and scores within ``CLI_TOL``
    of ``preds``."""
    root = os.path.dirname(cfg.OUTPUT_DIR)
    name = tag.split()[0].replace("(cfg)", "")
    yaml_path = os.path.join(root, f"{name}.yaml")
    with open(yaml_path, "w") as f:
        f.write(cfg.dump())
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "asf_tpu_torch.tools.run_net", "--cfg", yaml_path,
         "TRAIN.ENABLE", "False", "TEST.ENABLE", "True",
         "TEST.SAVE_RESULTS_PATH", f"{name}_cli.pkl"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"run_net exited {proc.returncode}: {proc.stderr[-2000:]}")
    with open(os.path.join(cfg.OUTPUT_DIR, "scores", f"{name}_cli.pkl"), "rb") as f:
        cli = pickle.load(f)
    diff = float(np.abs(cli["output"] - preds).max())
    print(f"[{tag}] python -m asf_tpu_torch.tools.run_net --cfg {name}.yaml TRAIN.ENABLE False "
          f"TEST.ENABLE True: exit 0 in {time.perf_counter() - t0:.1f} s, scores {diff:.3g} max "
          f"abs from the in-process run (gated at {CLI_TOL})", flush=True)
    check(diff <= CLI_TOL and np.array_equal(cli["labels"], labels),
          f"{tag}: the CLI's scores differ by {diff} > {CLI_TOL}")


def write_epic(root: str, cfg) -> list:
    """Phase 7's synthetic EPIC-KITCHENS set in ``root``; points ``cfg``'s
    ``EPICKITCHENS`` node at it and returns the test rows."""
    from scipy.io import wavfile

    sr = cfg.AUDIO_DATA.SAMPLING_RATE
    clip_secs = cfg.AUDIO_DATA.CLIP_SECS
    rng = np.random.default_rng(7)
    audio = os.path.join(root, "epic_audio")
    os.makedirs(audio)
    for v in range(EPIC_VIDEOS):
        wave = (rng.standard_normal(int(sr * EPIC_VIDEO_SECS)) * 3000).astype(np.int16)
        wavfile.write(os.path.join(audio, f"P01_{v:02d}.wav"), sr, wave)

    def stamp(sec: float) -> str:
        return f"{int(sec // 3600):02d}:{int(sec % 3600 // 60):02d}:{sec % 60:05.2f}"

    lists = {}
    for split, n, transformed in (("train", EPIC_TRAIN, True), ("val", EPIC_VAL, False),
                                  ("test", EPIC_TEST, False)):
        rows = []
        for i in range(n):
            # a third of the actions shorter than a clip
            secs = rng.uniform(0.5, clip_secs - 0.2) if i % 3 == 0 else rng.uniform(2.5, 6.0)
            start = rng.uniform(0.0, EPIC_VIDEO_SECS - secs)
            row = {"narration_id": f"{split}_{i:04d}", "participant_id": "P01",
                   "video_id": f"P01_{i % EPIC_VIDEOS:02d}", "start_timestamp": stamp(start),
                   "stop_timestamp": stamp(start + secs),
                   "verb_class": int(rng.integers(cfg.MODEL.NUM_CLASSES[0])),
                   "noun_class": int(rng.integers(cfg.MODEL.NUM_CLASSES[1]))}
            if transformed and i % 4 == 1:  # a quarter: the split reads float32
                row["transformation"] = EPIC_TRANSFORMS[i // 4 % len(EPIC_TRANSFORMS)]
            rows.append(row)
        with open(os.path.join(root, f"epic_{split}.pkl"), "wb") as f:
            pickle.dump(rows, f)
        lists[split] = rows
    c = cfg.EPICKITCHENS
    c.AUDIO_DATA_FILE, c.ANNOTATIONS_DIR = audio, root
    c.PROCESSED_TRAIN_LIST = "epic_train.pkl"
    c.PROCESSED_VAL_LIST = "epic_val.pkl"
    c.PROCESSED_TEST_LIST = "epic_test.pkl"
    return lists["test"]


def _times(records: list) -> list:
    """(s, data wait s) of each iteration's ``json_stats`` record."""
    return [(round(r["dt"], 5), round(r["dt_data"], 5)) for r in records]


def _topk(scores: np.ndarray, labels: np.ndarray, k: int) -> np.ndarray:
    top = torch.topk(torch.from_numpy(scores), k, dim=1).indices
    return (top == torch.from_numpy(labels)[:, None]).any(dim=1).numpy()


def phase_epic(card: str, vgg_cfg, step_ms: float, root: str) -> tuple[dict, dict, str]:
    """Phase 7: EPIC-KITCHENS verb/noun ``train(cfg)``, fine-tuned from phase
    5's last checkpoint, then ``test(cfg)`` from its checkpoint, in this
    process and through ``run_net``; returns the launch counts of the two
    in-process runs and that checkpoint."""
    from asf_tpu_torch.checkpoint import manager as cu
    from asf_tpu_torch.engine import test, train
    from asf_tpu_torch.engine.optimizer import is_frozen_bn_param
    from asf_tpu_torch.entry import epic_cfg
    from asf_tpu_torch.tools.loop_probe import StatsLog

    cfg = epic_cfg()
    cfg.SOLVER.MAX_EPOCH = 1
    cfg.LOG_PERIOD = 1
    cfg.LOG_MODEL_INFO = False
    cfg.DATA_LOADER.NUM_WORKERS = LOADER_WORKERS
    cfg.OUTPUT_DIR = os.path.join(root, "epic_out")
    vgg_ckpt = cu.get_last_checkpoint(vgg_cfg.OUTPUT_DIR)
    cfg.TRAIN.CHECKPOINT_FILE_PATH = vgg_ckpt
    t0 = time.perf_counter()
    test_rows = write_epic(root, cfg)
    print(f"[epic] wrote {EPIC_VIDEOS} wav files of {EPIC_VIDEO_SECS} s and {EPIC_TRAIN} + "
          f"{EPIC_VAL} + {EPIC_TEST} rows in {time.perf_counter() - t0:.1f} s; fine-tune from "
          f"{os.path.basename(vgg_ckpt)}", flush=True)
    batch = cfg.TRAIN.BATCH_SIZE
    n_train, n_val = EPIC_TRAIN // batch, -(-EPIC_VAL // batch)
    n_test = -(-EPIC_TEST * cfg.TEST.NUM_ENSEMBLE_VIEWS // cfg.TEST.BATCH_SIZE)

    with StatsLog() as stats:
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        state = train(cfg)
        torch.cuda.synchronize()
        train_launches = read_launches()
        wall = time.perf_counter() - t0
    want = n_train + min(cfg.BN.NUM_BATCHES_PRECISE, n_train) + n_val
    print(f"[epic] train(cfg): launches {train_launches} ({n_train} train, "
          f"{min(cfg.BN.NUM_BATCHES_PRECISE, n_train)} precise BN, {n_val} val batches), "
          f"{wall:.1f} s in train(cfg); warnings {stats.warnings}", flush=True)
    check(train_launches == {n: (want if n == "logmel_bf16" else 0) for n in REPLACES},
          f"epic train(cfg): launches {train_launches}, expected {want} of logmel_bf16")
    skipped = [w for w in stats.warnings if w.startswith("pyth load: skipped")]
    check(len(skipped) == 2 and any("head.projection_verb " in w for w in skipped)
          and any("head.projection_noun " in w for w in skipped),
          f"the fine-tune skipped {skipped}: it must skip the two head projections only")
    check(stats.start_epochs == [1] and state.step == n_train,
          f"started at epoch {stats.start_epochs}, ended at step {state.step}")
    check(all(p.is_cuda for p in state.model.parameters()), "parameters off the card")
    src = cu.load_checkpoint(vgg_ckpt)["model_state"]
    got = state.model.state_dict()
    frozen = [k for k in src if k.endswith((".weight", ".bias")) and is_frozen_bn_param(k)]
    moved = [k for k in frozen if not torch.equal(got[k].cpu(), src[k])]
    check(frozen and not moved, f"{len(moved)} of {len(frozen)} frozen BN parameters differ "
          f"from the VGG-Sound checkpoint's, e.g. {moved[:3]}")
    iters, viters = stats.of("train_iter"), stats.of("val_iter")
    losses = [r[k] for r in iters for k in ("loss", "verb_loss", "noun_loss")]
    check(len(iters) == n_train and all(math.isfinite(v) for v in losses),
          f"{len(iters)} train_iter records, losses {losses}")
    (val,) = stats.of("val_epoch")
    check(all(0.0 <= val[f"{t}_top{k}_acc"] <= 100.0 for t in ("verb", "noun", "action")
              for k in (1, 5)), f"val record {val}")
    epoch_wall = stats.of("train_epoch")[0]["_at"] - stats.starts[-1]
    steady = iters[1:]
    it_ms = statistics.median(r["dt"] for r in steady) * 1e3
    wait_ms = statistics.median(r["dt_data"] for r in steady) * 1e3
    print(f"[epic] train(cfg) at B={batch} x {cfg.AUDIO_DATA.NUM_FRAMES} frames: {it_ms:.3f} ms "
          f"per train iteration (median of iterations 2-{n_train}, host clock, no sync a "
          f"step; {it_ms / step_ms:.3f} of train_entry's B=64 step in phase 4, {step_ms:.3f} "
          f"ms), data wait {wait_ms:.3f} ms; first iteration {iters[0]['dt']:.4f} s (wait "
          f"{iters[0]['dt_data']:.4f} s: the workers' start); epoch wall {epoch_wall:.4f} s; "
          f"val iterations (s, wait s) {_times(viters)}; every train iteration (s, wait s) "
          f"{_times(iters)} | {card}", flush=True)
    print(f"[epic] train_epoch {stats.of('train_epoch')}; val_epoch {val}", flush=True)
    del state

    tcfg = cfg.clone()
    tcfg.TEST.CHECKPOINT_FILE_PATH = cu.get_path_to_checkpoint(cfg.OUTPUT_DIR, 1)
    tcfg.TEST.SAVE_RESULTS_PATH = "epic_scores.pkl"
    check_loader_workers(card, tcfg)
    with StatsLog() as stats:
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        (verb, noun), (verb_l, noun_l), ids = test(tcfg)
        torch.cuda.synchronize()
        test_launches = read_launches()
        wall = time.perf_counter() - t0
    views = tcfg.TEST.NUM_ENSEMBLE_VIEWS
    print(f"[epic] test(cfg): launches {test_launches}, {wall:.2f} s in test(cfg)", flush=True)
    check(test_launches == {n: (n_test if n == "logmel_bf16" else 0) for n in REPLACES},
          f"epic test(cfg): launches {test_launches}, expected {n_test} of logmel_bf16")
    with open(os.path.join(tcfg.OUTPUT_DIR, "scores", tcfg.TEST.SAVE_RESULTS_PATH), "rb") as f:
        saved = pickle.load(f)
    check(set(saved) == {"verb_output", "noun_output", "labels", "narration_id"}
          and set(saved["labels"]) == {"verb", "noun"}, f"score pickle keys {sorted(saved)}")
    check(saved["verb_output"].shape == (EPIC_TEST, 97)
          and saved["noun_output"].shape == (EPIC_TEST, 300),
          f"scores {saved['verb_output'].shape}, {saved['noun_output'].shape}")
    check(list(saved["narration_id"]) == [r["narration_id"] for r in test_rows] == list(ids),
          f"narration ids {list(saved['narration_id'])[:4]}...")
    for name, got, rows_key in (("verb", saved["labels"]["verb"], "verb_class"),
                                ("noun", saved["labels"]["noun"], "noun_class")):
        check(list(got) == [r[rows_key] for r in test_rows], f"{name} labels differ from the rows")
    check(np.array_equal(saved["verb_output"], verb) and np.array_equal(saved["noun_output"], noun),
          "the score pickle differs from test(cfg)'s result")
    for name, scores in (("verb", verb), ("noun", noun)):
        sums = scores.sum(axis=1)
        check(bool(np.isfinite(scores).all()) and bool((np.abs(sums - views) <= 1e-3).all()),
              f"{name} rows sum to {sums.min()}..{sums.max()}, not {views}")
    check(not stats.of("test_warn"), f"clips with missing views: {stats.of('test_warn')}")
    (final,) = stats.of("test_final")
    recomputed = {}
    for k in (1, 5):
        v, n = _topk(verb, verb_l, k), _topk(noun, noun_l, k)
        for t, hit in (("verb", v), ("noun", n), ("action", v & n)):
            recomputed[f"{t}_top{k}_acc"] = f"{hit.mean() * 100:.2f}"
    check(recomputed == {k: final[k] for k in recomputed},
          f"top-k from the pickle {recomputed}, the meter's {final}")
    titers = stats.of("test_iter")
    check(len(titers) == n_test, f"{len(titers)} test_iter records")
    test_ms = statistics.median(r["time_diff"] for r in titers[1:]) * 1e3
    print(f"[epic] test(cfg) {EPIC_TEST} clips x {views} views at B={tcfg.TEST.BATCH_SIZE}: "
          f"{test_ms:.3f} ms per test iteration (median of iterations 2-{n_test}, host clock), "
          f"{tcfg.TEST.BATCH_SIZE / test_ms * 1e3:.1f} clip views/s; first iteration "
          f"{titers[0]['time_diff']:.4f} s (wait {titers[0]['dt_data']:.4f} s); {final} | "
          f"{card}", flush=True)

    yaml_path = os.path.join(root, "epic.yaml")
    with open(yaml_path, "w") as f:
        f.write(tcfg.dump())
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "asf_tpu_torch.tools.run_net", "--cfg", yaml_path,
         "TRAIN.ENABLE", "False", "TEST.ENABLE", "True", "TEST.SAVE_RESULTS_PATH",
         "epic_cli.pkl"], cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"run_net exited {proc.returncode}: {proc.stderr[-2000:]}")
    with open(os.path.join(tcfg.OUTPUT_DIR, "scores", "epic_cli.pkl"), "rb") as f:
        cli = pickle.load(f)
    diff = max(float(np.abs(cli["verb_output"] - verb).max()),
               float(np.abs(cli["noun_output"] - noun).max()))
    print(f"[epic] python -m asf_tpu_torch.tools.run_net --cfg epic.yaml TRAIN.ENABLE False "
          f"TEST.ENABLE True: exit 0 in {time.perf_counter() - t0:.1f} s, scores {diff:.3g} max "
          f"abs from the in-process run (gated at {CLI_TOL})", flush=True)
    check(diff <= CLI_TOL and list(cli["narration_id"]) == list(ids),
          f"the CLI's scores differ by {diff} > {CLI_TOL}")
    return train_launches, test_launches, tcfg.TEST.CHECKPOINT_FILE_PATH


def write_gru(root: str, cfg) -> list:
    """Phase 8's chain lists over phase 7's videos (``root/epic_audio``);
    points ``cfg``'s ``EPICKITCHENS`` node at them and returns the test
    rows. A chain of n windows lasts (n - 1/2) clip-minus-overlap spans past
    the overlap (a 20-window chain 21-25 s), a one-window chain is shorter
    than a clip, and every tenth row runs past its video's end."""
    from asf_tpu_torch.data.loader import bucket_windows, construct_loader

    a = cfg.AUDIO_DATA
    step = a.CLIP_SECS - a.SPECTROGRAM_OVERLAP
    batch = cfg.TRAIN.BATCH_SIZE
    rng = np.random.default_rng(8)

    def stamp(sec: float) -> str:
        return f"{int(sec // 3600):02d}:{int(sec % 3600 // 60):02d}:{sec % 60:05.2f}"

    lists = {}
    for split, buckets in (("train", GRU_TRAIN_BUCKETS), ("val", GRU_VAL_BUCKETS),
                           ("test", GRU_TEST_BUCKETS)):
        n = len(buckets) * batch - (0 if split == "train" else batch - GRU_RAGGED)
        order = np.arange(n)
        if split == "train":  # the loader's order at epoch 0
            np.random.default_rng(cfg.RNG_SEED).shuffle(order)
        windows = np.empty(n, np.int64)
        for b, top in enumerate(buckets):
            rows = order[b * batch:(b + 1) * batch]
            windows[rows] = rng.integers(1, top + 1, len(rows))
            windows[rows[0]] = top
        rows = []
        for i, nw in enumerate(windows):
            if nw == 1:
                secs = rng.uniform(0.5, a.CLIP_SECS - 0.2)
            elif nw == a.MAX_NB_SPECTROGRAMS:
                secs = rng.uniform(21.0, 25.0)  # more windows than the model takes
            else:
                secs = a.SPECTROGRAM_OVERLAP + (nw - 0.5 + rng.uniform(-0.2, 0.2)) * step
            start = (EPIC_VIDEO_SECS - secs / 2 if i % 10 == 9
                     else rng.uniform(0.0, EPIC_VIDEO_SECS - 26.0))
            rows.append({"narration_id": f"gru_{split}_{i:04d}", "participant_id": "P01",
                         "video_id": f"P01_{i % EPIC_VIDEOS:02d}", "start_timestamp": stamp(start),
                         "stop_timestamp": stamp(start + secs),
                         "verb_class": int(rng.integers(cfg.MODEL.NUM_CLASSES[0])),
                         "noun_class": int(rng.integers(cfg.MODEL.NUM_CLASSES[1]))})
        with open(os.path.join(root, f"gru_{split}.pkl"), "wb") as f:
            pickle.dump(rows, f)
        lists[split] = rows
    c = cfg.EPICKITCHENS
    c.AUDIO_DATA_FILE, c.ANNOTATIONS_DIR = os.path.join(root, "epic_audio"), root
    c.PROCESSED_TRAIN_LIST = "gru_train.pkl"
    c.PROCESSED_VAL_LIST = "gru_val.pkl"
    c.PROCESSED_TEST_LIST = "gru_test.pkl"
    for split, buckets in (("train", GRU_TRAIN_BUCKETS), ("val", GRU_VAL_BUCKETS),
                           ("test", GRU_TEST_BUCKETS)):
        lcfg = cfg.clone()
        lcfg.DATA_LOADER.NUM_WORKERS = 0
        ld = construct_loader(lcfg, split)
        nw, idx, bs = ld.dataset._n_windows, ld._indices(), ld.batch_size
        got = tuple(bucket_windows(int(nw[idx[b * bs:(b + 1) * bs]].max()),
                                   a.MAX_NB_SPECTROGRAMS) for b in range(len(ld)))
        check(got == buckets, f"gru {split} batches pad to {got}, not {buckets}")
    return lists["test"]


def step_times(fn, reps: int = 2, runs: int = 3) -> dict:
    """Medians over ``runs`` of ``reps`` back-to-back calls of ``fn()`` after
    one warm-up call: ms a call on the card (CUDA events), on the host clock
    up to the card's end (wall), and on the host clock until the calls were
    queued (dispatch)."""
    fn()
    torch.cuda.synchronize()
    dev, wall, dispatch = [], [], []
    for _ in range(runs):
        start, end = _events()
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        t1 = time.perf_counter()
        end.synchronize()
        t2 = time.perf_counter()
        dev.append(start.elapsed_time(end) / reps)
        wall.append((t2 - t0) * 1e3 / reps)
        dispatch.append((t1 - t0) * 1e3 / reps)
    return {k: statistics.median(v) for k, v in
            (("ms", dev), ("wall_ms", wall), ("dispatch_ms", dispatch))}


def sync_calls(fn) -> list:
    """``(message, place)`` of each call in ``fn()`` that makes the host wait
    for the card, as torch's sync debug mode reports them; the place is the
    innermost frame of the port (or of the repo) on the stack."""
    found = []

    def hook(message, category, filename, lineno, file=None, line=None):
        text = str(message).splitlines()[0]
        if text.startswith("Synchronization debug mode is a prototype"):
            return
        frames = [f for f in traceback.extract_stack() if f.filename.startswith(str(ROOT))
                  and "chip_smoke" not in f.filename]
        where = (f"{os.path.relpath(frames[-1].filename, ROOT)}:{frames[-1].lineno}" if frames
                 else f"{filename}:{lineno}")
        found.append((text[:60], where))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return found


def step_profile(tag: str, card: str, fn, wall_ms: float) -> None:
    """One train step, ``fn()``, under ``torch.profiler`` (device activity):
    busy ms, idle share against ``wall_ms``, the GRU kernels' ms (names with
    ``rnn`` or ``gru``), the device ms of each group of kernels
    (``profile_forward.group_of``) and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from asf_tpu_torch.tools.profile_forward import busy_us, group_of

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"[{tag}] the profiler recorded no device activity: busy time not measured | "
              f"{card}", flush=True)
        return
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels) / 1e3
    gru = {k: v for k, v in by_name.items() if any(t in k.lower() for t in ("rnn", "gru"))}
    groups = {}
    for k, v in by_name.items():
        groups[group_of(k)] = groups.get(group_of(k), 0.0) + v
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    print(f"[{tag}] one train step under torch.profiler: device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.3f} of the step's wall "
          f"{wall_ms:.3f} ms without the profiler, {len(kernels)} kernels; the GRU's kernels "
          f"{sum(gru.values()):.3f} ms: "
          f"{[(k[:240], round(v, 4)) for k, v in sorted(gru.items(), key=lambda kv: -kv[1])]}; "
          f"groups {sorted(((k, round(v, 3)) for k, v in groups.items()), key=lambda kv: -kv[1])}; "
          f"top kernels {[(k[:70], round(v, 3)) for k, v in top[:10]]} | {card}", flush=True)


def check_padded_windows(card: str, cfg, batch: dict) -> None:
    """The input pipeline on ``batch`` (bf16 front end, K2) against the plain
    front end on the same chains: within ``BF16_TOL``, and the padded
    windows (zeros, ``n_valid`` 1) are log(eps) frames in both."""
    from asf_tpu_torch.dsp.logmel import edge_pad
    from asf_tpu_torch.engine.pipeline import make_input_pipeline, pack_pathways
    from asf_tpu_torch.ops import logmel as ops

    wave, n_valid, lengths = batch["waveform"], batch["n_valid"], batch["lengths"]
    pipe = make_input_pipeline(cfg, wave.device)
    p = pipe.params
    b, n, s = wave.shape
    with torch.inference_mode():
        got = pipe(wave, n_valid)
        x = wave.reshape(b * n, s)
        x = x.float() / 32768.0 if x.dtype == torch.int16 else x
        log_mel = ops.logmel_bf16_plain(x.to(p.dtype).contiguous(), p.w_cos, p.w_sin, p.mel_w,
                                        **p.geometry(s))
        want = pack_pathways(cfg, edge_pad(log_mel, n_valid.reshape(-1), p.hop,
                                           cfg.AUDIO_DATA.NUM_FRAMES))
    pad = torch.arange(n, device=wave.device)[None, :] >= lengths[:, None]
    err = max((g.reshape(b * n, -1) - w.reshape(b * n, -1)).abs().max().item()
              for g, w in zip(got, want))
    eps = math.log(1e-6)
    pad_err = max((g[pad] - eps).abs().max().item() for g in got)
    print(f"[gru] the pipeline at B={b} x N={n} ({b * n} rows, {int(pad.sum())} padded "
          f"windows): max abs {err:.3g} from the plain front end; padded windows "
          f"{pad_err:.3g} from log(1e-6) | {card}", flush=True)
    check(err <= BF16_TOL[0], f"the GRU pipeline is {err} from the plain front end")
    check(bool(pad.any()) and pad_err <= 1e-4, f"padded windows {pad_err} from log(1e-6)")


def phase_gru(card: str, epic_ckpt: str, root: str) -> tuple[dict, dict]:
    """Phase 8: the GRU sequence model's ``train(cfg)``, fine-tuned from
    phase 7's EPIC checkpoint, per-bucket steps timed on the trained state,
    then ``test(cfg)`` in this process and through ``run_net``; returns the
    launch counts of the two in-process runs."""
    from asf_tpu_torch.checkpoint import manager as cu
    from asf_tpu_torch.data.loader import collate, construct_loader
    from asf_tpu_torch.data.prefetch import Prefetcher
    from asf_tpu_torch.engine import test, train
    from asf_tpu_torch.engine.optimizer import is_frozen_bn_param
    from asf_tpu_torch.engine.steps import make_train_step
    from asf_tpu_torch.entry import epic_gru_cfg
    from asf_tpu_torch.tools.loop_probe import StatsLog

    cfg = epic_gru_cfg()
    cfg.SOLVER.MAX_EPOCH = 1
    cfg.LOG_PERIOD = 1
    cfg.LOG_MODEL_INFO = False
    cfg.DATA_LOADER.NUM_WORKERS = LOADER_WORKERS
    cfg.OUTPUT_DIR = os.path.join(root, "gru_out")
    cfg.TRAIN.CHECKPOINT_FILE_PATH = epic_ckpt
    t0 = time.perf_counter()
    test_rows = write_gru(root, cfg)
    batch, max_nb = cfg.TRAIN.BATCH_SIZE, cfg.AUDIO_DATA.MAX_NB_SPECTROGRAMS
    n_train, n_val, n_test = len(GRU_TRAIN_BUCKETS), len(GRU_VAL_BUCKETS), len(GRU_TEST_BUCKETS)
    n_precise = min(cfg.BN.NUM_BATCHES_PRECISE, n_train)
    print(f"[gru] wrote {n_train * batch} + {len(test_rows) + (n_val - n_test) * batch} + "
          f"{len(test_rows)} chain rows in {time.perf_counter() - t0:.1f} s; train batches pad "
          f"to {GRU_TRAIN_BUCKETS} windows, val {GRU_VAL_BUCKETS}, test {GRU_TEST_BUCKETS}; "
          f"fine-tune from {os.path.basename(epic_ckpt)}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    with StatsLog() as stats:
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        state = train(cfg)
        torch.cuda.synchronize()
        train_launches = read_launches()
        wall = time.perf_counter() - t0
    peak_train = torch.cuda.max_memory_allocated() / 2**30
    want = n_train + n_precise + n_val
    print(f"[gru] train(cfg): launches {train_launches} ({n_train} train, {n_precise} precise "
          f"BN, {n_val} val batches), {wall:.1f} s in train(cfg), peak device memory "
          f"{peak_train:.2f} GiB; warnings {stats.warnings}", flush=True)
    check(train_launches == {k: (want if k == "logmel_bf16" else 0) for k in REPLACES},
          f"gru train(cfg): launches {train_launches}, expected {want} of logmel_bf16")
    skipped = sorted(w.split()[3] for w in stats.warnings if w.startswith("pyth load: skipped"))
    check(skipped == ["head.gru", "head.projection_to_dim_in"],
          f"the fine-tune skipped {skipped}: it must skip the GRU and projection_to_dim_in only")
    check(stats.start_epochs == [1] and state.step == n_train,
          f"started at epoch {stats.start_epochs}, ended at step {state.step}")
    check(all(p.is_cuda for p in state.model.parameters()), "parameters off the card")
    src = cu.load_checkpoint(epic_ckpt)["model_state"]
    got = state.model.state_dict()
    frozen = [k for k in src if k.endswith((".weight", ".bias")) and is_frozen_bn_param(k)]
    moved = [k for k in frozen if not torch.equal(got[k].cpu(), src[k])]
    check(frozen and not moved, f"{len(moved)} of {len(frozen)} frozen BN parameters differ "
          f"from the EPIC checkpoint's, e.g. {moved[:3]}")
    iters, viters = stats.of("train_iter"), stats.of("val_iter")
    losses = [r[k] for r in iters for k in ("loss", "verb_loss", "noun_loss")]
    check(len(iters) == n_train and all(math.isfinite(v) for v in losses),
          f"{len(iters)} train_iter records, losses {losses}")
    (val,) = stats.of("val_epoch")
    check(all(0.0 <= val[f"{t}_top{k}_acc"] <= 100.0 for t in ("verb", "noun", "action")
              for k in (1, 5)), f"val record {val}")
    per_bucket = {}
    for r, nb in zip(iters, GRU_TRAIN_BUCKETS):
        per_bucket.setdefault(nb, []).append(r["dt"] * 1e3)
    waits = [r["dt_data"] * 1e3 for r in iters[1:]]
    epoch_wall = stats.of("train_epoch")[0]["_at"] - stats.starts[-1]
    print(f"[gru] train(cfg) ms per iteration by bucket (windows: first, second; host clock at "
          f"each iter_toc, no sync a step): "
          f"{ {nb: [round(t, 3) for t in v] for nb, v in sorted(per_bucket.items())} }; data "
          f"wait median {statistics.median(waits):.3f} ms (iterations 2-{n_train}); first "
          f"iteration {iters[0]['dt']:.4f} s (wait {iters[0]['dt_data']:.4f} s: the workers' "
          f"start); epoch wall {epoch_wall:.4f} s; val iterations (s, wait s) {_times(viters)} "
          f"| {card}", flush=True)
    print(f"[gru] train_epoch {stats.of('train_epoch')}; val_epoch {val}", flush=True)

    # The step of each bucket on the trained state, synchronised: the first
    # batch of that bucket in the epoch's order, read on the host.
    ld = construct_loader(cfg, "train")
    idx = ld._indices()
    firsts = {}
    for b, nb in enumerate(GRU_TRAIN_BUCKETS):
        firsts.setdefault(nb, idx[b * batch:(b + 1) * batch])
    device = next(state.model.parameters()).device
    step = make_train_step(cfg, device)
    lr = 0.01
    timing = {}
    for nb in sorted(firsts):
        host = collate(ld.dataset.get_batch(0, firsts[nb]), max_nb)
        (dev,) = list(Prefetcher([host], device, depth=0))
        if nb == max_nb:
            big = dev
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t = step_times(lambda: step(state, dev, lr))
        if nb == max_nb:
            t["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rows = batch * nb
        t.update(chains_per_s=batch / t["ms"] * 1e3, windows_per_s=rows / t["ms"] * 1e3)
        timing[nb] = t
        print(f"[gru] step at {batch} chains x {nb} windows ({rows} rows): {t['ms']:.3f} ms on "
              f"the card (CUDA events, median of 3 runs of 2 after one), wall {t['wall_ms']:.3f} "
              f"ms, queued in {t['dispatch_ms']:.3f} ms on the host; {t['chains_per_s']:.1f} "
              f"chains/s, {t['windows_per_s']:.1f} windows/s"
              + (f"; peak device memory {t['peak_gib']:.2f} GiB" if "peak_gib" in t else "")
              + f" | {card}", flush=True)
    check_padded_windows(card, cfg, big)
    step_profile("gru", card, lambda: step(state, big, lr), timing[max_nb]["wall_ms"])
    # The calls that make the host wait for the card: none in the GRU
    # model's forward, whose packing reads host lengths; those of a step.
    with torch.inference_mode():
        paths = step.pipeline(big["waveform"], big["n_valid"])
        state.model.eval()
        forward = sync_calls(lambda: state.model(paths, big["lengths"],
                                                 host_lengths=big["host_lengths"]))
    in_step = sync_calls(lambda: step(state, big, lr))
    print(f"[gru] synchronizing calls (torch.cuda.set_sync_debug_mode 'warn'; the port's "
          f"innermost frame): the model's forward {forward}, a train step {in_step}", flush=True)
    check(not forward, f"the GRU model's forward waits for the card at {forward}")
    del state, big, dev

    tcfg = cfg.clone()
    tcfg.TEST.CHECKPOINT_FILE_PATH = cu.get_path_to_checkpoint(cfg.OUTPUT_DIR, 1)
    tcfg.TEST.SAVE_RESULTS_PATH = "gru_scores.pkl"
    with StatsLog() as stats:
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        (verb, noun), (verb_l, noun_l), ids = test(tcfg)
        torch.cuda.synchronize()
        test_launches = read_launches()
        wall = time.perf_counter() - t0
    print(f"[gru] test(cfg): launches {test_launches}, {wall:.2f} s in test(cfg)", flush=True)
    check(test_launches == {k: (n_test if k == "logmel_bf16" else 0) for k in REPLACES},
          f"gru test(cfg): launches {test_launches}, expected {n_test} of logmel_bf16")
    with open(os.path.join(tcfg.OUTPUT_DIR, "scores", tcfg.TEST.SAVE_RESULTS_PATH), "rb") as f:
        saved = pickle.load(f)
    check(set(saved) == {"verb_output", "noun_output", "labels", "narration_id"},
          f"score pickle keys {sorted(saved)}")
    check(saved["verb_output"].shape == (len(test_rows), 97)
          and saved["noun_output"].shape == (len(test_rows), 300),
          f"scores {saved['verb_output'].shape}, {saved['noun_output'].shape}")
    check(list(saved["narration_id"]) == [r["narration_id"] for r in test_rows] == list(ids),
          f"narration ids {list(saved['narration_id'])[:4]}...")
    check(list(saved["labels"]["verb"]) == [r["verb_class"] for r in test_rows]
          and list(saved["labels"]["noun"]) == [r["noun_class"] for r in test_rows],
          "labels differ from the rows")
    check(np.array_equal(saved["verb_output"], verb) and np.array_equal(saved["noun_output"], noun),
          "the score pickle differs from test(cfg)'s result")
    for name, scores in (("verb", verb), ("noun", noun)):
        sums = scores.sum(axis=1)
        check(bool(np.isfinite(scores).all()) and bool((np.abs(sums - 1.0) <= 1e-3).all()),
              f"{name} rows sum to {sums.min()}..{sums.max()}, not 1 (one view a chain)")
    check(not stats.of("test_warn"), f"chains with missing views: {stats.of('test_warn')}")
    (final,) = stats.of("test_final")
    recomputed = {}
    for k in (1, 5):
        v, n = _topk(verb, verb_l, k), _topk(noun, noun_l, k)
        for t, hit in (("verb", v), ("noun", n), ("action", v & n)):
            recomputed[f"{t}_top{k}_acc"] = f"{hit.mean() * 100:.2f}"
    check(recomputed == {k: final[k] for k in recomputed},
          f"top-k from the pickle {recomputed}, the meter's {final}")
    titers = stats.of("test_iter")
    check(len(titers) == n_test, f"{len(titers)} test_iter records")
    print(f"[gru] test(cfg) {len(test_rows)} chains, one view each, B={tcfg.TEST.BATCH_SIZE}: "
          f"test iterations (s, wait s) {[(round(r['time_diff'], 5), round(r['dt_data'], 5)) for r in titers]}; "
          f"{len(test_rows) / wall:.2f} chains/s over all of test(cfg); {final} | {card}",
          flush=True)

    yaml_path = os.path.join(root, "gru.yaml")
    with open(yaml_path, "w") as f:
        f.write(tcfg.dump())
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "asf_tpu_torch.tools.run_net", "--cfg", yaml_path,
         "TRAIN.ENABLE", "False", "TEST.ENABLE", "True", "TEST.SAVE_RESULTS_PATH",
         "gru_cli.pkl"], cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"run_net exited {proc.returncode}: {proc.stderr[-2000:]}")
    with open(os.path.join(tcfg.OUTPUT_DIR, "scores", "gru_cli.pkl"), "rb") as f:
        cli = pickle.load(f)
    diff = max(float(np.abs(cli["verb_output"] - verb).max()),
               float(np.abs(cli["noun_output"] - noun).max()))
    print(f"[gru] python -m asf_tpu_torch.tools.run_net --cfg gru.yaml TRAIN.ENABLE False "
          f"TEST.ENABLE True: exit 0 in {time.perf_counter() - t0:.1f} s, scores {diff:.3g} max "
          f"abs from the in-process run (gated at {CLI_TOL})", flush=True)
    check(diff <= CLI_TOL and list(cli["narration_id"]) == list(ids),
          f"the CLI's scores differ by {diff} > {CLI_TOL}")
    return train_launches, test_launches, timing[max_nb]


def write_state(root: str, cfg, src: str, dst: str, embeddings: bool) -> tuple[list, str]:
    """Phase 9's state lists: the rows of ``root/<src>_{train,val,test}.pkl``
    with each verb mapped onto one of the actions of
    ``pddl/full_domain.pddl`` and its ``precs_vec``/``posts_vec`` (the
    port's ``state/pddl.py``), and with ``embeddings`` a seeded 512-wide
    ``noun_embedding``; writes ``root/<dst>_*.pkl`` and
    ``root/attributes.csv``, points ``cfg`` at them and returns the test
    rows and the number of attributes."""
    from asf_tpu_torch.state.pddl import parse_pddl

    actions, attributes = parse_pddl(str(ROOT / "pddl" / "full_domain.pddl"))
    csv = os.path.join(root, "attributes.csv")
    with open(csv, "w") as f:
        f.write("attribute\n" + "".join(f"{a}\n" for a in attributes))
    vectors = [a.vectorize(attributes) for a in actions]
    rng = np.random.default_rng(9)
    lists = {}
    for split in ("train", "val", "test"):
        with open(os.path.join(root, f"{src}_{split}.pkl"), "rb") as f:
            rows = pickle.load(f)
        for r in rows:
            r["precs_vec"], r["posts_vec"] = vectors[r["verb_class"] % len(vectors)]
            if embeddings:
                r["noun_embedding"] = rng.standard_normal(512).astype(np.float32)
        with open(os.path.join(root, f"{dst}_{split}.pkl"), "wb") as f:
            pickle.dump(rows, f)
        lists[split] = rows
    c = cfg.EPICKITCHENS
    c.AUDIO_DATA_FILE, c.ANNOTATIONS_DIR = os.path.join(root, "epic_audio"), root
    c.PROCESSED_TRAIN_LIST = f"{dst}_train.pkl"
    c.PROCESSED_VAL_LIST = f"{dst}_val.pkl"
    c.PROCESSED_TEST_LIST = f"{dst}_test.pkl"
    cfg.MODEL.PDDL_ATTRIBUTES = csv
    return lists["test"], len(attributes)


def state_train(tag: str, card: str, cfg, ckpt: str, want: int, skipped: list):
    """``train(cfg)`` of a state model fine-tuned from ``ckpt``, with phase
    8's gates: ``want`` launches of ``logmel_bf16``, exactly the head leaves
    ``skipped`` skipped, frozen BN untouched, finite losses (``state_loss``
    too) and the val record's 14 ``Val/state/*`` means in [0, 1]. Returns
    the state, the launch counts and the records."""
    from asf_tpu_torch.checkpoint import manager as cu
    from asf_tpu_torch.engine import train
    from asf_tpu_torch.engine.optimizer import is_frozen_bn_param
    from asf_tpu_torch.tools.loop_probe import StatsLog

    torch.cuda.reset_peak_memory_stats()
    with StatsLog() as stats:
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        state = train(cfg)
        torch.cuda.synchronize()
        launches = read_launches()
        wall = time.perf_counter() - t0
    print(f"[{tag}] train(cfg): launches {launches} (expected {want} of logmel_bf16), "
          f"{wall:.1f} s in train(cfg), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; warnings {stats.warnings}",
          flush=True)
    check(launches == {k: (want if k == "logmel_bf16" else 0) for k in REPLACES},
          f"{tag} train(cfg): launches {launches}, expected {want} of logmel_bf16")
    got = sorted(w.split()[3] for w in stats.warnings if w.startswith("pyth load: skipped"))
    check(got == skipped, f"the fine-tune skipped {got}, not {skipped}")
    check(stats.start_epochs == [1] and all(p.is_cuda for p in state.model.parameters()),
          f"started at epoch {stats.start_epochs}, or parameters off the card")
    src = cu.load_checkpoint(ckpt)["model_state"]
    sd = state.model.state_dict()
    frozen = [k for k in src if k.endswith((".weight", ".bias")) and is_frozen_bn_param(k)]
    moved = [k for k in frozen if not torch.equal(sd[k].cpu(), src[k])]
    check(frozen and not moved, f"{len(moved)} of {len(frozen)} frozen BN parameters moved")
    iters = stats.of("train_iter")
    losses = [r[k] for r in iters for k in ("loss", "verb_loss", "noun_loss", "state_loss")]
    check(iters and all(math.isfinite(v) for v in losses), f"train losses {losses}")
    (val,) = stats.of("val_epoch")
    means = {k: v for k, v in val.items() if k.startswith("Val/state/")}
    check(len(means) == 14 and all(0.0 <= v <= 1.0 for v in means.values()),
          f"val state means {means}")
    print(f"[{tag}] train iterations (s, wait s) {_times(iters)}; val iterations "
          f"{_times(stats.of('val_iter'))}; train_epoch {stats.of('train_epoch')}; val_epoch "
          f"{val} | {card}", flush=True)
    return state, launches


def state_test(tag: str, card: str, cfg, rows: list, views: int, want: int) -> dict:
    """``test(cfg)`` of a state model from its run's checkpoint, in this
    process and through ``run_net``: ``want`` launches, the verb (97) and
    noun (300) rows each summing to ``views``, the ids and labels of
    ``rows``, the meter's top-k from the pickle, the CLI within
    ``CLI_TOL``. Returns the launch counts."""
    from asf_tpu_torch.checkpoint import manager as cu
    from asf_tpu_torch.engine import test
    from asf_tpu_torch.tools.loop_probe import StatsLog

    tcfg = cfg.clone()
    tcfg.TEST.CHECKPOINT_FILE_PATH = cu.get_path_to_checkpoint(cfg.OUTPUT_DIR, 1)
    tcfg.TEST.SAVE_RESULTS_PATH = f"{tag}_scores.pkl"
    # A few batches, read in this process: 8 workers would take ~9 s to
    # start (phases 6-8 drive them at test time).
    tcfg.DATA_LOADER.NUM_WORKERS = 0
    with StatsLog() as stats:
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        (verb, noun), (verb_l, noun_l), ids = test(tcfg)
        torch.cuda.synchronize()
        launches = read_launches()
        wall = time.perf_counter() - t0
    check(launches == {k: (want if k == "logmel_bf16" else 0) for k in REPLACES},
          f"{tag} test(cfg): launches {launches}, expected {want} of logmel_bf16")
    with open(os.path.join(tcfg.OUTPUT_DIR, "scores", tcfg.TEST.SAVE_RESULTS_PATH), "rb") as f:
        saved = pickle.load(f)
    check(set(saved) == {"verb_output", "noun_output", "labels", "narration_id"},
          f"score pickle keys {sorted(saved)}")
    check(saved["verb_output"].shape == (len(rows), 97)
          and saved["noun_output"].shape == (len(rows), 300)
          and np.array_equal(saved["verb_output"], verb)
          and np.array_equal(saved["noun_output"], noun),
          f"scores {saved['verb_output'].shape}, {saved['noun_output'].shape}")
    check(list(ids) == [r["narration_id"] for r in rows]
          and list(verb_l) == [r["verb_class"] for r in rows]
          and list(noun_l) == [r["noun_class"] for r in rows], "ids or labels differ")
    for scores in (verb, noun):
        sums = scores.sum(axis=1)
        check(bool(np.isfinite(scores).all()) and bool((np.abs(sums - views) <= 1e-3).all()),
              f"rows sum to {sums.min()}..{sums.max()}, not {views}")
    (final,) = stats.of("test_final")
    for k in (1, 5):
        v, n = _topk(verb, verb_l, k), _topk(noun, noun_l, k)
        for t, hit in (("verb", v), ("noun", n), ("action", v & n)):
            check(final[f"{t}_top{k}_acc"] == f"{hit.mean() * 100:.2f}",
                  f"{t} top-{k} {final}")
    yaml_path = os.path.join(os.path.dirname(cfg.OUTPUT_DIR), f"{tag}.yaml")
    with open(yaml_path, "w") as f:
        f.write(tcfg.dump())
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "asf_tpu_torch.tools.run_net", "--cfg", yaml_path,
         "TRAIN.ENABLE", "False", "TEST.ENABLE", "True", "TEST.SAVE_RESULTS_PATH",
         f"{tag}_cli.pkl"], cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"run_net exited {proc.returncode}: {proc.stderr[-2000:]}")
    with open(os.path.join(tcfg.OUTPUT_DIR, "scores", f"{tag}_cli.pkl"), "rb") as f:
        cli = pickle.load(f)
    diff = max(float(np.abs(cli["verb_output"] - verb).max()),
               float(np.abs(cli["noun_output"] - noun).max()))
    print(f"[{tag}] test(cfg): {len(rows)} rows x {views} views, launches {launches}, "
          f"{wall:.2f} s; {final}; run_net --cfg {tag}.yaml: exit 0 in "
          f"{time.perf_counter() - t1:.1f} s, scores {diff:.3g} max abs from the in-process "
          f"run (gated at {CLI_TOL}) | {card}", flush=True)
    check(diff <= CLI_TOL and list(cli["narration_id"]) == list(ids),
          f"the CLI's scores differ by {diff} > {CLI_TOL}")
    return launches


def phase_state(card: str, epic_ckpt: str, root: str, gru_step: dict) -> dict:
    """Phase 9: the state head. The GRU state model (``epic_gru_state_cfg``)
    on phase 8's chains, then the single-clip one (``epic_state_cfg``) on
    phase 7's rows, each fine-tuned from phase 7's checkpoint, timed and
    checked on its trained state, then tested; returns the launch counts of
    the four in-process runs by path."""
    from asf_tpu_torch.data.loader import collate, construct_loader
    from asf_tpu_torch.data.prefetch import Prefetcher
    from asf_tpu_torch.engine import metrics
    from asf_tpu_torch.engine.steps import (
        make_loss_fn, make_train_step, prepare_state_labels, state_of)
    from asf_tpu_torch.entry import epic_gru_state_cfg, epic_state_cfg

    projections = ["head.projection_0", "head.projection_1", "head.projection_min_1"]
    out = {}
    cfg = epic_gru_state_cfg()
    cfg.SOLVER.MAX_EPOCH = 1
    cfg.LOG_PERIOD = 1
    cfg.LOG_MODEL_INFO = False
    cfg.DATA_LOADER.NUM_WORKERS = LOADER_WORKERS
    cfg.OUTPUT_DIR = os.path.join(root, "gru_state_out")
    cfg.TRAIN.CHECKPOINT_FILE_PATH = epic_ckpt
    test_rows, n_attr = write_state(root, cfg, "gru", "gru_state", embeddings=True)
    batch, max_nb = cfg.TRAIN.BATCH_SIZE, cfg.AUDIO_DATA.MAX_NB_SPECTROGRAMS
    n_train, n_val = len(GRU_TRAIN_BUCKETS), len(GRU_VAL_BUCKETS)
    state, out["gru state train(cfg)"] = state_train(
        "gru state", card, cfg, epic_ckpt,
        n_train + min(cfg.BN.NUM_BATCHES_PRECISE, n_train) + n_val,
        sorted(["head.gru", "head.projection_to_dim_in"] + projections))
    check(cfg.MODEL.NUM_CLASSES == [97, 300, n_attr] == [97, 300, 30],
          f"NUM_CLASSES {cfg.MODEL.NUM_CLASSES}")

    # The 320-row state step on the trained state, beside phase 8's
    # action-only one; the state output, its sync-free head, h0 and labels.
    ld = construct_loader(cfg, "train")
    idx = ld._indices()
    rows = idx[GRU_TRAIN_BUCKETS.index(max_nb) * batch:][:batch]
    (big,) = list(Prefetcher([collate(ld.dataset.get_batch(0, rows), max_nb)],
                             next(state.model.parameters()).device, depth=0))
    ld.close()
    step = make_train_step(cfg, big["waveform"].device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = step_times(lambda: step(state, big, 0.01))
    t["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"[gru state] step at {batch} chains x {max_nb} windows ({batch * max_nb} rows): "
          f"{t['ms']:.3f} ms on the card (CUDA events, median of 3 runs of 2 after one), wall "
          f"{t['wall_ms']:.3f} ms, queued in {t['dispatch_ms']:.3f} ms, peak device memory "
          f"{t['peak_gib']:.2f} GiB; phase 8's action-only step {gru_step['ms']:.3f} ms (wall "
          f"{gru_step['wall_ms']:.3f}, queued {gru_step['dispatch_ms']:.3f}): "
          f"{t['ms'] / gru_step['ms']:.4f} x | {card}", flush=True)
    step_profile("gru state", card, lambda: step(state, big, 0.01), t["wall_ms"])
    loss_fn = make_loss_fn(cfg)
    model, lengths, labels = state.model, big["lengths"], big["labels"]
    with torch.no_grad():
        paths = step.pipeline(big["waveform"], big["n_valid"])
        model.train()
        forward = sync_calls(lambda: model(paths, lengths, big["noun_embedding"],
                                           host_lengths=big["host_lengths"]))
        preds = model(paths, lengths, big["noun_embedding"], host_lengths=big["host_lengths"])
        loss = sync_calls(lambda: loss_fn(preds, labels, lengths))
        model.eval()
        evals = sync_calls(lambda: model(paths, lengths, big["noun_embedding"],
                                         host_lengths=big["host_lengths"]))
        probs = model(paths, lengths, big["noun_embedding"], host_lengths=big["host_lengths"])
    in_step = sync_calls(lambda: step(state, big, 0.01))
    print(f"[gru state] synchronizing calls (torch.cuda.set_sync_debug_mode 'warn'): the "
          f"train forward with h0 {forward}, the loss with its state labels {loss}, the eval "
          f"forward {evals}, a train step {in_step}", flush=True)
    check(not forward and not loss and not evals,
          f"the state head, h0 or label builder waits for the card: {forward + loss + evals}")
    x_s = probs[2]
    per_window = x_s.reshape(batch * max_nb, 3, n_attr).sum(dim=1)  # the raw view's classes
    check(tuple(x_s.shape) == (batch, max_nb, n_attr, 3)
          and bool(torch.isfinite(x_s).all())
          and float((per_window - 1.0).abs().max()) <= 1e-5,
          f"state output {tuple(x_s.shape)}, class sums off by "
          f"{float((per_window - 1.0).abs().max())}")
    host = [v.cpu() for v in (state_of(probs)[0], labels["precs"], labels["posts"], lengths)]
    t0 = time.perf_counter()
    state_labels = prepare_state_labels(host[1], host[2], host[3], max_nb)
    scores = metrics.state_metrics(host[0].numpy(), state_labels.numpy(), host[3].numpy())
    host_ms = (time.perf_counter() - t0) * 1e3
    print(f"[gru state] state output {tuple(x_s.shape)}, each window's 3 x {n_attr} classes sum "
          f"to 1; the val flush's host work for this batch (state labels, then state_metrics "
          f"on {batch} chains: {2 * batch} windows x 7 metrics) {host_ms:.3f} ms on the host "
          f"clock; {scores} | {card}", flush=True)
    del state, big, preds, probs
    out["gru state test(cfg)"] = state_test("gru_state", card, cfg, test_rows, 1,
                                            len(GRU_TEST_BUCKETS))

    cfg = epic_state_cfg()
    cfg.SOLVER.MAX_EPOCH = 1
    cfg.LOG_PERIOD = 1
    cfg.LOG_MODEL_INFO = False
    cfg.DATA_LOADER.NUM_WORKERS = LOADER_WORKERS
    cfg.OUTPUT_DIR = os.path.join(root, "state_out")
    cfg.TRAIN.CHECKPOINT_FILE_PATH = epic_ckpt
    test_rows, _ = write_state(root, cfg, "epic", "epic_state", embeddings=False)
    batch = cfg.TRAIN.BATCH_SIZE
    n_train, n_val = EPIC_TRAIN // batch, -(-EPIC_VAL // batch)
    state, out["state train(cfg)"] = state_train(
        "state", card, cfg, epic_ckpt,
        n_train + min(cfg.BN.NUM_BATCHES_PRECISE, n_train) + n_val, projections)
    ld = construct_loader(cfg, "train")
    (first,) = list(Prefetcher([collate(ld.dataset.get_batch(0, ld._indices()[:batch]))],
                               next(state.model.parameters()).device, depth=0))
    ld.close()
    step = make_train_step(cfg, first["waveform"].device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = step_times(lambda: step(state, first, 0.001))
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_profile("state", card, lambda: step(state, first, 0.001), t["wall_ms"])
    with torch.no_grad():
        state.model.eval()
        probs = state.model(step.pipeline(first["waveform"], first["n_valid"]))
    check(tuple(probs[2].shape) == (batch, n_attr, 3)
          and float((probs[2].sum(-1) - 1.0).abs().max()) <= 1e-5,
          f"single-clip state output {tuple(probs[2].shape)}")
    print(f"[state] step at B={batch} x {cfg.AUDIO_DATA.NUM_FRAMES} frames: {t['ms']:.3f} ms on "
          f"the card (CUDA events, median of 3 runs of 2 after one), wall {t['wall_ms']:.3f} "
          f"ms, queued in {t['dispatch_ms']:.3f} ms, {batch / t['ms'] * 1e3:.1f} clips/s; peak "
          f"device memory {peak:.2f} GiB; state output {tuple(probs[2].shape)} | {card}",
          flush=True)
    del state, first, probs
    out["state test(cfg)"] = state_test(
        "state", card, cfg, test_rows, cfg.TEST.NUM_ENSEMBLE_VIEWS,
        -(-EPIC_TEST * cfg.TEST.NUM_ENSEMBLE_VIEWS // cfg.TEST.BATCH_SIZE))
    return out


def phase_resnet(card: str, vgg_cfg) -> dict:
    """Phase 10, first part: the single-pathway Slow-only and Fast-only
    ResNet (``entry.resnet_cfg``: R50, 309 classes, weights from a seed) at
    full width: the eval gates, the train step at B = 64 (timed, profiled,
    its peak memory), ``train(cfg)`` of one epoch on phase 5's set and
    ``test(cfg)`` on phase 6's from its checkpoint (the Fast-only one also
    through ``run_net``). Returns the launch counts by path."""
    from asf_tpu_torch.entry import resnet_cfg

    out = {}
    for arch in ("slow", "fast"):
        cfg = resnet_cfg(arch, "vgg")
        out[f"{arch} eval"], _ = phase_slice(card, cfg, tag=f"{arch} eval", n8=2, n128=2)
        torch.cuda.reset_peak_memory_stats()
        out[f"{arch} train"], _ = train_run(card, f"{arch}-only", cfg, 5, "logmel_bf16",
                                            profile=True)
        print(f"[train] {arch}-only: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB at B={TRAIN_BATCH} | {card}",
              flush=True)
        out[f"{arch} train(cfg)"], out[f"{arch} test(cfg)"] = resnet_loop(card, arch, vgg_cfg)
    return out


def resnet_loop(card: str, arch: str, vgg_cfg) -> tuple[dict, dict]:
    """``train(cfg)`` of the ``arch``-only ResNet, one epoch on phase 5's
    set (3 train, 2 precise BN, 2 val batches; the loader in this process:
    phases 5-9 drive its workers), then ``test(cfg)`` of phase 6's set from
    its checkpoint; returns the launch counts of both."""
    from asf_tpu_torch.checkpoint import manager as cu
    from asf_tpu_torch.engine import train
    from asf_tpu_torch.entry import resnet_cfg
    from asf_tpu_torch.tools.loop_probe import StatsLog

    tag = f"{arch} train(cfg)"
    cfg = resnet_cfg(arch, "vgg")
    for key, value in vgg_cfg.VGGSOUND.items():
        cfg.VGGSOUND[key] = value
    cfg.VGGSOUND.TEST_LIST = "test.pkl"  # phase 6's
    cfg.GPU.DSP_PRECISION = "BFLOAT16"
    cfg.TRAIN.BATCH_SIZE = TRAIN_BATCH
    cfg.BN.USE_PRECISE_STATS = True
    cfg.BN.NUM_BATCHES_PRECISE = 2
    cfg.TRAIN.EVAL_PERIOD = cfg.TRAIN.CHECKPOINT_PERIOD = 1
    cfg.SOLVER.MAX_EPOCH = 1
    cfg.LOG_PERIOD = 1
    cfg.LOG_MODEL_INFO = False
    cfg.DATA_LOADER.NUM_WORKERS = 0
    cfg.OUTPUT_DIR = os.path.join(os.path.dirname(vgg_cfg.OUTPUT_DIR), f"{arch}_out")
    with StatsLog() as stats:
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        state = train(cfg)
        torch.cuda.synchronize()
        train_launches = read_launches()
        wall = time.perf_counter() - t0
    print(f"[{tag}] launches {train_launches}, {wall:.1f} s in train(cfg)", flush=True)
    want = {name: (EPOCH_LAUNCHES if name == "logmel_bf16" else 0) for name in REPLACES}
    check(train_launches == want, f"{tag}: launches {train_launches}, expected {want}")
    check(state.step == 3 and all(p.is_cuda for p in state.model.parameters()),
          f"{tag} ended at step {state.step}, or its parameters left the card")
    iters = stats.of("train_iter")
    (val,) = stats.of("val_epoch")
    losses = [r["loss"] for r in iters + stats.of("train_epoch")]
    check(len(iters) == 3 and all(math.isfinite(v) for v in losses), f"{tag} losses {losses}")
    check(0.0 <= val["top1_err"] <= 100.0, f"{tag} val record {val}")
    ckpt = cu.get_path_to_checkpoint(cfg.OUTPUT_DIR, 1)
    check(os.path.exists(ckpt), f"{tag}: {ckpt} missing")
    print(f"[{tag}] train iterations (s, wait s) {_times(iters)}; val iterations "
          f"{_times(stats.of('val_iter'))}; train_epoch {stats.of('train_epoch')}; val_epoch "
          f"{val} | {card}", flush=True)
    del state

    tcfg = cfg.clone()
    tcfg.TEST.NUM_ENSEMBLE_VIEWS = TEST_VIEWS
    tcfg.TEST.BATCH_SIZE = TEST_BATCH
    tcfg.TEST.CHECKPOINT_FILE_PATH = ckpt
    tcfg.TEST.SAVE_RESULTS_PATH = f"{arch}_scores.pkl"
    test_launches, preds, labels = vgg_test(card, tcfg, f"{arch} test(cfg)")
    if arch == "fast":  # one CLI run bounds the time
        vgg_cli(tcfg, preds, labels, f"{arch} test(cfg)")
    return train_launches, test_launches


def _seconds(stamp: str) -> float:
    h, m, sec = stamp.split(":")
    return int(h) * 3600 + int(m) * 60 + float(sec)


def slide_windows(cfg, rows: list, durations: list) -> list:
    """The plain reference of ``EpicKitchensSlide``'s windows: (video, start
    s, end s, verb labels, noun labels) of each, from the annotation
    ``rows`` and the (video, duration) list in the csv's order. A window is
    taken while the middle of its full span lies before the video's end
    (inside the action), and its end is then clipped there."""
    s = cfg.TEST.SLIDE
    out = []
    if s.INSIDE_ACTION_BOUNDS:
        for r in rows:
            start, stop = _seconds(r["start_timestamp"]), _seconds(r["stop_timestamp"])
            spans = [(start, stop)]
            if not s.PER_ACTION_INSTANCE and stop - start >= s.WIN_SIZE:
                spans, a = [], start
                while (a + a + s.WIN_SIZE) / 2 <= stop:
                    spans.append((a, min(a + s.WIN_SIZE, stop)))
                    a += s.HOP_SIZE
            out += [(r["video_id"], a, b, r["verb_class"], r["noun_class"]) for a, b in spans]
        return out
    for video, duration in durations:
        anns = sorted((r for r in rows if r["video_id"] == video),
                      key=lambda r: (r["start_timestamp"], r["stop_timestamp"]))
        a = 0.0
        while (a + a + s.WIN_SIZE) / 2 < duration:
            b = min(a + s.WIN_SIZE, duration)
            hits = [r for r in anns if _seconds(r["start_timestamp"]) <= (a + b) / 2
                    <= _seconds(r["stop_timestamp"])][:SLIDE_OVERLAP]
            hits += hits[:1] * (SLIDE_OVERLAP - len(hits))
            out.append((video, a, b, [r["verb_class"] for r in hits] or [-1] * SLIDE_OVERLAP,
                        [r["noun_class"] for r in hits] or [-1] * SLIDE_OVERLAP))
            a += s.HOP_SIZE
    return out


def phase_slide(card: str, epic_ckpt: str, root: str) -> dict:
    """Phase 10, second part: sliding-window ``test(cfg)`` over phase 7's
    videos from phase 7's checkpoint (``entry.epic_slide_cfg``) in each
    mode, held to ``slide_windows``; the whole-video run with 8 loader
    workers (none on the card) and then through ``run_net`` on the repo's
    ``slide/asf-original-whole-video-1s.yaml``. Returns the launch counts
    of the three runs together."""
    from asf_tpu_torch.data.epickitchens_slide import EpicKitchensSlide
    from asf_tpu_torch.engine import metrics, test
    from asf_tpu_torch.entry import epic_slide_cfg
    from asf_tpu_torch.tools.loop_probe import StatsLog

    durations = [(f"P01_{v:02d}", EPIC_VIDEO_SECS) for v in range(EPIC_VIDEOS)]
    with open(os.path.join(root, SLIDE_DURATIONS), "w") as f:
        f.write("video_id,duration\n" + "".join(f"{v},{d}\n" for v, d in durations))
    with open(os.path.join(root, "epic_test.pkl"), "rb") as f:
        rows = pickle.load(f)
    launches = {name: 0 for name in REPLACES}
    whole = None
    for mode in ("whole_video", "action_bounds", "per_instance"):
        tag = f"slide {mode}"
        cfg = epic_slide_cfg(mode)
        c = cfg.EPICKITCHENS
        c.AUDIO_DATA_FILE, c.ANNOTATIONS_DIR = os.path.join(root, "epic_audio"), root
        c.PROCESSED_TEST_LIST, c.VIDEO_DURS = "epic_test.pkl", SLIDE_DURATIONS
        cfg.TEST.CHECKPOINT_FILE_PATH = epic_ckpt
        cfg.TEST.SAVE_RESULTS_PATH = f"slide_{mode}.pkl"
        cfg.OUTPUT_DIR = os.path.join(root, "slide_out")
        cfg.LOG_PERIOD = 1
        # The whole-video run reads in 8 worker processes; the other two
        # (a few batches) in this process.
        cfg.DATA_LOADER.NUM_WORKERS = LOADER_WORKERS if mode == "whole_video" else 0
        want = slide_windows(cfg, rows, durations)
        ds = EpicKitchensSlide(cfg, "test")
        sr = cfg.AUDIO_DATA.SAMPLING_RATE
        got = [(v, int(a), int(a + n)) for v, a, n in zip(ds._video, ds._start, ds._num)]
        spans = [(v, round(a * sr), round(b * sr)) for v, a, b, _, _ in want]
        check(got == spans, f"{tag}: {len(got)} windows, the plain reference {len(spans)}; "
              f"first samples {got[:2]} against {spans[:2]}")
        for key, col in (("verb", 3), ("noun", 4)):
            check(np.array_equal(ds._labels[key], np.asarray([w[col] for w in want])),
                  f"{tag}: the {key} labels differ from the plain reference")
        n_batches = -(-len(want) // cfg.TEST.BATCH_SIZE)
        if mode == "whole_video":
            check(len(want) == EPIC_VIDEOS * 239,
                  f"{len(want)} windows, not {EPIC_VIDEOS} videos x 239 (1 s every 0.5 s over "
                  f"{EPIC_VIDEO_SECS} s)")
            check_loader_workers(card, cfg)
        with StatsLog() as stats:
            torch.cuda.synchronize()
            zero_launches()
            t0 = time.perf_counter()
            (verb, noun), (verb_l, noun_l), ids = test(cfg)
            torch.cuda.synchronize()
            counts = read_launches()
            wall = time.perf_counter() - t0
        check(counts == {k: (n_batches if k == "logmel_bf16" else 0) for k in REPLACES},
              f"{tag} test(cfg): launches {counts}, expected {n_batches} of logmel_bf16")
        for k, n in counts.items():
            launches[k] += n
        per_instance = cfg.TEST.SLIDE.PER_ACTION_INSTANCE
        labelled = [w for w in want if np.all(np.asarray(w[3]) != -1)]
        n = len(labelled)
        with open(os.path.join(cfg.OUTPUT_DIR, "scores", cfg.TEST.SAVE_RESULTS_PATH), "rb") as f:
            saved = pickle.load(f)
        check(set(saved) == {"verb_output", "noun_output", "labels", "narration_id"}
              and saved["verb_output"].shape == (n, 97) and saved["noun_output"].shape == (n, 300)
              and np.array_equal(saved["verb_output"], verb)
              and np.array_equal(saved["noun_output"], noun),
              f"{tag}: score pickle {sorted(saved)}, {saved['verb_output'].shape}, "
              f"{saved['noun_output'].shape}, expected {n} windows")
        for scores in (verb, noun):
            sums = scores.sum(axis=1)
            check(bool(np.isfinite(scores).all()) and bool((np.abs(sums - 1) <= 1e-3).all()),
                  f"{tag}: rows sum to {sums.min()}..{sums.max()}, not 1")
        width = () if per_instance else (SLIDE_OVERLAP,)
        want_v = np.asarray([np.broadcast_to(w[3], width) if mode == "whole_video" or
                             per_instance else [w[3]] + [-1] * (SLIDE_OVERLAP - 1)
                             for w in labelled])
        check(verb_l.shape == (n, *width) and np.array_equal(verb_l, want_v)
              and np.array_equal(saved["labels"]["verb"], verb_l),
              f"{tag}: verb labels {verb_l.shape}, expected {want_v.shape}")
        (final,) = stats.of("test_final")
        check(final["num_windows_eval"] == n, f"{tag}: {final}")
        recomputed = {}
        for t, acc in (("verb", metrics.topk_accuracies_slide(
                saved["verb_output"], saved["labels"]["verb"], (1, 5), per_instance)),
                       ("noun", metrics.topk_accuracies_slide(
                           saved["noun_output"], saved["labels"]["noun"], (1, 5), per_instance)),
                       ("action", metrics.multitask_topk_accuracies_slide(
                           (saved["verb_output"], saved["noun_output"]),
                           (saved["labels"]["verb"], saved["labels"]["noun"]), (1, 5),
                           per_instance))):
            for k, v in zip((1, 5), acc):
                recomputed[f"{t}_top{k}_acc"] = f"{v:.2f}"
        check(recomputed == {k: final[k] for k in recomputed},
              f"{tag}: top-k from the pickle {recomputed}, the meter's {final}")
        iters = stats.of("test_iter")
        check(len(iters) == n_batches, f"{tag}: {len(iters)} test_iter records")
        steady = [r["time_diff"] for r in iters[1:]] or [iters[0]["time_diff"]]
        it_ms = statistics.median(steady) * 1e3
        print(f"[{tag}] test(cfg) of {len(want)} windows ({n} annotated) in {n_batches} batches "
              f"of up to {cfg.TEST.BATCH_SIZE} x {cfg.AUDIO_DATA.NUM_FRAMES} frames: launches "
              f"{counts}, {wall:.2f} s in test(cfg); {it_ms:.3f} ms per test iteration (median "
              f"of iterations {min(2, len(iters))}-{len(iters)}, host clock, no sync a batch), "
              f"{cfg.TEST.BATCH_SIZE / it_ms * 1e3:.1f} windows/s; first batch's wait "
              f"{iters[0]['dt_data']:.4f} s; {final}; every iteration (s, wait s) "
              f"{[(round(r['time_diff'], 5), round(r['dt_data'], 5)) for r in iters]} | {card}",
              flush=True)
        if mode == "whole_video":
            whole = (cfg, verb, noun, list(ids))
            check(set(ids) == {str(i) for i in range(EPIC_VIDEOS)},
                  f"{tag}: narration ids {sorted(set(ids))}, not each video's row number")

    cfg, verb, noun, ids = whole
    yaml = os.path.join(ROOT, "models", "asf", "config", "slide",
                        "asf-original-whole-video-1s.yaml")
    c = cfg.EPICKITCHENS
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "asf_tpu_torch.tools.run_net", "--cfg", yaml,
         "TRAIN.ENABLE", "False", "OUTPUT_DIR", cfg.OUTPUT_DIR,
         "EPICKITCHENS.AUDIO_DATA_FILE", c.AUDIO_DATA_FILE,
         "EPICKITCHENS.ANNOTATIONS_DIR", c.ANNOTATIONS_DIR,
         "EPICKITCHENS.PROCESSED_TEST_LIST", c.PROCESSED_TEST_LIST,
         "TEST.CHECKPOINT_FILE_PATH", cfg.TEST.CHECKPOINT_FILE_PATH,
         "TEST.SAVE_RESULTS_PATH", "slide_cli.pkl",
         # phase 7's checkpoint is of epic_cfg's trunk (ROADMAP.md section 3)
         "SLOWFAST.ALPHA", str(cfg.SLOWFAST.ALPHA),
         "SLOWFAST.FUSION_KERNEL_SZ", str(cfg.SLOWFAST.FUSION_KERNEL_SZ),
         "GPU.DSP_PRECISION", cfg.GPU.DSP_PRECISION, "DATA_LOADER.NUM_WORKERS", "0"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"run_net exited {proc.returncode}: {proc.stderr[-2000:]}")
    with open(os.path.join(cfg.OUTPUT_DIR, "scores", "slide_cli.pkl"), "rb") as f:
        cli = pickle.load(f)
    diff = max(float(np.abs(cli["verb_output"] - verb).max()),
               float(np.abs(cli["noun_output"] - noun).max()))
    print(f"[slide whole_video] python -m asf_tpu_torch.tools.run_net --cfg "
          f"models/asf/config/slide/asf-original-whole-video-1s.yaml TRAIN.ENABLE False (data, "
          f"checkpoint and trunk overridden): exit 0 in {time.perf_counter() - t0:.1f} s, "
          f"scores {diff:.3g} max abs from the in-process run (gated at {CLI_TOL})", flush=True)
    check(diff <= CLI_TOL and list(cli["narration_id"]) == ids,
          f"the slide CLI's scores differ by {diff} > {CLI_TOL}")
    return launches


def free_port() -> int:
    """A free TCP port on this host, for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def bn_float64_hooks(model, found: list) -> list:
    """Hooks on every live ``GroupedBatchNorm2d`` of ``model`` (one process)
    that hold its output and running statistics to float64 of the same
    function of the input it was given: each forward appends (name, output
    ratio, statistics ratio) to ``found``, a ratio the largest |error| over
    its bound (``BN_OUT_TOL``, ``BN_STAT_TOL``), so 1 is the bound."""
    from asf_tpu_torch.models.norm import GroupedBatchNorm2d

    def before(mod, inp):
        mod.smoke_before = (mod.running_mean.double(), mod.running_var.double())

    def after(name):
        def hook(mod, inp, out):
            x = inp[0].detach().double()
            xs = x.reshape(mod.num_splits, x.shape[0] // mod.num_splits, x.shape[1], -1)
            mean, var = xs.mean(dim=(1, 3)), xs.var(dim=(1, 3), unbiased=False)
            y = ((xs - mean[:, None, :, None]) * torch.rsqrt(var[:, None, :, None] + mod.eps)
                 * mod.weight.double()[:, None] + mod.bias.double()[:, None]).reshape(x.shape)
            out_ratio = ((out.double() - y).abs()
                         / (BN_OUT_TOL[0] * y.abs() + BN_OUT_TOL[1])).max().item()
            agg_mean = mean.mean(dim=0)
            agg_var = var.mean(dim=0) + ((mean - agg_mean) ** 2).mean(dim=0)
            if mod.unbiased_running:
                n = xs.shape[1] * xs.shape[3]
                agg_var = agg_var * n / (n - 1)
            m, stat_ratio = mod.momentum, 0.0
            for got, old, stat in ((mod.running_mean, mod.smoke_before[0], agg_mean),
                                   (mod.running_var, mod.smoke_before[1], agg_var)):
                want = (1 - m) * old + m * stat
                stat_ratio = max(stat_ratio, ((got.double() - want).abs()
                                              / (BN_STAT_TOL[0] * want.abs() + BN_STAT_TOL[1]))
                                 .max().item())
            found.append((name, out_ratio, stat_ratio))
        return hook

    handles = []
    for name, mod in model.named_modules():
        if isinstance(mod, GroupedBatchNorm2d) and not mod.stats_frozen:
            handles += [mod.register_forward_pre_hook(before),
                        mod.register_forward_hook(after(name))]
    return handles


def phase_bn_types(card: str) -> tuple[dict, dict, list]:
    """Phase 11, one process: ``BN_STEPS`` train steps of the flagship at
    B = ``TRAIN_BATCH`` (``train_entry``, bf16) with each of ``batchnorm``
    and ``BN_TYPES``; the first step of a grouped type holds every norm to
    float64. Returns the launch counts, ms a step of each type, and the sync
    debug mode's list for the ``batchnorm`` step."""
    from asf_tpu_torch.entry import flagship_cfg, train_entry
    from asf_tpu_torch.models.norm import BatchNorm2d, GroupedBatchNorm2d
    from asf_tpu_torch.utils.lr_policy import get_lr_at_epoch

    launches, ms, plain_sync = {}, {}, []
    for norm_type, splits in (("batchnorm", 1), *BN_TYPES):
        label = f"{norm_type} S={splits}" if norm_type == "sub_batchnorm" else norm_type
        cfg = flagship_cfg()
        cfg.BN.NORM_TYPE, cfg.BN.NUM_SPLITS = norm_type, splits
        torch.manual_seed(0)
        step, (state, example) = train_entry(batch=TRAIN_BATCH, cfg=cfg)
        want = BatchNorm2d if norm_type == "batchnorm" else GroupedBatchNorm2d
        kinds = {type(m).__name__ for m in state.model.modules()
                 if isinstance(m, torch.nn.BatchNorm2d)}
        check(kinds == {want.__name__}, f"[bn] {label}: norms {kinds}")
        lr = get_lr_at_epoch(step.pipeline.cfg, 200.0)
        found = []
        hooks = bn_float64_hooks(state.model, found)
        torch.cuda.synchronize()
        zero_launches()
        losses = []
        for i in range(BN_STEPS):
            losses.append(step(state, example, lr)[0]["loss"])
            if i == 0:
                for h in hooks:
                    h.remove()
        torch.cuda.synchronize()
        launches[label] = read_launches()
        losses = [v.item() for v in losses]
        check(launches[label] == {k: (BN_STEPS if k == "logmel_bf16" else 0) for k in REPLACES},
              f"[bn] {label}: launches {launches[label]}")
        check(all(math.isfinite(v) and v > 0 for v in losses), f"[bn] {label}: losses {losses}")
        if want is GroupedBatchNorm2d:
            n_live = sum(isinstance(m, GroupedBatchNorm2d) for m in state.model.modules())
            worst_out = max(found, key=lambda f: f[1])
            worst_stat = max(found, key=lambda f: f[2])
            print(f"[bn] {label}: {len(found)} of {n_live} norms held to float64 on their "
                  f"captured inputs in step 1: worst output {worst_out[1]:.3f} of its bound "
                  f"({worst_out[0]}), worst running statistic {worst_stat[2]:.3f} of its bound "
                  f"({worst_stat[0]})", flush=True)
            check(len(found) == n_live and worst_out[1] <= 1.0 and worst_stat[2] <= 1.0,
                  f"[bn] {label}: {len(found)} of {n_live} norms checked, output "
                  f"{worst_out}, statistics {worst_stat} (1 is the bound)")
        ms[label] = cuda_ms(lambda: step(state, example, lr), reps=5, warmup=1, runs=3)
        if norm_type == "batchnorm":
            plain_sync = sync_calls(lambda: step(state, example, lr))
        print(f"[bn] {label}: losses {[round(v, 4) for v in losses]}, {ms[label]:.3f} ms a step "
              f"at B={TRAIN_BATCH} (bf16 flagship, {ms[label] / ms['batchnorm']:.3f} x "
              f"batchnorm's) | {card}", flush=True)
        del step, state, example
    return launches, ms, plain_sync


def _example(cfg, device) -> dict:
    """A seeded VGG-Sound batch of ``TRAIN_BATCH`` clips on ``device``."""
    from asf_tpu_torch.entry import clip_samples

    s, rng = clip_samples(cfg), np.random.default_rng(3)
    return {"waveform": torch.from_numpy(
                rng.standard_normal((TRAIN_BATCH, s)).astype(np.float32) * 0.1).to(device),
            "n_valid": torch.full((TRAIN_BATCH,), s, dtype=torch.int32, device=device),
            "labels": {"class_id": torch.from_numpy(
                rng.integers(0, cfg.MODEL.NUM_CLASSES[0], TRAIN_BATCH)).to(device)}}


def nccl_rank(cfg, device) -> dict:
    """Phase 11's NCCL rank (world size 1): ``train(cfg)``, its launches, the
    collectives issued, the model after it, then one more step of the
    trained state (through its wrapper) under the sync debug mode."""
    from asf_tpu_torch.engine import train
    from asf_tpu_torch.engine.steps import make_train_step
    from asf_tpu_torch.parallel import dist
    from asf_tpu_torch.tools.loop_probe import StatsLog

    dist.CALLS.clear()
    with StatsLog() as stats:
        torch.cuda.synchronize()
        zero_launches()
        state = train(cfg, device=device)
        torch.cuda.synchronize()
        launches = read_launches()
    calls = dict(dist.CALLS)
    model = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    step, example = make_train_step(cfg, device), _example(cfg, device)
    step(state, example, 0.01)
    return {"launches": launches, "calls": calls, "wrapper": type(state.ddp).__name__,
            "model": model, "losses": [r["loss"] for r in stats.of("train_iter")],
            "sync": sync_calls(lambda: step(state, example, 0.01)), "step": state.step}


def float64_step(ranks: int, device) -> dict:
    """One train step of the flagship in float64 (dropout and SpecAugment
    off, ``batchnorm``) on this rank's rows of ``_example``'s clips, through
    ``DistributedDataParallel`` in a process group of ``ranks``, with the
    step's loss (``steps.make_loss_fn``): the loss (averaged over the
    ranks), the gradients (their average) and the running statistics after
    the step, on the host. Every rank runs the front end on the whole host
    batch and keeps its rows, so that both sides feed the model the same
    bits (a rank's own launch at 32 rows differs in the last bits,
    ``rank_front_end``)."""
    from torch.nn.parallel import DistributedDataParallel

    from asf_tpu_torch.engine.pipeline import make_input_pipeline
    from asf_tpu_torch.engine.steps import make_loss_fn, reduce_over_ranks
    from asf_tpu_torch.entry import flagship_cfg
    from asf_tpu_torch.models import build_model
    from asf_tpu_torch.parallel import dist

    cfg = flagship_cfg()
    cfg.NUM_GPUS = ranks
    cfg.GPU.COMPUTE_DTYPE = "float32"
    cfg.GPU.SPEC_AUGMENT = False
    cfg.MODEL.DROPOUT_RATE = 0.0
    model = build_model(cfg, device, torch.Generator().manual_seed(cfg.RNG_SEED)).double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    net = model.train()
    if dist.is_initialized():
        net = DistributedDataParallel(model, device_ids=[device.index], broadcast_buffers=False)
    lo, hi = dist.host_rows(dist.local_rank(cfg), dist.local_size(cfg), TRAIN_BATCH)
    ex = _example(cfg, device)
    paths = [p[lo:hi] for p in make_input_pipeline(cfg, device)(ex["waveform"], ex["n_valid"])]
    loss, _ = make_loss_fn(cfg)(net(paths), {"class_id": ex["labels"]["class_id"][lo:hi]})
    loss.backward()
    if dist.is_initialized():
        loss = reduce_over_ranks({"loss": loss.detach()})["loss"]
    return {"loss": loss.item(),
            "grads": {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
            "stats": {k: v.detach().cpu() for k, v in model.named_buffers()
                      if k.endswith(("running_mean", "running_var"))},
            "norms": sorted({type(m).__name__ for m in model.modules()
                             if isinstance(m, torch.nn.BatchNorm2d)})}


def rank_front_end(device) -> dict:
    """The float32 front end (``logmel_f32``) of this rank's rows (its own
    launch at 32 rows, and SpecAugment with this rank's share of the host
    draws) against the same rows of one launch over the host batch (one
    process's draws): the largest |difference| with and without
    SpecAugment, on the host."""
    from asf_tpu_torch.engine.pipeline import make_input_pipeline
    from asf_tpu_torch.entry import flagship_cfg
    from asf_tpu_torch.parallel import dist

    cfg = flagship_cfg()
    cfg.NUM_GPUS = GLOO_RANKS
    lo, hi = dist.host_rows(dist.local_rank(cfg), dist.local_size(cfg), TRAIN_BATCH)
    ex = _example(cfg, device)
    mine, host = make_input_pipeline(cfg, device), make_input_pipeline(cfg, device)
    host.share = (0, 1)  # one process's draws for the whole host batch
    out = {}
    for train in (False, True):
        got = mine(ex["waveform"][lo:hi], ex["n_valid"][lo:hi],
                   torch.Generator(device=device).manual_seed(cfg.RNG_SEED), train=train)
        want = host(ex["waveform"], ex["n_valid"],
                    torch.Generator(device=device).manual_seed(cfg.RNG_SEED), train=train)
        out["specaugment" if train else "plain"] = max(
            (g - w[lo:hi]).abs().max().item() for g, w in zip(got, want))
    return out


def gloo_rank(cfg, device) -> None:
    """A rank of phase 11's gloo pair on the one card: one ``train(cfg)``
    epoch with ``batchnorm`` and one with ``sync_batchnorm`` at k = 1, then
    ``test(cfg)`` of the first's checkpoint, then ``rank_front_end`` and
    ``float64_step``; writes its launches, losses and roles to
    ``OUTPUT_DIR/rank<r>.json`` and rank 0 the float64 step to
    ``OUTPUT_DIR/float64.pt``."""
    from asf_tpu_torch.engine import test, train
    from asf_tpu_torch.parallel import dist
    from asf_tpu_torch.tools.loop_probe import StatsLog

    out = {}
    for norm_type in ("batchnorm", "sync_batchnorm"):
        run = cfg.clone()
        run.BN.NORM_TYPE = norm_type
        run.OUTPUT_DIR = os.path.join(cfg.OUTPUT_DIR, norm_type)
        with StatsLog() as stats:
            zero_launches()
            state = train(run, device=device)
            torch.cuda.synchronize()
            counts = read_launches()
        out[norm_type] = {
            "launches": counts, "losses": [r["loss"] for r in stats.of("train_iter")],
            "wrapper": type(state.ddp).__name__, "step": state.step,
            "norms": sorted({type(m).__name__ for m in state.model.modules()
                             if isinstance(m, torch.nn.BatchNorm2d)})}
        del state
    run = cfg.clone()
    run.OUTPUT_DIR = os.path.join(cfg.OUTPUT_DIR, "batchnorm")
    zero_launches()
    result = test(run, device=device)
    torch.cuda.synchronize()
    out["test"] = {"launches": read_launches(), "lead": result is not None}
    zero_launches()
    front = rank_front_end(device)
    f64 = float64_step(GLOO_RANKS, device)
    torch.cuda.synchronize()
    out["float64"] = {"launches": read_launches(), "front_end": front}
    if dist.rank() == 0:
        torch.save(f64, os.path.join(cfg.OUTPUT_DIR, "float64.pt"))
    del f64
    with open(os.path.join(cfg.OUTPUT_DIR, f"rank{dist.rank()}.json"), "w") as f:
        json.dump(out, f)


def _positions(cfg) -> dict:
    """Each norm's input positions (frames x frequencies) in ``cfg``'s model."""
    from asf_tpu_torch.engine.pipeline import make_input_pipeline
    from asf_tpu_torch.models import build_model

    model, found = build_model(cfg), {}
    device = next(model.parameters()).device

    def keep(name):
        def hook(mod, inp, out):
            found[name] = inp[0].shape[2] * inp[0].shape[3]
        return hook

    hooks = [m.register_forward_hook(keep(name)) for name, m in model.named_modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    ex = _example(cfg, device)
    with torch.no_grad():
        model.eval()(make_input_pipeline(cfg, device)(ex["waveform"][:2], ex["n_valid"][:2]))
    for h in hooks:
        h.remove()
    return found


def phase_ranks(card: str, loop_cfg, run1_losses: list, plain_sync: list) -> dict:
    """Phase 11, across processes: NCCL at world size 1 through the port's
    per-rank entry, against phase 5's first run; then two gloo ranks on the
    one card against one process. Returns the launch counts by path."""
    from asf_tpu_torch.checkpoint import manager as cu
    from asf_tpu_torch.engine import test, train
    from asf_tpu_torch.models import build_model
    from asf_tpu_torch.tools.loop_probe import StatsLog
    from asf_tpu_torch.tools.run_net import run_rank

    root = os.path.dirname(loop_cfg.OUTPUT_DIR)
    paths = {}

    # NCCL at world size 1: phase 5's first run, in a process group.
    cfg = loop_cfg.clone()
    cfg.OUTPUT_DIR = os.path.join(root, "nccl")
    cfg.SOLVER.MAX_EPOCH = 1
    cfg.DATA_LOADER.NUM_WORKERS = 0  # the same batches bit for bit, no workers to start
    t0 = time.perf_counter()
    res = run_rank(0, cfg, f"tcp://localhost:{free_port()}", nccl_rank, "cuda:0", "nccl")
    wall = time.perf_counter() - t0
    paths["nccl train(cfg)"] = res["launches"]
    want = {name: (EPOCH_LAUNCHES if name == "logmel_bf16" else 0) for name in REPLACES}
    check(res["launches"] == want, f"[ranks] nccl: launches {res['launches']}, expected {want}")
    check(res["wrapper"] == "DistributedDataParallel", f"[ranks] nccl: wrapper {res['wrapper']}")
    check(res["calls"].get("all_gather", 0) >= 3 and res["calls"].get("barrier", 0) >= 1,
          f"[ranks] nccl: collectives {res['calls']} (a step's all_gather, a save's barrier)")
    ref = cu.load_checkpoint(os.path.join(loop_cfg.OUTPUT_DIR, "checkpoints",
                                          "checkpoint_epoch_00001.pyth"))["model_state"]
    worst = max(((k, _rel_l2(v, ref[k])) for k, v in res["model"].items()
                 if not k.endswith("num_batches_tracked")), key=lambda kv: kv[1])
    identical = sum(torch.equal(v, ref[k]) for k, v in res["model"].items())
    loss_diff = max(abs(a - b) for a, b in zip(res["losses"], run1_losses))
    extra = sorted(set(res["sync"]) - set(plain_sync))
    print(f"[ranks] NCCL world size 1 (run_rank, DistributedDataParallel): train(cfg) of phase "
          f"5's run 1 in {wall:.1f} s, collectives {res['calls']}; losses {res['losses']} against "
          f"{run1_losses} (max diff {loss_diff:.3g}); {identical} of {len(ref)} tensors equal "
          f"bit for bit, worst leaf {worst[0]} at {worst[1]:.3g} relative L2; synchronizing "
          f"calls of a step through the wrapper {res['sync']}, of phase 11's step without a "
          f"group {plain_sync} | {card}", flush=True)
    check(len(res["losses"]) == len(run1_losses) == 3 and loss_diff <= DDP_TOL,
          f"[ranks] nccl: losses {res['losses']} against phase 5's {run1_losses}")
    check(worst[1] <= DDP_TOL, f"[ranks] nccl: leaf {worst[0]} {worst[1]:.3g} from phase 5's")
    check(not extra, f"[ranks] nccl: the step through the wrapper waits for the card at {extra}")
    del res

    # Two gloo ranks on the one card, float32 with TF32 off, against one process.
    cfg = loop_cfg.clone()
    cfg.GPU.COMPUTE_DTYPE = "float32"
    cfg.MODEL.DROPOUT_RATE = 0.0  # each rank draws its own dropout: off for the comparison
    # Phase 5's LR (0.1 at 309 random classes) takes the loss from 6 to 19 in
    # one step; a small one keeps val on a model near its start.
    cfg.SOLVER.BASE_LR = 1e-3
    cfg.BN.MOMENTUM_OVERRIDE = 1.0
    cfg.BN.USE_PRECISE_STATS = False
    with open(os.path.join(root, cfg.VGGSOUND.TRAIN_LIST), "rb") as f:
        one_step = pickle.load(f)[:TRAIN_BATCH]
    with open(os.path.join(root, GLOO_TRAIN_LIST), "wb") as f:
        pickle.dump(one_step, f)
    cfg.VGGSOUND.TRAIN_LIST = GLOO_TRAIN_LIST
    cfg.SOLVER.MAX_EPOCH = 1
    cfg.DATA_LOADER.NUM_WORKERS = 0
    cfg.BN.NUM_SYNC_DEVICES = 1
    cfg.NUM_GPUS = GLOO_RANKS
    cfg.VGGSOUND.TEST_LIST = "test.pkl"  # phase 6's set
    cfg.TEST.NUM_ENSEMBLE_VIEWS, cfg.TEST.BATCH_SIZE = TEST_VIEWS, TEST_BATCH
    cfg.TEST.SAVE_RESULTS_PATH = "gloo_scores.pkl"
    cfg.OUTPUT_DIR = os.path.join(root, "gloo")
    os.makedirs(cfg.OUTPUT_DIR)
    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(
        run_rank, args=(cfg, f"tcp://localhost:{free_port()}", gloo_rank, "cuda:0", "gloo"),
        nprocs=GLOO_RANKS, start_method="spawn")
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(GLOO_RANKS):
        with open(os.path.join(cfg.OUTPUT_DIR, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    ref = cfg.clone()
    ref.NUM_GPUS = 1
    one = {}
    for norm_type, splits in (("batchnorm", 1), ("sub_batchnorm", 2)):
        run = ref.clone()
        run.BN.NORM_TYPE, run.BN.NUM_SPLITS = norm_type, splits
        run.OUTPUT_DIR = os.path.join(root, "one", norm_type)
        with StatsLog() as stats:
            zero_launches()
            train(run)
            torch.cuda.synchronize()
            paths[f"one-process {norm_type} train(cfg)"] = read_launches()
        one[norm_type] = ([r["loss"] for r in stats.of("train_iter")], cu.load_checkpoint(
            cu.get_path_to_checkpoint(run.OUTPUT_DIR, 1))["model_state"])
    n_split = {k: p * TRAIN_BATCH // 2 for k, p in _positions(ref).items()}
    start = {k: v.cpu() for k, v in build_model(ref, "cuda", torch.Generator().manual_seed(
        ref.RNG_SEED)).state_dict().items()}
    for tag, mine, theirs in (("batchnorm", "batchnorm", "batchnorm"),
                              ("sync_batchnorm k=1", "sync_batchnorm", "sub_batchnorm")):
        losses, want = one[theirs]
        got = cu.load_checkpoint(cu.get_path_to_checkpoint(
            os.path.join(cfg.OUTPUT_DIR, mine), 1))["model_state"]
        if mine == "sync_batchnorm":  # biased -> unbiased with a split's count n
            cut = len(".running_var")
            got = {k: (v.double() * n_split[k[:-cut]] / (n_split[k[:-cut]] - 1)
                       if k.endswith(".running_var") else v) for k, v in got.items()}
        params = [k for k in want if not k.endswith(("running_mean", "running_var",
                                                      "num_batches_tracked"))]
        update = _rel_l2(torch.cat([(got[k] - start[k]).double().flatten() for k in params]),
                         torch.cat([(want[k] - start[k]).double().flatten() for k in params]))
        stats = {s: _rel_l2(torch.cat([got[k].double().flatten() for k in want if k.endswith(s)]),
                            torch.cat([want[k].double().flatten() for k in want if k.endswith(s)]))
                 for s in ("running_mean", "running_var")}
        leaves = sorted(((k, _rel_l2(got[k], want[k])) for k in want
                         if not k.endswith("num_batches_tracked")), key=lambda kv: -kv[1])[:3]
        rank_losses = ranks[0][mine]["losses"]
        diff = max(abs(a - b) / abs(b) for a, b in zip(rank_losses, losses))
        print(f"[ranks] gloo x{GLOO_RANKS} on cuda:0, {tag}, against one process with {theirs}"
              f"{' S=2' if theirs == 'sub_batchnorm' else ''}: norms {ranks[0][mine]['norms']}, "
              f"losses {rank_losses} against {losses} (max relative diff {diff:.3g}); the "
              f"step's update {update:.3g} relative L2 from one process's, running means "
              f"{stats['running_mean']:.3g}, running variances {stats['running_var']:.3g}; worst "
              f"leaves {[(k, float(f'{v:.3g}')) for k, v in leaves]} (float32, TF32 off) | {card}",
              flush=True)
        check(all(r[mine]["wrapper"] == "DistributedDataParallel" and r[mine]["step"] == 1
                  for r in ranks), f"[ranks] gloo {tag}: {[r[mine] for r in ranks]}")
        check(len(rank_losses) == len(losses) == 1 and diff <= GLOO_LOSS_TOL
              and update <= GLOO_UPDATE_TOL and max(stats.values()) <= GLOO_STAT_TOL,
              f"[ranks] gloo {tag}: losses {diff:.3g}, update {update:.3g}, statistics {stats}")
        for r, rec in enumerate(ranks):
            paths[f"gloo rank {r} {tag} train(cfg)"] = rec[mine]["launches"]
            check(rec[mine]["launches"]["logmel_bf16"] == GLOO_LAUNCHES,
                  f"[ranks] gloo rank {r} {tag}: launches {rec[mine]['launches']}")
    scores_dir = os.path.join(cfg.OUTPUT_DIR, "batchnorm", "scores")
    check(os.listdir(scores_dir) == ["gloo_scores.pkl"], f"score pickles {os.listdir(scores_dir)}")
    with open(os.path.join(scores_dir, "gloo_scores.pkl"), "rb") as f:
        two = pickle.load(f)
    tcfg = cfg.clone()
    tcfg.NUM_GPUS = 1
    tcfg.OUTPUT_DIR = os.path.join(root, "one", "test")
    tcfg.TEST.CHECKPOINT_FILE_PATH = cu.get_path_to_checkpoint(
        os.path.join(cfg.OUTPUT_DIR, "batchnorm"), 1)
    zero_launches()
    preds, labels = test(tcfg)
    torch.cuda.synchronize()
    paths["one-process gloo-set test(cfg)"] = read_launches()
    diff = float(np.abs(two["output"] - preds).max())
    leads = [r["test"]["lead"] for r in ranks]
    print(f"[ranks] gloo x{GLOO_RANKS} test(cfg): one pickle, {two['output'].shape} scores "
          f"{diff:.3g} max abs from one process's, local rank 0 kept the meter ({leads}); "
          f"{wall:.1f} s for the two ranks' runs, spawn included | {card}", flush=True)
    check(np.array_equal(two["labels"], labels) and diff <= GLOO_SCORE_TOL
          and leads == [True, False],
          f"[ranks] gloo test: scores {diff:.3g} apart, labels equal "
          f"{np.array_equal(two['labels'], labels)}, leads {leads}")
    for r, rec in enumerate(ranks):
        paths[f"gloo rank {r} test(cfg)"] = rec["test"]["launches"]
        check(rec["test"]["launches"]["logmel_bf16"] == TEST_LAUNCHES,
              f"[ranks] gloo rank {r} test: launches {rec['test']['launches']}")

    # The float64 step of the two ranks against one process's.
    zero_launches()
    one = float64_step(1, torch.device("cuda", 0))
    torch.cuda.synchronize()
    paths["one-process float64 step"] = read_launches()
    two = torch.load(os.path.join(cfg.OUTPUT_DIR, "float64.pt"))
    names = list(one["grads"])
    grad = _rel_l2(torch.cat([two["grads"][k].flatten() for k in names]),
                   torch.cat([one["grads"][k].flatten() for k in names]))
    leaf = max(((k, _rel_l2(two["grads"][k], one["grads"][k])) for k in names),
               key=lambda kv: kv[1])
    stats = {s: _rel_l2(torch.cat([v.flatten() for k, v in two["stats"].items() if k.endswith(s)]),
                        torch.cat([v.flatten() for k, v in one["stats"].items() if k.endswith(s)]))
             for s in ("running_mean", "running_var")}
    loss = abs(two["loss"] - one["loss"]) / abs(one["loss"])
    fronts = [rec["float64"]["front_end"] for rec in ranks]
    print(f"[ranks] gloo x{GLOO_RANKS} on cuda:0, each rank's front end against the host "
          f"batch's rows: {fronts} max abs (K1 at 32 rows; with SpecAugment, its share of the "
          f"draws) | {card}", flush=True)
    check(max(v for f in fronts for v in f.values()) <= GLOO_FRONT_TOL,
          f"[ranks] a rank's front end {fronts} (bound {GLOO_FRONT_TOL})")
    print(f"[ranks] gloo x{GLOO_RANKS} on cuda:0, one float64 step on the same front-end output "
          f"(norms {two['norms']}) against one process's ({one['norms']}): gradient {grad:.3g} "
          f"relative L2, worst leaf {leaf[0]} {leaf[1]:.3g}; running means "
          f"{stats['running_mean']:.3g}, variances {stats['running_var']:.3g}; loss "
          f"{two['loss']:.9f} against {one['loss']:.9f} ({loss:.3g}) | {card}", flush=True)
    check(two["norms"] == ["GroupedBatchNorm2d"] and one["norms"] == ["BatchNorm2d"],
          f"[ranks] float64 step: norms {two['norms']} against {one['norms']}")
    check(max(grad, leaf[1], loss, *stats.values()) <= GLOO_F64_TOL,
          f"[ranks] float64 step: gradient {grad:.3g}, leaf {leaf}, statistics {stats}, loss "
          f"{loss:.3g} (bound {GLOO_F64_TOL})")
    for r, rec in enumerate(ranks):
        paths[f"gloo rank {r} front end and float64 step"] = rec["float64"]["launches"]
        check(rec["float64"]["launches"]["logmel_f32"] == 5,
              f"[ranks] gloo rank {r} front end and float64 step: launches "
              f"{rec['float64']['launches']}")
    return paths


class WandbStandIn(types.ModuleType):
    """A ``wandb`` module that records ``init``, ``log``, ``alert`` and
    ``finish``: the card's machine has no ``wandb``, and this lets the watch
    histograms run on the card."""

    class AlertLevel:
        WARN = "WARN"

    class Histogram:
        def __init__(self, np_histogram=None):
            self.np_histogram = np_histogram

    def __init__(self):
        super().__init__("wandb")
        self.calls = []
        calls = self.calls

        class Run:
            def log(self, payload, step=None):
                calls.append(("log", payload, step))

            def alert(self, title, text, level):
                calls.append(("alert", title, text, level))

            def finish(self):
                calls.append(("finish",))

        self._run = Run

    def init(self, **kwargs):
        self.calls.append(("init", kwargs))
        return self._run()


def _predict_case(card: str, tag: str, cfg, wav: str, kernels: dict, flush) -> dict:
    """``predict.main`` on ``wav`` with ``cfg``'s checkpoint; returns its
    launch counts. Gates: one launch of the kernel ``cfg``'s front end picks
    at the whole file's frames, the ``.npz`` holding the returned scores
    (finite rows summing to 1), the kernel's log-mel at that shape within
    ``BF16_TOL`` / ``F32_TOL`` of its plain version, and the eval
    probabilities of the kernel's spectrogram within ``PROB_TOL`` of the
    plain front end's through ``float32_copy`` of the model. Adds the
    kernel's row at this shape (times, bound) to ``kernels``."""
    from asf_tpu_torch.dsp.logmel import LogMelParams, edge_pad
    from asf_tpu_torch.engine.pipeline import pack_pathways
    from asf_tpu_torch.ops import logmel as ops
    from asf_tpu_torch.tools import predict

    out = cfg.OUTPUT_DIR
    os.makedirs(out, exist_ok=True)
    yaml_path = os.path.join(out, "predict.yaml")
    with open(yaml_path, "w") as f:
        f.write(cfg.dump())
    npz = os.path.join(out, "predict_scores.npz")
    if os.path.exists(npz):
        os.remove(npz)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    preds = predict.main([wav, "--cfg", yaml_path, "--device", TOOLS_DEVICE])
    torch.cuda.synchronize()
    launches = read_launches()
    wall = time.perf_counter() - t0

    p = LogMelParams(cfg, TOOLS_DEVICE)
    wave = torch.from_numpy(predict.read_audio(cfg, wav)).to(TOOLS_DEVICE)
    n_samples = wave.shape[0]
    geo = p.geometry(n_samples)
    name = p.kernel(geo["n_frames"]).__name__
    t_out = predict.out_frames(cfg, n_samples, p.hop)
    print(f"[tools] {tag}: predict.main in {wall:.2f} s; {n_samples} samples, the kernel over "
          f"1 x {geo['n_frames']} frames ({t_out} after the ALPHA rounding or the edge "
          f"padding), launches {launches}: {name}", flush=True)
    check(launches == {n: int(n == name) for n in REPLACES},
          f"{tag}: launches {launches}, expected one of {name}")
    saved = np.load(npz)
    heads = ["verb", "noun"] if len(cfg.MODEL.NUM_CLASSES) > 1 else ["class"]
    check(sorted(saved.files) == sorted(heads), f"{tag}: npz holds {saved.files}")
    for head, pr, n_cls in zip(heads, preds, cfg.MODEL.NUM_CLASSES):
        check(pr.shape == (1, n_cls) and np.array_equal(saved[head], pr)
              and bool(np.isfinite(pr).all()) and abs(float(pr.sum()) - 1) <= 1e-3,
              f"{tag}: {head} scores {pr.shape}, sum {pr.sum()}")

    kernel, plain = getattr(ops, name), getattr(ops, f"{name}_plain")
    args = (wave[None].to(p.dtype).contiguous(), p.w_cos, p.w_sin, p.mel_w)
    with torch.inference_mode():
        got = kernel(*args, **geo)
        want = plain(*args, **geo)
    err = (got - want).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    if p.fast:
        check(max_err <= BF16_TOL[0] and mean_err <= BF16_TOL[1],
              f"{tag}: log-mel max {max_err} mean {mean_err} > {BF16_TOL}")
    else:
        check(max_err <= F32_TOL, f"{tag}: log-mel max {max_err} > {F32_TOL}")
    ms = cuda_ms(lambda: kernel(*args, **geo), reps=10)
    cold = cold_ms(lambda: kernel(*args, **geo), flush, reps=7)
    plain_ms = cuda_ms(lambda: plain(*args, **geo), reps=3, runs=3)
    row = dict(ms=ms, cold_ms=cold, plain_ms=plain_ms, max_abs_err=max_err,
               **kernel_work(p, args, geo, card))
    row["tflops"] = row["gflop"] / ms
    kernels[name]["rows"][(f"predict {tag}", 1)] = row
    kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], max_err)
    plan = ""
    if not p.fast:
        frames, splits = ops.f32_device_plan(1, geo["n_frames"], geo["hop"], p.ksup,
                                             p.w_cos.shape[1], TOOLS_DEVICE)
        plan = f"; plan {frames} frames a block x {splits} frequency slice(s)"
    else:
        tiles = -(-geo["n_frames"] // ops.tc_frames_per_block(geo["hop"], p.ksup))
        n_sms = torch.cuda.get_device_properties(0).multi_processor_count
        plan = f"; {tiles} blocks on {n_sms} SMs ({tiles / n_sms:.2f} waves)"
    print(f"[kernel] {name} predict {tag} 1 x {geo['n_frames']} frames: max_abs_err "
          f"{max_err:.3g} mean {mean_err:.3g} | {ms:.4f} ms warm, {cold:.4f} ms cold (plain "
          f"{plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
          f"{row['bound_ms'] / ms:.3f} of it; {row['tflops']:.2f} TFLOP/s){plan} | {card}",
          flush=True)

    # the plain version of the kernel (``want``) is the front end the gate
    # judges against: logmel_f32_plain or logmel_bf16_plain, as in phase 3
    model = predict.load_model(cfg, TOOLS_DEVICE)
    twin = float32_copy(model, cfg)

    def probs(spec_or_paths):
        paths = (spec_or_paths if isinstance(spec_or_paths, list)
                 else pack_pathways(cfg, edge_pad(spec_or_paths, None, p.hop, t_out)))
        out = twin(paths)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    with torch.inference_mode():
        ref = probs(want)
        judged = probs(predict.load_audio(cfg, wav, TOOLS_DEVICE))
        control = probs(want * (1 + CONTROL))
    gate = max((a - b).abs().max().item() for a, b in zip(judged, ref))
    ctrl = max((a - b).abs().max().item() for a, b in zip(control, ref))
    bf16 = max(float(np.abs(a - b.float().cpu().numpy()).max()) for a, b in zip(preds, ref))
    print(f"[tools] {tag}: probabilities of the kernel's spectrogram against {plain.__name__}'s "
          f"through a float32 copy of the model: max abs {gate:.3g} (gated at {PROB_TOL}); the "
          f"plain log-mel {CONTROL:.0%} off: {ctrl:.3g} (not gated); predict's bf16 model "
          f"against the float32 copy on the plain one: {bf16:.3g} (not gated)", flush=True)
    check(gate <= PROB_TOL, f"{tag}: probabilities differ by {gate} > {PROB_TOL}")
    del model, twin
    return launches


def write_main_originals(root: str, epic_root: str, n_verbs: int) -> dict:
    """``main``'s inputs beside phase 7's lists: verb and noun class csvs
    (the verbs of ``pddl/domain.pddl`` first), phase 7's train and val rows
    (lists of dicts with ``narration_id``) as the original lists; returns
    the ``EPICKITCHENS`` keys that name them."""
    import csv

    from asf_tpu_torch.state.pddl import parse_pddl

    actions, _ = parse_pddl(str(ROOT / "pddl" / "domain.pddl"))
    names = [a.name for a in actions]
    verbs = names + [f"verb{i}" for i in range(len(names), 97)]
    for fname, keys in (("verbs.csv", verbs), ("nouns.csv", [f"noun{i}" for i in range(300)])):
        with open(os.path.join(root, fname), "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(["id", "key"])
            w.writerows(enumerate(keys))
    return {"VERBS_FILE": os.path.join(root, "verbs.csv"),
            "NOUNS_FILE": os.path.join(root, "nouns.csv"),
            "ORIGINAL_TRAIN_LIST": os.path.join(epic_root, "epic_train.pkl"),
            "ORIGINAL_VAL_LIST": os.path.join(epic_root, "epic_val.pkl"),
            "VERBS": verbs[:n_verbs]}


def phase_main(card: str, vgg_ckpt: str, epic_root: str) -> tuple[dict, str]:
    """``python -m asf_tpu_torch.main``'s ``main`` with ``--train`` in this
    process: the preparation from list-of-dict originals, one epoch
    fine-tuned from ``vgg_ckpt`` with the observers and the profiler, then
    the test with a config read afresh; returns its launch counts and the
    processed val list."""
    from asf_tpu_torch import main as port_main
    from asf_tpu_torch.entry import epic_cfg
    from asf_tpu_torch.engine.steps import watch_name
    from asf_tpu_torch.tools.loop_probe import StatsLog

    root = os.path.join(epic_root, "main")
    os.makedirs(root)
    cfg = epic_cfg()
    ek = cfg.EPICKITCHENS
    for k, v in write_main_originals(root, epic_root, MAIN_VERBS).items():
        ek[k] = v
    ek.AUDIO_DATA_FILE = os.path.join(epic_root, "epic_audio")
    ek.ANNOTATIONS_DIR = root
    ek.PROCESSED_TRAIN_LIST = os.path.join(root, "full_train.pkl")
    ek.PROCESSED_VAL_LIST = ek.PROCESSED_TEST_LIST = os.path.join(root, "full_val.pkl")
    ek.STATE.PDDL_DOMAIN = str(ROOT / "pddl" / "domain.pddl")
    ek.STATE.PDDL_PROBLEM = str(ROOT / "pddl" / "problem.pddl")
    ek.STATE.NOUNS_EMBEDDINGS_FILE = os.path.join(root, "nouns_embeddings.pkl")
    ek.AUGMENT.ENABLE = ek.AUGMENT.BALANCE = True
    cfg.MODEL.PDDL_ATTRIBUTES = os.path.join(root, "attributes.csv")
    cfg.TRAIN.CHECKPOINT_FILE_PATH = vgg_ckpt
    cfg.SOLVER.MAX_EPOCH = 1
    cfg.BN.NUM_BATCHES_PRECISE = 2
    cfg.TEST.NUM_ENSEMBLE_VIEWS = MAIN_VIEWS
    cfg.DATA_LOADER.NUM_WORKERS = 0
    cfg.LOG_PERIOD = MAIN_LOG_PERIOD
    cfg.LOG_MODEL_INFO = False
    cfg.TENSORBOARD.ENABLE = cfg.WANDB.ENABLE = True
    cfg.GPU.PROFILE_DIR = os.path.join(root, "profile")
    cfg.GPU.PROFILE_START_ITER, cfg.GPU.PROFILE_NUM_ITERS = 1, 2
    cfg.OUTPUT_DIR = os.path.join(root, "out")
    yaml_path = os.path.join(root, "main.yaml")
    with open(yaml_path, "w") as f:
        f.write(cfg.dump())

    stand_in = WandbStandIn()
    saved_wandb = sys.modules.get("wandb")
    sys.modules["wandb"] = stand_in
    try:
        with StatsLog() as stats:
            torch.cuda.synchronize()
            zero_launches()
            t0 = time.perf_counter()
            port_main.main({"config": yaml_path, "train": True, "test": False,
                            "device": TOOLS_DEVICE})
            torch.cuda.synchronize()
            launches = read_launches()
            wall = time.perf_counter() - t0
    finally:
        if saved_wandb is None:
            sys.modules.pop("wandb", None)
        else:
            sys.modules["wandb"] = saved_wandb

    with open(ek.PROCESSED_TRAIN_LIST, "rb") as f:
        train_rows = pickle.load(f)
    with open(ek.PROCESSED_VAL_LIST, "rb") as f:
        val_rows = pickle.load(f)
    keep = set(range(MAIN_VERBS))
    check(isinstance(train_rows, list) and train_rows and all(
        r["verb_class"] in keep and "narration_id" in r and r["noun_embedding"].shape == (1, 512)
        for r in train_rows + val_rows), "the processed lists: rows of other verbs or keys missing")
    transformed = sum(r["transformation"] != "none" for r in train_rows)
    with open(cfg.MODEL.PDDL_ATTRIBUTES) as f:
        attributes = f.read().splitlines()
    check(attributes[0] == "attribute" and len(attributes) > 1, f"attributes.csv {attributes[:3]}")
    batch = cfg.TRAIN.BATCH_SIZE
    n_train, n_val = len(train_rows) // batch, -(-len(val_rows) // batch)
    n_test = -(-len(val_rows) * MAIN_VIEWS // cfg.TEST.BATCH_SIZE)
    want = n_train + min(2, n_train) + n_val + n_test
    print(f"[tools] main --train: {wall:.1f} s; prepared {len(train_rows)} train rows "
          f"({transformed} augmented copies) and {len(val_rows)} val rows of {MAIN_VERBS} verbs, "
          f"{len(attributes) - 1} attributes; launches {launches} ({n_train} train, "
          f"{min(2, n_train)} precise BN, {n_val} val, {n_test} test batches)", flush=True)
    check(launches == {n: (want if n == "logmel_bf16" else 0) for n in REPLACES},
          f"main: launches {launches}, expected {want} of logmel_bf16")
    with open(os.path.join(cfg.OUTPUT_DIR, "scores", "test_scores.pkl"), "rb") as f:
        scores = pickle.load(f)
    check(scores["verb_output"].shape == (len(val_rows), 97)
          and scores["noun_output"].shape == (len(val_rows), 300)
          and list(scores["narration_id"]) == [r["narration_id"] for r in val_rows],
          f"main's score pickle: {scores['verb_output'].shape}")
    for head in ("verb_output", "noun_output"):
        sums = scores[head].sum(axis=1)
        check(bool((np.abs(sums - MAIN_VIEWS) <= 1e-3).all()), f"{head} rows sum to {sums}")

    live = ["wandb (a stand-in module)"] if any(c[0] == "init" for c in stand_in.calls) else []
    disabled = [w for w in stats.warnings if w.startswith(("TensorBoard disabled",
                                                           "wandb disabled"))]
    print(f"[tools] observers: live sinks {live}; {disabled}", flush=True)
    check(live, "the W&B stand-in was not initialised")
    ckpt = torch.load(os.path.join(cfg.OUTPUT_DIR, "checkpoints", "checkpoint_epoch_00001.pyth"),
                      map_location="cpu", weights_only=False)["model_state"]
    sizes = {watch_name(k, v.dim()): v.numel() for k, v in ckpt.items()}
    hist_steps, leaves = [], 0
    for kind, *rest in stand_in.calls:
        if kind == "log" and any(k.startswith("gradients/") for k in rest[0]):
            payload, step = rest
            hist_steps.append(step)
            for name, h in payload.items():
                counts, edges = h.np_histogram
                check(int(counts.sum()) == sizes[name.split("/", 1)[1]] and len(edges) == 65,
                      f"histogram {name} at step {step}: counts sum to {counts.sum()}")
                leaves += 1
    scalars = sorted({k for kind, *rest in stand_in.calls if kind == "log" for k in rest[0]
                      if k.startswith(("Train/", "Val/"))})
    print(f"[tools] W&B stand-in: histograms at steps {hist_steps} ({leaves} leaves, each "
          f"one's counts summing to its size); scalars {scalars}", flush=True)
    check(hist_steps == list(range(0, n_train, MAIN_LOG_PERIOD)),
          f"histograms at {hist_steps}, expected every {MAIN_LOG_PERIOD} steps of {n_train}")
    check("Train/loss" in scalars and "Val/verb_top1_acc" in scalars, f"scalars {scalars}")

    traces = sorted(os.listdir(cfg.GPU.PROFILE_DIR))
    check(len(traces) == 1, f"profiler traces {traces}")
    with open(os.path.join(cfg.GPU.PROFILE_DIR, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    hits = [e for e in events if "logmel_tc_kernel" in str(e.get("name", ""))]
    print(f"[tools] GPU.PROFILE_DIR: {traces[0]}, {len(events)} events, {len(hits)} of "
          f"logmel_tc_kernel (device time {sum(e.get('dur', 0) for e in hits):.1f} us)",
          flush=True)
    # One launch a traced step; a trace of ~1e5 events has held 1 or 2 of the 2
    # (a kernel of a step is lost at times; the same launches alone are all kept).
    check(1 <= len(hits) <= cfg.GPU.PROFILE_NUM_ITERS,
          f"the profiler trace holds {len(hits)} logmel_tc_kernel events for "
          f"{cfg.GPU.PROFILE_NUM_ITERS} traced steps of one launch each")
    return launches, cfg


def phase_tools(card: str, kernels: dict, loop_cfg, epic_ckpt: str, root: str) -> dict:
    """Phase 12: ``predict`` over whole files, ``main`` with the preparation,
    the observers and the profiler, ``stress_test`` and the spectrogram
    dumper's pathways; returns the launch counts of each path."""
    from scipy.io import wavfile

    from asf_tpu_torch.checkpoint import manager as cu
    from asf_tpu_torch.data.epickitchens import EpicKitchens
    from asf_tpu_torch.entry import epic_cfg, wide_window
    from asf_tpu_torch.tools.stress_test import stress_test
    from asf_tpu_torch.visualization.spectrograms import _item_pathways

    t0 = time.perf_counter()
    flush = torch.empty(FLUSH_BYTES // 4, device=TOOLS_DEVICE)
    video = os.path.join(root, "epic_audio", "P01_00.wav")
    vgg_ckpt = cu.get_last_checkpoint(loop_cfg.OUTPUT_DIR)
    paths = {}
    cfg = epic_cfg()
    # epic_cfg's head pools 400 // 8 // 4 = 12 slow and 400 // 4 = 100 fast
    # frames, not in the ratio ALPHA = 8: over a whole file the two pathways
    # pool to 62 and 60 windows and the head's concatenation raises, in both
    # packages. At 384 the pools are 12 and 96; the weights do not depend on it.
    cfg.AUDIO_DATA.NUM_FRAMES = PREDICT_EPIC_FRAMES
    cfg.TEST.CHECKPOINT_FILE_PATH = epic_ckpt
    cfg.OUTPUT_DIR = os.path.join(root, "predict_epic")
    paths["predict bf16"] = _predict_case(card, "bf16", cfg, video, kernels, flush)
    cfg.GPU.DSP_PRECISION = "HIGHEST"
    paths["predict float32"] = _predict_case(card, "float32", cfg, video, kernels, flush)
    short = os.path.join(root, "short.wav")
    wavfile.write(short, 24000, (np.random.default_rng(12).standard_normal(
        int(24000 * PREDICT_SHORT_SECS)) * 3000).astype(np.int16))
    vcfg = loop_cfg.clone()
    vcfg.TEST.CHECKPOINT_FILE_PATH = vgg_ckpt
    vcfg.OUTPUT_DIR = os.path.join(root, "predict_vgg")
    paths["predict short"] = _predict_case(card, "short flagship", vcfg, short, kernels, flush)
    wcfg = wide_window(vcfg.clone())
    wcfg.OUTPUT_DIR = os.path.join(root, "predict_wide")
    paths["predict wide"] = _predict_case(card, "wide", wcfg, video.replace("P01_00", "P01_01"),
                                          kernels, flush)
    del flush
    t_main = time.perf_counter()
    main_launches, main_cfg = phase_main(card, vgg_ckpt, root)
    paths["main"] = main_launches
    t_stress = time.perf_counter()
    rate = stress_test(STRESS_N, STRESS_SECS, device=TOOLS_DEVICE)
    print(f"[tools] stress_test n={STRESS_N}, {STRESS_SECS} s: {rate:.1f} TFLOP/s (bf16 "
          f"torch.matmul chains, the last interval) | {card}", flush=True)
    check(rate > 0, "stress_test gave no rate")

    item = EpicKitchens(main_cfg, "val")[0]
    torch.cuda.synchronize()
    zero_launches()
    got = _item_pathways(main_cfg, item, TOOLS_DEVICE)
    torch.cuda.synchronize()
    paths["spectrograms"] = read_launches()
    want = _item_pathways(main_cfg, item, "cpu")  # the plain bf16 front end
    errs = [np.abs(g - w) for g, w in zip(got, want)]
    max_err, mean_err = max(e.max() for e in errs), max(e.mean() for e in errs)
    print(f"[tools] the spectrogram dumper's _item_pathways: launches {paths['spectrograms']}, "
          f"shapes {[g.shape for g in got]}, max abs {max_err:.3g} mean {mean_err:.3g} from the "
          f"plain pipeline on the CPU (gated at {BF16_TOL})", flush=True)
    check(paths["spectrograms"] == {n: int(n == "logmel_bf16") for n in REPLACES},
          f"_item_pathways launches {paths['spectrograms']}")
    check(max_err <= BF16_TOL[0] and mean_err <= BF16_TOL[1],
          f"_item_pathways: max {max_err} mean {mean_err} > {BF16_TOL}")
    print(f"[smoke] phase 12: {t_main - t0:.1f} s for predict, {t_stress - t_main:.1f} s for "
          f"main, {time.perf_counter() - t_stress:.1f} s for stress_test and the dumper | {card}",
          flush=True)
    return paths


def main() -> None:
    t0 = time.perf_counter()
    card, sass = phase_device()
    kernels = phase_kernels(card)
    eval_launches, _ = phase_slice(card)
    train_launches, train_timing = phase_train(card)
    with tempfile.TemporaryDirectory() as root:
        loop_launches, loop_cfg, run1_losses = phase_train_cfg(
            card, train_timing["flagship"]["ms"], root)
        test_launches = phase_test_cfg(card, loop_cfg)
        epic_train_launches, epic_test_launches, epic_ckpt = phase_epic(
            card, loop_cfg, train_timing["flagship"]["ms"], root)
        gru_train_launches, gru_test_launches, gru_step = phase_gru(card, epic_ckpt, root)
        state_launches = phase_state(card, epic_ckpt, root, gru_step)
        t10 = time.perf_counter()
        resnet_launches = phase_resnet(card, loop_cfg)
        t_slide = time.perf_counter()
        slide_launches = phase_slide(card, epic_ckpt, root)
        print(f"[smoke] phase 10: {t_slide - t10:.1f} s for the two ResNets, "
              f"{time.perf_counter() - t_slide:.1f} s for the sliding windows", flush=True)
        t11 = time.perf_counter()
        bn_launches, _, plain_sync = phase_bn_types(card)
        t_ranks = time.perf_counter()
        rank_launches = phase_ranks(card, loop_cfg, run1_losses, plain_sync)
        print(f"[smoke] phase 11: {t_ranks - t11:.1f} s for the batch-norm types, "
              f"{time.perf_counter() - t_ranks:.1f} s across ranks", flush=True)
        tool_launches = phase_tools(card, kernels, loop_cfg, epic_ckpt, root)
    check_instructions(card, sass, kernels)
    paths = {"eval": eval_launches, **{f"train {k}": v for k, v in train_launches.items()},
             "train(cfg)": loop_launches, "test(cfg)": test_launches,
             "epic train(cfg)": epic_train_launches, "epic test(cfg)": epic_test_launches,
             "gru train(cfg)": gru_train_launches, "gru test(cfg)": gru_test_launches,
             **state_launches, **resnet_launches, "slide test(cfg)": slide_launches,
             **{f"train {k}": v for k, v in bn_launches.items()}, **rank_launches,
             **tool_launches}
    line = []
    for name, res in kernels.items():
        geometry, batch = LINE_BATCH[name]
        row = res["rows"][(geometry, batch)]
        line.append({
            "name": name, "route": "cuda", "source": "asf_tpu_torch/csrc/logmel.cu",
            "replaces": REPLACES[name],
            "launches": sum(counts[name] for counts in paths.values()),
            "max_abs_err": res["max_abs_err"], "ms": row["ms"], "cold_ms": row["cold_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
            "batch": batch, "support_taps": 2048 if geometry == "wide" else 256,
            "launches_by_path": {k: counts[name] for k, counts in paths.items()},
            **({"other_branch": row["other_branch"]} if "other_branch" in row else {}),
            "other_shapes": {
                f"{g} B={b}": {
                    k: r[k] for k in ("ms", "cold_ms", "plain_ms", "bound_ms", "max_abs_err")}
                for (g, b), r in res["rows"].items() if (g, b) != (geometry, batch)},
        })
    print(f"[smoke] {time.perf_counter() - t0:.1f} s in all", flush=True)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
