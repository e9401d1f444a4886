#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the repo root; needs one CUDA card

In order, failing (exit 1) on the first check that does not hold:
  1. requires CUDA and prints the card's name and power limit;
  2. builds the CUDA kernels from csrc/ (one nvcc per source, all started
     together) and prints the build time; prints, for each cluster kernel
     (B1, B2, B3), its cluster size C, the CTAs it launches, the clusters
     that fit on the card at once and its shared memory per CTA (checked
     against the wrappers' reckoning); drives predict at U=128 (the
     cluster kernels), U=24 (the cell's own scan: fault C1) and U=256
     (gaze_grcn's cell on B6, gaze_lstm's on its scan) and prints the
     routes;
  3. holds each kernel against its plain PyTorch version in bf16 under the
     JAX package's gate, and in f32 with TF32 off: the forward recurrence
     B1 (`convgru_parity`, T=42, 512->128), the backward kernels
     B2 `convgru_bwd` (`backward_parity`, the same shapes, on inputs from a
     real forward) at B=8, and B1 and B2 also at B=1 (one cluster: the
     streaming shape) and B=28 (two waves of clusters: the train batch);
     B4 `convgru_bwd_mono` (G + B2 + W) at B=8 and 16, and its phases G
     `convgru_bwd_gates` (against `recompute_gates`) and W `convgru_wgrad`
     (against `wgrad_plain`) at B=8, 16 and 28 (and at U=64 with the
     zoo: V2's backward, the train path, runs G, B2 and W); then the
     peephole ConvLSTM forward B3 (`convlstm_parity`, nonzero carries, the
     final c checked too) at B=8, 1 and 16 (two waves of clusters: the
     serving batch); then B5 `convgru_small`, the cascade's top cell
     (B=28, T=42, U=3, 5x5, 49x49, bf16, three seeds): ys against
     `forward_plain` within 1e-6 of its largest magnitude, each gradient
     against `backward_plain` by norm, the backward bitwise repeatable,
     and the plain versions with their sums rounded to bf16 (the control)
     refused; then B6 `convgru_grid`, the cascade's bottom cell (B=28,
     T=42, U=256, 3x3, 7x7, bf16, three seeds): ys, the final h and the
     whole backward (the recursion, then phase W) against `forward_plain`,
     `backward_plain` and `wgrad_plain` by norm, the backward bitwise
     repeatable, the control refused; then M1 `gemm_bf16`, the dense
     layers' bf16 products, at the cascade's fc1, fc2 and projection
     (three seeds): the forward, input and weight gradients against their
     plain versions by norm, the controls (the forward's sums in bf16, a
     one-term cotangent) refused;
  4. serves full-width gaze_grcn, then gaze_lstm (1024->512->128, T=42,
     49x49 maps, bf16, seeded random weights) over HTTP from a bundle:
     concurrent single-clip POSTs, each reply checked against a plain-scan
     predict of the same clip, and the kernels' launch counts over each run
     checked (B1 for gaze_grcn, B3 for gaze_lstm);
  4b. streams a 100-frame feature stream through both models in chunks of
     42 with the state carried (`streaming.stream_video` for gaze_grcn,
     `lstm_stream_step` for gaze_lstm): the maps match one plain pass over
     all 100 frames, each chunk launches its kernel once, and the second
     chunk differs from a zero-state restart;
  5. trains full-width gaze_grcn through the normal entry point
     (`cli.train_gaze`, B=28, T=42, bf16, synthetic corpus), its batches
     prefetched on the worker thread (the default): the loss is finite at
     every step and falls, B1 and B2 launch once per step, a checkpoint and
     metrics.jsonl are written, and the final test-split evaluation (one
     more B1 launch) writes finite `test/<metric>` rows; then the same 20
     steps with `--no_prefetch`, whose per-step losses must equal the
     prefetched run's (rel 1e-6), and both runs' CLI sec/batch;
  4c. the raw-video front: the C3D tower in bf16 against f32 (TF32 off) on
     16 clips; then the bundle's `fused` program of gaze_grcn and gaze_lstm
     served over HTTP at the JAX package's fused benchmark shape (F=160
     uint8 frames of 128x171, T=10): 8 concurrent POSTs, each reply against
     the plain path (bf16 tower, plain-scan predict), one launch of B1 / B3
     per batcher call;
  5b. trains gaze_lstm through `cli.train_gaze` (B=28, T=42, 20 steps, on
     the plain `ConvLSTM.scan`: no launches) and checks its gradients
     against plain autograd of `ConvLSTM.scan`; trains gaze_grcn from raw
     pixels through `cli.train_fused` (B=8, F=160, 20 steps with the tower
     frozen: the loss falls, B1 and B2 once per step; then 3 steps with
     `--finetune_c3d`: conv1a moves);
  5c. evaluation on the card: all seven saliency metrics through
     `metrics_torch.evaluate_batch` on 8192 frames of 49x49 against the same
     call on the CPU (max |delta| <= 1e-4, NaN at the same frames) and on
     256 frames against `metrics_np`, then timed beside the NumPy protocol;
     `train.fit` for 20 steps with an evaluation every 10 (two in-range
     `evaluation/<metric>` rows, B1 once per step and per evaluated
     batch); `cli.evaluate_gaze` on the gaze_grcn and gaze_lstm CLI runs
     (overall.txt, one scores.txt row per frame, one B1 / B3 launch, mean
     scores within 0.01 of the same evaluation through the plain scan);
  6. checks the train step's gradients at full width, through the
     kernels' backward, against plain autograd of `ConvGRU.scan` on one
     batch;
  9. the rest of the model zoo, each family at its registry
     width in bf16: the cluster lines of B1 and B2 at U=64 (C=4) and their
     gates at gaze_pupil_grcn's shapes (T=35, 32 -> 64) at B=7, 1 and 28
     (bf16, and f32 with TF32 off; B1's final h == ys[-1]); predict of
     gaze_rnn, gaze_rnn77, gaze_c3d_conv, gaze_framewise_shallownet,
     gaze_grcn_cascade, gaze_pupil_grcn and gaze_pupil_gru2 at their
     registry batch and T and at B=16 (finite, corr >= 0.999 vs f32 with
     TF32 off; B1 once per call for gaze_pupil_grcn, B5 and B6 once per
     call for gaze_grcn_cascade, no launch for the others); gaze_pupil_grcn
     and
     gaze_framewise_shallownet served over HTTP (8 concurrent POSTs vs the
     plain path; B1 once per batcher call / none); one fused predict of
     gaze_framewise_shallownet (B=8, F=160 uint8, the frame stream resized
     on the card, the tower skipped) vs the host-resized plain path;
     `cli.pretrain_shallownet` (20 steps,
     B=128), then `cli.train_gaze` 20 steps each of gaze_pupil_grcn (B1 and
     B2 once per step), gaze_grcn_cascade (B5 and B6 once each way per
     step; M1 8 times a step and 3 a test batch), gaze_rnn with
     `--shallownet_pretrain` (its frozen ShallowNet bitwise the file's
     after training) and gaze_framewise_shallownet (its ShallowNet moves),
     each loss falling; gaze_pupil_grcn's gradients through B1 + B2 vs
     plain autograd (and its pupil term), the cascade's with `remat_cells`
     on vs off (a no-op on its kernels) and through B6 vs the bottom
     cell's rematerialized scan (the peak memory of each); then
     times B1 and B2 at U=64
     beside their bounds, each family's predict at B=16 and train step at
     its registry batch, a ShallowNet pretraining step at B=128, the
     cascade's step without remat, and the two zoo HTTP latencies;
  10. the reference's research loop, on the runs of phase 5: prints which
     optional host packages import (h5py, Pillow, a video decoder) and
     the stages that run; extract_features' window loop over 4 seeded
     uint8 videos of 176 frames at 240x320 (11 windows each,
     --batch_windows 16, bf16) against the f32 tower (corr >= 0.999),
     windows/s, and, where a decoder imports, the CLI on an .avi;
     `cli.extract_map` of the gaze_grcn and gaze_lstm CLI runs over 8
     clips of 105..300 windows with 540 frame files each (so 105 maps
     per clip), batched at its defaults (T=105, B=4: two launches of B1 /
     B3; every saved map against the predict) and `--streaming`
     (one launch per 42-window chunk), the maps against the plain scan
     (corr >= 0.999, max_rel_delta <= 0.05; the batched ones summing to
     1), ms per clip; `cli.create_records` (synthetic, one B1 launch) and
     `cli.action_classification` (NN with the maps as attention, 200
     steps, the loss falling; SVM, 50 steps; mAP finite), ms per step;
     the attention re-extraction (the features move); where h5py and
     Pillow import, `cli.process_gazemap`, `cli.train_gaze --dataset crc`
     (4 steps, B1 and B2 per step) and `cli.evaluate_gaze --dataset crc`
     (both protocols) on a fake CRC layout;
  11. a port-only user's export: `cli.export_serving` of the gaze_grcn
     (with `--stream_chunk_len 42`) and gaze_lstm CLI runs of phase 5 with
     the tower's weights as a `--caffemodel` .npz, bf16 features and uint8
     video on the wire; each bundle loaded and served over HTTP (8
     concurrent predict POSTs and 8 fused POSTs at F=160 against the plain
     path, one B1 / B3 launch per batcher call), the HTTP median per
     program, and a profiler window over one more round of gaze_grcn's
     predict POSTs: its device idle share and top device operations;
  12. `cli.pretrain_shallownet --dataset salicon` on a SALICON tree laid
     out with Pillow (160 98x98 images, 49x49 maps, .npy fixations), 20
     steps at B=128: the loss falls;
  13. `cli.train_gaze --profile_steps 5` at B=28: a trace under
     {train_dir}/profile naming B1 and B2, its device idle share and top
     device operations;
  14. the FLOP counts of `utils/mfu.py` through the kernel route against
     the plain route (predict at B=16 and fused predict at B=8 equal; the
     train step at B=28 above it by V2's gate recompute and B2's dh0
     transposed conv; B1's share 14.57 GFLOP at B=8), and the MFU of each
     over its CUDA-event time;
  15. the int8 C3D tower (kernel Q1, `models/quant.py`), with weights
     under which activations survive all eight layers: calibrated on 8
     seeded windows; Q1 and Q1-pool against their plain versions layer by
     layer on one clip at the real shapes (bitwise); the tower through
     `quant.apply_int8` at 160 clips (the served fused predict's B=16,
     F=160: Q1 8 times, Q1-pool 4 times) against the plain int8 tower
     (corr >= 0.999, max_rel_delta <= 0.05) and the bf16 cuDNN tower (corr
     > 0.995, mean rel < 0.06); `cli.export_serving --int8 --calib_videos`
     of phase 5's gaze_grcn run on seeded .avi files, its `fused_int8`
     program served over HTTP (8 concurrent uint8 POSTs, each reply against
     the bundle's `fused` program at corr >= 0.98; Q1 8 and Q1-pool 4
     launches and B1 one per batcher call);
  16. the host-side interop: a TFRecord round trip, the native libraries'
     build status (`native: built` or `native: fallback (<reason>)`) and,
     where the JPEG decoder built, a frame folder through
     `load_frame_folder(backend="native")` within one step of PIL's;
  17. multi-rank on one card (`parallel_phase`): two ranks on cuda:0 over
     gloo (this script with `--parallel-rank R DIR`, one process each)
     take 3 sharded train steps of full-width gaze_grcn at a global B=28
     (SGD, flip and dropout off; each step's loss equal on both ranks and
     within rel 2e-3 of one process on the same batches, the params after
     them and their updates at corr >= 0.999 and max_rel <= 0.05; B1 and
     B2 once per step per rank),
     sharded predict of gaze_grcn and gaze_lstm at B=16 (corr >= 0.999, B1
     / B3 once per rank), the temporal fused predict of one F=160 video (5
     of its 10 windows through each rank's tower, corr >= 0.999 against
     fused predict) and the sharded evaluate of 8192 frames (every metric
     within 1e-5 of `evaluate_batch`); then `cli.train_gaze
     --data_parallel -1` under `torch.distributed.run --nproc_per_node 1`
     (NCCL, world 1): the same losses (rel 1e-6) as without the flag;
  7. times the kernels and their plain versions (B=8, B=16; B1 and B2 also
     at B=1 and 28, B3 also at B=1, in us per step beside the bound; B4's
     phases G and W also at B=28 and U=64, beside the cuDNN calls that
     compute the same functions, B4 beside its B2 launch and V2's backward
     on its library stages, and B4's device time by kernel from
     torch.profiler; V2's backward at B=28 on its library stages and on
     G + B2 + W in turns; B5 forward and backward at B=28 beside their
     bounds and plain versions, and the cascade's top cell through B5 and
     through the rematerialized scan in turns; B6 forward and backward
     recursion at B=28 beside their bounds and plain versions, the bottom
     cell through B6 and
     through the rematerialized scan and the cascade's predict through
     both, in turns; M1's three uses at fc1, fc2 and the projection beside
     their bounds, plain versions and cuBLAS's bf16 GEMM, and the route
     forward + backward beside the f32 cast chain it replaced), the
     feature-fed predict of both models (B=16) with a breakdown, the HTTP
     requests, the streaming chunk steps (B=1), and the train step (B=28)
     through the kernels, through V2 on its library stages and through
     plain autograd, in turns, with a breakdown; the
     gaze_lstm train step; the C3D tower NCDHW against channels-last-3d;
     the fused predict at B=8 and 16 with its stages, the fused train step
     (frozen, fine-tuned) and the fused HTTP latency; Q1 and Q1-pool layer
     by layer at 160 clips beside their bounds, plain versions, im2col +
     `torch._int_mm` (with its TOP/s) and the bf16 cuDNN conv, each Q1
     layer with its tile plan (route, box, BN, BK, stages, CTAs per SM);
     the int8 tower against the
     bf16 tower in turns; `fused_int8` against `fused` predict at B=8 and
     16 and the fused_int8 HTTP latency; the sharded train step per rank
     beside the one-process step, and the gradient all-reduce (phase 17);
     with CUDA events or the host clock after warm-up;
  8. prints the kernels' JSON line (B1-B4, B4's phases G and W, B1 and B2
     at U=64, Q1 and Q1-pool, B5 and B6), then,
     last, the device JSON line.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import os
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from recurrent_gaze_prediction_tpu_torch import native, registry
from recurrent_gaze_prediction_tpu_torch.action import (
    ActionClassifier, ActionHParams, iter_record_batches, read_record_shard)
from recurrent_gaze_prediction_tpu_torch.action.classification import (
    batch_to)
from recurrent_gaze_prediction_tpu_torch.action.classification import (
    make_train_step as action_train_step)
from recurrent_gaze_prediction_tpu_torch.bridge import c3d_params_to_jax
from recurrent_gaze_prediction_tpu_torch.cli import (
    action_classification, create_records, evaluate_gaze, export_serving,
    extract_features, extract_map, pretrain_shallownet, process_gazemap,
    train_fused, train_gaze)
from recurrent_gaze_prediction_tpu_torch.compat import tfrecord
from recurrent_gaze_prediction_tpu_torch.config import (
    ExperimentConfig, OptimizerConfig)
from recurrent_gaze_prediction_tpu_torch.data import codec, synthetic, video
from recurrent_gaze_prediction_tpu_torch.data.prefetch import (
    device_put_batch, stream_casts)
from recurrent_gaze_prediction_tpu_torch.eval import (
    evaluator, metrics_np, metrics_torch)
from recurrent_gaze_prediction_tpu_torch.models import c3d as c3d_model
from recurrent_gaze_prediction_tpu_torch.models import (pipeline, quant,
                                                        shallownet, streaming)
from recurrent_gaze_prediction_tpu_torch.models.common import (
    apply_c3d_projection, apply_decoder, sequence_loss)
from recurrent_gaze_prediction_tpu_torch.ops.cells import ConvGRU, ConvLSTM
from recurrent_gaze_prediction_tpu_torch.ops.kernels import build
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru as kconv
from recurrent_gaze_prediction_tpu_torch.ops.kernels import (
    convgru_grid as kg)
from recurrent_gaze_prediction_tpu_torch.ops.kernels import (
    convgru_small as ks)
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru_vjp as v1
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru_vjp2 as v2
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convlstm as klstm
from recurrent_gaze_prediction_tpu_torch.ops.kernels import conv3d_int8 as q1
from recurrent_gaze_prediction_tpu_torch.ops.kernels import gemm
from recurrent_gaze_prediction_tpu_torch.ops.kernels.parity import (
    MIN_CORR, backward_inputs, backward_kernel_and_plain, backward_parity,
    backward_parity_ok, convgru_parity, convlstm_parity, parity_ok)
from recurrent_gaze_prediction_tpu_torch.ops import layers
from recurrent_gaze_prediction_tpu_torch.ops.layers import resize_bilinear
from recurrent_gaze_prediction_tpu_torch.ops.normalize import (
    normalize_probability_map, softmax_2d)
from recurrent_gaze_prediction_tpu_torch.serving import (
    fused_int8_predict_fn, fused_predict_fn, load_bundle, save_bundle,
    server_from_bundle)
from recurrent_gaze_prediction_tpu_torch.train import (
    Checkpointer, create_train_state, fit, make_train_step)
from recurrent_gaze_prediction_tpu_torch.train import fused as fused_data
from recurrent_gaze_prediction_tpu_torch.train import (load_params,
                                                       profiler, saliency,
                                                       save_params)
from recurrent_gaze_prediction_tpu_torch.utils import (mfu, rank_envs,
                                                     run_processes, tf32_off)

SEED = 0
T = 42
N_REQUESTS = 8
TRAIN_BATCH = 28  # the reference's training batch (cli/train_gaze.py:135)
TRAIN_STEPS = 20
# B4 and its phases G and W: gated and timed at the flagship B=8 and the
# serving batch B=16; G and W also at the reference's training batch
B4_BATCHES = (8, 16)
GW_BATCHES = (8, 16, TRAIN_BATCH)
# what B4's timing lines print beside the kernel: the library calls that
# compute the same functions, and B4's share of B2
B4_EXTRA_TIMES = ("library_ms", "b2_in_b4_ms", "v2_backward_ms")
STREAM_FRAMES = 100  # a feature stream longer than two chunks
STREAM_CHUNK = 42    # the tail chunk (16 frames) is padded and trimmed
UNITS = 128
# f32 mode: the kernel's scalar f32 FMAs against cuDNN's f32 convs with
# TF32 off differ only in summation order (~1e-7 per step), amplified by
# the recurrence over 42 steps; 1e-3 leaves a wide margin above that and
# stays far below what a wrong gate or shift gives.
F32_MAX_REL_DELTA = 1e-3
# Served maps against the plain path: the kernel keeps its conv results in
# f32 where the plain path rounds them to bf16; the JAX package's gate.
MAP_MIN_CORR = 0.999
# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
STATE_STDDEV = 0.05  # the reference init (1e-4) leaves the recurrence ~0
# batches at which the cluster kernels B1 and B2 are gated and timed: the
# flagship B=8 first, then one cluster (B=1, streaming) and two waves of
# clusters (B=28, the train batch); timed also at B=16 (serving)
CLUSTER_BATCHES = (8, 1, 28)
CLUSTER_TIMED = (1, 8, 16, 28)
# the same for the cluster kernel B3, which serving (B=16) and streaming
# (B=1) run
LSTM_BATCHES = (8, 1, 16)
LSTM_TIMED = (1, 8, 16)
# Train-step gradients, kernels against plain autograd (bf16): the
# kernels keep conv results in f32 where the plain scan rounds them to
# bf16, so they agree to bf16 resolution, as the served maps do.
GRAD_MIN_CORR = 0.999
LOSS_MAX_REL = 1e-3
# the raw-video front at the JAX package's fused benchmark shape
# (BENCHMARKS.md: B=8 at F=160): 128x171 uint8 frames, T = 10
FUSED_FRAMES = 160
VIDEO_HW = (128, 171)
FUSED_BATCHES = (8, 16)   # fused predict timed at these
FUSED_TRAIN_BATCH = 8
FUSED_TRAIN_STEPS = 20
FINETUNE_STEPS = 3
# evaluation: the metrics on EVAL_FRAMES frames of 49x49 (an 8192-frame
# batch, the exact path's default chunk), NP_FRAMES of them held against
# metrics_np and NP_TIMED timed through it; card vs CPU within
# METRIC_CARD_MAX_ABS (f32, only the summation order differs)
EVAL_FRAMES = 8192
NP_FRAMES = 256
NP_TIMED = 32
METRIC_CARD_MAX_ABS = 1e-4
CADENCE = 10          # steps_per_evaluation of the cadence phase
# evaluate_gaze's mean scores through the kernel vs the plain scan: bf16
# maps that agree to corr >= 0.999 move a mean score by well under this
EVAL_MAX_ABS = 0.01
# per-step losses of the prefetched vs the inline trainer: the same batches
# and random draws, so only a nondeterministic library reduction could
# move them
PREFETCH_MAX_REL = 1e-6
# the rest of the model zoo: the seven families beside gaze_grcn,
# gaze_grcn77 and gaze_lstm, at their registry widths, T and batches
ZOO = ("gaze_rnn", "gaze_rnn77", "gaze_c3d_conv",
       "gaze_framewise_shallownet", "gaze_grcn_cascade", "gaze_pupil_grcn",
       "gaze_pupil_gru2")
ZOO_PREDICT_BATCH = 16
# gaze_pupil_grcn's ConvGRU: U=64 on clusters of 4 CTAs, T=35, its 1024->32
# projection feeding the input gates
C4_UNITS, C4_T, C4_C = 64, 35, 32
C4_BATCHES = (7, 1, 28)   # its registry batch, one cluster, two batches' worth
# the zoo's CLI runs take 20 steps at lr 3e-4: at the model classes' 3e-3
# the cascade's relu head dies within a few steps on the synthetic corpus
ZOO_LR = 3e-4
# cli.train_gaze's synthetic test split at its default 16 clips: max(16 //
# 2, 2); the final evaluation runs it in ceil(8 / B) batches, the last one
# padded
ZOO_TEST_CLIPS = 8
PRETRAIN_BATCH = 128
# the cascade with remat against without: the same forward, and gradients
# that differ only by the order of the recomputed steps' sums
REMAT_GRAD_MIN_CORR = 0.9999
REMAT_LOSS_MAX_REL = 1e-6
CELLS = ("cell", "bottom_cell", "top_cell")
# kernel B5, the cascade's top cell (5x5 state convs, U=3, 49x49), gated
# and timed at the cascade's train shape, on SMALL_SEEDS
SMALL_HW, SMALL_UNITS, SMALL_K = (49, 49), 3, 5
SMALL_SEEDS = (SEED, SEED + 1, SEED + 2)
SMALL_GRADS = ("dwx", "dh0", "dU_zr", "dU_c")
# B5's forward makes each conv's f32 sum in its plain version's order, so
# ys is held to the plain version's bits (the largest difference over the
# largest magnitude). Its backward sums in its own order; where that flips
# the bf16 rounding of a conv operand, the flip spreads through the
# remaining steps, so each gradient (dwx in bf16, as the wrapper returns
# it) is held by its norm, ||kernel - plain|| / ||plain||. Each limit lies
# between the largest sound reading and the smallest reading of the control
# (the plain versions with every conv's sum rounded to bf16), seeds 0-2 at
# B=28, T=42 on an H100: dwx 1.66e-3 / 2.95e-3, dh0 1.63e-3 / 2.66e-3,
# dU_zr 1.98e-3 / 3.48e-3, dU_c 1.69e-3 / 3.22e-3.
SMALL_FWD_MAX_REL = 1e-6
SMALL_BWD_L2_REL = {"dwx": 2.2e-3, "dh0": 2.1e-3, "dU_zr": 2.6e-3,
                    "dU_c": 2.4e-3}
# kernel B6, the cascade's bottom cell (3x3 state convs, U=256, 7x7), gated
# and timed at the cascade's train shape, on GRID_SEEDS
GRID_HW, GRID_UNITS, GRID_INPUT = (7, 7), 256, 512
GRID_SEEDS = (SEED, SEED + 1, SEED + 2)
GRID_READINGS = ("ys", "h_final", "dwx", "dh0", "dU_zr", "dU_c")
# B6 sums its mma products in another order than cuDNN's; where that flips
# a bf16 rounding of a conv operand the flip spreads through the remaining
# steps, so each reading is held by its norm, ||kernel - plain|| /
# ||plain|| (dwx in bf16, as the wrapper returns it). Each limit lies
# between the largest sound reading and the smallest of the control (the
# plain versions with every conv's sum rounded to bf16), seeds 0-2 at
# B=28, T=42 on an H100 (sound / control): ys 5.74e-4 / 1.017e-3, h_final
# 6.17e-4 / 1.032e-3, dwx 1.433e-3 / 1.988e-3, dh0 9.88e-4 / 1.673e-3,
# dU_zr 1.586e-3 / 2.765e-3, dU_c 1.298e-3 / 2.459e-3 (the -m cuda tests'
# GRID_TOL)
GRID_L2_REL = {"ys": 8e-4, "h_final": 8.5e-4, "dwx": 1.7e-3, "dh0": 1.3e-3,
               "dU_zr": 2.1e-3, "dU_c": 1.8e-3}
# kernel M1, the dense layers' bf16 products: (M, K, N, weight std) of the
# cascade's fc1 and fc2 over T*B = 1,176 frames and its projection over
# T*B*49 positions (the -m cuda tests' M1_SHAPES), on M1_SEEDS
M1_SHAPES = {"fc1": (T * TRAIN_BATCH, 7203, 4802, 0.02),
             "fc2": (T * TRAIN_BATCH, 2401, 4802, 0.02),
             "proj": (T * TRAIN_BATCH * 49, 1024, 512, 0.005)}
M1_USES = ("forward", "input_grad", "weight_grad")
M1_SEEDS = (SEED, SEED + 1, SEED + 2)
# M1 against its plain versions (the same bf16 values multiplied in f32 by
# cuBLAS, TF32 off; the terms summed smallest first) differs by summation
# order alone, so each use is held by its norm, ||kernel - plain|| /
# ||plain||. The limit (the -m cuda tests' against the plain versions at odd
# shapes) lies between the largest sound reading and the smallest of the
# controls (the forward's sums rounded to bf16; the gradients of the
# cotangent rounded to one bf16 term), seeds 0-2 on an H100: forward
# 3.83e-7 / 1.655e-3, input gradient 7.00e-7 / 1.654e-3, weight gradient
# 4.92e-7 / 1.611e-3
M1_L2_REL = 1e-5
# a cascade train step's M1 launches: the forwards of the projection, fc1
# and fc2, then fc1's and fc2's two gradients and the projection's weight
# gradient (its input, the features, takes none); a predict's: 3
M1_STEP_LAUNCHES, M1_PREDICT_LAUNCHES = 8, 3
# the research loop: extract_features over 4 seeded videos of 176 uint8
# frames (11 windows each) at 240x320; extract_map at its CLI defaults
# (T=105, B=4) over 8 clips of 105..300 windows, streamed in chunks of 42;
# the action classifier's NN head for 200 steps and SVM for 50; the CRC
# stages on 6 clips of 120 frames, 4 train steps
RESEARCH_VIDEOS, RESEARCH_FRAMES = 4, 176
RESEARCH_VIDEO_HW = (240, 320)
RESEARCH_BATCH_WINDOWS = 16
MAP_CLIPS, MAP_WINDOWS = 8, (105, 300)
MAP_T, MAP_BATCH = 105, 4
MAP_MAX_REL_DELTA = 0.05   # the JAX package's gate (ops/pallas/parity.py)
ACTION_NN_STEPS, ACTION_SVM_STEPS = 200, 50
CRC_CLIPS, CRC_FRAMES, CRC_STEPS = 6, 120, 4
# the int8 tower (slice 13): Q1 per layer on one clip's activations, the
# tower at the served fused predict's 160 clips (B=16, F=160), against the
# plain int8 tower (the JAX package's kernel gate) and the bf16 cuDNN
# tower (its accuracy gate, tests/test_quant.py); fused_int8 served over
# HTTP against the same bundle's fused program (its surface gate);
# calibration on CALIB_VIDEOS seeded .avi files of CALIB_FRAMES frames
INT8_CLIPS = 160
INT8_BF16_MIN_CORR, INT8_BF16_MAX_MEAN_REL = 0.995, 0.06
INT8_MAP_MIN_CORR = 0.98
# a cause that keeps Q1 from its plain version's bits may move at most
# this share of a layer's int8 outputs by at most one step
INT8_MAX_STEP, INT8_MAX_SHARE = 1, 1e-4
CALIB_VIDEOS, CALIB_FRAMES = 2, 64
INT8_CHUNK = 16   # clips per call of the float64 plain tower


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def corr(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


def post(url: str, frames: np.ndarray, c3d: np.ndarray) -> tuple:
    buf = io.BytesIO()
    np.savez(buf, frames=frames, c3d=c3d)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    start = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        status, body = resp.status, resp.read()
    seconds = time.perf_counter() - start
    return status, np.load(io.BytesIO(body))["gazemaps"], seconds


def post_all(url: str, frames: np.ndarray, c3d: np.ndarray) -> list:
    """POST clip i from thread i, all at once; (status, maps, s) each."""
    results: list = [None] * len(c3d)
    errors: list = []

    def one(i: int) -> None:
        try:
            results[i] = post(url, frames[i], c3d[i])
        except Exception as e:  # reported below; the run fails
            errors.append(f"request {i}: {e!r}")

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(c3d))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    check(not errors and all(r is not None for r in results),
          f"requests failed: {errors}")
    return results


def kernel_timing(fused: dict, b: int, rng: np.random.RandomState,
                  t: int = T) -> dict:
    """The kernel and its plain version on the same precomputed gates."""
    dev = torch.device("cuda")
    c = fused["Wx_zrc"].shape[2]
    units = fused["U_c"].shape[-1]
    xs = torch.from_numpy(
        rng.randn(t, b, 7, 7, c).astype(np.float32)).to(dev)
    h0 = ConvGRU.zero_state(b, (7, 7), units, device=dev)
    with torch.inference_mode():
        wx = ConvGRU.input_gates(fused, xs, torch.bfloat16)
        ms = cuda_ms(lambda: kconv.convgru_recurrence(fused, wx, h0), 20)
        plain_ms = cuda_ms(lambda: ConvGRU.scan_precomputed(
            fused, wx, h0, torch.bfloat16), 5)
    flops = t * b * 49 * 9 * units * 3 * units * 2
    nbytes = (wx.numel() * 2 + t * b * 49 * units * 4          # wx, ys
              + (fused["Uh_zr"].numel() + fused["U_c"].numel()) * 2
              + 2 * b * 49 * units * 4)                        # h0, hT
    return {"ms": ms, "plain_ms": plain_ms, **bound(flops, nbytes)}


def lstm_kernel_timing(fused: dict, b: int, rng: np.random.RandomState
                       ) -> dict:
    """Kernel B3 and its plain version on the same precomputed gates."""
    dev = torch.device("cuda")
    c = fused["Wx"].shape[2]
    units = fused["W_ci"].shape[-1]
    xs = torch.from_numpy(
        rng.randn(T, b, 7, 7, c).astype(np.float32)).to(dev)
    carry = ConvLSTM.zero_state(b, (7, 7), units, device=dev)
    with torch.inference_mode():
        gx = ConvLSTM.input_gates(fused, xs, torch.bfloat16)
        ms = cuda_ms(lambda: klstm.convlstm_recurrence(fused, gx, *carry), 20)
        plain_ms = cuda_ms(lambda: ConvLSTM.scan_precomputed(
            fused, gx, carry, torch.bfloat16), 5)
    flops = T * b * 49 * 9 * units * 4 * units * 2
    nbytes = (gx.numel() * 2 + T * b * 49 * units * 4          # gx, ys
              + fused["Wh"].numel() * 2 + 3 * 49 * units * 4   # Wh, peeps
              + 4 * b * 49 * units * 4)                        # c0 h0 cT hT
    return {"ms": ms, "plain_ms": plain_ms, **bound(flops, nbytes)}


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes (each input read once, each output
    written once) over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6}


# ------------------------------------------------------------ kernel B5

def small_inputs(seed: int) -> tuple:
    """B5's inputs at the cascade's train shape (T=42, B=28) on the card:
    weights whose state convs reach O(1) (std 0.2), wx ~ N(0, 1) in bf16,
    h0 ~ N(0, 0.25), a cotangent ~ N(0, 1)."""
    rng = np.random.RandomState(seed)

    def f32(*shape, std=1.0):
        return torch.from_numpy((rng.randn(*shape) * std).astype(
            np.float32)).cuda()

    k, u = SMALL_K, SMALL_UNITS
    return (f32(k, k, u, 2 * u, std=0.2), f32(k, k, u, u, std=0.2),
            f32(T, TRAIN_BATCH, *SMALL_HW, 3 * u).to(torch.bfloat16),
            f32(TRAIN_BATCH, *SMALL_HW, u, std=0.5),
            f32(T, TRAIN_BATCH, *SMALL_HW, u))


def l2_rel(a: np.ndarray, b: np.ndarray) -> float:
    """||a - b|| / ||b||."""
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@contextlib.contextmanager
def bf16_sums():
    """B5's plain versions with every conv's sum (the state convs, the
    transposed convs, the weight products) rounded to bf16: the control
    that B5's gates must refuse."""
    conv, wgrad = ks.state_conv, ks.weight_grad
    ks.state_conv = lambda *a: conv(*a).to(torch.bfloat16).float()
    ks.weight_grad = lambda *a: wgrad(*a).to(torch.bfloat16).float()
    try:
        yield
    finally:
        ks.state_conv, ks.weight_grad = conv, wgrad


def small_readings(ys, grads, want_ys, want) -> dict:
    """ys by its largest difference, each gradient (dwx in wx's dtype, as
    the wrapper returns it) by its norm, against the plain versions'."""
    def host(x):
        return x.float().cpu().numpy().astype(np.float64)

    return {"ys": max_rel(host(ys), host(want_ys)),
            **{n: l2_rel(host(a), host(w))
               for n, a, w in zip(SMALL_GRADS, grads, want)}}


def small_kernel_gates(card: str) -> dict:
    """Kernel B5 at the cascade's top cell and train shape (B=28, T=42,
    U=3, 5x5, 49x49, bf16) on each of SMALL_SEEDS: the forward against
    `forward_plain` within SMALL_FWD_MAX_REL, the backward (on the
    kernel's ys) against `backward_plain`, each gradient within its
    SMALL_BWD_L2_REL; a second backward bitwise the first; the control
    (`bf16_sums`) outside the forward's limit and some gradient's."""
    out = {"max_abs_err": 0.0}
    for seed in SMALL_SEEDS:
        uzr, uc, wx, h0, g = small_inputs(seed)
        with torch.no_grad():
            ys = ks.recurrence(uzr, uc, wx, h0)
            got = ks.recurrence_bwd(uzr, uc, wx, h0, ys, g)
            again = ks.recurrence_bwd(uzr, uc, wx, h0, ys, g)
            want_ys = ks.forward_plain(uzr, uc, wx, h0)
            want = ks.backward_plain(uzr, uc, wx, h0, ys, g)
            with bf16_sums():
                ctl_ys = ks.forward_plain(uzr, uc, wx, h0)
                ctl = ks.backward_plain(uzr, uc, wx, h0, ys, g)
        torch.cuda.synchronize()
        want = (want[0].to(wx.dtype), *want[1:])
        sound = small_readings(ys, got, want_ys, want)
        control = small_readings(ctl_ys, (ctl[0].to(wx.dtype), *ctl[1:]),
                                 want_ys, want)
        repeatable = all(torch.equal(a, b) for a, b in zip(got, again))
        out["max_abs_err"] = max(
            [out["max_abs_err"], float((ys - want_ys).abs().max())]
            + [float((a.float() - w.float()).abs().max())
               for a, w in zip(got, want)])
        print(f"parity convgru_small (B5) bf16 B={TRAIN_BATCH} T={T} U="
              f"{SMALL_UNITS} {SMALL_K}x{SMALL_K} {SMALL_HW} seed {seed}: "
              f"ys max_rel, gradients l2_rel {json.dumps(sound)}; control "
              f"(sums rounded to bf16) {json.dumps(control)}; backward "
              f"bitwise repeatable {repeatable} [{card}]", flush=True)
        check(sound["ys"] <= SMALL_FWD_MAX_REL,
              f"B5 forward seed {seed}: max_rel {sound['ys']}")
        for n in SMALL_GRADS:
            check(sound[n] <= SMALL_BWD_L2_REL[n],
                  f"B5 backward seed {seed}: {n} l2_rel {sound[n]}")
        check(repeatable, f"B5 backward seed {seed} not bitwise repeatable")
        check(control["ys"] > SMALL_FWD_MAX_REL
              and any(control[n] > SMALL_BWD_L2_REL[n]
                      for n in SMALL_GRADS),
              f"B5's gates pass the control (bf16 sums) at seed {seed}: "
              f"{control}")
        out[seed] = {"sound": sound, "control": control}
    return out


def in_turns(fns: dict, iters: int = 3) -> dict:
    """Host ms a call of each of two functions, in turns (a, b, b, a),
    each call ending in a synchronize."""
    a, b = fns
    turns = {a: [], b: []}
    for name in (a, b, b, a):
        fns[name]()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(iters):
            fns[name]()
        torch.cuda.synchronize()
        turns[name].append((time.perf_counter() - start) * 1e3 / iters)
    return turns


def small_kernel_timing(card: str) -> dict:
    """B5 at the cascade's train shape: each launch by CUDA events beside
    its bound and its plain version; then the top cell's whole recurrence,
    forward + backward with its input conv, through B5 and through the
    rematerialized `ConvGRU.scan` it replaces, in turns, on the host's
    clock (ms a pass)."""
    uzr, uc, wx, h0, g = small_inputs(SEED + 3)
    t, b, k, u = T, TRAIN_BATCH, SMALL_K, SMALL_UNITS
    hw = SMALL_HW[0] * SMALL_HW[1]
    flops = ks.flops(t, b, *SMALL_HW, k, u)
    with torch.no_grad():
        ys = ks.recurrence(uzr, uc, wx, h0)
        out = {
            "fwd": {"ms": cuda_ms(lambda: ks.recurrence(uzr, uc, wx, h0),
                                  20),
                    "plain_ms": cuda_ms(lambda: ks.forward_plain(
                        uzr, uc, wx, h0), 3, warmup=1),
                    # wx and h0 read, ys written
                    **bound(flops, t * b * hw * (3 * u * 2 + u * 4)
                            + b * hw * u * 4)},
            "bwd": {"ms": cuda_ms(lambda: ks.recurrence_bwd(
                uzr, uc, wx, h0, ys, g), 20),
                    "plain_ms": cuda_ms(lambda: ks.backward_plain(
                        uzr, uc, wx, h0, ys, g), 3, warmup=1),
                    # wx, ys, g and h0 read, dwx and dh0 written
                    **bound(3 * flops, t * b * hw * (2 * 3 * u * 2
                                                     + 2 * u * 4)
                            + 2 * b * hw * u * 4)}}
    rng = np.random.RandomState(SEED + 4)
    params = {n: torch.from_numpy((rng.randn(*v.shape) * 0.1).astype(
        np.float32)).cuda().requires_grad_()
        for n, v in ConvGRU.init(64, u, kernel=(k, k)).items()}
    xs = torch.from_numpy(rng.randn(t, b, *SMALL_HW, 64).astype(
        np.float32)).to("cuda", torch.bfloat16).requires_grad_()
    zero = torch.zeros(b, *SMALL_HW, u, device="cuda")

    def cell(scan, **kw):
        _, gs = scan(params, xs, zero, compute_dtype=torch.bfloat16, **kw)
        torch.autograd.grad((gs * g).sum(), [*params.values(), xs])

    turns = out["cell_fwd_bwd_host_ms"] = in_turns({
        "remat scan": lambda: cell(ConvGRU.scan, remat=True),
        "B5": lambda: cell(ks.convgru_scan_small)})
    for d in ("fwd", "bwd"):
        x = out[d]
        print(f"timing: convgru_small (B5) {d} T={t} B={b} U={u} {k}x{k} "
              f"{SMALL_HW} bf16: {x['ms']:.4f} ms, plain "
              f"{x['plain_ms']:.3f} ms, bound {x['bound_ms']:.4f} ms "
              f"({x['bound_by']}: {x['gflop']:.2f} GFLOP, "
              f"{x['mbytes']:.1f} MB) [{card}]", flush=True)
    print(f"timing: the cascade's top cell forward + backward with its "
          f"input conv, T={t} B={b}, in turns (host ms a pass): "
          f"{json.dumps(turns)} [{card}]", flush=True)
    return out


# ------------------------------------------------------------ kernel B6

def grid_inputs(seed: int) -> tuple:
    """B6's inputs at the cascade's bottom cell's train shape (T=42, B=28,
    U=256, 7x7): weights whose state convs reach O(1) (std 0.03 over 2,304
    taps), wx ~ N(0, 1) in bf16, h0 ~ N(0, 0.25), a cotangent ~ N(0, 1)."""
    rng = np.random.RandomState(seed)

    def f32(*shape, std=1.0):
        return torch.from_numpy((rng.randn(*shape) * std).astype(
            np.float32)).cuda()

    u = GRID_UNITS
    return (f32(3, 3, u, 2 * u, std=0.03), f32(3, 3, u, u, std=0.03),
            f32(T, TRAIN_BATCH, *GRID_HW, 3 * u).to(torch.bfloat16),
            f32(TRAIN_BATCH, *GRID_HW, u, std=0.5),
            f32(T, TRAIN_BATCH, *GRID_HW, u))


@contextlib.contextmanager
def grid_bf16_sums():
    """B6's plain versions with every conv's sum (the state convs, the
    transposed convs, phase W's weight products) rounded to bf16: the
    control that B6's gates must refuse."""
    conv, conv_t, wgrad = kg.conv3x3, kg.conv3x3_transpose, v1.kernel_grad
    kg.conv3x3 = lambda *a: conv(*a).to(torch.bfloat16).float()
    kg.conv3x3_transpose = lambda *a: conv_t(*a).to(torch.bfloat16).float()
    v1.kernel_grad = lambda *a: wgrad(*a).to(torch.bfloat16).float()
    try:
        yield
    finally:
        kg.conv3x3, kg.conv3x3_transpose, v1.kernel_grad = conv, conv_t, wgrad


def grid_plain_backward(uzr, uc, wx, h0, ys, gates, g) -> tuple:
    """B6's whole backward in its plain versions on the given ys and
    gates: the recursion, then phase W's plain weight products -> (dwx in
    wx's dtype, dh0, dU_zr, dU_c)."""
    units = uc.shape[-1]
    dwx, dh0 = kg.backward_plain(uzr, uc, h0, ys, gates, g, wx.dtype)
    hprev = kconv.hprev_of(h0, ys)
    duzr, duc = v1.wgrad_plain(hprev, dwx[..., :2 * units], gates[1] * hprev,
                               dwx[..., 2 * units:], wx.dtype)
    return dwx.to(wx.dtype), dh0, duzr, duc


def grid_readings(ys, grads, want_ys, want) -> dict:
    """Each of GRID_READINGS by its norm against the plain versions'."""
    def host(x):
        return x.float().cpu().numpy().astype(np.float64)

    return {"ys": l2_rel(host(ys), host(want_ys)),
            "h_final": l2_rel(host(ys[-1]), host(want_ys[-1])),
            **{n: l2_rel(host(a), host(w))
               for n, a, w in zip(GRID_READINGS[2:], grads, want)}}


def grid_kernel_gates(card: str) -> dict:
    """Kernel B6 at the cascade's bottom cell and train shape (B=28, T=42,
    U=256, 3x3, 7x7, bf16) on each of GRID_SEEDS: the forward (ys, the
    final h) against `forward_plain`, the whole backward (the recursion,
    then phase W) on the kernel's ys and gates against `backward_plain`
    and `wgrad_plain`, each reading within its GRID_L2_REL; a second
    backward bitwise the first; the control (`grid_bf16_sums`) outside the
    forward's limits and some gradient's."""
    out = {"max_abs_err": 0.0}
    for seed in GRID_SEEDS:
        uzr, uc, wx, h0, g = grid_inputs(seed)
        with torch.no_grad():
            ys, gates = kg.recurrence(uzr, uc, wx, h0, True)
            got = kg.backward(uzr, uc, wx, h0, ys, gates, g)
            again = kg.backward(uzr, uc, wx, h0, ys, gates, g)
            want_ys, _ = kg.forward_plain(uzr, uc, wx, h0)
            want = grid_plain_backward(uzr, uc, wx, h0, ys, gates, g)
            with grid_bf16_sums():
                ctl_ys, _ = kg.forward_plain(uzr, uc, wx, h0)
                ctl = grid_plain_backward(uzr, uc, wx, h0, ys, gates, g)
        torch.cuda.synchronize()
        sound = grid_readings(ys, got, want_ys, want)
        control = grid_readings(ctl_ys, ctl, want_ys, want)
        repeatable = all(torch.equal(a, b) for a, b in zip(got, again))
        out["max_abs_err"] = max(
            [out["max_abs_err"], float((ys - want_ys).abs().max())]
            + [float((a.float() - w.float()).abs().max())
               for a, w in zip(got, want)])
        print(f"parity convgru_grid (B6) bf16 B={TRAIN_BATCH} T={T} U="
              f"{GRID_UNITS} 3x3 {GRID_HW} seed {seed}: l2_rel "
              f"{json.dumps(sound)}; control (sums rounded to bf16) "
              f"{json.dumps(control)}; backward bitwise repeatable "
              f"{repeatable} [{card}]", flush=True)
        for n in GRID_READINGS:
            check(sound[n] <= GRID_L2_REL[n],
                  f"B6 seed {seed}: {n} l2_rel {sound[n]}")
        check(repeatable, f"B6 backward seed {seed} not bitwise repeatable")
        check(control["ys"] > GRID_L2_REL["ys"]
              and control["h_final"] > GRID_L2_REL["h_final"]
              and any(control[n] > GRID_L2_REL[n]
                      for n in GRID_READINGS[2:]),
              f"B6's gates pass the control (bf16 sums) at seed {seed}: "
              f"{control}")
        out[seed] = {"sound": sound, "control": control}
    return out


def grid_kernel_timing(card: str) -> dict:
    """B6 at the cascade's train shape: the forward (with the gates a
    backward reads) and the backward's recursion by CUDA events beside
    their bound and plain versions, the whole backward (the recursion and
    phase W); the bottom cell's whole recurrence,
    forward + backward with its input conv, through B6 and through the
    rematerialized `ConvGRU.scan` it replaces, and the cascade's predict
    at B=16 through both, in turns (host ms a pass)."""
    uzr, uc, wx, h0, g = grid_inputs(SEED + 5)
    t, b, u = T, TRAIN_BATCH, GRID_UNITS
    hw = GRID_HW[0] * GRID_HW[1]
    flops = kg.flops(t, b, *GRID_HW, u)
    state = t * b * hw * u * 4  # one f32 [T,B,H,W,U] stream
    with torch.no_grad():
        ys, gates = kg.recurrence(uzr, uc, wx, h0, True)
        out = {
            "fwd": {"ms": cuda_ms(lambda: kg.recurrence(uzr, uc, wx, h0,
                                                        True), 20),
                    "plain_ms": cuda_ms(lambda: kg.forward_plain(
                        uzr, uc, wx, h0, True), 3, warmup=1),
                    # wx and h0 read; ys and the three gates written
                    **bound(flops, t * b * hw * 3 * u * 2 + 4 * state
                            + b * hw * u * 4)},
            "bwd": {"ms": cuda_ms(lambda: kg.recurrence_bwd(
                uzr, uc, wx, h0, ys, gates, g), 20),
                    "plain_ms": cuda_ms(lambda: kg.backward_plain(
                        uzr, uc, h0, ys, gates, g, torch.bfloat16), 3,
                        warmup=1),
                    # the gates, ys and g read; dwx and dh0 written
                    **bound(flops, 5 * state + t * b * hw * 3 * u * 2
                            + 2 * b * hw * u * 4)},
            "bwd_with_wgrad_ms": cuda_ms(lambda: kg.backward(
                uzr, uc, wx, h0, ys, gates, g), 10)}
    rng = np.random.RandomState(SEED + 6)
    params = {n: torch.from_numpy((rng.randn(*v.shape) * 0.02).astype(
        np.float32)).cuda().requires_grad_()
        for n, v in ConvGRU.init(GRID_INPUT, u).items()}
    xs = torch.from_numpy(rng.randn(t, b, *GRID_HW, GRID_INPUT).astype(
        np.float32)).to("cuda", torch.bfloat16).requires_grad_()
    zero = torch.zeros(b, *GRID_HW, u, device="cuda")

    def cell(scan, **kw):
        _, gs = scan(params, xs, zero, compute_dtype=torch.bfloat16, **kw)
        torch.autograd.grad((gs * g).sum(), [*params.values(), xs])

    out["cell_fwd_bwd_host_ms"] = in_turns({
        "remat scan": lambda: cell(ConvGRU.scan, remat=True),
        "B6": lambda: cell(kg.convgru_scan_grid)})
    model = zoo_model("gaze_grcn_cascade")
    _, c3d = zoo_inputs(model, ZOO_PREDICT_BATCH, SEED + 23)
    with torch.inference_mode():
        out["cascade_predict_host_ms"] = in_turns({
            "scan": lambda: plain_predict_cascade(model, c3d),
            "B6": lambda: model.predict(None, c3d)})
    del model
    for d in ("fwd", "bwd"):
        x = out[d]
        print(f"timing: convgru_grid (B6) {d} T={t} B={b} U={u} 3x3 "
              f"{GRID_HW} bf16: {x['ms']:.4f} ms ({x['ms'] * 1e3 / t:.1f} "
              f"us a step), plain {x['plain_ms']:.3f} ms, bound "
              f"{x['bound_ms']:.4f} ms ({x['bound_by']}: {x['gflop']:.1f} "
              f"GFLOP, {x['mbytes']:.1f} MB) [{card}]", flush=True)
    print(f"timing: convgru_grid (B6) whole backward (recursion + phase W) "
          f"{out['bwd_with_wgrad_ms']:.4f} ms [{card}]", flush=True)
    print(f"timing: the cascade's bottom cell forward + backward with its "
          f"input conv, T={t} B={b}, in turns (host ms a pass): "
          f"{json.dumps(out['cell_fwd_bwd_host_ms'])}; the cascade's predict "
          f"B={ZOO_PREDICT_BATCH} T={t}: "
          f"{json.dumps(out['cascade_predict_host_ms'])} [{card}]",
          flush=True)
    return out


# ------------------------------------------------------------ kernel M1

def m1_operands(name: str, seed: int) -> tuple:
    """M1's operands at one of M1_SHAPES on the card, as the layer's
    product takes them: the input (the projection's relu(N(0, 1)) * 10
    features; the top cell's states in (-1, 1) for fc1; relu'd
    activations for fc2) and weight rounded to bf16 and zero-padded to 8
    elements a row, an f32 cotangent, and the true (K, N)."""
    m, k, n, std = M1_SHAPES[name]
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(m, k, generator=g, device="cuda")
    a = {"proj": lambda v: v.relu() * 10, "fc1": torch.tanh,
         "fc2": torch.relu}[name](a)
    w = torch.randn(k, n, generator=g, device="cuda") * std
    cot = torch.randn(m, n, generator=g, device="cuda") * 1e-4
    ap = layers._padded(a, m, layers._up(k))
    wp = layers._padded(w, layers._up(k), layers._up(n))
    return ap, wp, cot, k, n


def m1_use(use: str, ap, wp, terms, k: int, n: int, plain: bool = False
           ) -> torch.Tensor:
    """One of M1_USES on the given operands (its plain version with
    `plain`)."""
    if use == "forward":
        return (gemm.forward_plain if plain else gemm.forward)(ap, wp, n)
    if use == "input_grad":
        return (gemm.input_grad_plain if plain else gemm.input_grad)(
            terms, wp, k)
    return (gemm.weight_grad_plain if plain else gemm.weight_grad)(
        ap, terms, k, n)


def m1_kernel_gates(card: str) -> dict:
    """Kernel M1 at the cascade's fc1, fc2 and projection shapes on each of
    M1_SEEDS: the forward, input gradient and weight gradient against their
    plain versions (TF32 off) within M1_L2_REL by norm; the controls (the
    forward's sums rounded to bf16, the gradients of the cotangent rounded
    to one bf16 term) outside it."""
    out = {"max_abs_err": 0.0}
    for name in M1_SHAPES:
        for seed in M1_SEEDS:
            ap, wp, cot, k, n = m1_operands(name, seed)
            terms = layers.split_bf16(cot, wp.shape[1])
            single = layers.split_bf16(cot.bfloat16().float(), wp.shape[1])
            with torch.no_grad(), tf32_off():
                got = {u: m1_use(u, ap, wp, terms, k, n) for u in M1_USES}
                want = {u: m1_use(u, ap, wp, terms, k, n, plain=True)
                        for u in M1_USES}
                ctl = {u: m1_use(u, ap, wp, single, k, n) for u in M1_USES}
                ctl["forward"] = got["forward"].bfloat16().float()
            torch.cuda.synchronize()
            sound = {u: l2_rel(got[u].double().cpu().numpy(),
                               want[u].double().cpu().numpy())
                     for u in M1_USES}
            control = {u: l2_rel(ctl[u].double().cpu().numpy(),
                                 want[u].double().cpu().numpy())
                       for u in M1_USES}
            out["max_abs_err"] = max(
                [out["max_abs_err"]]
                + [float((got[u] - want[u]).abs().max()) for u in M1_USES])
            print(f"parity gemm_bf16 (M1) {name} {tuple(M1_SHAPES[name][:3])}"
                  f" seed {seed}: l2_rel {json.dumps(sound)}; control "
                  f"(forward sums in bf16, one-term cotangent) "
                  f"{json.dumps(control)} [{card}]", flush=True)
            for u in M1_USES:
                check(sound[u] <= M1_L2_REL,
                      f"M1 {name} seed {seed}: {u} l2_rel {sound[u]}")
                check(control[u] > M1_L2_REL,
                      f"M1's gate passes the control at {name} seed {seed}: "
                      f"{u} {control[u]}")
            out[name, seed] = {"sound": sound, "control": control}
    return out


def m1_kernel_timing(card: str) -> dict:
    """M1 at each of M1_SHAPES by CUDA events: each use beside its bound,
    its plain version (f32 cuBLAS on f32 copies, TF32 off) and cuBLAS's
    bf16 GEMM with an f32 result (`torch.mm(out_dtype=)`; for a gradient
    the three terms stacked, before their sum); then the route,
    `matmul_f32` in bf16 forward + backward, against the f32 cast chain
    it replaced."""
    f32 = torch.float32
    out = {}
    for name in M1_SHAPES:
        m = M1_SHAPES[name][0]
        ap, wp, cot, k, n = m1_operands(name, SEED + 7)
        terms = layers.split_bf16(cot, wp.shape[1])
        kp, np_ = wp.shape
        products = 2 * m * k * n
        library = {
            "forward": lambda: torch.mm(ap, wp, out_dtype=f32),
            "input_grad": lambda: torch.mm(terms.view(-1, np_), wp.t(),
                                           out_dtype=f32),
            "weight_grad": lambda: torch.mm(ap.t(), terms.view(m, -1),
                                            out_dtype=f32)}
        # each operand read once, the f32 result written once
        nbytes = {"forward": (m * kp + kp * np_) * 2 + m * n * 4,
                  "input_grad": (3 * m * np_ + kp * np_) * 2 + m * k * 4,
                  "weight_grad": (m * kp + 3 * m * np_) * 2 + k * n * 4}
        row = {}
        with torch.no_grad(), tf32_off():
            for u in M1_USES:
                row[u] = {
                    "ms": cuda_ms(lambda: m1_use(u, ap, wp, terms, k, n),
                                  20),
                    "plain_ms": cuda_ms(lambda: m1_use(
                        u, ap, wp, terms, k, n, plain=True), 5),
                    "library_ms": cuda_ms(library[u], 20),
                    **bound(products * (1 if u == "forward" else 3),
                            nbytes[u])}
        a = ap[:, :k].float().requires_grad_(name != "proj")
        w = wp[:k, :n].float().requires_grad_()
        wanted = [a, w] if name != "proj" else [w]

        def route(fn):
            torch.autograd.grad(fn(), wanted, cot)

        with tf32_off():
            row["route_ms"] = cuda_ms(lambda: route(
                lambda: layers.matmul_f32(a, w, torch.bfloat16)), 10)
            row["f32_route_ms"] = cuda_ms(lambda: route(
                lambda: torch.matmul(a.bfloat16().float(),
                                     w.bfloat16().float())), 5)
        out[name] = row
        print(f"timing: gemm_bf16 (M1) {name} {m} x {k} -> {n} bf16, f32 "
              f"sums: " + "; ".join(
                  f"{u} {row[u]['ms']:.4f} ms ("
                  f"{row[u]['gflop'] / row[u]['ms']:.0f} TFLOP/s), plain {row[u]['plain_ms']:.3f}, cuBLAS bf16 "
                  f"{row[u]['library_ms']:.4f}, bound {row[u]['bound_ms']:.4f}"
                  f" ({row[u]['bound_by']}: {row[u]['gflop']:.1f} GFLOP, "
                  f"{row[u]['mbytes']:.1f} MB)" for u in M1_USES)
              + f"; the route forward + backward {row['route_ms']:.3f} ms, "
              f"the f32 cast chain {row['f32_route_ms']:.3f} ms [{card}]",
              flush=True)
    return out


def plain_predict_cascade(model, c3d):
    """The cascade's predict with its bottom cell on its own scan."""
    with plain_route(model):
        return model.predict(None, c3d)


def cluster_lines(card: str, units: int = UNITS,
                  names: tuple = ("convgru_fwd", "convgru_bwd",
                                  "convlstm_fwd"),
                  batches: tuple = CLUSTER_TIMED) -> dict:
    """For each cluster kernel: its cluster size, CTAs, the clusters that
    fit on the card at once (cudaOccupancyMaxActiveClusters) and shared
    memory per CTA, each checked against what the wrapper reckons."""
    lib = build.load()
    clusters = kconv.cluster_size(units)
    reckoners = {"convgru_fwd": kconv.smem_bytes,
                 "convgru_bwd": v2.smem_bytes,
                 "convlstm_fwd": klstm.smem_bytes}
    out = {}
    for name in names:
        reckon = reckoners[name]
        info = {}
        for dtype, elem in (("bf16", 2), ("f32", 4)):
            smem = getattr(lib, f"{name}_smem_bytes")(7, 7, units, elem)
            fit = getattr(lib, f"{name}_max_clusters")(7, 7, units, elem)
            check(smem == reckon(7, 7, units, elem),
                  f"{name} {dtype}: the kernel needs {smem} B per CTA, the "
                  f"wrapper reckons {reckon(7, 7, units, elem)}")
            check(fit >= 1, f"{name} {dtype}: no cluster fits ({fit})")
            info[dtype] = {"smem_per_cta": smem, "max_active_clusters": fit}
        print(f"cluster {name} U={units} 7x7: C={clusters}, CTAs at B="
              f"{'/'.join(map(str, batches))}: "
              f"{'/'.join(str(b * clusters) for b in batches)}, "
              f"{json.dumps(info)} [{card}]", flush=True)
        out[name] = info
    return out


def per_step(k: dict, t: int = T) -> str:
    """A timing's ms with its us per step, beside the bound's."""
    return (f"{k['ms']:.4f} ms ({k['ms'] * 1e3 / t:.2f} us/step), plain "
            f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_ms'] * 1e3 / t:.3f} us/step, {k['bound_by']}: "
            f"{k['gflop']:.2f} GFLOP, {k['mbytes']:.1f} MB)")


def library_b4_calls(x: dict) -> dict:
    """The PyTorch calls that compute B4's phases, on B4's inputs `x`
    (`backward_inputs`, bf16), as zero-argument functions: the two cuDNN
    convs of phase G and the two cuDNN weight-gradient convs of phase W
    (bf16, NCHW views of the channels-last streams), and V2's backward
    (library stage 1, B2, library stage 3): yardsticks, used nowhere in
    the port."""
    cdt = torch.bfloat16
    t, b, _, _, units = x["ys"].shape
    frames = t * b

    def nchw(a):  # [T,B,H,W,C] -> [T*B,C,H,W] (channels-last strides)
        return a.reshape(frames, *a.shape[2:]).to(cdt).permute(0, 3, 1, 2)

    def oihw(w):  # [3,3,I,O] -> [O,I,3,3]
        return w.to(cdt).permute(3, 2, 0, 1).contiguous()

    h, rh = nchw(x["hprev"]), nchw(x["rh"])
    uzr, uc = oihw(x["uzr"]), oihw(x["uc"])
    dzr, da, _ = v2.dh_bwd(x["u"], x["r"], x["c"], x["hprev"], x["g"],
                           x["uzr"], x["uc"], cdt)
    dzr, da = nchw(dzr), nchw(da)
    conv, wgrad = torch.nn.functional.conv2d, torch.nn.grad.conv2d_weight

    def v2_backward():
        return v1.convgru_bwd_phased(
            x["uzr"], x["uc"], x["wx"], x["ys"], x["h0"], x["g"],
            gates=v1.recompute_gates, recursion=v2.dh_bwd,
            tail=v1.wgrad_plain)

    return {
        "convgru_bwd_gates": lambda: (conv(h, uzr, padding=1),
                                      conv(rh, uc, padding=1)),
        "convgru_wgrad": lambda: (wgrad(h, uzr.shape, dzr, padding=1),
                                  wgrad(rh, uc.shape, da, padding=1)),
        "v2_backward": v2_backward,
    }


def backward_timing(kernel: str, b: int, seed: int, t: int = T,
                    c: int = 512, units: int = UNITS) -> dict:
    """A backward kernel and its plain version on the same inputs from a
    real forward (bf16; T=42, 512->128 unless given); for B4's phases also
    the library calls that compute the same function (`library_ms`), for
    B4 its B2 launch on phase G's outputs (`b2_in_b4_ms`) and V2's
    backward (`v2_backward_ms`)."""
    x = backward_inputs(t, b, c, units, torch.bfloat16, seed, "cuda")
    run_kernel, run_plain, _ = backward_kernel_and_plain(kernel, x)
    extra = {}
    with torch.no_grad():
        ms = cuda_ms(run_kernel, 10)
        plain_ms = cuda_ms(run_plain, 3)
        library = library_b4_calls(x) if kernel != "convgru_bwd" else {}
        if kernel in library:
            extra["library_ms"] = cuda_ms(library[kernel], 10)
        if kernel == "convgru_bwd_mono":
            u, r, cand, hprev, _ = v1.bwd_gates(x["uzr"], x["uc"], x["wx"],
                                                x["h0"], x["ys"])
            extra["b2_in_b4_ms"] = cuda_ms(lambda: v2.dh_bwd(
                u, r, cand, hprev, x["g"], x["uzr"], x["uc"],
                torch.bfloat16), 10)
            extra["v2_backward_ms"] = cuda_ms(library["v2_backward"], 10)
    convs = t * b * 49 * 9 * 3 * units * units * 2  # one set of state convs
    stream = t * b * 49 * units * 4                 # one f32 [T,B,7,7,U]
    state = b * 49 * units * 4                      # h0 or dh0
    weights = (x["uzr"].numel() + x["uc"].numel()) * 2
    dweights = 9 * units * 3 * units * 4            # dU_zr, dU_c in f32
    if kernel == "convgru_bwd":
        # two transposed convs; u, r, c, h_prev, g in, dzr (2U), da out
        flops, nbytes = convs, 8 * stream + weights + state
    elif kernel == "convgru_bwd_gates":
        # both gate convs; wx (bf16), ys, h0 in; u, r, c, h_prev, r*h out
        flops = convs
        nbytes = x["wx"].numel() * 2 + stream + state + weights + 5 * stream
    elif kernel == "convgru_wgrad":
        # both weight gradients; h_prev, r*h, da, dzr (2U) in
        flops, nbytes = convs, 5 * stream + dweights
    else:
        # recompute, transposed convs and weight grads; wx (bf16), ys, g,
        # h0 in, dwx (3U), dh0, dU_zr, dU_c out
        flops = 3 * convs
        nbytes = (x["wx"].numel() * 2 + 2 * stream + 3 * stream + 2 * state
                  + weights + dweights)
    return {"ms": ms, "plain_ms": plain_ms, **extra, **bound(flops, nbytes)}


# kernels of a B4 call by the name the profiler gives them
B4_PARTS = (("gates_wgmma", "G"), ("convgru_bwd_kernel", "B2"),
            ("wgrad_wgmma", "W"), ("wgrad_reduce", "W slice sum"))


def b4_breakdown(b: int, calls: int = 5) -> tuple[dict, dict]:
    """Device time of one B4 call by kernel (torch.profiler over `calls`
    calls after warm-up, ms per call): G, B2, W, W's slice sum, and the
    rest (weight packing, the dwx concatenation); and the launches of all
    the calls, warm-up included: each call of B4's wrapper launches G, B2
    and W once."""
    x = backward_inputs(T, b, 512, UNITS, torch.bfloat16, SEED + b, "cuda")
    args = (x["uzr"], x["uc"], x["wx"], x["ys"], x["h0"], x["g"])
    reset_launches()
    with torch.no_grad():
        for _ in range(2):
            v1.convgru_bwd(*args)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                v1.convgru_bwd(*args)
            torch.cuda.synchronize()
    out = {label: 0.0 for _, label in B4_PARTS}
    out["other"] = 0.0
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total", None)
        if us is None:
            us = event.self_cuda_time_total
        label = next((lbl for key, lbl in B4_PARTS if key in event.key),
                     "other")
        out[label] += us / 1e3 / calls
    check(all(out[label] > 0 for _, label in B4_PARTS),
          f"B4's profile at B={b} misses a kernel: {out}")
    launches = read_launches()
    check(launches == {"convgru_fwd": 0, **v2_backwards(2 + calls),
                       "convgru_bwd_mono": 2 + calls, "convlstm_fwd": 0,
                       **cascade_launches()},
          f"launches over {2 + calls} calls of B4's wrapper: {launches}")
    return out, launches


@contextlib.contextmanager
def v2_stages(route: str):
    """V2's backward (`ConvGRUFused`'s) through its kernels (phase G, B2,
    phase W: the port's route) or, as a yardstick, through its library
    stages (cuDNN convs for G, matmuls for W: `recompute_gates`,
    `wgrad_plain`), for the span of the block."""
    saved = (v1.bwd_gates, v1.wgrad)
    if route == "library":
        v1.bwd_gates, v1.wgrad = v1.recompute_gates, v1.wgrad_plain
    try:
        yield
    finally:
        v1.bwd_gates, v1.wgrad = saved


@contextlib.contextmanager
def plain_route(model, plain: bool = True):
    """With `plain`, the model's recurrence on its cell's own scan (plain
    autograd in training: the reference the kernels are held against) for
    the span of the block."""
    if plain:
        model.recurrence_route = lambda train: "scan"
    try:
        yield
    finally:
        if plain:
            del model.recurrence_route


def v2_route_timing(b: int) -> dict:
    """V2's backward (`convgru_bwd_phased` as `ConvGRUFused` calls it) at
    T=42, U=128 in bf16 through its library stages and through G + B2 + W,
    in turns (library, kernels, kernels, library)."""
    x = backward_inputs(T, b, 512, UNITS, torch.bfloat16, SEED + b, "cuda")
    args = (x["uzr"], x["uc"], x["wx"], x["ys"], x["h0"], x["g"])
    runs = {"library": [], "kernels": []}
    with torch.no_grad():
        for label in ("library", "kernels", "kernels", "library"):
            with v2_stages(label):
                runs[label].append(cuda_ms(lambda: v1.convgru_bwd_phased(
                    *args, gates=v1.bwd_gates, recursion=v2.dh_bwd,
                    tail=v1.wgrad), 10))
    return {"library_ms": statistics.mean(runs["library"]),
            "kernels_ms": statistics.mean(runs["kernels"]), "runs": runs}


def plain_logits(model, c3d: torch.Tensor) -> torch.Tensor:
    """gaze_grcn's or gaze_lstm's logits with the recurrence run by the
    plain `ConvGRU.scan` / `ConvLSTM.scan` (bf16 compute, no dropout): the
    reference the served and streamed maps are held against."""
    cdt = torch.bfloat16
    b, t = c3d.shape[:2]
    stage = dict(keep_prob=1.0, generator=None, train=False,
                 compute_dtype=cdt)
    lstm = model.cfg.name == "gaze_lstm"
    cell = ConvLSTM if lstm else ConvGRU
    with torch.no_grad():
        xs = apply_c3d_projection(model.c3d_proj, c3d, **stage).transpose(
            0, 1)
        state0 = cell.zero_state(b, (7, 7), UNITS, device=c3d.device)
        _, ys = cell.scan(model.cell, xs, state0, compute_dtype=cdt)
        folded = ys.transpose(0, 1).reshape(b * t, 7, 7, UNITS)
        return apply_decoder(model.decoder, folded, **stage).reshape(
            b, t, 49, 49)


def plain_predict(model, c3d: torch.Tensor) -> torch.Tensor:
    return softmax_2d(plain_logits(model, c3d))


def full_width_model(name: str = "gaze_grcn"):
    """gaze_grcn or gaze_lstm at the registry's full width, bf16, seeded
    random weights with the recurrent cell's weights at N(0,
    STATE_STDDEV)."""
    gen = torch.Generator().manual_seed(SEED)
    model = registry.create_model(
        name, dim_feature=1024, dim_cnn_proj=512,
        rnn_state_size=UNITS, n_lstm_steps=T, gazemap_height=49,
        gazemap_width=49, compute_dtype="bfloat16", device="cuda",
        generator=gen)
    with torch.no_grad():
        for p in model.cell.values():
            p.copy_(torch.randn(p.shape, generator=gen) * STATE_STDDEV)
    return model


def reset_launches() -> None:
    kconv.launches = v2.launches = v1.launches = klstm.launches = 0
    v1.gates_launches = v1.wgrad_launches = 0
    q1.launches = q1.pool_launches = 0
    ks.launches = ks.bwd_launches = 0
    kg.launches = kg.bwd_launches = 0
    gemm.launches = 0


def read_int8_launches() -> dict:
    torch.cuda.synchronize()
    return {"conv3d_int8": q1.launches, "maxpool3d_int8": q1.pool_launches}


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {"convgru_fwd": kconv.launches, "convgru_bwd": v2.launches,
            "convgru_bwd_mono": v1.launches,
            "convgru_bwd_gates": v1.gates_launches,
            "convgru_wgrad": v1.wgrad_launches,
            "convlstm_fwd": klstm.launches,
            "convgru_small_fwd": ks.launches - ks.bwd_launches,
            "convgru_small_bwd": ks.bwd_launches,
            "convgru_grid_fwd": kg.launches - kg.bwd_launches,
            "convgru_grid_bwd": kg.bwd_launches}


def cascade_launches(fwd: int = 0, bwd: int = 0) -> dict:
    """The launches of the cascade's two cell kernels, B5 (the top cell)
    and B6 (the bottom cell): `fwd` forwards and `bwd` backwards of each
    (each of B6's backwards also runs phase W, `convgru_wgrad`, which the
    callers count)."""
    return {"convgru_small_fwd": fwd, "convgru_small_bwd": bwd,
            "convgru_grid_fwd": fwd, "convgru_grid_bwd": bwd}


def v2_backwards(n: int) -> dict:
    """The launches of n train backwards (`ConvGRUFused`'s, V2's split):
    phase G, B2 and phase W once each."""
    return {"convgru_bwd_gates": n, "convgru_bwd": n, "convgru_wgrad": n}


# the forward kernel each served or streamed model runs
FORWARD_KERNEL = {"gaze_grcn": "convgru_fwd", "gaze_lstm": "convlstm_fwd"}


def serve_and_check(model, frames: np.ndarray, c3d: np.ndarray,
                    card: str, bundle: str = None,
                    profile_dir: str = None) -> dict:
    """Serve `model` over HTTP from a bundle it writes (or from `bundle`,
    `model`'s export); POST every clip at once and check each reply
    against a plain-scan predict of the same clip, and that the model's
    forward kernel, and no other, launched once per batcher call. Then
    POST them again for the latency; with `profile_dir`, once more inside
    a profiler trace written there."""
    name = model.cfg.name
    kernel = FORWARD_KERNEL[name]
    with tempfile.TemporaryDirectory() as tmp:
        if bundle is None:
            bundle = f"{tmp}/bundle"
            save_bundle(bundle, model)
        server = server_from_bundle(bundle, device="cuda",
                                    max_batch=32, max_wait_ms=50.0).start()
        try:
            host, port = server.address
            url = f"http://{host}:{port}"
            reset_launches()
            served = post_all(f"{url}/predict", frames, c3d)
            launches = read_launches()
            with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
                health = json.loads(r.read())
            print(f"serving {name}: {len(c3d)} concurrent requests, healthz "
                  f"{health}, kernel launches {launches}", flush=True)
            check(launches[kernel] >= 1, f"serving {name} never launched "
                                         f"{kernel}")
            check(health["requests"] == len(c3d)
                  and launches[kernel] == health["calls"]
                  and sum(launches.values()) == launches[kernel],
                  f"serving {name}: healthz {health} does not count the "
                  f"{len(c3d)} requests / {kernel} launches {launches}")

            reference = load_bundle(bundle, device="cuda")
            plain = plain_predict(reference, torch.from_numpy(c3d).cuda())
            plain = plain.cpu().numpy()
            for i, (status, maps, _) in enumerate(served):
                check(status == 200, f"{name} request {i}: HTTP {status}")
                check(maps.shape == (T, 49, 49),
                      f"{name} request {i}: gazemaps shape {maps.shape}")
                check(bool(np.isfinite(maps).all()),
                      f"{name} request {i}: non-finite maps")
                sums = maps.reshape(T, -1).sum(-1)
                check(bool(np.abs(sums - 1.0).max() <= 1e-3),
                      f"{name} request {i}: map sums off 1 by "
                      f"{np.abs(sums - 1.0).max()}")
                c = corr(maps, plain[i])
                check(c >= MAP_MIN_CORR,
                      f"{name} request {i}: corr {c} vs the plain path")
            min_corr = min(corr(m, plain[i])
                           for i, (_, m, _) in enumerate(served))
            print(f"serving {name}: all {len(c3d)} replies HTTP 200, "
                  f"[{T},49,49] finite, sums 1 within 1e-3, min corr vs "
                  f"plain path {min_corr:.6f} [{card}]", flush=True)

            again = post_all(f"{url}/predict", frames, c3d)
            http_ms = statistics.median(s for _, _, s in again) * 1e3
            if profile_dir is not None:
                with profiler.trace(profile_dir):
                    post_all(f"{url}/predict", frames, c3d)
                    torch.cuda.synchronize()
        finally:
            server.close()
    return {"launches": launches, "http_ms": http_ms, "min_corr": min_corr}


def stream_fns(model):
    """The model's streaming step and a function giving its zero state at
    B=1 on the model's device."""
    lstm = model.cfg.name == "gaze_lstm"
    init = (streaming.init_lstm_stream_state if lstm
            else streaming.init_stream_state)
    dev = next(model.parameters()).device
    return ((streaming.lstm_stream_step if lstm
             else streaming.grcn_stream_step),
            lambda: init(1, model.cfg, device=dev))


def stream_chunks(model, feats: np.ndarray, restart: bool = False) -> list:
    """The feature stream [F,1024,7,7] in chunks of STREAM_CHUNK through
    the model's streaming step, as a user drives it: gaze_grcn through
    `stream_video`; gaze_lstm through `lstm_stream_step` with the tail
    chunk zero-padded and trimmed. `restart` starts every chunk from the
    zero state (the reference's behaviour)."""
    if model.cfg.name == "gaze_grcn" and not restart:
        return list(streaming.stream_video(model, feats,
                                           chunk_len=STREAM_CHUNK))
    step, init = stream_fns(model)
    state = init()
    out = []
    for start in range(0, len(feats), STREAM_CHUNK):
        chunk = feats[start:start + STREAM_CHUNK]
        valid = len(chunk)
        chunk = np.concatenate([chunk, np.zeros(
            (STREAM_CHUNK - valid,) + chunk.shape[1:], np.float32)])
        new_state, maps = step(model, state,
                               torch.from_numpy(chunk[None]).cuda())
        state = init() if restart else new_state
        out.append(maps[0, :valid].cpu().numpy())
    return out


def stream_and_check(name: str, feats: np.ndarray, card: str) -> dict:
    """Stream `feats` through full-width `name` with the state carried;
    hold the maps against one plain pass over all the frames, count the
    kernel's launches, and show that context flows across chunks."""
    model = full_width_model(name)
    kernel = FORWARD_KERNEL[name]
    n_chunks = -(-len(feats) // STREAM_CHUNK)
    reset_launches()
    chunks = stream_chunks(model, feats)
    launches = read_launches()
    streamed = np.concatenate(chunks)
    full = plain_logits(model, torch.from_numpy(feats[None]).cuda())
    full = full[0].cpu().numpy()
    restarted = np.concatenate(stream_chunks(model, feats, restart=True))
    c = corr(streamed, full)
    second = slice(STREAM_CHUNK, 2 * STREAM_CHUNK)
    context = float(np.abs(streamed[second] - restarted[second]).max()
                    / np.abs(streamed[second]).max())
    print(f"streaming {name}: {len(feats)} frames in chunks of "
          f"{STREAM_CHUNK} -> {[len(x) for x in chunks]}, corr vs one plain "
          f"pass {c:.6f}, launches {launches}, second chunk vs zero-state "
          f"restart max rel delta {context:.4g} [{card}]", flush=True)
    check(streamed.shape == (len(feats), 49, 49)
          and bool(np.isfinite(streamed).all()),
          f"streaming {name}: maps {streamed.shape}, finite "
          f"{bool(np.isfinite(streamed).all())}")
    check(c >= MAP_MIN_CORR, f"streaming {name}: corr {c} vs one pass")
    check(launches[kernel] == n_chunks
          and sum(launches.values()) == n_chunks,
          f"streaming {name}: launches {launches}, want {n_chunks} of "
          f"{kernel}")
    check(context > 1e-3, f"streaming {name}: the second chunk equals a "
                          f"zero-state restart (max rel delta {context})")
    return {"model": model, "launches": launches, "corr": c}


def stream_timing(model) -> float:
    """ms per STREAM_CHUNK-frame chunk of the model's streaming step at
    B=1, the state carried from a real chunk."""
    step, init = stream_fns(model)
    chunk = torch.from_numpy(np.random.RandomState(SEED + 7).randn(
        1, STREAM_CHUNK, 1024, 7, 7).astype(np.float32)).cuda()
    state, _ = step(model, init(), chunk)
    return cuda_ms(lambda: step(model, state, chunk), 10)


def train_through_cli(card: str, run: str, prefetch: bool = True) -> dict:
    """The feature-fed trainer: `cli.train_gaze` at full width on the card,
    the reference's batch, the loss read back at every step, the batches
    prefetched on the worker thread (the default) or copied inline
    (`--no_prefetch`); then the final test-split evaluation (28 clips, one
    batch). CLI sec/batch is read from metrics.jsonl's host clock over
    steps 6..20 (past the warm-up)."""
    argv = ["--dataset", "synthetic", "--batch_size", str(TRAIN_BATCH),
            "--synthetic_clips", str(2 * TRAIN_BATCH), "--n_lstm_steps",
            str(T), "--compute_dtype", "bfloat16", "--max_steps",
            str(TRAIN_STEPS), "--steps_per_logprint", "1", "--seed",
            str(SEED), "--train_dir", run]
    label = "prefetch" if prefetch else "inline (--no_prefetch)"
    reset_launches()
    start = time.perf_counter()
    rc = train_gaze.main(argv + ([] if prefetch else ["--no_prefetch"]))
    launches = read_launches()
    seconds = time.perf_counter() - start
    check(rc == 0, f"cli.train_gaze ({label}) returned {rc}")
    with open(f"{run}/metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    saved = Checkpointer(run).steps()
    train = [r for r in records if "loss/train" in r]
    tests = [r for r in records if "test/cc" in r]
    losses = [r["loss/train"] for r in train]
    sec_per_batch = (train[-1]["time"] - train[4]["time"]) / (len(train) - 5)
    print(f"train (cli.train_gaze, {label}, B={TRAIN_BATCH}, T={T}, bf16, "
          f"{TRAIN_STEPS} steps, {seconds:.1f} s wall with data and model "
          f"set-up, {sec_per_batch:.4f} CLI sec/batch over steps 6..20): "
          f"losses {[round(x, 4) for x in losses]}, launches {launches}, "
          f"checkpoints {saved}, test split {json.dumps(tests)} [{card}]",
          flush=True)
    check([r["step"] for r in train] == list(range(1, TRAIN_STEPS + 1)),
          f"metrics.jsonl steps {[r['step'] for r in train]}")
    check(all(np.isfinite(losses)), f"non-finite train loss: {losses}")
    check(statistics.mean(losses[-5:]) < losses[0],
          f"loss did not fall: first {losses[0]}, mean of the last 5 "
          f"{statistics.mean(losses[-5:])}")
    # B1 once per step and once for the test split's batch, B2 per step
    check(launches == {"convgru_fwd": TRAIN_STEPS + 1,
                       **v2_backwards(TRAIN_STEPS), "convgru_bwd_mono": 0,
                       "convlstm_fwd": 0, **cascade_launches()},
          f"launches over {TRAIN_STEPS} train steps and the test split: "
          f"{launches}")
    check(saved == [TRAIN_STEPS], f"checkpoints written: {saved}")
    check(len(tests) == 1 and tests[0]["step"] == TRAIN_STEPS
          and all(np.isfinite(tests[0][f"test/{m}"])
                  for m in metrics_torch.AVAILABLE_METRICS),
          f"test-split evaluation records: {tests}")
    return {"launches": launches, "losses": losses,
            "sec_per_batch": sec_per_batch, "test": tests[0]}


def prefetch_check(prefetched: dict, inline: dict, card: str) -> dict:
    """The prefetched and the inline trainer took the same steps: equal
    per-step losses (rel 1e-6)."""
    a, b = prefetched["losses"], inline["losses"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    print(f"prefetch vs --no_prefetch: per-step losses max rel delta "
          f"{rel:.3g}, bitwise equal {a == b}; CLI sec/batch "
          f"{prefetched['sec_per_batch']:.4f} (prefetch) vs "
          f"{inline['sec_per_batch']:.4f} (inline) [{card}]", flush=True)
    check(len(a) == len(b) == TRAIN_STEPS and rel <= PREFETCH_MAX_REL,
          f"prefetched losses {a} vs inline {b} (max rel {rel})")
    return {"max_rel": rel, "bitwise": a == b}


def eval_maps(n: int, seed: int) -> tuple:
    """n frames of 49x49: gaussian gt maps, 3-12 fixations near each gt
    peak, and predictions that are noisy gt as a rank map (values 1/2401
    apart, so AUC_Judd's 1e-7 jitter decides nothing); frame 0 has no
    fixation and frame 1 a constant prediction (the NaN cases). Also the
    other map, the union of frames 2..11's fixations."""
    rng = np.random.RandomState(seed)
    cy, cx = (rng.rand(2, n, 1, 1) * 33 + 8)
    ys, xs = np.arange(49)[None, :, None], np.arange(49)[None, None, :]
    gt = (np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * 5.0 ** 2))
          + 1e-4).astype(np.float32)
    fix = np.zeros((n, 49, 49), np.float32)
    k = rng.randint(3, 13, n)
    iy = np.clip(np.round(cy[:, :, 0] + rng.randn(n, 12) * 4), 0, 48)
    ix = np.clip(np.round(cx[:, :, 0] + rng.randn(n, 12) * 4), 0, 48)
    for i in range(1, n):
        fix[i, iy[i, :k[i]].astype(int), ix[i, :k[i]].astype(int)] = 1.0
    noisy = (gt + 0.3 * rng.rand(n, 49, 49)).reshape(n, -1)
    pred = (np.argsort(np.argsort(noisy, -1), -1) / 2401.0).astype(
        np.float32).reshape(n, 49, 49)
    pred[1] = 0.5
    return pred, gt, fix, (fix[2:12] > 0).sum(0)


def metrics_phase(card: str) -> dict:
    """The batched metrics on the card: all seven through `evaluate_batch`
    (exact) on EVAL_FRAMES frames against the same call on the CPU in f32;
    256 frames against the port's `metrics_np`; then `evaluate_batch`
    timed with CUDA events and the NumPy protocol per frame on the host."""
    pred, gt, fix, other = eval_maps(EVAL_FRAMES, SEED + 21)
    metrics = metrics_torch.ALL_METRICS
    host = [torch.from_numpy(x) for x in (pred, gt, fix)]
    card_in = [x.cuda() for x in host]
    other_t = torch.from_numpy(other)

    def run(inputs, other_map):
        dev = inputs[0].device
        return metrics_torch.evaluate_batch(
            *inputs, torch.Generator(device=dev).manual_seed(0),
            metrics=metrics, other_map=other_map)

    on_card = {m: v.cpu().numpy() for m, v in
               run(card_in, other_t.cuda()).items()}
    on_cpu = {m: v.numpy() for m, v in run(host, other_t).items()}
    deltas = {}
    for m in metrics:
        a, b = on_card[m], on_cpu[m]
        check(a.shape == (EVAL_FRAMES,) and bool(
            (np.isnan(a) == np.isnan(b)).all()),
              f"metric {m}: shape {a.shape}, NaN frames differ card vs CPU")
        # frame 1 is constant: its AUC_Judd is the jitter's coin toss
        keep = ~np.isnan(a)
        if m == "AUC_Judd":
            keep[1] = False
        deltas[m] = float(np.abs(a[keep] - b[keep]).max())
    nan_frames = {m: np.flatnonzero(np.isnan(on_card[m])).tolist()
                  for m in metrics}
    means = {m: float(np.nanmean(v)) for m, v in on_card.items()}
    print(f"metrics on the card vs the CPU (evaluate_batch exact, "
          f"{EVAL_FRAMES} frames of 49x49, f32): max |delta| "
          f"{json.dumps(deltas)}; NaN frames {json.dumps(nan_frames)}; "
          f"means {json.dumps(means)} [{card}]", flush=True)
    check(all(d <= METRIC_CARD_MAX_ABS for d in deltas.values()),
          f"metrics card vs CPU: {deltas}")
    check(nan_frames["cc"] == [1] and nan_frames["nss"] == [0]
          and nan_frames["AUC_Judd"] == [0],
          f"NaN conventions: {nan_frames}")

    worst = {}
    for m in ("cc", "sim", "nss", "kld", "AUC_Judd"):
        ref = np.array([metrics_np.saliency_score_single(
            m, pred[i], gt[i], fix[i], rng=np.random.RandomState(0))
            for i in range(2, 2 + NP_FRAMES)])
        got = on_card[m][2:2 + NP_FRAMES]
        tol = (dict(rtol=0, atol=2e-3) if m == "AUC_Judd"
               else dict(rtol=1e-3, atol=1e-4))
        ok = np.allclose(got, ref, **tol)
        worst[m] = float(np.abs(got - ref).max())
        check(ok, f"metric {m} on the card vs metrics_np: max |delta| "
                  f"{worst[m]} ({tol})")
    print(f"metrics on the card vs metrics_np ({NP_FRAMES} frames): max "
          f"|delta| {json.dumps(worst)} [{card}]", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    other_card = other_t.cuda()
    ms = cuda_ms(lambda: metrics_torch.evaluate_batch(
        *card_in, gen, metrics=metrics, other_map=other_card), 5)
    nbytes = sum(x.numel() * x.element_size() for x in card_in)
    rng = np.random.RandomState(0)
    start = time.perf_counter()
    for i in range(NP_TIMED):
        for m in metrics:
            metrics_np.saliency_score_single(m, pred[i], gt[i], fix[i],
                                             other_map_union=other, rng=rng)
    np_ms = (time.perf_counter() - start) * 1e3 / NP_TIMED
    print(f"timing: evaluate_batch, all 7 metrics (exact), {EVAL_FRAMES} "
          f"frames of 49x49 f32 on the card: {ms:.3f} ms "
          f"({EVAL_FRAMES / ms * 1e3:.0f} frames/s; bytes bound "
          f"{nbytes / PEAK_BYTES * 1e3:.4f} ms for {nbytes / 1e6:.1f} MB of "
          f"maps); NumPy protocol (metrics_np, the same 7 metrics, n_rep "
          f"100) {np_ms:.3f} ms per frame on the host [{card}]", flush=True)
    return {"deltas": deltas, "golden": worst, "ms": ms, "np_ms": np_ms}


def evaluation_cadence(card: str) -> dict:
    """`train.fit` at full width (B=28, T=42, bf16) for TRAIN_STEPS steps
    with the evaluation cadence every 10 steps on a 28-clip valid split:
    two `evaluation/<metric>` rows, each in range, and B1 launched once per
    step and once per evaluated batch."""
    model = full_width_model()
    model.cfg.batch_size = TRAIN_BATCH
    exp = ExperimentConfig()
    exp.model = model.cfg
    exp.seed = SEED
    exp.schedule.max_steps = TRAIN_STEPS
    exp.schedule.steps_per_evaluation = CADENCE
    data = synthetic.make_splits(n_train=TRAIN_BATCH, n_valid=TRAIN_BATCH,
                                 n_test=2, t=T, seed=SEED + 4)
    state, tx = create_train_state(model, exp.optimizer)
    rows = []
    reset_launches()
    fit(model, state, tx, data, exp,
        metric_writer=lambda step, values: rows.append((step, values)))
    launches = read_launches()
    evals = [(step, {k.split("/", 1)[1]: v for k, v in values.items()})
             for step, values in rows
             if any(k.startswith("evaluation/") for k in values)]
    print(f"evaluation cadence (train.fit, {TRAIN_STEPS} steps, every "
          f"{CADENCE}): {json.dumps(evals)}, launches {launches} [{card}]",
          flush=True)
    n_evals = TRAIN_STEPS // CADENCE
    check([s for s, _ in evals] == [CADENCE * (i + 1) for i in range(n_evals)],
          f"evaluation rows at steps {[s for s, _ in evals]}")
    for step, scores in evals:
        check(set(scores) == set(metrics_torch.AVAILABLE_METRICS)
              and all(np.isfinite(v) for v in scores.values())
              and all(0 <= scores[m] <= 1
                      for m in ("sim", "AUC_Borji", "AUC_shuffled"))
              and -1 <= scores["cc"] <= 1,
              f"evaluation scores at step {step}: {scores}")
    check(launches == {"convgru_fwd": TRAIN_STEPS + n_evals,
                       **v2_backwards(TRAIN_STEPS), "convgru_bwd_mono": 0,
                       "convlstm_fwd": 0, **cascade_launches()},
          f"launches over {TRAIN_STEPS} steps and {n_evals} evaluations: "
          f"{launches}")
    return {"evals": evals, "launches": launches}


def evaluate_through_cli(card: str, run: str) -> dict:
    """`cli.evaluate_gaze` on a run of `cli.train_gaze`: overall.txt and one
    scores.txt row per frame of the synthetic valid split (8 clips, one
    batch), one launch of the model's forward kernel and no other; the
    mean scores within EVAL_MAX_ABS of the same evaluation through the
    plain scan."""
    exp = Checkpointer.load_config(run)
    name, kernel = exp.model.name, FORWARD_KERNEL[exp.model.name]
    reset_launches()
    start = time.perf_counter()
    rc = evaluate_gaze.main(["--train_dir", run])
    launches = read_launches()
    seconds = time.perf_counter() - start
    check(rc == 0, f"cli.evaluate_gaze {name} returned {rc}")
    with open(f"{run}/evaluation/overall.txt") as f:
        overall = {k: float(v) for k, v in
                   (line.strip().split(": ") for line in f)}
    with open(f"{run}/evaluation/scores.txt") as f:
        header, *rows = f.read().splitlines()

    model = registry.create_model(name, exp.model, device="cuda")
    state, _ = create_train_state(model, exp.optimizer)
    Checkpointer(run).restore_latest(state)
    valid = synthetic.make_splits(n_train=2, n_valid=8, n_test=2, t=T,
                                  seed=exp.seed).valid
    _, plain = evaluator.generate_and_evaluate(
        lambda frames, c3d: plain_predict(model, c3d), valid,
        model.cfg.batch_size, max_instances=None,
        input_cast=torch.bfloat16, device="cuda")
    delta = max(abs(overall[m] - plain[m]) for m in plain)
    print(f"cli.evaluate_gaze {name} ({len(rows)} frames, {seconds:.1f} s "
          f"wall with model set-up): {json.dumps(overall)}, launches "
          f"{launches}; plain-scan evaluation {json.dumps(plain)}, max "
          f"|delta| {delta:.3g} [{card}]", flush=True)
    check(header == "frame\t" + "\t".join(evaluator.AVAILABLE_METRICS)
          and len(rows) == 8 * T and rows[-1].startswith(f"{8 * T - 1:06d}\t"),
          f"scores.txt: header {header!r}, {len(rows)} rows")
    check(set(overall) == set(plain)
          and all(np.isfinite(v) for v in overall.values()),
          f"overall.txt {overall}")
    check(launches[kernel] == 1 and sum(launches.values()) == 1,
          f"evaluate_gaze {name} launches {launches}")
    check(delta <= EVAL_MAX_ABS, f"evaluate_gaze {name}: {overall} vs the "
                                 f"plain scan {plain}")
    return {"overall": overall, "plain": plain, "launches": launches}


def gradient_check(model, batch: dict) -> dict:
    """The train loss and gradients on one batch, from the same weights,
    through the kernels' backward against plain autograd of `ConvGRU.scan`
    (no dropout; the flip is not applied)."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    keep = model.cfg.dropout_keep_prob
    model.cfg.dropout_keep_prob = 1.0
    out = {}
    try:
        for label in ("plain", "v2 (G, B2, W)"):
            with plain_route(model, label == "plain"):
                loss, _ = model.loss(batch, train=True)
            grads = torch.autograd.grad(loss, params)
            out[label] = (loss.item(), [g.float().cpu().numpy()
                                        for g in grads])
    finally:
        model.cfg.dropout_keep_prob = keep
    plain_loss, plain_grads = out.pop("plain")
    scale = max(float(np.abs(g).max()) for g in plain_grads)
    results = {}
    for label, (loss, grads) in out.items():
        rel = abs(loss - plain_loss) / abs(plain_loss)
        check(rel <= LOSS_MAX_REL, f"{label}: loss {loss} vs plain "
                                   f"{plain_loss} (rel {rel})")
        worst = (1.0, None)
        for name, a, k in zip(names, plain_grads, grads):
            if a.size > 1:
                c = corr(k, a)
                check(c >= GRAD_MIN_CORR,
                      f"{label}: grad {name} corr {c} vs plain autograd")
                worst = min(worst, (c, name))
            else:
                # the head bias: zero up to rounding under xentropy
                # (softmax ignores a shift), so held to the gradients' scale
                check(float(np.abs(k - a).max()) <= 1e-3 * scale,
                      f"{label}: grad {name} {k} vs plain {a}")
        results[label] = {"loss": loss, "plain_loss": plain_loss,
                          "loss_rel": rel, "min_corr": worst[0],
                          "min_corr_param": worst[1]}
    print(f"gradient check (B={TRAIN_BATCH}, T={T}, bf16, vs plain "
          f"autograd): {json.dumps(results)}", flush=True)
    return results


def train_step_timing(model, raw: dict) -> dict:
    """The train step at B=28 through the kernels and through plain
    autograd (in turns: plain, kernels, kernels, plain), and a breakdown
    of the kernel path."""
    cdt = torch.bfloat16
    dev = torch.device("cuda")
    start = time.perf_counter()
    batch = device_put_batch(raw, dev, stream_casts(cdt))
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - start) * 1e3
    state, tx = create_train_state(model, OptimizerConfig())
    step = make_train_step(model, tx)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    runs = {"plain": [], "kernels": [], "v2 library stages": []}
    for label in ("plain", "kernels", "v2 library stages",
                  "v2 library stages", "kernels", "plain"):
        with plain_route(model, label == "plain"), v2_stages(
                "library" if label == "v2 library stages" else "kernels"):
            runs[label].append(cuda_ms(lambda: step(state, batch, gen), 5))
    params = list(state.params.values())

    def forward_backward():
        loss, _ = model.loss(batch, train=True, generator=gen)
        return torch.autograd.grad(loss, params)

    stages = {"batch prep + H2D (host clock)": h2d_ms,
              "forward (loss)": cuda_ms(
                  lambda: model.loss(batch, train=True, generator=gen), 5),
              "forward + backward": cuda_ms(forward_backward, 5)}
    grads = dict(zip(state.params, forward_backward()))
    stages["optimizer (clip + adam)"] = cuda_ms(
        lambda: tx.apply(state.params, grads, state.opt_state), 5)
    # the ConvGRU's own pieces at this batch, on the forward's wx and ys
    with torch.no_grad():
        fused = ConvGRU.fuse(model.cell)
        xs = apply_c3d_projection(
            model.c3d_proj, batch["c3d"], keep_prob=1.0, generator=None,
            train=False, compute_dtype=cdt).transpose(0, 1)
        wx = ConvGRU.input_gates(fused, xs, cdt)
        h0 = ConvGRU.zero_state(TRAIN_BATCH, (7, 7), UNITS, device=dev)
        _, ys = kconv.convgru_recurrence(fused, wx, h0)
        g = torch.randn(ys.shape, device=dev, generator=gen)
        uzr, uc = fused["Uh_zr"], fused["U_c"]
        stages["  B1 convgru_fwd (in forward)"] = cuda_ms(
            lambda: kconv.convgru_recurrence(fused, wx, h0), 5)
        stages["  backward stage 1: phase G convgru_bwd_gates"] = cuda_ms(
            lambda: v1.bwd_gates(uzr, uc, wx, h0, ys), 5)
        u, r, c, hprev, rh = v1.bwd_gates(uzr, uc, wx, h0, ys)
        stages["  backward stage 2: B2 convgru_bwd"] = cuda_ms(
            lambda: v2.dh_bwd(u, r, c, hprev, g, uzr, uc, cdt), 5)
        dzr, da, _ = v2.dh_bwd(u, r, c, hprev, g, uzr, uc, cdt)
        stages["  backward stage 3: phase W convgru_wgrad"] = cuda_ms(
            lambda: v1.wgrad(hprev, dzr, rh, da, cdt), 5)
    kernels_ms = statistics.mean(runs["kernels"])
    plain_ms = statistics.mean(runs["plain"])
    return {"kernels_ms": kernels_ms, "plain_ms": plain_ms, "runs": runs,
            "library_stages_ms": statistics.mean(runs["v2 library stages"]),
            "clips_per_s": TRAIN_BATCH / kernels_ms * 1e3,
            "plain_clips_per_s": TRAIN_BATCH / plain_ms * 1e3,
            "stages": stages}


def predict_breakdown(model, c3d: torch.Tensor) -> dict:
    """CUDA-event times of the stages of gaze_grcn's or gaze_lstm's
    predict, each run alone on the outputs of the stage before (bf16
    compute)."""
    cdt = torch.bfloat16
    b, t = c3d.shape[:2]
    units = model.cfg.rnn_state_size
    stage = dict(keep_prob=1.0, generator=None, train=False,
                 compute_dtype=cdt)
    lstm = model.cfg.name == "gaze_lstm"
    cell = ConvLSTM if lstm else ConvGRU
    with torch.inference_mode():
        fused = cell.fuse(model.cell)
        state0 = cell.zero_state(b, (7, 7), units, device=c3d.device)
        fns = {"projection": lambda: apply_c3d_projection(
            model.c3d_proj, c3d, **stage)}
        xs = fns["projection"]().transpose(0, 1)
        fns["input_gates"] = lambda: cell.input_gates(fused, xs, cdt)
        gates = fns["input_gates"]()
        if lstm:
            fns["recurrence_kernel"] = lambda: klstm.convlstm_recurrence(
                fused, gates, *state0)
        else:
            fns["recurrence_kernel"] = lambda: kconv.convgru_recurrence(
                fused, gates, state0)
        folded = fns["recurrence_kernel"]()[1].transpose(0, 1).reshape(
            b * t, 7, 7, units)
        fns["decoder_softmax"] = lambda: softmax_2d(apply_decoder(
            model.decoder, folded, **stage))
        return {name: cuda_ms(fn, 10) for name, fn in fns.items()}


def route_check(card: str) -> dict:
    """Fault C1's rule on the card: predict of gaze_grcn and gaze_lstm at
    a width the cluster kernels take (U=128), one no kernel takes (U=24)
    and one too wide for them (U=256: gaze_grcn's cell takes B6, gaze_lstm's
    the scan), each route decided from the shapes before any launch and
    checked by the launch counts."""
    rng = np.random.RandomState(SEED + 11)
    c3d = torch.from_numpy(rng.randn(2, T, 1024, 7, 7).astype(
        np.float32)).cuda()
    out = {}
    for name in ("gaze_grcn", "gaze_lstm"):
        for units in (128, 24, 256):
            model = registry.create_model(
                name, rnn_state_size=units, n_lstm_steps=T,
                compute_dtype="bfloat16", device="cuda",
                generator=torch.Generator().manual_seed(SEED))
            reset_launches()
            maps = model.predict(None, c3d)
            launches = read_launches()
            kernel = {128: FORWARD_KERNEL[name],
                      256: "convgru_grid_fwd" if name == "gaze_grcn"
                      else None}.get(units)
            want = int(kernel is not None)
            out[name, units] = model.last_route
            check(model.last_route == ("kernel" if want else "scan")
                  and (not want or launches[kernel] == 1)
                  and sum(launches.values()) == want
                  and bool(torch.isfinite(maps).all())
                  and tuple(maps.shape) == (2, T, 49, 49),
                  f"C1 route {name} U={units}: {model.last_route}, "
                  f"launches {launches}")
    print(f"C1 routes (predict, bf16; train: gaze_grcn "
          f"{full_width_model().recurrence_route(train=True)}, gaze_lstm "
          f"scan): " + ", ".join(f"{n} U={u} {r}"
                                 for (n, u), r in out.items())
          + f" [{card}]", flush=True)
    return out


def tower_flops(n_clips: int) -> float:
    """The C3D tower's convolution FLOPs to conv5b for `n_clips` 16-frame
    112x112 clips (2 per multiply-add)."""
    d, h, w, cin, total = 16, 112, 112, 3, 0
    for name, cout in c3d_model.CONV_LAYERS:
        total += 2 * 27 * cin * cout * d * h * w
        cin = cout
        if name in c3d_model.POOLS and name != "conv5b":
            sd, sh, sw = c3d_model.POOLS[name][1]
            d, h, w = -(-d // sd), -(-h // sh), -(-w // sw)
    return float(total) * n_clips


def tower_gate(tower: dict, card: str) -> dict:
    """The tower in bf16 against the same tower in f32 (TF32 off) on 16
    clips: conv5b corr >= MAP_MIN_CORR."""
    pixels = torch.from_numpy(np.random.RandomState(SEED + 12).randint(
        0, 256, (16, 16, 128, 171, 3)).astype(np.uint8)).cuda()
    with torch.inference_mode():
        clips = c3d_model.preprocess_frames(pixels)
        bf16 = c3d_model.apply(tower, clips, compute_dtype=torch.bfloat16)
        f32 = c3d_model.apply(tower, clips, compute_dtype=None)
    a, b = bf16.cpu().numpy(), f32.cpu().numpy()
    c = corr(a, b)
    rel = float(np.abs(a - b).max() / np.abs(b).max())
    print(f"tower gate (16 clips, conv5b [16,512,2,7,7], bf16 vs f32 with "
          f"TF32 off): corr {c:.6f}, max rel delta {rel:.4g} [{card}]",
          flush=True)
    check(a.shape == (16, 512, 2, 7, 7) and bool(np.isfinite(a).all()),
          f"tower conv5b {a.shape}, finite {bool(np.isfinite(a).all())}")
    check(c >= MAP_MIN_CORR, f"tower bf16 vs f32 corr {c}")
    return {"corr": c, "max_rel_delta": rel}


def post_video(url: str, video: np.ndarray) -> tuple:
    buf = io.BytesIO()
    np.savez(buf, video=video)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    start = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        status, body = resp.status, resp.read()
    seconds = time.perf_counter() - start
    return status, np.load(io.BytesIO(body))["gazemaps"], seconds


def post_videos(url: str, videos: np.ndarray) -> list:
    """POST video i from thread i, all at once; (status, maps, s) each."""
    results: list = [None] * len(videos)
    errors: list = []

    def one(i: int) -> None:
        try:
            results[i] = post_video(url, videos[i])
        except Exception as e:  # reported below; the run fails
            errors.append(f"request {i}: {e!r}")

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(videos))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    check(not errors and all(r is not None for r in results),
          f"video requests failed: {errors}")
    return results


def plain_fused_predict(model, tower: dict, video: torch.Tensor
                        ) -> torch.Tensor:
    """The fused predict by its plain path: the bf16 library tower on the
    video's windows, then a plain-scan predict of the folded features."""
    b, f = video.shape[:2]
    t = pipeline.pipeline_timesteps(f)
    n_windows = f // 16
    with torch.inference_mode():
        clips = c3d_model.preprocess_frames(video[:, :n_windows * 16].reshape(
            b * n_windows, 16, *video.shape[2:]))
        feats = c3d_model.conv5b_to_rgp(c3d_model.apply(
            tower, clips, compute_dtype=torch.bfloat16)).reshape(
                b, n_windows, 1024, 7, 7)[:, :t]
    return plain_predict(model, feats)


def fused_serve_and_check(model, tower: dict, videos: np.ndarray,
                          card: str, bundle: str = None) -> dict:
    """Serve `model`'s fused program from a bundle it writes with uint8
    video (or from `bundle`, an export of `model` with `tower`); POST
    every clip at once, check each reply against the plain path, and that
    the model's forward kernel, and no other, launched once per batcher
    call. Then POST them again for the latency."""
    name = model.cfg.name
    kernel = FORWARD_KERNEL[name]
    t = pipeline.pipeline_timesteps(FUSED_FRAMES)
    with tempfile.TemporaryDirectory() as tmp:
        if bundle is None:
            bundle = f"{tmp}/bundle"
            save_bundle(bundle, model, c3d_params=tower,
                        num_frames=FUSED_FRAMES, video_hw=VIDEO_HW,
                        video_dtype="uint8")
        reference = load_bundle(bundle, device="cuda")
        route = reference.recurrence_route(train=False)
        server = server_from_bundle(bundle, program="fused",
                                    device="cuda", max_batch=32,
                                    max_wait_ms=200.0).start()
        try:
            host, port = server.address
            url = f"http://{host}:{port}/predict"
            reset_launches()
            served = post_videos(url, videos)
            launches = read_launches()
            health = {"calls": server.batcher.calls,
                      "requests": server.batcher.requests}
            print(f"fused serving {name}: {len(videos)} concurrent uint8 "
                  f"video requests [{FUSED_FRAMES},{VIDEO_HW[0]},"
                  f"{VIDEO_HW[1]},3], {health}, route {route}, kernel "
                  f"launches {launches}", flush=True)
            check(route == "kernel" and launches[kernel] >= 1
                  and health["requests"] == len(videos)
                  and launches[kernel] == health["calls"]
                  and sum(launches.values()) == launches[kernel],
                  f"fused serving {name}: route {route}, {health}, "
                  f"launches {launches}")
            plain = plain_fused_predict(
                reference, reference.bundle_c3d_params,
                torch.from_numpy(videos).cuda()).cpu().numpy()
            for i, (status, maps, _) in enumerate(served):
                check(status == 200, f"fused {name} request {i}: HTTP "
                                     f"{status}")
                check(maps.shape == (t, 49, 49)
                      and bool(np.isfinite(maps).all()),
                      f"fused {name} request {i}: maps {maps.shape}")
                sums = maps.reshape(t, -1).sum(-1)
                check(bool(np.abs(sums - 1.0).max() <= 1e-3),
                      f"fused {name} request {i}: sums off 1 by "
                      f"{np.abs(sums - 1.0).max()}")
                c = corr(maps, plain[i])
                check(c >= MAP_MIN_CORR,
                      f"fused {name} request {i}: corr {c} vs plain path")
            min_corr = min(corr(m, plain[i])
                           for i, (_, m, _) in enumerate(served))
            print(f"fused serving {name}: all {len(videos)} replies HTTP "
                  f"200, [{t},49,49] finite, sums 1 within 1e-3, min corr "
                  f"vs plain path (bf16 tower + plain scan) "
                  f"{min_corr:.6f} [{card}]", flush=True)
            again = post_videos(url, videos)
            http_ms = statistics.median(s for _, _, s in again) * 1e3
        finally:
            server.close()
    return {"launches": launches, "http_ms": http_ms, "min_corr": min_corr,
            "route": route}


def train_fused_through_cli(card: str) -> dict:
    """Training from raw pixels through `cli.train_fused` on the card: 20
    frozen-tower steps at the JAX benchmark's shape, then 3 steps with the
    tower fine-tuned."""
    t = pipeline.pipeline_timesteps(FUSED_FRAMES)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, steps, extra in (("frozen", FUSED_TRAIN_STEPS, []),
                                    ("finetune", FINETUNE_STEPS,
                                     ["--finetune_c3d"])):
            run = f"{tmp}/{label}"
            argv = ["--dataset", "synthetic", "--num_frames",
                    str(FUSED_FRAMES), "--frame_hw", *map(str, VIDEO_HW),
                    "--batch_size", str(FUSED_TRAIN_BATCH),
                    "--synthetic_clips", str(FUSED_TRAIN_BATCH),
                    "--compute_dtype", "bfloat16", "--max_steps", str(steps),
                    "--steps_per_logprint", "1", "--seed", str(SEED),
                    "--train_dir", run, *extra]
            reset_launches()
            start = time.perf_counter()
            rc = train_fused.main(argv)
            launches = read_launches()
            seconds = time.perf_counter() - start
            check(rc == 0, f"cli.train_fused {label} returned {rc}")
            with open(f"{run}/metrics.jsonl") as f:
                records = [json.loads(line) for line in f]
            saved = Checkpointer(run).steps()
            losses = [r["loss/train"] for r in records]
            print(f"train_fused {label} (cli.train_fused, B="
                  f"{FUSED_TRAIN_BATCH}, F={FUSED_FRAMES} -> T={t}, "
                  f"{VIDEO_HW[0]}x{VIDEO_HW[1]} uint8, bf16, {steps} steps, "
                  f"{seconds:.1f} s wall with corpus and model set-up): "
                  f"losses {[round(x, 4) for x in losses]}, launches "
                  f"{launches}, checkpoints {saved} [{card}]", flush=True)
            check([r["step"] for r in records] == list(range(1, steps + 1)),
                  f"{label} metrics.jsonl steps "
                  f"{[r['step'] for r in records]}")
            check(all(np.isfinite(losses)), f"{label}: non-finite loss "
                                            f"{losses}")
            check(launches == {"convgru_fwd": steps, **v2_backwards(steps),
                               "convgru_bwd_mono": 0, "convlstm_fwd": 0,
                               **cascade_launches()},
                  f"{label}: launches over {steps} steps: {launches}")
            check(saved == [steps], f"{label}: checkpoints {saved}")
            if label == "frozen":
                check(statistics.mean(losses[-5:]) < losses[0],
                      f"fused loss did not fall: first {losses[0]}, mean "
                      f"of the last 5 {statistics.mean(losses[-5:])}")
            else:
                stored = torch.load(f"{run}/model/{steps}/state.pt",
                                    weights_only=True)["c3d_params"]
                init = c3d_model.init_params(
                    torch.Generator().manual_seed(SEED + 1),
                    device="cpu")["conv1a_w"]
                moved = float((stored["conv1a_w"] - init).abs().max())
                print(f"train_fused finetune: conv1a max |change| "
                      f"{moved:.4g}", flush=True)
                check(moved > 0, "finetune: conv1a's weights did not move")
            out[label] = {"losses": losses, "launches": launches}
    return out


def train_lstm_through_cli(card: str, run: str) -> dict:
    """gaze_lstm through `cli.train_gaze` at full width (B=28, T=42): it
    trains on `ConvLSTM.scan` under autograd (no backward kernel), so no
    kernel launches; its 14-clip test split is smaller than a batch, so
    there is no final evaluation."""
    argv = ["--model", "gaze_lstm", "--dataset", "synthetic",
            "--batch_size", str(TRAIN_BATCH), "--synthetic_clips",
            str(TRAIN_BATCH), "--n_lstm_steps", str(T),
            "--compute_dtype", "bfloat16", "--max_steps",
            str(TRAIN_STEPS), "--steps_per_logprint", "1", "--seed",
            str(SEED), "--train_dir", run]
    reset_launches()
    start = time.perf_counter()
    rc = train_gaze.main(argv)
    launches = read_launches()
    seconds = time.perf_counter() - start
    check(rc == 0, f"cli.train_gaze --model gaze_lstm returned {rc}")
    with open(f"{run}/metrics.jsonl") as f:
        losses = [json.loads(line)["loss/train"] for line in f]
    print(f"train gaze_lstm (cli.train_gaze, B={TRAIN_BATCH}, T={T}, bf16, "
          f"{TRAIN_STEPS} steps, {seconds:.1f} s wall): losses "
          f"{[round(x, 4) for x in losses]}, launches {launches} [{card}]",
          flush=True)
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"gaze_lstm losses {losses}")
    check(statistics.mean(losses[-5:]) < losses[0],
          f"gaze_lstm loss did not fall: first {losses[0]}, mean of the "
          f"last 5 {statistics.mean(losses[-5:])}")
    check(sum(launches.values()) == 0, f"gaze_lstm train launches "
                                       f"{launches}")
    return {"losses": losses}


def lstm_gradient_check(model, batch: dict) -> dict:
    """gaze_lstm's train loss and gradients on one batch (no dropout)
    against plain autograd of `ConvLSTM.scan` assembled by hand
    (projection, scan, decoder, loss)."""
    params = [p for _, p in model.named_parameters()]
    keep = model.cfg.dropout_keep_prob
    model.cfg.dropout_keep_prob = 1.0
    try:
        loss, _ = model.loss(batch, train=True)
        grads = torch.autograd.grad(loss, params)
        route = model.last_route
    finally:
        model.cfg.dropout_keep_prob = keep
    cdt = torch.bfloat16
    stage = dict(keep_prob=1.0, generator=None, train=True,
                 compute_dtype=cdt)
    c3d_in = batch["c3d"]
    b, t = c3d_in.shape[:2]
    xs = apply_c3d_projection(model.c3d_proj, c3d_in, **stage).transpose(
        0, 1)
    _, ys = ConvLSTM.scan(model.cell, xs,
                          ConvLSTM.zero_state(b, (7, 7), UNITS,
                                              device=c3d_in.device),
                          compute_dtype=cdt)
    logits = apply_decoder(model.decoder, ys.transpose(0, 1).reshape(
        b * t, 7, 7, UNITS), **stage).reshape(b, t, 49, 49)
    plain_loss = sequence_loss(logits, normalize_probability_map(
        batch["gazemaps"]), model.cfg.loss_type)
    plain = torch.autograd.grad(plain_loss, params)
    rel = abs(loss.item() - plain_loss.item()) / abs(plain_loss.item())
    worst = min(corr(g.float().cpu().numpy(), p.float().cpu().numpy())
                for g, p in zip(grads, plain) if g.numel() > 1)
    print(f"gradient check gaze_lstm (B={TRAIN_BATCH}, T={T}, bf16, route "
          f"{route} vs plain autograd of ConvLSTM.scan): loss rel "
          f"{rel:.3g}, min grad corr {worst:.7f}", flush=True)
    check(route == "scan", f"gaze_lstm trained on route {route}")
    check(rel <= LOSS_MAX_REL and worst >= GRAD_MIN_CORR,
          f"gaze_lstm gradients: loss rel {rel}, min corr {worst}")
    return {"loss_rel": rel, "min_corr": worst}


def tower_layout_timing(tower: dict, n_clips: int) -> dict:
    """The bf16 tower on `n_clips` clips with its activations NCDHW and
    channels-last-3d, in turns (NCDHW, CL, CL, NCDHW); then, measured only
    (the port leaves cuDNN's heuristics on), channels-last-3d with
    `cudnn.benchmark` choosing each conv's algorithm by trial."""
    pixels = torch.from_numpy(np.random.RandomState(SEED + 13).randint(
        0, 256, (n_clips, 16, 128, 171, 3)).astype(np.uint8)).cuda()
    runs = {"ncdhw": [], "channels_last_3d": [],
            "channels_last_3d, cudnn.benchmark": []}
    with torch.inference_mode():
        clips = c3d_model.preprocess_frames(pixels)
        layouts = {"ncdhw": clips.contiguous(),
                   "channels_last_3d": clips.contiguous(
                       memory_format=torch.channels_last_3d)}
        for label in ("ncdhw", "channels_last_3d", "channels_last_3d",
                      "ncdhw"):
            runs[label].append(cuda_ms(lambda: c3d_model.apply(
                tower, layouts[label], compute_dtype=torch.bfloat16), 5))
        saved = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = True
        try:
            runs["channels_last_3d, cudnn.benchmark"].append(cuda_ms(
                lambda: c3d_model.apply(tower, layouts["channels_last_3d"],
                                        compute_dtype=torch.bfloat16), 5))
        finally:
            torch.backends.cudnn.benchmark = saved
    return runs


def fused_predict_timing(model, tower: dict, b: int) -> dict:
    """ms per fused predict call at B=b, F=FUSED_FRAMES, uint8 128x171 on
    the card, and its stages, each run alone on the outputs of the stage
    before."""
    video = torch.from_numpy(np.random.RandomState(SEED + 14).randint(
        0, 256, (b, FUSED_FRAMES, *VIDEO_HW, 3)).astype(np.uint8)).cuda()
    fn = pipeline.make_fused_predict(model, num_frames=FUSED_FRAMES)
    n_windows = FUSED_FRAMES // 16
    t = pipeline.pipeline_timesteps(FUSED_FRAMES)
    out = {"ms": cuda_ms(lambda: fn(tower, video), 5)}
    with torch.inference_mode():
        windows = video.reshape(b * n_windows, 16, *VIDEO_HW, 3)
        out["preprocess (crop, widen, mean)"] = cuda_ms(
            lambda: c3d_model.preprocess_frames(windows), 5)
        clips = c3d_model.preprocess_frames(windows)
        out["tower (conv1a..conv5b, bf16)"] = cuda_ms(
            lambda: c3d_model.apply(tower, clips, compute_dtype=torch.bfloat16), 5)
        conv5b = c3d_model.apply(tower, clips, compute_dtype=torch.bfloat16)
        out["fold"] = cuda_ms(lambda: c3d_model.conv5b_to_rgp(conv5b).reshape(
            b, n_windows, 1024, 7, 7)[:, :t].contiguous(), 5)
        feats = c3d_model.conv5b_to_rgp(conv5b).reshape(
            b, n_windows, 1024, 7, 7)[:, :t].contiguous()
        out["gaze predict"] = cuda_ms(lambda: model.predict(None, feats), 5)
        out["  of which"] = predict_breakdown(model, feats)
    return out


def fused_train_step_timing(model, finetune: bool) -> float:
    """ms per fused train step at B=FUSED_TRAIN_BATCH, F=FUSED_FRAMES
    (flip and dropout on, Adam, bf16)."""
    corpus = fused_data.make_synthetic_fused_corpus(
        FUSED_TRAIN_BATCH, num_frames=FUSED_FRAMES, frame_hw=VIDEO_HW,
        seed=SEED + 15)
    batch = device_put_batch(corpus.next_batch(FUSED_TRAIN_BATCH),
                             torch.device("cuda"))
    tower = c3d_model.init_params(torch.Generator().manual_seed(SEED + 1))
    state, tx = create_train_state(model, OptimizerConfig())
    state = fused_data.FusedTrainState(
        params=state.params, c3d_params=tower,
        opt_state=pipeline.init_fused_opt_state(
            tx, state.params, tower, finetune_c3d=finetune))
    step = pipeline.make_fused_train_step(model, tx, finetune_c3d=finetune)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return cuda_ms(lambda: step(state, batch, gen), 3, warmup=1)


# ------------------------------------------------------------ the model zoo

def zoo_model(name: str, **overrides):
    """A family of the zoo at its registry width in bf16 on the card,
    seeded random weights with the ConvGRU kernels at N(0, 1/fan_in) (the
    reference init leaves the recurrence ~0)."""
    gen = torch.Generator().manual_seed(SEED)
    model = registry.create_model(name, compute_dtype="bfloat16",
                                  device="cuda", generator=gen, **overrides)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.split(".")[0] in CELLS and p.dim() == 4:
                fan_in = p.shape[0] * p.shape[1] * p.shape[2]
                p.copy_(torch.randn(p.shape, generator=gen)
                        / float(np.sqrt(fan_in)))
    return model


def zoo_inputs(model, b: int, seed: int) -> tuple:
    """frames [B,T,98,98,3] in [0,1] and c3d [B,T,1024,7,7] on the card."""
    rng = np.random.RandomState(seed)
    t = model.cfg.n_lstm_steps
    frames = torch.from_numpy(rng.rand(b, t, 98, 98, 3).astype(np.float32))
    c3d = torch.from_numpy(rng.randn(b, t, 1024, 7, 7).astype(np.float32))
    return frames.cuda(), c3d.cuda()


def zoo_kernel_launches(name: str, calls: int = 1) -> dict:
    """The launches of `calls` forwards in bf16: B1 for gaze_pupil_grcn,
    B5 and B6 for gaze_grcn_cascade (its top and bottom cells), none for
    the other families of the zoo."""
    fwd = calls if name == "gaze_pupil_grcn" else 0
    top = calls if name == "gaze_grcn_cascade" else 0
    return {"convgru_fwd": fwd, **v2_backwards(0), "convgru_bwd_mono": 0,
            "convlstm_fwd": 0, **cascade_launches(top)}


def c4_kernel_gates(card: str) -> dict:
    """B1 and B2 at gaze_pupil_grcn's shapes (U=64, C=4, T=35, 32 input
    channels) against their plain versions, bf16 under the gate and f32
    (TF32 off) at F32_MAX_REL_DELTA, at each of C4_BATCHES; B1's final h
    must equal ys[-1] (`parity_ok`)."""
    out = {}
    for b in C4_BATCHES:
        bf16 = convgru_parity(t=C4_T, b=b, c=C4_C, units=C4_UNITS,
                              device="cuda")
        with tf32_off():
            f32 = convgru_parity(t=C4_T, b=b, c=C4_C, units=C4_UNITS,
                                 compute_dtype=torch.float32, device="cuda")
        print(f"parity convgru_fwd U={C4_UNITS} (C=4) T={C4_T} B={b}: bf16 "
              f"{json.dumps(bf16)}; f32 {json.dumps(f32)}", flush=True)
        check(parity_ok(bf16), f"U=64 bf16 parity gate failed at B={b}: "
                               f"{bf16}")
        check(parity_ok(f32, max_rel_delta=F32_MAX_REL_DELTA),
              f"U=64 f32 parity failed at B={b}: {f32}")
        stats = backward_parity("convgru_bwd", t=C4_T, b=b, c=C4_C,
                                units=C4_UNITS, device="cuda")
        with tf32_off():
            stats32 = backward_parity("convgru_bwd", t=C4_T, b=b, c=C4_C,
                                      units=C4_UNITS,
                                      compute_dtype=torch.float32,
                                      device="cuda")
        print(f"parity convgru_bwd U={C4_UNITS} (C=4) T={C4_T} B={b}: bf16 "
              f"{json.dumps(stats['outputs'])}; f32 "
              f"{json.dumps(stats32['outputs'])}", flush=True)
        check(backward_parity_ok(stats), f"U=64 convgru_bwd bf16 gate "
                                         f"failed at B={b}: {stats}")
        check(backward_parity_ok(stats32, max_rel_delta=F32_MAX_REL_DELTA),
              f"U=64 convgru_bwd f32 parity failed at B={b}: {stats32}")
        out[b] = {"fwd": bf16, "bwd": stats}
    # phases G and W at the registry batch: V2's backward runs them here too
    for kernel in ("convgru_bwd_gates", "convgru_wgrad"):
        b = C4_BATCHES[0]
        stats = backward_parity(kernel, t=C4_T, b=b, c=C4_C, units=C4_UNITS,
                                device="cuda")
        with tf32_off():
            stats32 = backward_parity(kernel, t=C4_T, b=b, c=C4_C,
                                      units=C4_UNITS,
                                      compute_dtype=torch.float32,
                                      device="cuda")
        print(f"parity {kernel} U={C4_UNITS} T={C4_T} B={b}: bf16 "
              f"{json.dumps(stats['outputs'])}; f32 "
              f"{json.dumps(stats32['outputs'])}", flush=True)
        check(backward_parity_ok(stats), f"U=64 {kernel} bf16 gate failed "
                                         f"at B={b}: {stats}")
        check(backward_parity_ok(stats32, max_rel_delta=F32_MAX_REL_DELTA),
              f"U=64 {kernel} f32 parity failed at B={b}: {stats32}")
        out[kernel] = stats
    return out


def zoo_predict_check(card: str) -> dict:
    """Each family's predict (its logits) at its registry T and batch and
    at B=16 in bf16: finite, of shape [B,T,GH,GW], corr >= MAP_MIN_CORR
    against the same weights in f32 with TF32 off; gaze_pupil_grcn
    launches B1 once per call (its route "kernel"), gaze_grcn_cascade B5
    and B6 once per call (its `top_route` and `last_route` "kernel"), the
    others no recurrence kernel."""
    out = {}
    for name in ZOO:
        model = zoo_model(name)
        gh, gw = model.cfg.gazemap_height, model.cfg.gazemap_width
        t = model.cfg.n_lstm_steps
        for b in (model.cfg.batch_size, ZOO_PREDICT_BATCH):
            frames, c3d = zoo_inputs(model, b, SEED + 21)
            reset_launches()
            with torch.inference_mode():
                logits = model(frames, c3d)
            launches = read_launches()
            route = getattr(model, "last_route", None)
            top_route = getattr(model, "top_route", None)
            model.cfg.compute_dtype = "float32"
            try:
                with tf32_off(), torch.inference_mode():
                    ref = model(frames, c3d)
            finally:
                model.cfg.compute_dtype = "bfloat16"
            a = logits.float().cpu().numpy()
            c = corr(a, ref.float().cpu().numpy())
            print(f"zoo predict {name} B={b} T={t}: logits "
                  f"{list(a.shape)}, route {route}, launches {launches}, "
                  f"corr vs f32 (TF32 off) {c:.6f} [{card}]", flush=True)
            check(a.shape == (b, t, gh, gw) and bool(np.isfinite(a).all()),
                  f"{name} B={b}: logits {a.shape}, finite "
                  f"{bool(np.isfinite(a).all())}")
            check(c >= MAP_MIN_CORR, f"{name} B={b}: corr {c} vs f32")
            check(launches == zoo_kernel_launches(name),
                  f"{name} B={b}: launches {launches}")
            if name in ("gaze_pupil_grcn", "gaze_grcn_cascade"):
                check(route == "kernel", f"{name}: route {route}")
            elif route is not None:
                check(route == "scan", f"{name}: route {route}")
            if name == "gaze_grcn_cascade":
                check(top_route == "kernel", f"{name}: top_route {top_route}")
            out[name, b] = {"corr": c, "route": route}
    return out


def serve_zoo_and_check(model, card: str) -> dict:
    """Serve a zoo family over HTTP from a bundle it writes (the `predict`
    program); POST N_REQUESTS clips at once; each reply HTTP 200, [T,GH,GW],
    finite, corr >= MAP_MIN_CORR against the plain path (the bundle's model
    on all clips in one call, its recurrence on the cell's own scan); B1
    once per batcher call for gaze_pupil_grcn, no launch for the others.
    Then POST them again for the latency."""
    name = model.cfg.name
    t, gh = model.cfg.n_lstm_steps, model.cfg.gazemap_height
    rng = np.random.RandomState(SEED + 23)
    c3d = rng.randn(N_REQUESTS, t, 1024, 7, 7).astype(np.float32)
    frames = rng.rand(N_REQUESTS, t, 98, 98, 3).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        save_bundle(f"{tmp}/bundle", model)
        server = server_from_bundle(f"{tmp}/bundle", device="cuda",
                                    max_batch=32, max_wait_ms=50.0).start()
        try:
            host, port = server.address
            url = f"http://{host}:{port}"
            reset_launches()
            served = post_all(f"{url}/predict", frames, c3d)
            launches = read_launches()
            with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
                health = json.loads(r.read())
            print(f"serving {name}: {N_REQUESTS} concurrent requests, "
                  f"healthz {health}, kernel launches {launches}", flush=True)
            check(health["requests"] == N_REQUESTS
                  and launches == zoo_kernel_launches(name, health["calls"]),
                  f"serving {name}: healthz {health}, launches {launches}")
            reference = load_bundle(f"{tmp}/bundle", device="cuda")
            if hasattr(reference, "recurrence_route"):
                reference.recurrence_route = lambda train: "scan"
            plain = reference.predict(torch.from_numpy(frames).cuda(),
                                      torch.from_numpy(c3d).cuda())
            plain = plain.float().cpu().numpy()
            for i, (status, maps, _) in enumerate(served):
                check(status == 200, f"{name} request {i}: HTTP {status}")
                check(maps.shape == (t, gh, gh),
                      f"{name} request {i}: gazemaps shape {maps.shape}")
                check(bool(np.isfinite(maps).all()),
                      f"{name} request {i}: non-finite maps")
                c = corr(maps, plain[i])
                check(c >= MAP_MIN_CORR,
                      f"{name} request {i}: corr {c} vs the plain path")
            min_corr = min(corr(m, plain[i])
                           for i, (_, m, _) in enumerate(served))
            print(f"serving {name}: all {N_REQUESTS} replies HTTP 200, "
                  f"[{t},{gh},{gh}] finite, min corr vs plain path "
                  f"{min_corr:.6f} [{card}]", flush=True)
            again = post_all(f"{url}/predict", frames, c3d)
            http_ms = statistics.median(s for _, _, s in again) * 1e3
        finally:
            server.close()
    return {"launches": launches, "http_ms": http_ms, "min_corr": min_corr}


def fused_framewise_check(model, tower: dict, card: str) -> dict:
    """One fused predict of gaze_framewise_shallownet (B=8, F=160 uint8
    128x171): the frame stream ([15::5], resized to 98x98 on the card)
    feeds its ShallowNet, and the C3D tower is skipped (`reads_c3d`).
    Against the plain path: the same frames resized on the host in f32,
    then the model's predict. Timed beside it."""
    t = pipeline.pipeline_timesteps(FUSED_FRAMES)
    videos = np.random.RandomState(SEED + 24).randint(
        0, 256, (8, FUSED_FRAMES, *VIDEO_HW, 3)).astype(np.uint8)
    video = torch.from_numpy(videos).cuda()
    fn = pipeline.make_fused_predict(model, num_frames=FUSED_FRAMES)
    maps = fn(tower, video).float().cpu().numpy()
    sub = torch.from_numpy(videos[:, pipeline.FRAME_OFFSET::
                                  pipeline.FRAME_STRIDE][:, :t]).float()
    frames = resize_bilinear(sub.reshape(8 * t, *sub.shape[2:]),
                             pipeline.FRAME_HW).reshape(
                                 8, t, *pipeline.FRAME_HW, 3) / 255.0
    plain = model.predict(frames.cuda(), None).float().cpu().numpy()
    c = corr(maps, plain)
    ms = cuda_ms(lambda: fn(tower, video), 5)
    print(f"fused predict gaze_framewise_shallownet B=8 F={FUSED_FRAMES} "
          f"uint8 -> T={t}: maps {list(maps.shape)}, corr vs the host-resized "
          f"plain path {c:.6f}; {ms:.3f} ms/call (tower skipped) [{card}]",
          flush=True)
    check(maps.shape == (8, t, 49, 49) and bool(np.isfinite(maps).all()),
          f"fused framewise maps {maps.shape}")
    check(c >= MAP_MIN_CORR, f"fused framewise corr {c}")
    return {"corr": c, "ms": ms}


def train_records(run: str) -> tuple:
    with open(f"{run}/metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if "loss/train" in r]
    return [r["loss/train"] for r in train], [r["step"] for r in train]


def check_learned(label: str, losses: list, steps: list, n: int) -> None:
    check(steps == list(range(1, n + 1)), f"{label}: logged steps {steps}")
    check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    check(statistics.mean(losses[-5:]) < losses[0],
          f"{label}: loss did not fall: first {losses[0]}, mean of the "
          f"last 5 {statistics.mean(losses[-5:])}")


def pretrain_through_cli(card: str, run: str, out: str) -> dict:
    """`cli.pretrain_shallownet --dataset synthetic` on the card, 20 steps
    at B=128 (the CLI's defaults otherwise: lr 3e-5, f32): the loss falls
    and the params file is written."""
    argv = ["--dataset", "synthetic", "--max_steps", str(TRAIN_STEPS),
            "--batch_size", str(PRETRAIN_BATCH), "--steps_per_logprint", "1",
            "--out", out, "--train_dir", run]
    reset_launches()
    start = time.perf_counter()
    rc = pretrain_shallownet.main(argv)
    seconds = time.perf_counter() - start
    launches = read_launches()
    check(rc == 0, f"cli.pretrain_shallownet returned {rc}")
    losses, steps = train_records(run)
    print(f"pretrain (cli.pretrain_shallownet, B={PRETRAIN_BATCH}, "
          f"{TRAIN_STEPS} steps, {seconds:.1f} s wall with data set-up): "
          f"losses {[round(x, 5) for x in losses]}, launches {launches} "
          f"[{card}]", flush=True)
    check_learned("pretrain_shallownet", losses, steps, TRAIN_STEPS)
    check(sum(launches.values()) == 0, f"pretraining launched {launches}")
    check(set(load_params(out)) == set(shallownet.init_params()),
          f"{out}: not ShallowNet's params")
    return {"losses": losses}


def zoo_train_through_cli(card: str, run: str, name: str,
                          extra: tuple = ()) -> dict:
    """`cli.train_gaze` on a zoo family at its registry T and batch, bf16,
    20 steps at ZOO_LR, batches prefetched: the loss falls; B1 and B2 once
    per step for gaze_pupil_grcn, B5 and B6 once each way per step (and
    B6's phase W) for gaze_grcn_cascade (and B1 / B5's and B6's forwards
    once per batch of the final test-split evaluation), no launch for the
    others."""
    argv = ["--model", name, "--dataset", "synthetic", "--compute_dtype",
            "bfloat16", "--max_steps", str(TRAIN_STEPS),
            "--steps_per_logprint", "1", "--learning_rate", str(ZOO_LR),
            "--seed", str(SEED), "--train_dir", run, *extra]
    reset_launches()
    start = time.perf_counter()
    rc = train_gaze.main(argv)
    seconds = time.perf_counter() - start
    launches = read_launches()
    m1_launches = gemm.launches
    check(rc == 0, f"cli.train_gaze --model {name} returned {rc}")
    losses, steps = train_records(run)
    print(f"train {name} (cli.train_gaze {' '.join(extra)}, registry B and "
          f"T, bf16, {TRAIN_STEPS} steps at lr {ZOO_LR}, {seconds:.1f} s wall "
          f"with data and model set-up): losses "
          f"{[round(x, 4) for x in losses]}, launches {launches}, M1 "
          f"{m1_launches} [{card}]", flush=True)
    check_learned(name, losses, steps, TRAIN_STEPS)
    if name == "gaze_pupil_grcn":
        test_batches = -(-ZOO_TEST_CLIPS // 7)
        want = {"convgru_fwd": TRAIN_STEPS + test_batches,
                **v2_backwards(TRAIN_STEPS), "convgru_bwd_mono": 0,
                "convlstm_fwd": 0, **cascade_launches()}
    elif name == "gaze_grcn_cascade":
        # B5 and B6 once each way per step (and B6's phase W), and
        # forward once per batch of the final test-split evaluation
        test_batches = -(-ZOO_TEST_CLIPS // 7)
        want = {**zoo_kernel_launches(name, 0),
                **cascade_launches(TRAIN_STEPS + test_batches, TRAIN_STEPS),
                "convgru_wgrad": TRAIN_STEPS}
        want_m1 = (M1_STEP_LAUNCHES * TRAIN_STEPS
                   + M1_PREDICT_LAUNCHES * test_batches)
        check(m1_launches == want_m1,
              f"{name}: M1 launches {m1_launches}, want {want_m1}")
    else:
        want = zoo_kernel_launches(name, 0)
    check(launches == want, f"{name}: launches {launches}, want {want}")
    saved = torch.load(f"{run}/model/{TRAIN_STEPS}/state.pt",
                       weights_only=True)["params"]
    return {"losses": losses, "launches": launches, "params": saved,
            "seconds": seconds, "m1_launches": m1_launches}


def pupil_gradient_check(card: str) -> dict:
    """gaze_pupil_grcn's train loss and gradients on one batch (B=7, T=35,
    bf16, no dropout) through B1 + B2 against plain autograd of
    `ConvGRU.scan`: loss within LOSS_MAX_REL, every tensor's gradient corr
    >= GRAD_MIN_CORR; B1 and B2 once on the kernel path, none on the plain;
    the loss is the gaze term plus 0.01 x a nonzero pupil term."""
    model = zoo_model("gaze_pupil_grcn")
    model.cfg.dropout_keep_prob = 1.0
    raw = synthetic.make_clip_windows(
        7, C4_T, seed=SEED + 3, gazemap_hw=(7, 7)).next_batch(7)
    batch = device_put_batch(raw, torch.device("cuda"),
                             stream_casts(torch.bfloat16))
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    out = {}
    for label in ("plain", "kernels"):
        reset_launches()
        with plain_route(model, label == "plain"):
            loss, aux = model.loss(batch, train=True)
        grads = torch.autograd.grad(loss, params)
        launches = read_launches()
        out[label] = (loss.item(), [g.float().cpu().numpy() for g in grads],
                      launches, {k: aux[k].item() for k in
                                 ("gaze_loss", "pupil_loss")})
    (plain_loss, plain_grads, plain_launches, _), \
        (loss, grads, launches, parts) = out["plain"], out["kernels"]
    rel = abs(loss - plain_loss) / abs(plain_loss)
    corrs = {n: corr(k, a) for n, a, k in zip(names, plain_grads, grads)}
    joint = parts["gaze_loss"] + 0.01 * parts["pupil_loss"]
    print(f"gradient check gaze_pupil_grcn (B=7, T={C4_T}, bf16, B1 + G, B2, "
          f"W at U=64 vs plain autograd): loss {loss} vs {plain_loss} (rel "
          f"{rel:.3g}), gaze {parts['gaze_loss']:.5f} + 0.01 x pupil "
          f"{parts['pupil_loss']:.5f}, min grad corr "
          f"{min(corrs.values()):.6f} ({min(corrs, key=corrs.get)}), "
          f"launches {launches} / plain {plain_launches} [{card}]",
          flush=True)
    check(rel <= LOSS_MAX_REL, f"pupil grcn loss rel {rel}")
    for n, c in corrs.items():
        check(c >= GRAD_MIN_CORR, f"pupil grcn grad {n} corr {c}")
    check(launches == {"convgru_fwd": 1, **v2_backwards(1),
                       "convgru_bwd_mono": 0, "convlstm_fwd": 0,
                       **cascade_launches()}
          and sum(plain_launches.values()) == 0,
          f"pupil grcn launches {launches}, plain {plain_launches}")
    check(parts["pupil_loss"] > 0 and abs(loss - joint) <= 1e-5 * abs(loss),
          f"pupil term: loss {loss}, gaze + 0.01 pupil {joint}")
    return {"loss_rel": rel, "min_corr": min(corrs.values()), **parts}


def cascade_remat_check(card: str) -> dict:
    """gaze_grcn_cascade's loss and gradients (B=7, T=42, bf16, no
    dropout) in three arms: both cells on their kernels (B6 and B5, once
    each way a pass) with `remat_cells` on and off, and the bottom cell on
    its rematerialized `ConvGRU.scan` (`plain_route`). The kernels keep no
    per-step graph, so the flag changes nothing: the same loss, every
    gradient corr >= REMAT_GRAD_MIN_CORR. Through B6 against the plain
    scan, whose cuDNN convs round their sums to bf16: the loss within
    LOSS_MAX_REL, every gradient corr >= GRAD_MIN_CORR. The peak memory of
    each forward + backward."""
    model = zoo_model("gaze_grcn_cascade")
    model.cfg.dropout_keep_prob = 1.0
    raw = synthetic.make_clip_windows(7, T, seed=SEED + 4).next_batch(7)
    batch = device_put_batch(raw, torch.device("cuda"),
                             stream_casts(torch.bfloat16))
    named = [(n, p) for n, p in model.named_parameters()
             if not n.startswith("shallownet.")]
    out, routes = {}, {}
    reset_launches()
    for arm, remat in (("remat", True), ("no_remat", False),
                       ("plain_remat", True)):
        model.cfg.remat_cells = remat
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with plain_route(model, arm == "plain_remat"):
            loss, _ = model.loss(batch, train=True)
            grads = torch.autograd.grad(loss, [p for _, p in named])
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        routes[arm] = (model.last_route, model.top_route)
        out[arm] = (loss.item(), [g.float().cpu().numpy() for g in grads],
                    peak)
    model.cfg.remat_cells = True
    launches = read_launches()

    def compare(arm, against):
        rel = abs(out[arm][0] - out[against][0]) / abs(out[against][0])
        corrs = {n: corr(a, b) for (n, _), a, b in
                 zip(named, out[arm][1], out[against][1]) if a.size > 1}
        return rel, corrs

    rel, corrs = compare("remat", "no_remat")
    plain_rel, plain_corrs = compare("remat", "plain_remat")
    print(f"cascade remat check (B=7, T={T}, bf16): loss {out['remat'][0]} "
          f"(remat) vs {out['no_remat'][0]} (rel {rel:.3g}), min grad corr "
          f"{min(corrs.values()):.7f} ({min(corrs, key=corrs.get)}); "
          f"through B6 vs the bottom cell's remat scan: loss "
          f"{out['plain_remat'][0]} (rel {plain_rel:.3g}), min grad corr "
          f"{min(plain_corrs.values()):.7f} "
          f"({min(plain_corrs, key=plain_corrs.get)}); peak memory above "
          f"the weights and batch (MiB): "
          f"{json.dumps({a: round(v[2], 1) for a, v in out.items()})}; "
          f"routes (bottom, top) {json.dumps(routes)} [{card}]", flush=True)
    check(rel <= REMAT_LOSS_MAX_REL, f"cascade remat loss rel {rel}")
    check(plain_rel <= LOSS_MAX_REL,
          f"cascade loss through B6 vs the plain scan: rel {plain_rel}")
    check(routes == {"remat": ("kernel", "kernel"),
                     "no_remat": ("kernel", "kernel"),
                     "plain_remat": ("scan", "kernel")}
          and launches == {**zoo_kernel_launches("gaze_grcn_cascade", 0),
                           **cascade_launches(2, 2), "convgru_small_fwd": 3,
                           "convgru_small_bwd": 3, "convgru_wgrad": 2},
          f"cascade remat check: routes {routes}, launches {launches}")
    for n, c in corrs.items():
        check(c >= REMAT_GRAD_MIN_CORR, f"cascade remat grad {n} corr {c}")
    for n, c in plain_corrs.items():
        check(c >= GRAD_MIN_CORR,
              f"cascade grad {n} through B6 vs the plain scan: corr {c}")
    return {"loss_rel": rel, "min_corr": min(corrs.values()),
            "plain_loss_rel": plain_rel,
            "plain_min_corr": min(plain_corrs.values()),
            "peak_mib": {a: v[2] for a, v in out.items()}}


def zoo_train_step_timing(name: str, remat: bool = True) -> dict:
    """One family's train step (flip, dropout, clip + Adam) at its registry
    batch and T in bf16, by CUDA events after warm-up, with the peak
    memory of one step above the weights, optimizer state and batch."""
    model = zoo_model(name)
    model.cfg.remat_cells = remat
    b, t = model.cfg.batch_size, model.cfg.n_lstm_steps
    raw = synthetic.make_clip_windows(
        b, t, seed=SEED + 5, gazemap_hw=(model.cfg.gazemap_height,
                                         model.cfg.gazemap_width)
    ).next_batch(b)
    batch = device_put_batch(raw, torch.device("cuda"),
                             stream_casts(torch.bfloat16))
    state, tx = create_train_state(
        model, OptimizerConfig(initial_learning_rate=ZOO_LR))
    step = make_train_step(model, tx)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ms = cuda_ms(lambda: step(state, batch, gen), 5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step(state, batch, gen)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    return {"ms": ms, "peak_mib": peak, "batch": b, "t": t}


def pretrain_step_timing() -> dict:
    """One ShallowNet pretraining step (flip, dropout 0.4, clip + Adam) at
    B=128, f32 (the CLI's default) and bf16."""
    out = {}
    rng = np.random.RandomState(SEED + 6)
    images = torch.from_numpy(rng.rand(PRETRAIN_BATCH, 98, 98, 3).astype(
        np.float32)).cuda()
    maps = torch.from_numpy(rng.rand(PRETRAIN_BATCH, 49, 49).astype(
        np.float32)).cuda()
    for label, cdt in (("f32", None), ("bf16", torch.bfloat16)):
        params = {k: v.cuda().requires_grad_() for k, v in
                  shallownet.init_params(generator=torch.Generator()
                                         .manual_seed(SEED)).items()}
        step, tx = saliency.make_saliency_train_step(
            OptimizerConfig(initial_learning_rate=3e-5,
                            use_decay_schedule=False), compute_dtype=cdt)
        opt_state = tx.init(params)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        out[label] = cuda_ms(
            lambda: step(params, opt_state, images, maps, gen), 5)
    return out


def zoo_phases(card: str, tower: dict, runs: str) -> dict:
    """Phase 9, the rest of the model zoo: the cluster lines and gates of
    B1 and B2 at U=64 (C=4); predict of each family; serving
    gaze_pupil_grcn (B1) and gaze_framewise_shallownet (frames); the fused
    frame stream; the CLIs (pretraining, then grafting into gaze_rnn); the
    pupil gradients and the cascade's remat. Run files go under `runs`."""
    c4_clusters = cluster_lines(card, C4_UNITS, ("convgru_fwd",
                                                 "convgru_bwd"), C4_BATCHES)
    c4_parity = c4_kernel_gates(card)
    zoo_predict_check(card)
    pupil_served = serve_zoo_and_check(zoo_model("gaze_pupil_grcn"), card)
    framewise = zoo_model("gaze_framewise_shallownet")
    framewise_served = serve_zoo_and_check(framewise, card)
    framewise_fused = fused_framewise_check(framewise, tower, card)
    pretrained = f"{runs}/shallownet.pt"
    pretrain_through_cli(card, f"{runs}/pretrain", pretrained)
    zoo_trained = {}
    for name, extra in (("gaze_pupil_grcn", ()),
                        ("gaze_grcn_cascade", ()),
                        ("gaze_rnn", ("--shallownet_pretrain", pretrained)),
                        ("gaze_framewise_shallownet", ())):
        zoo_trained[name] = zoo_train_through_cli(
            card, f"{runs}/{name}", name, extra)
    grafted = load_params(pretrained)
    check(all(torch.equal(zoo_trained["gaze_rnn"]["params"][f"shallownet/{k}"],
                          v) for k, v in grafted.items()),
          "gaze_rnn's ShallowNet is not the pretrained file's after training")
    initial = registry.create_model(
        "gaze_framewise_shallownet", device="cpu",
        generator=torch.Generator().manual_seed(SEED)).shallownet
    moved = {k: float((zoo_trained["gaze_framewise_shallownet"]["params"][
        f"shallownet/{k}"] - initial[k].detach()).abs().max())
        for k in ("conv1_w", "conv2_w", "conv3_w", "fc1_w", "fc2_w")}
    print(f"grafting: gaze_rnn's shallownet.* bitwise the pretrained file's "
          f"after {TRAIN_STEPS} steps (frozen); gaze_framewise_shallownet's "
          f"ShallowNet max |change| {json.dumps(moved)} [{card}]", flush=True)
    check(all(v > 0 for v in moved.values()),
          f"gaze_framewise_shallownet's ShallowNet did not train: {moved}")
    pupil_grads = pupil_gradient_check(card)
    remat = cascade_remat_check(card)
    return {"c4_clusters": c4_clusters, "c4_parity": c4_parity,
            "pupil_served": pupil_served,
            "framewise_served": framewise_served,
            "framewise_fused": framewise_fused, "trained": zoo_trained,
            "pupil_grads": pupil_grads, "remat": remat}


def zoo_timings(card: str, zoo: dict, timing_rng) -> tuple:
    """The zoo's times: B1 and B2 at U=64 (C=4) beside their bounds,
    predict per family at B=16, the train step per family at its registry
    batch, a ShallowNet pretraining step, the cascade without remat, the
    zoo's HTTP latencies. Returns the U=64 kernel timings by batch."""
    c4_clusters = zoo["c4_clusters"]
    pupil = zoo_model("gaze_pupil_grcn")
    c4_fused = ConvGRU.fuse({k: v.detach() for k, v in pupil.cell.items()})
    c4_timing, c4_bwd_timing = {}, {}
    for b in C4_BATCHES:
        k = c4_timing[b] = kernel_timing(c4_fused, b, timing_rng, t=C4_T)
        print(f"timing: convgru_fwd T={C4_T} B={b} U={C4_UNITS} (C=4) bf16: "
              f"{per_step(k, C4_T)}; co-resident clusters "
              f"{c4_clusters['convgru_fwd']['bf16']['max_active_clusters']} "
              f"[{card}]", flush=True)
        k = c4_bwd_timing[b] = backward_timing(
            "convgru_bwd", b, SEED + b, t=C4_T, c=C4_C, units=C4_UNITS)
        print(f"timing: convgru_bwd T={C4_T} B={b} U={C4_UNITS} (C=4) bf16: "
              f"{per_step(k, C4_T)}; co-resident clusters "
              f"{c4_clusters['convgru_bwd']['bf16']['max_active_clusters']} "
              f"[{card}]", flush=True)
    for kernel in ("convgru_bwd_gates", "convgru_wgrad"):
        b = C4_BATCHES[0]
        k = c4_bwd_timing[kernel, b] = backward_timing(
            kernel, b, SEED + b, t=C4_T, c=C4_C, units=C4_UNITS)
        print(f"timing: {kernel} T={C4_T} B={b} U={C4_UNITS} bf16: "
              f"{per_step(k, C4_T)}, library_ms {k['library_ms']:.4f} ms "
              f"[{card}]", flush=True)
    for name in ZOO:
        m = zoo_model(name)
        frames16, c3d16z = zoo_inputs(m, ZOO_PREDICT_BATCH, SEED + 22)
        ms = cuda_ms(lambda: m.predict(frames16, c3d16z), 5)
        print(f"timing: {name} predict B={ZOO_PREDICT_BATCH} "
              f"T={m.cfg.n_lstm_steps} bf16: {ms:.3f} ms/call [{card}]",
              flush=True)
        del m, frames16, c3d16z
    for name in ZOO:
        st = zoo_train_step_timing(name)
        print(f"timing: {name} train step B={st['batch']} T={st['t']} bf16 "
              f"(flip, dropout, clip + adam): {st['ms']:.3f} ms, peak "
              f"{st['peak_mib']:.1f} MiB above weights, state and batch "
              f"[{card}]", flush=True)
    st = zoo_train_step_timing("gaze_grcn_cascade", remat=False)
    print(f"timing: gaze_grcn_cascade train step without remat "
          f"B={st['batch']} T={st['t']}: {st['ms']:.3f} ms, peak "
          f"{st['peak_mib']:.1f} MiB [{card}]", flush=True)
    pre = pretrain_step_timing()
    print(f"timing: ShallowNet pretraining step B={PRETRAIN_BATCH} (flip, "
          f"dropout, clip + adam): f32 {pre['f32']:.3f} ms, bf16 "
          f"{pre['bf16']:.3f} ms [{card}]", flush=True)
    print(f"timing: HTTP request latency, median of {N_REQUESTS} concurrent "
          f"POSTs: gaze_pupil_grcn {zoo['pupil_served']['http_ms']:.1f} ms, "
          f"gaze_framewise_shallownet "
          f"{zoo['framewise_served']['http_ms']:.1f} ms [{card}]", flush=True)
    return c4_timing, c4_bwd_timing


# ------------------------------------------------ 10. the research loop

def research_packages(card: str) -> dict:
    """The optional host packages of the research loop: h5py and Pillow
    (process_gazemap, the CRC loader, frame folders) and a video decoder
    (cv2, or imageio with imageio_ffmpeg or av). Every stage on the
    device runs without them; the host stages that need them run only
    where they import."""
    found = {}
    for name in ("h5py", "PIL", "cv2", "imageio", "imageio_ffmpeg", "av"):
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    found["decoder"] = found["cv2"] or (
        found["imageio"] and (found["imageio_ffmpeg"] or found["av"]))
    found["crc"] = found["h5py"] and found["PIL"]
    stages = ["extract_features (window helper)", "extract_map (batched, "
              "streamed)", "create_records (synthetic)",
              "action_classification (NN, SVM)", "attention re-extraction"]
    if found["decoder"]:
        stages.insert(1, "extract_features CLI on an .avi")
    if found["crc"]:
        stages += ["process_gazemap", "train_gaze --dataset crc",
                   "evaluate_gaze --dataset crc"]
    print(f"research loop packages: {json.dumps(found)} [{card}]",
          flush=True)
    print(f"research loop stages run: {stages}", flush=True)
    return found


def write_video(path: str, frames: np.ndarray) -> None:
    """RGB uint8 frames -> a video file (cv2's MJPG, else imageio's
    ffmpeg or pyav writer)."""
    try:
        import cv2
    except ImportError:
        import imageio

        imageio.mimwrite(path, list(frames), fps=10)
        return
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (w, h))
    check(writer.isOpened(), f"cv2.VideoWriter could not open {path}")
    for frame in frames:
        writer.write(np.ascontiguousarray(frame[:, :, ::-1]))
    writer.release()


def research_features(card: str, tower: dict, packages: dict,
                      work: str) -> dict:
    """extract_features' window loop (`extract_windows`) over RESEARCH_VIDEOS
    seeded uint8 videos of RESEARCH_FRAMES frames (11 windows each), bf16
    at --batch_windows 16, held against the f32 tower (TF32 off); then,
    where a decoder imports, the CLI end to end on an .avi of the first
    video against the helper on the frames it decodes."""
    videos = np.random.RandomState(SEED + 30).randint(
        0, 256, (RESEARCH_VIDEOS, RESEARCH_FRAMES, *RESEARCH_VIDEO_HW, 3),
        dtype=np.uint8)
    bf16 = {k: v.to(torch.bfloat16) for k, v in tower.items()}

    def run(params, dtype, frames, att=None):
        return np.stack(extract_features.extract_windows(
            params, frames, batch_windows=RESEARCH_BATCH_WINDOWS,
            compute_dtype=dtype, attention_maps=att, device="cuda"))

    run(bf16, "bfloat16", videos[0])  # warm-up: cuDNN picks its algorithms
    start = time.perf_counter()
    feats = [run(bf16, "bfloat16", v) for v in videos]
    seconds = time.perf_counter() - start
    f32 = [run(tower, "float32", v) for v in videos]
    n_windows = sum(len(f) for f in feats)
    a, b = np.concatenate(feats), np.concatenate(f32)
    c = corr(a, b)
    rate = n_windows / seconds
    print(f"research extract_features (extract_windows, {RESEARCH_VIDEOS} "
          f"videos x {RESEARCH_FRAMES} uint8 frames of {RESEARCH_VIDEO_HW[0]}x"
          f"{RESEARCH_VIDEO_HW[1]}, --batch_windows {RESEARCH_BATCH_WINDOWS}, "
          f"bf16): {n_windows} windows in {seconds:.3f} s host clock = "
          f"{rate:.1f} windows/s (copy, preprocess, tower, read-back); conv5b "
          f"vs the f32 tower (TF32 off): corr {c:.6f} [{card}]", flush=True)
    want = (-(-RESEARCH_FRAMES // 16), 512, 2, 7, 7)
    check(all(f.shape == want for f in feats) and bool(np.isfinite(a).all()),
          f"extract_windows shapes {[f.shape for f in feats]}")
    check(c >= MAP_MIN_CORR, f"extract_windows bf16 vs f32 corr {c}")
    out = {"feats": feats, "videos": videos, "bf16": bf16,
           "windows_per_s": rate, "corr": c}
    if packages["decoder"]:
        out["cli"] = research_features_cli(card, tower, videos[0], work, run)
    return out


def research_features_cli(card: str, tower: dict, frames: np.ndarray,
                          work: str, run) -> dict:
    """`cli.extract_features` on an .avi of `frames`, the tower from a
    params file of this package: the `.c3d` against the window helper on
    the frames the decoder gives back (MJPG is lossy)."""
    videos = f"{work}/videos"
    os.makedirs(videos)
    write_video(f"{videos}/video0.avi", frames)
    params_file = f"{work}/c3d_params.pt"
    save_params(params_file, tower)
    start = time.perf_counter()
    rc = extract_features.main(["--videos_root", videos, "--out_dir",
                                f"{work}/vid_c3d", "--params", params_file])
    seconds = time.perf_counter() - start
    check(rc == 0, f"cli.extract_features returned {rc}")
    got = codec.read_c3d_file(f"{work}/vid_c3d/video0.c3d")
    decoded = np.stack(list(video.decode_video(f"{videos}/video0.avi")))
    want = run({k: v.to(torch.bfloat16) for k, v in tower.items()},
               "bfloat16", decoded)
    c = corr(got, want)
    print(f"research cli.extract_features on an .avi ({len(decoded)} "
          f"frames decoded): .c3d {got.shape} in {seconds:.2f} s wall with "
          f"the decode and weight load; vs the helper on the decoded frames "
          f"corr {c:.6f} [{card}]", flush=True)
    check(got.shape == want.shape and c >= MAP_MIN_CORR,
          f"extract_features CLI .c3d {got.shape} vs {want.shape}, corr {c}")
    return {"seconds": seconds, "corr": c}


# frame files per clip folder: the [15::5] subsample then holds MAP_T frames,
# so a batched export writes min(frames, windows, T) = MAP_T maps per clip
MAP_FRAMES = 15 + 5 * MAP_T


def map_clips(work: str) -> tuple:
    """MAP_CLIPS clip folders of MAP_FRAMES frame JPEGs (98x98, one seeded
    image per clip), whose `.c3d` files hold MAP_WINDOWS[0]..MAP_WINDOWS[1]
    windows of seeded features."""
    from PIL import Image

    root = f"{work}/clips"
    rng = np.random.RandomState(SEED + 31)
    lengths = [int(n) for n in np.linspace(*MAP_WINDOWS, MAP_CLIPS)]
    for i, n in enumerate(lengths):
        os.makedirs(f"{root}/clip{i:02d}")
        jpeg = io.BytesIO()
        Image.fromarray(rng.randint(0, 256, (98, 98, 3)).astype(
            np.uint8)).save(jpeg, format="JPEG")
        for f in range(MAP_FRAMES):
            with open(f"{root}/clip{i:02d}/{f:06d}.jpg", "wb") as out:
                out.write(jpeg.getvalue())
        codec.write_c3d_file(f"{root}/clip{i:02d}.c3d", list(
            rng.randn(n, 512, 2, 7, 7).astype(np.float32)))
    return root, lengths


def restore_for_maps(run: str):
    """The run's model as `cli.extract_map` restores it (T=MAP_T,
    B=MAP_BATCH)."""
    exp = Checkpointer.load_config(run)
    model = registry.create_model(exp.model.name, exp.model, device="cuda",
                                  n_lstm_steps=MAP_T, batch_size=MAP_BATCH)
    state, _ = create_train_state(model, exp.optimizer)
    check(Checkpointer(run).restore_latest(state) is not None,
          f"no checkpoint under {run}")
    return model


def max_rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def research_maps(card: str, run: str, clips: str, lengths: list,
                  work: str) -> dict:
    """`cli.extract_map` on a run of `cli.train_gaze`, batched (T=105,
    B=4: two predict calls, the model's forward kernel once each) and
    `--streaming` (chunks of 42: one launch per chunk); the maps against
    the plain path, the batched ones summing to 1; times per clip."""
    name = Checkpointer.load_config(run).model.name
    kernel = FORWARD_KERNEL[name]
    result = {}
    for mode, extra, want in (
            ("batched", [], -(-MAP_CLIPS // MAP_BATCH)),
            ("streamed", ["--streaming"],
             sum(-(-n // STREAM_CHUNK) for n in lengths))):
        out = f"{work}/maps_{name}_{mode}"
        reset_launches()
        start = time.perf_counter()
        rc = extract_map.main(["--train_dir", run, "--clips_root", clips,
                               "--out_dir", out] + extra)
        launches = read_launches()
        seconds = time.perf_counter() - start
        check(rc == 0, f"cli.extract_map {name} {mode} returned {rc}")
        print(f"research cli.extract_map {name} {mode}: {MAP_CLIPS} clips "
              f"of {lengths} windows ({MAP_FRAMES} frame files each) in "
              f"{seconds:.2f} s wall with the restore, .c3d and frame reads "
              f"= {seconds / MAP_CLIPS * 1e3:.1f} ms per clip of maps "
              f"written; launches {launches} [{card}]", flush=True)
        check(launches[kernel] == want and sum(launches.values()) == want,
              f"extract_map {name} {mode}: launches {launches}, want {want} "
              f"of {kernel}")
        result[mode] = {"out": out, "launches": launches,
                        "ms_per_clip": seconds / MAP_CLIPS * 1e3}

    model = restore_for_maps(run)
    inputs = [extract_map.load_clip_inputs(f"{clips}/clip{i:02d}",
                                           f"{clips}/clip{i:02d}.c3d", MAP_T)
              for i in range(MAP_BATCH)]
    batch = device_put_batch(
        {k: np.stack([x[k] for x in inputs]) for k in ("frames", "c3d")},
        torch.device("cuda"), stream_casts(torch.bfloat16))
    with torch.inference_mode():
        maps = model.predict(batch["frames"], batch["c3d"]).float()
        route = model.last_route
        plain = plain_predict(model, batch["c3d"]).float()
    a, b = maps.cpu().numpy(), plain.cpu().numpy()
    sums = a.reshape(MAP_BATCH, MAP_T, -1).sum(-1)
    saved = np.stack([np.load(f"{result['batched']['out']}/clip{i:02d}"
                              f".gazemap.npy") for i in range(MAP_BATCH)])
    predict_ms = cuda_ms(lambda: model.predict(batch["frames"],
                                               batch["c3d"]), 5)
    c, rel = corr(a, b), max_rel(a, b)
    print(f"research extract_map {name} batched gate (B={MAP_BATCH}, "
          f"T={MAP_T}, route {route}): corr {c:.6f}, max_rel_delta "
          f"{rel:.4g} vs the plain scan; map sums in [{sums.min():.6f}, "
          f"{sums.max():.6f}]; predict {predict_ms:.3f} ms per call = "
          f"{predict_ms / MAP_BATCH:.3f} ms per clip (CUDA events) [{card}]",
          flush=True)
    check(route == "kernel", f"extract_map {name}: route {route}")
    check(a.shape == (MAP_BATCH, MAP_T, 49, 49) and bool(np.isfinite(a).all())
          and c >= MAP_MIN_CORR and rel <= MAP_MAX_REL_DELTA,
          f"extract_map {name} batched: corr {c}, max_rel_delta {rel}")
    check(bool(np.abs(sums - 1.0).max() <= 1e-3), f"extract_map {name}: "
          f"map sums {sums.min()}..{sums.max()}")
    # every clip has MAP_T maps: min(frames, windows, T) with MAP_FRAMES
    # frame files and at least MAP_T windows
    check(saved.shape == a.shape, f"extract_map {name}: saved maps "
                                  f"{saved.shape}, predicted {a.shape}")
    saved_delta = float(np.abs(saved.astype(np.float32) - a).max())
    check(np.allclose(saved.astype(np.float32), a, rtol=1e-3, atol=1e-6),
          f"extract_map {name}: saved float16 maps differ from the predict "
          f"by up to {saved_delta} (max map value {np.abs(a).max()})")

    streamed = {}
    for i in (0, MAP_CLIPS - 1):
        feats = codec.load_c3d_for_model(f"{clips}/clip{i:02d}.c3d")
        got = np.load(f"{result['streamed']['out']}/clip{i:02d}.gazemap.npy"
                      ).astype(np.float32)
        full = plain_logits(model, torch.from_numpy(feats[None]).cuda())
        full = full[0].float().cpu().numpy()
        streamed[i] = (corr(got, full), max_rel(got, full))
        check(got.shape == full.shape == (lengths[i], 49, 49)
              and streamed[i][0] >= MAP_MIN_CORR
              and streamed[i][1] <= MAP_MAX_REL_DELTA,
              f"extract_map {name} streamed clip {i}: {got.shape}, corr / "
              f"max_rel_delta {streamed[i]}")
    feats = codec.load_c3d_for_model(f"{clips}/clip{MAP_CLIPS - 1:02d}.c3d")
    extract_map.stream_clip(model, feats, STREAM_CHUNK)  # warm
    torch.cuda.synchronize()
    start = time.perf_counter()
    extract_map.stream_clip(model, feats, STREAM_CHUNK)
    stream_ms = (time.perf_counter() - start) * 1e3
    print(f"research extract_map {name} streamed gate (whole clips against "
          f"one plain pass): clip 0 ({lengths[0]} windows) and clip "
          f"{MAP_CLIPS - 1} ({lengths[-1]}) corr / max_rel_delta "
          f"{json.dumps(streamed)}; {lengths[-1]} windows streamed in "
          f"{stream_ms:.2f} ms host clock ({-(-lengths[-1] // STREAM_CHUNK)} "
          f"chunks) [{card}]", flush=True)
    result.update(gate={"corr": c, "max_rel_delta": rel}, route=route,
                  predict_ms=predict_ms, stream_ms=stream_ms)
    return result


def research_records(card: str, run: str, work: str) -> dict:
    """`cli.create_records` on the gaze_grcn CLI run (synthetic corpus,
    the run's T=42 and B=28: one predict call, one B1 launch) with
    Hollywood2 ClipSets labels, then `cli.action_classification`: NN with
    the predicted maps as attention for ACTION_NN_STEPS steps and SVM
    for ACTION_SVM_STEPS; the losses and ms per step from the classifier
    driven as the CLI drives it."""
    clipsets = f"{work}/ClipSets"
    os.makedirs(clipsets)
    for k in range(13):  # clip i has classes i % 13 and (3i + 1) % 13
        for split in ("train", "test"):
            with open(f"{clipsets}/class{k:02d}_{split}.txt", "w") as f:
                for s in range(3):
                    for i in range(8):
                        label = 1 if k in (i % 13, (3 * i + 1) % 13) else -1
                        f.write(f"synthetic_{s}_{i:04d} {label}\n")
    records = f"{work}/records"
    reset_launches()
    start = time.perf_counter()
    rc = create_records.main(["--train_dir", run, "--out_dir", records,
                              "--clipsets_dir", clipsets])
    launches = read_launches()
    seconds = time.perf_counter() - start
    check(rc == 0, f"cli.create_records returned {rc}")
    shards = sorted(os.listdir(records))
    shard = read_record_shard(f"{records}/{shards[0]}")
    n = len(shard["c3d"])
    sums = shard["gaze_pred"].reshape(n, -1).sum(-1)
    print(f"research cli.create_records (synthetic train split, 8 clips of "
          f"T={T}, B={TRAIN_BATCH}): {len(shards)} shard(s), {n} frames, "
          f"{seconds:.2f} s wall per batch with the restore and the "
          f"compressed shard write; launches {launches}; gaze_pred sums in "
          f"[{sums.min():.5f}, {sums.max():.5f}] [{card}]", flush=True)
    check(launches["convgru_fwd"] == 1 and sum(launches.values()) == 1,
          f"create_records launches {launches}")
    check(n == 8 * T and shard["c3d"].shape == (n, 1024, 7, 7)
          and shard["gaze_pred"].shape == (n, 49, 49)
          and shard["labels"].shape == (n, 13)
          and bool((shard["labels"].sum(-1) >= 1).all())
          and bool(np.abs(sums - 1).max() <= 1e-3),
          f"record shard {[(k, v.shape) for k, v in shard.items()]}")

    scores = {}
    for head, steps, extra in (("NN", ACTION_NN_STEPS, ["--use_gazemap"]),
                               ("SVM", ACTION_SVM_STEPS, [])):
        out = f"{work}/action_{head}.json"
        start = time.perf_counter()
        rc = action_classification.main(
            ["--records_glob", f"{records}/train-*.npz", "--head", head,
             "--max_iter", str(steps), "--out", out] + extra)
        cli_s = time.perf_counter() - start
        check(rc == 0, f"cli.action_classification {head} returned {rc}")
        with open(out) as f:
            scores[head] = json.load(f)
        hp = ActionHParams(head=head, use_gazemap=head == "NN",
                           max_iter=steps)
        clf = ActionClassifier(hp, device="cuda")

        def endless():
            epoch = 0
            while True:
                yield from iter_record_batches(
                    [f"{records}/{s}" for s in shards], hp.batch_size,
                    shuffle_seed=epoch)
                epoch += 1

        start = time.perf_counter()
        losses = clf.fit(endless())
        fit_ms = (time.perf_counter() - start) / steps * 1e3
        batch = batch_to(next(iter_record_batches(
            [f"{records}/{shards[0]}"], hp.batch_size)),
            torch.device("cuda"))
        step = action_train_step(hp, clf.tx)
        step_ms = cuda_ms(lambda: step(clf.params, clf.opt_state, batch), 20)
        first, last = statistics.mean(losses[:10]), statistics.mean(
            losses[-10:])
        summary = {k: v for k, v in scores[head].items()
                   if k != "per_class_ap"}
        print(f"research action_classification {head}"
              f"{' --use_gazemap' if extra else ''} ({steps} steps, B="
              f"{hp.batch_size}): CLI {cli_s:.2f} s wall, scores "
              f"{json.dumps(summary)}; "
              f"the classifier's losses mean of the first 10 {first:.5f} -> "
              f"last 10 {last:.5f}; {fit_ms:.3f} ms per step with the shard "
              f"reads (host clock), {step_ms:.3f} ms per step on a resident "
              f"batch (CUDA events) [{card}]", flush=True)
        # the NN head must learn; the SVM's hinge at C=50 and SGD 0.01 (the
        # reference's settings) takes steps far larger than its margins, so
        # its loss need only stay finite
        check(all(np.isfinite(losses)) and (head == "SVM" or last < first),
              f"action {head} losses: {first} -> {last}")
        check(np.isfinite(scores[head]["mean_average_precision"]),
              f"action {head} mAP {scores[head]}")
        scores[head]["step_ms"] = step_ms
    return {"launches": launches, "seconds": seconds, "scores": scores}


def research_attention(card: str, features: dict, maps_dir: str) -> dict:
    """The attention variant: the first video re-extracted with an exported
    `.gazemap.npy` as its attention maps; the features differ from the
    plain ones."""
    maps = np.load(f"{maps_dir}/clip00.gazemap.npy")
    att = extract_features.normalize_attention(maps)
    got = np.stack(extract_features.extract_windows(
        features["bf16"], features["videos"][0],
        batch_windows=RESEARCH_BATCH_WINDOWS, attention_maps=att,
        device="cuda"))
    plain = features["feats"][0]
    rel = max_rel(got, plain)
    print(f"research attention re-extraction ({len(maps)} exported map(s) "
          f"of clip00): conv5b {got.shape}, max rel delta vs the plain "
          f"features {rel:.4g} [{card}]", flush=True)
    check(got.shape == plain.shape and bool(np.isfinite(got).all())
          and rel > 1e-3, f"attention features {got.shape}, rel {rel}")
    return {"max_rel_delta": rel}


def crc_layout(root: str) -> None:
    """CRC_CLIPS clip folders in the reference's layout: CRC_FRAMES frame
    JPEGs (98x98), a raw gaze .mat (3 users' one-hot maps at 36x48 and
    pupil traces) and a `.c3d` of seeded features."""
    import h5py
    from PIL import Image

    rng = np.random.RandomState(SEED + 32)
    for sub in ("vid_frm", "gazemap", "vid_c3d"):
        os.makedirs(f"{root}/{sub}")
    for ci in range(CRC_CLIPS):
        clip = f"clip{ci:05d}"
        os.makedirs(f"{root}/vid_frm/{clip}")
        for fi in range(CRC_FRAMES):
            Image.fromarray(rng.randint(0, 256, (98, 98, 3)).astype(
                np.uint8)).save(f"{root}/vid_frm/{clip}/{fi:06d}.jpg")
        with h5py.File(f"{root}/gazemap/{clip}.mat", "w") as mat:
            grp = mat.create_group("data")
            for ui in range(3):
                user = grp.create_group(f"user{ui:02d}")
                raw = np.zeros((CRC_FRAMES, 36, 48), np.uint8)
                raw[np.arange(CRC_FRAMES), rng.randint(0, 36, CRC_FRAMES),
                    rng.randint(0, 48, CRC_FRAMES)] = 1
                user["gazemap"] = raw
                user["pupilsize"] = rng.rand(CRC_FRAMES)
        codec.write_c3d_file(f"{root}/vid_c3d/{clip}.c3d", list(
            rng.randn(CRC_FRAMES // 16, 512, 2, 7, 7).astype(np.float32)))


def research_crc(card: str, work: str) -> dict:
    """Where h5py and Pillow import: `cli.process_gazemap` on raw .mat files,
    `cli.train_gaze --dataset crc` (full width, T=42, B=2, CRC_STEPS
    steps: B1 and B2 once per step), and `cli.evaluate_gaze` on the valid
    split (device metrics, then the NumPy protocol with the fixation maps
    at their original 36x48)."""
    import h5py

    root = f"{work}/crc"
    crc_layout(root)
    rc = process_gazemap.main(["--glob", f"{root}/gazemap/*.mat",
                               "--num_agents", "1"])
    check(rc == 0, f"cli.process_gazemap returned {rc}")
    with h5py.File(f"{root}/gazemap/clip00000.mat", "r") as mat:
        keys = sorted(mat["data"]["user00"].keys())
    check({"gazemap49x49", "gazemap7x7", "fixation_t"} <= set(keys),
          f"process_gazemap keys {keys}")
    run = f"{work}/crc_run"
    reset_launches()
    start = time.perf_counter()
    rc = train_gaze.main(["--dataset", "crc", "--data_root", root,
                          "--batch_size", "2", "--n_lstm_steps", str(T),
                          "--compute_dtype", "bfloat16",
                          "--max_steps", str(CRC_STEPS),
                          "--steps_per_logprint", "1", "--train_dir", run])
    launches = read_launches()
    seconds = time.perf_counter() - start
    check(rc == 0, f"cli.train_gaze --dataset crc returned {rc}")
    with open(f"{run}/metrics.jsonl") as f:
        losses = [json.loads(line)["loss/train"] for line in f
                  if "loss/train" in line]
    print(f"research cli.train_gaze --dataset crc ({CRC_CLIPS} clips, B=2, "
          f"T={T}, bf16, {CRC_STEPS} steps, {seconds:.1f} s wall with the "
          f"loader): losses {[round(x, 4) for x in losses]}, launches "
          f"{launches} [{card}]", flush=True)
    check(len(losses) == CRC_STEPS and all(np.isfinite(losses)),
          f"crc losses {losses}")
    # B2 once per step; B1 once per step and per batch of any evaluation
    # the cadences run
    check(launches["convgru_bwd"] == CRC_STEPS
          and launches["convgru_fwd"] >= CRC_STEPS
          and launches["convgru_bwd_mono"] == launches["convlstm_fwd"] == 0,
          f"crc train launches {launches}")
    overall = {}
    for tag, extra in (("device", []), ("numpy", ["--numpy_protocol"])):
        reset_launches()
        rc = evaluate_gaze.main(["--train_dir", run, "--data_root", root,
                                 "--out_dir", f"{run}/eval_{tag}",
                                 "--metrics", "cc", "sim", "nss", "AUC_Judd"]
                                + extra)
        eval_launches = read_launches()
        check(rc == 0, f"cli.evaluate_gaze crc {tag} returned {rc}")
        with open(f"{run}/eval_{tag}/overall.txt") as f:
            overall[tag] = {k: float(v) for k, v in
                            (line.strip().split(": ") for line in f)}
        print(f"research cli.evaluate_gaze --dataset crc ({tag} protocol): "
              f"{json.dumps(overall[tag])}, launches {eval_launches} "
              f"[{card}]", flush=True)
        check(all(np.isfinite(v) for v in overall[tag].values())
              and eval_launches["convgru_fwd"] >= 1,
              f"evaluate_gaze crc {tag}: {overall[tag]}, {eval_launches}")
    return {"launches": launches, "losses": losses, "overall": overall}


def research_loop_phases(card: str, tower: dict, runs: str) -> dict:
    """Phase 10, the reference's research loop on the card: C3D feature
    extraction, gaze-map export of both models' CLI runs (batched and
    streamed), record shards, the action classifier, the attention
    re-extraction, and, where h5py and Pillow import, the CRC stages."""
    packages = research_packages(card)
    work = f"{runs}/research"
    os.makedirs(work)
    features = research_features(card, tower, packages, work)
    clips, lengths = map_clips(work)
    maps = {name: research_maps(card, f"{runs}/{run}", clips, lengths, work)
            for name, run in (("gaze_grcn", "grcn"), ("gaze_lstm", "lstm"))}
    records = research_records(card, f"{runs}/grcn", work)
    attention = research_attention(card, features,
                                   maps["gaze_grcn"]["batched"]["out"])
    crc = research_crc(card, work) if packages["crc"] else None
    return {"packages": packages, "features": features, "maps": maps,
            "records": records, "attention": attention, "crc": crc}


# ------------------------------------------- slice 12: a port-only workflow

SALICON_IMAGES = 160   # 128 train images after the 80/20 split: B=128
PROFILE_STEPS = 5
PROFILE_MAX_STEPS = 8  # the window opens at step 3: steps 3..7 are traced
TOP_OPS = 5


def export_through_cli(card: str, run: str, tower_npz: str, out: str,
                       stream: bool):
    """`cli.export_serving` of a `cli.train_gaze` run with the tower's
    weights (`--caffemodel` .npz), bf16 features and uint8 video on the
    wire, and the stream program where asked; returns the loaded bundle's
    model."""
    argv = ["--train_dir", run, "--out_dir", out, "--caffemodel", tower_npz,
            "--video_dtype", "uint8", "--wire_dtype", "bfloat16"]
    if stream:
        argv += ["--stream_chunk_len", str(STREAM_CHUNK)]
    start = time.perf_counter()
    rc = export_serving.main(argv)
    seconds = time.perf_counter() - start
    check(rc == 0, f"cli.export_serving {run} returned {rc}")
    model = load_bundle(out, device="cuda")
    programs = model.bundle_programs
    want = {"predict", "fused"} | ({"stream"} if stream else set())
    print(f"export (cli.export_serving {os.path.basename(run)}: "
          f"{model.cfg.name}, T={model.cfg.n_lstm_steps}, {seconds:.2f} s "
          f"wall with the restore): programs {sorted(programs)}, predict "
          f"wire {programs['predict']['wire_dtype']}, fused "
          f"{programs['fused']['video_dtype']} F="
          f"{programs['fused']['num_frames']} [{card}]", flush=True)
    check(set(programs) == want
          and programs["predict"]["wire_dtype"] == "bfloat16"
          and programs["fused"]["video_dtype"] == "uint8"
          and programs["fused"]["num_frames"] == FUSED_FRAMES
          and model.cfg.n_lstm_steps == T,
          f"exported bundle {out}: {programs}")
    return model


def trace_summary(log_dir: str) -> dict:
    """The profiler window written to `log_dir`: its span (all events),
    the device's busy time (the union of kernel intervals) and idle share
    1 - busy / span, and the kernels with the most device time."""
    import glob

    (path,) = glob.glob(f"{log_dir}/*.pt.trace.json")
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    start = min(e["ts"] for e in events)
    span = max(e["ts"] + e["dur"] for e in events) - start
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                     for e in events if e.get("cat") == "kernel")
    busy, end = 0.0, -np.inf
    by_name: dict = {}
    for lo, hi, name in kernels:
        busy += max(hi - max(lo, end), 0.0)
        end = max(end, hi)
        by_name[name] = by_name.get(name, 0.0) + (hi - lo) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_OPS]
    return {"window_ms": span / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / span, "kernels": len(kernels),
            "names": set(by_name),
            "top_ms": {name[:90]: round(ms, 4) for name, ms in top}}


def print_window(label: str, window: dict, card: str) -> None:
    print(f"profile {label}: window {window['window_ms']:.3f} ms, device "
          f"busy {window['busy_ms']:.3f} ms in {window['kernels']} kernels, "
          f"device idle share {window['idle_share']:.4f}; top device "
          f"operations (ms): {json.dumps(window['top_ms'])} [{card}]",
          flush=True)


def export_phases(card: str, tower: dict, runs: str, frames: np.ndarray,
                  c3d: np.ndarray, videos: np.ndarray) -> dict:
    """Phase 11: `cli.export_serving` of the gaze_grcn (with the stream
    program) and gaze_lstm CLI runs of phase 5 with the tower's weights,
    each bundle loaded and served over HTTP: 8 concurrent `predict` POSTs
    and 8 `fused` POSTs at F=160 against the plain path, launches counted;
    a profiler window over one more round of gaze_grcn's predict POSTs."""
    work = f"{runs}/export"
    os.makedirs(work)
    tower_npz = f"{work}/c3d_params.npz"
    np.savez(tower_npz, **c3d_params_to_jax(tower))
    out = {}
    for name, run, stream in (("gaze_grcn", "grcn", True),
                              ("gaze_lstm", "lstm", False)):
        bundle = f"{work}/{run}_bundle"
        model = export_through_cli(card, f"{runs}/{run}", tower_npz, bundle,
                                   stream)
        check(model.cfg.name == name, f"exported {model.cfg.name}")
        profile_dir = f"{work}/serve_profile" if stream else None
        served = serve_and_check(model, frames, c3d, card, bundle=bundle,
                                 profile_dir=profile_dir)
        fused = fused_serve_and_check(model, tower, videos, card,
                                      bundle=bundle)
        print(f"export {name}: served from the exported bundle, HTTP "
              f"median of {N_REQUESTS} concurrent POSTs: predict "
              f"{served['http_ms']:.1f} ms (bf16 wire), fused "
              f"{fused['http_ms']:.1f} ms (uint8, F={FUSED_FRAMES}); "
              f"launches predict {served['launches']}, fused "
              f"{fused['launches']} [{card}]", flush=True)
        out[name] = {"predict": served, "fused": fused}
    window = trace_summary(f"{work}/serve_profile")
    print_window(f"serving window (gaze_grcn exported bundle, {N_REQUESTS} "
                 f"concurrent predict POSTs)", window, card)
    check(any("convgru_fwd_kernel" in n for n in window["names"]),
          f"the serving window holds no B1 kernel: {window['top_ms']}")
    out["window"] = window
    return out


def salicon_layout(root: str) -> None:
    """A SALICON tree in the reference's layout: SALICON_IMAGES 98x98 JPEG
    images (the synthetic corpus's frames), their 49x49 saliency maps
    (its gaze maps, scaled to 0..255) and `.npy` fixation maps (each map's
    peak)."""
    from PIL import Image

    clips = synthetic.make_clip_windows(SALICON_IMAGES // 8, 8,
                                        seed=SEED + 40)
    images = (clips.frames.reshape(-1, 98, 98, 3) * 255).round().astype(
        np.uint8)
    maps = clips.gazemaps.reshape(-1, 49, 49)
    maps = (maps / maps.max(axis=(1, 2), keepdims=True) * 255).astype(
        np.uint8)
    dirs = [f"{root}/images/train98x98", f"{root}/saliencymaps/train49x49",
            f"{root}/fixations/train"]
    for d in dirs:
        os.makedirs(d)
    for i in range(SALICON_IMAGES):
        name = f"img{i:04d}.jpg"
        Image.fromarray(images[i]).save(f"{dirs[0]}/{name}")
        Image.fromarray(maps[i]).save(f"{dirs[1]}/{name}")
        np.save(f"{dirs[2]}/{name}.npy", (maps[i] == maps[i].max()).astype(
            np.uint8))


def salicon_through_cli(card: str, runs: str) -> dict:
    """Phase 12: `cli.pretrain_shallownet --dataset salicon` on a SALICON
    tree, 20 steps at B=128: the loss falls, nothing launches a kernel,
    the params file is ShallowNet's."""
    root, run, out = (f"{runs}/salicon", f"{runs}/salicon_run",
                      f"{runs}/salicon_sn.pt")
    start = time.perf_counter()
    salicon_layout(root)
    layout_s = time.perf_counter() - start
    reset_launches()
    start = time.perf_counter()
    rc = pretrain_shallownet.main(
        ["--dataset", "salicon", "--salicon_root", root, "--max_steps",
         str(TRAIN_STEPS), "--batch_size", str(PRETRAIN_BATCH),
         "--steps_per_logprint", "1", "--out", out, "--train_dir", run])
    seconds = time.perf_counter() - start
    launches = read_launches()
    check(rc == 0, f"cli.pretrain_shallownet --dataset salicon returned {rc}")
    losses, steps = train_records(run)
    print(f"salicon (cli.pretrain_shallownet --dataset salicon, "
          f"{SALICON_IMAGES} images laid out in {layout_s:.2f} s, 80/20 "
          f"split, B={PRETRAIN_BATCH}, {TRAIN_STEPS} steps, {seconds:.1f} s "
          f"wall with the loader): losses {[round(x, 5) for x in losses]}, "
          f"launches {launches} [{card}]", flush=True)
    check_learned("pretrain_shallownet --dataset salicon", losses, steps,
                  TRAIN_STEPS)
    check(sum(launches.values()) == 0, f"pretraining launched {launches}")
    check(set(load_params(out)) == set(shallownet.init_params()),
          f"{out}: not ShallowNet's params")
    return {"losses": losses, "seconds": seconds}


def profile_through_cli(card: str, runs: str) -> dict:
    """Phase 13: `cli.train_gaze --profile_steps 5` at full width, B=28: a
    trace under {train_dir}/profile naming B1 and B2, its device idle
    share and top device operations."""
    run = f"{runs}/profiled"
    reset_launches()
    rc = train_gaze.main(
        ["--dataset", "synthetic", "--batch_size", str(TRAIN_BATCH),
         "--synthetic_clips", str(2 * TRAIN_BATCH), "--n_lstm_steps", str(T),
         "--compute_dtype", "bfloat16", "--max_steps",
         str(PROFILE_MAX_STEPS), "--seed", str(SEED), "--profile_steps",
         str(PROFILE_STEPS), "--train_dir", run])
    launches = read_launches()
    check(rc == 0, f"cli.train_gaze --profile_steps returned {rc}")
    window = trace_summary(f"{run}/profile")
    print_window(f"train window (cli.train_gaze --profile_steps "
                 f"{PROFILE_STEPS}, B={TRAIN_BATCH}, T={T}, bf16; launches "
                 f"over the run {launches})", window, card)
    for kernel in ("convgru_fwd_kernel", "convgru_bwd_kernel"):
        check(any(kernel in n for n in window["names"]),
              f"the train trace names no {kernel}: {window['top_ms']}")
    return window


def flop_line(label: str, kernel: dict, plain: dict, ms: float,
              card: str, extra: str = "") -> float:
    total = sum(kernel.values())
    util = mfu.mfu(total, 1e3 / ms, "cuda")
    print(f"mfu {label}: {total / 1e9:.3f} GFLOP per call through the "
          f"kernels ({', '.join(f'{k} {v / 1e9:.3f}' for k, v in kernel.items())}"
          f"), plain route {sum(plain.values()) / 1e9:.3f} GFLOP{extra}; "
          f"{ms:.3f} ms per call (CUDA events) = "
          f"{total / ms / 1e9:.2f} TFLOP/s, MFU {util:.4f} of "
          f"{mfu.peak_flops('cuda') / 1e12:.0f} TFLOP/s bf16 [{card}]",
          flush=True)
    return util


def mfu_phase(card: str, tower: dict, raw_batch: dict,
              videos: np.ndarray) -> dict:
    """Phase 14: the contractions of predict (B=16), the train step
    (B=28) and fused predict (B=8, F=160), counted by `utils/mfu.py`
    through the kernel route and through the plain route, and each call's
    MFU over its CUDA-event time."""
    check(mfu.peak_flops("cuda") is not None,
          f"no peak FLOP/s for {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda")
    model = full_width_model()
    rng = np.random.RandomState(SEED + 50)
    out = {}

    c3d8 = torch.from_numpy(rng.randn(8, T, 1024, 7, 7).astype(
        np.float32)).to(dev)
    b1 = mfu.flop_counts(model.predict, None, c3d8)["convgru_fwd"]
    check(b1 == kconv.flops(T, 8, 7, 7, UNITS, 3) == 14_566_293_504,
          f"B1's count at B=8: {b1}")
    c3d16 = torch.from_numpy(rng.randn(16, T, 1024, 7, 7).astype(
        np.float32)).to(dev)
    kernel = mfu.flop_counts(model.predict, None, c3d16)
    plain = mfu.flop_counts(plain_predict, model, c3d16)
    check(sum(kernel.values()) == sum(plain.values()),
          f"predict counts: kernel route {kernel}, plain {plain}")
    out["predict"] = flop_line(
        f"gaze_grcn predict B=16 T={T} (B1's share at B=8: "
        f"{b1 / 1e9:.3f} GFLOP)", kernel, plain,
        cuda_ms(lambda: model.predict(None, c3d16), 10), card)

    state, tx = create_train_state(model, OptimizerConfig())
    step = make_train_step(model, tx)
    batch = device_put_batch(raw_batch, dev, stream_casts(torch.bfloat16))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernel = mfu.flop_counts(step, state, batch, gen)
    with plain_route(model):
        plain = mfu.flop_counts(step, state, batch, gen)
    # V2's backward recomputes the gates (phase G, the contractions of
    # `recompute_gates`) and B2 forms dh0 through U_zr's transposed conv,
    # which plain autograd skips (h0 takes no gradient): both counted on
    # lines of their own
    with torch.no_grad():
        fused = ConvGRU.fuse(model.cell)
        xs = apply_c3d_projection(
            model.c3d_proj, batch["c3d"], keep_prob=1.0, generator=None,
            train=False, compute_dtype=torch.bfloat16).transpose(0, 1)
        wx = ConvGRU.input_gates(fused, xs, torch.bfloat16)
        h0 = ConvGRU.zero_state(TRAIN_BATCH, (7, 7), UNITS, device=dev)
        _, ys = kconv.convgru_recurrence(fused, wx, h0)
    recompute = sum(mfu.flop_counts(v1.recompute_gates, fused["Uh_zr"],
                                    fused["U_c"], wx, h0, ys).values())
    dh0 = 2 * TRAIN_BATCH * 49 * 9 * UNITS * 2 * UNITS
    check(sum(kernel.values()) == sum(plain.values()) + recompute + dh0,
          f"train step counts: kernel route {kernel}, plain {plain}, "
          f"recompute {recompute}, dh0 {dh0}")
    for name in ("convgru_bwd_gates", "convgru_bwd", "convgru_wgrad"):
        check(kernel.get(name) == kconv.flops(T, TRAIN_BATCH, 7, 7, UNITS, 3),
              f"{name}'s count {kernel}")
    out["train"] = flop_line(
        f"train step B={TRAIN_BATCH} T={T}", kernel, plain,
        cuda_ms(lambda: step(state, batch, gen), 5), card,
        f" + V2's gate recompute {recompute / 1e9:.3f} GFLOP + dh0's "
        f"transposed conv {dh0 / 1e9:.3f} GFLOP")

    fn = pipeline.make_fused_predict(model, num_frames=FUSED_FRAMES)
    video = torch.from_numpy(videos[:FUSED_TRAIN_BATCH]).to(dev)
    kernel = mfu.flop_counts(fn, tower, video)
    plain = mfu.flop_counts(plain_fused_predict, model, tower, video)
    check(sum(kernel.values()) == sum(plain.values()),
          f"fused predict counts: kernel route {kernel}, plain {plain}")
    out["fused"] = flop_line(
        f"gaze_grcn fused predict B={FUSED_TRAIN_BATCH} F={FUSED_FRAMES}",
        kernel, plain, cuda_ms(lambda: fn(tower, video), 5), card)
    return out


# ------------------------------------------------------------ the int8 tower

def int8_tower(seed: int = SEED + 60) -> dict:
    """C3D conv weights under which activations survive all eight layers
    (w / sqrt(27 Cin) and small biases, as the JAX package's fabricated
    caffemodel in tests/test_quant.py), on the card; the fc layers zero
    (no path here reads them)."""
    rng = np.random.RandomState(seed)
    params, cin = {}, 3
    for name, cout in c3d_model.CONV_LAYERS:
        params[f"{name}_w"] = (rng.randn(cout, cin, 3, 3, 3)
                               / np.sqrt(27.0 * cin)).astype(np.float32)
        params[f"{name}_b"] = (0.01 * rng.randn(cout)).astype(np.float32)
        cin = cout
    for name, d_in, d_out in c3d_model.FC_LAYERS:
        params[f"{name}_w"] = np.zeros((d_out, d_in), np.float32)
        params[f"{name}_b"] = np.zeros(d_out, np.float32)
    return {k: torch.from_numpy(v).cuda() for k, v in params.items()}


def int8_layers(qparams: dict, clips: torch.Tensor, conv, pool) -> tuple:
    """`quant.apply_int8`'s loop with the given conv and pool functions
    (the kernels or their plain versions): (conv5b NCDHW f32, each layer's
    int8 input, each pool's int8 input)."""
    names = [name for name, _ in c3d_model.CONV_LAYERS]
    xs = [float(qparams[f"{n}_xscale"]) for n in names]
    x_q = q1.quantize(clips.permute(0, 2, 3, 4, 1).float(),
                      xs[0]).contiguous()
    inputs, pool_inputs = [], []
    for i, name in enumerate(names):
        inputs.append(x_q)
        last = name == "conv5b"
        y = conv(x_q, qparams[f"{name}_wq"], qparams[f"{name}_wscale"],
                 qparams[f"{name}_b"], xs[i], None if last else xs[i + 1])
        if last:
            return y.permute(0, 4, 1, 2, 3), inputs, pool_inputs
        x_q = y
        if name in c3d_model.POOLS:
            pool_inputs.append((name, x_q))
            x_q = pool(x_q, *c3d_model.POOLS[name])
    raise AssertionError("unreachable")


def plain_int8_tower(qparams: dict, clips: torch.Tensor) -> torch.Tensor:
    """The plain int8 tower on the card (float64 convs), INT8_CHUNK clips
    per call."""
    return torch.cat([int8_layers(qparams, clips[i:i + INT8_CHUNK],
                                  q1.conv3d_int8_plain,
                                  q1.maxpool3d_int8_plain)[0]
                      for i in range(0, clips.shape[0], INT8_CHUNK)])


def int8_compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    diff = (got.float() - want.float()).abs()
    return {"equal": bool(torch.equal(got, want)),
            "differing": int((diff > 0).sum()), "elements": diff.numel(),
            "max_abs_diff": float(diff.max())}


def int8_layer_gates(card: str, qparams: dict, clips1: torch.Tensor
                     ) -> dict:
    """Q1 and Q1-pool against their plain versions, layer by layer, on one
    clip's activations at the real shapes (conv1a's input 16x112x112x3):
    bitwise, or at most INT8_MAX_STEP in INT8_MAX_SHARE of an int8
    layer's outputs (conv5b's f32: bitwise)."""
    names = [name for name, _ in c3d_model.CONV_LAYERS]
    with torch.inference_mode():
        _, inputs, pool_inputs = int8_layers(qparams, clips1,
                                             q1.conv3d_int8_plain,
                                             q1.maxpool3d_int8_plain)
        out = {}
        xs = [float(qparams[f"{n}_xscale"]) for n in names]
        for i, (name, x) in enumerate(zip(names, inputs)):
            args = (x, qparams[f"{name}_wq"], qparams[f"{name}_wscale"],
                    qparams[f"{name}_b"], xs[i],
                    None if name == "conv5b" else xs[i + 1])
            stats = int8_compare(q1.conv3d_int8(*args),
                                 q1.conv3d_int8_plain(*args))
            print(f"parity conv3d_int8 {name} x {list(x.shape)} int8 -> "
                  f"{'f32' if name == 'conv5b' else 'int8'}: "
                  f"{json.dumps(stats)} [{card}]", flush=True)
            ok = stats["equal"] or (
                name != "conv5b" and stats["max_abs_diff"] <= INT8_MAX_STEP
                and stats["differing"] <= INT8_MAX_SHARE * stats["elements"])
            check(ok, f"Q1 {name} against its plain version: {stats}")
            out[name] = stats
        for name, x in pool_inputs:
            window, stride = c3d_model.POOLS[name]
            stats = int8_compare(q1.maxpool3d_int8(x, window, stride),
                                 q1.maxpool3d_int8_plain(x, window, stride))
            print(f"parity maxpool3d_int8 after {name} x {list(x.shape)} "
                  f"window {window}: {json.dumps(stats)} [{card}]",
                  flush=True)
            check(stats["equal"], f"Q1-pool after {name}: {stats}")
            out[f"pool_{name}"] = stats
    return out


def int8_tower_gates(card: str, qparams: dict, tower: dict,
                     clips: torch.Tensor) -> dict:
    """The int8 tower through `quant.apply_int8` (Q1 8 times, Q1-pool 4
    times) at INT8_CLIPS clips against the plain int8 tower (corr >=
    MIN_CORR, max_rel_delta <= MAP_MAX_REL_DELTA: the JAX package's kernel
    gate) and against the bf16 cuDNN tower (corr > 0.995, mean rel < 0.06:
    its accuracy gate)."""
    with torch.inference_mode():
        reset_launches()
        got = quant.apply_int8(qparams, clips)
        launches = read_int8_launches()
        plain = plain_int8_tower(qparams, clips)
        bf16 = c3d_model.apply(tower, clips, compute_dtype=torch.bfloat16)
    check(launches == {"conv3d_int8": 8, "maxpool3d_int8": 4},
          f"int8 tower launches {launches}")
    a, p, r = (t.float().cpu().numpy() for t in (got, plain, bf16))
    check(a.shape == (clips.shape[0], 512, 2, 7, 7)
          and bool(np.isfinite(a).all()), f"int8 conv5b {a.shape}")
    stats = {"corr_vs_plain": corr(a, p), "max_rel_delta_vs_plain": max_rel(
        a, p), "bitwise_vs_plain": bool(np.array_equal(a, p)),
        "corr_vs_bf16": corr(a, r),
        "mean_rel_vs_bf16": float(np.abs(a - r).mean() / np.abs(r).mean()),
        "zero_share": float((a == 0).mean()), "launches": launches}
    print(f"int8 tower ({clips.shape[0]} clips, conv5b "
          f"[{clips.shape[0]},512,2,7,7]): {json.dumps(stats)} [{card}]",
          flush=True)
    check(stats["corr_vs_plain"] >= MIN_CORR
          and stats["max_rel_delta_vs_plain"] <= MAP_MAX_REL_DELTA,
          f"int8 tower against the plain int8 tower: {stats}")
    check(stats["corr_vs_bf16"] > INT8_BF16_MIN_CORR
          and stats["mean_rel_vs_bf16"] < INT8_BF16_MAX_MEAN_REL,
          f"int8 tower against the bf16 tower: {stats}")
    return stats


def int8_serve_phase(card: str, runs: str, tower: dict,
                     videos: np.ndarray) -> dict:
    """`cli.export_serving --int8 --calib_videos` of the gaze_grcn CLI run
    of phase 5 (the int8 tower's weights as a `--caffemodel` .npz, uint8
    video), calibrated on seeded .avi files; the bundle's `fused_int8`
    program served over HTTP: 8 concurrent uint8 POSTs, each reply against
    the same bundle's `fused` program on the same video (corr >= 0.98),
    Q1 8 times and Q1-pool 4 times per batcher call, B1 once."""
    work = f"{runs}/int8"
    os.makedirs(f"{work}/calib")
    rng = np.random.RandomState(SEED + 61)
    for i in range(CALIB_VIDEOS):
        write_video(f"{work}/calib/calib{i}.avi", rng.randint(
            0, 256, (CALIB_FRAMES, *VIDEO_HW, 3)).astype(np.uint8))
    tower_npz = f"{work}/c3d_int8_tower.npz"
    np.savez(tower_npz, **c3d_params_to_jax(tower))
    bundle = f"{work}/bundle"
    start = time.perf_counter()
    rc = export_serving.main([
        "--train_dir", f"{runs}/grcn", "--out_dir", bundle, "--caffemodel",
        tower_npz, "--video_dtype", "uint8", "--int8", "--calib_videos",
        f"{work}/calib", "--calib_windows", "8"])
    seconds = time.perf_counter() - start
    check(rc == 0, f"cli.export_serving --int8 returned {rc}")
    model = load_bundle(bundle, device="cuda")
    programs = model.bundle_programs
    print(f"int8 export (cli.export_serving --int8 --calib_videos, "
          f"{CALIB_VIDEOS} videos of {CALIB_FRAMES} frames, 8 windows; "
          f"{seconds:.2f} s wall with the restore and calibration): "
          f"programs {sorted(programs)}, fused_int8 "
          f"{programs.get('fused_int8')} [{card}]", flush=True)
    check({"predict", "fused", "fused_int8"} <= set(programs)
          and programs["fused_int8"]["video_dtype"] == "uint8"
          and model.bundle_qparams_int8 is not None,
          f"int8 bundle programs {programs}")
    t = pipeline.pipeline_timesteps(FUSED_FRAMES)
    server = server_from_bundle(bundle, program="fused_int8", device="cuda",
                                max_batch=32, max_wait_ms=200.0).start()
    try:
        host, port = server.address
        url = f"http://{host}:{port}/predict"
        reset_launches()
        served = post_videos(url, videos)
        launches = {**read_int8_launches(),
                    "convgru_fwd": read_launches()["convgru_fwd"]}
        calls = server.batcher.calls
        print(f"fused_int8 serving gaze_grcn: {len(videos)} concurrent uint8 "
              f"video requests, {calls} batcher calls, launches "
              f"{launches} [{card}]", flush=True)
        check(calls >= 1 and launches == {
            "conv3d_int8": 8 * calls, "maxpool3d_int8": 4 * calls,
            "convgru_fwd": calls}, f"fused_int8 launches {launches}, "
                                   f"{calls} calls")
        reference = fused_predict_fn(model)(videos).cpu().numpy()
        corrs = []
        for i, (status, maps, _) in enumerate(served):
            check(status == 200 and maps.shape == (t, 49, 49)
                  and bool(np.isfinite(maps).all()),
                  f"fused_int8 request {i}: HTTP {status}, {maps.shape}")
            corrs.append(corr(maps, reference[i]))
        print(f"fused_int8 serving gaze_grcn: all {len(videos)} replies "
              f"HTTP 200, [{t},49,49] finite; corr vs the bundle's fused "
              f"program (bf16 tower) min {min(corrs):.6f} mean "
              f"{float(np.mean(corrs)):.6f} [{card}]", flush=True)
        check(min(corrs) >= INT8_MAP_MIN_CORR, f"fused_int8 maps: {corrs}")
        again = post_videos(url, videos)
        http_ms = statistics.median(s for _, _, s in again) * 1e3
    finally:
        server.close()
    return {"model": model, "launches": launches, "http_ms": http_ms,
            "min_corr": min(corrs), "export_s": seconds}


def layer_bound(x_shape, cout: int, out_f32: bool) -> dict:
    """Q1's bound for one layer: its operations over the int8 peak, or its
    bytes (int8 input, weights, output) over the memory rate."""
    n, d, h, w, cin = x_shape
    m = n * d * h * w
    ops = q1.conv_ops(x_shape, cout)
    nbytes = m * cin + cout * 27 * cin + 8 * cout + m * cout * (
        4 if out_f32 else 1)
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gop": ops / 1e9, "mbytes": nbytes / 1e6}


def im2col(x_q: torch.Tensor, k: int) -> torch.Tensor:
    """The int8 patches [M, k] of a SAME 3x3x3 conv in the packed weights'
    (tap, ci) order, zero-padded to k columns: the library route's copy."""
    n, d, h, w, c = x_q.shape
    xp = torch.nn.functional.pad(x_q, (0, 0, 1, 1, 1, 1, 1, 1))
    sn, sd, sh, sw, _ = xp.stride()
    view = xp.as_strided((n, d, h, w, 3, 3, 3, c),
                         (sn, sd, sh, sw, sd, sh, sw, 1))
    cols = view.reshape(n * d * h * w, 27 * c)
    return cols if k == 27 * c else torch.nn.functional.pad(
        cols, (0, k - 27 * c))


def int8_timings(card: str, qparams: dict, tower: dict,
                 clips: torch.Tensor) -> dict:
    """At INT8_CLIPS clips: each layer's Q1 launch beside its bound, its
    plain version, the im2col + `torch._int_mm` (int8 x int8 -> int32)
    route to the same product and the bf16 cuDNN conv of the layer (both
    used nowhere in the port); each pool beside its plain version; the
    int8 tower, the bf16 tower and the plain int8 tower."""
    names = [name for name, _ in c3d_model.CONV_LAYERS]
    xs = [float(qparams[f"{n}_xscale"]) for n in names]
    out = {"layers": {}, "pools": {}}
    with torch.inference_mode():
        _, inputs, pool_inputs = int8_layers(qparams, clips, q1.conv3d_int8,
                                             q1.maxpool3d_int8)
        for i, (name, x) in enumerate(zip(names, inputs)):
            last = name == "conv5b"
            wq = qparams[f"{name}_wq"]
            args = (x, wq, qparams[f"{name}_wscale"], qparams[f"{name}_b"],
                    xs[i], None if last else xs[i + 1])
            plan = q1.launch_shape(tuple(x.shape), wq.shape[0], last)
            check(plan["ctas_per_sm"] >= 1, f"Q1 {name}: no CTA of {plan} "
                                             f"fits on an SM")
            row = {"ms": cuda_ms(lambda: q1.conv3d_int8(*args), 5),
                   **layer_bound(tuple(x.shape), wq.shape[0], last),
                   "plan": plan}
            # the float64 plain version over the 160 clips, INT8_CHUNK at
            # a time (whole, conv1a's float64 temporaries would not fit)
            row["plain_ms"] = cuda_ms(lambda: [q1.conv3d_int8_plain(
                x[j:j + INT8_CHUNK], *args[1:]) for j in range(
                    0, x.shape[0], INT8_CHUNK)], 1, warmup=1)
            torch.cuda.empty_cache()
            row["im2col_ms"] = cuda_ms(lambda: im2col(x, wq.shape[1]), 2,
                                       warmup=1)
            cols = im2col(x, wq.shape[1])
            row["int_mm_ms"] = cuda_ms(lambda: torch._int_mm(cols, wq.t()),
                                       3, warmup=1)
            del cols
            torch.cuda.empty_cache()
            xb = x.permute(0, 4, 1, 2, 3).to(torch.bfloat16)
            wb = tower[f"{name}_w"].to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last_3d)
            row["cudnn_bf16_ms"] = cuda_ms(lambda: torch.nn.functional.conv3d(
                xb, wb, padding=1), 3, warmup=1)
            del xb
            row["tops"] = row["gop"] / row["ms"]
            row["int_mm_tops"] = row["gop"] / row["int_mm_ms"]
            row["bound_share"] = row["bound_ms"] / row["ms"]
            out["layers"][name] = row
            print(f"timing: conv3d_int8 {name} x {list(x.shape)} int8 "
                  f"({INT8_CLIPS} clips): {row['ms']:.4f} ms "
                  f"({row['tops']:.1f} TOP/s, {row['gop']:.1f} GOP, "
                  f"{row['bound_share']:.3f} of its bound), bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}); route "
                  f"{plan['route']}, box {'x'.join(map(str, plan['box']))}, "
                  f"BN {plan['bn']}, BK {plan['bk']}, stages "
                  f"{plan['stages']}, {plan['ctas_per_sm']} CTA(s) per SM; "
                  f"plain {row['plain_ms']:.3f} ms, im2col "
                  f"{row['im2col_ms']:.3f} + torch._int_mm "
                  f"{row['int_mm_ms']:.4f} ms ({row['int_mm_tops']:.1f} "
                  f"TOP/s), cuDNN bf16 conv3d {row['cudnn_bf16_ms']:.4f} ms "
                  f"[{card}]", flush=True)
        for name, x in pool_inputs:
            window, stride = c3d_model.POOLS[name]
            nbytes = x.numel() + x.numel() // int(np.prod(stride))
            row = {"ms": cuda_ms(lambda: q1.maxpool3d_int8(x, window,
                                                           stride), 5),
                   "plain_ms": cuda_ms(lambda: q1.maxpool3d_int8_plain(
                       x, window, stride), 2, warmup=1),
                   "bound_ms": nbytes / PEAK_BYTES * 1e3,
                   "bound_by": "bytes"}
            out["pools"][name] = row
            print(f"timing: maxpool3d_int8 after {name} x {list(x.shape)} "
                  f"window {window}: {row['ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms (bytes), plain "
                  f"{row['plain_ms']:.3f} ms [{card}]", flush=True)
        del inputs, pool_inputs
        torch.cuda.empty_cache()
        tower_ms = {"int8": [], "bf16": []}
        for label in ("bf16", "int8", "int8", "bf16"):
            fn = ((lambda: quant.apply_int8(qparams, clips)) if label ==
                  "int8" else (lambda: c3d_model.apply(
                      tower, clips, compute_dtype=torch.bfloat16)))
            tower_ms[label].append(cuda_ms(fn, 5))
        out["tower"] = {
            "int8_ms": float(np.mean(tower_ms["int8"])),
            "bf16_ms": float(np.mean(tower_ms["bf16"])),
            "plain_ms": cuda_ms(lambda: plain_int8_tower(qparams, clips), 1,
                                warmup=1),
            "bound_ms": tower_flops(clips.shape[0]) / PEAK_INT8_OPS * 1e3,
            "runs": tower_ms}
    tw = out["tower"]
    print(f"timing: int8 C3D tower, {clips.shape[0]} clips (B=16, F="
          f"{FUSED_FRAMES}), in turns (bf16, int8, int8, bf16; ms): "
          f"{json.dumps(tower_ms)}; int8 {tw['int8_ms']:.3f} ms vs bf16 "
          f"cuDNN {tw['bf16_ms']:.3f} ms ({tw['bf16_ms'] / tw['int8_ms']:.2f}"
          f"x), plain int8 tower {tw['plain_ms']:.1f} ms; int8 bound "
          f"{tw['bound_ms']:.3f} ms (operations: "
          f"{tower_flops(clips.shape[0]) / 1e12:.2f} TOP) [{card}]",
          flush=True)
    return out


def int8_phases(card: str, runs: str, videos: np.ndarray) -> dict:
    """Phase 15, the int8 tower: calibrate and quantize `int8_tower()` on
    8 seeded windows, gate Q1 and Q1-pool layer by layer on one clip, the
    tower at INT8_CLIPS clips, then `fused_int8` exported and served over
    HTTP."""
    tower = int8_tower()
    rng = np.random.RandomState(SEED + 63)
    with torch.inference_mode():
        calib = c3d_model.preprocess_frames(torch.from_numpy(rng.randint(
            0, 256, (8, 16, *VIDEO_HW, 3)).astype(np.uint8)).cuda())
        qparams = quant.quantize_for_pipeline(tower, calib_clips=calib)
        clips = c3d_model.preprocess_frames(torch.from_numpy(rng.randint(
            0, 256, (INT8_CLIPS, 16, *VIDEO_HW, 3)).astype(
                np.uint8)).cuda())
    layers = int8_layer_gates(card, qparams, clips[:1])
    gates = int8_tower_gates(card, qparams, tower, clips)
    served = int8_serve_phase(card, runs, tower, videos)
    return {"tower": tower, "qparams": qparams, "clips": clips,
            "layers": layers, "gates": gates, "served": served}


def interop_phase(card: str, work: str) -> dict:
    """Phase 16, the host-side interop: a TFRecord round trip of the
    reference's action-record schema; the native libraries' build status;
    where the JPEG decoder built, a frame folder through
    `load_frame_folder(backend="native")` within one step of PIL's."""
    from PIL import Image

    rng = np.random.RandomState(SEED + 64)
    examples = [{key: (rng.rand(*shape) * (255 if dtype == np.uint8 else 1)
                       ).astype(dtype)
                 for key, (dtype, shape) in tfrecord.SCHEMA.items()}
                for _ in range(4)]
    path = f"{work}/records.tfrecord"
    tfrecord.write_reference_tfrecord(path, examples)
    back = tfrecord.read_reference_tfrecord(path)
    check(len(back) == len(examples) and all(
        np.array_equal(b[k], e[k]) for b, e in zip(back, examples)
        for k in e), "TFRecord round trip")
    print(f"tfrecord: {len(examples)} reference examples written and read "
          f"back equal ({os.path.getsize(path)} bytes) [{card}]", flush=True)
    status = native.build_status()
    for name, state in status.items():
        print(f"native: {state} (lib{name}) [{card}]", flush=True)
    out = {"native": status}
    if status["framedec"] == "built":
        folder = f"{work}/frames"
        os.makedirs(folder)
        for i in range(8):
            Image.fromarray(rng.randint(0, 256, (98, 98, 3)).astype(
                np.uint8)).save(f"{folder}/{i:06d}.jpg", quality=95)
        got = video.load_frame_folder(folder, (98, 98), backend="native")
        pil = video.load_frame_folder(folder, (98, 98))
        diff = int(np.abs(got.astype(int) - pil.astype(int)).max())
        print(f"native: 8 JPEG frames decoded by libframedec, max |native - "
              f"PIL| {diff} [{card}]", flush=True)
        check(got.shape == pil.shape and diff <= 1,
              f"native decode vs PIL: {got.shape} {pil.shape}, {diff}")
        out["decode_max_diff"] = diff
    return out


# ------------------------------------------------ 17. two ranks on one card

PAR_STEPS = 3         # sharded train steps gated against one process
PAR_TIMED = 5         # steps (and all-reduces) timed after them
PAR_PREDICT_BATCH = 16
PAR_LOSS_MAX_REL = 2e-3
PAR_METRIC_MAX_ABS = 1e-5
# SGD (momentum 0.9): its update is proportional to the gradient, so the
# params after the sharded steps hold the gradient averaging. Adam turns
# the last-bit differences of near-zero gradients (another summation
# order) into updates of +-lr: at B=8 on an H100 80GB HBM3 (700 W) its
# params differed by 5.4% of the largest weight after 3 steps
# (proj_c3d_W).
PAR_OPTIMIZER = OptimizerConfig(method="sgd")
NCCL_STEPS = 4


def parallel_batches() -> list:
    """PAR_STEPS global train batches of TRAIN_BATCH, the same in every
    process that makes them."""
    data = synthetic.make_clip_windows(TRAIN_BATCH * PAR_STEPS, T,
                                       seed=SEED + 70)
    return [{k: v for k, v in data.next_batch(TRAIN_BATCH).items()
             if k != "clipnames"} for _ in range(PAR_STEPS)]


def parallel_model(name: str = "gaze_grcn"):
    """`full_width_model` with dropout off: the ranks then compute what
    one process computes on the same global batch."""
    model = full_width_model(name)
    model.cfg.dropout_keep_prob = 1.0
    return model


def parallel_inputs() -> dict:
    rng = np.random.RandomState(SEED + 71)
    return {"c3d": rng.randn(PAR_PREDICT_BATCH, T, 1024, 7, 7).astype(
                np.float32),
            "video": rng.randint(0, 256, (1, FUSED_FRAMES, *VIDEO_HW, 3))
            .astype(np.uint8),
            "tower": c3d_model.init_params(
                torch.Generator().manual_seed(SEED + 1)),
            "maps": eval_maps(EVAL_FRAMES, SEED + 72)}


def parallel_rank(rank: int, work: str) -> int:
    """One rank of phase 17 (`chip_smoke.py --parallel-rank R DIR`,
    started by `parallel_phase` with torchrun's variables), on the mesh and
    devices DIR/mesh.json gives (two ranks on cuda:0 run over gloo, ranks
    on cards of their own over NCCL). Writes DIR/rank<R>.pt."""
    from recurrent_gaze_prediction_tpu_torch import parallel
    from recurrent_gaze_prediction_tpu_torch.ops.collectives import (
        whole_tensor)
    from recurrent_gaze_prediction_tpu_torch.parallel.sharding import (
        mean_over_data)

    with open(f"{work}/mesh.json") as f:
        layout = json.load(f)
    mesh = parallel.make_mesh(layout["data"], layout["model"],
                              devices=layout["devices"])
    build.load()
    out = {"backend": torch.distributed.get_backend()}
    model = parallel_model()
    state, tx = create_train_state(model, PAR_OPTIMIZER)
    step = parallel.make_sharded_train_step(model, tx, mesh, use_flip=False)
    batches = parallel_batches()
    reset_launches()
    losses = []
    for batch in batches:
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    out["train"] = {"losses": losses, "launches": read_launches(),
                    "params": {n: whole_tensor(p).detach().float().cpu()
                               for n, p in state.params.items()}}
    shard = parallel.shard_batch(batches[0], mesh)
    mesh.barrier()
    start = time.perf_counter()
    for _ in range(PAR_TIMED):
        float(step(state, shard)[1]["loss"])
    out["step_ms"] = (time.perf_counter() - start) / PAR_TIMED * 1e3
    grads = [torch.zeros_like(p) for p in state.params.values()]
    loss = torch.zeros((), device=mesh.device)
    mean_over_data(loss, grads, mesh)
    mesh.barrier()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(PAR_TIMED):
        mean_over_data(loss, grads, mesh)
    torch.cuda.synchronize()
    out["allreduce_ms"] = (time.perf_counter() - start) / PAR_TIMED * 1e3
    out["grad_floats"] = sum(g.numel() for g in grads)

    inputs = parallel_inputs()
    out["predict"] = {}
    for name in ("gaze_grcn", "gaze_lstm"):
        predict = parallel.make_sharded_predict(parallel_model(name), mesh)
        reset_launches()
        maps = predict(None, inputs["c3d"])
        out["predict"][name] = {"maps": maps.float().cpu(),
                                "launches": read_launches()}
    runs = []
    apply = c3d_model.apply

    def counted(params, clips, **kw):
        runs.append(clips.shape[0])
        return apply(params, clips, **kw)

    c3d_model.apply = counted
    try:
        fn = parallel.make_temporal_sharded_fused_predict(
            parallel_model(), mesh)
        if (FUSED_FRAMES // 16) % mesh.data == 0:
            out["temporal"] = {"maps": fn(inputs["tower"], inputs["video"])
                               .float().cpu(), "tower_clips": runs}
    finally:
        c3d_model.apply = apply
    pred, gt, fix, other = inputs["maps"]
    scores = parallel.make_sharded_evaluate(
        mesh, metrics=metrics_torch.ALL_METRICS)(
        pred, gt, fix, other_map=torch.from_numpy(other).cuda())
    out["evaluate"] = {m: v.cpu().numpy() for m, v in scores.items()}
    torch.save(out, f"{work}/rank{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def parallel_phase(card: str, runs: str, data: int = 2, model: int = 1,
                   devices: tuple = ("cuda:0", "cuda:0"),
                   cli: bool = True) -> dict:
    """Phase 17, multi-rank: `data` x `model` ranks on `devices` (by
    default two ranks on cuda:0 over gloo; `parallel_rank`) against one
    process here, then (`cli`) the NCCL code path of `cli.train_gaze
    --data_parallel -1` at world 1 under torchrun."""
    world = data * model
    label = f"{data}x{model} mesh on {len(set(devices))} card(s)"
    work = f"{runs}/parallel_{data}x{model}"
    os.makedirs(work)
    with open(f"{work}/mesh.json", "w") as f:
        json.dump({"data": data, "model": model, "devices": list(devices)},
                  f)
    start = time.perf_counter()
    done = run_processes([[sys.executable, os.path.abspath(__file__),
                           "--parallel-rank", str(r), work]
                          for r in range(world)], rank_envs(world),
                         timeout=300)
    seconds = time.perf_counter() - start
    rcs, logs = [rc for rc, _ in done], [log for _, log in done]
    check(rcs == [0] * world, f"parallel ranks exited {rcs}:\n"
                              + "\n".join(log[-4000:] for log in logs))
    ranks = [torch.load(f"{work}/rank{r}.pt", weights_only=False)
             for r in range(world)]
    inputs = parallel_inputs()

    # train: the same global batches in one process
    model = parallel_model()
    p0 = {n: p.detach().float().cpu().clone()
          for n, p in model.named_parameters()}
    state, tx = create_train_state(model, PAR_OPTIMIZER)
    step = make_train_step(model, tx, use_flip=False)
    dev = torch.device("cuda")
    batches = [device_put_batch(b, dev) for b in parallel_batches()]
    one = [float(step(state, b)[1]["loss"]) for b in batches]
    p_one = {n: p.detach().float().cpu().clone()
             for n, p in state.params.items()}
    one_ms = cuda_ms(lambda: float(step(state, batches[0])[1]["loss"]),
                     PAR_TIMED)
    got = [r["train"]["losses"] for r in ranks]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got[0], one))
    params = ranks[0]["train"]["params"]
    p_corr = min(corr(params[n].numpy(), p_one[n].numpy()) for n in p_one
                 if p_one[n].numel() > 1 and bool(p_one[n].std() > 0))
    p_rel = max(max_rel(params[n].numpy(), p_one[n].numpy()) for n in p_one)
    moved = {n: ((params[n] - p0[n]).numpy(), (p_one[n] - p0[n]).numpy())
             for n in p_one}
    # a parameter one process leaves unmoved (gaze_grcn's output bias: the
    # 2-D softmax ignores a constant shift) has no ratio; its sharded update
    # is held against the largest update of the model instead
    still = sorted(n for n, (_, want) in moved.items() if not want.any())
    largest = max(float(np.abs(want).max()) for _, want in moved.values())
    check(all(float(np.abs(moved[n][0]).max()) <= MAP_MAX_REL_DELTA * largest
              for n in still),
          f"sharded steps moved parameters one process leaves: {still}")
    u_corr = min(corr(*moved[n]) for n in moved
                 if n not in still and moved[n][1].size > 1)
    u_rel = max(max_rel(*moved[n]) for n in moved if n not in still)
    print(f"parallel: {label} over {ranks[0]['backend']} ({seconds:.1f} s "
          f"wall with start-up), {PAR_STEPS} sharded train steps at global "
          f"B={TRAIN_BATCH} ({TRAIN_BATCH // data} per data rank), T={T}, "
          f"bf16, SGD, flip and dropout off: losses by rank "
          f"{[[round(x, 5) for x in g] for g in got]}, one process "
          f"{[round(x, 5) for x in one]} (max rel {rel:.3g}); params after "
          f"{PAR_STEPS} steps vs one process: min corr {p_corr:.6f}, max_rel "
          f"{p_rel:.3g}; their updates: min corr {u_corr:.6f}, max_rel "
          f"{u_rel:.3g} (unmoved in both: {still}); launches per rank "
          f"{[r['train']['launches'] for r in ranks]} [{card}]", flush=True)
    check(all(g == got[0] for g in got), f"the ranks' losses differ: {got}")
    check(rel <= PAR_LOSS_MAX_REL, f"sharded losses {got[0]} vs one process "
                                   f"{one} (max rel {rel})")
    check(p_corr >= MIN_CORR and p_rel <= MAP_MAX_REL_DELTA
          and u_corr >= MIN_CORR and u_rel <= MAP_MAX_REL_DELTA,
          f"params after {PAR_STEPS} sharded steps: corr {p_corr}, max_rel "
          f"{p_rel}; updates: corr {u_corr}, max_rel {u_rel}")
    for r in ranks:
        check(r["train"]["launches"] == {
            "convgru_fwd": PAR_STEPS, **v2_backwards(PAR_STEPS),
            "convgru_bwd_mono": 0, "convlstm_fwd": 0, **cascade_launches()},
            f"a rank's launches over {PAR_STEPS} sharded steps: "
            f"{r['train']['launches']}")

    # predict, both models, B=16 split over the data ranks
    c3d = torch.from_numpy(inputs["c3d"]).cuda()
    for name in ("gaze_grcn", "gaze_lstm"):
        want = parallel_model(name).predict(None, c3d).float().cpu().numpy()
        c = [corr(r["predict"][name]["maps"].numpy(), want) for r in ranks]
        kernel = FORWARD_KERNEL[name]
        launches = [r["predict"][name]["launches"][kernel] for r in ranks]
        print(f"parallel: {name} sharded predict B={PAR_PREDICT_BATCH}, "
              f"{label}, vs one process: corr {[round(x, 6) for x in c]}, "
              f"{kernel} launches per rank {launches} [{card}]", flush=True)
        check(min(c) >= MAP_MIN_CORR and launches == [1] * world,
              f"{name} sharded predict: corr {c}, launches {launches}")

    # temporal fused predict: one F=160 video, 10 windows over the data
    # ranks (when they divide)
    windows = FUSED_FRAMES // 16
    if windows % data == 0:
        want = pipeline.make_fused_predict(parallel_model(),
                                           num_frames=FUSED_FRAMES)(
            {k: v.cuda() for k, v in inputs["tower"].items()},
            torch.from_numpy(inputs["video"]).cuda()).float().cpu().numpy()
        c = [corr(r["temporal"]["maps"].numpy(), want) for r in ranks]
        clips = [r["temporal"]["tower_clips"] for r in ranks]
        print(f"parallel: temporal fused predict of one F={FUSED_FRAMES} "
              f"video ({windows} windows), {label}, vs fused predict: corr "
              f"{[round(x, 6) for x in c]}, tower clips per rank {clips} "
              f"[{card}]", flush=True)
        check(min(c) >= MAP_MIN_CORR
              and clips == [[windows // data]] * world,
              f"temporal fused predict: corr {c}, tower clips {clips}")

    # sharded evaluate against the unsharded evaluate_batch
    pred, gt, fix, other = inputs["maps"]
    want = metrics_torch.evaluate_batch(
        *(torch.from_numpy(x).cuda() for x in (pred, gt, fix)),
        metrics=metrics_torch.ALL_METRICS,
        other_map=torch.from_numpy(other).cuda())
    worst = {}
    for m, v in want.items():
        v = v.cpu().numpy()
        for r in ranks:
            g = r["evaluate"][m]
            check(g.shape == v.shape and np.array_equal(np.isnan(g),
                                                         np.isnan(v)),
                  f"sharded {m}: shape {g.shape} or NaNs differ")
            ok = ~np.isnan(v)
            if m == "AUC_Judd":  # frame 1 is constant: the jitter's toss
                ok[1] = False
            worst[m] = max(worst.get(m, 0.0),
                           float(np.abs(g[ok] - v[ok]).max()))
    print(f"parallel: sharded evaluate of {EVAL_FRAMES} frames, {label}, vs "
          f"evaluate_batch, max |delta| per metric {json.dumps(worst)} "
          f"[{card}]", flush=True)
    check(max(worst.values()) <= PAR_METRIC_MAX_ABS,
          f"sharded evaluate: {worst}")

    out = {"train_rel": rel, "params_corr": p_corr,
           "step_ms": [r["step_ms"] for r in ranks], "one_ms": one_ms,
           "allreduce_ms": [r["allreduce_ms"] for r in ranks],
           "grad_floats": ranks[0]["grad_floats"]}
    if not cli:
        return out
    # NCCL at world 1: the CLI's mesh branch under torchrun against the
    # same run without --data_parallel (28 clips: no test-split pass)
    argv = ["--dataset", "synthetic", "--batch_size", str(TRAIN_BATCH),
            "--synthetic_clips", str(TRAIN_BATCH), "--n_lstm_steps",
            str(T), "--compute_dtype", "bfloat16", "--max_steps",
            str(NCCL_STEPS), "--steps_per_logprint", "1", "--seed",
            str(SEED)]
    plain_env = {k: v for k, v in os.environ.items()
                 if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                              "MASTER_ADDR", "MASTER_PORT")}
    start = time.perf_counter()
    (rc, stdout), = run_processes(
        [[sys.executable, "-m", "torch.distributed.run", "--standalone",
          "--nproc_per_node", "1", "-m",
          "recurrent_gaze_prediction_tpu_torch.cli.train_gaze", *argv,
          "--data_parallel", "-1", "--train_dir", f"{work}/nccl"]],
        [plain_env], timeout=300)
    nccl_s = time.perf_counter() - start
    check(rc == 0, f"torchrun cli.train_gaze --data_parallel -1 returned "
                   f"{rc}:\n{stdout[-4000:]}")
    check(train_gaze.main(argv + ["--train_dir", f"{work}/plain"]) == 0,
          "cli.train_gaze without --data_parallel failed")
    nccl, steps = train_records(f"{work}/nccl")
    plain, _ = train_records(f"{work}/plain")
    nccl_rel = max(abs(a - b) / abs(b) for a, b in zip(nccl, plain))
    mesh_line = [line for line in stdout.splitlines() if "mesh:" in line]
    print(f"parallel: torchrun --nproc_per_node 1 cli.train_gaze "
          f"--data_parallel -1 (NCCL, world 1; {nccl_s:.1f} s wall): "
          f"{mesh_line[-1].split('INFOV')[-1].strip() if mesh_line else ''}"
          f"; losses {[round(x, 5) for x in nccl]} vs without the mesh "
          f"{[round(x, 5) for x in plain]} (max rel {nccl_rel:.3g}) "
          f"[{card}]", flush=True)
    check(steps == list(range(1, NCCL_STEPS + 1)) and len(plain) == len(nccl)
          and nccl_rel <= PREFETCH_MAX_REL,
          f"NCCL world-1 losses {nccl} vs {plain}")
    check(bool(mesh_line) and "nccl" in mesh_line[-1],
          f"the torchrun run built no NCCL mesh: {mesh_line}")
    out["nccl_rel"] = nccl_rel
    return out


def fused_int8_timing(model, b: int) -> dict:
    """ms per `fused_int8` and per `fused` predict call of an exported
    bundle's model at B=b, F=FUSED_FRAMES uint8 on the card, in turns
    (fused, int8, int8, fused)."""
    video = torch.from_numpy(np.random.RandomState(SEED + 62).randint(
        0, 256, (b, FUSED_FRAMES, *VIDEO_HW, 3)).astype(np.uint8)).cuda()
    fns = {"fused": fused_predict_fn(model),
           "fused_int8": fused_int8_predict_fn(model)}
    runs = {"fused": [], "fused_int8": []}
    for label in ("fused", "fused_int8", "fused_int8", "fused"):
        runs[label].append(cuda_ms(lambda: fns[label](video), 5))
    return {k: float(np.mean(v)) for k, v in runs.items()}


def main() -> int:
    # 1. the card
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    card = card_line()
    print(card, flush=True)  # name, power limit: as nvidia-smi prints them

    # 2. build
    start = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - start:.1f} s "
          f"({build.last_build['path']})", flush=True)
    for line in build.last_build["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    cluster_lines(card)
    route_check(card)  # fault C1: widths the kernels do not take

    # 3. each kernel against its plain version, bf16 then f32 (TF32 off);
    # the cluster kernels B1 and B2 at each of CLUSTER_BATCHES
    fwd_parity = {}
    for b in CLUSTER_BATCHES:
        bf16 = convgru_parity(t=T, b=b, device="cuda")
        print(f"parity convgru_fwd bf16 B={b}: {json.dumps(bf16)}",
              flush=True)
        check(parity_ok(bf16), f"bf16 parity gate failed at B={b}: {bf16}")
        with tf32_off():
            f32 = convgru_parity(t=T, b=b, compute_dtype=torch.float32,
                                 device="cuda")
        print(f"parity convgru_fwd f32 (TF32 off) B={b}: {json.dumps(f32)}",
              flush=True)
        check(parity_ok(f32, max_rel_delta=F32_MAX_REL_DELTA),
              f"f32 parity failed at B={b} (corr >= {MIN_CORR}, "
              f"max_rel_delta <= {F32_MAX_REL_DELTA}, final h == ys[-1]): "
              f"{f32}")
        fwd_parity[b] = bf16
    bwd_parity = {}
    for kernel, batches in (("convgru_bwd", CLUSTER_BATCHES),
                            ("convgru_bwd_gates", GW_BATCHES),
                            ("convgru_wgrad", GW_BATCHES),
                            ("convgru_bwd_mono", B4_BATCHES)):
        for b in batches:
            stats = backward_parity(kernel, t=T, b=b, device="cuda")
            print(f"parity {kernel} bf16 B={b}: "
                  f"{json.dumps(stats['outputs'])}", flush=True)
            check(backward_parity_ok(stats), f"{kernel} bf16 parity gate "
                                             f"failed at B={b}: {stats}")
            with tf32_off():
                stats32 = backward_parity(kernel, t=T, b=b,
                                          compute_dtype=torch.float32,
                                          device="cuda")
            print(f"parity {kernel} f32 (TF32 off) B={b}: "
                  f"{json.dumps(stats32['outputs'])}", flush=True)
            check(backward_parity_ok(stats32,
                                     max_rel_delta=F32_MAX_REL_DELTA),
                  f"{kernel} f32 parity failed at B={b} (corr >= "
                  f"{MIN_CORR}, max_rel_delta <= {F32_MAX_REL_DELTA}): "
                  f"{stats32}")
            bwd_parity[kernel, b] = stats
    lstm_parity = {}
    for b in LSTM_BATCHES:
        bf16 = convlstm_parity(t=T, b=b, device="cuda")
        print(f"parity convlstm_fwd bf16 B={b}: {json.dumps(bf16)}",
              flush=True)
        check(parity_ok(bf16), f"convlstm_fwd bf16 parity gate failed at "
                               f"B={b} (ys and final c): {bf16}")
        with tf32_off():
            f32 = convlstm_parity(t=T, b=b, compute_dtype=torch.float32,
                                  device="cuda")
        print(f"parity convlstm_fwd f32 (TF32 off) B={b}: {json.dumps(f32)}",
              flush=True)
        check(parity_ok(f32, max_rel_delta=F32_MAX_REL_DELTA),
              f"convlstm_fwd f32 parity failed at B={b} (corr >= "
              f"{MIN_CORR}, max_rel_delta <= {F32_MAX_REL_DELTA} for ys and "
              f"final c, final h == ys[-1]): {f32}")
        lstm_parity[b] = bf16
    # B5, the cascade's top cell, at its train shape against its plain
    # versions and the control
    small_gates = small_kernel_gates(card)
    # B6, the cascade's bottom cell, the same way
    grid_gates = grid_kernel_gates(card)
    # M1, the dense layers' products, at the cascade's three layers
    m1_gates = m1_kernel_gates(card)

    # 4. serving at full width through the kernels: gaze_grcn (B1), then
    # gaze_lstm (B3)
    model = full_width_model()
    rng = np.random.RandomState(SEED)
    c3d = rng.randn(N_REQUESTS, T, 1024, 7, 7).astype(np.float32)
    frames = rng.rand(N_REQUESTS, T, 98, 98, 3).astype(np.float32)
    grcn_served = serve_and_check(model, frames, c3d, card)
    lstm_model = full_width_model("gaze_lstm")
    lstm_served = serve_and_check(lstm_model, frames, c3d, card)

    # 4b. streaming both models with the state carried
    feats = np.random.RandomState(SEED + 5).randn(
        STREAM_FRAMES, 1024, 7, 7).astype(np.float32)
    streamed = {name: stream_and_check(name, feats, card)
                for name in ("gaze_grcn", "gaze_lstm")}

    # 4c. the raw-video front: the tower's bf16 gate, then the fused
    # program of both models served over HTTP at F=160 (uint8 video)
    tower = c3d_model.init_params(torch.Generator().manual_seed(SEED + 1))
    tower_gate(tower, card)
    videos = np.random.RandomState(SEED + 16).randint(
        0, 256, (N_REQUESTS, FUSED_FRAMES, *VIDEO_HW, 3)).astype(np.uint8)
    fused_served = {m.cfg.name: fused_serve_and_check(m, tower, videos, card)
                    for m in (model, lstm_model)}

    # 5. training at full width: the normal entry point (B1 + B2),
    # prefetched and inline; gaze_lstm (plain scan); from raw video. 5c. evaluation: the metrics, fit's
    # cadence, and cli.evaluate_gaze on the two CLI runs
    runs_dir = tempfile.TemporaryDirectory()
    runs = runs_dir.name
    trained = train_through_cli(card, f"{runs}/grcn")
    inline = train_through_cli(card, f"{runs}/grcn_inline", prefetch=False)
    prefetch_check(trained, inline, card)
    raw_batch = synthetic.make_clip_windows(
        TRAIN_BATCH, T, seed=SEED + 3).next_batch(TRAIN_BATCH)
    batch = device_put_batch(raw_batch, torch.device("cuda"),
                             stream_casts(torch.bfloat16))
    gradient_check(full_width_model(), batch)  # 6.
    train_lstm_through_cli(card, f"{runs}/lstm")
    lstm_gradient_check(full_width_model("gaze_lstm"), batch)
    train_fused_through_cli(card)
    metrics_phase(card)
    evaluation_cadence(card)
    for run in ("grcn", "lstm"):
        evaluate_through_cli(card, f"{runs}/{run}")
    research_loop_phases(card, tower, runs)  # 10.

    zoo = zoo_phases(card, tower, runs)  # 9.
    export_phases(card, tower, runs, frames, c3d, videos)  # 11.
    salicon_through_cli(card, runs)  # 12.
    profile_through_cli(card, runs)  # 13.
    mfu_phase(card, tower, raw_batch, videos)  # 14.
    int8 = int8_phases(card, runs, videos)  # 15.
    interop_phase(card, runs)  # 16.
    par = parallel_phase(card, runs)  # 17.
    runs_dir.cleanup()

    # 7. timings
    fused = ConvGRU.fuse({k: v.detach() for k, v in model.cell.items()})
    timing_rng = np.random.RandomState(SEED + 1)
    fwd_timing = {}
    for b in CLUSTER_TIMED:
        k = fwd_timing[b] = kernel_timing(fused, b, timing_rng)
        print(f"timing: convgru_fwd T={T} B={b} U=128 bf16: {per_step(k)} "
              f"[{card}]", flush=True)
    bwd_timing = {}
    for kernel, batches in (("convgru_bwd", CLUSTER_TIMED),
                            ("convgru_bwd_gates", GW_BATCHES),
                            ("convgru_wgrad", GW_BATCHES),
                            ("convgru_bwd_mono", B4_BATCHES)):
        for b in batches:
            k = bwd_timing[kernel, b] = backward_timing(kernel, b, SEED + b)
            print(f"timing: {kernel} T={T} B={b} U=128 bf16: {per_step(k)}"
                  + "".join(f", {name} {k[name]:.4f} ms"
                            for name in B4_EXTRA_TIMES if name in k)
                  + f" [{card}]", flush=True)
    for b in B4_BATCHES:
        parts, b4_launches = b4_breakdown(b)
        print(f"timing: convgru_bwd_mono T={T} B={b} U=128 bf16, device time "
              f"per call by kernel (torch.profiler, ms): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in parts.items()) + f" [{card}]",
              flush=True)
    route = v2_route_timing(TRAIN_BATCH)
    print(f"timing: V2 backward T={T} B={TRAIN_BATCH} U=128 bf16, in turns "
          f"(ms): library stages (2 cuDNN convs + B2 + 2 matmuls) "
          f"{route['library_ms']:.4f}, G + B2 + W {route['kernels_ms']:.4f}; "
          f"runs {json.dumps(route['runs'])} [{card}]", flush=True)
    lstm_fused = ConvLSTM.fuse({k: v.detach()
                                for k, v in lstm_model.cell.items()})
    lstm_timing = {}
    for b in LSTM_TIMED:
        k = lstm_timing[b] = lstm_kernel_timing(lstm_fused, b, timing_rng)
        print(f"timing: convlstm_fwd T={T} B={b} U=128 bf16: {per_step(k)} "
              f"[{card}]", flush=True)
    small_timing = small_kernel_timing(card)
    grid_timing = grid_kernel_timing(card)
    m1_timing = m1_kernel_timing(card)
    c3d16 = torch.from_numpy(
        timing_rng.randn(16, T, 1024, 7, 7).astype(np.float32)).cuda()
    for m, served in ((model, grcn_served), (lstm_model, lstm_served)):
        name = m.cfg.name
        predict_ms = cuda_ms(lambda: m.predict(None, c3d16), 10)
        print(f"timing: {name} feature-fed predict B=16 T={T}: "
              f"{predict_ms:.3f} ms/call [{card}]")
        stages = predict_breakdown(m, c3d16)
        print(f"timing: {name} predict B=16 stages (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in stages.items()) + f" [{card}]")
        print(f"timing: {name} HTTP request latency, median of "
              f"{N_REQUESTS} concurrent single-clip POSTs: "
              f"{served['http_ms']:.1f} ms [{card}]")
    for name, st in streamed.items():
        print(f"timing: {name} streaming step, one {STREAM_CHUNK}-frame "
              f"chunk at B=1: {stream_timing(st['model']):.3f} ms [{card}]",
              flush=True)
    step = train_step_timing(full_width_model(), raw_batch)
    print(f"timing: train step B={TRAIN_BATCH} T={T} bf16 (fwd + bwd + "
          f"clip + adam, flip, dropout): kernels {step['kernels_ms']:.3f} "
          f"ms ({step['clips_per_s']:.1f} clips/s), V2 through its library "
          f"stages {step['library_stages_ms']:.3f} ms, plain autograd "
          f"{step['plain_ms']:.3f} ms ({step['plain_clips_per_s']:.1f} "
          f"clips/s); runs {json.dumps(step['runs'])} [{card}]", flush=True)
    print("timing: train step B=28 breakdown, kernel path (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in step["stages"].items()) + f" [{card}]",
          flush=True)
    lstm = full_width_model("gaze_lstm")
    lstm_state, lstm_tx = create_train_state(lstm, OptimizerConfig())
    lstm_step = make_train_step(lstm, lstm_tx)
    lstm_gen = torch.Generator(device="cuda").manual_seed(SEED)
    print(f"timing: gaze_lstm train step B={TRAIN_BATCH} T={T} bf16 (plain "
          f"autograd of ConvLSTM.scan, flip, dropout, clip + adam): "
          f"{cuda_ms(lambda: lstm_step(lstm_state, batch, lstm_gen), 5):.3f}"
          f" ms [{card}]", flush=True)

    # the raw-video front: the tower's layouts, fused predict and its
    # stages, the fused train step, the fused HTTP latency
    n_clips = 16 * (FUSED_FRAMES // 16)
    layouts = tower_layout_timing(tower, n_clips)
    tower_bound = tower_flops(n_clips) / PEAK_BF16_FLOPS * 1e3
    print(f"timing: C3D tower bf16, {n_clips} clips (B=16, F="
          f"{FUSED_FRAMES}), in turns (ms): {json.dumps(layouts)}; bound "
          f"{tower_bound:.3f} ms (operations: "
          f"{tower_flops(n_clips) / 1e12:.2f} TFLOP); the tower runs "
          f"{c3d_model.MEMORY_FORMAT} [{card}]", flush=True)
    for m in (model, lstm_model):
        name = m.cfg.name
        for b in FUSED_BATCHES:
            fp = fused_predict_timing(m, tower, b)
            frames_per_s = b * FUSED_FRAMES / fp["ms"] * 1e3
            inner = fp.pop("  of which")
            print(f"timing: {name} fused predict B={b} F={FUSED_FRAMES} "
                  f"uint8 {VIDEO_HW[0]}x{VIDEO_HW[1]}: {fp.pop('ms'):.3f} "
                  f"ms/call ({frames_per_s:.0f} raw frames/s); stages (ms): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in fp.items())
                  + "; gaze predict stages (ms): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in inner.items())
                  + f" [{card}]", flush=True)
        print(f"timing: {name} fused HTTP request latency, median of "
              f"{N_REQUESTS} concurrent uint8 video POSTs (F="
              f"{FUSED_FRAMES}): {fused_served[name]['http_ms']:.1f} ms "
              f"[{card}]", flush=True)
    for finetune in (False, True):
        ms = fused_train_step_timing(full_width_model(), finetune)
        regime = "tower fine-tuned, remat" if finetune else "tower frozen"
        print(f"timing: gaze_grcn fused train step B={FUSED_TRAIN_BATCH} "
              f"F={FUSED_FRAMES} bf16 ({regime}, flip, dropout, adam): "
              f"{ms:.3f} ms "
              f"({FUSED_TRAIN_BATCH * FUSED_FRAMES / ms * 1e3:.0f} raw "
              f"frames/s) [{card}]", flush=True)

    c4_timing, c4_bwd_timing = zoo_timings(card, zoo, timing_rng)

    # 17.'s times: two ranks share one card, so they measure the program
    # (its collectives and per-rank overhead), not the scaling
    print(f"timing: sharded train step, 2 ranks sharing one card over gloo, "
          f"global B={TRAIN_BATCH} (14 per rank), T={T}, bf16: "
          f"{', '.join(f'{x:.3f}' for x in par['step_ms'])} ms per step on "
          f"rank 0, 1 (both ranks in flight at once); one process at B="
          f"{TRAIN_BATCH}: {par['one_ms']:.3f} ms per step; the gradient "
          f"all-reduce ({par['grad_floats']} f32 over gloo, through the "
          f"host): {', '.join(f'{x:.3f}' for x in par['allreduce_ms'])} ms "
          f"per step on rank 0, 1. Two ranks on one card measure the "
          f"program, not the scaling [{card}]", flush=True)

    # the int8 tower: Q1 and Q1-pool by layer, the towers, fused_int8
    int8_timed = int8_timings(card, int8["qparams"], int8["tower"],
                              int8["clips"])
    del int8["clips"]
    for b in FUSED_BATCHES:
        ft = fused_int8_timing(int8["served"]["model"], b)
        print(f"timing: gaze_grcn fused_int8 predict B={b} F={FUSED_FRAMES} "
              f"uint8 {VIDEO_HW[0]}x{VIDEO_HW[1]} (the exported bundle), in "
              f"turns with its fused program: fused_int8 "
              f"{ft['fused_int8']:.3f} ms/call, fused {ft['fused']:.3f} "
              f"ms/call ({ft['fused'] / ft['fused_int8']:.2f}x) [{card}]",
              flush=True)
    print(f"timing: gaze_grcn fused_int8 HTTP request latency, median of "
          f"{N_REQUESTS} concurrent uint8 video POSTs (F={FUSED_FRAMES}): "
          f"{int8['served']['http_ms']:.1f} ms [{card}]", flush=True)

    # 8. result lines
    def entry(name, source, replaces, launches, err, t, **more):
        return {"name": name, "route": "cuda",
                "source": f"recurrent_gaze_prediction_tpu_torch/{source}",
                "replaces": f"recurrent_gaze_prediction_tpu/ops/pallas/"
                            f"{replaces}",
                "launches": launches, "max_abs_err": err, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"],
                "library_ms": t.get("library_ms"), **more}

    def max_err(stats):
        return max(o["max_delta"] for o in stats["outputs"].values())

    def int8_entry(name, replaces, key, rows, int8, library=False):
        gates = [v for k, v in int8["layers"].items()
                 if k.startswith("pool_") == (key == "maxpool3d_int8")]
        rows = list(rows.values())
        return {
            "name": name, "route": "cuda",
            "source": "recurrent_gaze_prediction_tpu_torch/csrc/"
                      "conv3d_int8.cu",
            "replaces": f"recurrent_gaze_prediction_tpu/{replaces}",
            "launches": int8["served"]["launches"][key],
            "max_abs_err": max(g["max_abs_diff"] for g in gates),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": ("operations" if sum(
                r["bound_by"] == "operations" for r in rows) * 2 > len(rows)
                else "bytes"),
            "library_ms": (sum(r["im2col_ms"] + r["int_mm_ms"] for r in rows)
                           if library else None),
            **({"library_bf16_cudnn_ms": sum(r["cudnn_bf16_ms"]
                                             for r in rows)}
               if library else {}),
            "calls": f"{len(rows)} launches per tower call, {INT8_CLIPS} "
                     f"clips"}

    print(json.dumps({"kernels": [
        entry("convgru_fwd", "csrc/convgru_fwd.cu", "convgru.py:45",
              grcn_served["launches"]["convgru_fwd"],
              fwd_parity[8]["max_delta"], fwd_timing[8]),
        entry("convgru_bwd", "csrc/convgru_bwd.cu", "convgru_vjp2.py:56",
              trained["launches"]["convgru_bwd"],
              max_err(bwd_parity["convgru_bwd", 8]),
              bwd_timing["convgru_bwd", 8]),
        # B4 is G + B2 + W, composed in its wrapper: its entry is the whole
        # backward, then one entry for each new phase
        entry("convgru_bwd_mono", "ops/kernels/convgru_vjp.py",
              "convgru_vjp.py:85", b4_launches["convgru_bwd_mono"],
              max_err(bwd_parity["convgru_bwd_mono", 8]),
              bwd_timing["convgru_bwd_mono", 8],
              phases=["convgru_bwd_gates", "convgru_bwd", "convgru_wgrad"]),
        entry("convgru_bwd_gates", "csrc/convgru_bwd_gates.cu",
              "convgru_vjp.py:102", trained["launches"]["convgru_bwd_gates"],
              max_err(bwd_parity["convgru_bwd_gates", 8]),
              bwd_timing["convgru_bwd_gates", 8]),
        entry("convgru_wgrad", "csrc/convgru_wgrad.cu", "convgru_vjp.py:113",
              trained["launches"]["convgru_wgrad"],
              max_err(bwd_parity["convgru_wgrad", 8]),
              bwd_timing["convgru_wgrad", 8]),
        entry("convlstm_fwd", "csrc/convlstm_fwd.cu", "convlstm.py:23",
              lstm_served["launches"]["convlstm_fwd"],
              max(lstm_parity[8]["max_delta"],
                  lstm_parity[8]["final_c"]["max_delta"]),
              lstm_timing[8]),
        # gaze_pupil_grcn's cell: U=64, clusters of 4, T=35, B=7
        entry("convgru_fwd_u64", "csrc/convgru_fwd.cu", "convgru.py:45",
              zoo["pupil_served"]["launches"]["convgru_fwd"],
              zoo["c4_parity"][7]["fwd"]["max_delta"], c4_timing[7]),
        entry("convgru_bwd_u64", "csrc/convgru_bwd.cu", "convgru_vjp2.py:56",
              zoo["trained"]["gaze_pupil_grcn"]["launches"]["convgru_bwd"],
              max_err(zoo["c4_parity"][7]["bwd"]), c4_bwd_timing[7]),
        # Q1 replaces no Pallas kernel: the JAX package's int8 conv is a
        # lax.conv_general_dilated. Its times are the tower's eight
        # launches at 160 clips; library_ms the same products through
        # im2col + torch._int_mm
        int8_entry("conv3d_int8", "models/quant.py:91", "conv3d_int8",
                   int8_timed["layers"], int8, library=True),
        int8_entry("maxpool3d_int8", "models/quant.py:117",
                   "maxpool3d_int8", int8_timed["pools"], int8),
        # B5 replaces no Pallas kernel: the JAX package scans the cascade's
        # top cell with lax.scan. Its times are one forward and one
        # backward at the cascade's train shape; its launches those of the
        # cascade's 20 CLI train steps and test-split evaluation
        {"name": "convgru_small", "route": "cuda",
         "source": "recurrent_gaze_prediction_tpu_torch/csrc/"
                   "convgru_small.cu",
         "replaces": None,
         "launches": sum(zoo["trained"]["gaze_grcn_cascade"]["launches"][n]
                         for n in ("convgru_small_fwd", "convgru_small_bwd")),
         "max_abs_err": small_gates["max_abs_err"],
         **{key: sum(small_timing[d][key] for d in ("fwd", "bwd"))
            for key in ("ms", "plain_ms", "bound_ms")},
         "bound_by": small_timing["bwd"]["bound_by"], "library_ms": None,
         "phases": {d: {key: small_timing[d][key] for key in
                        ("ms", "plain_ms", "bound_ms", "bound_by")}
                    for d in ("fwd", "bwd")},
         "calls": f"1 forward + 1 backward launch per cascade train step, "
                  f"T={T}, B={TRAIN_BATCH}"},
        # B6 replaces no Pallas kernel: the JAX package scans the cascade's
        # bottom cell with lax.scan. Its times are one forward and one
        # backward recursion at the cascade's train shape (phase W's
        # weight products after it are convgru_wgrad's); its launches
        # those of the cascade's 20 CLI train steps and test-split
        # evaluation
        {"name": "convgru_grid", "route": "cuda",
         "source": "recurrent_gaze_prediction_tpu_torch/csrc/"
                   "convgru_grid.cu",
         "replaces": None,
         "launches": sum(zoo["trained"]["gaze_grcn_cascade"]["launches"][n]
                         for n in ("convgru_grid_fwd", "convgru_grid_bwd")),
         "max_abs_err": grid_gates["max_abs_err"],
         **{key: sum(grid_timing[d][key] for d in ("fwd", "bwd"))
            for key in ("ms", "plain_ms", "bound_ms")},
         "bound_by": grid_timing["bwd"]["bound_by"], "library_ms": None,
         "phases": {d: {key: grid_timing[d][key] for key in
                        ("ms", "plain_ms", "bound_ms", "bound_by")}
                    for d in ("fwd", "bwd")},
         "calls": f"1 forward + 1 backward launch per cascade train step, "
                  f"T={T}, B={TRAIN_BATCH}"},
        # M1 replaces no Pallas kernel: the JAX package leaves the dense
        # products to XLA. Its times are fc1's three uses at the cascade's
        # train shape (library_ms: cuBLAS's bf16 GEMM with an f32 result);
        # its launches those of the cascade's 20 CLI train steps and
        # test-split evaluation
        {"name": "gemm_bf16", "route": "cuda",
         "source": "recurrent_gaze_prediction_tpu_torch/csrc/gemm_bf16.cu",
         "replaces": None,
         "launches": zoo["trained"]["gaze_grcn_cascade"]["m1_launches"],
         "max_abs_err": m1_gates["max_abs_err"],
         **{key: sum(m1_timing["fc1"][u][key] for u in M1_USES)
            for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
         "bound_by": m1_timing["fc1"]["forward"]["bound_by"],
         "phases": {u: {key: m1_timing["fc1"][u][key] for key in
                        ("ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms")} for u in M1_USES},
         "calls": f"{M1_STEP_LAUNCHES} launches per cascade train step "
                  f"(3 forwards, 5 gradients), fc1 "
                  f"{' x '.join(map(str, M1_SHAPES['fc1'][:2]))} -> "
                  f"{M1_SHAPES['fc1'][2]}"},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
