#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``threepu_torch``) on one GPU or more.

    python3 chip_smoke.py [--profile STEPS] [--profile-shapes SHAPES]

Phases, in order; any failure ends the script with a non-zero exit and
no result line:

1. Device: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions; exits non-zero when no GPU is visible.
2. Build: compiles ``threepu_torch/csrc/*.cu`` for sm_90a with nvcc.
3. Kernels against their plain PyTorch versions, at the shapes of the
   16x pipeline: select (k=33 over (B, 312, 312) for B = 80, 160 and 320,
   injected ties and 1e30 penalty columns, and PU-GAN's feature kNN, k=17
   over (8, 256, 256) with repeated points penalized) and FPS
   (AdaptiveLevel's 48 x 312 -> 48 and 48 x 48 -> 16, the level-2, 3 and 4
   merges, 8 x 6240 / 12480 / 24960 -> 1248 / 2496 / 4992, PU-GAN's net
   FPS, 8 x 1536 -> 1024, and the final
   re-stitch, 8 x 29952 -> 10000, with a mask and non-finite points; the
   cluster plan taken and microseconds per pick printed for each, then
   the pick chain's floor at each cluster size) must match exactly;
   interlevel (P=8, C=264, k=5: group 20, M=312, the step-4 net's level
   2; group 10, M=312; group 20, M=3120; group
   40, M=6240, the calls of levels 2, 3 and 4) must pick the same indices
   and agree to 1e-5, and so must, at the train step's shape (B = P = 16,
   M = 312), its weights output and the ``prev_feat`` gradient of its
   backward (the cluster plan and the selection's issue-slot floor are
   printed for each);
   the nearest neighbours of the Chamfer loss, one way and both ways in
   one launch, laid out by the plan ((16, 624) x (16, 624), the train
   loss, (16, 1248) x (16, 1248), the step-4 net's, and the JAX
   package's 80k output against the 80k ground truth,
   then three odd shapes: one query a cloud, one candidate, N != M) must
   match exactly, values and indices, with the plan, the clusters the
   card holds at once, the time of calls replayed back to back in a CUDA
   graph (free of the host's launch time) and the issue-slot floor
   printed beside the times; the fused edge-conv chain
   (B = 8, 80, 160 and 320 sub-patches of N = 312, k = 32, G = 12, n = 3,
   the calls of levels 1 to 4, in the main path's layout: the int32
   ``[..., 1:]`` view of a k+1 selection, the chain blocks as views of
   weights; PU-GAN's B = 8, N = 256, k = 16, G = 24; and two small odd
   shapes with n = 1 and n = 2)
   must agree to 1e-5.  Each kernel's time is printed beside its plain
   version's, the time of one PyTorch call computing the same function
   where there is one (``torch.topk`` for select, ``torch.cdist`` and a
   min each way for the Chamfer kernel), and its bound: the least time
   an H100 SXM could take, the larger of the operations over 67 TFLOP/s
   fp32 and the bytes over 3.35 TB/s.
4. End to end, with the trained weights of
   ``artifacts/prod_clean_final.npz`` and the JAX package's results
   frozen in ``tests/fixtures/torch_port_ref.npz``:

   a. Cascade replay: the 16x cascade of one 312-point patch, each step
      fed JAX's own input for it, so that no FPS near-tie can flip
      between the two.  At every level, at least 99% of the output
      rows must lie within 1e-4 of JAX's (a flipped near-tie in a
      feature-space kNN moves a few), the sub-patches must hold at
      least 99% of JAX's points, and their real counts must be JAX's.
      Run twice: on the decomposed edge convs, and with every edge conv
      on the fused chain kernel (the tight check of that kernel inside
      the net).
   b. The pipeline: held-out shape 0 (5000 points) upsampled 16x to
      80,000 points, chunk 8, G=8 re-stitch, edge convs on the plain
      chain (the kernel off; the kernel is the default).  The launch
      counts of the three kernels must be select 96, FPS 38, interlevel
      18 for that run (as before the capture of phase 7e existed), the
      output finite and (80000, 3), its Chamfer distance to the ground
      truth within 5% of the JAX package's, and its Chamfer distance to
      the JAX output no larger than the JAX package's distance to itself
      when its input is perturbed by 1e-6 (relative): float rounding
      flips near-ties of the re-stitch FPS, so this band holds the port
      to the surface, and (a) to the numbers.  The run's six chunks must
      have taken the two stream slots in turn
      (``inference.SLOT_CHUNKS`` 3 and 3), and its output must equal bit
      for bit the same shape's with the chunks one after another on the
      caller's stream, as the pipeline ran them before the slots.
   c. File to file, with the edge-conv kernel on: the same shape written
      to an ``.xyz`` file, ``threepu_torch.cli.main(["--phase", "test",
      ...])`` at the same configuration, the two ``.ply`` files read
      back.  The output must be finite, (80000, 3) and inside both
      Chamfer bands of (b), the input file the processed input, the
      edge-conv kernel launched 96 times (16 per chunk, 6 chunks) and
      select, FPS and interlevel above zero.  Then the warm seconds per
      shape with the kernel on, beside (b)'s with it off.
   d. Bucketing: ``upsample_shape(..., bucket=1024)`` (5000 points pad
      to 5120), kernel off: finite, (80000, 3), Chamfer distance to the
      ground truth within 5% of the JAX package's.  With
      ``--profile-shapes SHAPES``, that many warm shapes then run under
      ``torch.profiler`` with the kernel off and on: device time per
      shape by kind of kernel, and the device's idle share.

5. Training, at full width with the trained weights and the JAX
   package's results frozen in ``tests/fixtures/torch_train_ref.npz``:

   a. Batches 16 x 312 at ratio 2 and 16 cut from shape 0 by
      ``sample_batch`` with the fixture's seed points and angles: at
      least 99.9% of their points must coincide with JAX's batches
      (kNN boundaries rank in matmul form, so a near-tie may swap a
      point).  Then ``train_loss`` and backward on JAX's batches with
      JAX's re-patch seeds: at ratio 2 (no re-patching) the loss within
      1e-5 of JAX's (relative), every gradient tensor within a relative
      L2 error of 0.1 and all gradients together within the fixture's
      float-noise control; at ratio 16 the loss and all gradients
      together within the float-noise control (JAX against itself with
      the batch scaled by 1 + 1e-6 N(0, 1), the largest change over 64
      noise seeds): kNN re-patching and nearest-neighbour assignments
      flip under rounding, so this band holds the port to JAX's own
      sensitivity.  The tight check at ratio 16: the same step of the
      port on the CPU, fed every decision of the card's step (each
      k-smallest selection, interlevel pick and Chamfer argmin, the
      discrete choices that flip under rounding), must give the card's
      loss within 1e-5 (relative), all gradients together within 5e-3
      and every gradient tensor within 4e-2 (relative L2), and at least
      99.9% of each kind of decision must be the one the CPU would have
      made itself.
   b. Five clipped-Adam steps at ratio 16 with the fixture's re-patch
      seeds: every loss finite, the select and interlevel kernels
      launched in every step and the Chamfer kernel once a step (both
      directions in one launch); the losses print beside JAX's.
   c. Warm milliseconds per step at ratio 16: the median of 10 steps
      after 2 warm-up steps, each ending in a device sync.  With
      ``--profile STEPS``, that many more steps run under
      ``torch.profiler``: device time per step by kind of kernel, the
      device's idle share of the unprofiled step, the top kernels.

6. Training from a file, on the card, from the repo's own files:

   a. Data: the port's ``write_synthetic_h5`` writes 4 shapes at 5000 to
      80,000 points as ``.npz`` (the card's machine has no h5py);
      ``load_h5_data`` must give the input (4, 5000, 3) and the labels of
      ratios 2-16; a ``DeviceDataset`` on the card and one on the CPU cut
      one batch a ratio from the same draws: at least 99.9% of the card's
      points within 1e-6 of the CPU's (a kNN boundary may flip under
      rounding).
   b. The loop at full width (``train.train_loop``, 16 x 312 patches, the
      net of ``NET``), resumed from ``WEIGHTS`` with its Adam state: the
      restored state written back equals the file bit for bit; then 20
      steps past step 120000 with stages of 14000 steps (stage 4, ratios
      2-16 combined, threshold on), ``log_steps`` 5: the ratios drawn
      cover 2-16, every step launches select, interlevel once a level past
      the first and the Chamfer kernel once, every loss is finite,
      ``error_log`` has one key a ratio drawn, ``log_fn`` gets the
      prediction, and ``torch.cuda.set_sync_debug_mode`` counts no host
      sync on a step that does not log.  Then 2 steps of a fresh net at
      ratio 2 (stage 0) on the card and on the CPU with the same
      step-keyed draws, the CPU fed the card's batches: losses within
      1e-5 (relative), each parameter within 0.1 (relative L2), and the
      CPU's own batches holding 99.9% of the card's points.  Then the
      warm ms/step of the loop at ratio 16 (stages of 16000 steps: ratio
      16 only, threshold off, as in 5c; default ``log_steps``) beside
      5c's bare step, and, over 5 profiled steps, the device's idle
      share of a loop step.
   c. Resume on the card: 3 steps, ``save_train_checkpoint``, 3 more from
      the file, against 6 straight steps; the largest parameter
      difference must be at most twice the largest between two of three
      straight runs (the backward's atomic sums round in any order).
   d. The command line: ``cli.main(["--phase", "train", ...])``, one
      epoch of 300 steps of batch 1 crossing curriculum stages 0-4
      (``--stage_steps 40``), must write ``model_1.npz``; ``--phase test``
      with it must upsample the fixture's shape to 80,000 finite points,
      and the same weights saved by ``save_pth`` must give that output bit
      for bit through ``--ckpt ...pth``.

7. The rest of the one-GPU surface, against the JAX package's results
   frozen in ``tests/fixtures/torch_surface_ref.npz``:

   a. The step-4 net (``--step_ratio 4``: 2 levels of 4x, a 2-D code grid)
      at full width on JAX's initial parameters: phase 4a's replay of the
      fixture's patch and its bands, edge convs decomposed then fused.
   b. The same weights as ``.npz`` through ``cli.main(["--phase", "test",
      "--step_ratio", "4", ...])`` on shape 0, 5000 -> 80,000, chunk 8,
      G=8, the edge-conv kernel on: finite, (80000, 3), Chamfer distance
      to the ground truth within 5% of JAX's; select, FPS, interlevel and
      48 edge-conv launches.  The warm s/shape, kernel off, beside 4b's.
   c. Its train step at full width, 16 x 312: at ratio 4 on JAX's batch,
      the loss within 1e-5 (relative) of JAX's and each gradient tensor
      within 0.1 (relative L2); then 5 clipped-Adam steps at ratio 16 on
      phase 5's batch: finite losses, select and interlevel launched each
      step, Chamfer once; the warm ms/step beside 5c's.
   d. ``AdaptiveLevel`` (growth 12, dense 3, knn 15, fm_knn 5) on JAX's
      initial parameters and 48 patches of shape 0, 1225 points each:
      output and global features within 1e-4 of JAX's, and of the port on
      the CPU, on 99% of the rows; select and FPS launched.
   e. ``cli.main(["--phase", "vis", ...])`` with the trained weights,
      16x, the edge-conv kernel on, ``Painter.interactive_3D_plot``
      patched to record its arguments (the card's machine has no
      matplotlib): 16 kNN graphs, each within its own level's input cloud;
      level 1's for the first 8 patches hold JAX's neighbour sets on 99%
      of the rows, or on JAX's own share under 1e-6 input noise where that
      is smaller (the order within a row is printed too: rounding
      reorders near-equal distances).  Then ``collect_intermediates`` of
      JAX's 48 patches: level 1's ``layer_4`` of the first 8 within 1e-4
      of JAX's on 99% of the rows, or on JAX's own share under that noise
      where smaller, and every graph the kNN of its level's captured
      features under the plain selection on 99.9% of the rows.
   f. The reference-style ops (``ball_query``, ``group_knn``,
      ``furthest_point_sample``, ``fps_indices``,
      ``normalize_point_batch``, ``nndistance``, ``gather_points`` and
      its gradient) on CUDA tensors against CPU tensors, on grid clouds
      whose arithmetic is exact: equal.
   g. The native host library, built with ``g++``: ``parse_xyz`` of the
      5000- and the 80,000-point shapes equals ``np.loadtxt`` bit for bit;
      both times printed.

8. The sharded paths (``threepu_torch.parallel``) over
   ``torch.distributed`` with ``nccl``, each rank a process started by
   ``parallel.launch.spawn`` after phase 2's build (one rank a card):

   a. World size 1: phase 4b's shape through ``upsample_shape(...,
      mesh=...)``: bit for bit phase 4b's output, select 96, FPS 38,
      interlevel 18 launches and exactly one collective, the merge's
      all-gather; the warm s/shape beside 4b's.  Then once with the
      edge-conv kernel on: 96 edge-conv launches, one all-gather and both
      Chamfer bands of (4b).
   b. World size 1: phase 5a's step at ratios 2 and 16 (the trained
      weights with their Adam state, the fixture's batches and re-patch
      seeds) through ``make_sharded_train_step``: the loss equal to
      ``train_step``'s from the same state, the parameters within twice
      the largest difference between 3 serial steps (the backward's
      atomics), one all-reduce, the kernels launched (Chamfer once); the
      witness (the step as 8d's ranks run it, each block of rows through
      the forward and backward in turn on this card, the gradients
      averaged) printed beside it; the warm ms/step at ratio 16 beside the
      serial step's in the same rank (before and after) and 5c's.
   c. World size 1: ``train_loop`` with ``TrainConfig(mesh=...)`` on phase
      6's file, resumed from ``WEIGHTS``: 12 steps of 6b's checked
      configuration (each step's launches; no host sync on a step that
      does not log; one broadcast, one all-reduce a step, one all-gather a
      log step), 6b's timed configuration with the mesh and, before and
      after, without it (the warm ms/step of each beside 6b's), and one
      epoch of 300 steps of batch 1 whose checkpoint reads back through
      ``io.checkpoint`` bit for bit.
   d. Where 2 or more cards are visible, (a) and (b) at world size 4
      (2 with 2 or 3 cards): each rank's output within the float-noise
      control of (4b) of world 1's (Chamfer), one all-gather.  Each
      step, one all-reduce, against the witness: the loss within 1e-5
      (relative), the reduced gradients within phase 5b's band and the
      parameters within twice the serial pairs' difference of (b).
      Against world 1's step: at ratio 2 the same loss and parameter
      bands, all gradients within JAX's float-noise control and each
      within 0.1; at ratio 16, a chaotic step whose GEMMs round
      otherwise at 4 rows a card, loss and gradients within JAX's
      float-noise control.  On one card a line says that 8d did not run.

The last two lines of standard output are one JSON object per kernel
(launches on the checked runs of phases 4b, 4c, 5b, 6b, 6d, 7b-7e and
8a-8c, by path, error, times, bound) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from collections import defaultdict
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_ref.npz")
TRAIN_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_train_ref.npz")
SURFACE_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                               "torch_surface_ref.npz")
WEIGHTS = os.path.join(ROOT, "artifacts", "prod_clean_final.npz")
NET = dict(max_up_ratio=16, step_ratio=2, knn=32, growth_rate=12, dense_n=3,
           max_num_point=312, fm_knn=5)
#: phase 7: the step-4 net (2 levels of 4x) at full width, on the JAX
#: package's initial parameters; AdaptiveLevel at full width (knn 15: at
#: the reference's 16 its layer4 asks for 17 neighbours among 16 points)
NET4 = dict(NET, step_ratio=4)
ADAPTIVE = dict(dense_n=3, growth_rate=12, knn=15, fm_knn=5)
ADAPTIVE_TARGET = 1248
#: edge-conv launches of one step-4 16x shape: 2 levels x 4 convs x 6
#: chunks
STEP4_EDGECONV_LAUNCHES = 48
#: phase 7 bands: rows of a JAX result matched to 1e-4 (7a, 7d, 7e, as
#: 4a), the ratio-4 loss (relative) and each gradient tensor (relative
#: L2, as 5a at ratio 2), rows of a kNN graph holding JAX's neighbour set
#: (7e) or equal to its recomputation from the captured features (7e)
ROWS_BAND = 0.99
R4_LOSS_BAND, R4_TENSOR_BAND = 1e-5, 0.1
GRAPH_BAND, RECOMPUTED_BAND = 0.99, 0.999
SEED = 0
# phase 3 shapes: (B, N) of the conv-site distance matrices (k=33); FPS
# (clouds, points, picks); interlevel (P, sub-patches per top patch, M)
SELECT_BATCHES, SELECT_N = (80, 160, 320), 312
#: a PU-GAN chunk's feature kNN: (B, N, C, k + 1) over the distances of its
#: dense edge convs' 48-wide inputs
SELECT_FEATURE_CASE = (8, 256, 48, 17)
#: AdaptiveLevel's two samplings (48 patches: 312 -> 48, 48 -> 16), the
#: merge re-stitches of levels 2, 3 and 4, a PU-GAN chunk's net FPS, then a
#: group of the final G = 8 re-stitch
FPS_CASES = ((48, 312, 48), (48, 48, 16), (8, 6240, 1248), (8, 12480, 2496),
             (8, 24960, 4992), (8, 1536, 1024), (8, 29952, 10000))
#: picks of the pick-chain floor (:func:`fps_chain_floor`)
FPS_FLOOR_PICKS = 4992
#: level 2 of the step-4 net, then levels 2, 3 and 4 of the step-2 net
INTERLEVEL_CASES = ((8, 20, 312), (8, 10, 312), (8, 20, 3120),
                    (8, 40, 6240))
#: interlevel launches of one 16x shape at each re-patching level (levels
#: 2-4 of the step-2 net, level 2 of the step-4 net): one a chunk, 6 chunks
INTERLEVEL_LAUNCHES = 6
#: the train step's interlevel shape: B = P = 16, one sub-patch, M = 312
INTERLEVEL_TRAIN_CASE = (16, 1, 312)
#: interlevel values, weights and gradient against the plain version (max
#: abs): the kernel's exp and sums round apart from PyTorch's
INTERLEVEL_BAND = 1e-5
#: the train loss's nearest-neighbour shape (B, N) x (B, N), and the step-4
#: net's (at ratios 4 and 16 alike)
CHAMFER_TRAIN_CASE = (16, 624)
CHAMFER_STEP4_CASE = (16, 1248)
#: (B, N, M) of odd Chamfer shapes: one query a cloud, one candidate, and
#: N != M over several tiles
CHAMFER_ODD_CASES = ((3, 1, 700), (3, 700, 1), (2, 300, 2500))
#: the edge-conv chain (B, N, k, G, n): two small odd shapes, a PU-GAN
#: chunk's call, then the calls of a 3PU chunk's levels 1, 2, 3 and 4; max
#: abs band against the plain version, whose cuBLAS products sum in
#: another order
EDGECONV_CASES = ((3, 40, 5, 4, 1), (3, 40, 5, 4, 2), (8, 256, 16, 24, 3),
                  (8, 312, 32, 12, 3), (80, 312, 32, 12, 3),
                  (160, 312, 32, 12, 3), (320, 312, 32, 12, 3))
EDGECONV_BAND = 1e-5
#: edge-conv launches of one 16x shape: 4 levels x 4 convs x 6 chunks
EDGECONV_LAUNCHES = 96
#: phase 4b's chunks of one 16x shape by stream slot: 6 chunks in turn
EVAL_SLOT_CHUNKS = {0: 3, 1: 3}
#: phase 4b's launches of one 16x shape (edge convs decomposed): select 4
#: convs x 4 levels x 6 chunks; FPS the patch seeds, then per chunk 3
#: sub-patch seedings and 3 merges, then the final re-stitch; interlevel 3
#: levels x 6 chunks.  The same with a capture off as before it existed
EVAL_LAUNCHES = {"select": 96, "fps": 38, "interlevel": 18}
#: H100 SXM peaks (NVIDIA's data sheet): fp32 outside the tensor cores,
#: and device memory
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
#: phase 5 bands (see the module docstring): the share of sampled points
#: that must coincide with JAX's batch, the ratio-2 loss (relative) and
#: per-tensor gradient (relative L2) errors.  The per-tensor band: the
#: port on the CPU reads at most 0.032 (a bias whose gradient sums a few
#: hundred terms that nearest-neighbour flips move), all gradients
#: together 0.0057 (tests/fixtures/make_torch_train_ref.py).
BATCH_BAND = 0.999
R2_LOSS_BAND = 1e-5
R2_TENSOR_BAND = 0.1
#: phase 5a at ratio 16, the card against the port on the CPU with the
#: card's decisions replayed: the loss (relative), all gradients together
#: and each gradient tensor (relative L2), and the share of each site's
#: decisions the CPU would have made alike.  An H100 read 3.8e-7, 5.4e-4,
#: 4.2e-3 (a level-2 conv weight) and 0.99966 (the selections; the
#: interlevel picks and Chamfer argmins all shared): the bands leave
#: about ten times the rounding, and three times the selections' flips
PIN_LOSS_BAND = 1e-5
PIN_GRAD_BAND = 5e-3
PIN_TENSOR_BAND = 4e-2
DECISION_BAND = 0.999
TRAIN_BATCH, TRAIN_POINTS, TRAIN_LR = 16, 312, 5e-4
#: phase 6: the training file (shapes, resolutions) and how far a batch
#: cut on the card may lie from the CPU's (max abs, per point)
DATA_SHAPES, DATA_RESOLUTIONS = 4, (5000, 10000, 20000, 40000, 80000)
DATA_BAND = 1e-6
#: the loop resumed from WEIGHTS (step 120000): steps and log cadence;
#: with stages of 14000 steps step 120000 is stage 4 at progress 0.79
#: (ratios 2-16 combined, threshold on), with 16000 at 0.25 (ratio 16
#: only, threshold off: phase 5c's step)
LOOP_STEPS, LOOP_LOG_STEPS = 20, 5
LOOP_STAGE_STEPS, TIMING_STAGE_STEPS = 14000, 16000
LOOP_WARM, LOOP_TIMED, LOOP_PROFILED = 2, 10, 5
#: ratio-2 steps of a fresh net, card against CPU; steps before and after
#: the checkpoint of the resume check; stage length of the command line's
#: one epoch (300 steps of batch 1 cross stages 0-4)
FRESH_STEPS, RESUME_STEPS, CLI_STAGE_STEPS = 2, 3, 40
#: straight runs of phase 6c's control: two read the resumed run's gap at
#: 1.06x and 1.74x their difference on an H100, so one pair alone would
#: let chance decide
RESUME_CONTROL_RUNS = 3
#: phase 8d's world size where that many cards are visible, else 2 (the
#: train batch of 16 divides by neither 3 nor 5-7)
MAX_WORLD = 4


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the current stream, by CUDA events,
    after one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def chamfer(a, b, chunk: int = 4096) -> float:
    """Mean squared NN distance a->b plus b->a, float64 on a's device."""
    import torch
    a = a.to(torch.float64)
    b = b.to(torch.float64)

    def one_way(x, y):
        y2 = (y * y).sum(-1)
        mins = [torch.clamp((r * r).sum(-1)[:, None] - 2.0 * r @ y.T
                            + y2[None, :], min=0.0).amin(-1)
                for r in x.split(chunk)]
        return torch.cat(mins).mean()

    return float(one_way(a, b) + one_way(b, a))


# ------------------------------------------------------------ phase 3
def select_inputs(dev, g, b=320, n=312):
    import torch
    d = torch.randint(0, 40, (b, n, n), generator=g, device=dev).float()
    pen = torch.randperm(n, generator=g, device=dev)[:64]
    d[..., pen] = 1e30                         # duplicate-penalty columns
    d[0, :, :n - 22] = 1e30                    # rows with < k real columns
    return d


def feature_select_inputs(dev, g, b, n, c):
    """Squared distances between ``(b, n, c)`` ReLU features, every 40th
    point a repeat of the one before it (same position, same features),
    its column penalized as the net's feature kNN does."""
    import torch
    from threepu_torch.ops.distances import duplicate_mask, pairwise_dist2
    from threepu_torch.ops.knn import PENALTY
    xyz = torch.randn((b, n, 3), generator=g, device=dev)
    feat = torch.relu(torch.randn((b, n, c), generator=g, device=dev))
    for t in (xyz, feat):
        t[:, 1::40] = t[:, 0::40][:, :t[:, 1::40].shape[1]]
    d = pairwise_dist2(feat, feat)
    return d.masked_fill(duplicate_mask(xyz)[..., None, :], PENALTY)


def fps_inputs(dev, g, b, n):
    import torch
    pts = torch.randn((b, n, 3), generator=g, device=dev)
    pts = pts / pts.norm(dim=-1, keepdim=True)
    valid = torch.ones((b, n), dtype=torch.bool, device=dev)
    valid[:, n - n // 10:] = False             # phantom sub-patches
    pts[:, 7::997] = float("nan")              # non-finite points
    return pts, valid


def interlevel_inputs(dev, g, p, group, m, n=312, c=264):
    import torch
    from threepu_torch.ops.distances import duplicate_mask
    prev = torch.randn((p, m, 3), generator=g, device=dev) * 0.3
    prev[:, 1::50] = prev[:, 0::50][:, :prev[:, 1::50].shape[1]]
    pick = torch.randint(0, m, (p, group * n), generator=g, device=dev)
    q = torch.gather(prev, 1, pick[..., None].expand(-1, -1, 3))
    q = q + 0.01 * torch.randn(q.shape, generator=g, device=dev)
    q = q.reshape(p * group, n, 3).contiguous()
    xq = torch.randn((p * group, n, c), generator=g, device=dev)
    feat = torch.randn((p, m, c), generator=g, device=dev)
    dup = duplicate_mask(prev)
    dup[:, m - m // 10:] = True                # phantom previous rows
    return q, xq, prev, feat, dup


def bound(ops: float, nbytes: float) -> dict:
    """The least milliseconds an H100 SXM could take for ``ops`` fp32
    operations moving ``nbytes`` bytes, and which of the two bounds it."""
    t_ops = ops / FP32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def interlevel_bound(args, with_w: bool = False) -> dict:
    """The interlevel skip's bound on ``args`` (as
    :func:`interlevel_inputs` returns them), with the weights written as
    a third output when ``with_w``."""
    (p, m, _), (bq, nq, c) = args[2].shape, args[1].shape
    # candidates: distance (8) and a compare; picks: feature distance
    # (3 per channel) and the weighted sum (2 per channel)
    ops = bq * nq * m * 9.0 + bq * nq * 5 * c * 5.0
    nbytes = (4 * (bq * nq * 3 + 2 * bq * nq * c + p * m * 3 + p * m * c
                   + bq * nq * 5 * (2 if with_w else 1)) + p * m)
    return bound(ops, nbytes)


def interlevel_issue_floor_ms(args) -> float:
    """The interlevel selection's issue-slot floor on ``args``: 10 issue
    slots a candidate (the distance's 8 separately rounded operations, the
    penalty's select and the compare) at one a lane a clock, the rate at
    which the fp32 peak (:data:`FP32_FLOPS`) counts an FMA as two
    operations.  The bound prices each of these slots as one operation."""
    (_, m, _), (bq, nq, _) = args[2].shape, args[1].shape
    return bq * nq * m * 10.0 / (FP32_FLOPS / 2) * 1e3


def check_interlevel_train(dev, g, card: str) -> None:
    """The interlevel kernel at the train step's shape (B = P = 16, one
    sub-patch per previous set, N = M = 312, C = 264, k = 5) with the
    weights output the backward reads: its ``(out, idx, w)`` against the
    plain version's, and the ``prev_feat`` gradient of both for one
    cotangent.  Picks exact; values and gradient within
    ``INTERLEVEL_BAND`` (the card's backward sums with atomics)."""
    import torch
    import threepu_torch.ops.interlevel as il_mod
    p, group, m = INTERLEVEL_TRAIN_CASE
    args = interlevel_inputs(dev, g, p, group, m)
    got = il_mod._launch(*args, 5, with_w=True)
    want = il_mod._plain(*args, 5)
    torch.cuda.synchronize()
    if not torch.equal(got[1], want[1]):
        first = (got[1] != want[1]).nonzero()[0].tolist()
        raise AssertionError(f"interlevel train shape: picks differ first at "
                             f"{first}")
    errs = {"out": float((got[0] - want[0]).abs().max()),
            "w": float((got[2] - want[2]).abs().max())}
    cot = torch.randn(got[0].shape, generator=g, device=dev)
    grads = []
    for fn in (il_mod.interlevel, il_mod.interlevel_plain):
        feat = args[3].clone().requires_grad_()
        out, _ = fn(args[0], args[1], args[2], feat, args[4], 5)
        out.backward(cot)
        grads.append(feat.grad)
    errs["grad"] = float((grads[0] - grads[1]).abs().max())
    print(f"interlevel train shape B=P={p} M={m} C=264 k=5: picks exact, max "
          f"abs err out {errs['out']:.3e}, w {errs['w']:.3e}, prev_feat "
          f"gradient {errs['grad']:.3e} [{card}]", flush=True)
    for name, err in errs.items():
        if not err <= INTERLEVEL_BAND:
            raise AssertionError(f"interlevel train shape: {name} max abs "
                                 f"error {err} > {INTERLEVEL_BAND}")
    ms = cuda_ms(lambda: il_mod._launch(*args, 5, with_w=True), 20)
    plain_ms = cuda_ms(lambda: il_mod._plain(*args, 5), 5)
    b = interlevel_bound(args, with_w=True)
    print(f"interlevel train shape with w: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}); 3 launches per train step [{card}]",
          flush=True)


def chamfer_inputs(dev, g, b, n, m=None):
    """Two clouds, ``(b, n, 3)`` and ``(b, m, 3)`` (``m`` defaults to
    ``n``), with duplicate points and exact zero distances."""
    import torch
    m = n if m is None else m
    a = torch.randn((b, n, 3), generator=g, device=dev)
    r = torch.randn((b, m, 3), generator=g, device=dev)
    r[:, 1::7] = r[:, 0::7][:, :r[:, 1::7].shape[1]]
    k = min(n // 10, m - m // 2)
    a[:, :k] = r[:, m // 2:m // 2 + k]
    return a, r


def chamfer_issue_floor_ms(pairs: float) -> float:
    """The Chamfer kernel's issue-slot floor for ``pairs`` (query,
    candidate) pairs: 9 issue slots a pair (the distance's 8 separately
    rounded operations and a min) at one a lane a clock, the rate at which
    :data:`FP32_FLOPS` counts an FMA as two operations (1.98 GHz)."""
    return pairs * 9.0 / (FP32_FLOPS / 2) * 1e3


def chamfer_exact(what: str, got, want) -> None:
    """Raises unless every tensor of ``got`` equals its ``want``."""
    import torch
    for name, g, w in zip(("dist1", "idx1", "dist2", "idx2"), got, want):
        if not torch.equal(g, w):
            first = (g != w).nonzero()[0].tolist()
            raise AssertionError(f"chamfer {what}: {name} differs first at "
                                 f"{first}")


def chamfer_plan_text(a, b) -> str:
    """The plan of the kernel both ways and one way on ``a`` and ``b``,
    and the clusters the card holds at once at the plan's block."""
    import threepu_torch.ops.chamfer as ch_mod
    (bsz, n, _), m = a.shape, b.shape[1]
    active = ch_mod.active_clusters(a.device.index)
    plan = ch_mod.chamfer_plan(bsz, n, m, active)
    return (f"plan {tuple(plan)} (threads, cluster, tile) for "
            f"{bsz * (-(-n // plan.threads) - (-m // plan.threads))} query "
            f"tiles, one way "
            f"{tuple(ch_mod.chamfer_plan(bsz, n, m, active, False))}; the "
            f"card holds {[active(plan.threads, cl) for cl in range(1, 9)]} "
            f"clusters of 1-8 such blocks at once")


def check_chamfer_exact(a, b, card: str) -> None:
    """The nearest-neighbour kernel one way and both ways in one launch,
    as the plan lays it out, against its plain version: exact, or
    raises."""
    import torch
    import threepu_torch.ops.chamfer as ch_mod
    shape = f"{tuple(a.shape)} x {tuple(b.shape)}"
    want = (*ch_mod.nn_one_way_plain(a, b), *ch_mod.nn_one_way_plain(b, a))
    chamfer_exact(f"{shape} one way", ch_mod.nn_one_way(a, b), want[:2])
    chamfer_exact(f"{shape} both ways", ch_mod.nn_both_ways(a, b), want)
    torch.cuda.synchronize()
    print(f"chamfer {shape}: exact one way and both ways; "
          f"{chamfer_plan_text(a, b)} [{card}]", flush=True)


def check_chamfer(a, b, card: str, reps: int) -> dict:
    """The nearest-neighbour kernel, one way and both ways in one launch,
    against its plain version on ``a`` and ``b``: exact, or raises.
    Returns the both-ways call's error, times and bound; its ``ms`` is the
    time of a call replayed in a CUDA graph (:func:`graph_us`), device
    time, and ``eager_ms`` that of eager calls by CUDA events, which at the
    train shape is mostly the wrapper's host time."""
    import torch
    import threepu_torch.ops.chamfer as ch_mod
    check_chamfer_exact(a, b, card)
    bsz, n, _ = a.shape
    m = b.shape[1]
    one_ms = cuda_ms(lambda: ch_mod.nn_one_way(a, b), reps)
    eager_ms = cuda_ms(lambda: ch_mod.nn_both_ways(a, b), reps)
    ms = graph_us(lambda: ch_mod.nn_both_ways(a, b), reps) / 1e3
    plain_ms = cuda_ms(lambda: (ch_mod.nn_one_way_plain(a, b),
                                ch_mod.nn_one_way_plain(b, a)), 1)

    def library():
        d = torch.cdist(a, b, compute_mode="donot_use_mm_for_euclid_dist")
        return d.min(-1), d.min(-2)

    library_ms = cuda_ms(library, 1)
    torch.cuda.empty_cache()
    pairs = bsz * n * m
    one = bound(8.0 * pairs, bsz * n * 20 + bsz * m * 12)
    rep = dict(max_abs_err=0.0, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
               library_ms=library_ms,
               **bound(16.0 * pairs, bsz * (n + m) * 20))
    print(f"chamfer {tuple(a.shape)} x {tuple(b.shape)}: kernel one way "
          f"{one_ms:.4f} ms (bound {one['bound_ms']:.4f} ms, "
          f"{one['bound_by']}; issue-slot floor "
          f"{chamfer_issue_floor_ms(pairs):.4f} ms), both ways in one launch "
          f"{ms:.4f} ms in a CUDA graph, {eager_ms:.4f} ms eager (bound "
          f"{rep['bound_ms']:.4f} ms, {rep['bound_by']}; "
          f"issue-slot floor {chamfer_issue_floor_ms(2 * pairs):.4f} ms); "
          f"plain both ways {plain_ms:.4f} ms, torch.cdist + min both ways "
          f"{library_ms:.4f} ms [{card}]", flush=True)
    return rep


def graph_us(fn, reps: int) -> float:
    """Microseconds a call of ``fn`` takes on the device when ``reps``
    calls replay back to back as one CUDA graph: where the host's launch
    time hides a small kernel from CUDA events around eager calls.  The
    mean of 3 replays after a warm-up one."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (3 * reps)


def chamfer_times(dev, fx, card: str) -> None:
    """The Chamfer kernel through the callers every tree of the port has:
    ``nn_one_way`` (one way) and ``nn_distance``'s forward (both ways), at
    the fixture's 80k pair and at the train shape: milliseconds by CUDA
    events around eager calls, microseconds a call replayed in a CUDA graph
    (:func:`graph_us`), and launches a call.  ``compare_trees.py`` runs it
    in each tree."""
    import torch
    import threepu_torch.ops.chamfer as ch_mod
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = (("80k", [torch.from_numpy(fx[k][None]).to(dev)
                      for k in ("jax_out", "gt")], 10),
             ("train", chamfer_inputs(dev, g, *CHAMFER_TRAIN_CASE), 50))
    with torch.no_grad():
        for name, (a, b), reps in cases:
            calls = (("one way", lambda: ch_mod.nn_one_way(a, b)),
                     ("both ways", lambda: ch_mod.nn_distance(a, b)))
            for what, fn in calls:
                before = ch_mod.KERNEL.launches
                fn()
                launches = ch_mod.KERNEL.launches - before
                ms = cuda_ms(fn, reps)
                dev_us = graph_us(fn, reps)
                print(f"chamfer {name} {tuple(a.shape)} x {tuple(b.shape)} "
                      f"{what}: {ms:.4f} ms, in a CUDA graph "
                      f"{dev_us:.2f} us, {launches} launch(es) a call "
                      f"[{card}]", flush=True)


def edgeconv_inputs(dev, g, b, n_pts, k, growth, n):
    """The chain's arguments as ``DenseEdgeConv`` passes them: ``z`` and
    the ``n`` stages' terms as separate ``(B, N, G)`` products, ``idx`` the
    int32 ``[..., 1:]`` view of a ``k + 1`` selection, the chain blocks as
    row blocks of transposed weights."""
    import torch
    z, *pts = torch.randn((n + 1, b, n_pts, growth), generator=g,
                          device=dev).unbind()
    idx = torch.randint(0, n_pts, (b, n_pts, k + 1), generator=g, device=dev,
                        dtype=torch.int32)[..., 1:]
    w = [0.3 * torch.randn((growth, growth * i + 3), generator=g,
                           device=dev).t() for i in range(1, n)]
    chain_w = [w[i - 1][growth * j:growth * (j + 1)] for i in range(1, n)
               for j in range(i)]
    return z, idx, pts, chain_w, n, growth


def edgeconv_host_us(chain, args, reps: int = 50, runs: int = 20) -> float:
    """Host microseconds a call of ``chain(*args)`` (an edge-conv wrapper,
    ``ops.edgeconv.edge_conv_chain``), the best of ``runs`` runs of
    ``reps`` calls queued without a sync (other work on a shared host only
    adds time): at the level-1 shape the device finishes a call before the
    host has issued the next, so this is what the wrapper costs the
    host-bound eval loop."""
    import torch
    best = float("inf")
    with torch.no_grad():
        chain(*args)
        for _ in range(runs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(reps):
                chain(*args)
            best = min(best, (time.perf_counter() - start) / reps * 1e6)
            torch.cuda.synchronize()
    return best


def check_edgeconv(dev, g, card: str) -> dict:
    """The edge-conv chain kernel against its plain version at
    ``EDGECONV_CASES``, within ``EDGECONV_BAND`` or raises.  Returns the
    error, times and bound of the last case, the level-4 call."""
    import torch
    import threepu_torch.ops.edgeconv as ec_mod
    for case in EDGECONV_CASES:
        b, n_pts, k, growth, n = case
        args = edgeconv_inputs(dev, g, *case)
        got = ec_mod.edge_conv_chain(*args)
        want = ec_mod.edge_conv_chain_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if got.shape != want.shape or not err <= EDGECONV_BAND:
            raise AssertionError(f"edge conv {case}: max abs error {err} > "
                                 f"{EDGECONV_BAND}")
        del got, want
        ms = cuda_ms(lambda: ec_mod.edge_conv_chain(*args), 20)
        plain_ms = cuda_ms(lambda: ec_mod.edge_conv_chain_plain(*args), 5)
        # per neighbour: n(n-1)/2 products of G x G (2 each), and per stage
        # an add, a relu and a max per channel
        ops = b * n_pts * k * (2.0 * growth * growth * n * (n - 1) / 2
                               + 3.0 * n * growth)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (*args[:2], *args[2], *args[3])) \
            + b * n_pts * n * growth * 4
        rep = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                   **bound(ops, nbytes))
        # a chunk's 4 levels run 4 edge convs each, one shape 6 chunks
        per_shape = (EDGECONV_LAUNCHES // 4 if (n_pts, k, growth, n)
                     == (312, 32, 12, 3) else 0)
        host_us = edgeconv_host_us(ec_mod.edge_conv_chain, args)
        print(f"edge conv B={b} N={n_pts} k={k} G={growth} n={n}: max abs err "
              f"{err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{rep['bound_ms']:.4f} ms ({rep['bound_by']}); wrapper "
              f"{host_us:.2f} us of host a call; {per_shape} launches per "
              f"16x shape with the kernel on [{card}]", flush=True)
    torch.cuda.empty_cache()
    return rep


def fps_chain_floor(dev, card: str) -> None:
    """The FPS kernel on 8 clouds of N = C points, one point a block, at
    each cluster size C: nearly all of a pick is then the argmaxes, the
    distributed-shared-memory stores and the wait for the peers, so the
    microseconds per pick are the pick chain's floor at that C."""
    import torch
    import threepu_torch.ops.fps as fps_mod
    picks = FPS_FLOOR_PICKS
    floors = {}
    for c in (1, 2, 4, 8):
        pts = torch.randn((8, c, 3), device=dev)
        valid = torch.ones((8, c), dtype=torch.bool, device=dev)
        out = torch.empty((8, picks), dtype=torch.int32, device=dev)
        plan = fps_mod.FpsPlan(c, "registers-8", 1)
        ms = cuda_ms(lambda: fps_mod._launch(pts, valid, out, plan), 3)
        floors[c] = round(ms * 1e3 / picks, 4)
    print(f"fps pick chain floor, 8 clouds of N = C points, {picks} picks: "
          f"us/pick by cluster size C {floors} [{card}]", flush=True)


def check_kernels(dev, card: str, fx) -> dict:
    """Phase 3: each kernel against its plain version; returns, per
    kernel, the error, times and bound at its headline shape."""
    import torch
    import threepu_torch.ops.fps as fps_mod
    import threepu_torch.ops.interlevel as il_mod
    import threepu_torch.ops.select as sel_mod

    g = torch.Generator(device=dev).manual_seed(SEED)
    report = {}

    b, n, c, k = SELECT_FEATURE_CASE
    d = feature_select_inputs(dev, g, b, n, c)
    v, i = sel_mod.select(d, k)
    pv, pi = sel_mod.select_plain(d, k)
    torch.cuda.synchronize()
    if not (torch.equal(v, pv) and torch.equal(i, pi)):
        raise AssertionError(f"select {tuple(d.shape)} k={k} over features: "
                             "kernel and plain version differ")
    ms = cuda_ms(lambda: sel_mod.select(d, k), 20)
    plain_ms = cuda_ms(lambda: sel_mod.select_plain(d, k), 5)
    print(f"select {tuple(d.shape)} k={k} over {c}-wide features: exact; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]", flush=True)

    for b in SELECT_BATCHES:                 # the headline shape last
        d = select_inputs(dev, g, b, SELECT_N)
        v, i = sel_mod.select(d, 33)
        pv, pi = sel_mod.select_plain(d, 33)
        torch.cuda.synchronize()
        if not (torch.equal(v, pv) and torch.equal(i, pi)):
            raise AssertionError(f"select {tuple(d.shape)}: kernel and plain "
                                 "version differ")
        ms = cuda_ms(lambda: sel_mod.select(d, 33), 20)
        plain_ms = cuda_ms(lambda: sel_mod.select_plain(d, 33), 5)
        # torch.topk computes the same k smallest, but with no promise on
        # the order among ties: a yardstick only
        library_ms = cuda_ms(lambda: torch.topk(d, 33, dim=-1,
                                                largest=False), 5)
        rows, n = d.numel() // d.shape[-1], d.shape[-1]
        report["select"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                library_ms=library_ms,
                                **bound(rows * n,
                                        rows * n * 4 + rows * 33 * 8))
        print(f"select {tuple(d.shape)} k=33: exact; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, torch.topk {library_ms:.4f} ms, "
              f"bound {report['select']['bound_ms']:.4f} ms "
              f"({report['select']['bound_by']}) [{card}]", flush=True)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, n, m in FPS_CASES:                # the headline shape last
        pts, valid = fps_inputs(dev, g, b, n)
        plan = fps_mod.fps_plan(b, n, m, sms)
        got = fps_mod.fps(pts, m, valid)
        want = fps_mod.fps_plain(pts, m, valid)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            first = (got != want).nonzero()[0].tolist()
            raise AssertionError(f"fps ({b}, {n}) -> {m}: kernel and plain "
                                 f"version differ first at {first}")
        ms = cuda_ms(lambda: fps_mod.fps(pts, m, valid), 3)
        plain_ms = cuda_ms(lambda: fps_mod.fps_plain(pts, m, valid), 1)
        # each pick updates every point: distance (8), min, argmax compare
        report["fps"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                             library_ms=None,
                             **bound(10.0 * b * m * n,
                                     b * n * 13 + b * m * 4))
        print(f"fps ({b}, {n}) -> {m}: exact; plan {plan.cluster} blocks a "
              f"cloud, {plan.slice} points a block, kept in {plan.storage}; "
              f"kernel {ms:.4f} ms, "
              f"{ms * 1e3 / m:.3f} us/pick, plain {plain_ms:.4f} ms, bound "
              f"{report['fps']['bound_ms']:.4f} ms "
              f"({report['fps']['bound_by']}) [{card}]", flush=True)
    fps_chain_floor(dev, card)

    for p, group, m in INTERLEVEL_CASES:
        args = interlevel_inputs(dev, g, p, group, m)
        out, idx = il_mod.interlevel(*args, 5)
        pout, pidx = il_mod.interlevel_plain(*args, 5)
        torch.cuda.synchronize()
        if not torch.equal(idx, pidx):
            first = (idx != pidx).nonzero()[0].tolist()
            raise AssertionError(f"interlevel group {group}, M {m}: picks "
                                 f"differ first at {first}")
        err = float((out - pout).abs().max())
        if not err <= INTERLEVEL_BAND:
            raise AssertionError(f"interlevel group {group}, M {m}: max abs "
                                 f"error {err} > {INTERLEVEL_BAND}")
        ms = cuda_ms(lambda: il_mod.interlevel(*args, 5), 10)
        plain_ms = cuda_ms(lambda: il_mod.interlevel_plain(*args, 5), 2)
        report["interlevel"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    library_ms=None,
                                    **interlevel_bound(args))
        plan = il_mod.interlevel_plan(args[0].shape[1])
        print(f"interlevel P={p} group={group} M={m} C=264 k=5: picks exact, "
              f"max abs err {err:.3e}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound "
              f"{report['interlevel']['bound_ms']:.4f} ms "
              f"({report['interlevel']['bound_by']}), issue-slot floor "
              f"{interlevel_issue_floor_ms(args):.4f} ms; "
              f"clusters of {plan.cluster} x {plan.threads} threads; "
              f"{INTERLEVEL_LAUNCHES} launches per 16x shape of the "
              f"{'step-4' if (group, m) == (20, 312) else 'step-2'} net "
              f"[{card}]", flush=True)
    check_interlevel_train(dev, g, card)

    for b, n, m in CHAMFER_ODD_CASES:
        check_chamfer_exact(*chamfer_inputs(dev, g, b, n, m), card)
    big = [torch.from_numpy(fx[k][None]).to(dev) for k in ("jax_out", "gt")]
    check_chamfer(*big, card, 10)
    del big
    check_chamfer(*chamfer_inputs(dev, g, *CHAMFER_STEP4_CASE), card, 50)
    train = chamfer_inputs(dev, g, *CHAMFER_TRAIN_CASE)
    report["chamfer"] = check_chamfer(*train, card, 50)
    report["edgeconv"] = check_edgeconv(dev, g, card)
    return report


# ------------------------------------------------------------ phase 4
def replay_cascade(net, fx, dev, chain_kernel: bool = False) -> list:
    """Phase 4a: ``net``'s eval cascade on the fixture's patch, each
    step fed JAX's input for it (``cascade_*`` of the fixture), as
    ``Net.upsample`` runs the steps, the edge convs on the fused chain
    kernel when ``chain_kernel``.  Returns, per level, the share of
    output rows within 1e-4 of JAX's, the largest row error, and for the
    sub-patching levels the share of JAX's sub-patch points that the
    port's sub-patches hold and both real sub-patch counts."""
    import torch
    from threepu_torch.ops.distances import duplicate_mask
    from threepu_torch.ops.normalize import normalize_point_batch_cl

    def jax_(key):
        return torch.from_numpy(fx[key]).to(dev)

    def rows(got, key):
        err = (got - jax_(key)).abs().amax(-1).reshape(-1)
        return dict(rows_1e4=float((err <= 1e-4).double().mean()),
                    max_abs_err=float(err.max()))

    stats = []
    with torch.no_grad():
        xyz = jax_("cascade_in")
        out, feats = net.levels["level_1"](xyz, xyz,
                                           chain_kernel=chain_kernel)
        stats.append(dict(level=1, **rows(out, "cascade_out_1")))
        old_xyz, old_feats, prev_invalid = xyz, feats, None
        for l in range(2, len(net.levels) + 1):
            flat = jax_(f"cascade_sub_{l}")
            true_sub = jax_(f"cascade_true_sub_{l}").long()
            n_sub, k, _ = flat.shape
            sub, port_true_sub = net._extract_patch_eval(
                jax_(f"cascade_xyz_{l}"), k, n_sub)
            same = (flat[:, :, None, :] == sub.reshape(flat.shape)[:, None]
                    ).all(-1).any(-1)
            norm, _, _ = normalize_point_batch_cl(flat)
            prev_dup = duplicate_mask(old_xyz)
            if prev_invalid is not None:
                prev_dup = prev_dup | prev_invalid
            out, feats = net.levels[f"level_{l}"](
                flat, norm, (old_xyz, old_feats), prev_group=n_sub,
                prev_dup=prev_dup, chain_kernel=chain_kernel)
            stats.append(dict(level=l, **rows(out, f"cascade_out_{l}"),
                              sub_points=float(same.double().mean()),
                              true_sub=int(port_true_sub[0]),
                              jax_true_sub=int(true_sub[0])))
            old_xyz = flat.reshape(1, n_sub * k, 3)
            old_feats = feats.reshape(1, n_sub * k, -1)
            valid = torch.arange(n_sub, device=dev) < true_sub[:, None]
            prev_invalid = ~valid[:, :, None].expand(1, n_sub, k).reshape(
                1, -1)
    return stats


def check_replay(stats: list) -> None:
    """Phase 4a's bands; raises on the first level outside them."""
    for st in stats:
        l = st["level"]
        if not st["rows_1e4"] >= 0.99:
            raise AssertionError(f"cascade replay level {l}: only "
                                 f"{st['rows_1e4']:.5f} of the rows lie "
                                 "within 1e-4 of JAX's")
        if l > 1 and not (st["sub_points"] >= 0.99
                          and st["true_sub"] == st["jax_true_sub"]):
            raise AssertionError(f"cascade replay level {l}: sub-patches "
                                 f"differ from JAX's: {st}")


def check_output(out, fx, dev, what: str, control: bool = True) -> None:
    """A 16x output of the fixture's shape: ``(80000, 3)``, finite, its
    Chamfer distance to the ground truth within 5% of the JAX package's
    and, with ``control``, its Chamfer distance to the JAX output inside
    the fixture's float-noise control; raises otherwise."""
    import torch
    n_out = fx["input"].shape[0] * int(fx["ratio"])
    if out.shape != (n_out, 3) or not np.isfinite(out).all():
        raise AssertionError(f"{what}: bad output: shape {out.shape}, finite "
                             f"{bool(np.isfinite(out).all())}")
    o = torch.from_numpy(out).to(dev)
    cd_gt = chamfer(o, torch.from_numpy(fx["gt"]).to(dev))
    cd_jax = chamfer(o, torch.from_numpy(fx["jax_out"]).to(dev))
    jax_cd_gt = float(fx["jax_cd_gt"])
    ctl = float(np.max(fx["jax_pert_cd"]))
    print(f"{what}: {fx['input'].shape[0]} -> {n_out}: chamfer to gt "
          f"{cd_gt:.6e} (JAX {jax_cd_gt:.6e}, ratio {cd_gt / jax_cd_gt:.4f}); "
          f"chamfer to JAX output {cd_jax:.6e} ({cd_jax / jax_cd_gt:.4f} of "
          f"JAX's distance to gt; JAX against itself under 1e-6 input noise: "
          f"{ctl:.6e}, {ctl / jax_cd_gt:.4f})", flush=True)
    if abs(cd_gt - jax_cd_gt) > 0.05 * jax_cd_gt:
        raise AssertionError(f"{what}: chamfer to gt is not within 5% of "
                             "JAX's")
    # float rounding flips near-ties of the re-stitch FPS, so outputs that
    # differ only by rounding are different samples of one surface: the
    # port must lie no farther from JAX than JAX lies from itself
    if control and cd_jax > ctl:
        raise AssertionError(f"{what}: chamfer to the JAX output exceeds the "
                             "JAX float-noise control")


def run_shape(net, fx, **kwargs):
    """``upsample_shape`` of the fixture's shape at its configuration
    (16x, 312-point patches, chunk 8), ending in a device sync; returns
    the upsampled points."""
    import torch
    from threepu_torch.inference import upsample_shape
    out = upsample_shape(net, fx["input"], int(fx["ratio"]),
                         num_point=int(fx["num_point"]),
                         chunk=int(fx["chunk"]), **kwargs)[1]
    torch.cuda.synchronize()
    return out


@contextlib.contextmanager
def plain_chain(net):
    """``net``'s eval cascade with its edge convs on the plain PyTorch
    chain (``ops.edgeconv.takes_kernel`` says no; the kernel is the
    default), for the runs held beside the kernel's.  The net's graphs,
    captured on one route, are dropped on entry and on exit."""
    import threepu_torch.ops.edgeconv as ec_mod
    net._stages.clear()
    try:
        with mock.patch.object(ec_mod, "takes_kernel",
                               lambda x, n, g: False):
            yield
    finally:
        net._stages.clear()


def warm_shape_s(net, fx, **kwargs) -> tuple:
    """``(best, times)`` of three warm :func:`run_shape` runs, in
    seconds."""
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_shape(net, fx, **kwargs)
        times.append(time.perf_counter() - t0)
    return min(times), times


def checked_launches(kernels: dict, required, what: str) -> dict:
    """The launch count of each of ``kernels`` since they were set to 0;
    raises where one of ``required`` is 0."""
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"{what} launches: {launches}", flush=True)
    for name in required:
        if launches[name] <= 0:
            raise AssertionError(f"{what} never launched {name}")
    return launches


def end_to_end(net, fx, card: str, kernels: dict) -> tuple:
    """Phase 4b: the 16x pipeline on held-out shape 0, edge convs on the
    plain chain; returns the launch count of each kernel in the checked
    run, the warm seconds per shape and the checked run's output."""
    import threepu_torch.inference as inf
    with plain_chain(net):
        t0 = time.perf_counter()
        run_shape(net, fx)                           # first run: warm-up
        first_s = time.perf_counter() - t0
        for k in kernels.values():
            k.launches = 0
        inf.SLOT_CHUNKS.clear()
        out = run_shape(net, fx)
        launches = checked_launches(kernels, ("select", "fps", "interlevel"),
                                    "main-path")
        slots = dict(inf.SLOT_CHUNKS)
        # the chunks one after another on the caller's stream
        with mock.patch.object(inf.SlotStreams, "streamed",
                               staticmethod(lambda t: False)):
            one_stream = run_shape(net, fx)
        best, times = warm_shape_s(net, fx)
    for name, want in EVAL_LAUNCHES.items():
        if launches[name] != want:
            raise AssertionError(f"the 16x shape launched {name} "
                                 f"{launches[name]} times, not {want}")
    print(f"16x chunks by stream slot: {slots}; one-stream output equal: "
          f"{np.array_equal(out, one_stream)}", flush=True)
    if slots != EVAL_SLOT_CHUNKS:
        raise AssertionError(f"the 16x shape's chunks took the slots "
                             f"{slots}, not {EVAL_SLOT_CHUNKS}")
    if not np.array_equal(out, one_stream):
        raise AssertionError("the 16x shape on two stream slots is not the "
                             "one-stream shape bit for bit")
    check_output(out, fx, next(net.parameters()).device, "16x pipeline")
    n_out = out.shape[0]
    print(f"16x {fx['input'].shape[0]} -> {n_out}: first run {first_s:.3f} s, "
          f"warm s/shape {best:.4f} (runs {[round(t, 4) for t in times]}), "
          f"{n_out / best:.1f} points/s [{card}]", flush=True)
    return launches, best, out


def file_to_file(net, fx, card: str, kernels: dict, off_s: float) -> dict:
    """Phase 4c: the fixture's shape from an ``.xyz`` file to ``.ply``
    files through ``threepu_torch.cli.main``, the edge-conv kernel on;
    returns the launch count of each kernel in that run.  ``net`` and
    ``off_s`` (phase 4b's warm seconds per shape, kernel off) serve the
    timing that follows."""
    import tempfile
    from threepu_torch import cli
    from threepu_torch.io import read_ply

    dev = next(net.parameters()).device
    with tempfile.TemporaryDirectory() as tmp:
        os.mkdir(os.path.join(tmp, "shapes"))
        np.savetxt(os.path.join(tmp, "shapes", "shape0.xyz"), fx["input"])
        for k in kernels.values():
            k.launches = 0
        cli.main(["--phase", "test", "--ckpt", WEIGHTS, "--test_data",
                  os.path.join(tmp, "shapes", "*.xyz"), "--num_point",
                  str(int(fx["num_point"])), "--up_ratio",
                  str(int(fx["ratio"])), "--knn", str(NET["knn"]), "--chunk",
                  str(int(fx["chunk"])), "--result_dir",
                  os.path.join(tmp, "out")])
        launches = checked_launches(
            kernels, ("select", "fps", "interlevel", "edgeconv"),
            "file-to-file")
        out = read_ply(os.path.join(tmp, "out", "shapes", "shape0.ply"))
        inp = read_ply(os.path.join(tmp, "out", "shapes", "shape0_input.ply"))
        if launches["edgeconv"] != EDGECONV_LAUNCHES:
            raise AssertionError(f"file-to-file launched the edge-conv kernel "
                                 f"{launches['edgeconv']} times, not "
                                 f"{EDGECONV_LAUNCHES}")
        # the processed input: normalized and denormalized in float32
        if inp.shape != fx["input"].shape or not np.allclose(
                inp, fx["input"], rtol=0.0, atol=1e-6):
            raise AssertionError("file-to-file: the input file is not the "
                                 "processed input")
        check_output(out, fx, dev, "file-to-file, edge-conv kernel on")
        on_s, times = warm_shape_s(net, fx)
    print(f"16x warm s/shape, edge-conv kernel on {on_s:.4f} (runs "
          f"{[round(t, 4) for t in times]}), off {off_s:.4f} (phase 4b) "
          f"[{card}]", flush=True)
    return launches


def bucketed(net, fx, card: str) -> None:
    """Phase 4d: the fixture's shape through ``bucket=1024`` (5000 points
    pad to 5120), kernel off.  The padded distance matrices round apart
    from the exact-size run's and flip near-ties, so the output is held
    to the ground truth, not to the JAX output."""
    t0 = time.perf_counter()
    with plain_chain(net):
        out = run_shape(net, fx, bucket=1024)
    print(f"bucketed run {time.perf_counter() - t0:.3f} s [{card}]",
          flush=True)
    check_output(out, fx, next(net.parameters()).device, "bucket=1024",
                 control=False)


def profile_shapes(net, fx, shapes: int, card: str) -> None:
    """``shapes`` warm 16x shapes under ``torch.profiler``, the edge-conv
    kernel off and then on (:func:`profile_steps`)."""
    for on in (False, True):
        with contextlib.nullcontext() if on else plain_chain(net):
            best, _ = warm_shape_s(net, fx)
            print(f"16x shape, edge-conv kernel {'on' if on else 'off'}:",
                  flush=True)
            profile_steps(lambda: run_shape(net, fx), shapes, best * 1e3,
                          card, "16x shapes")


# ------------------------------------------------------------ phase 5
def normalize_by_input(inp, *labels):
    """Every resolution of one shape by the input's centroid and furthest
    distance (arrays ``(1, N, 3)``), as the JAX package's ``load_h5_data``
    normalizes training data."""
    centroid = np.mean(inp, axis=1, keepdims=True)
    data = inp - centroid
    furthest = np.amax(np.sqrt(np.sum(data ** 2, axis=-1)), axis=1,
                       keepdims=True)[..., None]
    return (data / furthest,
            *[(lab - centroid) / furthest for lab in labels])


def coincide(got, want) -> float:
    """Share of the points of ``got (B, N, 3)`` that lie within 1e-5 of a
    point of the same batch element of ``want``."""
    from threepu_torch.ops.chamfer import nn_one_way
    d, _ = nn_one_way(got.contiguous(), want.contiguous())
    return float((d <= 1e-10).double().mean())


def check_batches(fx, tfx, dev, card: str) -> None:
    """Phase 5a, first half: ``sample_batch`` on the card with the
    fixture's draws against the JAX package's batches."""
    import torch
    from threepu_torch.data import sample_batch
    shape, lab2, lab16 = normalize_by_input(
        fx["input"][None], tfx["label_2"][None], fx["gt"][None])
    for ratio, label in ((2, lab2), (16, lab16)):
        x, gt = sample_batch(
            torch.from_numpy(shape[0]).to(dev),
            torch.from_numpy(label[0]).to(dev), ratio, TRAIN_BATCH,
            TRAIN_POINTS,
            seed_idx=torch.from_numpy(tfx[f"sample_seed_{ratio}"]).to(dev),
            angles=torch.from_numpy(tfx[f"angles_{ratio}"]).to(dev))
        shares = [coincide(got, torch.from_numpy(tfx[f"{k}_{ratio}"]).to(dev))
                  for got, k in ((x, "input"), (gt, "gt"))]
        print(f"train batch ratio {ratio}: {tuple(x.shape)} / "
              f"{tuple(gt.shape)}, points coinciding with JAX's batch: "
              f"input {shares[0]:.6f}, gt {shares[1]:.6f} [{card}]",
              flush=True)
        if not min(shares) >= BATCH_BAND:
            raise AssertionError(f"ratio {ratio}: sampled batch differs from "
                                 "JAX's")


def step_grads(net, x, gt, ratio: int, seed_idx) -> tuple:
    """``train_loss`` and backward of ``net`` on one batch: the unweighted
    loss and every parameter's gradient (zeros where none reached it)."""
    import torch
    from threepu_torch.train import train_loss
    net.zero_grad(set_to_none=True)
    weighted, cd, _, _ = train_loss(net, x, gt, ratio, seed_idx=seed_idx)
    weighted.backward()
    return float(cd.detach()), {
        name: p.grad if p.grad is not None else torch.zeros_like(p)
        for name, p in net.named_parameters()}


def compare_grads(loss: float, grads: dict, ref_loss: float,
                  ref_grads: dict) -> dict:
    """The loss's relative error against ``ref_loss``, each gradient
    tensor's relative L2 error against ``ref_grads`` (same names), and all
    gradients together's.  Raises where a reference gradient is zero and
    the other is not."""
    per, num, den = {}, 0.0, 0.0
    for name, g in grads.items():
        w = ref_grads[name].to(g.device)
        e2, w2 = float(((g - w) ** 2).sum()), float((w ** 2).sum())
        num, den = num + e2, den + w2
        if w2 > 0:
            per[name] = (e2 / w2) ** 0.5
        elif e2 > 0:
            raise AssertionError(f"{name} has a gradient where the "
                                 "reference's is zero")
    worst = max(per, key=per.get)
    return dict(loss=loss, ref_loss=ref_loss,
                loss_err=abs(loss - ref_loss) / ref_loss,
                grad_err=(num / den) ** 0.5, worst=worst,
                worst_err=per[worst])


def grad_errors(net, tfx, ratio: int, dev) -> dict:
    """``train_loss`` and backward on the fixture's ratio-``ratio`` batch
    with JAX's re-patch seeds, against JAX's loss and gradients
    (:func:`compare_grads`).  The gradients stay in ``net``."""
    import torch
    from threepu_torch.io.weights import state_dict_from_jax

    def arr(key):
        return torch.from_numpy(tfx[key]).to(dev)

    loss, grads = step_grads(net, arr(f"input_{ratio}"), arr(f"gt_{ratio}"),
                             ratio, list(arr(f"repatch_{ratio}")))
    prefix = f"grad_{ratio}/"
    want = state_dict_from_jax({k[len(prefix):]: tfx[k] for k in tfx.files
                                if k.startswith(prefix)})
    return compare_grads(loss, grads, float(tfx[f"loss_{ratio}"]), want)


def decision_sites() -> dict:
    """Where a train step makes its discrete choices, as ``{name: (module,
    function, positions)}``: every k-smallest selection (the edge convs'
    kNN, the re-patch and gt-patch picks), the interlevel picks and the
    Chamfer argmins of both directions.  Each function returns a tuple
    whose int32 indices stand at ``positions``: ``(values, indices)``, and
    ``(dist1, idx1, dist2, idx2)`` for the Chamfer pair."""
    import threepu_torch.models.upsampler as up_mod
    import threepu_torch.ops.chamfer as ch_mod
    import threepu_torch.ops.knn as knn_mod
    return {"select": (knn_mod, "exact_select", (1,)),
            "interlevel": (up_mod, "interlevel", (1,)),
            "chamfer": (ch_mod, "nn_both_ways", (1, 3))}


@contextlib.contextmanager
def recorded_decisions():
    """Yields ``{site: [indices, ...]}``, filled in call order with the
    indices every :func:`decision_sites` function returns inside (a
    Chamfer call adds its two directions' in turn)."""
    rec = {name: [] for name in decision_sites()}
    with contextlib.ExitStack() as stack:
        for name, (mod, attr, positions) in decision_sites().items():
            def record(*args, _orig=getattr(mod, attr), _name=name,
                       _positions=positions):
                out = _orig(*args)
                rec[_name].extend(out[p].detach() for p in _positions)
                return out
            stack.enter_context(mock.patch.object(mod, attr, record))
        yield rec


@contextlib.contextmanager
def replayed_decisions(rec: dict):
    """Inside, the train cascade takes the decisions ``rec`` recorded
    (:func:`recorded_decisions`) in call order, on its own device, and
    computes its values from them as the plain versions do: a gather of
    the selected distances, the interlevel skip from the given picks, the
    Chamfer distances to the given points.  So only rounding parts the
    run from the recorded one.  Yields ``{site: [equal, total]}``: how
    many of the replayed indices equal those the run would have chosen
    itself."""
    import torch
    import threepu_torch.ops.chamfer as ch_mod
    import threepu_torch.ops.interlevel as il_mod
    import threepu_torch.ops.knn as knn_mod
    from threepu_torch.ops.distances import sq_dist3
    from threepu_torch.ops.gather import batched_gather

    its = {name: iter(v) for name, v in rec.items()}
    agree = {name: [0, 0] for name in rec}

    def take(name, own):
        idx = next(its[name], None)
        if idx is None or idx.numel() != own.numel():
            raise ValueError(f"the replayed {name} decisions do not fit "
                             "this step")
        idx = idx.to(own.device).reshape(own.shape).to(own.dtype)
        agree[name][0] += int((idx == own).sum())
        agree[name][1] += own.numel()
        return idx

    select, nn_both_ways, picks = (knn_mod.exact_select,
                                   ch_mod.nn_both_ways, il_mod._plain_picks)

    def replay_select(d, k):
        idx = take("select", select(d, k)[1])
        return torch.gather(d, -1, idx.long()), idx

    def replay_nn(a, b):
        own = nn_both_ways(a, b)
        i1, i2 = take("chamfer", own[1]), take("chamfer", own[3])
        return (sq_dist3(a, batched_gather(b, i1)), i1,
                sq_dist3(b, batched_gather(a, i2)), i2)

    def replay_picks(q_xyz, prev_xyz, prev_dup, k):
        return take("interlevel", picks(q_xyz, prev_xyz, prev_dup, k))

    with mock.patch.object(knn_mod, "exact_select", replay_select), \
            mock.patch.object(ch_mod, "nn_both_ways", replay_nn), \
            mock.patch.object(il_mod, "_plain_picks", replay_picks):
        yield agree
    left = [name for name, it in its.items() if next(it, None) is not None]
    if left:
        raise ValueError(f"the step made fewer {left} decisions than were "
                         "recorded")


def pinned_errors(net, tfx, ratio: int, loss: float, rec: dict) -> dict:
    """The loss and gradients ``net`` holds from its ratio-``ratio`` step
    on the fixture's batch (:func:`grad_errors`) against the same step of
    the port on the CPU, on the same weights, fed that step's decisions
    ``rec`` (:func:`compare_grads`; ``agree``: per site, the share of the
    decisions the CPU would have made itself that equal the card's)."""
    import torch
    from threepu_torch.models import load_net
    cpu = load_net(device="cpu", **NET)
    cpu.load_state_dict(net.state_dict())
    grads = {name: p.grad if p.grad is not None else torch.zeros_like(p)
             for name, p in net.named_parameters()}
    with replayed_decisions(rec) as agree:
        ref_loss, ref_grads = step_grads(
            cpu, torch.from_numpy(tfx[f"input_{ratio}"]),
            torch.from_numpy(tfx[f"gt_{ratio}"]), ratio,
            list(torch.from_numpy(tfx[f"repatch_{ratio}"])))
    return dict(compare_grads(loss, grads, ref_loss, ref_grads),
                agree={k: eq / max(1, n) for k, (eq, n) in agree.items()})


def check_pinned(st: dict) -> None:
    """Phase 5a's bands for the card against the CPU with the card's
    decisions replayed; raises on the first reading outside them."""
    for key, band in (("loss_err", PIN_LOSS_BAND), ("grad_err", PIN_GRAD_BAND),
                      ("worst_err", PIN_TENSOR_BAND)):
        if not st[key] <= band:
            raise AssertionError(f"ratio 16, decisions pinned: {key} "
                                 f"{st[key]:.3e} outside {band:.1e} "
                                 f"(worst tensor {st['worst']})")
    for site, share in st["agree"].items():
        if not share >= DECISION_BAND:
            raise AssertionError(f"ratio 16: only {share:.5f} of the {site} "
                                 "decisions of the card are the CPU's")


#: kinds of device work for the profile, first match wins (lower-cased
#: kernel names)
KINDS = (("select kernel", ("select_kernel",)),
         ("interlevel kernel", ("interlevel_kernel",)),
         ("chamfer kernel", ("nn_kernel",)),
         ("fps kernel", ("fps_kernel",)),
         ("edge-conv kernel", ("edgeconv_kernel",)),
         ("cuBLAS GEMM", ("gemm", "xmma", "cutlass")),
         ("sorts", ("sort",)),
         ("memcpy, memset", ("memcpy", "memset")),
         ("gathers, scatters, index_add", ("gather", "scatter", "index")),
         ("reductions", ("reduce",)))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other elementwise"


def union_us(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def device_time(prof) -> tuple:
    """``(intervals, by_kind, by_name)`` of the device work a finished
    ``torch.profiler`` run recorded: every op's ``(start, end)`` in µs,
    ``{kind: [ops, µs]}`` and ``{kernel name: µs}``; raises where it
    recorded none."""
    from torch.autograd import DeviceType
    by_kind = defaultdict(lambda: [0, 0.0])
    by_name = defaultdict(float)
    intervals = []
    for ev in prof.events():
        # a user annotation (such as Adam.step's) spans kernels it holds
        if ev.device_type != DeviceType.CUDA or ev.is_user_annotation:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        intervals.append((s, e))
        by_kind[kind_of(ev.name)][0] += 1
        by_kind[kind_of(ev.name)][1] += e - s
        by_name[ev.name] += e - s
    if not intervals:
        raise RuntimeError("the profiler recorded no device time")
    return intervals, by_kind, by_name


def profile_steps(step, steps: int, step_ms: float, card: str,
                  what: str = "train steps") -> None:
    """``steps`` calls of ``step`` (``what`` names them) under
    ``torch.profiler``: device time per step by kind of kernel, the device-busy time (the union of all
    device intervals), its idle share against ``step_ms`` (the unprofiled
    step) and the ten kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    intervals, by_kind, by_name = device_time(prof)
    busy_ms = union_us(intervals) / 1e3 / steps
    print(f"profile, {steps} {what}: device busy {busy_ms:.3f} ms/step, "
          f"{len(intervals) / steps:.0f} device ops/step, "
          f"idle share {1 - busy_ms / step_ms:.4f} of the unprofiled "
          f"{step_ms:.3f} ms/step [{card}]", flush=True)
    print("| Device time per step | ops | ms | share of busy |")
    print("| --- | --- | --- | --- |")
    for kind, (n, us) in sorted(by_kind.items(), key=lambda kv: -kv[1][1]):
        ms = us / 1e3 / steps
        print(f"| {kind} | {n / steps:.0f} | {ms:.3f} | {ms / busy_ms:.1%} |")
    print("top kernels (ms/step):")
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {us / 1e3 / steps:9.3f}  {kname[:110]}", flush=True)


def train_checks(fx, tfx, card: str, kernels: dict,
                 profile: int = 0) -> tuple:
    """Phase 5: returns the launch count of each kernel in the five
    checked Adam steps, and the warm ms/step of phase 5c.  With
    ``profile`` > 0, that many more steps run under ``torch.profiler``
    after the timed ones."""
    import torch
    from threepu_torch.models import load_net
    from threepu_torch.train import make_optimizer, train_step

    net = load_net(WEIGHTS, **NET)          # the card is the default device
    dev = next(net.parameters()).device
    check_batches(fx, tfx, dev, card)

    for ratio in (2, 16):
        with recorded_decisions() as rec:
            st = grad_errors(net, tfx, ratio, dev)
        ctl_loss = float(np.max(tfx[f"control_loss_{ratio}"]))
        ctl_grad = float(np.max(tfx[f"control_grad_{ratio}"]))
        print(f"train ratio {ratio}: loss {st['loss']:.9e} (JAX "
              f"{st['ref_loss']:.9e}, rel err {st['loss_err']:.3e}; control "
              f"{ctl_loss:.3e}); gradients rel L2 {st['grad_err']:.3e} "
              f"(control {ctl_grad:.3e}), worst tensor {st['worst_err']:.3e} "
              f"({st['worst']}) [{card}]", flush=True)
        loss_band = R2_LOSS_BAND if ratio == 2 else ctl_loss
        if not st["loss_err"] <= loss_band:
            raise AssertionError(f"ratio {ratio}: loss outside its band "
                                 f"{loss_band:.3e}")
        if not st["grad_err"] <= ctl_grad:
            raise AssertionError(f"ratio {ratio}: gradients outside the "
                                 "float-noise control")
        if ratio == 2 and not st["worst_err"] <= R2_TENSOR_BAND:
            raise AssertionError(f"ratio 2: {st['worst']} outside "
                                 f"{R2_TENSOR_BAND}")
        if ratio == 16:
            t0 = time.perf_counter()
            pin = pinned_errors(net, tfx, ratio, st["loss"], rec)
            print(f"train ratio 16 against the port on the CPU, decisions "
                  f"pinned: loss rel err {pin['loss_err']:.3e}, gradients "
                  f"rel L2 {pin['grad_err']:.3e}, worst tensor "
                  f"{pin['worst_err']:.3e} ({pin['worst']}); decisions the "
                  f"CPU shares {pin['agree']}; CPU step "
                  f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
            check_pinned(pin)

    opt = make_optimizer(net.parameters(), TRAIN_LR)
    x = torch.from_numpy(tfx["input_16"]).to(dev)
    gt = torch.from_numpy(tfx["gt_16"]).to(dev)
    train_kernels = {k: kernels[k] for k in ("select", "interlevel",
                                             "chamfer")}
    for k in kernels.values():
        k.launches = 0
    losses = []
    for seeds in tfx["adam_repatch"]:
        before = {name: k.launches for name, k in train_kernels.items()}
        losses.append(float(train_step(
            net, opt, x, gt, 16,
            seed_idx=list(torch.from_numpy(seeds).to(dev)))))
        for name, k in train_kernels.items():
            if k.launches <= before[name]:
                raise AssertionError(f"a train step never launched {name}")
        chamfer = train_kernels["chamfer"].launches - before["chamfer"]
        if chamfer != 1:
            raise AssertionError(f"a train step launched the Chamfer kernel "
                                 f"{chamfer} times, not once")
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"train-path launches (5 steps): {launches}", flush=True)
    jax_losses = [float(v) for v in tfx["adam_loss"]]
    print(f"adam ratio 16, 5 steps: losses {losses}; JAX {jax_losses}; rel "
          f"diff {[round(abs(a - b) / b, 6) for a, b in zip(losses, jax_losses)]}"
          f" [{card}]", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError("a training loss is not finite")

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def step():
        train_step(net, opt, x, gt, 16, generator=gen)

    times = []
    for i in range(12):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(times))
    print(f"train step ratio 16, batch {TRAIN_BATCH} x {TRAIN_POINTS}: warm "
          f"{step_ms:.3f} ms/step (median of 10; "
          f"{[round(t, 3) for t in times]}) [{card}]", flush=True)
    if profile:
        profile_steps(step, profile, step_ms, card)
    return launches, step_ms


# ------------------------------------------------------------ phase 6
def data_file(tmp: str) -> str:
    """Phase 6a's training file: the port's synthetic shapes as ``.npz``
    (the card's machine has no h5py)."""
    from threepu_torch.data.synthetic import write_synthetic_h5
    name = "train_" + "_".join(f"poisson_{r}" for r in DATA_RESOLUTIONS)
    return write_synthetic_h5(tmp, n_shapes=DATA_SHAPES, seed=SEED,
                              resolutions=DATA_RESOLUTIONS,
                              filename=name + ".npz")


def check_data(path: str, dev, card: str) -> None:
    """Phase 6a: the file loads with the expected resolutions, and one
    batch a ratio, cut on the card, holds the points the same draws cut on
    the CPU."""
    from threepu_torch.data import DeviceDataset, load_h5_data, step_generator
    from threepu_torch.ops.chamfer import nn_one_way

    n_in = DATA_RESOLUTIONS[0]
    data, labels, _ = load_h5_data(path, n_in, 16, 2)
    got = {r: v.shape for r, v in labels.items()}
    want = {2 ** i: (DATA_SHAPES, n_in * 2 ** i, 3) for i in range(1, 5)}
    if data.shape != (DATA_SHAPES, n_in, 3) or got != want:
        raise AssertionError(f"load_h5_data: input {data.shape}, labels {got}")
    card_ds, cpu_ds = (DeviceDataset(path, n_in, TRAIN_POINTS, TRAIN_BATCH,
                                     device=d) for d in (dev, "cpu"))
    for ratio in (2, 4, 8, 16):
        draws = cpu_ds.draws(step_generator(SEED, ratio))
        on_card = card_ds.sample(ratio, ratio, **draws)
        on_cpu = cpu_ds.sample(ratio, ratio, **draws)
        shares, errs = [], []
        for got, want in zip(on_card, on_cpu):
            want = want.to(dev)
            d, _ = nn_one_way(got.contiguous(), want.contiguous())
            shares.append(float((d <= DATA_BAND ** 2).double().mean()))
            errs.append(float((got - want).abs().max()))
        print(f"train data ratio {ratio}, shape {ratio % DATA_SHAPES}: "
              f"{tuple(on_card[0].shape)} / {tuple(on_card[1].shape)}, points "
              f"within {DATA_BAND} of the CPU's batch: input {shares[0]:.6f}, "
              f"gt {shares[1]:.6f}; max abs diff in order {errs} [{card}]",
              flush=True)
        if not min(shares) >= BATCH_BAND:
            raise AssertionError(f"ratio {ratio}: the card's batch is not "
                                 "the CPU's")


def loop_step_patch(wrap, sharded: bool = False):
    """A patch that hands the step function ``train_loop`` calls to
    ``wrap`` and calls what it returns instead: ``train.train_step``, or
    with ``sharded`` each step that ``parallel.make_sharded_train_step``
    makes (a loop with ``TrainConfig.mesh``)."""
    if sharded:
        import threepu_torch.parallel as par_mod
        make = par_mod.make_sharded_train_step
        return mock.patch.object(
            par_mod, "make_sharded_train_step",
            lambda net, opt, mesh: wrap(make(net, opt, mesh)))
    import threepu_torch.train.loop as loop_mod
    return mock.patch.object(loop_mod, "train_step",
                             wrap(loop_mod.train_step))


@contextlib.contextmanager
def watched_steps(kernels: dict, syncs: bool = False, sharded: bool = False):
    """Wraps the loop's step function (:func:`loop_step_patch`); yields
    the list of its calls, each ``{"ratio", "loss" (on the device),
    "launches" (per kernel), "t0"}``.  With ``syncs``, each call also
    counts the host syncs that ``torch.cuda.set_sync_debug_mode`` reports
    from its start to the next call's (the step, then the loop's
    bookkeeping and the batch it issues)."""
    import warnings
    import torch
    calls = []

    def wrap(step_fn):
        def watched(net, opt, inp, gt, ratio, **kw):
            calls.append(dict(ratio=ratio, syncs=0, t0=time.perf_counter()))
            start = {n: k.launches for n, k in kernels.items()}
            out = step_fn(net, opt, inp, gt, ratio, **kw)
            calls[-1].update(loss=out[0] if kw.get("with_pred") else out,
                             launches={n: k.launches - start[n]
                                       for n, k in kernels.items()})
            return out
        return watched

    def on_warning(message, *args, **kwargs):
        if "synchroniz" in str(message) and calls:
            calls[-1]["syncs"] += 1

    with warnings.catch_warnings(), loop_step_patch(wrap, sharded):
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        if syncs:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield calls
        finally:
            torch.cuda.set_sync_debug_mode("default")


def loop_config(path: str, tmp: str, **kw):
    """Phase 6's ``TrainConfig``: the training file, 16 x 312 patches of
    5000-point shapes, the net of ``NET``, resumed from ``WEIGHTS`` with
    the curriculum at ratios 2-16 combined, threshold on."""
    from threepu_torch.train import TrainConfig
    base = dict(h5_data=path, num_shape_point=DATA_RESOLUTIONS[0],
                num_point=TRAIN_POINTS, batch_size=TRAIN_BATCH,
                up_ratio=NET["max_up_ratio"], step_ratio=NET["step_ratio"],
                knn=NET["knn"], growth_rate=NET["growth_rate"],
                dense_n=NET["dense_n"], fm_knn=NET["fm_knn"],
                max_num_point=NET["max_num_point"], lr_init=TRAIN_LR,
                stage_steps=LOOP_STAGE_STEPS, log_steps=LOOP_LOG_STEPS,
                ckpt=WEIGHTS, model_dir=os.path.join(tmp, "loop"))
    base.update(kw)
    return TrainConfig(**base)


def check_restore(cfg, start: int, tmp: str, card: str) -> None:
    """Phase 6b, first: the loop's state restored from ``WEIGHTS``, written
    back by ``save_train_checkpoint``, equals the file: the parameters,
    every Adam leaf and the fingerprint, bit for bit and dtype for
    dtype."""
    from threepu_torch.io import save_train_checkpoint
    from threepu_torch.train import train_loop
    state, _ = train_loop(cfg, max_steps=start)
    back = os.path.join(tmp, "restored.npz")
    save_train_checkpoint(back, state.net, state.opt, step=state.step)
    with np.load(WEIGHTS) as a, np.load(back) as b:
        bad = sorted(set(a.files) ^ set(b.files)) + [
            k for k in a.files if k in b.files and not (
                a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]))]
        n_opt = sum(k.startswith("opt/") for k in a.files)
    print(f"loop resumed {os.path.basename(WEIGHTS)} at step {state.step}: "
          f"its parameters and {n_opt} Adam leaves written back "
          f"{'differ at ' + str(bad[:5]) if bad else 'bit for bit'} [{card}]",
          flush=True)
    if bad or state.step != start:
        raise AssertionError("the loop did not restore the file's state")


def check_loop(cfg, start: int, card: str, kernels: dict) -> dict:
    """Phase 6b: ``LOOP_STEPS`` steps of the loop resumed from ``WEIGHTS``:
    ratios 2 to 16 drawn, the kernels launched in every step (the Chamfer
    kernel once, interlevel once a level past the first), finite losses,
    one running mean a ratio, and no host sync on a step that does not
    log.  Returns the launch count of each kernel in the run."""
    import torch
    from threepu_torch.train import train_loop
    logged = []

    def log_fn(step, ratio, loss, state, batch, pred=None, gt_out=None,
               error=None):
        logged.append((step, ratio, None if pred is None else pred.shape,
                       error))

    for k in kernels.values():
        k.launches = 0
    with watched_steps(kernels, syncs=True) as calls:
        state, error_log = train_loop(cfg, max_steps=start + LOOP_STEPS,
                                      log_fn=log_fn)
    launches = checked_launches(kernels, ("select", "interlevel", "chamfer"),
                                "training-loop")
    losses = torch.stack([c["loss"] for c in calls]).cpu().numpy()
    ratios = [c["ratio"] for c in calls]
    log_at = [(start + i + 1) % cfg.log_steps == 0 or i == len(calls) - 1
              for i in range(len(calls))]
    syncs = [c["syncs"] for c in calls]
    print(f"loop, {len(calls)} steps from step {start}: ratios {ratios}; "
          f"losses {losses.tolist()}; error_log "
          f"{dict(sorted(error_log.items()))}; log_fn at "
          f"{[(s, r) for s, r, _, _ in logged]}; host syncs a step {syncs} "
          f"(log steps {[i for i, on in enumerate(log_at) if on]}) [{card}]",
          flush=True)
    if len(calls) != LOOP_STEPS or state.step != start + LOOP_STEPS:
        raise AssertionError(f"the loop ran {len(calls)} steps")
    if set(ratios) != {2, 4, 8, 16}:
        raise AssertionError(f"the loop drew the ratios {sorted(set(ratios))}")
    for c in calls:
        levels = int(np.log2(c["ratio"]))
        got = c["launches"]
        if (got["select"] <= 0 or got["chamfer"] != 1
                or got["interlevel"] != levels - 1):
            raise AssertionError(f"a ratio-{c['ratio']} loop step launched "
                                 f"{got}")
    if not np.isfinite(losses).all():
        raise AssertionError("a loss of the loop is not finite")
    if set(error_log) != {f"cd_loss_x{r}" for r in set(ratios)}:
        raise AssertionError(f"error_log keys {sorted(error_log)}")
    if len(logged) != LOOP_STEPS // cfg.log_steps or \
            any(shape is None or not np.isfinite(err)
                for _, _, shape, err in logged):
        raise AssertionError(f"log_fn calls {logged}")
    off_log = [n for n, on in zip(syncs, log_at) if not on]
    if any(off_log):
        raise AssertionError(f"{sum(off_log)} host syncs on steps that do "
                             "not log")
    return launches


def fresh_steps(cfg, device, steps: int, feed=None) -> tuple:
    """``steps`` steps of the loop from a fresh net on ``device``: the
    final state and, per step, ``(input, gt, loss)`` of the batch the
    loop cut; with ``feed`` (such a list), each step trains on ``feed``'s
    batch instead."""
    import threepu_torch.train.loop as loop_mod
    from threepu_torch.train import train_loop
    rec = []
    step_fn = loop_mod.train_step

    def fed(net, opt, inp, gt, ratio, **kw):
        own = (inp, gt)
        if feed is not None:
            inp, gt = (t.to(inp.device) for t in feed[len(rec)][:2])
        loss = step_fn(net, opt, inp, gt, ratio, **kw)
        rec.append((*own, loss))
        return loss

    with mock.patch.object(loop_mod, "train_step", fed):
        state, _ = train_loop(cfg, max_steps=steps, device=device)
    return state, rec


def check_fresh_ratio2(cfg, dev, card: str) -> None:
    """Phase 6b, ratio 2: ``FRESH_STEPS`` steps of a fresh net (stage 0)
    on the card and on the CPU with the same step-keyed draws, the CPU
    fed the card's batches: each loss within ``R2_LOSS_BAND`` (relative),
    each parameter within ``R2_TENSOR_BAND`` (relative L2); the CPU's own
    batches hold the card's points (``BATCH_BAND``)."""
    import torch
    from threepu_torch.train import train_loop
    fresh = dataclasses.replace(cfg, ckpt=None)
    card_state, card_rec = fresh_steps(fresh, dev, FRESH_STEPS)
    cpu_state, cpu_rec = fresh_steps(fresh, "cpu", FRESH_STEPS, card_rec)
    init = dict(train_loop(fresh, max_steps=0, device="cpu")[0]
                .net.named_parameters())
    loss_errs, shares = [], []
    for (x, gt, loss), (own_x, own_gt, ref) in zip(card_rec, cpu_rec):
        loss_errs.append(abs(float(loss) - float(ref)) / float(ref))
        shares += [coincide(a.to(dev), b) for a, b in ((own_x, x),
                                                        (own_gt, gt))]
    def rel(diff: float, ref: torch.Tensor) -> float:
        ref = float(ref.detach().norm())
        return diff / ref if ref > 0 else (0.0 if diff == 0 else np.inf)

    cpu = dict(cpu_state.net.named_parameters())
    p_err, u_err = {}, {}
    for name, p in card_state.net.named_parameters():
        diff = float((p.detach().cpu() - cpu[name].detach()).norm())
        p_err[name] = rel(diff, cpu[name])
        u_err[name] = rel(diff, cpu[name] - init[name])
    worst, worst_u = max(p_err, key=p_err.get), max(u_err, key=u_err.get)
    print(f"fresh net, {FRESH_STEPS} ratio-2 loop steps, card against CPU: "
          f"losses {[float(r[2]) for r in card_rec]}, rel err {loss_errs}; "
          f"parameters rel L2 worst {p_err[worst]:.3e} ({worst}); updates "
          f"rel L2 worst {u_err[worst_u]:.3e} ({worst_u}); the CPU's own "
          f"batches hold {min(shares):.6f} of the card's points [{card}]",
          flush=True)
    if not max(loss_errs) <= R2_LOSS_BAND:
        raise AssertionError(f"ratio-2 loop loss outside {R2_LOSS_BAND}")
    if not p_err[worst] <= R2_TENSOR_BAND:
        raise AssertionError(f"{worst} outside {R2_TENSOR_BAND}")
    if not min(shares) >= BATCH_BAND:
        raise AssertionError("the loop's batches on the card and the CPU "
                             "differ")


def time_loop(cfg, start: int, card: str, bare_ms: float) -> float:
    """Phase 6b, timing: the loop resumed at ratio 16 only, threshold off
    (as phase 5c's bare step), with the default ``log_steps``: the warm
    ms/step over ``LOOP_TIMED`` steps after ``LOOP_WARM``, each end read
    after a device sync, then ``LOOP_PROFILED`` steps under
    ``torch.profiler``: the device's idle share of a loop step.  Returns
    the warm ms/step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import threepu_torch.train.loop as loop_mod
    from threepu_torch.train import TrainConfig, train_loop
    timed_cfg = dataclasses.replace(cfg, stage_steps=TIMING_STAGE_STEPS,
                                    log_steps=TrainConfig.log_steps)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks, ratios = [], []
    step_fn = loop_mod.train_step

    def timed(net, opt, inp, gt, ratio, **kw):
        if len(ratios) in (LOOP_WARM, LOOP_WARM + LOOP_TIMED):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if len(marks) == 2:
                prof.start()
        ratios.append(ratio)
        return step_fn(net, opt, inp, gt, ratio, **kw)

    with mock.patch.object(loop_mod, "train_step", timed):
        train_loop(timed_cfg, max_steps=start + LOOP_WARM + LOOP_TIMED
                   + LOOP_PROFILED)
    torch.cuda.synchronize()
    prof.stop()
    if set(ratios) != {16}:
        raise AssertionError(f"the timed loop drew ratios {set(ratios)}")
    step_ms = (marks[1] - marks[0]) * 1e3 / LOOP_TIMED
    intervals, by_kind, _ = device_time(prof)
    busy_ms = union_us(intervals) / 1e3 / LOOP_PROFILED
    print(f"loop ratio 16, batch {TRAIN_BATCH} x {TRAIN_POINTS}: warm "
          f"{step_ms:.3f} ms/step ({LOOP_TIMED} steps; bare train_step "
          f"{bare_ms:.3f} ms/step, phase 5c); profiled {LOOP_PROFILED} steps: "
          f"device busy {busy_ms:.3f} ms/step, "
          f"{len(intervals) / LOOP_PROFILED:.0f} device ops/step, idle share "
          f"{1 - busy_ms / step_ms:.4f} of the unprofiled step [{card}]",
          flush=True)
    return step_ms


def check_resume(cfg, start: int, tmp: str, card: str) -> None:
    """Phase 6c: ``RESUME_STEPS`` loop steps, ``save_train_checkpoint``,
    then ``RESUME_STEPS`` more from the file, against ``2 *
    RESUME_STEPS`` straight steps: the largest parameter difference no
    more than twice the largest between two of ``RESUME_CONTROL_RUNS``
    straight runs (the backward's atomic sums round in any order on the
    card, and a resumed run is one more such run)."""
    import itertools
    from threepu_torch.io import save_train_checkpoint
    from threepu_torch.train import train_loop
    end = start + 2 * RESUME_STEPS
    straight = [train_loop(cfg, max_steps=end)[0]
                for _ in range(RESUME_CONTROL_RUNS)]
    half, _ = train_loop(cfg, max_steps=start + RESUME_STEPS)
    path = os.path.join(tmp, "half.npz")
    save_train_checkpoint(path, half.net, half.opt, step=half.step)
    resumed, _ = train_loop(dataclasses.replace(cfg, ckpt=path),
                            max_steps=end)

    def max_diff(a, b):
        pb = dict(b.net.named_parameters())
        return max(float((p - pb[n]).detach().abs().max())
                   for n, p in a.net.named_parameters())

    pairs = [max_diff(a, b) for a, b in itertools.combinations(straight, 2)]
    control, gap = max(pairs), max_diff(resumed, straight[0])
    print(f"resume on the card: {RESUME_STEPS} + {RESUME_STEPS} steps against "
          f"{2 * RESUME_STEPS} straight: largest parameter difference "
          f"{gap:.3e}; pairs of straight runs differ by "
          f"{[f'{d:.3e}' for d in pairs]} [{card}]", flush=True)
    if resumed.step != end or not gap <= 2 * control:
        raise AssertionError("the resumed run is outside twice its control")


def check_cli_train(path: str, tmp: str, fx, card: str,
                    kernels: dict) -> dict:
    """Phase 6d: ``cli.main(["--phase", "train", ...])``, one epoch of 300
    steps of batch 1 over curriculum stages 0-4, writes ``model_1.npz``;
    ``--phase test`` with it upsamples the fixture's shape to 80,000
    points, and the same weights saved as ``.pth`` give that output bit
    for bit.  Returns the launch count of each kernel in the training
    run, and in the two ``--phase test`` runs."""
    from threepu_torch import cli
    from threepu_torch.io import read_ply, save_pth
    from threepu_torch.models import load_net
    log_dir = os.path.join(tmp, "cli")
    net_flags = ["--num_point", str(TRAIN_POINTS), "--up_ratio",
                 str(NET["max_up_ratio"]), "--knn", str(NET["knn"]),
                 "--growth_rate", str(NET["growth_rate"]), "--dense_n",
                 str(NET["dense_n"]), "--fm_knn", str(NET["fm_knn"])]
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    cli.main(["--phase", "train", "--h5_data", path, "--num_shape_point",
              str(DATA_RESOLUTIONS[0]), "--batch_size", "1", "--max_epoch",
              "1", "--stage_steps", str(CLI_STAGE_STEPS), "--log_dir",
              log_dir, "--id", "smoke"] + net_flags)
    train_s = time.perf_counter() - t0
    launches = checked_launches(kernels, ("select", "interlevel", "chamfer"),
                                "cli --phase train")
    ckpt = os.path.join(log_dir, "smoke", "model_1.npz")
    with np.load(ckpt) as f:
        step = int(f["step"])
    if step != 300:
        raise AssertionError(f"model_1.npz holds step {step}, not 300")
    os.mkdir(os.path.join(tmp, "shapes"))
    np.savetxt(os.path.join(tmp, "shapes", "shape0.xyz"), fx["input"])
    pth = save_pth(os.path.join(tmp, "model_1.pth"),
                   load_net(ckpt, device="cpu", **NET), step=step)
    outs = {}
    for k in kernels.values():
        k.launches = 0
    for name, weights in (("npz", ckpt), ("pth", pth)):
        cli.main(["--phase", "test", "--ckpt", weights, "--test_data",
                  os.path.join(tmp, "shapes", "*.xyz"), "--result_dir",
                  os.path.join(tmp, f"out_{name}")] + net_flags)
        outs[name] = read_ply(os.path.join(tmp, f"out_{name}", "shapes",
                                           "shape0.ply"))
    test_launches = checked_launches(kernels, ("select", "fps", "interlevel"),
                                     "cli --phase test, .npz and .pth")
    n_out = fx["input"].shape[0] * NET["max_up_ratio"]
    same = np.array_equal(outs["npz"], outs["pth"])
    print(f"cli --phase train: 300 steps of batch 1, stages 0-4, in "
          f"{train_s:.1f} s with set-up; model_1.npz at step {step}; "
          f"--phase test with it: {outs['npz'].shape}, finite "
          f"{bool(np.isfinite(outs['npz']).all())}; through .pth the same "
          f"bit for bit: {same} [{card}]", flush=True)
    if outs["npz"].shape != (n_out, 3) or not np.isfinite(outs["npz"]).all():
        raise AssertionError("--phase test with the trained checkpoint")
    if not same:
        raise AssertionError("the .pth checkpoint upsamples otherwise")
    return launches, test_launches


def file_training(fx, card: str, kernels: dict, bare_ms: float) -> tuple:
    """Phase 6: training from a file (6a-6d); returns the launch count of
    each kernel on the paths it drives: the loop (6b), the command line's
    training run and its two test runs (6d); and the loop's warm
    ms/step."""
    import tempfile
    from threepu_torch.device import require_cuda
    dev = require_cuda()
    start = int(np.load(WEIGHTS)["step"])
    with tempfile.TemporaryDirectory() as tmp:
        path = data_file(tmp)
        check_data(path, dev, card)
        cfg = loop_config(path, tmp)
        check_restore(cfg, start, tmp, card)
        loop = check_loop(cfg, start, card, kernels)
        check_fresh_ratio2(cfg, dev, card)
        loop_ms = time_loop(cfg, start, card, bare_ms)
        check_resume(cfg, start, tmp, card)
        cli_train, cli_test = check_cli_train(path, tmp, fx, card, kernels)
    return {"loop": loop, "cli_train": cli_train, "cli_test": cli_test}, \
        loop_ms

# ------------------------------------------------------------ phase 7
def surface_state(sfx, prefix: str) -> dict:
    """The port's state dict from the fixture's JAX parameters stored
    under ``prefix`` (``step4_params/``, ``adaptive_params/``)."""
    from threepu_torch.io.weights import state_dict_from_jax
    return state_dict_from_jax({k[len(prefix):]: sfx[k] for k in sfx.files
                                if k.startswith(prefix)})


def step4_net(sfx, device=None):
    """The step-4 net on JAX's initial parameters, on ``device`` (the
    card by default)."""
    from threepu_torch.models import load_net
    net = load_net(device=device, **NET4)
    net.load_state_dict(surface_state(sfx, "step4_params/"), strict=True)
    return net


def row_share(got, want, band: float = 1e-4) -> float:
    """Share of the rows (last axis) of ``got`` within ``band`` (max abs)
    of ``want``'s, a numpy array."""
    import torch
    want = torch.from_numpy(np.ascontiguousarray(want)).to(got.device)
    err = (got - want).abs().amax(-1).reshape(-1)
    return float((err <= band).double().mean())


def step4_replay(net4, fx, sfx, card: str) -> None:
    """Phase 7a: the step-4 cascade of the fixture's patch, each level fed
    JAX's input (:func:`replay_cascade`), edge convs decomposed then on
    the chain kernel; phase 4a's bands."""
    view = {"cascade_in": fx["cascade_in"],
            **{k[len("step4_"):]: sfx[k] for k in sfx.files
               if k.startswith("step4_cascade_")}}
    dev = next(net4.parameters()).device
    for chain_kernel in (False, True):
        stats = replay_cascade(net4, view, dev, chain_kernel)
        for st in stats:
            print(f"step-4 cascade replay, edge-conv kernel "
                  f"{'on' if chain_kernel else 'off'} {st} [{card}]",
                  flush=True)
        check_replay(stats)


def step4_file_to_file(net4, fx, sfx, card: str, kernels: dict,
                       off_s: float) -> dict:
    """Phase 7b: the fixture's shape through ``cli.main(["--phase",
    "test", "--step_ratio", "4", ...])`` with the step-4 weights written
    as ``.npz``, the edge-conv kernel on: (80000, 3), finite, Chamfer
    distance to the ground truth within 5% of JAX's.  Then the warm
    seconds per shape, kernel off, beside phase 4b's ``off_s``.  Returns
    the launch count of each kernel in the command line's run."""
    import tempfile
    import torch
    from threepu_torch import cli
    from threepu_torch.io import read_ply

    dev = next(net4.parameters()).device
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "step4.npz")
        np.savez(weights, step=np.int64(0),
                 **{"params/" + k[len("step4_params/"):]: sfx[k]
                    for k in sfx.files if k.startswith("step4_params/")})
        os.mkdir(os.path.join(tmp, "shapes"))
        np.savetxt(os.path.join(tmp, "shapes", "shape0.xyz"), fx["input"])
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        cli.main(["--phase", "test", "--ckpt", weights, "--step_ratio", "4",
                  "--test_data", os.path.join(tmp, "shapes", "*.xyz"),
                  "--num_point", str(int(fx["num_point"])), "--up_ratio",
                  str(int(fx["ratio"])), "--knn", str(NET4["knn"]),
                  "--chunk", str(int(fx["chunk"])), "--result_dir",
                  os.path.join(tmp, "out")])
        cli_s = time.perf_counter() - t0
        launches = checked_launches(
            kernels, ("select", "fps", "interlevel", "edgeconv"),
            "step-4 file-to-file")
        out = read_ply(os.path.join(tmp, "out", "shapes", "shape0.ply"))
    if launches["edgeconv"] != STEP4_EDGECONV_LAUNCHES:
        raise AssertionError(f"the step-4 shape launched the edge-conv kernel "
                             f"{launches['edgeconv']} times, not "
                             f"{STEP4_EDGECONV_LAUNCHES}")
    n_out = fx["input"].shape[0] * int(fx["ratio"])
    if out.shape != (n_out, 3) or not np.isfinite(out).all():
        raise AssertionError(f"step-4 file-to-file: bad output {out.shape}")
    cd_gt = chamfer(torch.from_numpy(out).to(dev),
                    torch.from_numpy(fx["gt"]).to(dev))
    jax_cd = float(sfx["step4_jax_cd_gt"])
    print(f"step-4 file-to-file, edge-conv kernel on: {fx['input'].shape[0]} "
          f"-> {n_out} in {cli_s:.3f} s with set-up; chamfer to gt "
          f"{cd_gt:.6e} (JAX {jax_cd:.6e}, ratio {cd_gt / jax_cd:.4f}; JAX "
          f"under 1e-6 input noise {float(sfx['step4_jax_pert_cd_gt']):.6e}) "
          f"[{card}]", flush=True)
    if abs(cd_gt - jax_cd) > 0.05 * jax_cd:
        raise AssertionError("step-4: chamfer to gt is not within 5% of "
                             "JAX's")
    with plain_chain(net4):
        best, times = warm_shape_s(net4, fx)
    print(f"step-4 16x warm s/shape, edge-conv kernel off {best:.4f} (runs "
          f"{[round(t, 4) for t in times]}); step-2 net {off_s:.4f} (phase "
          f"4b) [{card}]", flush=True)
    return launches


def step4_training(sfx, tfx, card: str, kernels: dict,
                   bare_ms: float) -> dict:
    """Phase 7c: the step-4 net's train step at full width.  At ratio 4
    (no re-patch) on JAX's batch: the loss within ``R4_LOSS_BAND`` of
    JAX's and every gradient tensor within ``R4_TENSOR_BAND``.  Then 5
    clipped-Adam steps at ratio 16 on phase 5's batch (16 x 312, gt 16 x
    4992), re-patch seeds from a seeded generator: finite losses, select
    and interlevel launched every step, the Chamfer kernel once.  Then
    the warm ms/step at ratio 16 beside phase 5c's ``bare_ms``.  Returns
    the launch count of each kernel in the 5 steps."""
    import torch
    from threepu_torch.io.weights import state_dict_from_jax
    from threepu_torch.train import make_optimizer, train_step

    net = step4_net(sfx).train()
    dev = next(net.parameters()).device

    def arr(f, key):
        return torch.from_numpy(f[key]).to(dev)

    loss, grads = step_grads(net, arr(sfx, "input_4"), arr(sfx, "gt_4"), 4,
                             [])
    want = state_dict_from_jax({k[len("grad_4/"):]: sfx[k]
                                for k in sfx.files if k.startswith("grad_4/")})
    st = compare_grads(loss, grads, float(sfx["loss_4"]), want)
    print(f"step-4 train ratio 4: loss {st['loss']:.9e} (JAX "
          f"{st['ref_loss']:.9e}, rel err {st['loss_err']:.3e}); gradients "
          f"rel L2 {st['grad_err']:.3e}, worst tensor {st['worst_err']:.3e} "
          f"({st['worst']}) [{card}]", flush=True)
    if not (st["loss_err"] <= R4_LOSS_BAND
            and st["worst_err"] <= R4_TENSOR_BAND):
        raise AssertionError("step-4 ratio 4: loss or a gradient outside its "
                             "band")

    opt = make_optimizer(net.parameters(), TRAIN_LR)
    x, gt = arr(tfx, "input_16"), arr(tfx, "gt_16")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    train_kernels = {k: kernels[k] for k in ("select", "interlevel",
                                             "chamfer")}
    for k in kernels.values():
        k.launches = 0
    losses = []
    for _ in range(5):
        before = {name: k.launches for name, k in train_kernels.items()}
        losses.append(float(train_step(net, opt, x, gt, 16, generator=gen)))
        for name, k in train_kernels.items():
            if k.launches <= before[name]:
                raise AssertionError(f"a step-4 train step never launched "
                                     f"{name}")
        if train_kernels["chamfer"].launches - before["chamfer"] != 1:
            raise AssertionError("a step-4 train step launched the Chamfer "
                                 "kernel more than once")
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"step-4 train-path launches (5 steps at ratio 16): {launches}; "
          f"losses {losses} [{card}]", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError("a step-4 training loss is not finite")
    times = []
    for i in range(12):
        t0 = time.perf_counter()
        train_step(net, opt, x, gt, 16, generator=gen)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    print(f"step-4 train step ratio 16, batch {TRAIN_BATCH} x {TRAIN_POINTS}: "
          f"warm {float(np.median(times)):.3f} ms/step (median of 10; "
          f"{[round(t, 3) for t in times]}); step-2 net {bare_ms:.3f} (phase "
          f"5c) [{card}]", flush=True)
    return launches


def adaptive_level(sfx, card: str, kernels: dict) -> dict:
    """Phase 7d: ``AdaptiveLevel`` at full width on JAX's initial
    parameters, 48 patches of 312 points to 35² = 1225: output and global
    features within 1e-4 of JAX's on at least ``ROWS_BAND`` of the rows,
    and of the port's on the CPU alike; select and FPS launched.  Returns
    the launch count of each kernel in the card's run."""
    import torch
    from threepu_torch.device import require_cuda
    from threepu_torch.models import AdaptiveLevel

    state = surface_state(sfx, "adaptive_params/")
    nets = {}
    for name, dev in (("card", require_cuda()), ("cpu", torch.device("cpu"))):
        nets[name] = AdaptiveLevel(**ADAPTIVE).to(dev).eval()
        nets[name].load_state_dict(state, strict=True)
    x = torch.from_numpy(sfx["patches"])
    for k in kernels.values():
        k.launches = 0
    with torch.no_grad():
        t0 = time.perf_counter()
        out, gfeat = nets["card"](x.to(require_cuda()), ADAPTIVE_TARGET)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = checked_launches(kernels, ("select", "fps"),
                                    "adaptive level")
        cpu_out, cpu_gfeat = nets["cpu"](x, ADAPTIVE_TARGET)
    shares = {"out vs JAX": row_share(out, sfx["adaptive_out"]),
              "gfeat vs JAX": row_share(gfeat, sfx["adaptive_gfeat"]),
              "out vs CPU": row_share(out, cpu_out.numpy()),
              "gfeat vs CPU": row_share(gfeat, cpu_gfeat.numpy())}
    print(f"adaptive level {tuple(x.shape)} -> {tuple(out.shape)}, global "
          f"{tuple(gfeat.shape)}: rows within 1e-4 {shares}; first call "
          f"{card_s:.3f} s [{card}]", flush=True)
    if tuple(out.shape) != (x.shape[0], 35 * 35, 3) or \
            min(shares.values()) < ROWS_BAND:
        raise AssertionError("adaptive level outside its band")
    return launches


def recomputed_graph_share(net, cap: dict, level: int, i: int) -> float:
    """Share of the rows of ``level_<level>.nnIdx_layer_<i>`` (merged, as
    :func:`threepu_torch.vis.collect_intermediates` returns them) that equal
    the ``k`` nearest of that level's captured features (``layer_0``, else
    ``layer<i+1>_prep`` of ``layer_i``), ranked by the plain selection
    (unique, the level's duplicate mask, self dropped)."""
    import torch
    import threepu_torch.ops.knn as knn_mod
    from threepu_torch.ops.distances import duplicate_mask
    from threepu_torch.ops.normalize import normalize_point_batch_cl

    dev = next(net.parameters()).device
    lvl = net.levels[f"level_{level}"]
    xyz = torch.from_numpy(cap[f"level_{level}.xyz_in"][0]).to(dev)
    got = torch.from_numpy(cap[f"level_{level}.nnIdx_layer_{i}"][0]).to(dev)
    k, n = got.shape[-1], int(NET["max_num_point"])    # (sub-)patch size
    b = xyz.shape[0] // n
    feats = torch.from_numpy(cap[f"level_{level}.layer_{i}"][0]).to(dev)
    feats = feats.reshape(b, n, -1)
    with torch.no_grad():
        if i > 0:
            feats = getattr(lvl, f"layer{i + 1}_prep")(feats)
        # the level's mask: on its input as given at level 1, else on the
        # normalized sub-patches
        src = xyz.reshape(b, n, 3)
        dup = duplicate_mask(src if level == 1
                             else normalize_point_batch_cl(src)[0])
        kernel = knn_mod.EXACT_SELECT_KERNEL
        knn_mod.set_exact_select_kernel(False)
        try:
            idx = knn_mod.knn_group(feats, feats, k + 1, unique=True,
                                    dup_mask=dup, with_neighbors=False).idx
        finally:
            knn_mod.set_exact_select_kernel(kernel)
    want = (idx[..., 1:] + torch.arange(b, device=dev, dtype=idx.dtype)
            [:, None, None] * n).reshape(-1, k)
    return float((want == got).all(-1).double().mean())


def vis_phase_check(fx, sfx, card: str, kernels: dict) -> dict:
    """Phase 7e: ``cli.main(["--phase", "vis", ...])`` with the trained
    weights on the fixture's shape at 16x, the edge-conv kernel on and
    ``Painter.interactive_3D_plot`` patched to record its arguments (the
    card's machine has no matplotlib): 16 graphs, each with its own
    level's input cloud, every index inside it; level 1's graphs of the
    first 8 patches hold JAX's frozen neighbour sets on ``GRAPH_BAND`` of
    the rows, or, where smaller, on the share JAX keeps against itself
    when its input is scaled by ``1 + 1e-6 N(0, 1)`` (the fixture's
    ``vis_control_sets``, the smallest of 8 seeds): near-equal distances
    flip under rounding, most in the deepest layer (JAX keeps 97.7-99.2%
    of layer 3's sets and 84-94% of its rows in order).  The edge conv
    maxes over the set, so the order within a row is printed only.  Then
    ``collect_intermediates`` of JAX's 48 patches: level 1's ``layer_4``
    of the first 8 within 1e-4 of JAX's on ``ROWS_BAND`` of the rows, or,
    where smaller, on JAX's own share under that noise
    (``vis_control_layer4``: a neighbour set that flips moves its row's
    max-pooled features); and each graph of every level the kNN of its
    level's captured features under the plain selection, in order, on
    ``RECOMPUTED_BAND`` of the rows.
    Returns the launch count of each kernel in the command line's run."""
    import tempfile
    import torch
    import threepu_torch.vis as vis_mod
    from threepu_torch import cli
    from threepu_torch.models import load_net

    plots = []

    def record(self, xyz, name="", show=True):
        plots.append((name, np.array(self.nnIdx), np.array(xyz)))

    n_vis = sfx["vis_layer_4"].shape[1]
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(vis_mod.Painter, "interactive_3D_plot", record):
        os.mkdir(os.path.join(tmp, "shapes"))
        np.savetxt(os.path.join(tmp, "shapes", "shape0.xyz"), fx["input"])
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        cli.main(["--phase", "vis", "--ckpt", WEIGHTS, "--test_data",
                  os.path.join(tmp, "shapes", "*.xyz"), "--num_point",
                  str(NET["max_num_point"]), "--up_ratio",
                  str(NET["max_up_ratio"]), "--knn", str(NET["knn"])])
        cli_s = time.perf_counter() - t0
        launches = checked_launches(
            kernels, ("select", "fps", "interlevel", "edgeconv"),
            "cli --phase vis")
        names = [f"level_{l}.nnIdx_layer_{i}" for l in range(1, 5)
                 for i in range(4)]
        if [p[0] for p in plots] != names:
            raise AssertionError(f"vis plotted {[p[0] for p in plots]}")
        graphs = {}
        for name, idx, xyz in plots:
            if idx.shape != (xyz.shape[0], NET["knn"]) or idx.min() < 0 \
                    or idx.max() >= xyz.shape[0]:
                raise AssertionError(f"vis {name}: graph {idx.shape} does not "
                                     f"fit its cloud {xyz.shape}")
            if name.startswith("level_1."):
                got, want = idx[:n_vis], sfx[f"vis_nnIdx_layer_{name[-1]}"][0]
                graphs[name] = (
                    round(float((got == want).all(-1).mean()), 5),
                    round(float((np.sort(got, -1) == np.sort(want, -1))
                                .all(-1).mean()), 5))
        # per layer: 99%, or JAX's own share under 1e-6 input noise where
        # that is smaller
        bands = np.minimum(GRAPH_BAND, np.min(sfx["vis_control_sets"], 0))
        print(f"cli --phase vis, 16x, edge-conv kernel on: 16 graphs, clouds "
              f"{[p[2].shape[0] for p in plots[::4]]} points by level; level "
              f"1 rows equal to JAX's in order and as sets {graphs}; JAX "
              f"against itself under 1e-6 input noise, smallest of 8 seeds: "
              f"in order {np.min(sfx['vis_control_rows'], 0).round(5).tolist()}"
              f", as sets {np.min(sfx['vis_control_sets'], 0).round(5).tolist()}"
              f"; {cli_s:.3f} s with set-up [{card}]", flush=True)
        if any(sets < band for (_, sets), band in zip(graphs.values(), bands)):
            raise AssertionError("vis: level 1's graphs differ from JAX's "
                                 "beyond its float-noise control")

        net = load_net(WEIGHTS, **NET).eval()
        cap = vis_mod.collect_intermediates(net, sfx["patches"],
                                            NET["max_up_ratio"])
    layer4 = row_share(torch.from_numpy(cap["level_1.layer_4"][0, :n_vis]),
                       sfx["vis_layer_4"][0])
    recomputed = {f"{l}.{i}": recomputed_graph_share(net, cap, l, i)
                  for l in range(1, 5) for i in range(4)}
    print(f"vis capture of JAX's 48 patches: level 1 layer_4 rows within 1e-4 "
          f"of JAX's {layer4:.5f} (JAX against itself under 1e-6 input noise: "
          f"{np.sort(sfx['vis_control_layer4']).round(5).tolist()}); graphs "
          f"equal to the kNN of their level's captured features {recomputed} "
          f"[{card}]", flush=True)
    if layer4 < min(ROWS_BAND, float(np.min(sfx["vis_control_layer4"]))) \
            or min(recomputed.values()) < RECOMPUTED_BAND:
        raise AssertionError("vis capture outside its band")
    return launches


def grid_cloud(rng, b: int, n: int):
    """``(b, 2n, 3)`` points on a 0.25 grid in [-2, 2], each with its
    mirror image: sums, squares and the centroid (0) are exact in float32
    in any order, and many distances tie."""
    half = rng.integers(-8, 9, (b, n, 3)) * 0.25
    return np.concatenate([half, -half], axis=1).astype(np.float32)


def reference_ops(card: str) -> None:
    """Phase 7f: the reference-style ops and ``ball_query`` on CUDA tensors
    against the same calls on CPU tensors, on grid clouds whose arithmetic
    is exact: every output equal (ties to the lowest index on both), and
    ``gather_points``' gradient."""
    import torch
    import threepu_torch.ops as ops
    from threepu_torch.device import require_cuda

    rng = np.random.default_rng(SEED)
    pts, q = grid_cloud(rng, 4, 256), grid_cloud(rng, 4, 32)
    feats = rng.integers(-5, 6, (4, 6, 512)).astype(np.float32)
    idx = rng.integers(0, 512, (4, 200)).astype(np.int32)
    cot = rng.integers(-3, 4, (4, 6, 200)).astype(np.float32)
    calls = {
        "ball_query": lambda p, q, f, i: ops.ball_query(0.75, 8, p, q),
        "group_knn NCHW": lambda p, q, f, i: ops.group_knn(
            8, q.transpose(1, 2), p.transpose(1, 2)),
        "group_knn": lambda p, q, f, i: ops.group_knn(8, q, p, NCHW=False),
        "furthest_point_sample": lambda p, q, f, i: ops.furthest_point_sample(
            p.transpose(1, 2), 64),
        "fps_indices": lambda p, q, f, i: ops.fps_indices(p, 64),
        "normalize_point_batch": lambda p, q, f, i: ops.normalize_point_batch(
            p.transpose(1, 2)),
        "nndistance": lambda p, q, f, i: ops.nndistance(p, q),
        "gather_points": lambda p, q, f, i: ops.gather_points(f, i)}
    dev = require_cuda()
    for name, fn in calls.items():
        outs = []
        for d in (dev, torch.device("cpu")):
            args = [torch.from_numpy(a).to(d) for a in (pts, q, feats, idx)]
            out = fn(*args)
            outs.append([o.cpu() for o in (out if isinstance(out, tuple)
                                           else (out,))])
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"{name}: the card and the CPU differ")
    grads = []
    for d in (dev, torch.device("cpu")):
        f = torch.from_numpy(feats).to(d).requires_grad_()
        ops.gather_points(f, torch.from_numpy(idx).to(d)).backward(
            torch.from_numpy(cot).to(d))
        grads.append(f.grad.cpu())
    if not torch.equal(*grads):
        raise AssertionError("gather_points: gradients differ")
    print(f"reference-style ops on the card equal the CPU's: {list(calls)} "
          f"and gather_points' gradient [{card}]", flush=True)


def native_host(fx, card: str) -> None:
    """Phase 7g: the native host library built with ``g++`` on the card's
    machine; ``parse_xyz`` of the fixture's 5000- and 80,000-point shapes
    written with ``np.savetxt`` equals ``np.loadtxt(...).astype(float32)``
    bit for bit (any row that differs is printed), with both times."""
    import tempfile
    from threepu_torch import native

    native.load()
    print(f"native host library: {native.library_path().name} (built with g++ "
          f"at its first use in this run) [{card}]", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for key in ("input", "gt"):
            path = os.path.join(tmp, f"{key}.xyz")
            np.savetxt(path, fx[key])
            t0 = time.perf_counter()
            got = native.parse_xyz(path)
            parse_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = np.loadtxt(path).astype(np.float32)
            loadtxt_s = time.perf_counter() - t0
            rows = np.flatnonzero((got.view(np.int32)
                                   != want.view(np.int32)).any(-1)) \
                if got.shape == want.shape else np.arange(len(want))
            print(f"parse_xyz {want.shape}: {parse_s * 1e3:.2f} ms, "
                  f"np.loadtxt {loadtxt_s * 1e3:.2f} ms; rows differing bit "
                  f"for bit: {len(rows)} {rows[:10].tolist()} [{card}]",
                  flush=True)
            for r in rows[:10]:
                print(f"  row {r}: parse_xyz {got[r].tolist()} loadtxt "
                      f"{want[r].tolist()}", flush=True)
            if len(rows):
                raise AssertionError(f"parse_xyz differs from np.loadtxt on "
                                     f"{key}")


def surface(fx, card: str, kernels: dict, off_s: float,
            bare_ms: float) -> dict:
    """Phase 7 (7a-7g); returns the launch count of each kernel on the
    paths it drives: ``step4`` (7b), ``step4_train`` (7c), ``adaptive``
    (7d), ``vis`` (7e)."""
    t0 = time.perf_counter()
    sfx = np.load(SURFACE_FIXTURE)
    net4 = step4_net(sfx).eval()
    step4_replay(net4, fx, sfx, card)
    paths = {"step4": step4_file_to_file(net4, fx, sfx, card, kernels, off_s)}
    del net4
    paths["step4_train"] = step4_training(sfx, np.load(TRAIN_FIXTURE), card,
                                          kernels, bare_ms)
    paths["adaptive"] = adaptive_level(sfx, card, kernels)
    paths["vis"] = vis_phase_check(fx, sfx, card, kernels)
    reference_ops(card)
    native_host(fx, card)
    print(f"phase 7: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return paths


# ------------------------------------------------------------ phase 8
def rank_kernels() -> dict:
    """The kernels' wrappers in this process, by name (each process, a
    rank among them, counts its own launches)."""
    import threepu_torch.ops.chamfer as ch_mod
    import threepu_torch.ops.edgeconv as ec_mod
    import threepu_torch.ops.fps as fps_mod
    import threepu_torch.ops.interlevel as il_mod
    import threepu_torch.ops.select as sel_mod
    return {"select": sel_mod.KERNEL, "fps": fps_mod.KERNEL,
            "interlevel": il_mod.KERNEL, "chamfer": ch_mod.KERNEL,
            "edgeconv": ec_mod.KERNEL}


@contextlib.contextmanager
def counted(mesh, kernels: dict):
    """Sets the mesh's collective counts and every kernel's launches to 0;
    yields a dict that holds both on exit (``counts``, ``launches``)."""
    mesh.counts.clear()
    for k in kernels.values():
        k.launches = 0
    got = {}
    yield got
    got.update(counts=dict(mesh.counts),
               launches={n: k.launches for n, k in kernels.items()})


def params_of(net) -> dict:
    return {n: p.detach().cpu().numpy().copy()
            for n, p in net.named_parameters()}


def rank_eval(mesh, fx) -> dict:
    """Phase 8a in a rank: the fixture's shape through ``upsample_shape``
    with the mesh (phase 4b's configuration): a warm-up run, the checked
    run, three warm runs on the plain chain, then one run with the
    edge-conv kernel (the default)."""
    from threepu_torch.models import load_net
    kernels = rank_kernels()
    net = load_net(WEIGHTS, device=mesh.device, **NET).eval()
    t0 = time.perf_counter()
    run_shape(net, fx, mesh=mesh)
    first_s = time.perf_counter() - t0
    with plain_chain(net):
        with counted(mesh, kernels) as off:
            out = run_shape(net, fx, mesh=mesh)
        best, times = warm_shape_s(net, fx, mesh=mesh)
    with counted(mesh, kernels) as on:
        out_on = run_shape(net, fx, mesh=mesh)
    return dict(out=out, off=off, first_s=first_s, best=best, times=times,
                out_on=out_on, on=on)


def witness_step(net, opt, x, gt, ratio: int, seeds, blocks: int) -> tuple:
    """The sharded step at world size ``blocks`` run on one card: each
    block of contiguous rows (a rank's) through ``train_loss`` and its
    backward in turn, the blocks' gradients (zeros where none) and losses
    summed in block order and divided by ``blocks``, then the clipped
    Adam step.  Written apart from ``parallel.train`` on purpose.  Returns
    ``(loss, grads)``."""
    import torch
    from threepu_torch.train.model import train_loss
    b = x.shape[0] // blocks
    named = list(net.named_parameters())
    grads, loss = {n: torch.zeros_like(p) for n, p in named}, 0.0
    for r in range(blocks):
        rows = slice(r * b, (r + 1) * b)
        opt.zero_grad(set_to_none=True)
        weighted, cd, _, _ = train_loss(net, x[rows], gt[rows], ratio,
                                        seed_idx=[s[rows] for s in seeds])
        weighted.backward()
        for n, p in named:
            if p.grad is not None:
                grads[n] += p.grad
        loss += float(cd.detach())
    for n, p in named:
        p.grad = grads[n] / blocks
    opt.step()
    return loss / blocks, {n: p.grad.detach().cpu().numpy().copy()
                           for n, p in named}


def rank_train(mesh, serial_runs: int, blocks: int = 0) -> dict:
    """Phase 8b in a rank: at ratios 2 and 16, phase 5a's step (16 x 312,
    the trained weights with their Adam state, the fixture's batch and
    re-patch seeds) ``serial_runs`` times through ``train_step``, once
    through :func:`witness_step` over ``blocks`` blocks (where ``blocks``
    is not 0) and once through ``make_sharded_train_step``, each from the
    same state; then the warm ms/step at ratio 16 of the sharded step
    and, before and after, of the serial one in this process (median of
    10 after 2, each ending in a device sync, the seeds drawn from a
    generator).  Returns ``{ratio: {loss, params, grads (the step's
    reduced gradients), serial: [(loss, params)], witness: (loss, params,
    grads) or None, counts, launches}, "times", "serial_times"}``.
    """
    import torch
    from threepu_torch.io import load_opt_state
    from threepu_torch.models import load_net
    from threepu_torch.parallel import make_sharded_train_step
    from threepu_torch.train import make_optimizer, train_step
    tfx = np.load(TRAIN_FIXTURE)
    dev = mesh.device

    def arr(key):
        return torch.from_numpy(tfx[key]).to(dev)

    def fresh():
        net = load_net(WEIGHTS, device=dev, **NET)
        opt = make_optimizer(net.parameters(), TRAIN_LR)
        if load_opt_state(WEIGHTS, net, opt) is None:
            raise AssertionError("8b: WEIGHTS holds no Adam state")
        return net, opt

    res = {}
    for ratio in (2, 16):
        x, gt = arr(f"input_{ratio}"), arr(f"gt_{ratio}")
        seeds = list(arr(f"repatch_{ratio}"))
        serial = []
        for _ in range(serial_runs):
            net, opt = fresh()
            loss = float(train_step(net, opt, x, gt, ratio, seed_idx=seeds))
            serial.append((loss, params_of(net)))
        witness = None
        if blocks:
            net, opt = fresh()
            loss, grads = witness_step(net, opt, x, gt, ratio, seeds, blocks)
            witness = (loss, params_of(net), grads)
        net, opt = fresh()
        step = make_sharded_train_step(net, opt, mesh)
        with counted(mesh, rank_kernels()) as got:
            loss = step(net, opt, x, gt, ratio, seed_idx=seeds)
        res[ratio] = dict(loss=float(loss), params=params_of(net),
                          grads={n: p.grad.detach().cpu().numpy().copy()
                                 for n, p in net.named_parameters()},
                          serial=serial, witness=witness, **got)

    def times(step_fn, net, opt):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        out = []
        for i in range(12):
            t0 = time.perf_counter()
            step_fn(net, opt, x, gt, 16, generator=gen)
            torch.cuda.synchronize()
            if i >= 2:
                out.append((time.perf_counter() - t0) * 1e3)
        return out

    # the serial step in this process before and after: the rank's host
    # apart from what the sharded step adds
    serial_net, serial_opt = fresh()
    res["serial_times"] = times(train_step, serial_net, serial_opt)
    res["times"] = times(step, net, opt)
    res["serial_times"] += times(train_step, serial_net, serial_opt)
    return res


def rank_loop(mesh, path: str, tmp: str) -> dict:
    """Phase 8c in a rank: ``train_loop`` with ``TrainConfig(mesh=...)``
    on phase 6's file, resumed from ``WEIGHTS``: ``LOOP_WARM +
    LOOP_TIMED`` steps of phase 6b's checked configuration (ratios 2-16,
    threshold on, a log step every 5) with each step's launches and host
    syncs; the same number of steps at ratio 16 only (phase 6b's timed
    configuration) with the warm ms/step over the last ``LOOP_TIMED``;
    then one whole epoch of a fresh net (300 steps of batch 1 at ratio 2)
    and its checkpoint, read back through ``io.checkpoint``."""
    import torch
    from threepu_torch.io import load_checkpoint
    from threepu_torch.train import TrainConfig, train_loop
    start = int(np.load(WEIGHTS)["step"])
    steps = LOOP_WARM + LOOP_TIMED
    kernels = rank_kernels()
    logged = []

    def log_fn(step, ratio, loss, state, batch, pred=None, gt_out=None,
               error=None):
        logged.append((step, None if pred is None else tuple(pred.shape)))

    cfg = loop_config(path, tmp, mesh=mesh)
    mesh.counts.clear()
    with watched_steps(kernels, syncs=True, sharded=True) as calls:
        _, error_log = train_loop(cfg, max_steps=start + steps, log_fn=log_fn)
    counts = dict(mesh.counts)
    out = dict(ratios=[c["ratio"] for c in calls],
               syncs=[c["syncs"] for c in calls],
               launches=[c["launches"] for c in calls],
               losses=torch.stack([c["loss"] for c in calls]).cpu().numpy(),
               error_log=dict(error_log), logged=logged, counts=counts)

    def loop_ms(mesh_or_none) -> tuple:
        ratios, marks = [], []

        def wrap(step_fn):
            def timed(net, opt, inp, gt, ratio, **kw):
                if len(ratios) in (LOOP_WARM, steps):
                    torch.cuda.synchronize()
                    marks.append(time.perf_counter())
                ratios.append(ratio)
                return step_fn(net, opt, inp, gt, ratio, **kw)
            return timed

        timed_cfg = dataclasses.replace(
            cfg, stage_steps=TIMING_STAGE_STEPS,
            log_steps=TrainConfig.log_steps, mesh=mesh_or_none)
        with loop_step_patch(wrap, sharded=mesh_or_none is not None):
            train_loop(timed_cfg, max_steps=start + steps + 1,
                       device=mesh.device)
        return (marks[1] - marks[0]) * 1e3 / LOOP_TIMED, set(ratios)

    # the serial loop in this process before and after, as in rank_train
    serial_ms, serial_ratios = loop_ms(None)
    out["step_ms"], ratios = loop_ms(mesh)
    out["serial_ms"] = [serial_ms, loop_ms(None)[0]]
    out["timed_ratios"] = sorted(ratios | serial_ratios)

    model_dir = os.path.join(tmp, f"mesh_rank{mesh.rank}")
    epoch_cfg = loop_config(path, tmp, mesh=mesh, ckpt=None, batch_size=1,
                            stage_steps=10 ** 6, max_epoch=1, ckpt_epochs=1,
                            model_dir=model_dir)
    t0 = time.perf_counter()
    state, _ = train_loop(epoch_cfg)
    out["epoch_s"] = time.perf_counter() - t0
    out["files"] = sorted(os.listdir(model_dir)) \
        if os.path.isdir(model_dir) else []
    out["read_back"] = False
    if out["files"] == ["model_1.npz"]:
        restored, step = load_checkpoint(
            os.path.join(model_dir, "model_1.npz"), state.net)
        mine = state.net.state_dict()
        out["read_back"] = step == state.step and all(
            torch.equal(restored[k].to(mine[k].device), mine[k])
            for k in mine)
    out["epoch_step"] = state.step
    return out


def phase8_rank(mesh, parts, path: str, tmp: str, blocks: int = 0) -> dict:
    """The parts of phase 8 that run in each rank: ``"eval"`` (8a),
    ``"train"`` (8b, with 3 serial runs and the witness over ``blocks``
    blocks at world size 1) and ``"loop"`` (8c)."""
    fx = np.load(FIXTURE)
    out = {"rank": mesh.rank, "size": mesh.size}
    if "eval" in parts:
        out["eval"] = rank_eval(mesh, fx)
    if "train" in parts:
        out["train"] = rank_train(
            mesh, RESUME_CONTROL_RUNS if mesh.size == 1 else 0,
            blocks if mesh.size == 1 else 0)
    if "loop" in parts:
        out["loop"] = rank_loop(mesh, path, tmp)
    return out


def max_param_diff(a: dict, b: dict) -> float:
    return max(float(np.max(np.abs(a[n] - b[n]))) for n in a)


def check_sharded_eval(r: dict, fx, serial_out, off_s: float, card: str,
                       dev) -> None:
    """Phase 8a's checks of a world-size-1 rank: bit for bit phase 4b's
    output, 4b's launches and one all-gather; with the edge-conv kernel
    on, 96 edge-conv launches, one all-gather and both Chamfer bands."""
    ev = r["eval"]
    diff = int(np.sum(np.any(ev["out"] != serial_out, axis=-1))) \
        if ev["out"].shape == serial_out.shape else -1
    print(f"8a sharded 16x, world size 1 (nccl): collectives "
          f"{ev['off']['counts']}, launches {ev['off']['launches']}; rows "
          f"differing from phase 4b's output: {diff}; first run "
          f"{ev['first_s']:.3f} s, warm s/shape {ev['best']:.4f} (runs "
          f"{[round(t, 4) for t in ev['times']]}) beside phase 4b's "
          f"{off_s:.4f}; edge-conv kernel on: collectives "
          f"{ev['on']['counts']}, launches {ev['on']['launches']} [{card}]",
          flush=True)
    if diff != 0:
        raise AssertionError("8a: the sharded output is not phase 4b's")
    for got in (ev["off"], ev["on"]):
        if got["counts"] != {"all_gather": 1}:
            raise AssertionError(f"8a: a shape ran {got['counts']}")
    for name, want in EVAL_LAUNCHES.items():
        if ev["off"]["launches"][name] != want:
            raise AssertionError(f"8a launched {name} "
                                 f"{ev['off']['launches'][name]} times, not "
                                 f"{want}")
    if ev["on"]["launches"]["edgeconv"] != EDGECONV_LAUNCHES:
        raise AssertionError("8a: the edge-conv kernel did not run 96 times")
    check_output(ev["out_on"], fx, dev, "8a sharded 16x, edge-conv kernel on")


def serial_control(st: dict) -> float:
    """Twice the largest parameter difference between two of a ratio's
    serial steps from one state (the backward's atomics): phase 6c's
    control for one step."""
    import itertools
    return 2 * max(max_param_diff(a, b) for (_, a), (_, b)
                   in itertools.combinations(st["serial"], 2))


def check_sharded_train(r: dict, bare_ms: float, card: str,
                        blocks: int) -> None:
    """Phase 8b's checks of a world-size-1 rank, at ratios 2 and 16: the
    loss equal to the serial step's, the parameters within twice the
    largest difference between two serial steps (the backward's
    atomics), one all-reduce, select and Chamfer (once) launched and
    interlevel once a level past the first.  The witness over ``blocks``
    blocks is printed beside the full step: where the two differ, it is
    by the blocks' shapes alone."""
    import itertools
    import torch
    tr = r["train"]
    for ratio in (2, 16):
        st = tr[ratio]
        serial_losses = [loss for loss, _ in st["serial"]]
        pairs = [max_param_diff(a, b) for (_, a), (_, b)
                 in itertools.combinations(st["serial"], 2)]
        gap = max_param_diff(st["params"], st["serial"][0][1])
        print(f"8b sharded train step, ratio {ratio}, world size 1 (nccl): "
              f"loss {st['loss']!r}, serial {serial_losses}; largest "
              f"parameter difference from a serial step {gap:.3e}, between "
              f"serial steps {[f'{d:.3e}' for d in pairs]}; collectives "
              f"{st['counts']}, launches {st['launches']} [{card}]",
              flush=True)
        if st["witness"] is not None:
            w_loss, w_params, w_grads = st["witness"]
            ws = compare_grads(
                w_loss, {n: torch.from_numpy(g) for n, g in w_grads.items()},
                st["loss"], {n: torch.from_numpy(g)
                             for n, g in st["grads"].items()})
            print(f"8b witness, ratio {ratio}: the step as {blocks} ranks "
                  f"would run it, on this card, from the full step: loss "
                  f"rel err {ws['loss_err']:.3e}, gradients rel L2 "
                  f"{ws['grad_err']:.3e}, worst tensor {ws['worst_err']:.3e} "
                  f"({ws['worst']}), largest parameter difference "
                  f"{max_param_diff(w_params, st['params']):.3e} [{card}]",
                  flush=True)
        if any(loss != st["loss"] for loss in serial_losses):
            raise AssertionError("8b: the sharded loss is not the serial one")
        if not gap <= serial_control(st):
            raise AssertionError("8b: parameters outside twice their "
                                 "control")
        if st["counts"] != {"all_reduce": 1}:
            raise AssertionError(f"8b: a step ran {st['counts']}")
        got = st["launches"]
        if got["select"] <= 0 or got["chamfer"] != 1 \
                or got["interlevel"] != int(np.log2(ratio)) - 1:
            raise AssertionError(f"8b: a ratio-{ratio} step launched {got}")
    print(f"8b sharded train step, ratio 16: warm "
          f"{np.median(tr['times']):.3f} ms/step (median of 10; "
          f"{[round(t, 3) for t in tr['times']]}) beside the serial step in "
          f"the same rank, before and after, "
          f"{np.median(tr['serial_times'][:10]):.3f} / "
          f"{np.median(tr['serial_times'][10:]):.3f}, and phase 5c's "
          f"{bare_ms:.3f} [{card}]", flush=True)


def check_across_cards(ranks: list, r: dict, fx, card: str, dev) -> None:
    """Phase 8d's checks of each rank at world size N against world size
    1's (``r``): the shape's output within phase 4b's float-noise control
    (Chamfer) and one all-gather.  The step at ratios 2 and 16, one
    all-reduce: against the witness (the step as N ranks run it, on one
    card), the loss within 1e-5 (relative), the reduced gradients within
    phase 5b's band for one set of decisions and the parameters within
    twice the serial pairs' difference (8b); against world 1's step, at
    ratio 2 the same loss and parameter bands, all gradients within JAX's
    float-noise control and each tensor within 0.1, and at ratio 16 (N
    rows a card run the GEMMs at other shapes, and that step is chaotic)
    the loss and gradients within JAX's float-noise control."""
    import torch
    tfx = np.load(TRAIN_FIXTURE)
    ctl = float(np.max(fx["jax_pert_cd"]))

    def grads(g: dict) -> dict:
        return {n: torch.from_numpy(v) for n, v in g.items()}

    for rank in ranks:
        o = torch.from_numpy(rank["eval"]["out"]).to(dev)
        cd = chamfer(o, torch.from_numpy(r["eval"]["out"]).to(dev))
        print(f"8d world size {rank['size']}, rank {rank['rank']}: chamfer to "
              f"world 1's output {cd:.6e} (JAX against itself under 1e-6 "
              f"input noise {ctl:.6e}); collectives "
              f"{rank['eval']['off']['counts']}; warm s/shape "
              f"{rank['eval']['best']:.4f} (world 1: "
              f"{r['eval']['best']:.4f}); "
              f"train {np.median(rank['train']['times']):.3f} ms/step (world "
              f"1: {np.median(r['train']['times']):.3f}) [{card}]",
              flush=True)
        if cd > ctl or rank["eval"]["off"]["counts"] != {"all_gather": 1}:
            raise AssertionError("8d: the sharded shape across cards")
        for ratio in (2, 16):
            got, want = rank["train"][ratio], r["train"][ratio]
            w_loss, w_params, w_grads = want["witness"]
            ws = compare_grads(got["loss"], grads(got["grads"]), w_loss,
                               grads(w_grads))
            st = compare_grads(got["loss"], grads(got["grads"]),
                               want["loss"], grads(want["grads"]))
            ctl_loss = float(np.max(tfx[f"control_loss_{ratio}"]))
            ctl_grad = float(np.max(tfx[f"control_grad_{ratio}"]))
            ctl_params = serial_control(want)
            w_gap = max_param_diff(got["params"], w_params)
            gap = max_param_diff(got["params"], want["params"])
            print(f"8d world size {rank['size']}, rank {rank['rank']}, ratio "
                  f"{ratio}: from the witness: loss rel err "
                  f"{ws['loss_err']:.3e}, gradients rel L2 "
                  f"{ws['grad_err']:.3e}, worst tensor {ws['worst_err']:.3e} "
                  f"({ws['worst']}), largest parameter difference "
                  f"{w_gap:.3e}; from world 1's step: loss rel err "
                  f"{st['loss_err']:.3e} (JAX's control {ctl_loss:.3e}), "
                  f"gradients rel L2 {st['grad_err']:.3e} (control "
                  f"{ctl_grad:.3e}), worst tensor {st['worst_err']:.3e} "
                  f"({st['worst']}), largest parameter difference "
                  f"{gap:.3e}; twice the serial pairs' {ctl_params:.3e}; "
                  f"collectives {got['counts']} [{card}]", flush=True)
            if not (ws["loss_err"] <= PIN_LOSS_BAND
                    and ws["grad_err"] <= PIN_GRAD_BAND
                    and w_gap <= ctl_params):
                raise AssertionError(f"8d: the ratio-{ratio} step across "
                                     "cards is not the witness's")
            if ratio == 2:
                inside = (st["loss_err"] <= R2_LOSS_BAND
                          and st["grad_err"] <= ctl_grad
                          and st["worst_err"] <= R2_TENSOR_BAND
                          and gap <= ctl_params)
            else:
                inside = (st["loss_err"] <= ctl_loss
                          and st["grad_err"] <= ctl_grad)
            if not inside:
                raise AssertionError(f"8d: the ratio-{ratio} step across "
                                     "cards is outside its bands")
            if got["counts"] != {"all_reduce": 1}:
                raise AssertionError(f"8d: a step ran {got['counts']}")


def check_sharded_loop(r: dict, loop_ms: float, card: str) -> None:
    """Phase 8c's checks: every step launched select, interlevel a level
    past the first and Chamfer once, no host sync on a step that does not
    log, the losses finite, the timed run at ratio 16 only, and one
    checkpoint that reads back."""
    lp = r["loop"]
    start = int(np.load(WEIGHTS)["step"])
    n = len(lp["ratios"])
    log_at = [(start + i + 1) % LOOP_LOG_STEPS == 0 or i == n - 1
              for i in range(n)]
    print(f"8c train_loop with a mesh, world size 1 (nccl), {n} steps from "
          f"step {start}: ratios {lp['ratios']}; losses "
          f"{lp['losses'].tolist()}; error_log {lp['error_log']}; log_fn at "
          f"{lp['logged']}; host syncs a step {lp['syncs']} (log steps "
          f"{[i for i, on in enumerate(log_at) if on]}); collectives "
          f"{lp['counts']}; warm {lp['step_ms']:.3f} ms/step ({LOOP_TIMED} "
          f"steps at ratios {lp['timed_ratios']}) beside the serial loop in "
          f"the same rank, before and after, {lp['serial_ms'][0]:.3f} / "
          f"{lp['serial_ms'][1]:.3f}, and phase 6b's {loop_ms:.3f}; one "
          f"epoch of 300 steps of batch 1 in "
          f"{lp['epoch_s']:.1f} s wrote {lp['files']}, read back "
          f"{'bit for bit' if lp['read_back'] else 'DIFFERENT'} [{card}]",
          flush=True)
    if n != LOOP_WARM + LOOP_TIMED:
        raise AssertionError(f"8c: the loop ran {n} steps")
    for ratio, got in zip(lp["ratios"], lp["launches"]):
        levels = int(np.log2(ratio))
        if (got["select"] <= 0 or got["chamfer"] != 1
                or got["interlevel"] != levels - 1):
            raise AssertionError(f"8c: a ratio-{ratio} step launched {got}")
    off_log = [c for c, on in zip(lp["syncs"], log_at) if not on]
    if any(off_log):
        raise AssertionError(f"8c: {sum(off_log)} host syncs on steps that "
                             "do not log")
    if not np.isfinite(lp["losses"]).all():
        raise AssertionError("8c: a loss is not finite")
    logs = sum((start + i + 1) % LOOP_LOG_STEPS == 0 for i in range(n))
    want = {"broadcast": 1, "all_reduce": n, "all_gather": logs}
    if lp["counts"] != want or len(lp["logged"]) != logs:
        raise AssertionError(f"8c: collectives {lp['counts']}, not {want}")
    if lp["timed_ratios"] != [16]:
        raise AssertionError(f"8c: the timed loop drew {lp['timed_ratios']}")
    if not lp["read_back"] or lp["epoch_step"] != 300:
        raise AssertionError("8c: the epoch's checkpoint")


def multi_gpu(fx, card: str, serial_out, off_s: float, bare_ms: float,
              loop_ms: float) -> dict:
    """Phase 8: the sharded paths over ``torch.distributed`` with
    ``nccl``, each rank a process of ``parallel.launch.spawn``: 8a-8c at
    world size 1, 8d across cards where 2 or more are visible.  Returns
    the launch count of each kernel on the paths of rank 0 at world size
    1: ``sharded_eval`` (8a, kernel off), ``sharded_eval_on`` (kernel
    on), ``sharded_train`` (8b) and ``sharded_loop`` (8c)."""
    import tempfile
    import torch
    from threepu_torch.device import require_cuda
    from threepu_torch.parallel.launch import spawn
    t0 = time.perf_counter()
    dev = require_cuda()
    cards = torch.cuda.device_count()
    # 8d's world size; the witness takes it on one card too
    world = MAX_WORLD if cards >= MAX_WORLD or cards < 2 else 2
    with tempfile.TemporaryDirectory() as tmp:
        path = data_file(tmp)
        [r] = spawn(phase8_rank, 1, ("eval", "train", "loop"), path, tmp,
                    world)
    print(f"phase 8 world size 1: {time.perf_counter() - t0:.1f} s with the "
          f"rank's start [{card}]", flush=True)
    check_sharded_eval(r, fx, serial_out, off_s, card, dev)
    check_sharded_train(r, bare_ms, card, world)
    check_sharded_loop(r, loop_ms, card)

    if cards < 2:
        print(f"8d did not run: {cards} card visible, and nccl takes one "
              f"rank a card, so the sharded paths across cards need 2 or "
              f"more [{card}]", flush=True)
    else:
        ranks = spawn(phase8_rank, world, ("eval", "train"), "", "")
        check_across_cards(ranks, r, fx, card, dev)
    print(f"phase 8: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    loop_launches = {n: sum(c[n] for c in r["loop"]["launches"])
                     for n in r["loop"]["launches"][0]}
    return {"sharded_eval": r["eval"]["off"]["launches"],
            "sharded_eval_on": r["eval"]["on"]["launches"],
            "sharded_train": {n: r["train"][2]["launches"][n]
                              + r["train"][16]["launches"][n]
                              for n in r["train"][2]["launches"]},
            "sharded_loop": loop_launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="also profile this many warm train steps (phase 5c)")
    ap.add_argument("--profile-shapes", type=int, default=0, metavar="SHAPES",
                    help="also profile this many warm 16x shapes, edge-conv "
                         "kernel off and on (after phase 4d)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from threepu_torch import _build, require_cuda
    from threepu_torch.device import card_line

    # 1. device
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    dev = require_cuda()

    # 2. build
    t0 = time.perf_counter()
    _build.build(ptxas_verbose=True)
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = rank_kernels()
    eval_kernels = {k: kernels[k] for k in ("select", "fps", "interlevel",
                                            "edgeconv")}
    fx = np.load(FIXTURE)
    from threepu_torch.models import load_net
    net = load_net(WEIGHTS, **NET).eval()

    # 3. kernels against their plain versions
    report = check_kernels(dev, card, fx)

    # 4. end to end
    for chain_kernel in (False, True):
        stats = replay_cascade(net, fx, dev, chain_kernel)
        for st in stats:
            print(f"cascade replay, edge-conv kernel "
                  f"{'on' if chain_kernel else 'off'} {st} [{card}]",
                  flush=True)
        check_replay(stats)
    eval_launches, off_s, serial_out = end_to_end(net, fx, card,
                                                  eval_kernels)
    file_launches = file_to_file(net, fx, card, eval_kernels, off_s)
    bucketed(net, fx, card)
    if args.profile_shapes:
        profile_shapes(net, fx, args.profile_shapes, card)

    # 5. training
    train_launches, step_ms = train_checks(fx, np.load(TRAIN_FIXTURE), card,
                                           kernels, args.profile)

    # 6. training from a file
    file_train, loop_ms = file_training(fx, card, kernels, step_ms)

    # 7. the rest of the one-GPU surface
    file_train.update(surface(fx, card, kernels, off_s, step_ms))

    # 8. the sharded paths over torch.distributed
    file_train.update(multi_gpu(fx, card, serial_out, off_s, step_ms,
                                loop_ms))

    by_path = {name: {"eval": eval_launches.get(name, 0),
                      "file": file_launches.get(name, 0),
                      "train": train_launches[name],
                      **{path: launches[name]
                         for path, launches in file_train.items()}}
               for name in kernels}
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=k.source, replaces=k.replaces,
             launches=sum(by_path[name].values()),
             launches_by_path=by_path[name], **report[name])
        for name, k in kernels.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
