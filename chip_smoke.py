#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (reduced3dgs_torch) on one card.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises and exits non-zero
before the final line:

 1. card name / power limit (nvidia-smi) and the nvcc build of every
    kernel source, and of K2 and K4 a second time with -DWALK_EXP2=0
    (expf in place of ex2.approx), all built in parallel;
 2. K1 (csrc/expand.cu, binning's slot keys) against its plain version,
    bit-exact, and two launches bit for bit, on the binning-test cases,
    budget truncation, no instances, a budget inside a primitive, P = 0
    and 1, and padding needs past the pad slots;
 3. K2 (csrc/tile_fwd.cu) against its plain version on the 512x512,
    2^17-primitive scene (every pixel within 5e-3, >= 99.9 % within 1e-4;
    two launches bit-identical), on edge cases at small size (a frame
    whose width and height are no multiples of 16, tiles whose ranges are
    exactly 128 and 256 instances, a limit that cuts a range mid-batch,
    an all-empty frame), and the whole render (kernels) against the
    masked oracle on a small scene;
 4. the main path at full size: a 1920x1080 model of 2^19 SH-degree-3
    primitives made from --seed, written as point_cloud.ply and
    point_cloud_quantised_half.ply (256-entry quantile codebooks), loaded
    through the port's Scene / ply_io, and rendered over a ring of 8 views
    through reduced3dgs_torch.render (budget ladder; FPS of the ring as a
    replayed CUDA graph of its frames, timed by CUDA events);
    the kernels' launch counters are zeroed just before and read just
    after, and must have risen; the ring once more through K2 as built
    and through its expf build on the same inputs (PSNR between the two,
    pixels more than 2e-5 from the plain version);
 5. per-kernel times (CUDA events) at the main path's shapes beside the
    plain versions, the bound, and a PyTorch yardstick (K1's keys and the
    whole BinningOut bit for bit against the plain version's); K2's line also
    counts the (warp, instance) pairs its warps dispatch and the instances
    its blocks stage, and gives the lane utilisation (pixel pairs over 32
    x warp pairs) for the kernels' warp footprint and for the former one;
 6. where a frame's time goes (baseline model, the ring, the settled
    budget): stage times by the stage clock (utils/profiling.py; its
    stages once a view, and its device counters equal to the binnings'
    num_rendered, total_padded and pad need read on the host), then one
    pass under torch.profiler whose kernel time is set against
    the CUDA-event span of that same pass (the device's idle share; no
    cummax kernel may run);
 7. the training kernels against their plain versions: K3
    (csrc/tile_bwd.cu) at 512p and at the 1080p main-path shapes with both
    feature tables (exact zeros on every slot outside the walked ranges,
    two launches bit-identical) and on phase 3's edge cases, with the
    lane utilisation of its walk and of its blending warps; K5 / K6
    (csrc/seg_reduce.cu) on K3's slot-major records at the
    main-path shapes, on the ragged segment layouts of
    tests/test_tile_render.py (P = 700, 2500) and on a skewed layout (64
    segments of 20,000 slots and 1,024 of 33-1,024 among 2^19 of 0-3),
    also against a float64 segment sum, bit for bit against the plain
    version where a segment has at most two instances, and bit for bit
    between two launches; times beside the plain versions, the bound,
    torch.segment_reduce on a payload gathered beforehand, and the PyTorch
    calls that compute the same sums from the kernels' own inputs;
 8. whole-render gradients on the card: the tile backend (K2 + K3 + K5)
    against the differentiable "ref" oracle on a small scene, and bf16x2
    against f32;
 9. the training main path at full width: the port renders the bench
    scene (1920x1080, 2^19 SH-degree-3 primitives) at the ring views as
    ground truth, and the port's Trainer trains a copy with perturbed
    colours and opacities from --seed in the default bf16x2 mode (a
    densify iteration with pool growth and budget regrow included), then
    a few f32 steps; the loss must be finite and fall, and K1, K2, K3 and
    K6 (K5 in f32 mode) must run once per render.  It prints the median
    step time, the fwd+bwd pixels/s bench.py reports (through
    reduced3dgs_torch.bench: its step replayed as a CUDA graph, at the
    1080p geometry), the stage times by
    the stage clock (its device counters held to the binnings as in
    phase 6; the reduction stage also split into key sort, kernel
    and reorder, on one step's own inputs) and the launches and idle
    share of one profiled step;
10. K4 (csrc/tile_trans.cu) against its plain version at the 512p and the
    1080p kernel inputs, per slot and per primitive, with exact zeros on
    every slot outside the walked ranges and two launches bit for bit,
    also on phase 3's edge cases; its time beside K2's, the plain version's and its bound, its lane
    utilisation; K4's expf build against it per primitive, and with phase
    4's frames the WALK_EXP2 rule's verdict;
11. a small scene on the card: render(want_transmittance=True) through
    the tile backend (K1 + K2 + K4) against the "ref" oracle;
12. the compression main path at full width, on the trainer of phase 9:
    Trainer.step runs one mercy pass (redundancy metric over 2^19+
    primitives and the 8 ring views; no longer run a second time to time
    it and its kNN apart) and one SH-band cull at the paper's
    thresholds (and, if that demotes under 5 % or over 95 % of this
    synthetic scene's degree-3 primitives, a second cull at thresholds
    taken from the scene's own statistics), then the training CLI's final
    compression writes the four PLYs, point_cloud_quantised_half.ply is
    loaded back and the ring is rendered with and without the variable-SH
    path;
13. fused steps on the trainer of phase 12 (its schedule made free of
    surgery): from one saved state the same 16 iterations run as eager
    Trainer.steps (twice, to show what two eager runs differ by) and as
    Trainer.step_group in groups of 8 (a captured CUDA graph of the train
    step, replayed); loss per step within rtol 1e-5, parameters within
    rtol 5e-4 / atol 1e-3, num_rendered within 2, budgets equal
    (tests/test_fused_steps.py); then both again from a budget small
    enough to overflow (the group regrows and redoes); K1, K2, K3 and K6
    once per replayed step by torch.profiler's kernel names over one
    group, equal to the captured launches times the replays; ms per step
    graphed and eager in turns, the device idle share of each, the host's
    launches per step and the capture time;
14. checkpoints, offline compression and metrics at full width: the
    trainer of phase 13 saved (train/checkpoint.py), loaded into a fresh
    Trainer (every leaf equal) and one step taken by both; python -m
    reduced3dgs_torch.compress on phase 12's model (--pack_xyz
    --prune_frac 0.17 --finetune_iters 32, the ring's images written as
    PNGs beside its COLMAP text); its quantised_half and the baseline
    rendered at the ring views into train/<variant>/ours_N/{renders,gt}
    and scored by python -m reduced3dgs_torch.metrics with random LPIPS
    weights from --seed.

15. the multi-device path at full width (parallel/, strips): K2 / K3 / K4
    at a tile base against their plain versions on a window past the
    image height and one with no instances; the 8 ring views at 1920x1080
    as 4 strips of 17 tile rows (their own binning, K1 / K2) stitched and
    held to the full frame (bit for bit, else within 1e-6), their
    backward (K3 / K6) summed per primitive against the full frame's
    (atol 2e-4 max|g|, rtol 2e-3), one view's strip transmittance (K4 at a
    tile base) added up; torch.distributed at world size 1 under NCCL:
    ShardedTrainer on a (1, 1) mesh, replicated and param_shard, 4 steps
    against the single-card Trainer (losses rtol 1e-5, parameters atol
    5e-6 / rtol 1e-4) with ms per step, and one sharded_train_step per
    layout against the single-card step's raw gradients (K5); the same
    on a (1, 2) mesh of two gloo processes on the one card (or the reason
    gloo refused), whose step_group phase 17 reads; python -m
    reduced3dgs_torch.parallel.launch --scaling (its step a graph);
    the certified blocked 30-NN search against knn_exact on 2^16 points
    of the scene (phase 12's mercy pass already went through it).
16. on phase 12's model directory: the FPS ring through the graphed
    measure_fps for baseline and quantised_half, dense and variable-SH,
    every view of a replay bit for bit the eager render_once image, FPS
    graphed and eager in turns (3 rounds), launches per replay, capture
    seconds and the device idle share of one profiled replay;
    python -m reduced3dgs_torch.bench --configs 1080p as a subprocess,
    its num_rendered against an eager step's and one replayed step's
    loss and gradients against the eager step's, bit for bit; one 1080p
    viewer frame through network_gui.NetworkGUI over loopback against
    render_view's image, byte for byte; python -m
    reduced3dgs_torch.full_eval --dry_run --custom_scene on its scene and
    python -m reduced3dgs_torch.generate_results on its model (with the
    ring's FPS as fps_results.json).
17. sharded step groups and the profiling tools, in phase 15's process
    group (world size 1, NCCL; phases 15, 17's part 1 and 19 run inside
    it):
    ShardedTrainer.step_group at the 1080p training geometry, replicated
    and param_shard: a group of 8 replayed from one CUDA graph (its NCCL
    collectives captured) against 8 ShardedTrainer.step calls from the
    same state, every metric and every leaf bit for bit, one K1, K2, K3
    and K6 per replayed step; from budgets that overflow, the group
    re-run against the eager steps; graphed and eager ms per step in
    turns (3 rounds), with the single-card graphed Trainer.step_group on
    the same pool in the same turns (replicated layout);
    ShardedTrainer.step_group on phase 15's two gloo
    ranks on the card raises; scaling_bench at 512x512 with 2^15
    primitives graphed beside an eager run of the same steps (the same
    loss); python -m reduced3dgs_torch.profile_components and
    profile_trace (bf16x2: the top kernels of a replayed step) at bench.py's
    1080p geometry in this process, microbench_gather and
    microbench_binning as subprocesses, their lines printed.
18. the paper's evaluation through its entry points, after phase 17:
    python -m reduced3dgs_torch.compression_eval (the JAX script's world
    at 384x384, 28 train / 4 test views, its ground truth rendered by the
    port; vanilla and the scaled full_final trained as training CLI
    subprocesses with --fused_steps 16, the schedule cut to EVAL's 5,000
    iterations and still crossing densification, mercy, the SH cull at
    degree 3, a test iteration and the final compression; the four
    variants of each scored) and python -m reduced3dgs_torch.fps_table
    (render CLI subprocesses, the graphed ring); the step groups must have
    been replayed graphs, K1, K2, K3, K4 and K6 launched (this process's
    and the subprocesses' counts, through R3DGS_LAUNCH_LOG), every PSNR
    finite and above the untrained pool's, full/quantised_half smaller
    than vanilla/baseline, six FPS rows; then the native COLMAP reader
    (native/colmap_io.cpp built into reduced3dgs_torch/_build/) against
    the Python reader on a binary model of the phase's cameras and world.
    Its launches go on the kernels line as "launches_phase18".
19. the surgery on row shards (parallel/sharded.py:ShardRows), in phase
    15's process group after phase 17's part 1, at the 1080p training
    geometry on phase 9's student: each event on the row shard of the
    (1, 1) NCCL mesh against the single-card event on the same whole
    state and generator, bit for bit in every leaf, the pending
    gradients, the statistics and the next draw (growth to 2^20 slots;
    on the grown pool densify with store_grads, opacity reset, dead
    prune, the redundancy metric and mercy of every type; densify on the
    full pool, every new row dropped), each timed; the SH cull over the
    8 views through ShardRows.transmittance (K1 and K4 per strip) against
    the whole cull (equal degrees, coefficients equal where they are but
    the DC of demoted rows within 1e-4, one view's transmittance sums
    within 1e-3); the largest collective in bytes per capacity row;
    a param_shard ShardedTrainer and the single-card Trainer through a
    plain, a growth + densify + mercy and a cull iteration, seconds and
    torch.cuda.max_memory_allocated per iteration less the bytes held
    before it; then the same on a (1, 2) mesh of two gloo processes on
    the one card (or the reason gloo refused).  Its launches (the
    sharded runs', not the references') go on the kernels line as
    "launches_phase19".
20. the JAX package's quality experiments on phase 18's models, each as
    a subprocess (python -m reduced3dgs_torch.<name> --device cuda):
    half_float_ablation (the eight rows: f32_all, each of the six
    attribute groups rounded alone through float16, f16_all; f16_all may
    not beat f32_all by more than F16_MARGIN_DB), prune_finetune at one
    fraction (0.15) with a 200-iteration fine-tune in replayed step
    groups (its pack file must be smaller than phase 18's
    full/quantised_pack) and grad_reduce_ab with its part 1 (every leaf's
    one-step relative L2 of bf16x2 against f32 below MAX_GRAD_REL_L2) and
    two 200-iteration arms (f32, bf16x2: eager steps, K5 in the first);
    K1, K2, K3, K5 and K6 must have launched in the three processes
    (their launch logs).  Its launches go on the kernels line as
    "launches_phase20".
21. the JAX package's timing experiments, each as a subprocess (python
    -m reduced3dgs_torch.<name> --device cuda), their lines printed:
    multicam_step at root's 1080p geometry (2^19 primitives, budget 2^22)
    with a few iterations (a k = 1 and a k = 2 camera step, each a CUDA
    graph whose first replay must equal an eager step bit for bit, K1,
    K2, K3 and K6 once per view per replayed step; ms per step, the
    per-camera amortization, each view's num_rendered and the peak
    memory), microbench_sort, microbench_reduce, microbench_sortscale
    (root's rows and the port's key sort + K5 beside them, K5 once per
    port_current row) and microbench_scatter_pack (int32 and complex64
    index_add_) at root's sizes; K1, K2, K3, K5 and K6 must have launched
    in the five processes (their launch logs).  Then every port_current
    row at its own sizes (microbench_sort's, microbench_reduce's, whose
    bounds start past slot 0, and each of microbench_sortscale's),
    captured and replayed as the entry point times it, holds K5's output
    to the plain version (bit for bit on segments of at most two
    instances) and to the float64 sums (phase 7's tolerance).  Its
    launches go on the kernels line as "launches_phase21" (the checks'
    launches not counted).  The stage clock's kernel (csrc/stamp.cu) ends
    the kernels line: its launches in this process and in phases 6 and 9,
    and the renders whose counters phase 6 compared.
22. the fused preprocess kernel (csrc/preprocess_fwd.cu, the forward of
    ops/preprocess.py for renders that need no gradient) against the
    torch path on a seeded 2^18-row pool (mixed degrees, dead rows, rows
    behind the camera and outside the frustum, det-0 rows), at both
    benchmark scenes' cameras, with and without the alive mask, at
    scale_modifier 0.5 and with color_precomp: floats within 1e-5
    relative, integer outputs equal but where a rounding within 4 ulps
    excuses them (at most 1e-5 of the rows), two launches bit for bit; a
    captured graph bit for bit its eager launches with the
    preprocess_fused counter once a replay; frames through each path
    within 1e-6 mean gap; then its ms at the m360 and tnt sizes (2^22 and
    2^20 rows) beside the torch path's and the bytes bound, with the
    same parity held between the two paths' outputs at those sizes.  Its
    entry ends the kernels line, with its launches in phase 4's graphed
    ring (zeroed just before) and phase 6's frames.
23. alignment pads past binning's slack pool at the benchmark's m360_full
    size (splatbench/configs/m360_full.json, its assumed density, the
    scene from --seed): views of its viewing path served by the
    program's FrameServer and rendered by the plain reference
    (splatbench/reference/raster.py), each view's pad need against the
    pool, pads_spilled (tracing on) and the frame's mean and largest gap
    to the reference, within the m360_full.serve cell's limits; at least
    one view must lay pads past the pool, and on the first such view K1's
    keys and the whole BinningOut must equal the plain version's bit for
    bit.

The last line is {"ok": true, "device": {...}}.  Without a card, or
without the rest of the repository beside it, it exits non-zero first.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# full-size main path: the headline geometry of bench.py's 1080p config
MAIN = dict(width=1920, height=1080, n=1 << 19, scales=(0.00432, 0.0189))
# the K2 check scene: bench.py's 512p config
K2_SCENE = dict(width=512, height=512, n=1 << 17, scales=(0.008, 0.040),
                budget=3 << 18)
RING_VIEWS = 8
RING_RADIUS = 3.6

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and f32 outside
# the tensor cores
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The least f32 arithmetic the tile walks need per (pixel, instance) pair,
# counted on the formulas (an FFMA as 2, as the peak counts it; an FADD,
# FMUL, FSETP or FMNMX as 1; a MUFU.EX2 / MUFU.RCP on the special-function
# units is not counted: at 16 per SM and clock it is not the tighter
# limit).  The loops of csrc/tile_fwd.cu, csrc/tile_bwd.cu and
# csrc/tile_trans.cu are written to these formulas (csrc/tile_walk.cuh).
# Every walked pair: dx, dy 2; the power dx (a dx + b dy) + c dy^2 with the
# conic pre-scaled once per instance 3 FMUL and 2 FFMA (7); min(power, 0)
# 1; op * e 1; min(0.99, .) 1; the power and alpha tests 2: 14.  A blended
# pair adds 1 - alpha, T (1 - alpha), the T test, alpha * T and three
# colour FFMAs: 10.  The pair that stops a pixel adds the first three: 3.
K2_OPS_WALKED = 14
K2_OPS_BLEND = 10
K2_OPS_STOP = 3
K1_OPS_PER_STEP = 4  # load, compare, select, add per search step
# K3 repeats K2's walk (K2_OPS_WALKED, K2_OPS_STOP).  A blended pair adds
# 24: T (1 - alpha) and its test 3, w 1, gc = g . rgb 5, the prefix 2,
# q - incl 1, times the reciprocal of 1 - alpha 1, dalpha 2, ge = e dalpha
# 1 and the eight products of its terms of the nine sums (ge {dx, dy,
# dx^2, dx dy, dy^2}, w g; the factors that belong to the instance are
# applied once per instance, which is not counted).  The sums over a
# tile's pixels need K3_OPS_REDUCE adds per blended pair; the kernel's
# exchanging butterfly spends 12 SHFL and 12 FADD per warp that blends an
# instance (K3_OPS_WARP_TREE; nine separate trees took 45).
K3_OPS_BLEND = 24
K3_OPS_REDUCE = 9
K3_OPS_WARP_TREE = 12
# The bounds first counted the instructions of the first kernels' SASS:
# expf's range reduction and an unscaled conic (26 per walked pair), an
# exact division and per-pixel instance factors (45 per blended pair of
# K3).  Each report prints the bound on those counts beside today's, so
# that roofline shares stay comparable with the earlier records.
FORMER_OPS_WALKED = 26
FORMER_K3_OPS_BLEND = 45
# K4 (csrc/tile_trans.cu) repeats K2's walk and blend decision
# (K2_OPS_WALKED, K2_OPS_STOP).  A blended pair adds 1 - alpha, T (1 -
# alpha) and its test (1 FADD, 1 FMUL, 1 FSETP: 3) and needs the two sums'
# adds over the tile's pixels (2); the kernel takes a warp's sums as one
# integer REDUX of fixed-point T and one __ballot_sync + POPC.
K4_OPS_BLEND = 5
PROFILE_TOP = 12  # kernels listed by phases 6 and 9
SEG_ROW_BYTES = {"f32": 36, "bf16x2": 20}  # gradient payload per instance
# phase 7's skewed segment layout: a few primitives that cover far more
# tiles than the rest (kernel tiers: one lane group, one warp, one block)
SKEWED = dict(p=1 << 19, n_long=64, long_len=20000, n_mid=1024,
              mid_len=(33, 1024), short_max=3)
# phase 9: the trainer's schedule on the bench scene.  Three passes over
# the 8 views; the densify iteration is the last of them (its loss is
# taken before the surgery), so the loss check compares the first pass
# with the third, and the steps after it run on the grown pool.
TRAIN = dict(steps=24, timed_steps=4, f32_steps=4, densify_from=15,
             densify_interval=24, percent_dense=0.003, grad_threshold=1e-4,
             dc_noise=0.3, opacity_noise=0.5, initial_budget=1 << 17)
BENCH_BUDGET = 1 << 22  # bench.py's 1080p instance budget
# phase 16: reduced3dgs_torch.bench's headline configuration (bench.py's
# 1080p: width, height, primitives, scale range, budget, tag)
BENCH_CONFIG = (1920, 1080, 1 << 19, (0.00432, 0.0189), 1 << 22, "1080p")
# phase 13: 16 fusible iterations, eager and in groups of 8; the overflow
# run starts every camera at a budget far under a 1080p view's need; the
# timing alternates eager and graphed groups
FUSED = dict(steps=16, group=8, overflow_budget=1 << 17, rounds=3)
# phase 15: tile-row strips of the 1080p frame (cdiv(68, 4) = 17 rows
# each), plain iterations of each sharded trainer, points of the kNN check
STRIPS = 4
MULTI = dict(steps=4, knn_points=1 << 16)
SCALING_ARGS = ()  # python -m reduced3dgs_torch.parallel.launch --scaling
# phase 17: sharded step groups (their size, the rounds in turns, the
# overflow run's starting budget), the graphed scaling harness at
# parallel/launch.py's defaults, the profiling tools at bench.py's 1080p
# geometry (profile_trace's replays and the kernels it lists), and extra
# arguments of the microbenchmark subprocesses
SHARDED = dict(group=8, rounds=3, overflow_budget=1 << 17)
SCALING = dict(width=512, prims=1 << 15, iters=20)
TOOLS = (1920, 1080, 1 << 19, 1 << 22)
TRACE = dict(iters=5, top=30, scales=(0.00432, 0.0189))
MICRO_ARGS = {"microbench_gather": (), "microbench_binning": ()}
# phase 18: the evaluation scripts at the JAX script's scene (384x384, 28 /
# 4 views), the schedule cut to 5,000 of its 10,000 iterations: the cull
# (at 3,000) still finds SH degree 3 and mercy runs (at 500, 1,000 and
# 2,000: never in the last 3,000 iterations)
EVAL = dict(iterations=5000, size=384, n_train=28, n_test=4)
# phase 19: the surgery on row shards on phase 9's student at the training
# geometry: the share of rows above the densify threshold, the instance
# budget of every render (bench.py's 1080p), the most bytes per global
# capacity row of a collective that moves no row to a new owner, and how
# far the DC of a row the cull demotes may move (its mean colour weighs
# the views by transmittance sums added in another order)
SURGERY = dict(grad_share=0.02, budget=BENCH_BUDGET, dc_atol=1e-4)
MAX_SURGERY_BYTES_PER_ROW = 64
# phase 20: the JAX package's quality experiments on phase 18's models:
# the prune / fine-tune ladder at one fraction with a short fine-tune, the
# bf16x2 A/B with two arms of a few iterations; f16_all may beat f32_all
# by no more than F16_MARGIN_DB, and bf16x2 moves no gradient leaf by a
# relative L2 of MAX_GRAD_REL_L2 or more
QUALITY = dict(fracs=("0.15",), ft_iters=200, ab_iters=200,
               ab_arms=("f32", "bf16x2"))
F16_MARGIN_DB = 0.05
MAX_GRAD_REL_L2 = 1e-2
# phase 21: the timing experiments' arguments (multicam_step at root's
# 1080p geometry with a few iterations; the microbenchmarks at root's
# sizes)
TIMING_ARGS = {
    "multicam_step": ("1920", "1080", str(1 << 19), str(1 << 22), "3"),
    "microbench_sort": (), "microbench_reduce": (),
    "microbench_sortscale": (), "microbench_scatter_pack": ()}
# phase 22: the fused preprocess kernel (csrc/preprocess_fwd.cu) at the
# benchmark scenes' sizes (splatbench/configs/*_dense.json: the image,
# fov_x, the pool's capacity and its live rows, the scale base; m360
# shades its SH rows, tnt takes color_precomp from variable-SH shading)
# and its parity pools' rows; what a row reads besides its coefficients
# (xyz 12, log-scales 12, quaternion 16, opacity 4, degree 4, alive 1) and
# what it writes (PreprocessOut: 64)
PREP_SIZES = {
    "m360": dict(width=1237, height=822, fov_x=56.0, rows=1 << 22,
                 alive=2959677, precomp=False, scale=0.012),
    "tnt": dict(width=979, height=546, fov_x=80.0, rows=1 << 20,
                alive=828629, precomp=True, scale=0.02)}
PREP_PARITY_ROWS = 1 << 18
PREP_ROW_IN = 49
PREP_ROW_OUT = 64
PREP_FLOAT_GAP = 1e-5  # relative, each row to its largest component
PREP_NEAR_ULPS = 4  # an integer output may differ only this near a rounding
PREP_EXCUSED_SHARE = 1e-5  # ... and on at most this share of the rows
PREP_FRAME_GAP = 1e-6  # mean gap of a frame rendered through each path
# phase 23: the poses of the m360_full viewing path served and compared
# (the path's 600 poses, as the benchmark's serve traffic has them)
SPILL_PATH = 600
SPILL_POSES = (0, 75, 150, 225, 300, 375, 450, 525)
# phase 14: the offline compression's options
COMPRESS = ("--pack_xyz", "--prune_frac", "0.17", "--finetune_iters", "32")
# profiler kernel names of the train step's kernels (K5 and K6 are the
# two instances of one template)
STEP_KERNELS = {"expand": "bin_keys_kernel", "tile_fwd": "tile_fwd_kernel",
                "tile_bwd": "tile_bwd_kernel",
                "seg_reduce_packed": "seg_reduce_kernel<true>",
                "seg_reduce_f32": "seg_reduce_kernel<false>"}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


@contextlib.contextmanager
def blocked_rungs():
    """The rungs of ops/knn.py's certified blocked search that run inside
    the block, as [(m, certificate)]: a spy on _blocked_knn_step."""
    from reduced3dgs_torch.ops import knn as tknn

    rungs, step = [], tknn._blocked_knn_step

    def spy(points, k, m, box):
        out = step(points, k, m, box)
        rungs.append((m, out[2]))
        return out

    tknn._blocked_knn_step = spy
    try:
        yield rungs
    finally:
        tknn._blocked_knn_step = step


def search_of(rungs):
    """What a kNN call did, from its blocked_rungs: ("exact", None) without
    a rung, else ("blocked" or "brute_fallback", the last rung's m)."""
    if not rungs:
        return "exact", None
    m, ok = rungs[-1]
    return ("blocked" if bool(ok) else "brute_fallback"), m


class Codebook(NamedTuple):
    ids: np.ndarray  # (rows * k,) uint8
    centers: np.ndarray  # (256, 1) f32


def quantile_codebooks(arrs, num_clusters=256):
    """The 20 codebooks save_gaussian_ply stores, from numpy quantiles of
    each attribute's values (nearest center per value).  Phase 4 keeps
    this stand-in for its serving model: the port's k-means fit
    (ops/kmeans.produce_clusters) runs once at full width in phase 12,
    on the trained pool, and a second fit here would only repeat its
    seconds."""
    cols = {
        "features_dc": arrs["features_dc"][:, 0, :],
        "opacity": arrs["opacity"],
        "scaling": arrs["scaling"],
        "rotation_re": arrs["rotation"][:, :1],
        "rotation_im": arrs["rotation"][:, 1:],
    }
    for i in range(15):
        cols[f"features_rest_{i}"] = arrs["features_rest"][:, i, :]
    books = {}
    for k, v in cols.items():
        flat = np.ascontiguousarray(v, np.float32).reshape(-1)
        centers = np.quantile(
            flat, (np.arange(num_clusters) + 0.5) / num_clusters)
        centers = np.unique(centers.astype(np.float32))
        centers = np.pad(centers, (0, num_clusters - centers.size), "edge")
        mids = (centers[1:] + centers[:-1]) * 0.5
        ids = np.searchsorted(mids, flat).astype(np.uint8)
        books[k] = Codebook(ids=ids, centers=centers.reshape(-1, 1))
    return books


def make_arrays(n, scales, seed):
    """A random model as load_gaussian_ply arrays (bench.py's scene)."""
    rng = np.random.default_rng(seed)
    smin, smax = scales
    feats = np.zeros((n, 16, 3), np.float32)
    feats[:, 0] = rng.uniform(-1.5, 1.5, (n, 3))
    feats[:, 1:] = rng.normal(0, 0.2, (n, 15, 3))
    return {
        "xyz": rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32),
        "features_dc": feats[:, :1].copy(),
        "features_rest": feats[:, 1:].copy(),
        "scaling": np.log(rng.uniform(smin, smax, (n, 3))).astype(np.float32),
        "rotation": rng.normal(0, 1, (n, 4)).astype(np.float32),
        "opacity": rng.uniform(-2, 3, (n, 1)).astype(np.float32),
        "degrees": np.full(n, 3, np.int32),
    }


def ring_cameras(width, height, n_views=RING_VIEWS, radius=RING_RADIUS):
    from reduced3dgs_torch.cameras import Camera

    cams = []
    for i in range(n_views):
        a = 2 * math.pi * i / n_views
        cams.append(Camera.look_at(
            eye=(radius * math.sin(a), 0.0, -radius * math.cos(a)),
            target=(0, 0, 0), width=width, height=height, uid=i + 1,
            image_name=f"view_{i:03d}"))
    return cams


def _rotmat2qvec(R):
    """Rotation matrix -> (w, x, y, z) quaternion (inverse of qvec2rotmat)."""
    t = np.trace(R)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def write_colmap_text(root, cams):
    """A COLMAP text project (no images) holding `cams`."""
    from reduced3dgs_torch.ops.transforms import fov2focal

    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        for c in cams:
            f.write(f"{c.uid} PINHOLE {c.width} {c.height} "
                    f"{fov2focal(c.fov_x, c.width)!r} "
                    f"{fov2focal(c.fov_y, c.height)!r} "
                    f"{c.width / 2} {c.height / 2}\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        for c in cams:
            q = _rotmat2qvec(np.asarray(c.R).T)  # world->camera rotation
            vals = " ".join(repr(float(v)) for v in (*q, *c.T))
            f.write(f"{c.uid} {vals} {c.uid} {c.image_name}.png\n")
            f.write("0.0 0.0 -1\n")
    pts = np.random.default_rng(0).uniform(-1, 1, (16, 3))
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        for i, p in enumerate(pts):
            f.write(f"{i + 1} {p[0]} {p[1]} {p[2]} 128 128 128 0.5\n")


def write_model(root, arrs, cams, iteration=1):
    """source/ (COLMAP text) + model/point_cloud/iteration_N/{plain,
    quantised_half} PLYs; returns the port's ModelParams for it."""
    from reduced3dgs_torch.config import ModelParams
    from reduced3dgs_torch.models.gaussians import (
        padded_leaves, pool_from_numpy,
    )
    from reduced3dgs_torch.models.ply_io import save_gaussian_ply

    src = os.path.join(root, "source")
    model = os.path.join(root, "model")
    write_colmap_text(src, cams)
    pool = pool_from_numpy(
        padded_leaves(arrs, capacity=arrs["xyz"].shape[0]), "cpu")
    pc = os.path.join(model, "point_cloud", f"iteration_{iteration}")
    save_gaussian_ply(os.path.join(pc, "point_cloud.ply"), pool)
    save_gaussian_ply(os.path.join(pc, "point_cloud_quantised_half.ply"),
                      pool, quantile_codebooks(arrs), quantised=True,
                      half_float=True)
    return ModelParams(source_path=src, model_path=model, resolution=1)


# ---------------------------------------------------------------------------
# phase helpers (device-agnostic, so the CPU tests can rehearse them)
# ---------------------------------------------------------------------------

def expand_cases():
    """[(name, bin_keys keyword arguments)] for K1, as numpy int32 arrays
    and ints: the binning-test marks with room to spare, a budget that
    truncates them and no instances at all; a budget that ends inside one
    primitive's instances; P = 0 and P = 1; padding needs past the pad
    slots, so that binning's markers are clamped, with a budget that
    leaves no room for them and with one whose unused slots take them."""
    cases = []
    for name, p, budget, grid in [
            ("plain", 700, 8192 + 1024, (20, 12)),
            ("plain", 2200, 32 * 1024, (40, 23)),
            ("truncate", 2200, 16 * 1024, (40, 23)),
            ("empty", 300, 2048, (8, 6)),
            ("budget splits a primitive", 300, 4096, (16, 9)),
            ("P=0", 0, 1024, (4, 3)),
            ("P=1", 1, 1024, (4, 3)),
            ("padding past the pad slots", 700, 8192, (20, 12)),
            ("padding spilled into the unused slots", 700, 3 * 8192,
             (20, 12))]:
        if name == "budget splits a primitive":
            rng = np.random.default_rng(13)
            counts = rng.poisson(40, p).astype(np.int64)
        elif p < 80:
            rng = np.random.default_rng(17)
            counts = np.full(p, 37, np.int64)
        else:  # tests/test_binning.py's expand cases
            rng = np.random.default_rng(11)
            counts = rng.poisson(11, p).astype(np.int64)
            counts[:80] = 0
            counts[rng.integers(0, p, 60)] = 0
            if name == "empty":
                counts[:] = 0
        offsets = np.cumsum(counts)
        total = int(offsets[-1]) if p else 0
        num_tiles = grid[0] * grid[1]
        need = rng.integers(0, 128, num_tiles)
        need[rng.integers(0, num_tiles, num_tiles // 4)] = 0
        pad_start = np.concatenate([[0], np.cumsum(need)])
        # pad slots past the padding need, or half of it
        n_extra = (pad_start[-1] // 256 * 128 if name.startswith("padding")
                   else -(-(pad_start[-1] + 300) // 128) * 128)
        i = int(np.searchsorted(offsets, budget, side="right"))
        fits = min(total, budget) + pad_start[-1] <= budget + n_extra
        check((total > budget) == (name in ("truncate",
                                            "budget splits a primitive"))
              and (name != "empty" or total == 0)
              and (name != "budget splits a primitive"
                   or offsets[i] - counts[i] < budget < offsets[i])
              and (pad_start[-1] > n_extra) == name.startswith("padding")
              and (not name.startswith("padding")
                   or fits == name.startswith("padding spilled")),
              f"expand case {name} is not what it claims")
        cases.append((name, dict(
            offsets=offsets.astype(np.int32), counts=counts.astype(np.int32),
            rectpack=rng.integers(0, 1 << 30, p).astype(np.int32),
            pad_start=pad_start.astype(np.int32),
            nv=np.array([min(total, budget)], np.int32), grid_x=grid[0],
            budget=budget, b_pad=int(budget + n_extra))))
    return cases


def k1_edge_cases(device):
    """K1 on expand_cases against its plain version, bit for bit, and
    two launches bit for bit."""
    import torch

    from reduced3dgs_torch.ops import binning as tbin

    for name, case in expand_cases():
        kw = {k: torch.as_tensor(v, device=device)
              if isinstance(v, np.ndarray) else v for k, v in case.items()}
        got = tbin._bin_keys_cuda(**kw)
        again = tbin._bin_keys_cuda(**kw)
        want = tbin.bin_keys_plain(**kw)
        check(torch.equal(got, want), f"K1 {name}: kernel != plain")
        check(torch.equal(got, again), f"K1 {name}: two launches differ")
        print(f"phase 2: K1 {name}, P={case['counts'].size} budget="
              f"{case['budget']} B_pad={case['b_pad']}: bit-exact, two "
              "launches bit-identical", flush=True)


def bench_scene(n, scales, seed):
    """(xyz, features, scales, rotations, opacity, degrees) numpy arrays."""
    a = make_arrays(n, scales, seed)
    return (a["xyz"], np.concatenate([a["features_dc"], a["features_rest"]],
                                     axis=1),
            a["scaling"], a["rotation"], a["opacity"][:, 0], a["degrees"])


def kernel_inputs(device, width, height, n, scales, budget, seed=0,
                  eye=(0.0, 0.0, -RING_RADIUS), fast=False, tile_rows=None):
    """Run preprocess + binning of a bench-style scene on `device` and
    return (prep, binning, K2's (feat, ranges, limit)); fast: the bf16x2
    feature table; tile_rows: the binning of that window of tile rows."""
    import torch

    from reduced3dgs_torch.cameras import Camera
    from reduced3dgs_torch.ops import binning, preprocess, tile_render

    arrs = [torch.as_tensor(a, device=device)
            for a in bench_scene(n, scales, seed)]
    cam = Camera.look_at(eye=eye, target=(0, 0, 0), width=width,
                         height=height)
    with torch.no_grad():
        prep = preprocess.preprocess(
            arrs[0], arrs[2], arrs[3], arrs[4], arrs[1], arrs[5],
            cam.params(device))
        b = binning.bin_gaussians(prep, width, height, budget,
                                  tile_rows=tile_rows)
        feat, b_pad = tile_render._pack_features(b, fast)
    limit = torch.clamp(b.total_padded, max=b_pad).to(torch.int32)
    return prep, b, (feat, b.tile_ranges.contiguous(), limit)


def walk_ops(pairs, blend, walked=K2_OPS_WALKED):
    """The f32 operations of a tile walk for tile_fwd_plain's pair counts,
    at `blend` operations per blended pair."""
    return (walked * pairs["walked"] + blend * pairs["blended"]
            + K2_OPS_STOP * pairs["stopped"])


def k2_ops(pairs):
    """K2's f32 operations for tile_fwd_plain's pair counts."""
    return walk_ops(pairs, K2_OPS_BLEND)


def former_text(nbytes, ops, ms):
    """The bound on the first kernels' operation counts, as report text."""
    former = bound(nbytes, ops)[0]
    return (f"on the first kernels' operation counts the bound was "
            f"{former:.4f} ms, share {former / ms * 100:.1f} %")


def compare_k2(out, ref):
    """Max abs error and the share of values within 1e-4 (colour and T
    rows of every pixel)."""
    d = (out[:, 0:4, :] - ref[:, 0:4, :]).abs()
    return float(d.max()), float((d <= 1e-4).double().mean())


def k3_cotangent(packed, seed):
    """A normal dL/dpacked for K3: colour and T rows, zero padding rows."""
    import torch

    gen = torch.Generator(packed.device).manual_seed(seed)
    g = torch.randn(packed.shape, generator=gen, device=packed.device)
    g[:, 4:] = 0.0
    return g


def compare_k3(out, ref):
    """(max abs error, largest error relative to its row's max |ref|,
    share of values within 1e-4 of their row's max)."""
    scale = ref.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    d = (out - ref).abs()
    return (float(d.max()), float((d / scale).max()),
            float((d <= 1e-4 * scale).double().mean()))


def walked_slots(ranges, limit, b_pad):
    """(b_pad,) bool: the slots inside some tile's [start, min(end,
    limit)), the only ones K3 may write."""
    import torch

    s = ranges[0].long()
    e = torch.minimum(ranges[1].long(), limit.long())
    keep = e > s
    mark = torch.zeros(b_pad + 1, dtype=torch.int64, device=ranges.device)
    mark.index_add_(0, s[keep], torch.ones_like(s[keep]))
    mark.index_add_(0, e[keep], -torch.ones_like(e[keep]))
    return torch.cumsum(mark, 0)[:b_pad] > 0


def synthetic_walk_inputs(device, lens, width, height, limit=None, seed=0):
    """K2 / K3 inputs made by hand: tile t owns `lens[t]` instances (a
    multiple of 128, as binning aligns them) scattered over its own
    pixels.  Returns (feat (9, B_pad) f32, ranges (2, T) int32, limit ()
    int32); `limit` defaults to the number of slots."""
    import torch

    rng = np.random.default_rng(seed)
    gx = -(-width // 16)
    check(len(lens) == gx * -(-height // 16)
          and all(n % 128 == 0 for n in lens), "synthetic walk: tile lengths")
    ends = np.cumsum(lens)
    starts = ends - np.asarray(lens)
    total = max(int(ends[-1]), 128)
    feat = np.zeros((9, total), np.float32)
    for t, (s, e) in enumerate(zip(starts, ends)):
        n = e - s
        feat[0, s:e] = t % gx * 16 + rng.uniform(-2, 18, n)
        feat[1, s:e] = t // gx * 16 + rng.uniform(-2, 18, n)
        inv = 1.0 / rng.uniform(1.5, 6.0, n) ** 2
        feat[2, s:e] = inv
        feat[3, s:e] = inv * rng.uniform(-0.3, 0.3, n)
        feat[4, s:e] = inv * rng.uniform(0.7, 1.4, n)
        feat[5, s:e] = rng.uniform(0.02, 0.6, n)
        feat[6:9, s:e] = rng.uniform(0, 1, (3, n))
    ranges = np.stack([starts, ends]).astype(np.int32)
    lim = int(ends[-1]) if limit is None else limit
    return (torch.as_tensor(feat, device=device),
            torch.as_tensor(ranges, device=device),
            torch.tensor(lim, dtype=torch.int32, device=device))


def walk_edge_cases(device, seed=0):
    """[(name, (feat, ranges, limit), width, height)] at small size: a
    binned scene whose width and height are no multiples of 16, tiles
    whose ranges are exactly 128 and 256 instances (and an empty one), a
    limit that cuts a range in the middle of a batch, an all-empty
    frame."""
    _, _, ragged = kernel_inputs(device, 200, 136, 20000, (0.01, 0.05),
                                 1 << 17, seed)
    lens = [128, 256, 0, 384, 128, 256]  # 3 x 2 tiles of a 40 x 24 frame
    cut = sum(lens[:3]) + 128 + 77  # inside tile 3's second batch
    return [
        ("200x136, not multiples of 16", ragged, 200, 136),
        ("ranges of exactly 128 and 256",
         synthetic_walk_inputs(device, lens, 40, 24, seed=seed + 1), 40, 24),
        (f"limit {cut} cuts a range mid-batch",
         synthetic_walk_inputs(device, lens, 40, 24, limit=cut,
                               seed=seed + 2), 40, 24),
        ("all-empty frame",
         synthetic_walk_inputs(device, [0] * 6, 40, 24, seed=seed + 3),
         40, 24),
    ]


def k2_edge_cases(device, seed=0):
    """K2 on walk_edge_cases against its plain version (compare_k2's
    criterion), two launches bit for bit; empty tiles exactly colour 0 and
    T 1.  Returns the largest error."""
    import torch

    from reduced3dgs_torch.ops import tile_render as ttr

    worst = 0.0
    for name, k2in, w, h in walk_edge_cases(device, seed):
        gx = -(-w // 16)
        got = ttr._tile_fwd_cuda(*k2in, gx, w, h)
        again = ttr._tile_fwd_cuda(*k2in, gx, w, h)
        want = ttr.tile_fwd_plain(*k2in, gx, w, h)
        check(torch.equal(got, again), f"K2 {name}: two launches differ")
        err, share = compare_k2(got, want)
        check(err <= 5e-3 and share >= 0.999,
              f"K2 {name}: kernel != plain ({err:.3e}, {share:.6f})")
        ranges, limit = k2in[1], k2in[2]
        empty = torch.minimum(ranges[1], limit) <= ranges[0]
        check(bool((got[empty, 0:3] == 0).all())
              and bool((got[empty, 3] == 1).all())
              and bool((got[:, 4:] == 0).all()),
              f"K2 {name}: empty tiles or padding rows are not exact")
        worst = max(worst, err)
        print(f"phase 3: K2 edge case, {name}: max abs err {err:.3e}, share "
              f"within 1e-4 {share:.6f}, {int(empty.sum())} empty tiles "
              "exact, two launches bit-identical", flush=True)
    return worst


def k3_edge_cases(device, seed=0):
    """K3 on walk_edge_cases against its plain version (compare_k3's
    criterion), exact zeros outside the walked ranges, two launches bit
    for bit.  Returns the largest relative error."""
    import torch

    from reduced3dgs_torch.ops import tile_render as ttr

    worst = 0.0
    for name, (feat, ranges, limit), w, h in walk_edge_cases(device, seed):
        gx = -(-w // 16)
        packed = ttr._tile_fwd_cuda(feat, ranges, limit, gx, w, h)
        k3in = (feat, ranges, limit, gx, w, h, k3_cotangent(packed, seed),
                packed)
        got = ttr._tile_bwd_cuda(*k3in)
        again = ttr._tile_bwd_cuda(*k3in)
        want = ttr.tile_bwd_plain(*k3in)
        check(torch.equal(got, again), f"K3 {name}: two launches differ")
        walked = walked_slots(ranges, limit, feat.shape[1])
        check(bool((got[:, ~walked] == 0).all()),
              f"K3 {name}: a slot outside the walked ranges is not 0")
        if bool(walked.any()):
            _, rel, share = compare_k3(got, want)
        else:
            rel, share = float(got.abs().max()), 1.0
        check(rel <= 5e-3 and share >= 0.999,
              f"K3 {name}: kernel != plain ({rel:.3e}, {share})")
        worst = max(worst, rel)
        print(f"phase 7: K3 edge case, {name}: largest error / row max "
              f"{rel:.3e}, share within 1e-4 of the row max {share:.6f}, "
              f"{int((~walked).sum())} unwalked slots exactly 0, two "
              "launches bit-identical", flush=True)
    return worst


def k4_edge_cases(device, seed=0):
    """K4 on walk_edge_cases against its plain version (k4_case's per-slot
    criteria), exact zeros outside the walked ranges, two launches bit for
    bit.  Returns the largest error of a sum."""
    import torch

    from reduced3dgs_torch.ops import tile_render as ttr

    worst = 0.0
    for name, k4in, w, h in walk_edge_cases(device, seed):
        gx = -(-w // 16)
        got = ttr._tile_trans_cuda(*k4in, gx, w, h)
        again = ttr._tile_trans_cuda(*k4in, gx, w, h)
        want = ttr.tile_trans_plain(*k4in, gx, w, h)
        check(torch.equal(got, again), f"K4 {name}: two launches differ")
        walked = walked_slots(k4in[1], k4in[2], k4in[0].shape[1])
        check(bool((got[:, ~walked] == 0).all()),
              f"K4 {name}: a slot outside the walked ranges is not 0")
        c = compare_k4(got, want)
        check(c["err"] <= 1.01 and c["share"] >= 0.9999
              and c["flips"] <= max(1e-4 * got.shape[1], 1)
              and c["max_flip"] <= 2, f"K4 {name}: kernel != plain ({c})")
        worst = max(worst, c["err"])
        print(f"phase 10: K4 edge case, {name}: max abs err of the sums "
              f"{c['err']:.3e}, counts differ on {c['flips']} slots; "
              f"{int((~walked).sum())} unwalked slots exactly 0, two "
              "launches bit-identical", flush=True)
    return worst


def layout_text(layout):
    """tile_render.walk_layout's keywords as report text."""
    wide, high = layout["warp_shape"]
    return (f"{layout['pixels_per_thread']} pixel(s) per thread on blocks "
            f"of {wide}x{high}, batches of {layout['batch']}")


def lane_text(pairs, pixels=32):
    """The (warp, instance) counts of tile_fwd_plain(count_pairs=True) and
    the two lane-utilisation shares, as text; a warp walks `pixels`
    pixels (32 per pixel of a thread)."""
    walk = pairs["walked"] / max(pixels * pairs["warp_walked"], 1)
    blend = pairs["blended"] / max(pixels * pairs["warp_blended"], 1)
    return (f"warp_walked {pairs['warp_walked']}, warp_blended "
            f"{pairs['warp_blended']}, staged {pairs['staged']}; lane "
            f"utilisation walked / ({pixels} x warp_walked) "
            f"{walk * 100:.2f} %, blended / ({pixels} x warp_blended) "
            f"{blend * 100:.2f} %")


def skewed_lens(p, n_long, long_len, n_mid, mid_len, short_max, seed=5):
    """Segment lengths of a skewed layout: p segments of 0..short_max
    slots, of which n_mid have a length in mid_len and n_long have
    long_len."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, short_max + 1, p).astype(np.int64)
    where = rng.permutation(p)[:n_long + n_mid]
    lens[where[:n_long]] = long_len
    lens[where[n_long:]] = rng.integers(mid_len[0], mid_len[1] + 1, n_mid)
    return lens


def ragged_segments(p, seed=3, lens=None):
    """The segment layout of tests/test_tile_render.py::
    test_segment_reduce_multichunk_ragged_bounds (empty-segment clusters,
    P + 1 not a multiple of any window), or the given segment lengths,
    with the slots shuffled as the tile layout scatters a primitive's
    instances.  Returns (BinningOut fields as numpy arrays, (9, B_pad) f32
    rows in slot order, the same rows in segment order)."""
    rng = np.random.default_rng(seed)
    if lens is None:
        lens = rng.poisson(9, p).astype(np.int64)
        lens[:p // 10] = 0
        lens[rng.integers(0, p, p // 16)] = 0
    offsets = np.cumsum(lens)
    nv = int(offsets[-1])
    b_pad = -(-(nv + 512) // 8192) * 8192
    seg_bounds = np.concatenate([[0], offsets]).astype(np.int32)
    key = np.full(b_pad, np.iinfo(np.int32).max, np.int32)
    key[:nv] = np.repeat(np.arange(p), lens).astype(np.int32)
    perm = rng.permutation(p).astype(np.int32)
    inv = np.empty(p, np.int32)
    inv[perm] = np.arange(p, dtype=np.int32)
    shuffle = rng.permutation(b_pad)
    cols = rng.normal(0, 1, (9, b_pad)).astype(np.float32)
    shuffled = np.ascontiguousarray(cols[:, shuffle])
    fields = dict(gauss_aligned=key[shuffle],
                  tile_id=np.zeros(b_pad, np.int32),
                  tile_ranges=np.zeros((2, 1), np.int32),
                  num_rendered=np.int32(nv), total_padded=np.int32(nv),
                  seg_bounds=seg_bounds, prim_order=perm, prim_inv=inv)
    return fields, shuffled, cols


def seg_inputs(binning, dfeat):
    """K5 / K6 inputs as segment_reduce_by_src builds them: (rows, order,
    bounds), the rows being K3's output as it is."""
    from reduced3dgs_torch.ops import tile_render as ttr

    return (dfeat, ttr.segment_order(binning),
            binning.seg_bounds.contiguous())


def seg_values(rows, order, bounds, packed):
    """(9, n) f32: the values K5 / K6 add, in segment order (K6: rounded
    to bf16 through the bf16x2 packing)."""
    from reduced3dgs_torch.ops import tile_render as ttr

    vals = rows[:9, order[int(bounds[0]):int(bounds[-1])]]
    return ttr.through_bf16x2(vals) if packed else vals


def seg_reference(rows, order, bounds, packed):
    """float64 segment sums and sums of magnitudes, (9, P) each."""
    import torch

    vals = seg_values(rows, order, bounds, packed).double()
    n = vals.shape[1]
    num_p = bounds.shape[0] - 1
    seg = torch.repeat_interleave(
        torch.arange(num_p, device=rows.device),
        (bounds[1:] - bounds[:-1]).long(), output_size=n)
    out = torch.zeros((9, num_p), dtype=torch.float64, device=rows.device)
    return (out.clone().index_add_(1, seg, vals),
            out.index_add_(1, seg, vals.abs()))


def check_seg(got, ref, mag, what):
    """f32 segment sums against the float64 ones: within 2e-5 relative
    plus 1e-5 of the segment's sum of magnitudes (f32 rounding of a
    direct sum)."""
    err = (got.double() - ref).abs()
    ok = bool((err <= 2e-5 * ref.abs() + 1e-5 * mag + 1e-30).all())
    check(ok, f"{what}: segment sums off the float64 sums by "
              f"{float(err.max()):.3e}")
    return float(err.max())


def main_path(device, root, width, height, n, scales, seed, n_views):
    """Write, load and render the model through the port's entry points.
    Returns one dict per variant."""
    import torch

    from reduced3dgs_torch.render import (
        PoolView, measure_fps, next_budget, render_view,
    )
    from reduced3dgs_torch.scene import Scene

    cams = ring_cameras(width, height, n_views)
    t0 = time.perf_counter()
    args = write_model(root, make_arrays(n, scales, seed), cams)
    t_write = time.perf_counter() - t0
    scene = Scene(args, load_iteration=-1, shuffle=False, lazy_images=True)
    views = scene.get_train_cameras()
    check(len(views) == n_views and (views[0].width, views[0].height)
          == (width, height), "scene cameras do not match the ring")
    bg = torch.zeros(3, device=device)
    results = {}
    for variant, kw in (("baseline", {}),
                        ("quantised_half", dict(quantised=True,
                                                half_float=True))):
        t0 = time.perf_counter()
        pv = PoolView(scene.load_model(device=device, **kw))
        t_load = time.perf_counter() - t0
        check(int(pv.alive.sum()) == n, f"{variant}: loaded pool size")
        imgs, budgets, nrs = [], [], []
        budget = next_budget(1 << 15, 1)
        for cam in views:
            out, budget = render_view(pv, cam, bg, budget)
            nr = int(out.num_rendered)
            check(out.color.shape == (height, width, 3), "image shape")
            check(bool(torch.isfinite(out.color).all())
                  and bool(torch.isfinite(out.final_t).all()),
                  f"{variant}: non-finite image")
            check(nr <= budget, f"{variant}: num_rendered {nr} > {budget}")
            cover = float((out.final_t < 0.5).float().mean())
            check(cover > 0.2, f"{variant}: coverage {cover:.3f} too low")
            imgs.append(out.color.float().cpu())
            budgets.append(budget)
            nrs.append(nr)
        fps = measure_fps(pv, views, bg)
        results[variant] = dict(
            fps=fps["fps"], frames=fps["frames"], reps=fps["reps"],
            capture_s=fps["capture_s"], fps_launches=fps["launches"],
            fps_budget=fps["budget"], num_rendered=nrs, budgets=budgets,
            load_s=t_load, images=torch.stack(imgs), pool=pv)
    results["write_s"] = t_write
    results["views"] = views
    return results


def psnr(a, b):
    mse = float(((a.clamp(0, 1) - b.clamp(0, 1)) ** 2).mean())
    return 10 * math.log10(1.0 / max(mse, 1e-12))


# ---------------------------------------------------------------------------
# the walks' exponent: ex2.approx on the pre-scaled conic against expf
# ---------------------------------------------------------------------------

EXPF = ("-DWALK_EXP2=0",)  # csrc/tile_walk.cuh's exponent as expf
# the rule that keeps WALK_EXP2 1: the two builds' frames agree to this
# PSNR, and K4's statistics differ on at most this share of primitives
EXP2_MIN_PSNR = 60.0
EXP2_MAX_SHARE = 1e-4


def expf_kernels():
    """K2 and K4 built with EXPF, as kernels beside tile_render's."""
    from reduced3dgs_torch.ops import _cuda
    from reduced3dgs_torch.ops import tile_render as ttr

    return {name: _cuda.Kernel(name, k.symbol, k.argtypes, EXPF)
            for name, k in (("tile_fwd", ttr.TILE_FWD),
                            ("tile_trans", ttr.TILE_TRANS))}


@contextlib.contextmanager
def swapped(module, name, value):
    """module.name = value inside the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def exp2_frames(pv, views, budget, k2_expf):
    """The views rendered through renderer.render once, with K2 as built
    and, on each frame's own K2 inputs, K2 built with EXPF and K2's plain
    version.  Returns (PSNR of the colours of the two builds, {build:
    pixels whose colour or T is more than 2e-5 from the plain version's},
    {build: largest such difference}, pixels)."""
    import torch

    from reduced3dgs_torch.ops import tile_render as ttr
    from reduced3dgs_torch.render import render_once

    sq = 0.0
    over = {"ex2": 0, "expf": 0}
    err = {"ex2": 0.0, "expf": 0.0}
    pixels = 0
    tile_fwd = ttr.tile_fwd

    def spy(feat, ranges, limit, gx, w, h, base=0):
        nonlocal sq, pixels
        out = tile_fwd(feat, ranges, limit, gx, w, h, base)
        with swapped(ttr, "TILE_FWD", k2_expf):
            alt = ttr._tile_fwd_cuda(feat, ranges, limit, gx, w, h, base)
        ref = ttr.tile_fwd_plain(feat, ranges, limit, gx, w, h, base)
        gy = ranges.shape[1] // gx
        img = {}
        for name, packed in (("ex2", out), ("expf", alt), ("plain", ref)):
            c, t = ttr._packed_to_images(packed, gx, gy, w, h)
            img[name] = torch.cat([c, t[..., None]], dim=-1)
        sq += float(((img["ex2"][..., :3].clamp(0, 1)
                      - img["expf"][..., :3].clamp(0, 1)) ** 2).sum())
        for name in over:
            d = (img[name] - img["plain"]).abs().amax(dim=-1)
            over[name] += int((d > 2e-5).sum())
            err[name] = max(err[name], float(d.max()))
        pixels += w * h
        return out

    bg = torch.zeros(3, device=pv.device)
    with swapped(ttr, "tile_fwd", spy):
        for cam in views:
            render_once(pv, cam.params(pv.device), bg, budget)
    mse = sq / max(3 * pixels, 1)
    return 10 * math.log10(1.0 / max(mse, 1e-12)), over, err, pixels


def exp2_trans(case, k4_expf):
    """K4 as built and K4 built with EXPF on one k4_case's inputs, summed
    per primitive as transmittance_by_primitive does.  Returns (P,
    primitives whose touched differs, whose trans_sum is off by more than
    atol 1e-3 / rtol 1e-3, whose trans_sum bits differ)."""
    from reduced3dgs_torch.ops import tile_render as ttr

    with swapped(ttr, "TILE_TRANS", k4_expf):
        alt = ttr._tile_trans_cuda(*case["k4in"])
    a = per_primitive(case["binning"], case["out"])
    e = per_primitive(case["binning"], alt)
    num_p = a.shape[0]
    off = (a[:, 0] - e[:, 0]).abs() > 1e-3 + 1e-3 * e[:, 0].abs()
    return (num_p, int((a[:, 1] != e[:, 1]).sum()), int(off.sum()),
            int((a[:, 0] != e[:, 0]).sum()))


def exp2_verdict(frames, trans, smi):
    """Prints both builds' numbers and what the rule decides."""
    db, over, err, pixels = frames
    num_p, touched, off, bits = trans
    share = max(touched, off) / max(num_p, 1)
    keep = db >= EXP2_MIN_PSNR and share <= EXP2_MAX_SHARE
    print(f"phase 10: WALK_EXP2 1 (ex2.approx) against 0 (expf): ring frames "
          f"PSNR between the builds {db:.3f} dB; pixels more than 2e-5 from "
          f"K2's plain version, of {pixels}: ex2 {over['ex2']} (largest "
          f"{err['ex2']:.3e}), expf {over['expf']} (largest "
          f"{err['expf']:.3e}); K4 at 1080p, of {num_p} primitives: touched "
          f"differs on {touched}, trans_sum off by more than 1e-3 on {off} "
          f"(bits differ on {bits}), share {share * 100:.5f} %; rule (>= "
          f"{EXP2_MIN_PSNR:g} dB and <= {EXP2_MAX_SHARE * 100:g} %): "
          f"{'keep WALK_EXP2 1' if keep else 'set WALK_EXP2 0'}; {smi}",
          flush=True)
    return keep


# ---------------------------------------------------------------------------
# card-only parts
# ---------------------------------------------------------------------------

def time_ms(fn, reps):
    """Mean milliseconds per call by CUDA events around `reps` calls,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def bound(nbytes, ops):
    """(bound ms, "bytes" | "operations", bytes ms, operations ms)."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", t_bytes, t_ops)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from reduced3dgs_torch.ops import _cuda
    from reduced3dgs_torch.ops import binning as tbin
    from reduced3dgs_torch.ops import preprocess as tprep
    from reduced3dgs_torch.ops import tile_render as ttr
    from reduced3dgs_torch.utils import profiling

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(smi, flush=True)
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {kind}", flush=True)
    t0 = time.perf_counter()
    expf = expf_kernels()
    _cuda.build(_cuda.SOURCES, [(n, EXPF) for n in expf])
    print(f"phase 1: built {', '.join(_cuda.SOURCES)} with nvcc "
          f"{' '.join(_cuda.NVCC_FLAGS)}, and {', '.join(expf)} with "
          f"{' '.join(EXPF)} too, in {time.perf_counter() - t0:.3f} s",
          flush=True)

    # --- phase 2: K1 bit-exact ----------------------------------------
    k1_edge_cases(dev)

    # --- phase 3: K2 on the 512p scene; whole render vs the oracle ------
    s = K2_SCENE
    _, b512, k2in = kernel_inputs(dev, s["width"], s["height"], s["n"],
                                  s["scales"], s["budget"], args.seed)
    gx = -(-s["width"] // 16)
    got = ttr._tile_fwd_cuda(*k2in, gx, s["width"], s["height"])
    again = ttr._tile_fwd_cuda(*k2in, gx, s["width"], s["height"])
    want = ttr.tile_fwd_plain(*k2in, gx, s["width"], s["height"])
    torch.cuda.synchronize()
    err, share = compare_k2(got, want)
    print(f"phase 3: K2 512p num_rendered={int(b512.num_rendered)}: max abs "
          f"err {err:.3e}, share within 1e-4 {share:.6f}", flush=True)
    check(err <= 5e-3 and share >= 0.999, "K2 512p: kernel != plain")
    check(torch.equal(got, again), "K2 512p: two launches differ")
    k2_edge_cases(dev, args.seed)
    small = _small_render_check(dev)
    print(f"phase 3: small scene, kernels vs masked oracle on the card: "
          f"max abs err {small:.3e}", flush=True)

    # --- phase 4: the main path at full size ----------------------------
    root = os.path.join(REPO, ".chip_smoke_run")
    shutil.rmtree(root, ignore_errors=True)
    tbin.EXPAND.launches = 0
    ttr.TILE_FWD.launches = 0
    tprep.PREPROCESS_FWD.launches = 0
    res = main_path(dev, root, MAIN["width"], MAIN["height"], MAIN["n"],
                    MAIN["scales"], args.seed, RING_VIEWS)
    launches = {"expand": tbin.EXPAND.launches,
                "tile_fwd": ttr.TILE_FWD.launches,
                "preprocess_fwd": tprep.PREPROCESS_FWD.launches}
    check(all(v > 0 for v in launches.values()),
          f"main path bypassed a kernel: {launches}")
    for variant in ("baseline", "quantised_half"):
        r = res[variant]
        print(f"phase 4: {variant}: {r['fps']:.3f} FPS over {r['frames']} "
              f"frames ({RING_VIEWS} views x {r['reps']} replays of the "
              f"graphed ring) at {MAIN['width']}x{MAIN['height']} (budget "
              f"{r['fps_budget']}, num_rendered {min(r['num_rendered'])}.."
              f"{max(r['num_rendered'])}; capture {r['capture_s']:.3f} s, "
              f"launches per replay {r['fps_launches']}; load "
              f"{r['load_s']:.3f} s)", flush=True)
    q_psnr = psnr(res["baseline"]["images"], res["quantised_half"]["images"])
    print(f"phase 4: model write {res['write_s']:.3f} s; quantised_half vs "
          f"baseline PSNR {q_psnr:.3f} dB; launches {launches}", flush=True)
    check(q_psnr > 15.0, "quantised_half render diverges from baseline")
    frames = exp2_frames(res["baseline"]["pool"], res["views"],
                         res["baseline"]["fps_budget"], expf["tile_fwd"])
    print(f"phase 4: the ring through K2 built with WALK_EXP2 1 and 0: PSNR "
          f"between the builds {frames[0]:.3f} dB, pixels more than 2e-5 "
          f"from the plain version {frames[1]} of {frames[3]}", flush=True)

    # --- phase 5: kernel times at the main path's shapes ----------------
    budget = res["baseline"]["fps_budget"]
    prep, _, k2in = kernel_inputs(dev, MAIN["width"], MAIN["height"],
                                  MAIN["n"], MAIN["scales"], budget,
                                  args.seed)
    shutil.rmtree(root, ignore_errors=True)
    kernels = [_report_k1(prep, MAIN["width"], MAIN["height"], budget,
                          launches["expand"], tbin),
               _report_k2(k2in, MAIN["width"], MAIN["height"],
                          launches["tile_fwd"], ttr)]
    del prep, k2in

    # --- phase 6: where a frame's time goes -----------------------------
    stamp = {"name": "stamp", "route": "cuda",
             "source": "reduced3dgs_torch/csrc/stamp.cu", "replaces": None}
    before = profiling.STAMP.launches
    prep_before = tprep.PREPROCESS_FWD.launches
    stamp["counters_checked_phase6"] = _profile_frames(
        res["baseline"]["pool"], res["views"], budget, smi)
    stamp["launches_phase6"] = profiling.STAMP.launches - before
    prep_launches = {"launches_phase4": launches["preprocess_fwd"],
                     "launches_phase6": tprep.PREPROCESS_FWD.launches
                     - prep_before}
    check(prep_launches["launches_phase6"] > 0,
          f"phase 6: the frames bypassed preprocess_fwd: {prep_launches}")
    del res

    # --- phase 7: the training kernels against their plain versions ----
    for fast in (False, True):
        k3_case(dev, K2_SCENE, K2_SCENE["budget"], args.seed, fast)
    main_k3 = {fast: k3_case(dev, MAIN, budget, args.seed, fast)
               for fast in (False, True)}
    k3_edge_cases(dev, args.seed)
    ragged_seg_cases(dev)
    skewed_seg_case(dev)
    case = main_k3[False]
    segs = {mode: seg_case(case["binning"], case["dfeat"], mode,
                           "main path") for mode in ("f32", "bf16x2")}

    # --- phase 8: whole-render gradients on the card --------------------
    worst_ref, worst_16 = small_grad_check(dev)
    print(f"phase 8: small scene gradients on the card: tile vs ref "
          f"largest error / max|g| {worst_ref:.3e}; bf16x2 vs f32 "
          f"{worst_16:.3e}", flush=True)

    # --- phase 9: the training main path at full width ------------------
    pps, fb_ms, fb_nr = fwd_bwd_rate(dev)
    print(f"phase 9: fwd+bwd (render + L1 + gradients, bf16x2; "
          f"reduced3dgs_torch.bench's step, a replayed CUDA graph) at "
          f"{MAIN['width']}x{MAIN['height']}, num_rendered {fb_nr}, budget "
          f"{BENCH_BUDGET}: {fb_ms:.3f} ms, {pps:.4e} pixels/s; {smi}",
          flush=True)
    before = profiling.STAMP.launches
    train_l, f32_l, trainer, next_it = train_main_path(dev, args.seed, smi)
    stamp["launches_phase9"] = profiling.STAMP.launches - before
    kernels += [report_k3(case, train_l["tile_bwd"]),
                report_seg(*segs["f32"], "f32", f32_l["seg_reduce_f32"]),
                report_seg(*segs["bf16x2"], "bf16x2",
                           train_l["seg_reduce_packed"])]
    del case, segs, main_k3

    # --- phase 10: K4 against its plain version ---------------------------
    k4_case(dev, K2_SCENE, K2_SCENE["budget"], args.seed)
    k4_main = k4_case(dev, MAIN, budget, args.seed)
    k4_edge_cases(dev, args.seed)
    exp2_verdict(frames, exp2_trans(k4_main, expf["tile_trans"]), smi)

    # --- phase 11: transmittance render, tile vs ref, on the card ---------
    e_sum, d_touch = small_trans_check(dev)
    print(f"phase 11: small scene render(want_transmittance) on the card, "
          f"tile vs ref: trans_sum max abs err {e_sum:.3e}, touched differs "
          f"by at most {d_touch}", flush=True)

    # --- phase 12: the compression main path at full width -----------------
    comp_l, next_it = compression_main_path(dev, trainer, next_it, root,
                                            smi, keep=True)
    kernels.insert(3, report_k4(k4_main, comp_l["tile_trans"]))
    del k4_main

    # --- phase 13: fused steps, a CUDA graph of the train step ------------
    t0 = time.perf_counter()
    next_it = fused_main_path(trainer, next_it, smi)
    print(f"phase 13: {time.perf_counter() - t0:.3f} s", flush=True)

    # --- phase 14: checkpoints, offline compression, metrics ---------------
    t0 = time.perf_counter()
    checkpoint_check(trainer, next_it, root, smi)
    compress_and_metrics(trainer, root, args.seed, smi)
    print(f"phase 14: {time.perf_counter() - t0:.3f} s", flush=True)
    del trainer

    with world_of_one("nccl"):
        # --- phase 15: the multi-device path -------------------------------
        _, gloo_groups = multi_device_path(dev, args.seed, smi)

        # --- phase 17, part 1: sharded step groups in phase 15's group -----
        launches17 = sharded_group_path(dev, args.seed, smi, gloo_groups)

        # --- phase 19: the surgery on row shards in phase 15's group -------
        launches19 = sharded_surgery_path(dev, args.seed, smi)

    # --- phase 16: graphed ring and bench, viewer bridge, CLIs -------------
    serving_tools_path(dev, root, smi)
    shutil.rmtree(root, ignore_errors=True)

    # --- phase 17, part 2: scaling harness, profiling tools ----------------
    sharded_tools_path(dev, smi, launches17)

    # --- phase 18: the paper's evaluation through its entry points -------
    torch.cuda.empty_cache()
    eval_root = os.path.join(REPO, ".chip_smoke_eval")
    launches18 = eval_path(dev, eval_root, args.seed, smi, keep=True)

    # --- phase 20: the quality experiments on phase 18's models ---------
    launches20 = quality_path(dev, eval_root, EVAL["iterations"], smi)

    # --- phase 21: the timing experiments --------------------------------
    launches21 = timing_path(dev, eval_root, smi)
    shutil.rmtree(eval_root, ignore_errors=True)

    # --- phase 22: the fused preprocess kernel ---------------------------
    prep_kernel = preprocess_path(dev, args.seed, smi)

    # --- phase 23: pads past the slack pool at the m360_full size ---------
    spill_path(dev, args.seed)
    for k in kernels:
        k["launches_phase18"] = launches18[k["name"]]
        k["launches_phase19"] = launches19.get(k["name"], 0)
        k["launches_phase20"] = launches20[k["name"]]
        k["launches_phase21"] = launches21[k["name"]]
    # the stage clock's launches in this process (its own subprocesses'
    # are not logged): phases 6 and 9 trace, and every captured graph
    # holds its stamps
    stamp["launches"] = profiling.STAMP.launches
    kernels.append(stamp)
    kernels.append(dict(prep_kernel, **prep_launches))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _small_render_check(dev):
    """The whole render through the kernels against the masked oracle on
    a small scene (56x40, 300 primitives): atol 2e-5 / rtol 1e-4."""
    import torch

    from reduced3dgs_torch.cameras import Camera
    from reduced3dgs_torch.renderer import render

    a = [torch.as_tensor(x, device=dev)
         for x in bench_scene(300, (0.02, 0.12), 1)]
    cp = Camera.look_at(eye=(0, 0, -3.2), target=(0, 0, 0), width=56,
                        height=40).params(dev)
    bg = torch.tensor([0.2, 0.1, 0.4], device=dev)
    outs = [render(*a, cp, bg, width=56, height=40, instance_budget=4096,
                   backend=be) for be in ("tile", "ref")]
    check(int(outs[0].num_rendered) > 300, "small scene too sparse")
    err = float((outs[0].color - outs[1].color).abs().max())
    check(torch.allclose(outs[0].color, outs[1].color, atol=2e-5, rtol=1e-4)
          and torch.allclose(outs[0].final_t, outs[1].final_t, atol=2e-5,
                             rtol=1e-4), f"kernels vs oracle: {err:.3e}")
    return err


def k1_inputs(prep, width, height, budget, tbin, tile_rows=None):
    """K1's arguments in one bin_gaussians call (captured, not counted)
    and that call's BinningOut."""
    captured = {}
    orig = tbin.bin_keys

    def spy(*a):
        captured["args"] = a
        return orig(*a)

    tbin.bin_keys = spy
    try:
        out = tbin.bin_gaussians(prep, width, height, budget,
                                 tile_rows=tile_rows)
    finally:
        tbin.bin_keys = orig
    return captured["args"], out


def k1_bound(args):
    """K1's bound on these inputs: (bound ms, by, bytes ms, ops ms).  Each
    input read once (offsets, counts, rect words, pad_start) and each key
    written once; a search step per level of the binary search, over P
    ranks for each slot below nv and over T + 1 prefix sums for each pad
    slot."""
    offsets, _, _, pad_start, nv, _, budget, b_pad = args
    p = offsets.shape[0]
    n_pad = pad_start.shape[0]
    nbytes = 3 * 4 * p + 4 * n_pad + 8 * b_pad
    ops = (int(nv) * math.ceil(math.log2(p + 1))
           + (b_pad - budget) * math.ceil(math.log2(n_pad + 1)))
    return bound(nbytes, ops * K1_OPS_PER_STEP)


def check_k1(prep, width, height, budget, tbin, what, tile_rows=None):
    """K1 on the inputs of one bin_gaussians call: its keys and the whole
    BinningOut must equal the plain version's bit for bit.  Returns K1's
    arguments and the BinningOut."""
    import torch

    args, got_b = k1_inputs(prep, width, height, budget, tbin, tile_rows)
    got = tbin._bin_keys_cuda(*args)
    want = tbin.bin_keys_plain(*args)
    orig = tbin.bin_keys
    tbin.bin_keys = tbin.bin_keys_plain
    try:
        want_b = tbin.bin_gaussians(prep, width, height, budget,
                                    tile_rows=tile_rows)
    finally:
        tbin.bin_keys = orig
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"K1 {what}: kernel != plain")
    for field in got_b._fields:
        a, b = getattr(got_b, field), getattr(want_b, field)
        check(torch.equal(a, b), f"K1 {what}: BinningOut.{field} differs "
                                 "from the plain version's")
    return args, got_b


def _report_k1(prep, width, height, budget, launches, tbin):
    """K1 at the main path's shapes: its inputs are captured from one
    bin_gaussians call of the main-path view; the keys and the whole
    BinningOut must equal the plain version's bit for bit."""
    import torch

    args, _ = check_k1(prep, width, height, budget, tbin,
                       "main-path shapes")
    offsets, nv, b_pad = args[0], args[4], args[7]
    slots = torch.arange(int(nv), dtype=torch.int32, device=offsets.device)
    ms = time_ms(lambda: tbin._bin_keys_cuda(*args), 50)
    plain_ms = time_ms(lambda: tbin.bin_keys_plain(*args), 5)
    lib_ms = time_ms(lambda: torch.searchsorted(offsets, slots, right=True),
                     20)
    bms, by, b_ms, o_ms = k1_bound(args)
    print(f"phase 5: K1 P={offsets.numel()} budget={args[6]} B_pad={b_pad} "
          f"nv={int(nv)} tiles={args[3].numel() - 1}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, torch.searchsorted (the owner index of "
          f"the slots below nv only) {lib_ms:.4f} ms, bound {bms:.4f} ms "
          f"({by}; bytes {b_ms:.4f}, operations {o_ms:.4f}), roofline share "
          f"{bms / ms * 100:.1f} %; keys and BinningOut bit-identical to the "
          "plain version's", flush=True)
    return {"name": "expand", "route": "cuda",
            "source": "reduced3dgs_torch/csrc/expand.cu",
            "replaces": "reduced3dgs_tpu/ops/binning.py:164",
            "launches": launches, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms}


def _report_k2(k2in, w, h, launches, ttr):
    """K2 at the main path's shapes (the main-path view's binning)."""
    import torch

    gx = -(-w // 16)
    got = ttr._tile_fwd_cuda(*k2in, gx, w, h)
    again = ttr._tile_fwd_cuda(*k2in, gx, w, h)
    layout = ttr.walk_layout("tile_fwd")
    want, pairs = ttr.tile_fwd_plain(*k2in, gx, w, h, count_pairs=True,
                                     **layout)
    _, rows = ttr.tile_fwd_plain(*k2in, gx, w, h, count_pairs=True)
    torch.cuda.synchronize()
    err, share = compare_k2(got, want)
    check(err <= 5e-3 and share >= 0.999,
          f"K2 main-path shapes: kernel != plain ({err:.3e}, {share:.6f})")
    check(torch.equal(got, again), "K2 main-path shapes: two launches differ")
    ms = time_ms(lambda: ttr._tile_fwd_cuda(*k2in, gx, w, h), 20)
    plain_ms = time_ms(lambda: ttr.tile_fwd_plain(*k2in, gx, w, h), 2)
    ranges = k2in[1]
    inst = int((ranges[1] - ranges[0]).sum())
    num_tiles = ranges.shape[1]
    nbytes = 4 * ttr.TABLE_ROWS * inst + 8 * num_tiles \
        + 4 * ttr.PIX_ROWS * ttr.NPIX * num_tiles
    bms, by, b_ms, o_ms = bound(nbytes, k2_ops(pairs))
    former = former_text(
        nbytes, walk_ops(pairs, K2_OPS_BLEND, FORMER_OPS_WALKED), ms)
    print(f"phase 5: K2 tiles={num_tiles} instances={inst} pairs walked "
          f"{pairs['walked']}, blended {pairs['blended']}, stopped "
          f"{pairs['stopped']}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, bound "
          f"{bms:.4f} ms ({by}; bytes {b_ms:.4f}, operations {o_ms:.4f}), "
          f"roofline share {bms / ms * 100:.1f} % ({former}); max abs err "
          f"{err:.3e}, share within 1e-4 {share:.6f}; two launches "
          "bit-identical", flush=True)
    print(f"phase 5: K2 {layout_text(layout)}: "
          f"{lane_text(pairs, 32 * layout['pixels_per_thread'])}; "
          f"warps of two 16-pixel rows, batches of 128 (the former walk, "
          f"K4's): {lane_text(rows)}", flush=True)
    return {"name": "tile_fwd", "route": "cuda",
            "source": "reduced3dgs_torch/csrc/tile_fwd.cu",
            "replaces": "reduced3dgs_tpu/ops/tile_render.py:324",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


@contextlib.contextmanager
def binning_spy():
    """Every binning renderer.render makes inside the block, as
    (num_rendered, total_padded, B_pad, budget): the first two the
    binning's own 0-dim tensors, to be read on the host afterwards."""
    from reduced3dgs_torch.ops import binning

    seen, real = [], binning.bin_gaussians

    def spy(prep, width, height, budget, tile_rows=None):
        b = real(prep, width, height, budget, tile_rows=tile_rows)
        seen.append((b.num_rendered, b.total_padded,
                     b.gauss_aligned.shape[0], budget))
        return b

    binning.bin_gaussians = spy
    try:
        yield seen
    finally:
        binning.bin_gaussians = real


def check_counters(snap, seen, what):
    """The counters of a profiling.snapshot() against the binnings
    binning_spy saw, read on the host: the device's num_rendered and
    total_padded, and what the fold derives from them: the pad need, the
    pads past the budget (total_padded less num_rendered) per mille of
    the B_pad - budget slots K1 has for them (its slack pool);
    pads_spilled, the pads laid past that pool where the layout fits in
    B_pad, and the same per mille of the pool.  Returns the renders
    compared."""
    from reduced3dgs_torch.ops.binning import ALIGN

    nr = [int(n) for n, _, _, _ in seen]
    tp = [int(t) for _, t, _, _ in seen]
    pools = [b_pad - -(-budget // ALIGN) * ALIGN
             for _, _, b_pad, budget in seen]
    need = [(t - n) * 1000 // pool for n, t, pool in zip(nr, tp, pools)]
    spilled = [0 if t > b_pad else max(0, t - min(n, b_pad - pool) - pool)
               for n, t, pool, (_, _, b_pad, _) in zip(nr, tp, pools, seen)]
    spill = [v * 1000 // pool for v, pool in zip(spilled, pools)]
    want = {name: {"sum": sum(v), "max": max(v), "count": len(v)}
            for name, v in (("num_rendered", nr), ("total_padded", tp),
                            ("pad_need_permille", need),
                            ("pads_spilled", spilled),
                            ("pad_spill_permille", spill))}
    got = {name: snap["counters"].get(name) for name in want}
    check(seen and got == want, f"{what}: device counters {got}, the "
          f"binnings read on the host {want}")
    return len(seen)


def _profile_frames(pv, views, budget, smi):
    """Phase 6 on the baseline model over the ring at the settled budget.
    Stage times and the device counters come from the stage clock
    (profiling.enable(), the profiler off), the counters held to the
    binnings read on the host; the idle share comes from one pass under
    torch.profiler: its kernel time against the CUDA-event span of that
    same pass.  Returns the renders whose counters were compared."""
    import torch

    from reduced3dgs_torch.profile_trace import trace_call
    from reduced3dgs_torch.render import render_once
    from reduced3dgs_torch.utils import profiling

    bg = torch.zeros(3, device=pv.device)
    cps = [c.params(pv.device) for c in views]
    nv = len(cps)
    for cp in cps:  # warm-up at the budget
        render_once(pv, cp, bg, budget)
    torch.cuda.synchronize()
    profiling.reset()
    host = 0.0
    with profiling.enable(), binning_spy() as seen:
        for cp in cps:
            t0 = time.perf_counter()
            render_once(pv, cp, bg, budget)
            torch.cuda.synchronize()
            host += time.perf_counter() - t0
    snap = profiling.snapshot()
    profiling.reset()
    stages = snap["stages"]
    names = profiling.VIEW_STAGES[0 if pv.ragged is not None else 1:]
    check({n: s["count"] for n, s in stages.items()}
          == dict.fromkeys(names, nv) and snap["stages_open"] == 0
          and snap["stamps_dropped"] == 0,
          f"stage clock: not the stages {names} once a view: {snap}")
    compared = check_counters(snap, seen, "phase 6")
    stage = [stages[n]["s"] * 1e3 for n in names]
    print(f"phase 6: baseline {nv} views, budget {budget}, profiler off: "
          "stage ms per view (stage clock) "
          f"{', '.join(f'{n} {v / nv:.3f}' for n, v in zip(names, stage))}"
          f"; frame {sum(stage) / nv:.3f} ms on the device, "
          f"{host / nv * 1e3:.3f} ms host wall; device counters equal to "
          f"the {compared} binnings read on the host (num_rendered max "
          f"{snap['counters']['num_rendered']['max']}, pad need max "
          f"{snap['counters']['pad_need_permille']['max']} per mille); "
          f"{smi}", flush=True)

    trace, span = trace_call(
        lambda: [render_once(pv, cp, bg, budget) for cp in cps], pv.device,
        cuda_only=True, iters=nv)
    rows = trace.kernel_rows()
    check(rows, "profiler saw no kernel on the card")
    span /= nv
    # K1 writes binning's keys: no running max of the former key pass
    check(not any("cummax" in r[2] for r in rows),
          "a cummax kernel runs in the frame")
    busy = trace.busy_ms
    launches = sum(r[1] for r in rows)
    print(f"phase 6: profiled pass: {launches:.1f} kernel launches and "
          f"{busy:.3f} ms of kernel time per frame over a CUDA-event span "
          f"of {span:.3f} ms per frame (same pass, profiler on, CUDA "
          f"activity only): device "
          f"idle {(1 - busy / span) * 100:.1f} %; no cummax kernel; {smi}",
          flush=True)
    for ms, count, key in rows[:PROFILE_TOP]:
        print(f"phase 6: {ms:9.4f} ms/frame x{count:<6.1f} {key[:100]}",
              flush=True)
    return compared


# ---------------------------------------------------------------------------
# phases 7-9: the training step
# ---------------------------------------------------------------------------

def k3_case(dev, scene, budget, seed, fast):
    """K3 against its plain version at one scene; returns a dict with the
    inputs, the kernel's dfeat and the comparison."""
    import torch

    from reduced3dgs_torch.ops import tile_render as ttr

    w, h = scene["width"], scene["height"]
    _, b, (feat, ranges, limit) = kernel_inputs(
        dev, w, h, scene["n"], scene["scales"], budget, seed, fast=fast)
    gx = -(-w // 16)
    packed = ttr._tile_fwd_cuda(feat, ranges, limit, gx, w, h)
    g = k3_cotangent(packed, seed)
    got = ttr._tile_bwd_cuda(feat, ranges, limit, gx, w, h, g, packed)
    again = ttr._tile_bwd_cuda(feat, ranges, limit, gx, w, h, g, packed)
    want = ttr.tile_bwd_plain(feat, ranges, limit, gx, w, h, g, packed)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    check(torch.equal(got, again), f"K3 {w}x{h} fast={fast}: two launches "
                                   "differ")
    walked = walked_slots(ranges, limit, feat.shape[1])
    check(bool((got[:, ~walked] == 0).all()),
          "K3: a slot outside the walked ranges is not exactly 0")
    err, rel, share = compare_k3(got, want)
    check(rel <= 5e-3 and share >= 0.999,
          f"K3 {w}x{h} fast={fast}: kernel != plain ({rel:.3e}, {share})")
    print(f"phase 7: K3 {w}x{h} {'bf16x2' if fast else 'f32'} table, "
          f"num_rendered {int(b.num_rendered)}: max abs err {err:.3e}, "
          f"largest error / row max {rel:.3e}, share within 1e-4 of the "
          f"row max {share:.6f}; {int((~walked).sum())} unwalked slots "
          "exactly 0; two launches bit-identical", flush=True)
    return dict(binning=b, k3in=(feat, ranges, limit, gx, w, h, g, packed),
                dfeat=got, err=err)


def report_k3(case, launches):
    """K3's times at the main path's shapes, its bound and the JSON row."""
    from reduced3dgs_torch.ops import tile_render as ttr

    feat, ranges, limit, gx, w, h, g, packed = case["k3in"]
    ms = time_ms(lambda: ttr._tile_bwd_cuda(*case["k3in"]), 20)
    plain_ms = time_ms(lambda: ttr.tile_bwd_plain(*case["k3in"]), 1)
    layout = ttr.walk_layout("tile_bwd")
    _, pairs = ttr.tile_fwd_plain(feat, ranges, limit, gx, w, h,
                                  count_pairs=True, **layout)
    inst = int((ranges[1] - ranges[0]).sum())
    tiles = ranges.shape[1]
    nbytes = (4 * ttr.TABLE_ROWS * inst + 8 * tiles
              + 2 * 4 * ttr.PIX_ROWS * ttr.NPIX * tiles
              + 4 * ttr.TABLE_ROWS * feat.shape[1])
    bms, by, b_ms, o_ms = bound(
        nbytes, walk_ops(pairs, K3_OPS_BLEND + K3_OPS_REDUCE))
    former = former_text(nbytes, walk_ops(
        pairs, FORMER_K3_OPS_BLEND + K3_OPS_REDUCE, FORMER_OPS_WALKED), ms)
    red_ms = K3_OPS_REDUCE * pairs["blended"] / F32_OPS_PER_S * 1e3
    tree_ms = K3_OPS_WARP_TREE * pairs["warp_blended"] / F32_OPS_PER_S * 1e3
    print(f"phase 7: K3 tiles={tiles} instances={inst} pairs walked "
          f"{pairs['walked']}, blended {pairs['blended']}, stopped "
          f"{pairs['stopped']}; warps blending an instance "
          f"{pairs['warp_blended']}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}; bytes {b_ms:.4f}, "
          f"operations {o_ms:.4f}, of which the per-instance sums "
          f"{red_ms:.4f}; the butterfly's adds would take {tree_ms:.4f}),"
          f" roofline share {bms / ms * 100:.1f} % ({former})", flush=True)
    print(f"phase 7: K3 {layout_text(layout)}: "
          f"{lane_text(pairs, 32 * layout['pixels_per_thread'])}",
          flush=True)
    return {"name": "tile_bwd", "route": "cuda",
            "source": "reduced3dgs_torch/csrc/tile_bwd.cu",
            "replaces": "reduced3dgs_tpu/ops/tile_render.py:468",
            "launches": launches, "max_abs_err": case["err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


def seg_case(binning, dfeat, mode, what):
    """K5 (f32) or K6 (bf16x2) against its plain version and the float64
    sums; returns (inputs, max |kernel - plain|).  Two launches must give
    the same bits.  Segments of at most two instances leave no order of
    summation open, so there the kernel must equal the plain version bit
    for bit (for K6 that is the bf16 rounding in registers against
    pack_bf16x2 -> unpack_bf16x2); on longer ones the plain version's
    index_add_ adds with atomics on the card, in no fixed order, and the
    two are held to the float64 sums instead."""
    import torch

    from reduced3dgs_torch.ops import tile_render as ttr

    packed = mode == "bf16x2"
    name = f"K{6 if packed else 5} {what}"
    rows, order, bounds = seg_inputs(binning, dfeat)
    got = ttr._seg_reduce_cuda(rows, order, bounds, packed)
    again = ttr._seg_reduce_cuda(rows, order, bounds, packed)
    want = ttr.seg_reduce_plain(rows, order, bounds, packed)
    ref, mag = seg_reference(rows, order, bounds, packed)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{name}: two launches differ")
    lens = bounds[1:] - bounds[:-1]
    short = lens <= 2
    check(torch.equal(got[:, short], want[:, short]),
          f"{name}: segments of <= 2 instances differ from the plain version")
    e_ref = check_seg(got, ref, mag, name)
    check_seg(want, ref, mag, f"plain {name}")
    err = float((got - want).abs().max())
    print(f"phase 7: K{6 if packed else 5} ({mode}) {what}: P="
          f"{bounds.shape[0] - 1}, instances {int(bounds[-1])}, longest "
          f"segment {int(lens.max())}: max abs err {err:.3e} against the "
          f"plain version ({int(short.sum())} segments of <= 2 instances "
          f"bit-identical), {e_ref:.3e} against the float64 sums; two "
          "launches bit-identical", flush=True)
    return (rows, order, bounds), err


def seg_times(inputs, mode):
    """K5 / K6 on `inputs`: (kernel ms, plain ms, torch.segment_reduce ms
    on the values gathered into segment order beforehand, ms of the
    PyTorch calls that compute the same sums from the same inputs: the
    row gather through `order`, K6's rounding, torch.segment_reduce,
    bound tuple).  The bound: each instance's 36 B (f32) or 20 B (bf16
    pairs) and its 8 B index read once, the bounds and the sums once."""
    import torch

    from reduced3dgs_torch.ops import tile_render as ttr

    packed = mode == "bf16x2"
    rows, order, bounds = inputs
    ms = time_ms(lambda: ttr._seg_reduce_cuda(rows, order, bounds, packed),
                 50)
    plain_ms = time_ms(lambda: ttr.seg_reduce_plain(rows, order, bounds,
                                                    packed), 5)
    n = int(bounds[-1])
    num_p = bounds.shape[0] - 1
    data = seg_values(rows, order, bounds, packed).T.contiguous()  # (n, 9)
    lens = (bounds[1:] - bounds[:-1]).long()
    lib_ms = time_ms(lambda: torch.segment_reduce(data, "sum",
                                                  lengths=lens), 20)

    def same_inputs():
        vals = rows.T[order[:n]]  # (n, 9), one gathered row per instance
        if packed:
            vals = vals.to(torch.bfloat16).to(torch.float32)
        return torch.segment_reduce(
            vals, "sum", lengths=(bounds[1:] - bounds[:-1]).long())

    lib_same_ms = time_ms(same_inputs, 20)
    nbytes = (SEG_ROW_BYTES[mode] + 8) * n + 4 * (num_p + 1) + 36 * num_p
    return ms, plain_ms, lib_ms, lib_same_ms, bound(nbytes, 9 * n)


def seg_times_text(times):
    ms, plain_ms, lib_ms, lib_same_ms, (bms, by, b_ms, o_ms) = times
    return (f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.segment_reduce on a payload gathered beforehand "
            f"{lib_ms:.4f} ms, gather + torch.segment_reduce from the same "
            f"inputs {lib_same_ms:.4f} ms, bound {bms:.4f} ms ({by}; bytes "
            f"{b_ms:.4f}, operations {o_ms:.4f}), roofline share "
            f"{bms / ms * 100:.1f} %")


def report_seg(inputs, err, mode, launches):
    """K5 / K6 times at the main path's shapes, bound and JSON row."""
    packed = mode == "bf16x2"
    bounds = inputs[2]
    times = seg_times(inputs, mode)
    ms, plain_ms, lib_ms, lib_same_ms, (bms, by, _, _) = times
    name = "seg_reduce_packed" if packed else "seg_reduce_f32"
    print(f"phase 7: {name} P={bounds.shape[0] - 1} instances="
          f"{int(bounds[-1])}: {seg_times_text(times)}", flush=True)
    return {"name": name, "route": "cuda",
            "source": "reduced3dgs_torch/csrc/seg_reduce.cu",
            "replaces": ("reduced3dgs_tpu/ops/tile_render.py:1117" if packed
                         else "reduced3dgs_tpu/ops/tile_render.py:1083"),
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "library_same_inputs_ms": lib_same_ms}


def segments_binning(dev, p, lens=None):
    """(BinningOut, K3-style rows) of ragged_segments on `dev`."""
    import torch

    from reduced3dgs_torch.ops import binning as tbin
    from reduced3dgs_torch.ops import tile_render as ttr

    fields, cols, _ = ragged_segments(p, lens=lens)
    b = tbin.BinningOut(**{k: torch.as_tensor(np.asarray(v), device=dev)
                           for k, v in fields.items()})
    return b, ttr.as_records(torch.as_tensor(cols, device=dev))


def ragged_seg_cases(dev):
    """K5 and K6 on the ragged multi-window layouts (P = 700, 2500)."""
    for p in (700, 2500):
        b, rows = segments_binning(dev, p)
        for mode in ("f32", "bf16x2"):
            seg_case(b, rows, mode, f"ragged P={p}")


def skewed_seg_case(dev):
    """K5 and K6 on the skewed layout, checked and timed on its own
    line."""
    b, rows = segments_binning(dev, SKEWED["p"], skewed_lens(**SKEWED))
    for mode in ("f32", "bf16x2"):
        inputs, _ = seg_case(b, rows, mode, "skewed")
        print(f"phase 7: K{6 if mode == 'bf16x2' else 5} ({mode}) skewed: "
              f"{seg_times_text(seg_times(inputs, mode))}", flush=True)


def render_grads(dev, arrs, cp, bg, width, height, backend, grad_reduce):
    """Gradients of |color|.mean() + 0.1 final_t.mean() w.r.t. the five
    parameter arrays (numpy in, tensors out)."""
    import torch

    from reduced3dgs_torch.renderer import render

    leaves = [torch.as_tensor(a, device=dev).requires_grad_(True)
              for a in arrs[:5]]
    out = render(*leaves, torch.as_tensor(arrs[5], device=dev), cp, bg,
                 width=width, height=height, instance_budget=4096,
                 backend=backend, grad_reduce=grad_reduce)
    loss = out.color.abs().mean() + 0.1 * out.final_t.mean()
    return torch.autograd.grad(loss, leaves)


def small_grad_check(dev):
    """Phase 8: tile (K2 + K3 + K5) against the differentiable oracle at
    atol 2e-4 max|g| / rtol 2e-3, and bf16x2 against f32 within
    2e-2 max|g|, on the 56x40, 300-primitive scene (opacity below the
    0.99 clamp, which the oracle's autodiff gates)."""
    import torch

    from reduced3dgs_torch.cameras import Camera

    arrs = bench_scene(300, (0.02, 0.12), 1)
    cp = Camera.look_at(eye=(0, 0, -3.2), target=(0, 0, 0), width=56,
                        height=40).params(dev)
    bg = torch.tensor([0.2, 0.1, 0.4], device=dev)
    g = {(be, gr): render_grads(dev, arrs, cp, bg, 56, 40, be, gr)
         for be, gr in (("ref", "f32"), ("tile", "f32"),
                        ("tile", "bf16x2"))}
    worst_ref = worst_16 = 0.0
    for i, name in enumerate(("xyz", "features", "scales", "rots",
                              "opacity")):
        a = g["ref", "f32"][i]
        b = g["tile", "f32"][i]
        c = g["tile", "bf16x2"][i]
        scale = float(a.abs().max())
        check(bool(torch.allclose(b, a, atol=2e-4 * scale, rtol=2e-3)),
              f"tile vs ref gradient of {name}")
        check(float((c - b).abs().max()) < 2e-2 * scale,
              f"bf16x2 vs f32 gradient of {name}")
        worst_ref = max(worst_ref, float((b - a).abs().max()) / scale)
        worst_16 = max(worst_16, float((c - b).abs().max()) / scale)
    return worst_ref, worst_16


def fwd_bwd_rate(dev):
    """bench.py's quantity on the card through reduced3dgs_torch.bench:
    pixels/s of its fwd+bwd step (one differentiable render, bf16x2, the
    L1 loss and the gradients of the five leaves) replayed as a CUDA
    graph, at MAIN's geometry and BENCH_BUDGET.  Returns (pixels/s, ms
    per step, num_rendered)."""
    from reduced3dgs_torch import bench

    pps, n, step_s = bench.measure(MAIN["width"], MAIN["height"], MAIN["n"],
                                   *MAIN["scales"], BENCH_BUDGET, dev)
    check(n <= BENCH_BUDGET, "fwd+bwd: the bench budget truncates")
    return pps, step_s * 1e3, n


def train_cameras(dev, seed, n_views=RING_VIEWS, scene=None):
    """The ring views (the first n_views) with the bench scene (`scene`,
    MAIN by default) rendered by the port as their ground truth; returns
    (cameras, the scene's numpy leaves)."""
    import torch

    from reduced3dgs_torch.models.gaussians import (
        padded_leaves, pool_from_numpy,
    )
    from reduced3dgs_torch.render import PoolView, render_view

    scene = scene or MAIN
    arrs = make_arrays(scene["n"], scene["scales"], seed)
    cams = ring_cameras(scene["width"], scene["height"])[:n_views]
    leaves = padded_leaves(arrs, capacity=scene["n"])
    pv = PoolView(pool_from_numpy(leaves, dev))
    bg = torch.zeros(3, device=dev)
    budget = 1 << 19
    for cam in cams:
        out, budget = render_view(pv, cam, bg, budget)
        cam.image = out.color.clamp(0, 1).cpu().numpy()
    return cams, leaves


def student_pool(dev, leaves, seed):
    """The ground-truth leaves with DC colours and opacity logits plus
    normal noise drawn from `seed`."""
    from reduced3dgs_torch.models.gaussians import pool_from_numpy

    rng = np.random.default_rng(seed + 1)
    s = dict(leaves)
    s["features_dc"] = (leaves["features_dc"] + rng.normal(
        0, TRAIN["dc_noise"], leaves["features_dc"].shape)).astype(np.float32)
    s["opacity"] = (leaves["opacity"] + rng.normal(
        0, TRAIN["opacity_noise"], leaves["opacity"].shape)).astype(
        np.float32)
    s["active_sh_degree"] = 3  # every primitive of the scene has degree 3
    return pool_from_numpy(s, dev)


def make_trainer(pool, cams, seed, grad_reduce="bf16x2", cls=None, **kw):
    """The port's Trainer (or `cls`, a subclass, with its keywords `kw`)
    with the default configuration, its densify cadence moved into the
    first TRAIN['steps'] iterations."""
    import dataclasses

    import torch

    from reduced3dgs_torch.config import OptimizationParams
    from reduced3dgs_torch.train.trainer import Trainer

    cfg = dataclasses.replace(
        OptimizationParams(), densify_from_iter=TRAIN["densify_from"],
        densification_interval=TRAIN["densify_interval"],
        percent_dense=TRAIN["percent_dense"],
        densify_grad_threshold=TRAIN["grad_threshold"])
    extent = 1.1 * RING_RADIUS  # the NeRF++ radius of the ring
    tr = (cls or Trainer)(pool, cfg, cams, spatial_lr_scale=extent,
                          background=torch.zeros(3, device=pool.device),
                          backend="tile", seed=seed,
                          initial_budget=TRAIN["initial_budget"],
                          grad_reduce=grad_reduce, **kw)
    tr.extent = extent
    return tr


def run_steps(tr, first, count):
    """Trainer steps first..first+count-1; returns (losses, host ms per
    step, each ending in a synchronize)."""
    import torch

    losses, ms = [], []
    for it in range(first, first + count):
        t0 = time.perf_counter()
        m = tr.step(it)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    return losses, ms


def train_main_path(dev, seed, smi):
    """Phase 9.  Returns the launch counts of the bf16x2 run (K1, K2, K3,
    K6) and of the f32 run (K5), the trainer and the next iteration."""
    import torch

    from reduced3dgs_torch.ops import binning as tbin
    from reduced3dgs_torch.ops import tile_render as ttr
    from reduced3dgs_torch.utils import profiling

    kernels = {"expand": tbin.EXPAND, "tile_fwd": ttr.TILE_FWD,
               "tile_bwd": ttr.TILE_BWD,
               "seg_reduce_packed": ttr.SEG_REDUCE_PACKED,
               "seg_reduce_f32": ttr.SEG_REDUCE_F32}
    t0 = time.perf_counter()
    cams, leaves = train_cameras(dev, seed)
    tr = make_trainer(student_pool(dev, leaves, seed), cams, seed)
    del leaves
    print(f"phase 9: ground truth of {len(cams)} views and the student "
          f"pool in {time.perf_counter() - t0:.3f} s", flush=True)

    for k in kernels.values():
        k.launches = 0
    steps = TRAIN["steps"]
    losses, ms = run_steps(tr, 1, steps)
    launches = {n: k.launches for n, k in kernels.items()}
    renders = launches["expand"]
    check(renders >= steps and all(launches[n] == renders for n in (
        "tile_fwd", "tile_bwd", "seg_reduce_packed"))
        and launches["seg_reduce_f32"] == 0,
        f"bf16x2 steps: not one K1, K2, K3 and K6 per render: {launches}")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    nv = len(cams)
    first, last = np.mean(losses[:nv]), np.mean(losses[2 * nv:3 * nv])
    check(last < first, f"loss did not fall: {first:.5f} -> {last:.5f}")
    pool = tr.state.pool
    print(f"phase 9: {steps} bf16x2 steps at {MAIN['width']}x"
          f"{MAIN['height']}: loss over the first {nv} views {first:.6f}, "
          f"over views {2 * nv + 1}..{3 * nv} {last:.6f}; median step "
          f"{float(np.median(ms)):.3f} ms (host wall, synchronized; steps "
          f"{', '.join(f'{v:.1f}' for v in ms)}); {renders} renders for "
          f"{steps} steps (budget regrows redo a step); budgets "
          f"{sorted(set(tr.budgets.values()))}; densify {tr.stats}; pool "
          f"capacity {pool.capacity}, alive {int(pool.num_alive)}; "
          f"launches {launches}; {smi}", flush=True)
    check(pool.capacity > MAIN["n"], "the densify step did not grow the pool")
    check(tr.stats.get("n_points_cloned", 0)
          + tr.stats.get("n_points_split", 0) > 0, "nothing was densified")

    # stage times by the stage clock over a few more steps
    it = steps + 1
    names = profiling.TRAIN_STAGES
    seen = []  # the last step's (gradient rows, binning, mode)
    reduce_by_src = ttr.segment_reduce_by_src

    def spy(dfeat, binning, grad_reduce="f32"):
        seen[:] = [(dfeat, binning, grad_reduce)]
        return reduce_by_src(dfeat, binning, grad_reduce)

    ttr.segment_reduce_by_src = spy
    profiling.reset()
    try:
        with profiling.enable(), binning_spy() as binnings:
            for _ in range(TRAIN["timed_steps"]):
                tr.step(it)
                torch.cuda.synchronize()
                it += 1
    finally:
        ttr.segment_reduce_by_src = reduce_by_src
    snap = profiling.snapshot()
    profiling.reset()
    stages = snap["stages"]
    # a budget regrow redoes a step: its stages are timed twice
    runs = TRAIN["timed_steps"] + snap["counters"].get(
        "budget_redos", {"sum": 0})["sum"]
    check({n: s["count"] for n, s in stages.items()}
          == dict.fromkeys(names, runs) and snap["stages_open"] == 0
          and snap["stamps_dropped"] == 0,
          f"stage clock: not the stages {names} once a step: {snap}")
    compared = check_counters(snap, binnings, "phase 9")
    stage = np.array([stages[n]["s"] * 1e3 / runs for n in names])
    print("phase 9: stage ms per step (stage clock, bf16x2) "
          + ", ".join(f"{n} {v:.3f}" for n, v in zip(names, stage))
          + f"; sum {stage.sum():.3f} ms; device counters equal to the "
          f"{compared} binnings read on the host; {smi}", flush=True)

    reduction_split(*seen[-1], smi)
    del seen
    profile_step(tr, it, smi)
    it += 1

    tr.grad_reduce = "f32"
    for k in kernels.values():
        k.launches = 0
    f32_losses, f32_ms = run_steps(tr, it, TRAIN["f32_steps"])
    f32_launches = {n: k.launches for n, k in kernels.items()}
    check(f32_launches["seg_reduce_f32"] == f32_launches["tile_bwd"]
          == f32_launches["expand"] >= TRAIN["f32_steps"]
          and f32_launches["seg_reduce_packed"] == 0,
          f"f32 steps: not one K5 per render: {f32_launches}")
    check(all(math.isfinite(x) for x in f32_losses), "non-finite f32 loss")
    print(f"phase 9: {TRAIN['f32_steps']} f32 steps: losses "
          f"{', '.join(f'{v:.6f}' for v in f32_losses)}; median step "
          f"{float(np.median(f32_ms)):.3f} ms; launches {f32_launches}",
          flush=True)
    return launches, f32_launches, tr, it + TRAIN["f32_steps"]


def reduction_split(dfeat, binning, mode, smi):
    """The reduction stage split into the key sort, the kernel and the
    reorder from depth rank to primitive id, each timed apart (CUDA
    events) on the (gradient rows, binning) that one Trainer step handed
    to segment_reduce_by_src."""
    from reduced3dgs_torch.ops import tile_render as ttr

    order = ttr.segment_order(binning)
    bounds = binning.seg_bounds.contiguous()
    packed = mode == "bf16x2"
    sums = ttr.seg_reduce(dfeat, order, bounds, packed)
    inv = binning.prim_inv
    t_sort = time_ms(lambda: ttr.segment_order(binning), 20)
    t_kernel = time_ms(lambda: ttr.seg_reduce(dfeat, order, bounds, packed),
                       20)
    t_reorder = time_ms(lambda: sums[:, inv.long()], 20)
    t_all = time_ms(lambda: ttr.segment_reduce_by_src(dfeat, binning, mode),
                    20)
    print(f"phase 9: reduction stage of one {mode} step (B_pad "
          f"{dfeat.shape[1]}, P {inv.shape[0]}, instances "
          f"{int(bounds[-1])}), CUDA events: key sort {t_sort:.4f} ms, "
          f"kernel {t_kernel:.4f} ms, reorder by prim_inv {t_reorder:.4f} "
          f"ms; segment_reduce_by_src as a whole {t_all:.4f} ms; {smi}",
          flush=True)


def profile_step(tr, it, smi):
    """One bf16x2 Trainer step under torch.profiler: kernel launches and
    kernel time against the CUDA-event span of that same step."""
    from reduced3dgs_torch.profile_trace import trace_call

    trace, span = trace_call(lambda: tr.step(it), tr.device, cuda_only=True)
    rows = trace.kernel_rows()
    check(rows, "profiler saw no kernel of the train step")
    busy = trace.busy_ms
    print(f"phase 9: profiled step: {sum(r[1] for r in rows)} kernel "
          f"launches and {busy:.3f} ms of kernel time over a CUDA-event "
          f"span of {span:.3f} ms (profiler on, CUDA activity only): "
          f"device idle {(1 - busy / span) * 100:.1f} %; {smi}", flush=True)
    for ms, count, key in rows[:PROFILE_TOP]:
        print(f"phase 9: {ms:9.4f} ms x{count:<5d} {key[:100]}", flush=True)


# ---------------------------------------------------------------------------
# phases 10-12: the compression path
# ---------------------------------------------------------------------------

def compare_k4(got, want):
    """K4 against its plain version, per slot.  Returns a dict: the
    largest |sum error|, the share of slots whose sum is within atol 1e-3
    / rtol 1e-3, the number of slots whose count differs and the largest
    count difference.  A sequential expf walk and the vectorised
    torch.exp one may flip single blends at the alpha = 1/255 and T =
    1e-4 thresholds; a flip moves a slot's count by one and its sum by
    that pixel's T (<= 1), and every later sum of that pixel by at most
    alpha = 1/255 of its term."""
    d = (got[0] - want[0]).abs()
    ok = d <= 1e-3 + 1e-3 * want[0].abs()
    dc = (got[1] - want[1]).abs()
    return dict(err=float(d.max()), share=float(ok.double().mean()),
                flips=int((dc != 0).sum()), max_flip=float(dc.max()))


def per_primitive(b, rows):
    """K4's (2, B_pad) rows summed per depth-rank primitive, (P, 2), as
    tile_render.transmittance_by_primitive sums them."""
    import torch

    num_p = b.prim_inv.shape[0]
    slot = torch.arange(rows.shape[1], device=rows.device)
    seg = torch.where(b.pad_mask | (slot >= b.total_padded), num_p,
                      b.gauss_aligned).long()
    return torch.zeros((num_p + 1, 2), dtype=torch.float32,
                       device=rows.device).index_add_(0, seg, rows.T)[:num_p]


def k4_case(dev, scene, budget, seed):
    """K4 against its plain version at one scene's kernel inputs; exact
    zeros on every slot outside the walked ranges, two launches bit for
    bit.  Slots: every sum
    within 1.01 (one flipped pixel) and >= 99.99 % within atol 1e-3 / rtol
    1e-3; counts differ on <= 0.01 % of the slots, by at most 2.  Per
    primitive (the sums the culling reads): trans_sum within atol 1e-3 /
    rtol 1e-3 on >= 99.99 %, touched differs by at most 2."""
    import torch

    from reduced3dgs_torch.ops import tile_render as ttr

    w, h = scene["width"], scene["height"]
    _, b, (feat, ranges, limit) = kernel_inputs(
        dev, w, h, scene["n"], scene["scales"], budget, seed)
    gx = -(-w // 16)
    got = ttr._tile_trans_cuda(feat, ranges, limit, gx, w, h)
    again = ttr._tile_trans_cuda(feat, ranges, limit, gx, w, h)
    want = ttr.tile_trans_plain(feat, ranges, limit, gx, w, h)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    check(torch.equal(got, again), f"K4 {w}x{h}: two launches differ")
    walked = walked_slots(ranges, limit, feat.shape[1])
    check(got.shape == (2, feat.shape[1]) and got.dtype == torch.float32,
          "K4: output shape")
    check(bool((got[:, ~walked] == 0).all()),
          "K4: a slot outside the walked ranges is not exactly 0")
    c = compare_k4(got, want)
    what = f"K4 {w}x{h}"
    check(c["err"] <= 1.01 and c["share"] >= 0.9999,
          f"{what}: sums off the plain version ({c})")
    check(c["flips"] <= 1e-4 * got.shape[1] and c["max_flip"] <= 2,
          f"{what}: counts off the plain version ({c})")
    pg, pw = per_primitive(b, got), per_primitive(b, want)
    p_ok = (pg[:, 0] - pw[:, 0]).abs() <= 1e-3 + 1e-3 * pw[:, 0].abs()
    p_touch = float((pg[:, 1] - pw[:, 1]).abs().max())
    p_share = float(p_ok.double().mean())
    check(p_share >= 0.9999 and p_touch <= 2,
          f"{what}: per-primitive sums off ({p_share}, {p_touch})")
    print(f"phase 10: {what} num_rendered {int(b.num_rendered)}: per slot "
          f"max abs err of the sums {c['err']:.3e}, share within 1e-3 "
          f"{c['share']:.6f}, counts differ on {c['flips']} slots (by at "
          f"most {c['max_flip']:.0f}); per primitive share within 1e-3 "
          f"{p_share:.6f}, touched differs by at most {p_touch:.0f}; "
          f"{int((~walked).sum())} unwalked slots exactly 0; two launches "
          "bit-identical", flush=True)
    return dict(k4in=(feat, ranges, limit, gx, w, h), err=c["err"],
                binning=b, out=got)


def report_k4(case, launches):
    """K4's times at the main path's shapes, its bound and the JSON row."""
    from reduced3dgs_torch.ops import tile_render as ttr

    feat, ranges, limit, gx, w, h = case["k4in"]
    ms = time_ms(lambda: ttr._tile_trans_cuda(*case["k4in"]), 20)
    k2_ms = time_ms(lambda: ttr._tile_fwd_cuda(*case["k4in"]), 20)
    plain_ms = time_ms(lambda: ttr.tile_trans_plain(*case["k4in"]), 1)
    layout = ttr.walk_layout("tile_trans")
    _, pairs = ttr.tile_fwd_plain(*case["k4in"], count_pairs=True, **layout)
    _, rows = ttr.tile_fwd_plain(*case["k4in"], count_pairs=True)
    inst = int((ranges[1] - ranges[0]).sum())
    tiles = ranges.shape[1]
    nbytes = 4 * 6 * inst + 8 * tiles + 4 * 2 * feat.shape[1]
    bms, by, b_ms, o_ms = bound(nbytes, walk_ops(pairs, K4_OPS_BLEND))
    former = former_text(
        nbytes, walk_ops(pairs, K4_OPS_BLEND, FORMER_OPS_WALKED), ms)
    print(f"phase 10: K4 tiles={tiles} instances={inst} pairs walked "
          f"{pairs['walked']}, blended {pairs['blended']}, stopped "
          f"{pairs['stopped']}; warps blending an instance "
          f"{pairs['warp_blended']}: kernel {ms:.4f} ms (K2 on the same "
          f"inputs in this loop {k2_ms:.4f} ms), plain {plain_ms:.4f} ms, "
          f"bound {bms:.4f} ms ({by}; bytes {b_ms:.4f}, operations "
          f"{o_ms:.4f}), roofline share {bms / ms * 100:.1f} % ({former})",
          flush=True)
    print(f"phase 10: K4 {layout_text(layout)}: {lane_text(pairs)}; warps "
          f"of two 16-pixel rows, batches of 128 (K4's former walk): "
          f"{lane_text(rows)}", flush=True)
    return {"name": "tile_trans", "route": "cuda",
            "source": "reduced3dgs_torch/csrc/tile_trans.cu",
            "replaces": "reduced3dgs_tpu/ops/tile_render.py:674",
            "launches": launches, "max_abs_err": case["err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


def small_trans_check(dev):
    """Phase 11: render(want_transmittance=True) through the tile backend
    (K1 + K2 + K4 on the card) against the "ref" oracle on the 56x40,
    300-primitive scene: trans_sum within atol 1e-3 / rtol 1e-3, touched
    within 2 per primitive (one flipped blend at a threshold)."""
    import torch

    from reduced3dgs_torch.cameras import Camera
    from reduced3dgs_torch.renderer import render

    a = [torch.as_tensor(x, device=dev)
         for x in bench_scene(300, (0.02, 0.12), 1)]
    cp = Camera.look_at(eye=(0, 0, -3.2), target=(0, 0, 0), width=56,
                        height=40).params(dev)
    bg = torch.zeros(3, device=dev)
    with torch.inference_mode():
        tile, ref = (render(*a, cp, bg, width=56, height=40,
                            instance_budget=4096, backend=be,
                            want_transmittance=True)
                     for be in ("tile", "ref"))
    check(int(tile.pixels_touched.sum()) > 1000, "small scene too sparse")
    check(tile.pixels_touched.dtype == torch.int32, "touched must be int32")
    err = float((tile.transmittance_sum - ref.transmittance_sum).abs().max())
    check(bool(torch.allclose(tile.transmittance_sum, ref.transmittance_sum,
                              atol=1e-3, rtol=1e-3)),
          f"trans_sum tile vs ref: {err:.3e}")
    d_touch = int((tile.pixels_touched - ref.pixels_touched).abs().max())
    check(d_touch <= 2, f"touched tile vs ref differs by {d_touch}")
    return err, d_touch


def degree_histogram(pool):
    """Alive primitives per SH degree 0..3, as Python ints."""
    import torch

    return torch.bincount(pool.degrees[pool.alive].long(),
                          minlength=4)[:4].tolist()


def second_thresholds(pool, cams, budget, quantile=0.3):
    """(std_threshold, cdist_threshold) that demote a share of this scene:
    the `quantile` of the alive primitives' colour std and of their
    degree-2 colour distance (in the CLI's units: distance 255 / sqrt 3),
    from one pass of the culling statistics."""
    import torch

    from reduced3dgs_torch.ops.sh_culling import calculate_colours_variance

    dists, var, _ = calculate_colours_variance(pool, cams, budget=budget)
    alive = pool.alive
    std = torch.nan_to_num(torch.sqrt(var)).mean(dim=2)[:, 0][alive]
    d2 = torch.nan_to_num(dists)[:, 2][alive]
    return (float(torch.quantile(std, quantile)),
            float(torch.quantile(d2, quantile)) * 255.0 / math.sqrt(3))


def ring_images(pv, views, bg, budget):
    """Clamped renders of the views, (V, H, W, 3) on the pool's device."""
    import torch

    from reduced3dgs_torch.render import render_view

    imgs = []
    for cam in views:
        out, budget = render_view(pv, cam, bg, budget)
        check(bool(torch.isfinite(out.color).all()), "non-finite image")
        imgs.append(out.color.clamp(0, 1))
    return torch.stack(imgs), budget


def compression_main_path(dev, tr, it, root, smi, keep=False):
    """Phase 12 on the trainer of phase 9 (its pool has been densified
    past 2^19 primitives): Trainer.step with mercy_points and
    cull_sh_iterations set inside the schedule, the CLI's final
    compression, and both render paths on the loaded quantised_half
    model.  Returns the kernels' launch counts over the whole path and
    the next iteration; keep: leave the model directory (root/model, its
    COLMAP text in root/source) for phase 14."""
    import dataclasses

    import torch

    from reduced3dgs_torch.config import ModelParams
    from reduced3dgs_torch.ops import binning as tbin
    from reduced3dgs_torch.ops import knn as tknn
    from reduced3dgs_torch.ops import redundancy
    from reduced3dgs_torch.ops import tile_render as ttr
    from reduced3dgs_torch.render import PoolView, measure_fps, render_once
    from reduced3dgs_torch.scene import Scene
    from reduced3dgs_torch.train.__main__ import final_compression

    kernels = {"expand": tbin.EXPAND, "tile_fwd": ttr.TILE_FWD,
               "tile_bwd": ttr.TILE_BWD, "tile_trans": ttr.TILE_TRANS}
    cams = tr.cameras
    nv = len(cams)
    shutil.rmtree(root, ignore_errors=True)
    src = os.path.join(root, "source")
    write_colmap_text(src, cams)
    scene = Scene(ModelParams(source_path=src,
                              model_path=os.path.join(root, "model"),
                              resolution=1),
                  load_iteration=None, shuffle=False, lazy_images=True,
                  pool=tr.state.pool, device=dev)
    views = scene.get_train_cameras()
    check(len(views) == nv, "scene cameras do not match the ring")

    # the schedule: densification over, a mercy pass at the next multiple
    # of 4, the cull two steps later (the paper's thresholds)
    mercy_it = -(-it // 4) * 4
    cull_it = mercy_it + 2
    tr.grad_reduce = "bf16x2"
    tr.scene = scene
    tr.opt_cfg = dataclasses.replace(
        tr.opt_cfg, densify_until_iter=it, densification_interval=4,
        mercy_interval=1, mercy_points=True, std_threshold=0.04,
        cdist_threshold=6.0)
    tr.fine_tune_start = tr.opt_cfg.iterations - 3000
    tr.cull_sh_iterations = (cull_it,)
    for k in kernels.values():
        k.launches = 0

    def step(i):
        before = {n: k.launches for n, k in kernels.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.step(i)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(math.isfinite(float(m["loss"])), f"non-finite loss at {i}")
        return dt, {n: k.launches - before[n] for n, k in kernels.items()}

    def check_cull(d, what):
        check(d["tile_trans"] == 2 * nv
              and d["expand"] - d["tile_bwd"] == 2 * nv
              and d["tile_fwd"] - d["tile_bwd"] == 2 * nv,
              f"{what}: not one K1, K2 and K4 per cull render: {d}")

    step_s = []
    alive_before = int(tr.state.pool.num_alive)
    searches = []  # (seconds, rows, blocked rungs) of the mercy's kNN
    knn_indices = redundancy.knn_indices

    def timed_knn(points, k, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with blocked_rungs() as rungs:
            out = knn_indices(points, k, **kw)
        torch.cuda.synchronize()
        searches.append((time.perf_counter() - t0, points.shape[0], rungs))
        return out

    redundancy.knn_indices = timed_knn
    try:
        for i in range(it, cull_it + 1):
            hist = degree_histogram(tr.state.pool)
            dt, d = step(i)
            step_s.append(dt)
            if i == mercy_it:
                st = tr.stats
                check("n_points_mercied" in st and len(searches) == 1,
                      "the mercy pass did not run, or not one kNN")
                knn_s, rows, rungs = searches[0]
                want = ("blocked" if rows > tknn.EXACT_LIMIT
                        else "exact")  # knn's auto-select
                method, m_cert = search_of(rungs)
                check(method == want,
                      f"the mercy's 30-NN search was not the {want} one: "
                      f"{method}, rungs {[m for m, _ in rungs]}")
                print(f"phase 12: mercy at iteration {i}: {alive_before} "
                      f"alive, {st['n_points_mercied']} mercied (redundancy "
                      f"threshold {st['redundancy_threshold']:.4f}, opacity "
                      f"threshold {st['opacity_threshold']:.4f}; "
                      f"lambda_mercy {tr.opt_cfg.lambda_mercy}, "
                      f"mercy_minimum {tr.opt_cfg.mercy_minimum}); step "
                      f"{dt:.3f} s, of which the 30-NN search "
                      f"{knn_s:.3f} s over {rows} rows ({want} "
                      f"search; certified at shortlist m = {m_cert}, "
                      f"rung {len(rungs)} of {len(tknn._M_LADDER)}); "
                      f"{smi}", flush=True)
            if i == cull_it:
                check_cull(d, "cull")
                after = degree_histogram(tr.state.pool)
                print(f"phase 12: cull at iteration {i} (std_threshold "
                      f"0.04, cdist_threshold 6, budget "
                      f"{max(tr.budgets.values())}): degrees 0..3 {hist} "
                      f"-> {after}; step with {2 * nv} transmittance "
                      f"renders {dt:.3f} s (a plain step {step_s[0]:.3f} "
                      f"s); launches {d}; {smi}", flush=True)
    finally:
        redundancy.knn_indices = knn_indices
    i = cull_it + 1
    kept = after[3] / max(hist[3], 1)  # still at degree 3
    if kept > 0.95 or kept < 0.05:
        std2, cd2 = second_thresholds(tr.state.pool, cams,
                                      max(tr.budgets.values()))
        tr.opt_cfg = dataclasses.replace(tr.opt_cfg, std_threshold=std2,
                                         cdist_threshold=cd2)
        tr.cull_sh_iterations = (i,)
        dt, d = step(i)
        check_cull(d, "second cull")
        after2 = degree_histogram(tr.state.pool)
        print(f"phase 12: the paper's thresholds demote "
              f"{(1 - kept) * 100:.3f} % of the degree-3 primitives of this "
              f"synthetic scene; second cull at iteration {i} at the 0.3 "
              f"quantiles of its own statistics (std_threshold {std2:.5f}, "
              f"cdist_threshold {cd2:.4f}): degrees 0..3 {after} -> "
              f"{after2}; step {dt:.3f} s; launches {d}", flush=True)
        check(after2 != after and after2[0] < sum(after2),
              "the second cull demoted nothing or everything")
        i += 1
    dt, _ = step(i)  # the culled pool trains on
    print(f"phase 12: one more step on the culled pool {dt:.3f} s",
          flush=True)
    # did a cull render overflow the shared budget? (it is not redone)
    budget = max(tr.budgets.values())
    pool = tr.state.pool
    bg = torch.zeros(3, device=dev)
    need = max(int(render_once(PoolView(pool), c.params(dev), bg,
                               budget).num_rendered) for c in views)
    print(f"phase 12: the cull's shared budget {budget} against the views' "
          f"largest instance count {need}: "
          f"{'OVERFLOW (truncated, not redone)' if need > budget else 'fits'}",
          flush=True)
    launches = {n: k.launches for n, k in kernels.items()}

    # final compression, as the training CLI ends
    scene.pool = pool
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paths = final_compression(scene, i, stats=stats)
    t_comp = time.perf_counter() - t0
    sizes = stats["bytes"]
    plain = sizes["point_cloud.ply"]
    print(f"phase 12: final compression of {int(pool.num_alive)} "
          f"primitives in {t_comp:.3f} s: produce_clusters "
          f"{stats['fit_s']:.3f} s, Lloyd steps per codebook "
          f"{stats['lloyd_steps']}; bytes "
          + ", ".join(f"{k} {v} (x{plain / v:.3f})" for k, v in sizes.items())
          + f"; {smi}", flush=True)
    check(len(paths) == 4 and all(os.path.getsize(p) > 0 for p in paths),
          "the final compression did not write four files")

    # load quantised_half back; both render paths
    scene.loaded_iter = i
    qpool = scene.load_model(quantised=True, half_float=True, device=dev)
    check(int(qpool.num_alive) == int(pool.num_alive), "loaded pool size")
    check(degree_histogram(qpool) == degree_histogram(pool),
          "the stored degrees differ from the pool's")
    want, budget = ring_images(PoolView(pool), views, bg, budget)
    dense_pv = PoolView(qpool)
    ragged_pv = PoolView(qpool, variable_sh=True)
    dense, budget = ring_images(dense_pv, views, bg, budget)
    ragged, budget = ring_images(ragged_pv, views, bg, budget)
    level = float((dense - ragged).abs().max()) * 255.0
    check(level <= 1.0, f"variable-SH render differs from the dense one by "
                        f"{level:.3f} 8-bit levels")
    q_psnr = psnr(dense, want)
    check(q_psnr > 20.0, f"quantised_half PSNR {q_psnr:.2f} dB")
    fps_d = measure_fps(dense_pv, views, bg, budget=budget)
    fps_r = measure_fps(ragged_pv, views, bg, budget=budget)
    sh_dense = qpool.capacity * 48
    sh_ragged = sum(n * (d + 1) ** 2 * 3
                    for d, n in enumerate(ragged_pv.ragged.sizes))
    print(f"phase 12: quantised_half loaded back: PSNR against the "
          f"unquantised pool's renders {q_psnr:.3f} dB; variable-SH vs "
          f"dense render within {level:.4f} 8-bit levels; "
          f"{fps_d['fps']:.3f} FPS dense, {fps_r['fps']:.3f} FPS "
          f"variable-SH over {nv} views (budget {fps_d['budget']}); SH "
          f"floats held {sh_dense} dense, {sh_ragged} ragged; launches of "
          f"the path {launches}; {smi}", flush=True)
    if not keep:
        shutil.rmtree(root, ignore_errors=True)
    return launches, i + 1


# ---------------------------------------------------------------------------
# phases 13-14: fused steps, checkpoints, offline compression, metrics
# ---------------------------------------------------------------------------

def trainer_snapshot(tr):
    """What a Trainer's next steps depend on: its state (steps never write
    a state's tensors in place) and the host's camera order, random
    stream and budgets."""
    import copy

    return (tr.state, copy.deepcopy(tr.rng.bit_generator.state),
            list(tr._stack), dict(tr.budgets))


def trainer_restore(tr, snap):
    tr.state, rng, stack, budgets = snap
    tr.rng.bit_generator.state = rng
    tr._stack, tr.budgets = list(stack), dict(budgets)


def run_steps_eager(tr, first, count):
    return [tr.step(i) for i in range(first, first + count)]


def run_steps_grouped(tr, first, count, size):
    ms, it = [], first
    while it < first + count:
        got = tr.step_group(range(it, min(it + size, first + count)))
        ms += got
        it += len(got)
    return ms


def compare_runs(ma, pa, mb, pb):
    """Two runs of the same steps: (largest relative loss difference,
    largest |num_rendered| difference, largest parameter difference, the
    parameters' match at rtol 5e-4 / atol 1e-3)."""
    import torch

    loss = max(abs(float(a["loss"]) - float(b["loss"]))
               / max(abs(float(a["loss"])), 1e-30) for a, b in zip(ma, mb))
    nr = max(abs(int(a["num_rendered"]) - int(b["num_rendered"]))
             for a, b in zip(ma, mb))
    diff = max(float((a - b).abs().max()) for a, b in zip(pa, pb))
    close = all(bool(torch.allclose(b, a, rtol=5e-4, atol=1e-3))
                for a, b in zip(pa, pb))
    return loss, nr, diff, close


def profiled(fn):
    """fn() under torch.profiler (CUDA activity and the host's runtime
    calls) between two CUDA events.  Returns (launches of the step's
    kernels by STEP_KERNELS name, kernel ms, the CUDA-event span in ms,
    all kernel launches, the host's launch calls: cudaLaunchKernel,
    cudaGraphLaunch, cudaMemcpyAsync and their variants)."""
    from reduced3dgs_torch.profile_trace import LAUNCH_CALLS, trace_call

    trace, span = trace_call(fn, "cuda")
    rows = trace.kernel_rows()
    counts = {n: sum(c for _, c, key in rows if sym in key)
              for n, sym in STEP_KERNELS.items()}
    host = sum(c for name, c in trace.host_calls.items()
               if name.startswith(LAUNCH_CALLS))
    return (counts, trace.busy_ms, span, sum(r[1] for r in rows), host)


def fused_main_path(tr, it, smi):
    """Phase 13 on the trainer of phase 12.  Returns the next iteration."""
    import dataclasses

    import torch

    from reduced3dgs_torch.train.trainer import carried

    sync = torch.cuda.synchronize
    n, size = FUSED["steps"], FUSED["group"]
    # no host boundary in the next iterations: no densification, mercy,
    # dead-point pruning or cull
    tr.opt_cfg = dataclasses.replace(
        tr.opt_cfg, densify_until_iter=0, mercy_points=False,
        prune_dead_points=False)
    tr.cull_sh_iterations = ()
    last = it + max(n, 3 * size + 2 * FUSED["rounds"] * size)
    check(all(tr.fusible(i) for i in range(it, last)),
          "phase 13: the schedule has a host boundary")
    tr.grad_reduce = "bf16x2"
    snap = trainer_snapshot(tr)

    def run(fn, budgets=None):
        trainer_restore(tr, snap)
        if budgets is not None:
            tr.budgets = dict(budgets)
        sync()
        t0 = time.perf_counter()
        ms = fn()
        sync()
        dt = time.perf_counter() - t0
        return ms, carried(tr.state), dict(tr.budgets), dt

    eager = run(lambda: run_steps_eager(tr, it, n))
    eager2 = run(lambda: run_steps_eager(tr, it, n))
    captures = tr.graph_captures
    grouped = run(lambda: run_steps_grouped(tr, it, n, size))
    noise = compare_runs(eager[0], eager[1], eager2[0], eager2[1])
    got = compare_runs(eager[0], eager[1], grouped[0], grouped[1])
    pool = tr.state.pool
    print(f"phase 13: {n} iterations from one state ({int(pool.num_alive)} "
          f"alive of {pool.capacity}, bf16x2), eager twice and in groups of "
          f"{size}: two eager runs differ by loss {noise[0]:.3e} (relative),"
          f" num_rendered {noise[1]}, parameters {noise[2]:.3e}; grouped "
          f"against eager: loss {got[0]:.3e}, num_rendered {got[1]}, "
          f"parameters {got[2]:.3e}; budgets "
          f"{sorted(set(grouped[2].values()))} (eager "
          f"{sorted(set(eager[2].values()))}); wall {eager[3]:.3f} s eager, "
          f"{grouped[3]:.3f} s grouped with "
          f"{tr.graph_captures - captures} captures; {smi}", flush=True)
    check(got[0] <= 1e-5 and got[1] <= 2 and got[3]
          and grouped[2] == eager[2],
          "phase 13: grouped steps differ from eager steps")

    # overflow: every camera's budget far under its need
    small = {c.uid: FUSED["overflow_budget"] for c in tr.cameras}
    captures = tr.graph_captures
    e_over = run(lambda: run_steps_eager(tr, it, n), small)
    g_over = run(lambda: run_steps_grouped(tr, it, n, size), small)
    got = compare_runs(e_over[0], e_over[1], g_over[0], g_over[1])
    print(f"phase 13: from budgets of {FUSED['overflow_budget']}: grouped "
          f"against eager: loss {got[0]:.3e}, num_rendered {got[1]}, "
          f"parameters {got[2]:.3e}; budgets grouped "
          f"{sorted(g_over[2].items())}, eager {sorted(e_over[2].items())};"
          f" {tr.graph_captures - captures} captures", flush=True)
    check(got[0] <= 1e-5 and got[1] <= 2 and got[3]
          and max(g_over[2].values()) > FUSED["overflow_budget"],
          "phase 13: the overflow group differs from the eager steps")

    # launches: one of K1, K2, K3, K6 per replayed step
    trainer_restore(tr, snap)
    run_steps_grouped(tr, it, size, size)  # the graph of this key exists
    before = dict(tr.graph_launches)
    counts, busy, span, kernels, host = profiled(
        lambda: tr.step_group(range(it + size, it + 2 * size)))
    replayed = {k: tr.graph_launches[k] - before[k] for k in before}
    print(f"phase 13: profiled group of {size}: kernels by name {counts}; "
          f"captured launches x replays {replayed}; {kernels} kernels, "
          f"{busy:.3f} ms of kernel time over a CUDA-event span of "
          f"{span:.3f} ms: {busy / size:.3f} ms kernel time per step, device "
          f"idle {(1 - busy / span) * 100:.1f} %; host launch calls "
          f"{host / size:.1f} per step; {smi}", flush=True)
    want = {"expand": size, "tile_fwd": size, "tile_bwd": size,
            "seg_reduce_packed": size, "seg_reduce_f32": 0}
    check(counts == want and (replayed == want or tr.device.type != "cuda"),
          f"phase 13: not one K1, K2, K3 and K6 per replayed step: "
          f"{counts}, {replayed}")  # (no graph, so no replays, on a CPU)
    _, e_busy, e_span, e_kernels, e_host = profiled(
        lambda: run_steps_eager(tr, it + 2 * size, size))
    print(f"phase 13: profiled {size} eager steps: {e_kernels / size:.1f} "
          f"kernels and {e_host / size:.1f} host launch calls per step, "
          f"{e_busy / size:.3f} ms kernel time per step, device idle "
          f"{(1 - e_busy / e_span) * 100:.1f} %; {smi}", flush=True)

    # ms per step, graphed and eager in turns
    first = it + 3 * size
    times = {"eager": [], "graphed": []}
    for r in range(FUSED["rounds"]):
        order = ("eager", "graphed") if r % 2 == 0 else ("graphed", "eager")
        for who in order:
            sync()
            t0 = time.perf_counter()
            if who == "eager":
                run_steps_eager(tr, first, size)
            else:
                tr.step_group(range(first, first + size))
            sync()
            times[who].append((time.perf_counter() - t0) * 1e3 / size)
            first += size
    print("phase 13: ms per step (host wall, synchronized, groups of "
          f"{size}, in turns): "
          + "; ".join(f"{w} {', '.join(f'{v:.3f}' for v in t)} (median "
                      f"{float(np.median(t)):.3f})" for w, t in times.items())
          + f"; captures {tr.graph_captures}, capture and warm-up "
          f"{tr.capture_s / max(tr.graph_captures, 1):.3f} s each; {smi}",
          flush=True)
    return first


def checkpoint_check(tr, it, root, smi):
    """Phase 14's checkpoint: save the trainer, load into a fresh Trainer,
    every leaf equal; one step of each after that."""
    import torch

    from reduced3dgs_torch.train.checkpoint import (
        load_checkpoint, save_checkpoint, state_leaves,
    )
    from reduced3dgs_torch.train.trainer import Trainer, carried

    path = os.path.join(root, f"chkpnt{it}.npz")
    t0 = time.perf_counter()
    save_checkpoint(path, tr.state, it, tr.spatial_lr_scale)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, got_it, slr = load_checkpoint(path, tr.device)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    fresh = Trainer(state.pool, tr.opt_cfg, tr.cameras, spatial_lr_scale=slr,
                    background=tr.background, backend=tr.backend,
                    initial_budget=tr.initial_budget,
                    grad_reduce=tr.grad_reduce)
    fresh.state, fresh.extent = state, tr.extent
    same = all(np.array_equal(a, b) for a, b in
               zip(state_leaves(state), state_leaves(tr.state)))
    check(same and got_it == it and slr == tr.spatial_lr_scale,
          "phase 14: the loaded checkpoint differs")
    trainer_restore(fresh, trainer_snapshot(tr))
    fresh.state = state
    ma, mb = tr.step(it), fresh.step(it)
    loss = abs(float(ma["loss"]) - float(mb["loss"]))
    diff = max(float((a - b).abs().max())
               for a, b in zip(carried(tr.state), carried(fresh.state)))
    print(f"phase 14: checkpoint of {int(tr.state.pool.num_alive)} alive / "
          f"{tr.state.pool.capacity} slots, {os.path.getsize(path)} bytes: "
          f"save {t_save:.3f} s, load {t_load:.3f} s, all 31 leaves equal; "
          f"one step after the load against one without: loss differs by "
          f"{loss:.3e}, state by {diff:.3e}; {smi}", flush=True)
    check(loss <= 1e-6 * abs(float(ma["loss"])) and diff <= 1e-5,
          "phase 14: the step after the load differs")
    os.remove(path)
    return it + 1


def lpips_random_weights(path, seed):
    """VGG16 + LPIPS heads of the right shapes from `seed` (the layout of
    reduced3dgs_torch/ops/lpips.py; tests/test_lpips.py's scales)."""
    from reduced3dgs_torch.ops.lpips import TAPS, VGG_CFG

    rng = np.random.default_rng(seed)
    arrays, cin, ci, heads = {}, 3, 0, []
    for spec in VGG_CFG:
        if spec == "M":
            continue
        arrays[f"conv{ci}_weight"] = rng.normal(
            0, 0.05, (spec, cin, 3, 3)).astype(np.float32)
        arrays[f"conv{ci}_bias"] = rng.normal(0, 0.01, spec).astype(
            np.float32)
        if ci in TAPS:
            heads.append(spec)
        cin, ci = spec, ci + 1
    for k, c in enumerate(heads):
        arrays[f"lin{k}_weight"] = rng.uniform(0, 0.1, (1, c, 1, 1)).astype(
            np.float32)
    np.savez(path, **arrays)
    return path


def _run_module(args, timeout):
    """python -m <args> from the repository; returns its stdout."""
    r = subprocess.run([sys.executable, "-m", *args], cwd=REPO,
                       capture_output=True, text=True, timeout=timeout)
    check(r.returncode == 0, f"{args[0]} failed:\n{r.stdout[-2000:]}\n"
                             f"{r.stderr[-3000:]}")
    return r.stdout


def compress_and_metrics(tr, root, seed, smi, timeout=900):
    """Phase 14's offline compression and metrics on phase 12's model."""
    from argparse import Namespace

    import torch

    from reduced3dgs_torch.config import ModelParams
    from reduced3dgs_torch.data.png import write_png
    from reduced3dgs_torch.render import PoolView, render_set
    from reduced3dgs_torch.scene import Scene, search_max_iteration

    src, model = os.path.join(root, "source"), os.path.join(root, "model")
    images = os.path.join(src, "images")
    os.makedirs(images, exist_ok=True)
    t0 = time.perf_counter()
    for cam in tr.cameras:
        write_png(os.path.join(images, f"{cam.image_name}.png"),
                  (np.clip(cam.image, 0, 1) * 255).astype(np.uint8))
    with open(os.path.join(model, "cfg_args"), "w") as f:
        f.write(str(Namespace(
            sh_degree=3, source_path=src, model_path=model, images="images",
            resolution=1, white_background=False, data_device="cuda",
            eval=False)))
    t_png = time.perf_counter() - t0
    tr._graphs.clear()  # the parent's graphs and caches give the card back
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    on = ["--device", tr.device.type]
    out = _run_module(["reduced3dgs_torch.compress", "-m", model,
                       *COMPRESS, *on], timeout)
    t_comp = time.perf_counter() - t0
    lines = [ln.strip() for ln in out.splitlines()
             if ln.startswith(("Pruned", "Fine-tuned", "Codebooks", "  "))]
    print(f"phase 14: {len(tr.cameras)} ground-truth PNGs written in "
          f"{t_png:.3f} s; python -m reduced3dgs_torch.compress "
          f"{' '.join(COMPRESS)} in {t_comp:.3f} s: " + "; ".join(lines)
          + f"; {smi}", flush=True)
    check(any(ln.startswith(f"Fine-tuned {COMPRESS[-1]} ") for ln in lines)
          and sum(ln.startswith("point_cloud") for ln in lines) == 4,
          "phase 14: compress printed no fine-tune or not four files")

    it = search_max_iteration(os.path.join(model, "point_cloud"))
    scene = Scene(ModelParams(source_path=src, model_path=model,
                              resolution=1),
                  load_iteration=it, shuffle=False, lazy_images=True)
    bg = torch.zeros(3, device=tr.device)
    t0 = time.perf_counter()
    for variant, kw in (("baseline", {}),
                        ("quantised_half", dict(quantised=True,
                                                half_float=True))):
        pool = scene.load_model(device=tr.device, **kw)
        render_set(PoolView(pool), tr.cameras, bg,
                   os.path.join(model, "train", variant, f"ours_{it}"))
    t_render = time.perf_counter() - t0
    weights = lpips_random_weights(os.path.join(root, "lpips_rand.npz"),
                                   seed)
    t0 = time.perf_counter()
    _run_module(["reduced3dgs_torch.metrics", "-m", model,
                 "--lpips_weights", weights, *on], timeout)
    t_metrics = time.perf_counter() - t0
    with open(os.path.join(model, "results.json")) as f:
        results = json.load(f)
    with open(os.path.join(model, "per_view.json")) as f:
        per_view = json.load(f)
    keys = {f"train_{v}/ours_{it}" for v in ("baseline", "quantised_half")}
    check(set(results) == keys and set(per_view) == keys
          and all(set(results[k]) == {"SSIM", "PSNR", "LPIPS"}
                  and all(math.isfinite(x) for x in results[k].values())
                  and len(per_view[k]["PSNR"]) == len(tr.cameras)
                  for k in keys), f"phase 14: results.json {results}")
    print(f"phase 14: {len(tr.cameras)} ring views of baseline and "
          f"quantised_half rendered into train/*/ours_{it} in "
          f"{t_render:.3f} s; python -m reduced3dgs_torch.metrics (random "
          f"LPIPS weights from --seed) in {t_metrics:.3f} s: "
          + "; ".join(f"{k}: PSNR {v['PSNR']:.4f} SSIM {v['SSIM']:.6f} "
                      f"LPIPS {v['LPIPS']:.6f}"
                      for k, v in sorted(results.items()))
          + f"; {smi}", flush=True)


# ---------------------------------------------------------------------------
# phase 15: the multi-device path
# ---------------------------------------------------------------------------

def strip_edge_cases(device, seed=0):
    """[(name, binning, (feat, ranges, limit), width, height, base)]:
    windows of tile rows binned on their own, at the tile base
    r0 * grid_x: on the 200x136 scene (9 tile rows) one whose last rows
    lie past the image height and one past the last tile row (no
    instances); then the last of the STRIPS strips of the main path's
    scene (MAIN at BENCH_BUDGET), which reaches past the height."""
    from reduced3dgs_torch.ops import preprocess as tprep

    cases = []
    for name, rows in (("tile rows 6..9, past the height", (6, 4)),
                       ("tile rows 9..10, no instances", (9, 2))):
        _, b, k2in = kernel_inputs(device, 200, 136, 20000, (0.01, 0.05),
                                   1 << 17, seed, tile_rows=rows)
        cases.append((name, b, k2in, 200, 136, rows[0] * 13))
    w, h = MAIN["width"], MAIN["height"]
    gx, gy = tprep.tile_grid(w, h)
    rows = -(-gy // STRIPS)
    r0 = rows * (STRIPS - 1)
    _, b, k2in = kernel_inputs(device, w, h, MAIN["n"], MAIN["scales"],
                               BENCH_BUDGET, seed, tile_rows=(r0, rows))
    cases.append((f"the main path's last strip, tile rows {r0}..{r0 + rows} "
                  f"of {w}x{h}", b, k2in, w, h, r0 * gx))
    return cases


def strip_kernel_checks(device, seed=0):
    """K2, K3 and K4 at a tile base on strip_edge_cases against their plain
    versions at the same base (the criteria of phases 3, 5, 7 and 10),
    two launches bit for bit, pixels past the image height exactly colour
    0 and T 1, slots outside the walked ranges exactly 0."""
    import torch

    from reduced3dgs_torch.ops import tile_render as ttr

    for name, b, (feat, ranges, limit), w, h, base in strip_edge_cases(
            device, seed):
        gx = -(-w // 16)
        got = ttr._tile_fwd_cuda(feat, ranges, limit, gx, w, h, base=base)
        again = ttr._tile_fwd_cuda(feat, ranges, limit, gx, w, h, base=base)
        want = ttr.tile_fwd_plain(feat, ranges, limit, gx, w, h, base=base)
        check(torch.equal(got, again), f"K2 {name}: two launches differ")
        err2, share2 = compare_k2(got, want)
        check(err2 <= 5e-3 and share2 >= 0.999,
              f"K2 {name}: kernel != plain ({err2:.3e}, {share2:.6f})")
        tiles = torch.arange(ranges.shape[1], device=device) + base
        py = (tiles // gx * 16)[:, None] + torch.arange(256,
                                                        device=device) // 16
        past = py >= h
        check(bool((got[:, 3][past] == 1).all())
              and bool((got[:, 0:3].permute(1, 0, 2)[:, past] == 0).all()),
              f"K2 {name}: a pixel past the height is not colour 0, T 1")
        g = k3_cotangent(got, seed)
        d = ttr._tile_bwd_cuda(feat, ranges, limit, gx, w, h, g, got,
                               base=base)
        d2 = ttr._tile_bwd_cuda(feat, ranges, limit, gx, w, h, g, got,
                                base=base)
        dw = ttr.tile_bwd_plain(feat, ranges, limit, gx, w, h, g, got,
                                base=base)
        check(torch.equal(d, d2), f"K3 {name}: two launches differ")
        walked = walked_slots(ranges, limit, feat.shape[1])
        check(bool((d[:, ~walked] == 0).all()),
              f"K3 {name}: a slot outside the walked ranges is not 0")
        rel3, share3 = ((compare_k3(d, dw)[1:]) if bool(walked.any())
                        else (float(d.abs().max()), 1.0))
        check(rel3 <= 5e-3 and share3 >= 0.999,
              f"K3 {name}: kernel != plain ({rel3:.3e}, {share3})")
        t4 = ttr._tile_trans_cuda(feat, ranges, limit, gx, w, h, base=base)
        t4b = ttr._tile_trans_cuda(feat, ranges, limit, gx, w, h, base=base)
        t4w = ttr.tile_trans_plain(feat, ranges, limit, gx, w, h, base=base)
        check(torch.equal(t4, t4b), f"K4 {name}: two launches differ")
        c = compare_k4(t4, t4w)
        check(c["err"] <= 1.01 and c["share"] >= 0.9999
              and c["flips"] <= max(1e-4 * t4.shape[1], 1)
              and c["max_flip"] <= 2, f"K4 {name}: kernel != plain ({c})")
        pg, pw = per_primitive(b, t4), per_primitive(b, t4w)
        p_ok = (pg[:, 0] - pw[:, 0]).abs() <= 1e-3 + 1e-3 * pw[:, 0].abs()
        p_touch = float((pg[:, 1] - pw[:, 1]).abs().max())
        p_share = float(p_ok.double().mean())
        check(p_share >= 0.9999 and p_touch <= 2,
              f"K4 {name}: per-primitive sums off ({p_share}, {p_touch})")
        print(f"phase 15: K2 / K3 / K4 at tile base {base}, {name} "
              f"(num_rendered {int(b.num_rendered)}, {int(walked.sum())} "
              f"walked slots, {int(past.sum())} pixels past the height): K2 "
              f"max abs err {err2:.3e}, K3 largest error / row max "
              f"{rel3:.3e}, K4 max abs err {c['err']:.3e}, counts differ on "
              f"{c['flips']} slots, per-primitive sums within 1e-3 on "
              f"{p_share:.6f}; two launches bit-identical each", flush=True)


def strips_against_full(dev, seed, smi):
    """Part 1: the ring at full width rendered as STRIPS strips of tile
    rows (their own binning, K1 / K2), stitched and held to the full
    frame; their backward (K3 / K6) under the full frame's cotangent
    summed and held to the full frame's gradients; on the first view the
    strips' transmittance statistics (K4 at a tile base) summed against
    the full frame's.  Returns the kernels' launches of the strips."""
    import torch

    from reduced3dgs_torch.ops import binning as tbin
    from reduced3dgs_torch.ops import preprocess as tprep
    from reduced3dgs_torch.ops import tile_render as ttr

    w, h = MAIN["width"], MAIN["height"]
    gx, gy = tprep.tile_grid(w, h)
    rows = -(-gy // STRIPS)
    arrs = [torch.as_tensor(a, device=dev)
            for a in bench_scene(MAIN["n"], MAIN["scales"], seed)]
    bg = torch.zeros(3, device=dev)
    kernels = {"expand": tbin.EXPAND, "tile_fwd": ttr.TILE_FWD,
               "tile_bwd": ttr.TILE_BWD,
               "seg_reduce_packed": ttr.SEG_REDUCE_PACKED,
               "tile_trans": ttr.TILE_TRANS}
    diff = ("means2d", "conic", "opacity", "color")
    worst_px, worst_g, strip_l = 0.0, 0.0, {n: 0 for n in kernels}
    gen = torch.Generator(dev).manual_seed(seed)
    t0 = time.perf_counter()
    for v, cam in enumerate(ring_cameras(w, h)):
        with torch.no_grad():
            prep = tprep.preprocess(arrs[0], arrs[2], arrs[3], arrs[4],
                                    arrs[1], arrs[5], cam.params(dev))
        leaves = {k: getattr(prep, k).detach().requires_grad_(True)
                  for k in diff}
        prep = prep._replace(**leaves)
        cot = torch.randn((rows * STRIPS * 16, w, 3), generator=gen,
                          device=dev)
        cot[h:] = 0.0
        full_b = tbin.bin_gaussians(prep, w, h, BENCH_BUDGET)
        check(int(full_b.num_rendered) <= BENCH_BUDGET,
              "strips: the budget truncates the full frame")
        color, t_fin, _, _ = ttr.tile_render(prep, full_b, bg, w, h,
                                             grad_reduce="bf16x2")
        g_full = torch.autograd.grad((color * cot[:h]).sum(),
                                     list(leaves.values()))
        before = {n: k.launches for n, k in kernels.items()}
        parts, sums = [], None
        for r0 in range(0, gy, rows):
            b = tbin.bin_gaussians(prep, w, h, BENCH_BUDGET,
                                   tile_rows=(r0, rows))
            c, t, _, _ = ttr.tile_render(prep, b, bg, w, h,
                                         tile_rows=(r0, rows),
                                         grad_reduce="bf16x2")
            g = torch.autograd.grad(
                (c * cot[r0 * 16:(r0 + rows) * 16]).sum(),
                list(leaves.values()))
            parts.append((c.detach(), t.detach()))
            sums = list(g) if sums is None else [
                a + x for a, x in zip(sums, g)]
            if v == 0:
                trans = ttr.transmittance_by_primitive(b, w, h,
                                                       base=r0 * gx)
                tsum = trans if r0 == 0 else (tsum[0] + trans[0],
                                              tsum[1] + trans[1])
        n_strips = len(parts)
        d = {n: k.launches - before[n] for n, k in kernels.items()}
        check(all(d[n] == n_strips for n in ("expand", "tile_fwd",
                                             "tile_bwd",
                                             "seg_reduce_packed")),
              f"strips: not one K1, K2, K3 and K6 per strip: {d}")
        for n in strip_l:
            strip_l[n] += d[n]
        img = torch.cat([p[0] for p in parts])
        tt = torch.cat([p[1] for p in parts])
        check(bool((tt[h:] == 1).all()) and bool((img[h:] == 0).all()),
              "strips: rows past the height are not background")
        dpx = max(float((img[:h] - color.detach()).abs().max()),
                  float((tt[:h] - t_fin.detach()).abs().max()))
        check(dpx <= 1e-6, f"strips: stitched frame off by {dpx:.3e}")
        worst_px = max(worst_px, dpx)
        for a, b_ in zip(g_full, sums):
            scale = float(a.abs().max())
            err = float(((b_ - a).abs() - 2e-3 * a.abs()).max()) / scale
            check(err <= 2e-4, f"strips: gradients off by {err:.3e} x max")
            worst_g = max(worst_g, err)
        if v == 0:
            full_t = ttr.transmittance_by_primitive(full_b, w, h)
            check(torch.equal(tsum[1], full_t[1]),
                  "strips: the pixels touched differ from the full frame")
            err_t = float(((tsum[0] - full_t[0]).abs()
                           - 1e-5 * full_t[0].abs()).max())
            check(err_t <= 1e-3, f"strips: transmittance off by {err_t}")
    stitched = ("bit for bit" if worst_px == 0
                else f"max abs diff {worst_px:.3e}")
    print(f"phase 15: {RING_VIEWS} views at {w}x{h} as {n_strips} strips "
          f"of {rows} tile rows (the last reaching {rows * n_strips * 16 - h}"
          f" pixel rows past the height): stitched against the full frame "
          f"{stitched}"
          f"; per-primitive gradients of the strips summed (bf16x2) against "
          f"the full frame's: largest excess over rtol 2e-3 {worst_g:.3e} x "
          f"max|g| (tolerance 2e-4); on view 1 the strips' transmittance "
          f"statistics (K4 at a tile base) add up to the full frame's "
          f"(touched equal); launches of the strips {strip_l} (one K1, K2, "
          f"K3 and K6 per strip); {time.perf_counter() - t0:.3f} s; {smi}",
          flush=True)
    return strip_l


@contextlib.contextmanager
def world_of_one(backend):
    """torch.distributed at world size 1 (a file:// rendezvous in a
    temporary directory) for the body: phase 15, phase 17's sharded
    step groups and phase 19 run inside it."""
    import tempfile

    import torch.distributed as dist

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def sharded_trainers(dev, seed, smi, backend="nccl"):
    """Part 2: torch.distributed at world size 1 under NCCL (world_of_one,
    open around phase 15 and phase 17's groups): ShardedTrainer on a
    (1, 1) mesh, replicated and param_shard, against the single-card
    Trainer from the same state, MULTI['steps'] plain bf16x2 iterations
    each, after raw_grad_check's one sharded_train_step per layout.
    Returns the kernels' launches of the sharded steps alone (the
    single-card references excluded)."""
    import torch
    import torch.distributed as dist

    from reduced3dgs_torch.ops import binning as tbin
    from reduced3dgs_torch.ops import tile_render as ttr
    from reduced3dgs_torch.parallel.sharded import (
        ShardedTrainer, gather_state, make_mesh,
    )

    kernels = {"expand": tbin.EXPAND, "tile_fwd": ttr.TILE_FWD,
               "tile_bwd": ttr.TILE_BWD,
               "seg_reduce_packed": ttr.SEG_REDUCE_PACKED}
    check(dist.is_initialized() and dist.get_world_size() == 1,
          "phase 15 runs inside a process group of one rank")
    mesh = make_mesh(1, 1)
    check(mesh.world is not None
          and dist.get_backend(mesh.tile) == backend,
          f"the (1, 1) mesh has no {backend} groups")
    raw = raw_grad_check(dev, seed, dict(MAIN, budget=BENCH_BUDGET),
                         mesh)
    check_raw_grads([raw], f"{backend} at world size 1, one "
                    "sharded_train_step", True)
    launches = {n: 0 for n in kernels}
    for shard in (False, True):
        for n, v in raw[shard]["launches"].items():
            launches[n] = launches.get(n, 0) + v
    cams, leaves = train_cameras(dev, seed)
    runs = {}
    for name, shard in (("single", None), ("replicated", False),
                        ("param_shard", True)):
        pool = student_pool(dev, leaves, seed)
        kw = ({} if shard is None else
              dict(cls=ShardedTrainer, mesh=mesh, param_shard=shard))
        tr = make_trainer(pool, cams, seed, **kw)
        before = {n: k.launches for n, k in kernels.items()}
        losses, ms = run_steps(tr, 1, MULTI["steps"])
        d = {n: k.launches - before[n] for n, k in kernels.items()}
        check(all(v >= MULTI["steps"] and v == d["expand"]
                  for v in d.values()),
              f"{name}: not one K1, K2, K3 and K6 per render: {d}")
        if shard is not None:
            for n in kernels:
                launches[n] += d[n]
        st = (gather_state(tr.state, mesh, shard) if shard else
              tr.state)
        runs[name] = (losses, ms, st, d)
        del tr
    l1, _, s1, _ = runs["single"]
    for name in ("replicated", "param_shard"):
        losses, ms, st, d = runs[name]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, l1))
        check(rel <= 1e-5, f"{name}: losses off by {rel:.3e}")
        worst, same = 0.0, True
        for leaf in ("xyz", "scaling", "opacity", "features_dc"):
            a = getattr(st.pool.params, leaf)
            b = getattr(s1.pool.params, leaf)
            ex = float(((a - b).abs() - 1e-4 * b.abs()).max())
            check(ex <= 5e-6, f"{name}: parameter {leaf} off by {ex:.3e}")
            worst = max(worst, ex)
            same = same and torch.equal(a, b)
        print(f"phase 15: {backend} at world size 1, ShardedTrainer "
              f"{name} on a (1, 1) mesh against the single-card "
              f"Trainer, {MULTI['steps']} bf16x2 steps at "
              f"{MAIN['width']}x{MAIN['height']}: losses off by at most "
              f"{rel:.3e} (rtol 1e-5), xyz / scaling / opacity / DC "
              f"at most {worst:.3e} past rtol 1e-4 (atol 5e-6)"
              f"{', bit for bit' if same else ''}; ms per "
              f"step {', '.join(f'{v:.1f}' for v in ms)} against "
              f"{', '.join(f'{v:.1f}' for v in runs['single'][1])} "
              f"single-card (host wall, synchronized; the first step "
              f"of each run warms up); launches {d}; {smi}", flush=True)
    return launches


def raw_grad_check(device, seed, scene, mesh):
    """One sharded_train_step (skip_update, the default f32 reduction) in
    each layout against the single-card step's raw gradients, leaf by
    leaf, on the first ring view of `scene` (with its "budget").  Returns
    {"loss": the single-card loss, False / True: {"loss", "worst" (the
    largest error over its tolerance 2e-6 + 1e-4 max|g|), "launches",
    "nr"}}."""
    import torch

    from reduced3dgs_torch.config import OptimizationParams
    from reduced3dgs_torch.ops import binning as tbin
    from reduced3dgs_torch.ops import tile_render as ttr
    from reduced3dgs_torch.parallel.sharded import (
        all_gather_rows, shard_state, sharded_train_step,
    )
    from reduced3dgs_torch.train import adam
    from reduced3dgs_torch.train.trainer import TrainState, train_step

    cams, leaves = train_cameras(device, seed, n_views=1, scene=scene)
    pool = student_pool(device, leaves, seed)
    state = TrainState(pool, adam.init(pool.params),
                       torch.Generator(device).manual_seed(seed))
    cp = cams[0].params(device)
    gt = torch.as_tensor(cams[0].image, device=device)
    bg = torch.zeros(3, device=device)
    kw = dict(width=scene["width"], height=scene["height"],
              budget=scene["budget"], opt_cfg=OptimizationParams(),
              spatial_lr_scale=1.0)
    _, m1, g1 = train_step(state, cp, gt, bg, 1, backend="tile",
                           skip_update=True, **kw)
    kernels = {"expand": tbin.EXPAND, "tile_fwd": ttr.TILE_FWD,
               "tile_bwd": ttr.TILE_BWD, "seg_reduce_f32": ttr.SEG_REDUCE_F32}
    out = {"loss": float(m1["loss"])}
    for shard in (False, True):
        before = {n: k.launches for n, k in kernels.items()}
        _, m, g = sharded_train_step(shard_state(state, mesh, shard), [cp],
                                     [gt], bg, 1, mesh=mesh,
                                     param_shard=shard, skip_update=True,
                                     **kw)
        launches = {n: k.launches - before[n] for n, k in kernels.items()}
        if shard:
            g = [all_gather_rows(x, mesh.tile) for x in g]
        worst = 0.0
        for a, b in zip(g1, g):
            tol = 2e-6 + 1e-4 * float(a.abs().max())
            worst = max(worst, float((a - b).abs().max()) / tol)
        out[shard] = dict(loss=float(m["loss"]), worst=worst,
                          launches=launches, nr=int(m["num_rendered_max"]))
    return out


def check_raw_grads(res, what, count_launches):
    """raw_grad_check's results of every rank held to their tolerances."""
    for shard in (False, True):
        for rank, r in enumerate(res):
            o = r[shard]
            check(abs(o["loss"] - r["loss"]) <= 1e-5 * abs(r["loss"]),
                  f"{what}: loss off on rank {rank}")
            check(o["worst"] <= 1.0, f"{what}, param_shard={shard}: "
                  f"gradients off ({o['worst']:.3f} x tolerance)")
            check(not count_launches
                  or all(v == 1 for v in o["launches"].values()),
                  f"{what}: not one K1, K2, K3, K5 per strip: "
                  f"{o['launches']}")
        print(f"phase 15: {what}, param_shard={shard}: raw gradients "
              f"(f32 reduction) against the single-card step's at most "
              f"{max(r[shard]['worst'] for r in res):.3f} x the tolerance "
              f"(atol 2e-6 + 1e-4 max|g| per leaf); loss "
              f"{res[0][shard]['loss']:.6f} (single "
              f"{res[0]['loss']:.6f}); largest strip demand "
              f"{res[0][shard]['nr']}; launches per rank "
              f"{res[0][shard]['launches']}", flush=True)


def two_rank_child(rank, world, device, seed, scene):
    """Part 3, one rank of a (1, 2) mesh on the one card, gloo: whether
    gloo carries CUDA tensors for the collectives the step uses; then
    raw_grad_check."""
    import torch
    import torch.distributed as dist

    from reduced3dgs_torch.parallel.sharded import make_mesh

    mesh = make_mesh(1, 2)
    group = group_under_gloo(device, mesh)
    probe = torch.arange(4, dtype=torch.float32, device=device)
    try:
        dist.all_reduce(probe.clone())
        dist.all_reduce(probe.to(torch.int32), op=dist.ReduceOp.MAX)
        dist.all_gather([torch.empty_like(probe) for _ in range(world)],
                        probe)
        dist.broadcast(probe.clone(), 0)
    except RuntimeError as e:
        return {"refused": str(e).strip().splitlines()[0], "group": group}
    return dict(raw_grad_check(device, seed, scene, mesh), group=group)


def group_under_gloo(device, mesh):
    """ShardedTrainer.step_group of two iterations on a small scene on the
    ranks' mesh under gloo (for phase 17): on the card it must raise,
    since gloo's collectives cannot be captured in a CUDA graph; on the
    CPU it runs its loop.  Returns ("raised", the message's first line)
    or ("ran", the losses)."""
    from reduced3dgs_torch.models.gaussians import (
        padded_leaves, pool_from_numpy,
    )
    from reduced3dgs_torch.parallel.sharded import ShardedTrainer

    cams = ring_cameras(64, 48, n_views=2)
    for c in cams:
        c.image = np.zeros((48, 64, 3), np.float32)
    pool = pool_from_numpy(padded_leaves(make_arrays(256, MAIN["scales"], 0),
                                         capacity=256), device)
    tr = make_trainer(pool, cams, 0, cls=ShardedTrainer, mesh=mesh,
                      param_shard=True)
    try:
        ms = tr.step_group([1, 2])
    except RuntimeError as e:
        return "raised", str(e).strip().splitlines()[0]
    return "ran", [float(m["loss"]) for m in ms]


def two_ranks_on_one_card(seed, smi, device="cuda"):
    """Part 3: mesh (1, 2) as two processes on the one card over gloo (NCCL
    refuses two ranks on one device), if gloo carries CUDA tensors."""
    from reduced3dgs_torch.parallel.launch import spawn_local

    t0 = time.perf_counter()
    res = spawn_local(two_rank_child, 2, "gloo", device, seed,
                      dict(MAIN, budget=BENCH_BUDGET))
    groups = [r["group"] for r in res]
    refused = [r["refused"] for r in res if "refused" in r]
    if refused:
        print(f"phase 15: the two-rank (1, 2) run on one card is left out: "
              f"gloo refused CUDA tensors ({refused[0]}); "
              f"tests/test_torch_parallel.py runs such ranks on the CPU",
              flush=True)
        return groups
    check_raw_grads(res, "mesh (1, 2), two gloo ranks on the one card",
                    device == "cuda")
    print(f"phase 15: two-rank run {time.perf_counter() - t0:.3f} s "
          f"(both processes' start included); {smi}", flush=True)
    return groups


def scaling_line(smi):
    """Part 4: python -m reduced3dgs_torch.parallel.launch --scaling at
    world size 1 (its own width and primitive defaults)."""
    t0 = time.perf_counter()
    out = _run_module(["reduced3dgs_torch.parallel.launch", "--scaling",
                       *SCALING_ARGS], timeout=300)
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    check(len(lines) == 1 and json.loads(lines[0])["pixels_per_s"] > 0,
          f"scaling_bench printed {lines}")
    print(f"phase 15: scaling_bench {lines[0]} "
          f"({time.perf_counter() - t0:.3f} s with the process start); "
          f"{smi}", flush=True)


def knn_subset_check(dev, seed, smi):
    """Part 5: the certified blocked 30-NN search against knn_exact on the
    first MULTI['knn_points'] points of the bench scene: the same
    neighbour sets (a near tie at the 30th may swap, then the distances
    agree), distances within rtol 1e-5 / atol 2e-6."""
    import torch

    from reduced3dgs_torch.ops import knn as tknn

    pts = torch.as_tensor(make_arrays(MAIN["n"], MAIN["scales"], seed)[
        "xyz"][:MULTI["knn_points"]], device=dev)
    k = 30

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with blocked_rungs() as rungs:
        (d2, idx), t_b = timed(lambda: tknn.knn(pts, k))
    method, m_cert = search_of(rungs)
    check(method == "blocked", f"kNN subset: {method}, rungs "
          f"{[m for m, _ in rungs]}")
    (d2e, idxe), t_e = timed(lambda: tknn.knn_exact(pts, k))
    same = (torch.sort(idx, 1).values == torch.sort(idxe, 1).values).all(1)
    direct = ((pts[idx] - pts[:, None, :]) ** 2).sum(-1)
    ex = float(((d2 - d2e).abs() - 1e-5 * d2e.abs()).max())
    ex2 = float(((torch.sort(direct, 1).values - d2e).abs()
                 - 1e-5 * d2e.abs()).max())
    check(ex <= 2e-6 and ex2 <= 2e-6,
          f"kNN subset: distances off ({ex:.3e}, {ex2:.3e})")
    check(float(same.double().mean()) >= 0.999,
          f"kNN subset: {int((~same).sum())} neighbour sets differ")
    print(f"phase 15: 30-NN of {pts.shape[0]} points of the scene: blocked "
          f"search {t_b:.3f} s (certified at m = {m_cert}, rung "
          f"{len(rungs)}) against knn_exact {t_e:.3f} s; neighbour sets "
          f"equal on {int(same.sum())} of {same.numel()} points (the rest "
          f"swap a near tie: their distances agree), distances at most "
          f"{ex:.3e} past rtol 1e-5 (atol 2e-6); {smi}", flush=True)


def multi_device_path(dev, seed, smi, backend="nccl", device="cuda"):
    """Phase 15, inside world_of_one(backend).  The kernels' counts are
    zeroed after the checks against the plain versions; the launches of
    the path are those of the strips and of the sharded steps in this
    process, each read around its own run (the full frames and
    single-card steps they are held to are not counted); every kernel
    must have run.  Returns those counts and the two gloo ranks'
    step_group outcomes (group_under_gloo), which phase 17 reads."""
    from reduced3dgs_torch.ops import binning as tbin
    from reduced3dgs_torch.ops import tile_render as ttr

    t0 = time.perf_counter()
    strip_kernel_checks(dev, seed)
    path = {"expand": tbin.EXPAND, "tile_fwd": ttr.TILE_FWD,
            "tile_bwd": ttr.TILE_BWD, "tile_trans": ttr.TILE_TRANS,
            "seg_reduce_f32": ttr.SEG_REDUCE_F32,
            "seg_reduce_packed": ttr.SEG_REDUCE_PACKED}
    for k in path.values():
        k.launches = 0
    strip_l = strips_against_full(dev, seed, smi)
    shard_l = sharded_trainers(dev, seed, smi, backend)
    launches = {n: strip_l.get(n, 0) + shard_l.get(n, 0) for n in path}
    check(all(v > 0 for v in launches.values()),
          f"the multi-device path bypassed a kernel: {launches}")
    print(f"phase 15: launches of the multi-device path in this process "
          f"(the strips {strip_l} and the sharded steps {shard_l}; the "
          f"references they are held to not counted) {launches}",
          flush=True)
    groups = two_ranks_on_one_card(seed, smi, device)
    scaling_line(smi)
    knn_subset_check(dev, seed, smi)
    print(f"phase 15: {time.perf_counter() - t0:.3f} s", flush=True)
    return launches, groups


# ---------------------------------------------------------------------------
# phase 16: the graphed ring and bench step, the viewer bridge, the
# evaluation CLIs
# ---------------------------------------------------------------------------

def bench_line(device, config):
    """python -m reduced3dgs_torch.bench --configs <tag> as a subprocess;
    returns its JSON line."""
    out = _run_module(["reduced3dgs_torch.bench", "--configs", config[-1],
                       "--device", device], timeout=900)
    lines = [json.loads(ln) for ln in out.splitlines()
             if ln.startswith("{")]
    check(len(lines) == 1, f"phase 16: bench printed {out!r}")
    return lines[0]


def ring_graph_checks(scene, dev, smi):
    """The FPS ring of phase 12's model through measure_fps, for baseline
    and quantised_half, dense and variable-SH: every view of one graph
    replay bit for bit the eager render_once image; FPS graphed and eager
    in turns; the launches per replay, capture_s and the device idle
    share of one profiled replay.  Returns ({variant: graphed FPS of the
    dense path}, the baseline's settled budget)."""
    import torch

    from reduced3dgs_torch.graphs import Looped, time_replays
    from reduced3dgs_torch.render import (
        MODELS_CONFIG, PoolView, fps_ring, measure_fps, render_once,
    )

    views = scene.get_train_cameras()
    bg = torch.zeros(3, device=dev)
    fps, budgets = {}, {}
    for variant in ("baseline", "quantised_half"):
        conf = MODELS_CONFIG[variant]
        pool = scene.load_model(quantised=conf["quantised"],
                                half_float=conf["half_float"], device=dev)
        for variable_sh in (False, True):
            what = f"{variant}{', variable-SH' if variable_sh else ''}"
            pv = PoolView(pool, variable_sh=variable_sh)
            res = measure_fps(pv, views, bg)
            budget, reps = res["budget"], res["reps"]
            cps = [c.params(dev) for c in views]
            graph = fps_ring(pv, cps, bg, budget)
            eager = Looped(lambda: [render_once(pv, cp, bg, budget)
                                    for cp in cps])
            graph.replay()
            for cp, g in zip(cps, graph.out):
                e = render_once(pv, cp, bg, budget)
                check(torch.equal(g.color, e.color)
                      and torch.equal(g.final_t, e.final_t)
                      and int(g.num_rendered) == int(e.num_rendered),
                      f"phase 16: {what}: a graphed view differs from "
                      "its eager render")
            turns = {"graphed": [], "eager": []}
            for r in range(3):
                order = (graph, eager) if r % 2 == 0 else (eager, graph)
                for run in order:
                    sec = time_replays(run, reps, dev)
                    turns["graphed" if run is graph else "eager"].append(
                        res["frames"] / sec)
            counts, busy, span, _, host = profiled(graph.replay)
            print(f"phase 16: {what}: measure_fps {res['fps']:.3f} FPS over "
                  f"{res['frames']} frames ({len(views)} views x {reps} "
                  f"replays, budget {budget}, capture {res['capture_s']:.3f}"
                  f" s, launches per replay {res['launches']}); "
                  f"{len(views)} graphed views bit for bit the eager "
                  "images; FPS in turns "
                  + "; ".join(f"{k} {', '.join(f'{v:.3f}' for v in t)}"
                              for k, t in turns.items())
                  + f"; one profiled replay: kernels by name {counts}, "
                  f"{busy:.3f} ms of kernel time over a CUDA-event span of "
                  f"{span:.3f} ms ({busy / len(views):.3f} ms per frame), "
                  f"device idle {(1 - busy / span) * 100:.1f} %, host "
                  f"launch calls {host}; {smi}", flush=True)
            want = {"expand": len(views), "tile_fwd": len(views)}
            check(all(res["launches"][k] == v for k, v in want.items()),
                  f"phase 16: {what}: not one K1 and K2 per frame: "
                  f"{res['launches']}")
            if not variable_sh:
                fps[variant] = res["fps"]
                budgets[variant] = budget
            del graph, eager
    return fps, budgets["baseline"]


def bench_checks(dev, smi):
    """bench.py's 1080p configuration through the port's bench CLI, then
    its step in this process: num_rendered of an eager step equals the
    line's, and one replayed step's gradients equal the eager step's bit
    for bit."""
    import torch

    from reduced3dgs_torch import bench

    cfg = BENCH_CONFIG
    t0 = time.perf_counter()
    line = bench_line(dev.type, cfg)
    t_cli = time.perf_counter() - t0
    width, height, n, (smin, smax), budget, tag = cfg
    fb = bench.FwdBwd(width, height, n, smin, smax, budget, dev)
    loss, nr, grads = fb.step()
    run = fb.runner()
    run.replay()
    g_loss, g_nr, g_grads = run.out
    same = (torch.equal(loss, g_loss) and int(nr) == int(g_nr)
            and all(torch.equal(a, b) for a, b in zip(grads, g_grads)))
    print(f"phase 16: python -m reduced3dgs_torch.bench --configs {tag} in "
          f"{t_cli:.3f} s: {json.dumps(line)}; eager num_rendered "
          f"{int(nr)}; one replayed step's loss and five gradients "
          f"{'bit for bit' if same else 'DIFFER from'} the eager step's "
          f"(launches per replay {run.launches}, capture "
          f"{run.capture_s:.3f} s); {smi}", flush=True)
    check(line["metric"] == f"raster_fwd_bwd_{tag}" and line["value"] > 0
          and line["num_rendered"] == int(nr),
          f"phase 16: the bench line {line} against num_rendered {int(nr)}")
    check(same, "phase 16: the replayed bench step differs from the eager")


def viewer_frame_check(scene, src, dev, budget, smi):
    """One loopback frame of ring view 0 through NetworkGUI on the card:
    its bytes equal render_view's image quantised the same way."""
    import socket
    import struct
    import threading
    from types import SimpleNamespace

    import torch

    from reduced3dgs_torch.network_gui import NetworkGUI
    from reduced3dgs_torch.render import PoolView, render_view

    pool = scene.load_model(device=dev)
    cam = scene.get_train_cameras()[0]
    bg = torch.zeros(3, device=dev)
    trainer = SimpleNamespace(state=SimpleNamespace(pool=pool),
                              opt_cfg=SimpleNamespace(iterations=100),
                              initial_budget=budget, device=dev)
    gui = NetworkGUI("127.0.0.1", 0, src, trainer,
                     SimpleNamespace(backend="tile"), bg)
    check(gui.enabled, "phase 16: the viewer bridge did not bind")
    view = cam.world_view_transform.copy()
    view[:, 1:3] *= -1
    proj = cam.full_proj_transform.copy()
    proj[:, 1] *= -1
    msg = json.dumps({
        "resolution_x": cam.width, "resolution_y": cam.height,
        "train": True, "keep_alive": False, "scaling_modifier": 1.0,
        "fov_x": cam.fov_x, "fov_y": cam.fov_y, "z_near": 0.01,
        "z_far": 100.0, "view_matrix": view.ravel().tolist(),
        "view_projection_matrix": proj.ravel().tolist()}).encode()
    nbytes = cam.width * cam.height * 3
    t0 = time.perf_counter()
    with socket.create_connection(gui.listener.getsockname()) as client:
        client.sendall(struct.pack("<I", len(msg)) + msg)
        reply = []

        def receive():  # the frame does not fit the socket's buffers
            buf = b""
            while len(buf) < nbytes + 4:
                buf += client.recv(1 << 20)
            vlen = struct.unpack("<I", buf[nbytes:nbytes + 4])[0]
            while len(buf) < nbytes + 4 + vlen:
                buf += client.recv(1 << 20)
            reply.append(buf)

        th = threading.Thread(target=receive)
        th.start()
        gui.poll(1)
        th.join(timeout=60)
        check(not th.is_alive() and reply, "phase 16: no viewer reply")
    dt = time.perf_counter() - t0
    gui.close()
    frame, verify = reply[0][:nbytes], reply[0][nbytes + 4:].decode()
    out, _ = render_view(PoolView(pool), cam, bg, budget)
    want = (torch.clamp(out.color, 0, 1).cpu().numpy() * 255).astype(
        np.uint8).tobytes()
    print(f"phase 16: one {cam.width}x{cam.height} viewer frame through "
          f"NetworkGUI (loopback, budget {budget}) in {dt:.3f} s: "
          f"{'bytes equal' if frame == want else 'bytes DIFFER from'} "
          f"render_view's image, verify string {verify!r}; {smi}",
          flush=True)
    check(frame == want and verify == src,
          "phase 16: the viewer frame differs from render_view's")


def serving_tools_path(dev, root, smi):
    """Phase 16 on phase 12's model directory (root/model, its COLMAP
    text in root/source): the graphed FPS ring, the bench, one viewer
    frame, full_eval --dry_run and generate_results."""
    from reduced3dgs_torch.config import ModelParams
    from reduced3dgs_torch.generate_results import VARIANT_FILES
    from reduced3dgs_torch.scene import Scene, search_max_iteration

    t0 = time.perf_counter()
    src, model = os.path.join(root, "source"), os.path.join(root, "model")
    it = search_max_iteration(os.path.join(model, "point_cloud"))
    scene = Scene(ModelParams(source_path=src, model_path=model,
                              resolution=1),
                  load_iteration=it, shuffle=False, lazy_images=True)
    fps, budget = ring_graph_checks(scene, dev, smi)
    with open(os.path.join(model, "fps_results.json"), "w") as f:
        json.dump(fps, f, indent=2)
    bench_checks(dev, smi)
    viewer_frame_check(scene, src, dev, budget, smi)

    out = _run_module(["reduced3dgs_torch.full_eval", "--dry_run",
                       "--custom_scene", src, "--iterations", "30",
                       "--device", dev.type], timeout=120)
    cmds = out.strip().splitlines()
    check(len(cmds) == 3 and all(
        f"-m reduced3dgs_torch.{m} " in c and c.endswith(
            f"--device {dev.type}")
        for m, c in zip(("train", "render", "metrics"), cmds)),
        f"phase 16: full_eval --dry_run printed {cmds}")
    _run_module(["reduced3dgs_torch.generate_results", "-m", model,
                 "--iteration", str(it)], timeout=120)
    stored = [f for _, f in VARIANT_FILES if os.path.exists(
        os.path.join(model, "point_cloud", f"iteration_{it}", f))]
    with open(os.path.join(root, "summary.csv")) as f:
        rows = f.read().strip().splitlines()
    check(len(rows) == 1 + len(stored) and rows[0].endswith(",fps"),
          f"phase 16: summary.csv {rows} for {stored}")
    print(f"phase 16: full_eval --dry_run --custom_scene on phase 12's "
          f"scene: {len(cmds)} commands ({'; '.join(cmds)}); "
          f"generate_results on its model: summary.csv header "
          f"{rows[0]}, {len(rows) - 1} rows", flush=True)
    print(f"phase 16: {time.perf_counter() - t0:.3f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 17: sharded step groups, the graphed scaling harness, the
# profiling tools
# ---------------------------------------------------------------------------

def _state_leaves(tr):
    from reduced3dgs_torch.train.trainer import carried

    pool = tr.state.pool
    return carried(tr.state) + (pool.degrees, pool.alive)


def _same_run(a, b):
    """Two runs (metrics, state leaves, budgets) equal bit for bit."""
    import torch

    return (all(sorted(x) == sorted(y)
                and all(float(x[k]) == float(y[k]) for k in x)
                for x, y in zip(a[0], b[0])) and len(a[0]) == len(b[0])
            and all(torch.equal(x, y) for x, y in zip(a[1], b[1])))


@contextlib.contextmanager
def launches_into(acc, all_kernels=False):
    """Adds each kernel's launches in the body (graphs.kernel_counters:
    K1, K2, K3, K5, K6; with all_kernels K4 too) to acc[name]."""
    from reduced3dgs_torch.graphs import all_kernel_counters, kernel_counters

    kernels = all_kernel_counters() if all_kernels else kernel_counters()
    before = {n: k.launches for n, k in kernels.items()}
    try:
        yield acc
    finally:
        for n, k in kernels.items():
            acc[n] = acc.get(n, 0) + k.launches - before[n]


def sharded_group_checks(tr, what, smi, acc, single=None):
    """ShardedTrainer.step_group on `tr` (no host boundary in the
    iterations it runs): a group of SHARDED['group'] from one state
    against as many ShardedTrainer.step calls, every metric and leaf bit
    for bit; the same from budgets small enough to overflow (the group
    re-runs); graphed and eager ms per step in turns, and with `single`
    (a single-card Trainer on the same pool) its graphed step_group in
    the same turns.  The groups' launches (warm-ups and captures) are
    added to acc, the eager steps' are not."""
    import torch

    g, rounds = SHARDED["group"], SHARDED["rounds"]
    last = 1 + g + 2 * rounds * g
    check(all(tr.fusible(i) for i in range(1, last)),
          f"phase 17: {what}: the schedule has a host boundary")
    tr.budgets = {c.uid: BENCH_BUDGET for c in tr.cameras}
    snap = trainer_snapshot(tr)

    def run(fn, budgets=None):
        trainer_restore(tr, snap)
        if budgets is not None:
            tr.budgets = dict(budgets)
        ms = fn()
        torch.cuda.synchronize()
        return ms, _state_leaves(tr), dict(tr.budgets)

    eager = run(lambda: run_steps_eager(tr, 1, g))
    before, captures = dict(tr.graph_launches), tr.graph_captures
    with launches_into(acc):
        grouped = run(lambda: tr.step_group(range(1, g + 1)))
    per_replay = {n: (tr.graph_launches[n] - before[n]) // g for n in before}
    same = _same_run(eager, grouped) and eager[2] == grouped[2]
    losses = ", ".join(f"{float(m['loss']):.6f}" for m in grouped[0])
    print(f"phase 17: {what}: a group of {g} replayed from one graph "
          f"({tr.graph_captures - captures} capture, "
          f"{tr.capture_s:.3f} s with its warm-up) against {g} "
          f"ShardedTrainer.step calls from the same state: "
          f"{'every metric and leaf bit for bit' if same else 'DIFFERENT'}"
          f"; losses {losses}"
          f"; launches per replayed step {per_replay}; {smi}", flush=True)
    check(same, f"phase 17: {what}: the group differs from the steps")
    want = ({"expand": 1, "tile_fwd": 1, "tile_bwd": 1,
             "seg_reduce_packed": 1, "seg_reduce_f32": 0}
            if tr.device.type == "cuda" else {n: 0 for n in per_replay})
    check(per_replay == want, f"phase 17: {what}: not one K1, K2, K3 and "
          f"K6 per replayed step: {per_replay}")

    small = {c.uid: SHARDED["overflow_budget"] for c in tr.cameras}
    captures = tr.graph_captures
    e_over = run(lambda: run_steps_eager(tr, 1, g), small)
    with launches_into(acc):
        g_over = run(lambda: tr.step_group(range(1, g + 1)), small)
    loss = max(abs(float(a["loss"]) - float(b["loss"]))
               / abs(float(a["loss"])) for a, b in zip(e_over[0], g_over[0]))
    close = all(bool(torch.allclose(b, a, rtol=5e-4, atol=1e-3))
                for a, b in zip(e_over[1], g_over[1]))
    print(f"phase 17: {what}: from budgets of {SHARDED['overflow_budget']}:"
          f" the group re-ran ({tr.graph_captures - captures} captures, "
          f"budgets {sorted(set(g_over[2].values()))}; the steps' "
          f"{sorted(set(e_over[2].values()))}); against the steps "
          f"{'bit for bit' if _same_run(e_over, g_over) else 'not bit for bit'}"
          f", loss {loss:.3e} (rtol 1e-5)", flush=True)
    check(loss <= 1e-5 and close
          and max(g_over[2].values()) > SHARDED["overflow_budget"],
          f"phase 17: {what}: the overflowing group differs")

    first, s_first = g + 1, 1
    times = {"eager": [], "graphed": []}
    if single is not None:
        times["single-card graphed"] = []
        single.budgets = {c.uid: BENCH_BUDGET for c in single.cameras}
        with launches_into(acc):  # its capture, before the turns
            single.step_group(range(s_first, s_first + g))
        s_first += g
    for r in range(rounds):
        order = list(times) if r % 2 == 0 else list(times)[::-1]
        for who in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if who == "eager":
                run_steps_eager(tr, first, g)
            elif who == "graphed":
                with launches_into(acc):
                    tr.step_group(range(first, first + g))
            else:
                with launches_into(acc):
                    single.step_group(range(s_first, s_first + g))
                s_first += g
            torch.cuda.synchronize()
            times[who].append((time.perf_counter() - t0) * 1e3 / g)
            if who != "single-card graphed":
                first += g
    print(f"phase 17: {what}: ms per step (host wall, synchronized, groups "
          f"of {g}, in turns): "
          + "; ".join(f"{w} {', '.join(f'{v:.3f}' for v in t)} (median "
                      f"{float(np.median(t)):.3f})" for w, t in times.items())
          + f"; {smi}", flush=True)


def sharded_group_path(dev, seed, smi, gloo_groups):
    """Phase 17, part 1, inside world_of_one just after phase 15:
    ShardedTrainer.step_group at world size 1 in that group (NCCL on the
    card, its collectives captured), replicated and param_shard, at the
    1080p training geometry (phase 9's scene and student, no
    densification); then phase 15's two gloo ranks' step_group outcomes
    (gloo_groups), which must have raised on the card.  The kernels'
    counts are zeroed first; returns the launches of the groups alone
    (the eager steps they are held to not counted)."""
    import dataclasses

    import torch.distributed as dist

    from reduced3dgs_torch.graphs import kernel_counters
    from reduced3dgs_torch.parallel.sharded import (
        ShardedTrainer, make_mesh,
    )

    t0 = time.perf_counter()
    for k in kernel_counters().values():
        k.launches = 0
    acc = {}
    mesh = make_mesh(1, 1)
    backend = dist.get_backend(mesh.world)
    cams, leaves = train_cameras(dev, seed)
    for shard in (False, True):
        tr = make_trainer(student_pool(dev, leaves, seed), cams, seed,
                          cls=ShardedTrainer, mesh=mesh, param_shard=shard)
        tr.opt_cfg = dataclasses.replace(tr.opt_cfg, densify_until_iter=0)
        single = None
        if not shard:  # the single-card graphed step on the same pool
            single = make_trainer(student_pool(dev, leaves, seed), cams,
                                  seed)
            single.opt_cfg = tr.opt_cfg
        sharded_group_checks(
            tr, f"{backend} at world size 1, "
            f"{'param_shard' if shard else 'replicated'}, bf16x2, "
            f"{MAIN['width']}x{MAIN['height']}", smi, acc, single)
        del tr, single
    want = "raised" if dev.type == "cuda" else "ran"
    print(f"phase 17: ShardedTrainer.step_group on phase 15's two gloo "
          f"ranks ({dev.type}): {gloo_groups}", flush=True)
    check(all(o == want for o, _ in gloo_groups)
          and (want == "ran" or all("gloo" in m for _, m in gloo_groups)),
          f"phase 17: step_group under gloo: {gloo_groups}")
    print(f"phase 17: part 1 {time.perf_counter() - t0:.3f} s", flush=True)
    return acc


def scaling_pair(dev, smi, acc):
    """parallel/launch.py:scaling_bench on the (1, 1) mesh, its step
    replayed as a CUDA graph (its launches added to acc), beside an eager
    run of the same steps (the same loss after the window)."""
    from reduced3dgs_torch.parallel.launch import scaling_bench

    lines = {}
    for eager in (False, True):
        out = []
        with launches_into({} if eager else acc):
            scaling_bench(widths=(SCALING["width"],),
                          n_prims=SCALING["prims"], iters=SCALING["iters"],
                          mesh_shapes=[(1, 1)], device=dev,
                          printer=out.append, eager=eager)
        lines["eager" if eager else "graphed"] = json.loads(out[0])
    g, e = lines["graphed"], lines["eager"]
    print(f"phase 17: scaling_bench graphed {json.dumps(g)}; eager "
          f"{json.dumps(e)}; {smi}", flush=True)
    check(g["loss"] == e["loss"] and g["pixels_per_s"] > 0,
          "phase 17: the graphed scaling step differs from the eager")


def tool_lines(name, fn):
    """fn() with its standard output printed under `name`, line by
    line."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    for line in buf.getvalue().splitlines():
        if line.strip():
            print(f"phase 17: {name}: {line}", flush=True)


def sharded_tools_path(dev, smi, acc):
    """Phase 17, part 2, after phase 16, outside any process group: the
    graphed scaling harness, profile_components and profile_trace (their
    launches added to acc, part 1's counts), then the two
    microbenchmarks as subprocesses.  K1, K2, K3, K5 and K6 must have
    been launched on the path (a graph's kernels count where it is warmed
    up and captured; replays are counted per graph)."""
    from reduced3dgs_torch import profile_components, profile_trace

    t0 = time.perf_counter()
    scaling_pair(dev, smi, acc)
    sizes = [str(v) for v in TOOLS]
    with launches_into(acc):
        tool_lines("profile_components", lambda: profile_components.main(
            sizes + ["--device", dev.type]))
        tool_lines("profile_trace", lambda: profile_trace.run(
            *TOOLS, TRACE["iters"], *TRACE["scales"], dev, top=TRACE["top"],
            grad_reduce="bf16x2"))
    check(all(v > 0 for v in acc.values()),
          f"phase 17: the path bypassed a kernel: {acc}")
    print(f"phase 17: launches of the path (the groups' and the graphed "
          f"scaling step's warm-ups and captures, the tools' stages; the "
          f"eager steps they are held to not counted) {acc}", flush=True)
    for mod, extra in MICRO_ARGS.items():
        out = _run_module([f"reduced3dgs_torch.{mod}", "--device",
                           dev.type, *extra], timeout=300)
        for line in out.splitlines():
            print(f"phase 17: {mod}: {line}", flush=True)
    print(f"phase 17: part 2 {time.perf_counter() - t0:.3f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 19: the surgery on row shards (parallel/sharded.py:ShardRows)
# ---------------------------------------------------------------------------

class RingScene:
    """The part of Scene the mercy pass reads: the training cameras."""

    def __init__(self, cams):
        self.cams, self.pool = cams, None

    def get_train_cameras(self, scale=1.0):
        return self.cams

    def calculate_redundancy_metric(self, **kw):
        from reduced3dgs_torch.scene import Scene

        return Scene.calculate_redundancy_metric(self, **kw)


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_start(dev):
    """Reset the card's peak memory statistic; the bytes allocated now
    (None off the card)."""
    import torch

    if dev.type != "cuda":
        return None
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def peak_since(dev, held):
    """torch.cuda.max_memory_allocated since peak_start less `held` (None
    off the card)."""
    import torch

    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) - held


def surgery_cfg():
    """make_trainer's configuration (phase 9's densify threshold and
    percent_dense) with mercy on and the paper's cull thresholds."""
    import dataclasses

    from reduced3dgs_torch.config import OptimizationParams

    return dataclasses.replace(
        OptimizationParams(), percent_dense=TRAIN["percent_dense"],
        densify_grad_threshold=TRAIN["grad_threshold"], mercy_points=True,
        mercy_interval=1, std_threshold=0.04, cdist_threshold=6.0)


def surgery_state(dev, leaves, seed):
    """Phase 9's student (every slot alive) as a whole TrainState with the
    densification statistics, Adam moments and pending gradients a
    training holds, drawn from `seed`: SURGERY['grad_share'] of the rows
    above the densify threshold, screen radii across the size prune.
    Returns (state without a generator, pending gradients)."""
    import torch

    from reduced3dgs_torch.models.gaussians import GaussianParams
    from reduced3dgs_torch.train import adam
    from reduced3dgs_torch.train.trainer import TrainState

    pool = student_pool(dev, leaves, seed)
    cap = pool.capacity
    g = torch.Generator(device=dev).manual_seed(seed + 19)

    def normal(x, scale):
        return torch.randn(x.shape, generator=g, device=dev) * scale

    denom = torch.randint(1, 9, (cap,), generator=g,
                          device=dev).to(torch.float32)
    avg = torch.rand(cap, generator=g, device=dev) * (
        TRAIN["grad_threshold"] / (1.0 - SURGERY["grad_share"]))
    pool = pool.replace(xyz_grad_accum=avg * denom, denom=denom,
                        max_radii2d=torch.rand(cap, generator=g,
                                               device=dev) * 24.0)
    opt = adam.init(pool.params)._replace(
        mu=GaussianParams(*(normal(p, 1e-3) for p in pool.params)),
        nu=GaussianParams(*(normal(p, 1e-3).abs() for p in pool.params)),
        step=GaussianParams(*([10] * 6)))
    pending = GaussianParams(*(normal(p, 1e-3) for p in pool.params))
    return TrainState(pool, opt, None), pending


def _whole(state, pending, mesh, rows):
    """A row-shard result as the whole state (gather_state), and its
    pending gradients gathered; `rows` None: already whole."""
    from reduced3dgs_torch.models.gaussians import GaussianParams
    from reduced3dgs_torch.parallel.sharded import (
        all_gather_rows, gather_state,
    )

    if rows is None:
        return state, pending
    if pending is not None:
        pending = GaussianParams(*(all_gather_rows(p, mesh.tile)
                                   for p in pending))
    return gather_state(state, mesh), pending


def same_result(a, b):
    """Two whole (state, pending, stats) results equal bit for bit: every
    carried leaf, degrees, alive, pending gradients, statistics and the
    generator's next draw."""
    import torch

    from reduced3dgs_torch.train.trainer import carried

    (sa, pa, ka), (sb, pb, kb) = a, b
    leaves = [carried(s) + (s.pool.degrees, s.pool.alive) for s in (sa, sb)]
    same = all(torch.equal(x, y) for x, y in zip(*leaves))
    same &= (pa is None) == (pb is None)
    if pa is not None and pb is not None:
        same &= all(torch.equal(x, y) for x, y in zip(pa, pb))
    same &= sorted(ka) == sorted(kb) and all(
        float(ka[k]) == float(kb[k]) for k in ka)
    draws = [torch.rand(4, generator=s.generator, device=s.pool.device)
             for s in (sa, sb)]
    return same and torch.equal(*draws)


def surgery_events(dev, seed, mesh, cams, leaves, acc, budget):
    """Phase 19, part 1, on this rank: each surgery event on the rank's
    row shard (ShardRows of `mesh`, its collectives logged) against the
    single-card event on the same whole state with the same generator,
    each run twice in turns and timed (host wall, synchronized, with the
    peak bytes above those held): growth to 2^20 slots, then on
    the grown state densify (store_grads), opacity reset, dead prune, the
    redundancy metric and mercy of every type; densify on the full pool
    (every new row dropped); the SH cull over the views and one view's
    per-primitive transmittance; every render at instance budget
    `budget`.  The sharded runs' launches (every kernel, K4 too) are
    added to acc, the references' are not.  Returns
    (rows (event, sharded [(s, peak)] x 2, single [(s, peak)] x 2, bit
    for bit, stats), the collectives' log, the cull's comparison)."""
    import torch

    from reduced3dgs_torch.models.gaussians import round_capacity
    from reduced3dgs_torch.ops.sh_culling import (
        cull_sh_bands, render_transmittance,
    )
    from reduced3dgs_torch.parallel.sharded import (
        ShardRows, all_gather_rows, all_reduce, gather_state, shard_state,
    )
    from reduced3dgs_torch.train import trainer as T
    from reduced3dgs_torch.train.densify import MERCY_TYPES, WholeRows

    # the groups' communicators exist before the timed events
    all_reduce(torch.zeros((), device=dev), mesh.tile)
    log = []
    rows, whole = ShardRows(mesh, log), WholeRows()
    cfg = surgery_cfg()
    extent = 1.1 * RING_RADIUS
    scene = RingScene(cams)
    base, base_pending = surgery_state(dev, leaves, seed)
    out = []

    def timed(fn, *a):
        """fn(*a), its seconds and (on the card) its peak bytes above
        those held before it."""
        sync(dev)
        held = peak_start(dev)
        t0 = time.perf_counter()
        res = fn(*a)
        sync(dev)
        return res, (time.perf_counter() - t0, peak_since(dev, held))

    def fresh(state, pending, r):
        """A copy of the whole state (its rows with a ShardRows) with a
        new generator from the seed."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = state._replace(generator=gen)
        if r is whole:
            return state, pending
        return shard_state(state, mesh), type(pending)(*(
            r.mine(p) for p in pending))

    def turns(fn, inputs=lambda r: ()):
        """fn(*inputs(r), r) for the shard and for the whole state in
        turns (sharded, single, single, sharded: the allocator's cache
        warm for the second of each), the inputs made before the clock
        starts; returns ({rows: first result}, {rows: [(s, peak)] x
        2})."""
        res, times = {}, {rows: [], whole: []}
        for r in (rows, whole, whole, rows):
            a = inputs(r)
            with launches_into(acc if r is rows else {}, all_kernels=True):
                got, t = timed(fn, *a, r)
            res.setdefault(r, got)
            times[r].append(t)
            del a
        return res, times

    def pair(name, fn, state, pending):
        """fn(state, pending, rows) -> (state, pending, stats) on the
        shard and on the whole state; returns the single-card result."""
        res, times = turns(fn, lambda r: fresh(state, pending, r))
        sh, one = res[rows], res[whole]
        got = _whole(sh[0], sh[1], mesh, rows) + (sh[2],)
        same = same_result(got, one)
        out.append((name, times[rows], times[whole], same,
                    {k: float(v) for k, v in one[2].items()}))
        return one

    def grow(st, pend, r):
        pool, opt, pend = r.grow(st.pool, st.opt, pend,
                                 round_capacity(2 * r.capacity(st.pool)))
        return st._replace(pool=pool, opt=opt), pend, {}

    def densify(st, pend, r):
        st, stats, pend = T.densify_step(
            st, extent, pend, opt_cfg=cfg, use_size_threshold=True,
            with_grads=True, rows=r)
        return st, pend, stats

    grown, grown_pending, _ = pair("growth to 2^20 slots" if
                                   base.pool.capacity == 1 << 19
                                   else "growth", grow, base, base_pending)
    pair("densify (store_grads) on the grown pool", densify, grown,
         grown_pending)
    pair("densify on the full pool (no free slot)", densify, base,
         base_pending)
    pair("opacity reset", lambda st, pend, r: (
        T.opacity_reset_step(st), pend, {}), grown, grown_pending)

    def prune_dead(st, pend, r):
        st, n = T.prune_dead_step(st, extent, r)
        return st, pend, {"n_points_pruned": n}

    pair("dead prune", prune_dead, grown, grown_pending)

    # the redundancy metric once per layout (it does not depend on the
    # mercy type); each type's mercy on its counts
    counts, times = turns(
        lambda st, r: T.mercy_counts(st, scene, pixel_scale=cfg.box_size,
                                     rows=r),
        lambda r: fresh(grown, grown_pending, r)[:1])
    same = torch.equal(counts[rows], counts[whole])
    out.append(("redundancy metric (mercy's kNN and counts)", times[rows],
                times[whole], same,
                {"rows_counted": float((counts[whole] > 0).sum())}))
    for kind in MERCY_TYPES:
        def mercy(st, pend, r, kind=kind):
            st, stats = T.mercy_step(
                st, counts[r], lambda_mercy=cfg.lambda_mercy,
                mercy_minimum=cfg.mercy_minimum, mercy_type=kind, rows=r)
            return st, pend, stats

        pair(f"mercy {kind}", mercy, grown, grown_pending)

    # the cull on the full pool over the views
    kw = dict(threshold=cfg.cdist_threshold * math.sqrt(3) / 255.0,
              std_threshold=cfg.std_threshold, budget=budget,
              backend="tile", max_sh_degree=3, active_sh_degree=3)
    sharded = shard_state(base, mesh)
    shard = sharded.pool
    res, times = turns(lambda r: cull_sh_bands(
        shard, cams, transmittance=r.transmittance, **kw) if r is rows
        else cull_sh_bands(base.pool, cams, **kw))
    culled, ref = res[rows], res[whole]
    got = gather_state(sharded._replace(pool=culled), mesh).pool
    deg = torch.equal(got.degrees, ref.degrees)
    kept = (got.degrees == ref.degrees) & (ref.degrees > 0)
    demoted = (got.degrees == ref.degrees) & (ref.degrees == 0)
    rest_same = torch.equal(got.params.features_rest[kept | demoted],
                            ref.params.features_rest[kept | demoted])
    dc_kept = torch.equal(got.params.features_dc[kept],
                          ref.params.features_dc[kept])
    dc_err = float((got.params.features_dc[demoted]
                    - ref.params.features_dc[demoted]).abs().max()) \
        if bool(demoted.any()) else 0.0
    cp = cams[0].params(dev)
    feats = shard.features()
    with launches_into(acc, all_kernels=True):
        radii, t_sum, touched = (
            all_gather_rows(x, mesh.tile) for x in rows.transmittance(
                shard, feats, cp, budget=budget, backend="tile"))
    w_radii, w_sum, w_touched = render_transmittance(
        base.pool, base.pool.features(), cp, budget=budget,
        backend="tile")
    t_err = float(((t_sum - w_sum).abs() - 1e-3 * w_sum.abs()).max())
    cull = dict(seconds=(times[rows], times[whole]), degrees=deg,
                rest=rest_same,
                dc_kept=dc_kept, dc_demoted_err=dc_err, t_err=t_err,
                t_abs=float((t_sum - w_sum).abs().max()),
                touched=torch.equal(touched, w_touched),
                radii=torch.equal(radii, w_radii),
                histogram=degree_histogram(ref), views=len(cams))
    return out, log, cull


def surgery_iterations(dev, seed, mesh, cams, leaves, acc, budget):
    """Phase 19, part 2: a param_shard ShardedTrainer on `mesh` (its
    launches added to acc) and the single-card Trainer, each from phase
    9's student (every view's budget `budget`), through iteration 1
    (plain), 2 (densify with
    store_grads, the pool grown to twice its slots first, and a mercy
    pass) and 3 (the SH cull over the views) at the training geometry.
    Per iteration: seconds (host wall, synchronized) and, on the card,
    torch.cuda.max_memory_allocated over it less the bytes held before
    it, those bytes, and the peaks of its step and of its surgery apart.
    Returns ({who: ([(s, peak, before, step peak, surgery peak)],
    losses)}, whether the two runs end on the same alive rows, degrees,
    statistics and events, the events, the rows this rank holds at the
    end)."""
    import dataclasses

    import torch

    from reduced3dgs_torch.parallel.sharded import (
        ShardedTrainer, gather_state,
    )

    cfg = dataclasses.replace(surgery_cfg(), densify_from_iter=1,
                              densification_interval=2, store_grads=True)
    runs, ends = {}, {}
    for who in ("sharded", "single"):
        kw = (dict(cls=ShardedTrainer, mesh=mesh, param_shard=True)
              if who == "sharded" else {})
        tr = make_trainer(student_pool(dev, leaves, seed), cams, seed,
                          scene=RingScene(cams), cull_sh_iterations=(3,),
                          **kw)
        tr.opt_cfg = cfg
        tr.budgets = {c.uid: budget for c in cams}
        rec, losses = [], []
        held, split = [], []  # bytes held at the start; the two peaks
        surgery = tr._surgery

        def measured(*a, surgery=surgery, held=held, split=split):
            step_peak = peak_since(dev, held[-1])
            peak_start(dev)
            surgery(*a)
            split.append((step_peak, peak_since(dev, held[-1])))

        tr._surgery = measured
        for it in (1, 2, 3):
            sync(dev)
            split.clear()
            held.append(peak_start(dev))
            t0 = time.perf_counter()
            with launches_into(acc if who == "sharded" else {},
                               all_kernels=True):
                m = tr.step(it)
                sync(dev)
            dt = time.perf_counter() - t0
            parts = split[0] if split else (peak_since(dev, held[-1]),
                                            None)
            whole = None if parts[0] is None else max(
                p for p in parts if p is not None)
            rec.append((dt, whole, held[-1]) + parts)
            losses.append(float(m["loss"]))
        st = gather_state(tr.state, mesh) if who == "sharded" else tr.state
        ends[who] = (st.pool.alive, st.pool.degrees, dict(tr.stats),
                     dict(tr.events), tr.state.pool.capacity)
        runs[who] = (rec, losses)
        del tr
    a, b = ends["sharded"], ends["single"]
    same = (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and a[2] == b[2] and a[3] == b[3])
    return runs, same, a[3], a[4]


def surgery_rank(rank, world, device, seed, scene, budget):
    """Phase 19 on one rank of a (1, 2) mesh of gloo processes on the one
    card: whether gloo carries the collectives the surgery runs on this
    device's tensors, then parts 1 and 2 on its own ring views of `scene`
    (MAIN's keys) and student.  Returns what surgery_report prints and
    the launches."""
    import torch
    import torch.distributed as dist

    from reduced3dgs_torch.parallel.sharded import make_mesh

    mesh = make_mesh(1, world)
    probe = torch.arange(4, dtype=torch.int32, device=device)
    try:
        dist.all_reduce(probe.to(torch.int64), group=mesh.tile)
        dist.all_gather([torch.empty_like(probe) for _ in range(world)],
                        probe, group=mesh.tile)
        dist.broadcast(probe.to(torch.uint8), 0, group=mesh.tile)
    except RuntimeError as e:
        return {"refused": str(e).strip().splitlines()[0]}
    cams, leaves = train_cameras(device, seed, scene=scene)
    acc = {}
    events = surgery_events(device, seed, mesh, cams, leaves, acc, budget)
    iterations = surgery_iterations(device, seed, mesh, cams, leaves, acc,
                                    budget)
    return {"events": events, "iterations": iterations, "launches": acc}


def timing_text(runs):
    """[(seconds, peak bytes or None)] of the runs in turns as text."""
    text = " / ".join(f"{s:.4f}" for s, _ in runs) + " s"
    if runs[0][1] is None:
        return text
    return text + " (peak +" + " / +".join(str(p) for _, p in runs) + " B)"


def surgery_report(res, what, smi):
    """Phase 19's lines for one rank's results, and its checks."""
    (rows, log, cull), (runs, same_end, events, held) = (res["events"],
                                                        res["iterations"])
    for name, sh, one, same, stats in rows:
        print(f"phase 19: {what}: {name}: sharded {timing_text(sh)}, "
              f"single-card {timing_text(one)}, "
              f"{'bit for bit' if same else 'DIFFERENT'}; {stats}; {smi}",
              flush=True)
        check(same, f"phase 19: {what}: {name}: the sharded event differs "
              f"from the single-card one")
    print(f"phase 19: {what}: SH cull over {cull['views']} views: sharded "
          f"{timing_text(cull['seconds'][0])}, single-card "
          f"{timing_text(cull['seconds'][1])}; degrees "
          f"{'equal' if cull['degrees'] else 'DIFFERENT'} "
          f"({cull['histogram']}), features_rest "
          f"{'equal' if cull['rest'] else 'DIFFERENT'} where they are, "
          f"features_dc of kept rows {'equal' if cull['dc_kept'] else 'DIFFERENT'}"
          f", of demoted rows at most {cull['dc_demoted_err']:.3e} apart; one "
          f"view's transmittance sums at most {cull['t_abs']:.3e} apart, "
          f"{cull['t_err']:.3e} past rtol 1e-3 (atol 1e-3), touched "
          f"{'equal' if cull['touched'] else 'DIFFERENT'}, radii "
          f"{'equal' if cull['radii'] else 'DIFFERENT'}; {smi}", flush=True)
    check(cull["degrees"] and cull["rest"] and cull["dc_kept"]
          and cull["dc_demoted_err"] <= SURGERY["dc_atol"]
          and cull["t_err"] <= 1e-3 and cull["touched"] and cull["radii"],
          f"phase 19: {what}: the sharded cull differs")
    moves = [e for e in log if e["move"]]
    rest = [e for e in log if not e["move"]]
    per_row = max(e["bytes"] / e["capacity"] for e in rest)
    move_row = max((e["bytes"] / e["capacity"] for e in moves), default=0)
    ops = sorted({e["op"] for e in log})
    print(f"phase 19: {what}: {len(log)} collectives in the events ({ops}):"
          f" the largest {per_row:.2f} B per capacity row (moves aside; "
          f"limit {MAX_SURGERY_BYTES_PER_ROW}), the largest move "
          f"{move_row:.2f} B per capacity row", flush=True)
    check(per_row <= MAX_SURGERY_BYTES_PER_ROW,
          f"phase 19: {what}: a collective carries {per_row} B a row")
    for who, (rec, losses) in runs.items():
        text = "; ".join(
            f"iteration {i}: {s:.4f} s" + (
                "" if peak is None else
                f", peak {peak} B over {before} B held (the step "
                f"{step}, the surgery {'none' if cut is None else cut})")
            for i, (s, peak, before, step, cut) in enumerate(rec, 1))
        print(f"phase 19: {what}: {who} trainer, iterations 1 (plain), 2 "
              f"(growth, densify, mercy), 3 (cull): {text}; losses "
              f"{', '.join(f'{v:.6f}' for v in losses)}; {smi}", flush=True)
    print(f"phase 19: {what}: this rank holds {held} rows at the end (725 B "
          f"x {held} = {725 * held} B of state); events {events}; the "
          f"sharded and single-card runs end on "
          f"{'the same' if same_end else 'DIFFERENT'} alive rows, degrees "
          f"and statistics", flush=True)
    check(same_end, f"phase 19: {what}: the trainers end apart")
    losses = [r[1] for r in runs.values()]
    rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    check(rel <= 1e-5, f"phase 19: {what}: losses off by {rel:.3e}")


def sharded_surgery_path(dev, seed, smi):
    """Phase 19, inside world_of_one just after phase 17's part 1: the
    surgery on row shards at the 1080p training geometry on phase 9's
    student, on the (1, 1) mesh of this process group (NCCL on the card)
    and on a (1, 2) mesh of two gloo processes on the one card (or the
    reason gloo refused).  The kernels' counts are zeroed first; returns
    the path's launches (the sharded events' and trainers' in this
    process and the gloo ranks', the single-card references not
    counted)."""
    import torch.distributed as dist

    from reduced3dgs_torch.graphs import all_kernel_counters
    from reduced3dgs_torch.parallel.launch import spawn_local
    from reduced3dgs_torch.parallel.sharded import make_mesh

    t0 = time.perf_counter()
    for k in all_kernel_counters().values():
        k.launches = 0
    mesh = make_mesh(1, 1)
    backend = dist.get_backend(mesh.world)
    cams, leaves = train_cameras(dev, seed)
    acc, budget = {}, SURGERY["budget"]
    events = surgery_events(dev, seed, mesh, cams, leaves, acc, budget)
    iterations = surgery_iterations(dev, seed, mesh, cams, leaves, acc,
                                    budget)
    surgery_report({"events": events, "iterations": iterations},
                   f"{backend} at world size 1", smi)
    del events, iterations
    own = dict(acc)
    t1 = time.perf_counter()
    res = spawn_local(surgery_rank, 2, "gloo", dev.type, seed, dict(MAIN),
                      budget)
    refused = [r["refused"] for r in res if "refused" in r]
    if refused:
        print(f"phase 19: the two-rank (1, 2) run on one card is left out: "
              f"gloo refused ({refused[0]}); "
              f"tests/test_torch_sharded_surgery.py runs such ranks on the "
              f"CPU", flush=True)
    else:
        for rank, r in enumerate(res):
            surgery_report(r, f"mesh (1, 2), gloo rank {rank}", smi)
            for n, v in r["launches"].items():
                acc[n] = acc.get(n, 0) + v
        print(f"phase 19: two-rank run {time.perf_counter() - t1:.3f} s "
              f"(both processes' start included)", flush=True)
    want = ("expand", "tile_fwd", "tile_bwd", "tile_trans",
            "seg_reduce_packed")
    check(all(acc.get(n, 0) > 0 for n in want),
          f"phase 19: the path bypassed a kernel: {acc}")
    print(f"phase 19: launches of the path (this process {own}, with the "
          f"gloo ranks' {acc}; the single-card references not counted)",
          flush=True)
    print(f"phase 19: {time.perf_counter() - t0:.3f} s", flush=True)
    return acc


# ---------------------------------------------------------------------------
# phase 18: the paper's evaluation, its entry points end to end
# ---------------------------------------------------------------------------

def write_colmap_binary(root, cams, xyz, rgb, seed):
    """images.bin (the cameras' poses, 2-D points of random counts) and
    points3D.bin (xyz, colours, random errors and tracks) under root, as
    tests/test_colmap_io.py writes them; returns what was written."""
    import struct

    rng = np.random.default_rng(seed)
    images = [(c.uid + 1, _rotmat2qvec(np.asarray(c.R).T),
               np.asarray(c.T, np.float64), 1, f"r_{c.uid}.png",
               int(rng.integers(0, 50))) for c in cams]
    err = rng.uniform(0, 2, len(xyz))
    tracks = rng.integers(0, 9, len(xyz))
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for iid, qvec, tvec, cam_id, name, npts in images:
            f.write(struct.pack("<i4d3di", iid, *qvec, *tvec, cam_id))
            f.write(name.encode() + b"\x00" + struct.pack("<Q", npts))
            f.write(b"\x00" * (24 * npts))
    with open(os.path.join(root, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<Q3d3BdQ", i + 1, *xyz[i], *rgb[i], err[i],
                                tracks[i]))
            f.write(b"\x00" * (8 * int(tracks[i])))
    return images, err


def native_reader_check(root, seed):
    """The port's native COLMAP reader (native/colmap_io.cpp built into
    reduced3dgs_torch/_build/) against its Python path on a binary model
    of the phase's cameras and world: ids, names and poses exactly, xyz
    as float32 (the native path's type), colours and errors exactly."""
    from reduced3dgs_torch import compression_eval as ce
    from reduced3dgs_torch.data import colmap

    lib = colmap.native_lib()
    check(lib is not None, "phase 18: the native COLMAP reader did not "
                           "build or load")
    world = ce.make_world(np.random.default_rng(seed))
    xyz = world[0].astype(np.float64)
    rgb = np.clip(world[1][:, 0] * ce.SH_C0 + 0.5, 0, 1) * 255
    cams = ce.scene_cameras(0.0, 28, 384, math.radians(60))
    images, err = write_colmap_binary(root, cams, xyz,
                                      rgb.astype(np.uint8), seed)
    imgs_bin = os.path.join(root, "images.bin")
    pts_bin = os.path.join(root, "points3D.bin")

    def read_twice():  # the second read timed: both find the files cached
        for _ in range(2):
            t0 = time.perf_counter()
            got = (colmap.read_images_binary(imgs_bin),
                   colmap.read_points3d_binary(pts_bin))
        return got, time.perf_counter() - t0

    (got_i, got_p), native_s = read_twice()
    saved, colmap._NATIVE = colmap._NATIVE, None
    try:
        (ref_i, ref_p), python_s = read_twice()
    finally:
        colmap._NATIVE = saved
    check(sorted(got_i) == sorted(ref_i) == [im[0] for im in images],
          "phase 18: native images.bin ids differ")
    for iid, a in got_i.items():
        b = ref_i[iid]
        check((a.camera_id, a.name) == (b.camera_id, b.name)
              and np.array_equal(a.qvec, b.qvec)
              and np.array_equal(a.tvec, b.tvec),
              f"phase 18: native images.bin differs at image {iid}")
    check(np.array_equal(got_p[0], ref_p[0].astype(np.float32)
                         .astype(np.float64))
          and np.array_equal(got_p[1], ref_p[1])
          and np.array_equal(got_p[2], ref_p[2])
          and np.array_equal(ref_p[0], xyz) and np.array_equal(ref_p[2], err),
          "phase 18: native points3D.bin differs from the Python reader")
    lib_name = colmap.native_library_path().name
    print(f"phase 18: native COLMAP reader ({lib_name}) against the "
          f"Python reader: {len(got_i)} images and "
          f"{len(got_p[0]):,} points equal (xyz as float32) in "
          f"{native_s:.3f} s against {python_s:.3f} s", flush=True)


@contextlib.contextmanager
def launch_log(path):
    """R3DGS_LAUNCH_LOG names `path` in the body: every training and render
    CLI started as a subprocess appends its kernels' launches there."""
    from reduced3dgs_torch.graphs import LAUNCH_LOG

    old = os.environ.get(LAUNCH_LOG)
    os.environ[LAUNCH_LOG] = path
    try:
        yield
    finally:
        if old is None:
            del os.environ[LAUNCH_LOG]
        else:
            os.environ[LAUNCH_LOG] = old


def logged_launches(path):
    """Each kernel's launches summed over the processes of a launch log,
    and the processes by what they ran."""
    from reduced3dgs_torch.graphs import all_kernel_counters

    total = dict.fromkeys(all_kernel_counters(), 0)
    runs = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                runs[rec["what"]] = runs.get(rec["what"], 0) + 1
                for n, v in rec["launches"].items():
                    total[n] += v
    return total, runs


def untrained_psnr(data, device):
    """Mean test-view PSNR of the pool training starts from (the scene's
    points3d.ply through create_from_pcd), scored as evaluate scores."""
    from reduced3dgs_torch import compression_eval as ce
    from reduced3dgs_torch.config import ModelParams
    from reduced3dgs_torch.scene import Scene

    scene = Scene(ModelParams(source_path=data, eval=True),
                  load_iteration=None, shuffle=False, device=device)
    return ce.mean_psnr(scene.pool, scene.get_test_cameras(), device)


def eval_path(dev, root, seed, smi, cfg=None, keep=False):
    """Phase 18: python -m reduced3dgs_torch.compression_eval (the world at
    EVAL's size, both configurations trained as training CLI subprocesses
    with --fused_steps 16 at EVAL's shortened depth, the four variants
    scored) and python -m reduced3dgs_torch.fps_table (render CLI
    subprocesses) on `root`, then the native COLMAP reader.  Returns each
    kernel's launches on the path: this process's (the ground truth and
    the scoring renders) and its subprocesses' (their launch log).  keep:
    leave `root` in place."""
    from reduced3dgs_torch import compression_eval as ce
    from reduced3dgs_torch import fps_table
    from reduced3dgs_torch.graphs import all_kernel_counters

    cfg = EVAL if cfg is None else cfg
    t0 = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    log = os.path.join(root, "launches.jsonl")
    kernels = all_kernel_counters()
    before = {n: k.launches for n, k in kernels.items()}
    with launch_log(log):
        record = ce.main([
            "--root", root, "--iterations", str(cfg["iterations"]),
            "--size", str(cfg["size"]), "--n_train", str(cfg["n_train"]),
            "--n_test", str(cfg["n_test"]), "--seed", str(seed),
            "--device", dev.type])
        t_fps = time.perf_counter()
        rows = fps_table.main(["--root", root, "--device", dev.type])
        fps_s = time.perf_counter() - t_fps
    logged, procs = logged_launches(log)
    launches = {n: k.launches - before[n] + logged[n]
                for n, k in kernels.items()}
    floor = untrained_psnr(os.path.join(root, "scene"), dev)

    res, runs = record["results"], record["runs"]
    check(procs == {"train": 2, "render": len(fps_table.RUNS)},
          f"phase 18: subprocesses {procs}")
    for name, run in runs.items():
        ev = run["events"]
        # on the card the groups are replayed graphs (a loop on the CPU)
        check(run["grouped_steps"] > 0 and (dev.type != "cuda" or (
            run["graph_captures"] > 0
            and sum(run["graph_launches"].values()) > 0)),
              f"phase 18: {name}: no step group ran ({run})")
        check(ev["densify"] > 0 and run["tests_run"] > 0
              and len(run["bytes"]) == 4,
              f"phase 18: {name}: the schedule missed a densify, a test "
              f"iteration or the final compression ({run})")
        print(f"phase 18: training {name}: {run['wall_s']:.1f} s wall "
              f"(the loop {run['train_s']:.1f} s, codebooks "
              f"{run['fit_s']:.1f} s); {run['grouped_steps']} of "
              f"{run['iterations']} iterations in step groups, "
              f"{run['graph_captures']} graphs captured in "
              f"{run['capture_s']:.1f} s, launches in their replays "
              f"{run['graph_launches']}; surgeries {ev}", flush=True)
    ev = runs["full"]["events"]
    check(ev["mercy"] > 0 and ev["cull"] == 1,
          f"phase 18: full: the schedule missed a mercy pass or the cull "
          f"({ev})")
    for name, models in res.items():
        for tag, r in models.items():
            check(math.isfinite(r["psnr"]) and r["psnr"] > floor,
                  f"phase 18: {name}/{tag} PSNR {r['psnr']} not above the "
                  f"untrained pool's {floor:.3f} dB")
    van, fqh = res["vanilla"]["baseline"], res["full"]["quantised_half"]
    check(fqh["bytes"] < van["bytes"],
          "phase 18: full/quantised_half is not smaller than vanilla")
    check(len(rows) == 6 and all(v > 0 and math.isfinite(v)
                                 for v in rows.values()),
          f"phase 18: FPS rows {rows}")
    print(f"phase 18: {cfg['size']}x{cfg['size']}, {cfg['n_train']} / "
          f"{cfg['n_test']} views, {cfg['iterations']} iterations: "
          f"full/quantised_half {van['bytes'] / fqh['bytes']:.2f}x smaller "
          f"than vanilla at {fqh['psnr'] - van['psnr']:+.3f} dB (untrained "
          f"pool {floor:.3f} dB); stages {record['stages']}, FPS "
          f"{fps_s:.1f} s; {smi}", flush=True)
    print(f"phase 18: full/baseline features_rest exactly 0: "
          f"{record['sparsity']['rest_zero']:.4f} (in the kept bands "
          f"{record['sparsity']['rest_zero_kept']}), SH degrees 0-3 "
          f"{record['sparsity']['degrees']}", flush=True)
    native_reader_check(os.path.join(root, "colmap_bin"), seed)
    check(all(launches[n] > 0 for n in ("expand", "tile_fwd", "tile_bwd",
                                        "tile_trans", "seg_reduce_packed")),
          f"phase 18: the path bypassed a kernel: {launches}")
    print(f"phase 18: launches of the path (this process and its "
          f"{sum(procs.values())} subprocesses; replays not counted) "
          f"{launches}; {time.perf_counter() - t0:.3f} s", flush=True)
    if not keep:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def quality_path(dev, root, iterations, smi, cfg=None):
    """Phase 20: python -m reduced3dgs_torch.half_float_ablation,
    prune_finetune and grad_reduce_ab as subprocesses on phase 18's
    models in `root` (trained to `iterations`; QUALITY's fraction, fine-
    tune and A/B lengths, or `cfg`'s), each logging its launches
    (R3DGS_LAUNCH_LOG).  Checks the eight ablation rows (f16_all not above
    f32_all by more than F16_MARGIN_DB), the pruned pack file smaller than
    phase 18's full/quantised_pack, every one-step relative L2 of part 1
    below MAX_GRAD_REL_L2, and that K1, K2, K3, K5 and K6 launched.
    Returns each kernel's launches over the three processes."""
    from reduced3dgs_torch import compression_eval as ce

    cfg = QUALITY if cfg is None else cfg
    t0 = time.perf_counter()
    log = os.path.join(root, "launches20.jsonl")
    runs = {
        "half_float_ablation": ["--iterations", str(iterations)],
        "prune_finetune": ["--fracs", *cfg["fracs"], "--ft_iters",
                           str(cfg["ft_iters"]), "--iterations",
                           str(iterations)],
        "grad_reduce_ab": [str(cfg["ab_iters"]), "--arms",
                           *cfg["ab_arms"]]}
    secs = {}
    with launch_log(log):
        for name, args in runs.items():
            t = time.perf_counter()
            r = subprocess.run(
                ce.module_command(f"reduced3dgs_torch.{name}") + args
                + ["--root", root, "--device", dev.type], cwd=REPO,
                capture_output=True, text=True, timeout=900)
            check(r.returncode == 0, f"phase 20: {name} failed:\n"
                  f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
            secs[name] = time.perf_counter() - t
    record = {}
    for name in runs:
        with open(os.path.join(root, f"{name}.json")) as f:
            record[name] = json.load(f)
    with open(os.path.join(root, "results.json")) as f:
        pack = json.load(f)["results"]["full"]["quantised_pack"]

    rows = record["half_float_ablation"]["psnr"]
    for k, v in rows.items():
        print(f"phase 20: half_float_ablation {k}: {v:.3f} dB (delta "
              f"{v - rows['f32_all']:+.3f})", flush=True)
    check(len(rows) == 8 and all(math.isfinite(v) for v in rows.values()),
          f"phase 20: ablation rows {rows}")
    check(rows["f16_all"] - rows["f32_all"] <= F16_MARGIN_DB,
          f"phase 20: f16_all beats f32_all by more than {F16_MARGIN_DB} dB")
    pf = record["prune_finetune"]
    for frac in cfg["fracs"]:
        r = pf[f"frac_{float(frac)}"]
        print(f"phase 20: prune_finetune {frac}: {pf['base']['n']} -> "
              f"{r['n']} primitives, PSNR {pf['base']['psnr']:.3f} -> "
              f"fine-tuned {r['ft_psnr']:.3f} -> pack {r['pack_psnr']:.3f} "
              f"dB, {r['bytes']} bytes against phase 18's quantised_pack "
              f"{pack['bytes']} ({pack['psnr']:.3f} dB); fine-tune "
              f"{r['finetune_s']:.2f} s ({cfg['ft_iters']} iterations), "
              f"codebooks {r['fit_s']:.2f} s", flush=True)
        check(math.isfinite(r["pack_psnr"]) and r["bytes"] < pack["bytes"],
              f"phase 20: the pruned pack file is not smaller ({r})")
    ab = record["grad_reduce_ab"]
    errs = ab["one_step_grad_rel_l2"]
    print(f"phase 20: grad_reduce_ab part 1, relative L2 of bf16x2 against "
          f"f32 per leaf: {errs}; part 2, {ab['iters']} iterations: held-"
          f"out PSNR {ab['test_psnr']}, delta "
          f"{ab.get('psnr_delta_db', float('nan')):+.3f} dB", flush=True)
    check(all(v < MAX_GRAD_REL_L2 for v in errs.values()),
          f"phase 20: a one-step relative L2 is {MAX_GRAD_REL_L2} or more")
    check(all(math.isfinite(v) for v in ab["test_psnr"].values()),
          f"phase 20: A/B PSNR {ab['test_psnr']}")
    launches, procs = logged_launches(log)
    check(procs == dict.fromkeys(runs, 1), f"phase 20: processes {procs}")
    check(all(launches[n] > 0 for n in ("expand", "tile_fwd", "tile_bwd",
                                        "seg_reduce_f32",
                                        "seg_reduce_packed")),
          f"phase 20: the path bypassed a kernel: {launches}")
    took = ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
    print(f"phase 20: seconds {took}; launches of the path (its "
          f"{len(runs)} processes; replays not counted) {launches}; "
          f"{time.perf_counter() - t0:.3f} s; {smi}", flush=True)
    return launches


def timing_path(dev, root, smi, args=None):
    """Phase 21: python -m reduced3dgs_torch.multicam_step and the four
    microbenchmarks as subprocesses with TIMING_ARGS (or `args`), each
    logging its launches (R3DGS_LAUNCH_LOG) into `root`; their lines
    printed.  Checks that multicam_step's graphed steps equalled its eager
    ones bit for bit with K1, K2, K3 and K6 once per view per replayed
    step, that the port_current rows of microbench_sort and
    microbench_reduce launched K5 once per replay, that every port_current
    row's K5 output agrees with the plain version and the float64 sums at
    the row's own sizes (k5_row_check), and that K1, K2, K3, K5 and K6
    launched.  Returns each kernel's launches over the five processes."""
    import ast

    from reduced3dgs_torch import compression_eval as ce

    args = TIMING_ARGS if args is None else args
    t0 = time.perf_counter()
    log = os.path.join(root, "launches21.jsonl")
    outs, secs = {}, {}
    with launch_log(log):
        for name, extra in args.items():
            t = time.perf_counter()
            r = subprocess.run(
                ce.module_command(f"reduced3dgs_torch.{name}")
                + [*extra, "--device", dev.type], cwd=REPO,
                capture_output=True, text=True, timeout=600)
            check(r.returncode == 0, f"phase 21: {name} failed:\n"
                  f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
            secs[name] = time.perf_counter() - t
            outs[name] = r.stdout.splitlines()
            for line in outs[name]:
                print(f"phase 21: {name}: {line}", flush=True)
    for k in (1, 2):
        line = [ln for ln in outs["multicam_step"]
                if ln.startswith(f"k={k}: num_rendered per view ")]
        check(len(line) == 1 and "graphed step bit for bit the eager step"
              in line[0], f"phase 21: multicam_step k={k}: {line}")
        per_replay = ast.literal_eval(line[0].split(
            "launches per replayed step ")[1].split("; ")[0])
        want = {"expand": k, "tile_fwd": k, "tile_bwd": k,
                "seg_reduce_f32": 0, "seg_reduce_packed": k}
        check(per_replay == want, f"phase 21: multicam_step k={k}: "
              f"launches per replayed step {per_replay}, not {want}")
    for name, row in (("microbench_sort", "port_current_key_sort+K5"),
                      ("microbench_reduce", "port_current_K5")):
        line = [ln for ln in outs[name] if ln.startswith(row)]
        check(len(line) == 1 and line[0].endswith(
            "launches per replay {'seg_reduce_f32': 1})"),
              f"phase 21: {name}: {row}: {line}")
    for what, fn, rows, order, bounds in k5_row_cases(dev, args):
        k5_row_check(dev, what, fn, rows, order, bounds)
    launches, procs = logged_launches(log)
    check(procs == dict.fromkeys(args, 1), f"phase 21: processes {procs}")
    check(all(launches[n] > 0 for n in ("expand", "tile_fwd", "tile_bwd",
                                        "seg_reduce_f32",
                                        "seg_reduce_packed")),
          f"phase 21: the path bypassed a kernel: {launches}")
    took = ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
    print(f"phase 21: seconds {took}; launches of the path (its "
          f"{len(args)} processes; replays not counted) {launches}; "
          f"{time.perf_counter() - t0:.3f} s; {smi}", flush=True)
    return launches


def k5_row_cases(dev, args):
    """Yields (what, the row's function, rows, order, bounds) for every
    port_current row that `args` (TIMING_ARGS's form) times: the entry
    point's draws at the row's own sizes on `dev`, the row's body on
    them, and K5's inputs (microbench_sort's and microbench_sortscale's
    order and bounds from the same stable sort and search as the row;
    microbench_reduce's the identity and root's bounds, which start past
    slot 0)."""
    import torch

    from reduced3dgs_torch import microbench_reduce as mred
    from reduced3dgs_torch import microbench_sort as msort
    from reduced3dgs_torch import microbench_sortscale as mscale
    from reduced3dgs_torch.microbench_binning import on_device
    from reduced3dgs_torch.ops import tile_render as ttr

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int)
    ap.add_argument("--prims", type=int)
    ap.add_argument("--sizes", type=int, nargs="+")

    def opts(name):
        return ap.parse_known_args(list(args[name]))[0]

    def key_case(what, key, records, p):
        order, bounds = msort.key_sort_bounds(key, p)
        return (what, lambda: msort.key_sort_k5(key, records, p), records,
                order, bounds)

    if "microbench_sort" in args:
        o = opts("microbench_sort")
        b, p = o.batch or msort.B, o.prims or msort.P
        d = on_device(msort.draws(b, p), dev)
        yield key_case(f"microbench_sort port_current_key_sort+K5 B={b} "
                       f"P={p}", d["key"],
                       ttr.as_records(d["cols"][:, :msort.NCOLS].T), p)
    if "microbench_reduce" in args:
        o = opts("microbench_reduce")
        b, p = o.batch or mred.B, o.prims or mred.P
        d = on_device(mred.draws(b, p), dev)
        records = ttr.as_records(d["cols"])
        identity = torch.arange(b, device=dev)
        yield (f"microbench_reduce port_current_K5 B={b} P={p}",
               lambda: ttr.seg_reduce(records, identity, d["zb"],
                                      packed=False),
               records, identity, d["zb"])
    if "microbench_sortscale" in args:
        o = opts("microbench_sortscale")
        p = o.prims or mscale.P
        for b in o.sizes or mscale.SIZES:
            d = on_device(mscale.draws(b, p), dev)
            yield key_case(f"microbench_sortscale port_current B={b} P={p}",
                           d["key"], ttr.as_records(d["cols"]), p)


def k5_row_check(dev, what, fn, rows, order, bounds):
    """A port_current row's K5 output, captured and replayed as the entry
    point times it (graphs.runner), against the plain version on the same
    tensors (bit for bit on segments of at most two instances, where no
    order of summation is open) and, with the plain version, against the
    float64 sums (check_seg); fails the phase on any mismatch."""
    import torch

    from reduced3dgs_torch import graphs
    from reduced3dgs_torch.ops import tile_render as ttr

    run = graphs.runner(fn, dev)
    run.replay()
    got = run.out
    want = ttr.seg_reduce_plain(rows, order, bounds, False)
    ref, mag = seg_reference(rows, order, bounds, False)
    lens = bounds[1:] - bounds[:-1]
    short = lens <= 2
    check(torch.equal(got[:, short], want[:, short]),
          f"phase 21: {what}: segments of <= 2 instances differ from the "
          "plain version")
    e_ref = check_seg(got, ref, mag, f"phase 21: {what}")
    check_seg(want, ref, mag, f"phase 21: plain {what}")
    err = float((got - want).abs().max())
    print(f"phase 21: K5 in {what}: first bound {int(bounds[0])}, last "
          f"{int(bounds[-1])}, longest segment {int(lens.max())}: max abs "
          f"err {err:.3e} against the plain version ({int(short.sum())} "
          f"segments of <= 2 instances bit-identical), {e_ref:.3e} against "
          "the float64 sums", flush=True)
    del run


# ---------------------------------------------------------------------------
# phase 22: the fused preprocess kernel
# ---------------------------------------------------------------------------

def prep_cameras(size, device, n_views=2, radius=3.5):
    """CameraParams of `n_views` poses around the origin at one of
    PREP_SIZES' image sizes and fields of view."""
    from reduced3dgs_torch.cameras import Camera

    cfg = PREP_SIZES[size]
    out = []
    for i in range(n_views):
        a = 0.4 + 2.1 * i
        out.append(Camera.look_at(
            eye=(radius * math.sin(a), 0.3 * i, -radius * math.cos(a)),
            target=(0.1, -0.05, 0.0), fov_x=math.radians(cfg["fov_x"]),
            width=cfg["width"], height=cfg["height"]).params(device))
    return out


def prep_pool(n, seed, device, alive_rows=None, scale=0.02, degree=None,
              dead_share=0.0, degenerate=0):
    """A seeded pool of `n` rows made on `device`: 80 % in a ball of
    radius 1.5 around the origin, 20 % in a shell of radii 5-15 (behind
    the cameras and outside their frustums too); log-normal scales around
    `scale`, unnormalised quaternions, raw opacities N(0, 2) (some below
    the binning's 1/300), SH coefficients on every band whatever the
    degree, degrees 0-3 mixed (or all `degree`); the first `alive_rows`
    alive, and `dead_share` of those dead again at random; the last
    `degenerate` rows near the centre with one log-scale of 12 and two
    of -12, whose 2D covariances round to det 0 or below."""
    import torch

    g = torch.Generator(device=device).manual_seed(int(seed))

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    d = randn(n, 3)
    d = d / d.norm(dim=1, keepdim=True).clamp_min(1e-6)
    shell = rand(n) < 0.2
    r = torch.where(shell, 5.0 + 10.0 * rand(n), 1.5 * rand(n) ** (1 / 3))
    xyz = d * r[:, None]
    scales = math.log(scale) + 0.6 * randn(n, 3)
    rots = randn(n, 4)
    opac = 2.0 * randn(n)
    sh = 0.4 * randn(n, 16, 3)
    degrees = (torch.randint(0, 4, (n,), generator=g, device=device,
                             dtype=torch.int32) if degree is None else
               torch.full((n,), degree, dtype=torch.int32, device=device))
    alive = torch.arange(n, device=device) < (
        n if alive_rows is None else alive_rows)
    if dead_share:
        alive &= rand(n) >= dead_share
    if degenerate:
        k = slice(n - degenerate, n)
        xyz[k] = 0.3 * randn(degenerate, 3)
        scales[k] = torch.tensor([12.0, -12.0, -12.0], device=device)
        opac[k] = 3.0
        alive[k] = True
    return dict(xyz=xyz, scales=scales, rots=rots, opac=opac, sh=sh,
                degrees=degrees, alive=alive)


def prep_args(pool, precomp=None):
    """preprocess's positional inputs from a prep_pool (its sh replaced
    by the PoolView's (P, 1, 3) zeros where colours come precomputed)."""
    import torch

    sh = pool["sh"] if precomp is None else torch.zeros(
        (pool["xyz"].shape[0], 1, 3), device=pool["xyz"].device)
    return (pool["xyz"], pool["scales"], pool["rots"], pool["opac"], sh,
            pool["degrees"])


def prep_rounding_floats(pool, cam, alive=True, scale_modifier=1.0):
    """(P, 9) float32: the values the torch path rounds to integers, from
    its own ops -- the radius before its ceil and the eight tile
    coordinates of the square and the binning rect before truncation,
    each 0.5 where its rounding cannot change an output (a culled row's
    radius, a coordinate the clip to the grid decides) -- and two (P,)
    bool: the live rows whose 2D covariance's determinant is 0, and the
    rows behind the camera's near plane."""
    import torch

    from reduced3dgs_torch.ops import preprocess as tp
    from reduced3dgs_torch.ops import transforms as tf

    xyz = pool["xyz"]
    focal_x = cam.width / (2.0 * cam.tan_fovx)
    focal_y = cam.height / (2.0 * cam.tan_fovy)
    p_view = tf.transform_points_3x3(xyz, cam.viewmatrix)
    live = p_view[:, 2] > 0.2
    if alive:
        live = live & pool["alive"]
    safe = (torch.arange(3, device=xyz.device) == 2).to(xyz.dtype)
    t_safe = torch.where(live[:, None], p_view, safe)
    p_hom = tf.transform_points(xyz, cam.projmatrix)
    p_w = 1.0 / torch.where(live, p_hom[:, 3] + 1e-7, 1.0)
    mx = tf.ndc2pix(p_hom[:, 0] * p_w, cam.width)
    my = tf.ndc2pix(p_hom[:, 1] * p_w, cam.height)
    cov3d = tf.build_cov3d(torch.exp(pool["scales"]), pool["rots"],
                           scale_modifier)
    cov2d = tf.compute_cov2d(t_safe, focal_x, focal_y, cam.tan_fovx,
                             cam.tan_fovy, cov3d, cam.viewmatrix)
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    r_pre = 3.0 * torch.sqrt(torch.clamp(mid + disc, min=0.0))
    kept = live & (det != 0.0)
    rad = torch.where(kept, torch.ceil(r_pre), 0.0)
    op = 1.0 / (1.0 + torch.exp(-pool["opac"]))
    ext_x, ext_y, _ = tp.binning_extents(cov2d, op)
    grid_x, grid_y = tp.tile_grid(cam.width, cam.height)

    def tile(v, grid):  # outside [0.5, grid + 0.5] the clip decides
        return torch.where((v >= 0.5) & (v <= grid + 0.5), v, 0.5)

    cols = [torch.where(kept, r_pre, 0.5)]
    for rx, ry in ((rad, rad), (torch.minimum(ext_x, rad),
                                torch.minimum(ext_y, rad))):
        cols += [tile((mx - rx) / tp.TILE_X, grid_x),
                 tile((my - ry) / tp.TILE_Y, grid_y),
                 tile((mx + rx + tp.TILE_X - 1) / tp.TILE_X, grid_x),
                 tile((my + ry + tp.TILE_Y - 1) / tp.TILE_Y, grid_y)]
    return (torch.stack(cols, dim=1), live & (det == 0.0),
            p_view[:, 2] <= 0.2)


def near_integer(v, ulps=PREP_NEAR_ULPS):
    """(P,) bool: rows with a value of (P, k) float32 `v` within `ulps`
    units in the last place of an integer."""
    import torch

    a = v.abs()
    ulp = torch.nextafter(a, torch.full_like(a, math.inf)) - a
    return ((v - torch.round(v)).abs() <= ulps * ulp).any(dim=1)


def compare_prep(got, want, near):
    """A kernel's PreprocessOut against the torch path's: per float
    output its largest relative gap (each row to its largest component's
    magnitude, colours to at least 1, their unit range; NaN where the
    torch path has NaN counts as equal), the rows whose integer outputs
    differ, and those of them no near-integer rounding (`near`) excuses."""
    import torch

    gaps = {}
    for name in ("means2d", "depths", "conic", "opacity", "color"):
        a = getattr(got, name).reshape(got.depths.shape[0], -1)
        b = getattr(want, name).reshape(a.shape)
        scale = b.abs().amax(dim=1, keepdim=True)
        if name == "color":
            scale = scale.clamp_min(1.0)
        gap = (a - b).abs() / scale.clamp_min(1e-30)
        same = (a == b) | (a.isnan() & b.isnan())
        gaps[name] = float(torch.where(same, 0.0, gap.nan_to_num(math.inf))
                           .max()) if a.numel() else 0.0
    diff = torch.zeros_like(got.depths, dtype=torch.bool)
    for name in ("radii", "rect_min", "rect_max", "tiles_touched"):
        a = getattr(got, name).reshape(diff.shape[0], -1)
        diff |= (a != getattr(want, name).reshape(a.shape)).any(dim=1)
    return dict(gaps=gaps, differ=int(diff.sum()),
                unexcused=int((diff & ~near).sum()), near=int(near.sum()))


def same_bits(a, b):
    """Two PreprocessOuts equal bit for bit."""
    import torch

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    return all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


def prep_cases(pool, size):
    """[(name, CameraParams, keyword arguments of preprocess)]: each pose
    of `size`'s cameras with the alive mask, without it, at
    scale_modifier 0.5 and with color_precomp."""
    import torch

    n = pool["xyz"].shape[0]
    g = torch.Generator(device=pool["xyz"].device).manual_seed(n)
    precomp = torch.rand((n, 3), generator=g, device=pool["xyz"].device)
    out = []
    for v, cam in enumerate(prep_cameras(size, pool["xyz"].device)):
        for name, kw in (("alive", dict(alive_mask=pool["alive"])),
                         ("no_mask", {}),
                         ("modifier_0.5", dict(alive_mask=pool["alive"],
                                               scale_modifier=0.5)),
                         ("precomp", dict(alive_mask=pool["alive"],
                                          color_precomp=precomp))):
            out.append((f"{size} view {v} {name}", cam, kw))
    return out


def _say(line):
    print(line, flush=True)


def check_prep(name, got, want, floats, rows):
    """check() the kernel's outputs `got` against the torch path's `want`
    by compare_prep, with the near-integer rows of the torch path's
    pre-rounding `floats`: floats within PREP_FLOAT_GAP, integer outputs
    equal but on rows a rounding excuses, at most PREP_EXCUSED_SHARE of
    `rows`.  Returns compare_prep's result."""
    res = compare_prep(got, want, near_integer(floats))
    check(max(res["gaps"].values()) <= PREP_FLOAT_GAP
          and res["unexcused"] == 0
          and res["differ"] <= PREP_EXCUSED_SHARE * rows,
          f"{name}: kernel against the torch path {res}")
    return res


def prep_parity(dev, seed, rows=PREP_PARITY_ROWS, say=_say):
    """The kernel against the torch path on a seeded parity pool, for
    every case of prep_cases at both sizes: check_prep, and two launches
    bit for bit.  The pool must reach every kind of row (culled by depth,
    dead, outside the frustum, det 0, each degree).  Returns the worst
    float gap and the most rows excused in one case."""
    import torch

    from reduced3dgs_torch.ops import preprocess as tp

    pool = prep_pool(rows, seed, dev, dead_share=0.05, degenerate=512)
    worst, most = 0.0, 0
    kinds = dict.fromkeys(("behind", "dead", "outside", "det0"), 0)
    for size in PREP_SIZES:
        for name, cam, kw in prep_cases(pool, size):
            args = prep_args(pool, kw.get("color_precomp"))
            with torch.no_grad():
                want = tp.preprocess_torch(*args, cam, **kw)
                outs = [tp.preprocess_fused(*args, cam, **kw)
                        for _ in range(2)]
            floats, det0, behind = prep_rounding_floats(
                pool, cam, "alive_mask" in kw,
                kw.get("scale_modifier", 1.0))
            check(same_bits(*outs), f"{name}: two launches differ")
            res = check_prep(name, outs[0], want, floats, rows)
            worst = max(worst, *res["gaps"].values())
            most = max(most, res["differ"])
            kept = floats[:, 0] != 0.5
            kinds["det0"] += int(det0.sum())
            kinds["behind"] += int(behind.sum())
            kinds["outside"] += int((kept & (want.radii == 0)).sum())
            if "alive_mask" in kw:
                kinds["dead"] += int((~pool["alive"]).sum())
            say(f"phase 22: {name}: largest float gaps "
                + ", ".join(f"{k} {v:.2e}" for k, v in res["gaps"].items())
                + f"; integer outputs differ on {res['differ']} of {rows} "
                f"rows ({res['near']} near a rounding); visible "
                f"{int((want.radii > 0).sum())}")
    degrees = torch.bincount(pool["degrees"].long(), minlength=4)
    check(all(kinds.values()) and bool((degrees > 0).all()),
          f"parity pool lacks a kind of row: {kinds}, degrees {degrees}")
    return worst, most


def prep_frame_checks(dev, seed, say=_say):
    """The kernel inside a captured graph (the camera from a device
    vector, two poses) bit for bit its eager launches, with the
    preprocess_fused counter once a replay summing the visible rows; and
    a frame of each size rendered through the kernel within
    PREP_FRAME_GAP mean gap of the same frame through the torch path.
    Returns the largest mean gap."""
    import torch

    from reduced3dgs_torch import graphs
    from reduced3dgs_torch.cameras import Camera
    from reduced3dgs_torch.ops import preprocess as tp
    from reduced3dgs_torch.render import next_budget
    from reduced3dgs_torch.renderer import render
    from reduced3dgs_torch.train.trainer import (
        camera_from_vector, camera_vector,
    )
    from reduced3dgs_torch.utils import profiling

    pool = prep_pool(PREP_PARITY_ROWS, seed + 1, dev, dead_share=0.05)
    args = prep_args(pool)
    worst = 0.0
    for size, cfg in PREP_SIZES.items():
        cams = [Camera.look_at(eye=(3.5 * math.sin(a), 0.2, -3.5 *
                                    math.cos(a)), target=(0, 0, 0),
                               fov_x=math.radians(cfg["fov_x"]),
                               width=cfg["width"], height=cfg["height"])
                for a in (0.3, 2.5)]
        vec = torch.zeros(37, device=dev)
        cp = camera_from_vector(vec, cfg["width"], cfg["height"])
        with torch.inference_mode():
            run = graphs.runner(lambda: tp.preprocess(
                *args, cp, alive_mask=pool["alive"]), dev)
            profiling.reset()
            with profiling.enable():
                visible = 0
                for cam in cams:
                    vec.copy_(torch.as_tensor(camera_vector(cam)))
                    run.replay()
                    eager = tp.preprocess_fused(*args, cam.params(dev),
                                                alive_mask=pool["alive"])
                    check(same_bits(run.out, eager),
                          f"{size}: replayed graph differs from the eager "
                          "launch")
                    visible += int((run.out.radii > 0).sum())
                snap = profiling.snapshot()
            profiling.reset()
        c = snap["counters"].get("preprocess_fused")
        # the graph's replays and the eager launches, once each
        check(c is not None and c["count"] == 2 * len(cams)
              and c["sum"] == 2 * visible,
              f"{size}: preprocess_fused {c}, want {2 * len(cams)} renders "
              f"and {2 * visible} rows")
        del run
        bg = torch.zeros(3, device=dev)
        for cam in cams:
            cpar = cam.params(dev)
            budget = 1 << 20
            while True:
                with torch.no_grad():
                    outs = [render(pool["xyz"], pool["sh"], pool["scales"],
                                   pool["rots"], pool["opac"],
                                   pool["degrees"], cpar, bg,
                                   width=cfg["width"],
                                   height=cfg["height"],
                                   instance_budget=budget,
                                   alive_mask=pool["alive"],
                                   screen_offset=off)
                            for off in (None, torch.zeros_like(
                                pool["xyz"][:, :2]))]
                need = max(int(o.num_rendered) for o in outs)
                if need <= budget:
                    break
                budget = next_budget(budget, need)
            gap = float((outs[0].color - outs[1].color).abs().mean())
            check(gap <= PREP_FRAME_GAP, f"{size}: frame through the kernel "
                  f"{gap:.3e} from the torch path's")
            worst = max(worst, gap)
            top = float((outs[0].color - outs[1].color).abs().max())
            say(f"phase 22: {size} frame ({need} instances): mean gap "
                f"{gap:.3e}, largest {top:.3e} against the torch path")
    return worst


def prep_bytes(pool, out, precomp):
    """The bytes the kernel must move for a launch: every row's inputs
    and outputs, and each visible row's coefficients its degree keeps (or
    its precomputed colour)."""
    import torch

    vis = out.radii > 0
    if precomp:
        coeff = 12 * int(vis.sum())
    else:
        d = pool["degrees"].clamp(0, 3).long()
        coeff = 12 * int(torch.where(vis, (d + 1) ** 2, 0).sum())
    n = pool["xyz"].shape[0]
    return n * (PREP_ROW_IN + PREP_ROW_OUT) + coeff


def prep_timing(dev, seed, smi, say=_say):
    """Each PREP_SIZES scene: the torch path's and the kernel's ms a call
    (a replayed graph, best of 3 windows of replays), beside the bytes
    bound of the launch and the bound of every row reading all 48
    coefficients; the two paths' outputs there held to check_prep.
    Returns {size: {name: ms, ..., "parity": compare_prep's result}}."""
    import torch

    from reduced3dgs_torch import graphs
    from reduced3dgs_torch.ops import preprocess as tp

    res = {}
    for size, cfg in PREP_SIZES.items():
        shares = (0.45, 0.2, 0.15, 0.2) if cfg["precomp"] else None
        pool = prep_pool(cfg["rows"], seed + 7, dev, cfg["alive"],
                         cfg["scale"], degree=None if shares else 3)
        if shares:
            cut = np.cumsum(np.array(shares) * cfg["rows"]).astype(int)
            idx = torch.arange(cfg["rows"], device=dev)
            pool["degrees"] = torch.bucketize(
                idx, torch.as_tensor(cut[:-1], device=dev),
                right=True).to(torch.int32)
        precomp = (torch.rand((cfg["rows"], 3), device=dev)
                   if cfg["precomp"] else None)
        args = prep_args(pool, precomp)
        cam = prep_cameras(size, dev, n_views=1)[0]
        kw = dict(alive_mask=pool["alive"], color_precomp=precomp)
        rows = {"torch": lambda: tp.preprocess_torch(*args, cam, **kw),
                "kernel": lambda: tp.preprocess_fused(*args, cam, **kw)}
        ms = {}
        with torch.inference_mode():
            out = tp.preprocess_fused(*args, cam, **kw)
            want = tp.preprocess_torch(*args, cam, **kw)
            floats, _, _ = prep_rounding_floats(pool, cam)
            parity = check_prep(f"{size} at {cfg['rows']} rows", out, want,
                                floats, cfg["rows"])
            del want, floats
            for name, fn in rows.items():
                run = graphs.runner(fn, dev)
                sec, reps = graphs.best_window(run, dev)
                ms[name] = sec * 1e3
                del run
        nbytes = prep_bytes(pool, out, cfg["precomp"])
        least = bound(nbytes, 0)[0]
        every = bound(cfg["rows"] * (PREP_ROW_IN + 192 + PREP_ROW_OUT), 0)[0]
        res[size] = dict(ms, bound_ms=least, bound_all_rows_ms=every,
                         visible=int((out.radii > 0).sum()), parity=parity)
        say(f"phase 22: {size} ({cfg['rows']} rows, {cfg['alive']} alive, "
            f"{res[size]['visible']} visible, "
            f"{'color_precomp' if cfg['precomp'] else 'SH 3'}): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
            + f"; bound {least:.4f} ms ({nbytes} B; "
            f"{100 * least / ms['kernel']:.1f} % of it), every row's 48 "
            f"coefficients {every:.4f} ms; against the torch path: largest "
            f"float gaps "
            + ", ".join(f"{k} {v:.2e}" for k, v in parity["gaps"].items())
            + f", integer outputs differ on {parity['differ']} rows "
            f"({parity['near']} near a rounding); {smi}")
        del pool, args, out, precomp
        torch.cuda.empty_cache()
    return res


def preprocess_path(dev, seed, smi):
    """Phase 22: prep_parity, prep_frame_checks and prep_timing; returns
    the kernel's entry of the kernels line."""
    from reduced3dgs_torch.ops import preprocess as tp

    t0 = time.perf_counter()
    before = tp.PREPROCESS_FWD.launches
    worst, most = prep_parity(dev, seed)
    frame = prep_frame_checks(dev, seed)
    timing = prep_timing(dev, seed, smi)
    print(f"phase 22: {time.perf_counter() - t0:.3f} s; largest float gap "
          f"{worst:.3e}, most rows excused in a case {most}, largest frame "
          f"mean gap {frame:.3e}", flush=True)
    return {"name": "preprocess_fwd", "route": "cuda",
            "source": "reduced3dgs_torch/csrc/preprocess_fwd.cu",
            "replaces": None, "float_gap": worst, "rows_excused": most,
            "frame_gap": frame, "timing_ms": timing,
            "launches_phase22": tp.PREPROCESS_FWD.launches - before}



# phase 23: alignment pads past the slack pool

def spill_scene(cfg, seed, dev):
    """The benchmark's seeded scene of `cfg` as the program's PoolView."""
    from reduced3dgs_torch.models.gaussians import (
        GaussianParams, GaussianPool,
    )
    from reduced3dgs_torch.render import PoolView
    from splatbench import scene

    leaves = scene.primitives(cfg, seed, dev)
    return PoolView(GaussianPool(
        params=GaussianParams(*(leaves[k] for k in scene.LEAVES)),
        degrees=leaves["degrees"], alive=leaves["alive"],
        active_sh_degree=cfg["sh_degree"]))


def spilled_k1(pv, cam, budget, dev):
    """K1 on a view that lays pads past the slack pool: the inputs of its
    binning in one eager render_once at `budget`, the keys and the whole
    BinningOut held to the plain version's bit for bit (check_k1), and
    the layout checked to spill (pad need over the pool, within B_pad).
    Returns (nv, pad need, slack pool)."""
    import torch

    from reduced3dgs_torch.ops import binning as tbin
    from reduced3dgs_torch.render import render_once

    seen, real = [], tbin.bin_gaussians

    def spy(prep, width, height, budget, tile_rows=None):
        seen.append((prep, width, height, budget, tile_rows))
        return real(prep, width, height, budget, tile_rows=tile_rows)

    tbin.bin_gaussians = spy
    try:
        render_once(pv, cam.params(dev), torch.zeros(3, device=dev), budget)
    finally:
        tbin.bin_gaussians = real
    prep, w, h, b, rows = seen[0]
    args, _ = check_k1(prep, w, h, b, tbin, "spilled view", rows)
    nv, need = int(args[4]), int(args[3][-1])
    pool = args[7] - args[6]
    check(need > pool and nv + need <= args[7], f"K1 spilled view: pad "
          f"need {need}, slack pool {pool}, nv {nv}, B_pad {args[7]}")
    return nv, need, pool


def spill_frames(dev, seed, cfg, poses=SPILL_POSES, path=SPILL_PATH,
                 say=_say, k1=False):
    """The poses of cfg's viewing path served by a FrameServer settled
    over them, each frame traced (pads_spilled and the pad need, per
    mille of the slack pool) and held to the reference's frame within
    the m360_full.serve cell's limits.  k1 (a card): K1 is held to the
    plain version (spilled_k1) on the first pose over the pool.  Returns
    [(pose, pad need per mille, pads_spilled, the reference's pad share,
    mean gap, largest gap)]."""
    import torch

    from reduced3dgs_torch.cameras import Camera
    from reduced3dgs_torch.render import FrameServer
    from reduced3dgs_torch.train.trainer import camera_vector
    from reduced3dgs_torch.utils import profiling
    from splatbench import scene
    from splatbench.generators import view as vw
    from splatbench.reference import full_precision

    with open(os.path.join(REPO, "splatbench", "limits",
                           "m360_full.serve.json")) as f:
        limits = json.load(f)
    w, h = cfg["width"], cfg["height"]
    route = scene.viewing_path(cfg, seed, path)
    cams = [Camera(uid=i, colmap_id=i, R=route[i][0], T=route[i][1],
                   fov_x=math.radians(cfg["assumed"]["fov_x_deg"]),
                   fov_y=scene.fov_y(cfg), image=None,
                   image_name=f"{i:05d}", width=w, height=h)
            for i in poses]
    server = FrameServer(spill_scene(cfg, seed, dev), w, h,
                         torch.zeros(3, device=dev))
    server.settle(cams)
    frames = []
    for i, cam in zip(poses, cams):
        profiling.reset()
        with profiling.enable():
            out = server.frame(camera_vector(cam))
            snap = profiling.snapshot()
        frames.append((i, out.color.clone(), snap["counters"]))
        profiling.reset()
    over = [k for k, (_, _, c) in enumerate(frames)
            if c["pad_need_permille"]["max"] > 1000]
    if k1 and over:
        nv, need, pool = spilled_k1(server.pv, cams[over[0]], server.budget,
                                    dev)
        say(f"phase 23: K1 on pose {poses[over[0]]} (nv {nv}, pad need "
            f"{need} against a slack pool of {pool}): keys and BinningOut "
            f"bit-identical to the plain version's")
    rows = []
    with full_precision():
        model = vw.reference_model(cfg, seed, dev)
        for i, color, counters in frames:
            want, share = vw.reference_frame(cfg, model, route[i], dev)
            gap = (color - want).abs()
            mean, top = float(gap.mean()), float(gap.max())
            need = counters["pad_need_permille"]["max"]
            spilled = counters["pads_spilled"]["max"]
            say(f"phase 23: pose {i}: pad need {need} per mille of the "
                f"slack pool (the reference's {share:.4f}), pads_spilled "
                f"{spilled}, mean gap {mean:.3e}, largest {top:.3e} "
                f"(budget {server.budget})")
            check(mean <= limits["frame_mean_gap"]
                  and top <= limits["frame_max_gap"],
                  f"pose {i}: frame gaps {mean:.3e} / {top:.3e} over the "
                  f"limits {limits}")
            # (the pad need is floored to whole per mille)
            check(spilled > 0 if need > 1000 else need == 1000
                  or spilled == 0, f"pose {i}: pads_spilled {spilled} at "
                  f"a pad need of {need} per mille")
            rows.append((i, need, spilled, share, mean, top))
    return rows


def spill_path(dev, seed):
    """Phase 23 at the m360_full size."""
    with open(os.path.join(REPO, "splatbench", "configs",
                           "m360_full.json")) as f:
        cfg = json.load(f)
    t0 = time.perf_counter()
    rows = spill_frames(dev, seed, cfg, k1=True)
    check(any(spilled > 0 for _, _, spilled, _, _, _ in rows),
          "phase 23: no view laid pads past the slack pool")
    print(f"phase 23: {time.perf_counter() - t0:.3f} s; {len(rows)} views, "
          f"{sum(r[2] > 0 for r in rows)} with pads past the pool; largest "
          f"mean gap {max(r[4] for r in rows):.3e}, largest gap "
          f"{max(r[5] for r in rows):.3e}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
