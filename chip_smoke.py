"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--num-points N]

Phases, each printed on its own line with its seconds:

1. build   -- tools/warmup.main on main's TOML (one chunk of 1,024
              samples per curve), whose first launch builds csrc/*.cu (the
              horizon kernel in 6 parts and the per-step Newton kernel in
              2, the histograms in 1, one nvcc each, all in parallel) into
              one library under build/ (plain C interface, loaded with
              ctypes); prints every kernel's ptxas registers and spills.  The
              CLI's first ingest builds the host CSV parser
              (native/src/trpl_native.cpp, the host C++ compiler) under
              build/.
2. compare -- the horizon kernel's chord body against its plain PyTorch
              version (group=1), on the card, on the same inputs: a seeded
              sample box, one curve of the power_scan configuration.  The
              plain version is a Python step loop (on the card its steps
              and iterations CUDA graph replays, models/step_graph.py), so
              both run a shortened ladder (256 fine steps, then 64 coarse steps at
              each of the strides 16/32/64).  float64 at 64 samples: conv,
              its, fulls and execs equal, final N/P/E bitwise equal,
              sse/esum within 1e-9 relative.  float32 at 1024 samples (the
              chunk): see F32_* below.  Then
              the kernel alone on the full ladder (256 fine steps, then
              strides 16/32/64 x 512, the last rung 862), timed per launch
              by CUDA events at chunk 1024: the times in the kernel line.
3. main    -- ``python -m bayesian_inference_trpl_tpu_torch.run`` on a TOML
              written into a temp dir: power_scan's [grid], [params] and
              [device], synthetic data for 3 excitation curves, a reduced
              num_points.  Counts every kernel launch and checks the output.
   main_resume -- main's inputs at 4,096 samples, stopped by a checkpoint
              write that raises after chunk 2 of curve 1, run again with
              --resume: only the chunks left launch, and P and the exported
              files equal an uninterrupted run's bit for bit.
   main_adaptive -- main's inputs with adaptive_fine_tau = 50 ns: the
              bucket's size printed (non-empty asserted), the bulk's P
              bitwise main's, and the bucket's P bitwise a separate CLI run
              of those samples alone on the bucket's 512/16/32 ladder.
4. compare_offgrid -- as 2, for the kernel's off-grid mode: the same
              ladders scored at ~400 log-spaced observation times (slot
              tables, models/offgrid.py), every phase one off-grid launch.
5. main_offgrid -- as 3, with the observations at those log-spaced times
              (examples/power_scan_offgrid.toml's configuration).
6. compare_full, compare_full_offgrid -- as 2 and 4 for the full-Newton
              body (method fused_horizon).
7. main_full, main_full_offgrid -- as 3 and 5 with method fused_horizon.
8. compare_newton_step -- the per-step Newton kernel against
              coupled_newton_step on the recorded inputs of steps from
              every phase of a coupled_newton_pallas run of the shortened
              ladder, float64 and float32 at 1024 samples; its time per
              launch by CUDA events.
9. main_newton_step -- as 3 with method coupled_newton_pallas at 1,024
              samples: one launch of the per-step kernel per BDF step, each
              step one CUDA graph replay (models/step_graph.py; the replays
              counted and asserted).  newton_step_routes -- that graph
              route held bitwise to the eager loop on the ladder's first
              128 steps, float64 and float32, each timed per step.
10. compare_variants -- kernel vs plain (group=1), float64 (bitwise state,
              equal counts) and float32, for what the main paths do not
              launch: the previous, linear and geometric predictors, the
              throughput chord profile, the run-time widths L = 32, 64 and
              256, and batches that are not a multiple of the samples per
              block (horizon kernel and per-step kernel).
              chord_refresh_cost -- the plain chord chain's Jacobian
              refresh, chosen on the host before each iteration, against
              the refresh on every iteration: the chain's wall and an
              iteration's replay on the card with it and without it.
11. compare_exact, time_exact -- exact fixed-dt mode (no ladder: one
              stride-1 launch over the whole horizon under the throughput
              chord profile, geometric predictor): kernel vs plain
              (group=1) on a shortened phase of 256 steps, float64 (counts
              equal, N/P/E bitwise) and float32; then one 80,000-step
              launch at chunk 1024 timed by CUDA events.
    compare_record, time_record -- the record launch of the interpolation
              fallback (full Newton at stride 1 over the whole horizon,
              recording the PL trace, no observations): kernel vs plain
              (group=1) on a 256-step phase, float64 every 1 and every 4
              steps (counts equal, N/P/E bitwise, trace within 1e-12) and
              float32; then one 80,000-step launch at chunk 1024 timed by
              CUDA events.  time_step_loops -- the step-loop route of the
              same solve (coupled_newton; coupled_newton_pallas) per step on
              a short horizon, eager and graph route (bitwise the same),
              against the record launch per step; the graph route's
              steady state (every piece a replay) on the host clock and
              on the card.
    compare_record_states, time_record_states -- the record launch with
              the state and iteration traces of the forward model's
              standalone mode (models/driver.pvsim): kernel vs plain
              (group=1) on the 256-step phase, float64 (counts and
              iteration traces equal, frames and N/P/E bitwise) and float32;
              then one launch at main_pvsim's shape timed by CUDA events.
    main_pvsim -- ``python -m bayesian_inference_trpl_tpu_torch.tools.run_sweep``
              (its main, in this process) on a full-width sweep (1,024
              production-box samples, 80,000 steps, the state every 800):
              exactly one record launch; its PL trace against the PL of
              its state snapshots.
    corner_gate -- the port's solver against the scipy oracle's shipped
              results on the 32 box and 16 mu-asymmetric corners at T0, 2 T0
              and 4 T0 (float64, one record launch each), asserted at the
              JAX package's bounds (tests/test_corner_gate.py); at T0 also
              coupled_newton_pallas, held to the record launch.  Missing
              oracle files fail the script.
    main_gauss_seidel -- the reference scheme (method gauss_seidel: plain
              PyTorch, no kernel) through the CLI at the reference's
              settings (float64, tol 1e-7, the previous-state predictor,
              exact fixed-dt), one curve, the legacy grid (random_sample =
              false, 2 points per free dimension: 1,024 samples), the
              horizon cut to GS_T steps; no kernel launched, X bitwise the
              host's make_grid.  The same TOML with fused_horizon (one
              full-Newton launch) against it: posterior equivalence, finite
              patterns and the relative P difference (GS_P_RTOL).  Prints
              the wall per BDF step (graph route: each step's start and end
              and every iteration a CUDA graph replay, the exit test lagged
              one iteration; the replays asserted), the iterations per step
              (the eager loop's sweeps and the replays), the converged
              share, the ms per iteration and its host share (its device
              time from a CUDA-graph replay of newton_iteration) against
              the full-Newton launch; then the graph route held bitwise to
              the eager loop over the first GS_CHECK_STEPS steps, both timed,
              with what max_iters 32/64/128 would converge over them.
    main_legacy -- utils/legacy_pipeline.grid_refine_bayes with
              make_trpl_forward on power_scan's forward model (L 128,
              80,000 steps, float32, fused_horizon), PL every 200 steps
              (401 times): observations from the port's forward at a truth
              point with 2% noise, then three refinement levels (1,024
              cells, then <= 64 kept cells x 16 twice), each level one
              record launch; the device likelihood against a numpy copy of
              the JAX package's loop (see LEGACY_PL_STRIDE).
    device_sampler -- utils/sampling.random_grid_device on a CUDA generator
              at 131,072 x 13: bounds, pinning, moments, determinism.
    compare_hist -- the posterior's weighted histogram kernels
              (csrc/hist_kernel.cu) against their plain versions on 10^6
              float64 samples with NaN, +-inf and values on both edges: 1-D
              at 96 bins (counts equal), 2-D at 96 x 96 (the shared-memory
              path) and 200 x 200 (the global-memory path), sums within
              1e-12 relative; each timed beside its plain version and
              torch.bincount (the index computation included).
    main_posterior -- posterior/cli.report (--t-factor auto) on main's
              exported result (32,768 samples) on the card, and the corner
              plot's marginals at 96 bins (6 1-D and 15 2-D histogram
              launches), held to the same calls on the CPU; get_data on
              main's observation file on the native and csv.reader routes,
              bitwise equal, both timed.
    timeshift_demo -- tools/timeshift_demo --profile synthetic --batch 8
              --seed 0 --top 1 on the card: no sample non-converged, the
              shift grid's shift-0 rms the raw rms.
12. main_exact -- as 3 on a TOML with no ladder and the geometric
              predictor: exactly one stride-1 launch per chunk and curve.
    main_interp -- as 3 with main_offgrid's observations and
              offgrid_fused = false (the interpolation fallback) at 4,096
              samples: exactly one record launch per chunk and curve, no
              ladder launch.
13. gate -- the port's accuracy gate (tools/accuracy_gate.main) on the
              JAX package's two bundled batch-8 synthetic float64 caches
              (seeds 0 and 1; missing caches fail the script): chord Newton
              (fused_horizon_chord) asserted at the gate's thresholds, also
              with --adaptive-fine-tau 50, full Newton (fused_horizon)
              printed with its verdict; the launch layout at the gate's
              shapes.
14. posterior, posterior_offgrid -- tools/posterior_equivalence.main on the
              smoke's on-grid and off-grid inputs: the ladder against exact
              fixed-dt stepping over one sample matrix, asserted at the JAX
              tool's thresholds.
15. layout -- for every kernel entry of the kernels line: samples per
              block, resident blocks and samples per SM
              (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers,
              local memory and waves per launch at chunk 1024.
16. devices_split -- tools/dryrun_multichip on the card: a mesh that names
              cuda:0 twice (512 samples per entry) against cuda:0 alone
              (1,024) at power_scan's full ladder, 2,048 samples on-grid and
              off-grid, 1,024 on the interpolation route: each chunk launched
              once per entry, likelihoods and flags bitwise; with more cards
              visible also the real mesh against one card.
    main_multiprocess -- ``python -m torch.distributed.run --nproc-per-node 2
              -m bayesian_inference_trpl_tpu_torch.run`` on main_resume's
              inputs, CUDA_VISIBLE_DEVICES=0 for both processes (the gather
              over gloo): both ranks log num_devices 2, the shared-card
              warning and half the launches; rank 0 alone exports, bitwise main_resume's uninterrupted run.
    main_profile -- main's inputs at 4,096 samples with [device]
              profile_dir: the torch.profiler trace read back, the device
              idle share over simulate's window and over the chunk loop, the
              longest gaps between kernels; the host's launch rate
              (tools/launch_rate.py) before, after the same run untraced,
              after the traced run, after gc.collect and a synchronize, and
              in a fresh process.  It runs after phase 14
              (PROFILE_RESERVE_S).

Phases 12 and 14 take ~0.6 s per 80,000-step exact launch and main_interp
its record launch per chunk-curve; when the projected total passes
BUDGET_S the off-grid posterior run is cut to 2,048 samples, then
main_exact to 1,024, then main_interp to 2,048 and 1,024, each cut
printed.

Then one JSON line describing every kernel, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}.  Any failure
raises: the script exits non-zero and prints no result.  It needs CUDA and
the package beside it; it writes only to a temp dir and under build/.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Per-cell operation counts of the horizon kernel, from csrc/horizon_kernel.cu
# (adds, multiplies, divides and compares of the per-cell work; per-sample
# scalars such as the surface terms are not counted):
#   per step: BDF history sums 27, quadratic predictor 16, E update 12, PL 2,
#             plus the cheap residual check 90;
#   per executed Newton iteration: chord apply 110 (6 sweeps of 16 + final
#             pair 14), positivity-clamped update and step-size maxima 18,
#             residual re-check 90;
#   per Jacobian refresh: Jacobian blocks 70, PCR reduce 600 (6 sweeps of 96
#             + final pair 22).
#   full Newton (method fused_horizon) refreshes on every iteration: its
#             fulls and execs both count each iteration.
OPS_STEP = 27 + 16 + 12 + 2 + 90
OPS_ITER = 110 + 18 + 90
OPS_FULL = 70 + 600
# The per-step Newton kernel, per cell and launch: the residual check 90 and
# the E update 12, plus OPS_ITER + OPS_FULL per iteration.
OPS_NEWTON_CALL = 90 + 12
# Off-grid slot scoring, per slot and step (not per cell): window sum 7,
# error 1, weighted sums 5.
OPS_SLOT = 13
PEAK_FP32 = 67e12        # H100 SXM, FP32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

F64_RTOL = 1e-9
# float32: the kernel and the plain version run the same arithmetic in a
# different summation order (block reductions vs torch's), so residual
# norms differ in the last bits and a chord decision (skip / refresh /
# accept) can flip at a threshold; a flipped sample then takes another,
# equally valid, path to its tolerance.  Required: conv equal on >= 99% of
# the samples, and sse within F32_RTOL relative on >= 99% of the samples
# converged in both.
F32_RTOL = 1e-3
F32_MIN_SHARE = 0.99

POWER_SCAN = dict(thickness=311.0, time=2000.0, L=128, T=80000, tol_exp=4.0,
                  max_iters=8, step_tol=1e-6, fast_fine_steps=256,
                  fast_coarse_stride=16, fast_max_stride=64,
                  fast_steps_per_phase=512)
MIN_X = [1e8, 1e14, 0.0, 0.0, 1e-11, 0.1, 0.1, 1e-30, 1e-30, 1.0, 1.0, 0.1, 0.0]
MAX_X = [1e8, 1e16, 50.0, 50.0, 1e-9, 100.0, 100.0, 1e-28, 1e-28, 1000.0, 2000.0, 0.1, 0.0]
DO_LOG = [1, 1, 0, 0, 1, 1, 1, 1, 1, 0, 0, 1, 0]
# Off-grid observations: t = 0 plus this many log-spaced times from
# 0.7 dt to the horizon (examples/power_scan_offgrid.toml: ~400 per curve).
OFFGRID_POINTS = 400
# Coarse steps per rung in the plain comparisons (the shortened ladder).
SHORT_RUNG_STEPS = 64
# The variants phase's ladder: 64 fine steps, then 16 coarse steps at
# stride 16 and 8 at stride 64 (88 steps).
VARIANT_SCHED = ((1, 64), (16, 256), (64, 512))
# Launches the main paths do not make, each held to its plain version:
# (name, method, ladder_inputs keywords; ``num`` sets both dtypes' samples).
VARIANTS = (
    ("previous", "fused_horizon_chord", dict(predictor="previous")),
    ("linear", "fused_horizon_chord", dict(predictor="linear")),
    ("geometric", "fused_horizon_chord", dict(predictor="geometric")),
    ("full_previous", "fused_horizon", dict(predictor="previous")),
    ("full_geometric", "fused_horizon", dict(predictor="geometric")),
    ("throughput", "fused_horizon_chord", dict(predictor="geometric", throughput=True)),
    ("L32", "fused_horizon_chord", dict(L=32)),
    ("L64", "fused_horizon_chord", dict(L=64)),
    ("L256", "fused_horizon_chord", dict(L=256)),
    ("full_L64", "fused_horizon", dict(L=64)),
    ("offgrid_L64", "fused_horizon_chord", dict(L=64, offgrid=True)),
    ("tail_1001", "fused_horizon_chord", dict(num=1001)),
    ("full_offgrid_tail_1001", "fused_horizon", dict(num=1001, offgrid=True)),
)
# Exact fixed-dt mode: one phase over power_scan's whole horizon, and the
# shortened phase of its plain comparison.
EXACT_SCHED = ((1, POWER_SCAN["T"]),)
EXACT_SHORT_SCHED = ((1, 256),)
# Samples of main_exact and of each posterior-equivalence run, the cuts
# taken in order when the projected script time passes BUDGET_S, and the
# seconds charged per tool or CLI run besides its exact launches.
EXACT_SAMPLES = 4096
BUDGET_S = 400.0
EXACT_CUTS = (("posterior_offgrid", 2048), ("main_exact", 1024), ("main_interp", 2048),
              ("main_interp", 1024))
RUN_OVERHEAD_S = 4.0
# The interpolation fallback (main_interp): samples, and the record launch's
# plain comparison (a 256-step phase, PL every 1 and every 4 steps) and
# float64 tolerance; the step loops timed per step over these many steps.
INTERP_SAMPLES = 4096
RECORD_SHORT_SCHED = ((1, 256),)
RECORD_F64_RTOL = 1e-12
STEP_LOOP_STEPS = (("coupled_newton", 32), ("coupled_newton_pallas", 128))
# The steps after which every step class (models/step_graph.step_class:
# 0-3, then 4 + t % 6) has been captured once.
STEADY_SKIP = 10
# The forward model's standalone mode (models/driver.pvsim): the record
# launch with the state and iteration traces against its plain version on
# the 256-step phase, float64 at (pl_stride, state stride) pairs and
# float32 (iteration traces equal on F32_MIN_SHARE of the samples, their
# frames within RECORD_STATES_F32_RTOL); main_pvsim's full-width sweep
# (PVSIM_SAMPLES from accuracy_gate.sample_production_box, power_scan's
# grid, the state and PL every PVSIM_STRIDE steps: run_sweep's snapshot
# gcd at T = 80,000, 100 frames).
RECORD_STATES_F64 = ((1, 1), (2, 4))
RECORD_STATES_F32 = (4, 8)
RECORD_STATES_F32_RTOL = 1e-6
PVSIM_SAMPLES = 1024
PVSIM_STRIDE = 800
# main_pvsim's PL trace against the PL of its state snapshots (float32, two
# summation orders), relative, beside an absolute floor of this share of
# the sample's t = 0 PL (late points of fast decays cancel to rounding).
PVSIM_PL_RTOL = 1e-4
# corner_gate: coupled_newton_pallas (the per-step kernel's step loop)
# against the record launch at T0, float64: N, P and PL relative, E of
# E_SCALE [V/nm], the field of the mu-asymmetric corners (2-4e-4 V/nm; the
# ambipolar corners' true E is 0 and their E rounding noise).
CORNER_PALLAS_RTOL = 1e-10
E_SCALE = 1e-4
# main_gauss_seidel: the reference scheme (method gauss_seidel: plain
# PyTorch, it reaches no kernel) at the reference's settings (float64, tol
# 1e-7, the previous-state predictor; SURVEY.md:343, :359), exact fixed-dt,
# one curve, the legacy grid at GS_LEGACY_POINTS per free dimension
# (2**10 = 1,024 samples over MIN_X/MAX_X's 10 free dimensions: one chunk).
# Each Gauss-Seidel iteration is ~650 PyTorch operations and one host read
# (the loop's exit test): 7.3 ms on an H100 80GB HBM3 at 700 W, ~3 per step
# after the first ~50 steps, so the horizon is cut from 80,000 steps to GS_T
# at dt = 25 ps (16 ns), for a phase of <= 30 s.  GS_MAX_ITERS: the first
# steps from the initial condition take up to 254 iterations on half of
# these samples (max_iters 32 and 64 would converge ~36% and 50% of them;
# the phase prints the shares), so the smallest power of two at which
# >= 99% converge.  The same TOML with method fused_horizon (the full-Newton
# stride-1 kernel, one launch) is the comparison: on the samples finite in
# both, posterior equivalence at the tool's defaults, finite patterns
# differing on at most GS_FINITE_DIFF of the samples, and the relative P
# difference within GS_P_RTOL, the bound tests/test_torch_legacy_grid.py
# derives from the JAX package (gauss_seidel against coupled_newton at these
# settings, ten times its largest difference, rounded up to a power of ten).
GS_T = 640
GS_MAX_ITERS = 256
# The graph route held bitwise to the eager loop over the first steps of
# main_gauss_seidel's samples (the startup ramp, ~250 sweeps a step).
GS_CHECK_STEPS = 4
GS_LEGACY_POINTS = 2
GS_FINITE_DIFF = 0.01
GS_P_RTOL = 1e-5
# main_legacy: the grid-refinement pipeline (utils/legacy_pipeline) on
# power_scan's forward model (L 128, 80,000 steps of 25 ps, float32,
# fused_horizon: one record launch per forward call; main_pvsim's tol_exp,
# max_iters and "previous" predictor, the "exp" initial condition), PL
# every LEGACY_PL_STRIDE steps: 401 observation times, the size of a
# measured curve.  The observations are the port's own forward at
# LEGACY_TRUTH (user units, inside MIN_X/MAX_X) with LEGACY_NOISE seeded
# relative noise, std LEGACY_NOISE of each value.  Level 0 is 2 cells per
# free dimension (1,024: main_gauss_seidel's grid); levels 1 and 2 split
# the LEGACY_SPLIT columns (B, Sf, tau_n, tau_p) by 2, 16 sub-cells per
# kept cell.  The model error of the coarse levels makes their posterior
# nearly flat (a 10 ns rehearsal on the CPU: the top 256 of 1,024 cells
# within 2.5% of the largest mass), so no fixed floor keeps a known number
# of cells; each level's floor is the (LEGACY_KEEP + 1)-th largest mass of
# the level before (LegacyFloors), which keeps at most LEGACY_KEEP cells:
# a level holds <= 1,024 cells, one launch.  The device likelihood is
# held to a numpy copy of the JAX package's loop within LEGACY_LNP_RTOL of
# each row's sum of its terms' magnitudes (tests/test_torch_legacy_pipeline.py's
# LNP_RTOL_F32 for a float32 PL: the loop squares the model error as a
# np.float32 scalar, which numpy may round one ulp off the correctly rounded
# square; the sum over 401 time points runs in another order, and its
# terms cancel, so |lnp| can lie far below them) on up to
# LEGACY_HOST_BLOCKS blocks per level, evenly spread (the loop takes
# ~0.1 s a block of 16 on one host core).
LEGACY_PL_STRIDE = 200
LEGACY_TRUTH = [1e8, 3e15, 20.0, 20.0, 4.8e-11, 10.0, 10.0, 4.4e-29, 4.4e-29, 511.0,
                871.0, 0.1, 0.0]
LEGACY_NOISE = 0.02
LEGACY_SPLIT = (4, 5, 9, 10)
LEGACY_LEVELS = 3
LEGACY_KEEP = 64
LEGACY_LNP_RTOL = 2.4e-7
LEGACY_HOST_BLOCKS = 8
# The device sampler (utils/sampling.random_grid_device) on a CUDA
# generator: samples, and the moments' bound in standard errors.
DEVICE_SAMPLER_POINTS = 131072
DEVICE_SAMPLER_SE = 6.0
# main_newton_step's samples (C9: 4,096 before main_gauss_seidel, whose
# time they pay for); the same 2,142 launches per chunk-curve.
NEWTON_STEP_SAMPLES = 1024
# ... and the steps on which the graph route is held to the eager loop.
NEWTON_CHECK_STEPS = 128
# main_resume: samples, and the checkpoint after which the first run stops
# (curve 1, 2 of its 4 chunks done).
RESUME_SAMPLES = 4096
RESUME_STOP = (1, 2)
# devices_split: samples on-grid and off-grid and on the interpolation route,
# and the global chunk (512 per entry of the two-entry mesh).
SPLIT_SAMPLES = 2048
SPLIT_INTERP_SAMPLES = 1024
SPLIT_CHUNK = 1024
# main_multiprocess: torchrun's time limit.  main_profile: samples, and the
# seconds it takes with the launch rates (20-25 s on an H100 80GB HBM3: the
# untraced control run ~1.5 s, the traced run 9-13 s, the trace read back
# and the rates, a fresh process's among them, 8-10 s), which the
# exact-mode projection reserves.  It runs last (pipeline.profile_trace).
MULTIPROCESS_TIMEOUT_S = 300
PROFILE_SAMPLES = 4096
PROFILE_RESERVE_S = 30.0
# main_adaptive: the tau_n threshold [ns]; the bucket's ladder is the
# pipeline's (adaptive_fine_steps 512, adaptive_max_stride 32 by default).
ADAPTIVE_TAU = 50.0
# The accuracy gate's bundled float64 caches (batch 8, synthetic profile).
GATE_SEEDS = (0, 1)
GATE_METHODS = (("fused_horizon_chord", True), ("fused_horizon", False))
# ... and chord Newton again with adaptive tau routing, asserted.
GATE_ADAPTIVE = ("fused_horizon_chord", True, ADAPTIVE_TAU)
# Kernel template arguments in ptxas's mangled names: MODE (STRIDE1,
# STRIDES, OFFGRID) and NEWTON (CHORD, FULL) of csrc/horizon_kernel.cu.
MODE_ARG = {"stride_1": 0, "stride_s": 1, "offgrid": 2}
# The posterior's weighted histograms (compare_hist): samples (with NaN,
# +-inf and values on both edges), the CLI's bins (1-D, and 2-D on the
# shared-memory path), the 2-D bins of the global-memory path; sums held
# within HIST_RTOL of the plain version, counts equal.
HIST_SAMPLES = 1_000_000
HIST_BINS = 96
HIST_GLOBAL_BINS = 200
HIST_RTOL = 1e-12
# Operations per sample and axis: 2 range compares, subtract, multiply,
# the 2^63 compare, convert, last-bin compare; plus 1 add per sample.
HIST_OPS_AXIS = 7
PEAK_FP64 = 34e12        # H100 SXM, FP64 outside the tensor cores
# main_posterior: the CLI's report (--t-factor auto) on main's result on the
# card, held to the same call on the CPU: statistics within
# POSTERIOR_RTOL, fmin's temperature (and what is taken at it) within
# POSTERIOR_TF_RTOL (tests/test_torch_posterior_stats.py's tolerances).
POSTERIOR_RTOL = 1e-12
POSTERIOR_TF_RTOL = 1e-6
PINNED = "n0"            # MIN_X[0] == MAX_X[0]
# timeshift: tools/timeshift_demo on the bundled synthetic b8 s0 cache.
TIMESHIFT_ARGS = ("--profile", "synthetic", "--batch", "8", "--seed", "0", "--top", "1")


def phase(name, t0, msg):
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s  {msg}", flush=True)


def excitation_profiles(L, thickness, num=3):
    """Exp-shaped excitation densities [nm^-3] (as tests/test_pipeline.py)."""
    xg = (np.arange(L) + 0.5) * (thickness / L)
    return [(0.5 + c) * 1e18 / 1e7 ** 3 * np.exp(-xg / 100.0) for c in range(num)]


def decay_curves(T, time_ns, num, seed, t=None):
    """Seeded closed-form bi-exponential PL decays with 2% noise, in
    [nm^-2 ns^-1], at the times ``t`` [ns]; by default on the simulation
    grid t = k dt, k = 0..T."""
    rng = np.random.default_rng(seed)
    if t is None:
        t = np.arange(T + 1) * (time_ns / T)
    out = []
    for c in range(num):
        amp = 1e-4 * (1.0 + c)
        pl = amp * (0.6 * np.exp(-t / (15.0 + 5 * c)) + 0.4 * np.exp(-t / 400.0))
        out.append(pl * (1.0 + 0.02 * rng.standard_normal(t.size)))
    return t, out


def offgrid_times(T, time_ns):
    """t = 0 plus OFFGRID_POINTS log-spaced times [ns] from 0.7 dt to 0.4 dt
    before the horizon, as written to the CSV (6 decimals); none on the dt
    grid."""
    dt = time_ns / T
    t = np.concatenate([[0.0], np.geomspace(0.7 * dt, time_ns - 0.4 * dt,
                                            OFFGRID_POINTS)])
    t = np.round(t, 6)
    on_grid = np.abs(t[1:] / dt - np.round(t[1:] / dt)) < 1e-6
    if on_grid.any():
        raise AssertionError(f"{int(on_grid.sum())} off-grid times land on the grid")
    return t


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def clocks():
    """The card's SM and memory clocks, temperature and power draw now."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,"
                          "power.draw", "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (f"SM, memory clocks, temperature, power draw {out.stdout.strip()}"
            if out.returncode == 0 else "nvidia-smi failed")


class Recorder:
    """Wraps a horizon-kernel entry; keeps each call's inputs, outputs and
    synchronised wall time."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    def __call__(self, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args)
        torch.cuda.synchronize()
        self.calls.append((args, out, time.perf_counter() - t0))
        return out


def ladder_schedule(short):
    """(T, schedule) of the power_scan ladder (256 fine steps, then strides
    16/32/64 x 512, the last rung 862 steps), or of the shortened ladder of
    the plain comparisons (the same fine phase and strides, SHORT_RUNG_STEPS
    coarse steps per rung, the same dt)."""
    from bayesian_inference_trpl_tpu_torch.models.twophase import geometric_schedule
    g = POWER_SCAN
    if not short:
        return g["T"], geometric_schedule(
            g["T"], g["fast_fine_steps"], base_stride=g["fast_coarse_stride"],
            coarse_steps_per_phase=g["fast_steps_per_phase"],
            max_stride=g["fast_max_stride"])
    sched = ((1, g["fast_fine_steps"]),) + tuple(
        (s, s * SHORT_RUNG_STEPS) for s in (16, 32, 64))
    return sum(n for _, n in sched), sched


def ladder_inputs(num, dtype, seed, offgrid=False, method="fused_horizon_chord",
                  short=False, predictor="quadratic", L=None, sched=None,
                  throughput=False, pl_stride=0, state_stride=None):
    """One curve of the power_scan configuration at ``num`` samples, on the
    full or the shortened ladder (or ``sched``); with ``offgrid`` its
    observations at the log-spaced times, as slot tables.  ``predictor``
    and ``L`` replace power_scan's; ``throughput`` solves one fine phase of
    ``sched``'s length under the throughput chord profile (the exact
    mode's); ``pl_stride`` > 0 records the PL trace every pl_stride steps
    over one fine phase of ``sched``'s length, with no observations (the
    interpolation fallback's solve); ``state_stride`` also records the state
    every that many steps and the iteration trace (pvsim's solve).  Returns
    run(kernel), which solves it with ``method`` and the given horizon-kernel
    entry."""
    from bayesian_inference_trpl_tpu_torch import physics
    from bayesian_inference_trpl_tpu_torch.models.driver import SimParams, pl_log_scale
    from bayesian_inference_trpl_tpu_torch.models.solver import FusedObs
    from bayesian_inference_trpl_tpu_torch.utils import sampling
    g = POWER_SCAN
    L = L or g["L"]
    T, sched = ladder_schedule(short) if sched is None else (sum(n for _, n in sched), sched)
    time_ns = g["time"] * T / g["T"]
    sim = SimParams(length=g["thickness"], time=time_ns, L=L, T=T,
                    tol_exp=g["tol_exp"], max_iters=g["max_iters"],
                    method=method, predictor=predictor,
                    step_tol=g["step_tol"], fast_fine_steps=g["fast_fine_steps"],
                    fast_coarse_stride=g["fast_coarse_stride"],
                    fast_max_stride=g["fast_max_stride"],
                    fast_steps_per_phase=g["fast_steps_per_phase"])
    uc = physics.UNIT_CONVERSIONS
    X = sampling.random_grid(np.asarray(MIN_X) * uc, np.asarray(MAX_X) * uc,
                             DO_LOG, num, rng=np.random.RandomState(seed))
    dev = "cuda"
    mat = torch.as_tensor(physics.nondimensionalize(X[:, :12], sim.dx, sim.dt),
                          dtype=dtype, device=dev)
    dn = torch.as_tensor(excitation_profiles(L, g["thickness"])[1] * sim.dx ** 3,
                         dtype=dtype, device=dev)
    n0 = (mat[:, 0:1] + dn[None]).contiguous()
    p0 = (mat[:, 1:2] + dn[None]).contiguous()
    if offgrid:
        from bayesian_inference_trpl_tpu_torch.models.offgrid import (
            build_offgrid_tables, solve_offgrid)
        t = offgrid_times(T, time_ns)
        _, curves = decay_curves(T, time_ns, 1, seed, t)
        tables = build_offgrid_tables([t], [np.log10(curves[0])], sched, sim.dt)

        def run(kernel):
            solve_offgrid(mat, n0, p0, torch.zeros_like(n0), sim.solver_config(),
                          tables, sched, pl_log_scale(sim),
                          sys.float_info.min, kernel=kernel)
        return run
    if pl_stride:
        from bayesian_inference_trpl_tpu_torch.models.solver import solve
        cfg = sim.solver_config(state_stride)._replace(
            num_steps=sched[0][1], pl_stride=pl_stride, record_iters=bool(state_stride))

        def run(kernel):
            return solve(mat, n0, p0, torch.zeros_like(n0), cfg, kernel=kernel)
        return run
    from bayesian_inference_trpl_tpu_torch.models.twophase import solve_multiphase
    _, curves = decay_curves(T, time_ns, 1, seed)
    vals = torch.as_tensor(np.log10(curves[0])[None], dtype=dtype, device=dev)
    obs = FusedObs(values=vals, log_scale=pl_log_scale(sim),
                   min_val=sys.float_info.min)

    def run(kernel):
        if throughput:
            from bayesian_inference_trpl_tpu_torch.ops.horizon_kernel import solve_horizon_fused
            cfg = sim.solver_config()._replace(num_steps=sched[0][1], chord_strict=False)
            obs1 = obs._replace(values=obs.values[:, :sched[0][1] + 1])
            solve_horizon_fused(mat, n0, p0, cfg, obs1, e_init=torch.zeros_like(n0),
                                kernel=kernel)
            return
        solve_multiphase(mat, n0, p0, torch.zeros_like(n0), sim.solver_config(),
                         obs, sched, kernel=kernel)
    return run


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` on the card: one warm-up call,
    then CUDA events around ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def record(prm, args, **kw):
    states = bool(prm.state_stride or prm.record_iters)
    return dict(stride=prm.stride, K=prm.offgrid_k, chord=prm.chord,
                pl_stride=prm.pl_stride, states=states, steps=args[4].shape[1], args=args,
                label=(f"off-grid K {prm.offgrid_k:>2}" if prm.offgrid_k
                       else f"record every {prm.pl_stride}, states every "
                       f"{prm.state_stride}" if states
                       else f"record every {prm.pl_stride}" if prm.pl_stride
                       else f"stride {prm.stride:>2}"), **kw)


def compare_phase(hk, run, dtype_name):
    """Plain chain (group=1) on the card, then the kernel on each phase's
    recorded inputs.  Returns per-phase records."""
    plain = Recorder(functools.partial(hk.horizon_chord_plain, group=1))
    run(plain)
    recs = []
    for args, ref, plain_s in plain.calls:
        out = hk.horizon_chord(*args)
        torch.cuda.synchronize()
        recs.append(record(args[-1], args, ref=ref, out=out, plain_ms=plain_s * 1e3,
                           dtype=dtype_name))
    return recs


def time_phase(hk, run, reps=3):
    """The kernel alone on every phase of the full ladder: each launch's
    inputs recorded, then timed (warm-up + ``reps`` launches, CUDA events)."""
    rec = Recorder(hk.horizon_chord)
    run(rec)
    recs = []
    for args, out, _ in rec.calls:
        r = record(args[-1], args, out=out,
                   kernel_ms=cuda_ms(lambda: hk.horizon_chord(*args), reps))
        r["bound_ms"], r["bound_by"] = bound_ms(r, POWER_SCAN["L"], PEAK_FP32)
        recs.append(r)
    return recs


def check_f64(r):
    ref, out = r["ref"], r["out"]
    for name in ("conv", "its", "fulls", "execs", "maxit"):
        a, b = getattr(out, name), getattr(ref, name)
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"f64 {r['label']}: {name} differs on {bad} samples")
    err = 0.0
    for name in ("sse", "esum"):
        a, b = getattr(out, name), getattr(ref, name)
        both = torch.isfinite(a) & torch.isfinite(b)
        if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
            raise AssertionError(f"f64 {r['label']}: {name} finiteness differs")
        rel = ((a - b).abs() / b.abs().clamp_min(1e-300))[both]
        if rel.numel() and float(rel.max()) > F64_RTOL:
            raise AssertionError(f"f64 {r['label']}: {name} rel err "
                                 f"{float(rel.max()):.3e} > {F64_RTOL}")
        err = max(err, float((a - b).abs()[both].max()) if both.any() else 0.0)
    for name in ("n", "p", "e"):
        a, b = getattr(out, name), getattr(ref, name)
        if not torch.equal(a, b):
            bad = int((a != b).any(1).sum())
            raise AssertionError(f"f64 {r['label']}: final {name} not bitwise equal on "
                                 f"{bad} samples")
    return err


def state_rel(out, ref):
    """Largest relative difference of the final N and P."""
    return max(float(((getattr(out, k) - getattr(ref, k)).abs()
                      / getattr(ref, k).abs().clamp_min(1e-300)).max())
               for k in ("n", "p"))


def check_f32(r):
    ref, out = r["ref"], r["out"]
    conv_eq = float((out.conv == ref.conv).float().mean())
    both = out.conv & ref.conv & torch.isfinite(out.sse).all(0) & torch.isfinite(ref.sse).all(0)
    rel = ((out.sse - ref.sse).abs() / ref.sse.abs().clamp_min(1e-30)).amax(0)[both]
    within = float((rel <= F32_RTOL).float().mean()) if rel.numel() else 1.0
    if conv_eq < F32_MIN_SHARE or within < F32_MIN_SHARE:
        raise AssertionError(f"f32 {r['label']}: conv equal on {conv_eq:.4f}, "
                             f"sse within {F32_RTOL} on {within:.4f} (< {F32_MIN_SHARE})")
    return conv_eq, within, float(rel.max()) if rel.numel() else 0.0, \
        float((out.sse - ref.sse).abs().amax(0)[both].max()) if rel.numel() else 0.0


def bound_ms(r, L, peak):
    """Least time for this launch's work: operations over the peak rate vs
    bytes (inputs read once, outputs written once) over HBM bandwidth."""
    out = r["out"]
    batch = out.n.shape[0]
    ops = L * (r["steps"] * batch * OPS_STEP
               + float(out.execs.double().sum()) * OPS_ITER
               + float(out.fulls.double().sum()) * OPS_FULL)
    ops += r["steps"] * batch * out.sse.shape[0] * r["K"] * OPS_SLOT
    nbytes = sum(a.numel() * a.element_size() for a in r["args"][:9]
                 if isinstance(a, torch.Tensor))
    nbytes += sum(x.numel() * x.element_size() for x in out if x is not None)
    t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def write_main_inputs(tmp, num_points, seed, offgrid=False, method="fused_horizon_chord",
                      exact=False, grid_extra=None, profile_dir=None, num_curves=3,
                      dtype="float32", legacy_points=None):
    """Excitations, observations (on the grid, or at the off-grid times)
    and a TOML of the power_scan configuration with the solver ``method``,
    in ``tmp``; ``exact`` leaves out the ladder (no fast_* keys: exact
    fixed-dt mode) and takes the geometric predictor; ``grid_extra`` adds
    or replaces [grid] keys (power_scan's T and time among them; a
    step_tol of None leaves the key out); ``profile_dir`` sets [device]
    profile_dir; ``num_curves`` excitation curves; ``dtype`` [device] dtype;
    ``legacy_points`` samples the legacy grid (random_sample = false) at
    that many points per free dimension in place of ``num_points`` random
    ones.  n_devices = 1 (per process): a machine with more cards runs the
    same paths."""
    g = dict(POWER_SCAN)
    extra = dict(grid_extra or {})
    for k in list(extra):
        if k in g:
            g[k] = extra.pop(k)
    predictor = extra.pop("predictor", "geometric" if exact else "quadratic")
    ladder = "" if exact else f"""fast_fine_steps = {g['fast_fine_steps']}
fast_coarse_stride = {g['fast_coarse_stride']}
fast_max_stride = {g['fast_max_stride']}
fast_steps_per_phase = {g['fast_steps_per_phase']}
"""
    ladder += "".join(f"{k} = {json.dumps(v)}\n" for k, v in extra.items())
    profiles = excitation_profiles(g["L"], g["thickness"], num_curves)
    exc = os.path.join(tmp, "excitations.csv")
    obs = os.path.join(tmp, "observations.csv")
    with open(exc, "w") as f:
        for dn in profiles:
            f.write(",".join(f"{v / 1e-21:.8e}" for v in dn) + "\n")
    t = offgrid_times(g["T"], g["time"]) if offgrid else None
    t, curves = decay_curves(g["T"], g["time"], len(profiles), seed + 1, t)
    ts = [f"{x:.6f}" for x in t]
    with open(obs, "w") as f:
        for pl in curves:
            f.write("".join(f"{a},{b / 1e-23:.10e},1e13\n" for a, b in zip(ts, pl)))
        f.write("END,,\n")
    cfg = os.path.join(tmp, "smoke.toml")
    with open(cfg, "w") as f:
        f.write(f"""checkpoint = true
resume = false

[grid]
thickness = {g['thickness']}
time = {g['time']}
num_nodes = {g['L']}
num_steps = {g['T']}
pl_stride = 1
tol_exp = {g['tol_exp']}
max_iters = {g['max_iters']}
method = "{method}"
predictor = "{predictor}"
{"" if g['step_tol'] is None else f"step_tol = {g['step_tol']}"}
{ladder}
[params]
min_x = {MIN_X}
max_x = {MAX_X}
do_log = {DO_LOG}

[ic_flags]
time_cutoff = 2000.0

[sim_flags]
random_sample = {"false" if legacy_points else "true"}
num_points = {legacy_points or num_points}
log_pl = true
self_normalize = false
seed = {seed}

[device]
chunk_per_device = 1024
n_devices = 1
dtype = "{dtype}"
{f'profile_dir = "{profile_dir}"' if profile_dir else ""}

[paths]
init_file = "{exc}"
observation_files = ["{obs}"]
out_dirs = ["{os.path.join(tmp, 'out', 'smoke')}"]
""")
    return cfg


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-points", type=int, default=32768,
                    help="samples of the chord and full-Newton main paths "
                         "(power_scan: 131072); the full-Newton off-grid path "
                         "takes a quarter")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    from bayesian_inference_trpl_tpu_torch.models import solver
    from bayesian_inference_trpl_tpu_torch.ops import horizon_kernel as hk
    from bayesian_inference_trpl_tpu_torch.ops import kernel_lib
    from bayesian_inference_trpl_tpu_torch.ops import newton_kernel as nk
    from bayesian_inference_trpl_tpu_torch.run import main as run_main
    from bayesian_inference_trpl_tpu_torch.tools import warmup
    from bayesian_inference_trpl_tpu_torch.utils import io as bio

    name = torch.cuda.get_device_name(0)
    card_line = card()
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{card_line}", flush=True)

    # 1. build: the warmup tool on main's TOML builds the library at its
    # first launch
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="trpl_smoke_") as tmp:
        warmup.main([write_main_inputs(tmp, 1024, args.seed), "--device", "cuda"])
    lib = kernel_lib.build_info["path"]
    ptx = kernel_lib.ptxas_entries(kernel_lib.build_info.get("ptxas", ""))
    phase("build", t0, f"tools.warmup on main's TOML; nvcc "
          f"{kernel_lib.build_info['seconds']:.2f} s -> "
          f"{os.path.relpath(lib, os.path.dirname(os.path.abspath(__file__)))}"
          + ("" if ptx else " (cached: no ptxas report)"))
    for entry_name, regs, stores, loads, frame in ptx:
        print(f"  ptxas: {kernel_label(entry_name)}: {regs} registers, spill stores {stores} B, "
              f"spill loads {loads} B, stack frame {frame} B")

    err64, plain32, timing, counts = {}, {}, {}, {}
    paths = MainPaths(hk, nk, run_main, bio, args, counts)
    n_main = args.num_points
    # Launches per chunk and curve: one per phase of the ladder, or one per
    # BDF step (2,142 for power_scan).
    sched = ladder_schedule(False)[1]
    rungs, steps = len(sched) - 1, sum(n // s for s, n in sched)
    # 2-5. chord Newton: the on-grid modes and path, then the off-grid ones
    compare_modes(hk, "", "fused_horizon_chord", args.seed, err64, plain32, timing)
    paths.run("", "fused_horizon_chord", n_main, {"stride_1": 1, "stride_s": rungs})
    # main's inputs stopped and resumed; main's inputs with adaptive routing
    files_full = resume_phase(paths, args.seed)
    adaptive_phase(paths, n_main, args.seed)
    # more than one device and more than one process
    devices_split(paths)
    multiprocess_phase(args.seed, files_full)
    compare_modes(hk, "offgrid", "fused_horizon_chord", args.seed, err64, plain32, timing)
    paths.run("offgrid", "fused_horizon_chord", n_main, {"offgrid": rungs + 1})
    # 6-7. full Newton (fused_horizon), on-grid and off-grid
    compare_modes(hk, "", "fused_horizon", args.seed, err64, plain32, timing)
    paths.run("", "fused_horizon", n_main, {"stride_1_full": 1, "stride_s_full": rungs})
    compare_modes(hk, "offgrid", "fused_horizon", args.seed, err64, plain32, timing)
    paths.run("offgrid", "fused_horizon", n_main // 4, {"offgrid_full": rungs + 1})
    # 8-9. the per-step Newton kernel (coupled_newton_pallas)
    compare_newton_step(nk, solver, args.seed, err64, plain32, timing)
    print(f"  cut: main_newton_step {n_main // 8:,} -> {NEWTON_STEP_SAMPLES:,} samples "
          f"(pays for main_gauss_seidel)")
    walls = paths.run("", "coupled_newton_pallas", NEWTON_STEP_SAMPLES, {"newton_step": steps})
    if paths.last_replays != {"step": counts["newton_step"], "iteration": 0}:
        raise AssertionError(f"main_newton_step: replays {paths.last_replays}, expected one "
                             f"step graph per launch")
    step_wall_ms = 1e3 * walls / counts["newton_step"]
    step_kernel_ms = float(np.mean([r["kernel_ms"] for r in timing["newton_step"]]))
    print(f"  main_newton_step: wall per BDF step {step_wall_ms:.4f} ms (the CLI run over "
          f"its steps, graph route: one replay per step) = kernel {step_kernel_ms:.4f} ms "
          f"(CUDA events at chunk 1024, float32) + host, launch and the step's other "
          f"kernels {step_wall_ms - step_kernel_ms:.4f} ms")
    newton_step_routes(args.seed)
    # 10. what the main paths do not launch
    compare_variants(hk, nk, solver, args.seed)
    chord_refresh_cost(hk, args.seed)
    # 11-12. exact fixed-dt mode: kernel vs plain, one full launch, the CLI;
    # the record launch and the step loops of the interpolation fallback,
    # and its CLI path
    launch_s = compare_exact(hk, args.seed, err64, plain32, timing)
    record_s = compare_record(hk, args.seed, err64, plain32, timing)
    time_step_loops(args.seed, record_s)
    # the forward model's standalone mode: the record launch with the state
    # and iteration traces, pvsim through run_sweep, and the corner gate
    compare_record_states(hk, args.seed, err64, plain32)
    time_record_states(hk, args.seed, timing)
    main_pvsim(paths, args.seed)
    corner_gate(paths)
    # the reference scheme (Gauss-Seidel, no kernel) against full Newton
    gauss_seidel_phase(paths, hk, solver)
    # the legacy grid-refinement inference (record launches) and the
    # device sampler
    legacy_launches = legacy_phase(paths)
    device_sampler_phase(args.seed)
    # the posterior analysis: its histogram kernels, the CLI's report on
    # main's result with native ingest checked, and timeshift_demo
    hist = compare_hist(args.seed)
    hist_launches = main_posterior(paths, n_main, args.seed)
    timeshift_phase(paths)
    sizes = exact_sizes(time.perf_counter() - t_all, launch_s, record_s)
    paths.run("", "fused_horizon_chord", sizes["main_exact"], {"stride_1": 1}, exact=True)
    paths.run("interp", "fused_horizon_chord", sizes["main_interp"], {"stride_1_record": 1})
    counts["stride_1_record"] += legacy_launches
    # 13. the accuracy gate on the bundled exact caches
    gate_phase(hk)
    # 14. posterior equivalence, ladder against exact fixed-dt stepping
    for kind in ("", "offgrid"):
        posterior_phase(hk, kind, sizes["posterior" + ("_" + kind if kind else "")],
                        args.seed)
    # the trace, last (see PROFILE_RESERVE_S)
    profile_phase(paths, args.seed, card_line)
    # 15. how each entry sits on the card
    t0 = time.perf_counter()
    layouts = {m: entry_layout(hk, nk, m, timing[m], ptx) for m in timing}
    phase("layout", t0, "launch layout of every entry at chunk 1024, float32, L = 128")

    def entry(mode):
        t, p = timing[mode], plain32[mode]
        if mode == "newton_step":
            ident = dict(name="newton_step", source="bayesian_inference_trpl_tpu_torch/"
                         "csrc/newton_kernel.cu",
                         replaces="bayesian_inference_trpl_tpu/ops/pallas/newton_kernel.py:92",
                         wrapper_ms=float(np.mean([r["wrapper_ms"] for r in t])))
        else:
            body = "full" if mode.endswith(("_full", "_record", "_states")) else "chord"
            # The record outputs replace no pallas_call: the JAX package
            # records PL, states and iterations in its coupled_newton XLA
            # scan.
            ident = dict(name=f"horizon_{body}_{mode.replace('_full', '')}",
                         source="bayesian_inference_trpl_tpu_torch/csrc/horizon_kernel.cu",
                         replaces=("bayesian_inference_trpl_tpu/models/solver.py:367"
                                   if mode.endswith("_record") else
                                   "bayesian_inference_trpl_tpu/models/solver.py:411"
                                   if mode.endswith("_states") else
                                   "bayesian_inference_trpl_tpu/ops/pallas/horizon_kernel.py:887"))
        return dict(
            ident, route="cuda", launches=counts[mode], max_abs_err=err64[mode],
            ms=float(np.mean([r["kernel_ms"] for r in t])),
            plain_ms=float(np.mean([r["plain_ms"] for r in p])),
            bound_ms=float(np.mean([r["bound_ms"] for r in t])),
            bound_by=t[0]["bound_by"], library_ms=None,
            steps=float(np.mean([r["steps"] for r in t])),
            plain_steps=float(np.mean([r["steps"] for r in p])), **layouts[mode])

    print(json.dumps({"kernels": [entry(m) for m in (
        "stride_1", "stride_s", "offgrid", "stride_1_full", "stride_s_full",
        "offgrid_full", "stride_1_exact", "stride_1_record", "stride_1_record_states",
        "newton_step")] + [dict(r, launches=hist_launches[r["name"]]) for r in hist]}))
    phase("total", t_all, "")
    print(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


def kernel_label(mangled):
    """A readable name for a kernel entry of the ptxas report."""
    m = re.search(r"horizon_kernelI([fd])Li(\d+)ELi(\d+)ELi(\d+)EE", mangled)
    if m:
        dt, jc, mode, newton = m.groups()
        return (f"horizon {('chord', 'full')[int(newton)]} "
                f"{('stride1', 'strides', 'offgrid')[int(mode)]} "
                f"{'f32' if dt == 'f' else 'f64'} "
                + ("L=128" if jc == "4" else "any L"))
    m = re.search(r"newton_step_kernelI([fd])Li(\d+)EE", mangled)
    if m:
        dt, jc = m.groups()
        return f"newton_step {'f32' if dt == 'f' else 'f64'} " + (
            "L=128" if jc == "4" else "any L")
    return mangled


def entry_layout(hk, nk, mode, recs, ptx):
    """Print and return the launch layout of one entry of the kernels line
    at chunk 1024, float32, L = 128: for the horizon kernel at each phase's
    stride or K of the timed ladder (the accumulators grow with them)."""
    L, batch = POWER_SCAN["L"], 1024
    if mode == "newton_step":
        lays = [nk.launch_layout(batch, L)]
        pat = "newton_step_kernelIfLi4EE"
    else:
        lays = [hk.launch_layout(batch, L, r["out"].sse.shape[0], r["stride"], r["K"],
                                 r["chord"]) for r in recs]
        pat = "horizon_kernelIfLi4ELi{}ELi{}EE".format(
            MODE_ARG[re.sub(r"_(full|exact|record|states)", "", mode)],
            int(mode.endswith(("_full", "_record", "_states"))))
    spill = [(regs, st, ld) for name, regs, st, ld, _ in ptx if pat in name]
    lo = min(lays, key=lambda d: d["samples_per_sm"])
    print(f"  layout {mode}: {lo['samples_per_block']} samples per block of "
          f"{lo['threads_per_block']} threads, "
          + ", ".join(f"{d['smem_per_block']} B" for d in lays)
          + f" shared memory per block; {lo['blocks_per_sm']} blocks = "
          f"{lo['samples_per_sm']} samples per SM on {lo['sms']} SMs; "
          f"{lo['registers']} registers, {lo['local_bytes']} B local memory per thread; "
          f"waves per launch at {batch}: {max(d['waves'] for d in lays):.3f}"
          + (f"; ptxas spill stores {spill[0][1]} B, loads {spill[0][2]} B"
             if spill else ""))
    return dict(registers=lo["registers"], samples_per_block=lo["samples_per_block"],
                samples_per_sm=lo["samples_per_sm"],
                waves=max(d["waves"] for d in lays),
                spill_stores=spill[0][1] if spill else None)


def newton_step_routes(seed):
    """The graph route against the eager loop for coupled_newton_pallas on
    the first NEWTON_CHECK_STEPS steps of the ladder at 1024 samples,
    float64 and float32, recording PL: bitwise; the time per step of each."""
    t0 = time.perf_counter()
    for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
        run = ladder_inputs(1024, dtype, seed, method="coupled_newton_pallas",
                            sched=((1, NEWTON_CHECK_STEPS),), pl_stride=1)
        eager_s, graph_s, rp, _ = hold_routes(lambda: run(None), f"{tag} newton_step check")
        if rp != {"step": NEWTON_CHECK_STEPS, "iteration": 0}:
            raise AssertionError(f"{tag} newton_step check: replays {rp}")
        print(f"  {tag} coupled_newton_pallas graph route vs eager loop, "
              f"{NEWTON_CHECK_STEPS} steps x 1024 samples: N/P/E, PL trace, its and flags "
              f"bitwise; eager {1e3 * eager_s / NEWTON_CHECK_STEPS:.4f} ms per step, graph "
              f"{1e3 * graph_s / NEWTON_CHECK_STEPS:.4f} ms per step")
    phase("newton_step_routes", t0, "the step graph against the eager loop")


def compare_variants(hk, nk, solver, seed):
    """Kernel vs plain (group=1) on VARIANT_SCHED for every VARIANTS entry,
    float64 (64 samples unless ``num``: counts equal, final state bitwise)
    and float32 (1024 samples unless ``num``: F32_* thresholds); then the
    per-step kernel at a batch of 1001 against coupled_newton_step."""
    t0 = time.perf_counter()
    for name, method, kw in VARIANTS:
        kw = dict(kw)
        num = kw.pop("num", None)
        msgs = []
        for dtype, tag, n in ((torch.float64, "f64", num or 64),
                              (torch.float32, "f32", num or 1024)):
            run = ladder_inputs(n, dtype, seed, method=method, sched=VARIANT_SCHED, **kw)
            recs = compare_phase(hk, run, tag)
            if tag == "f64":
                for r in recs:
                    check_f64(r)
                msgs.append(f"f64 x {n}: {len(recs)} launches, counts equal, "
                            f"N/P/E bitwise")
            else:
                worst = min((check_f32(r)[:2] for r in recs), key=min)
                msgs.append(f"f32 x {n}: conv equal {worst[0]:.4f}, sse within "
                            f"{F32_RTOL} {worst[1]:.4f}")
        print(f"  variant {name} ({method}, {kw or 'power_scan'}): " + "; ".join(msgs),
              flush=True)
    # The per-step kernel at a batch that is not a multiple of 4.
    from bayesian_inference_trpl_tpu_torch.models import step_graph
    from bayesian_inference_trpl_tpu_torch.models.newton import coupled_newton_step
    steps, orig = [], solver.newton_step

    def rec(*a, **kw):
        if len(steps) < 88:
            steps.append((tuple(x.clone() if isinstance(x, torch.Tensor) else x
                                for x in a[:5]) + a[5:], dict(kw)))
        return orig(*a, **kw)
    solver.newton_step = rec
    try:
        with step_graph.route("eager"):
            ladder_inputs(1001, torch.float64, seed, method="coupled_newton_pallas",
                          sched=VARIANT_SCHED)(None)
    finally:
        solver.newton_step = orig
    for a, kw in steps[::8]:
        out, ref = nk.newton_step(*a, **kw), coupled_newton_step(*a, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(out, ref)):
            raise AssertionError("f64 newton_step at batch 1001 differs from "
                                 "coupled_newton_step")
    print(f"  variant newton_step_tail_1001: f64 x 1001, {len(steps[::8])} recorded "
          f"steps, N/P/E bitwise, its/conv equal")
    phase("compare_variants", t0, "kernel vs plain(group=1) where the main paths "
          "do not go")


def compare_exact(hk, seed, err64, plain32, timing):
    """Exact fixed-dt mode's launch (stride 1, throughput chord profile,
    geometric predictor): kernel vs plain (group=1) on a shortened phase,
    float64 at 64 samples and float32 at 1024, then one launch over the
    whole horizon at chunk 1024, timed (warm-up + 1 launch, CUDA events).
    Returns that launch's seconds."""
    mode = "stride_1_exact"
    kw = dict(predictor="geometric", throughput=True)
    t0 = time.perf_counter()
    for dtype, tag, n in ((torch.float64, "f64", 64), (torch.float32, "f32", 1024)):
        (r,) = compare_phase(hk, ladder_inputs(n, dtype, seed, sched=EXACT_SHORT_SCHED,
                                               **kw), tag)
        prm = r["args"][-1]
        if (prm.stride, prm.settle_guard, prm.pred_order) != (1, hk.CHORD_SETTLE_GUARD, 3):
            raise AssertionError(f"exact mode launched {prm}")
        if tag == "f64":
            err64[mode] = check_f64(r)
            msg = f"conv/its/fulls/execs equal, max abs err {err64[mode]:.3e}, N/P/E bitwise"
        else:
            conv_eq, within, rmax, _ = check_f32(r)
            plain32[mode] = [r]
            msg = (f"conv equal {conv_eq:.4f}, sse within {F32_RTOL}: {within:.4f} "
                   f"(max rel {rmax:.2e}); plain {r['plain_ms']:.1f} ms")
        print(f"  {tag} exact x {r['steps']} steps, {n} samples: {msg}")
    phase("compare_exact", t0, "kernel vs plain(group=1), throughput profile, geometric")

    t0 = time.perf_counter()
    (r,) = time_phase(hk, ladder_inputs(1024, torch.float32, seed, sched=EXACT_SCHED, **kw),
                      reps=1)
    timing[mode] = [r]
    out = r["out"]
    print(f"  kernel f32 exact x {r['steps']} steps, 1024 samples: {r['kernel_ms']:.3f} ms, "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
          f"{100 * r['bound_ms'] / r['kernel_ms']:.1f}% of it reached); "
          f"conv {int(out.conv.sum())}/1024, its/sample {float(out.its.float().mean()):.1f}, "
          f"execs/sample {float(out.execs.float().mean()):.1f}, "
          f"fulls/sample {float(out.fulls.float().mean()):.1f}")
    phase("time_exact", t0, "one exact-mode launch over the whole horizon at chunk 1024")
    return r["kernel_ms"] / 1e3


def exact_sizes(elapsed_s, launch_s, record_s):
    """Samples of main_exact, of the two posterior runs and of main_interp:
    EXACT_SAMPLES and INTERP_SAMPLES, cut in EXACT_CUTS's order while the
    projected script time (each exact-mode launch ``launch_s``, each record
    launch ``record_s``, each run RUN_OVERHEAD_S, the gate phase alike, and
    main_profile's PROFILE_RESERVE_S) passes BUDGET_S.  Prints the cuts not
    taken and the seconds they add against every cut taken."""
    sizes = {"main_exact": EXACT_SAMPLES, "posterior": EXACT_SAMPLES,
             "posterior_offgrid": EXACT_SAMPLES, "main_interp": INTERP_SAMPLES}

    def projected(sz):
        secs = sum(3 * -(-n // 1024) * (record_s if name == "main_interp" else launch_s)
                   for name, n in sz.items())
        return elapsed_s + secs + (len(sz) + 1) * RUN_OVERHEAD_S + PROFILE_RESERVE_S

    all_cut = dict(sizes, **dict(EXACT_CUTS))
    taken = 0
    for name, n in EXACT_CUTS:
        if projected(sizes) <= BUDGET_S:
            break
        print(f"  cut: projected {projected(sizes):.0f} s > {BUDGET_S:.0f} s: {name} "
              f"{sizes[name]} -> {n} samples")
        sizes[name] = n
        taken += 1
    if taken < len(EXACT_CUTS):
        print(f"  lifted: {', '.join(f'{name} -> {n}' for name, n in EXACT_CUTS[taken:])} "
              f"not cut; they add {projected(sizes) - projected(all_cut):.2f} s (projected)")
    print(f"  exact-mode and interpolation sizes {sizes}; projected total "
          f"{projected(sizes):.0f} s (exact launch {launch_s:.2f} s, record launch "
          f"{record_s:.2f} s at chunk 1024)")
    return sizes


def compare_record(hk, seed, err64, plain32, timing):
    """The record launch (full Newton at stride 1 recording the PL trace, no
    observations; the interpolation fallback's solve): kernel vs plain
    (group = 1) on a 256-step phase, float64 at 64 samples every 1 and every
    4 steps (counts equal, N/P/E bitwise, trace within RECORD_F64_RTOL) and
    float32 at 1024 (F32_* on conv and the trace); then one launch over the
    whole horizon at chunk 1024, timed (warm-up + 1 launch, CUDA events).
    Returns that launch's seconds."""
    mode = "stride_1_record"
    t0 = time.perf_counter()
    for pl_stride in (1, 4):
        (r,) = compare_phase(hk, ladder_inputs(64, torch.float64, seed, sched=RECORD_SHORT_SCHED,
                                               pl_stride=pl_stride), "f64")
        check_f64(r)
        out, ref = r["out"], r["ref"]
        rel = float(((out.pl - ref.pl).abs() / ref.pl.abs().clamp_min(1e-300)).max())
        if out.pl.shape != (64, 256 // pl_stride + 1) or rel > RECORD_F64_RTOL:
            raise AssertionError(f"f64 record every {pl_stride}: trace {tuple(out.pl.shape)}, "
                                 f"rel err {rel:.3e} > {RECORD_F64_RTOL}")
        err64[mode] = max(err64.get(mode, 0.0), float((out.pl - ref.pl).abs().max()))
        print(f"  f64 record every {pl_stride} x 256 steps, 64 samples: conv/its/fulls/execs "
              f"equal, N/P/E bitwise, trace {tuple(out.pl.shape)} max rel err {rel:.3e}, "
              f"conv {int(out.conv.sum())}/64")
    (r,) = compare_phase(hk, ladder_inputs(1024, torch.float32, seed, sched=RECORD_SHORT_SCHED,
                                           pl_stride=1), "f32")
    out, ref = r["out"], r["ref"]
    conv_eq = float((out.conv == ref.conv).float().mean())
    rel = ((out.pl - ref.pl).abs() / ref.pl.abs().clamp_min(1e-30)).amax(1)[out.conv & ref.conv]
    within = float((rel <= F32_RTOL).float().mean()) if rel.numel() else 0.0
    if conv_eq < F32_MIN_SHARE or within < F32_MIN_SHARE:
        raise AssertionError(f"f32 record: conv equal on {conv_eq:.4f}, trace within "
                             f"{F32_RTOL} on {within:.4f} (< {F32_MIN_SHARE})")
    plain32[mode] = [r]
    print(f"  f32 record x 256 steps, 1024 samples: conv equal {conv_eq:.4f}, trace within "
          f"{F32_RTOL}: {within:.4f} (max rel {float(rel.max()):.2e}); plain "
          f"{r['plain_ms']:.1f} ms")
    phase("compare_record", t0, "record kernel vs plain(group=1)")

    t0 = time.perf_counter()
    (r,) = time_phase(hk, ladder_inputs(1024, torch.float32, seed, sched=EXACT_SCHED,
                                        pl_stride=1), reps=1)
    timing[mode] = [r]
    out = r["out"]
    print(f"  kernel f32 record x {r['steps']} steps, 1024 samples: {r['kernel_ms']:.3f} ms, "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
          f"{100 * r['bound_ms'] / r['kernel_ms']:.1f}% of it reached; the trace "
          f"{out.pl.numel() * out.pl.element_size() / 1e6:.1f} MB alone "
          f"{out.pl.numel() * out.pl.element_size() / HBM_BYTES_PER_S * 1e3:.4f} ms); "
          f"conv {int(out.conv.sum())}/1024, its/sample {float(out.its.float().mean()):.1f}, "
          f"finite trace {bool(torch.isfinite(out.pl).all())}")
    phase("time_record", t0, "one record launch over the whole horizon at chunk 1024")
    return r["kernel_ms"] / 1e3


def time_step_loops(seed, record_s):
    """The step-loop route of solve(record_pl=True) (coupled_newton: plain
    PyTorch steps; coupled_newton_pallas: one per-step kernel launch per
    step) at chunk 1024 in float32, timed per step on a short horizon on
    the eager route and on the graph route (bitwise the same), against the
    record launch's time per step; then the graph route's steady state
    (the steps after STEADY_SKIP, every piece a replay): host and device
    ms per step."""
    t0 = time.perf_counter()
    per_step = record_s * 1e3 / POWER_SCAN["T"]
    for method, steps in STEP_LOOP_STEPS:
        run = ladder_inputs(1024, torch.float32, seed, method=method, sched=((1, steps),),
                            pl_stride=1)
        with timed_runners() as runners:
            eager_s, graph_s, _, res = hold_routes(lambda: run(None), f"{method} step loop")
        if res.pl.shape != (1024, steps + 1):
            raise AssertionError(f"{method} step loop: trace {tuple(res.pl.shape)}")
        for name, secs in (("eager", eager_s), ("graph", graph_s)):
            ms = secs * 1e3 / steps
            print(f"  step loop {method} ({name} route), record_pl, {steps} steps at chunk "
                  f"1024: {ms:.4f} ms per step = {ms / per_step:.0f}x the record launch's "
                  f"{per_step:.5f} ms; {POWER_SCAN['T']} steps would take "
                  f"{ms * POWER_SCAN['T'] / 1e3:.0f} s")
        (runner,) = [r for r in runners if r.calls]
        st = steady_steps(runner, STEADY_SKIP)
        print(f"  step loop {method} (graph route), steady state over {st['steps']} of steps "
              f"{STEADY_SKIP}-{steps - 2} (no capture in them): {st['host_ms']:.4f} ms per "
              f"step on the host clock, {st['device_ms']:.4f} ms in the replays on the card "
              f"(device / "
              f"host {st['device_ms'] / st['host_ms']:.3f}: near 1 the card's work bounds "
              f"the loop, above 1 the host submits ahead of it); "
              f"{st['iters']:.2f} iterations per step"
              + (f", {st['device_ms'] / st['iters']:.4f} ms on the card per iteration "
                 "(the step's other pieces included)" if st["iters"] else ""))
    phase("time_step_loops", t0, "the step-loop route per step, for the ratio; the graph "
          "route bitwise the eager one; its steady state on the host and on the card")


def chord_refresh_cost(hk, seed):
    """The plain chord chain's Jacobian refresh on the graph route, on
    VARIANT_SCHED's first phase at 1024 samples in float32, group 1: as
    built (the host reads before each iteration whether some group asks,
    and replays the iteration's graph with the refresh or without it),
    against the refresh computed on every iteration and taken by the rows
    that ask (the device work of a loop that never reads the choice
    back): the chain's wall, the iterations with a refresh, and the device
    ms of an iteration's replay with and without it."""
    t0 = time.perf_counter()
    base = hk._Chord

    class EveryIteration(base):
        def variant(self, i):
            v = super().variant(i)
            return None if v is None else (v[0], True)

    kernel = functools.partial(hk.horizon_chord_plain, group=1)
    walls = {}
    for name, cls in (("as built", base), ("refresh every iteration", EveryIteration)):
        hk._Chord = cls
        try:
            with timed_runners() as runners:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                ladder_inputs(1024, torch.float32, seed, sched=VARIANT_SCHED[:1])(kernel)
                torch.cuda.synchronize()
                walls[name] = time.perf_counter() - t1
        finally:
            hk._Chord = base
        torch.cuda.synchronize()
        ms = {True: [], False: []}
        for r in runners:
            for key, captured, _, ev in r.calls:
                if key[0] == "chord" and not captured:
                    ms[key[1][1]].append(ev[0].elapsed_time(ev[1]))
        n = len(ms[True]) + len(ms[False])
        print(f"  chord chain (graph route), {name}: {walls[name]:.3f} s; {n} replayed "
              f"iterations, {len(ms[True])} with the refresh; a replay on the card "
              + ", ".join(f"{'with' if k else 'without'} it {np.mean(v):.4f} ms"
                          for k, v in ms.items() if v))
    print(f"  chord chain: as built {walls['as built'] / walls['refresh every iteration']:.3f}"
          f" of the wall with the refresh on every iteration")
    phase("chord_refresh_cost", t0, "the plain chord chain's Jacobian refresh on the card")


def compare_record_states(hk, seed, err64, plain32):
    """The record launch with the state and iteration traces (pvsim's
    solve): kernel vs plain (group = 1) on the 256-step phase, float64 at 64
    samples for each RECORD_STATES_F64 pair (counts and iteration traces
    equal, frames and final N/P/E bitwise, PL within RECORD_F64_RTOL) and
    float32 at 1024 (iteration traces equal on F32_MIN_SHARE of the samples,
    their frames within RECORD_STATES_F32_RTOL)."""
    mode = "stride_1_record_states"
    L = POWER_SCAN["L"]
    t0 = time.perf_counter()
    for pl_stride, rss in RECORD_STATES_F64:
        (r,) = compare_phase(hk, ladder_inputs(64, torch.float64, seed, sched=RECORD_SHORT_SCHED,
                                               pl_stride=pl_stride, state_stride=rss), "f64")
        check_f64(r)
        out, ref = r["out"], r["ref"]
        every = pl_stride * rss // int(np.gcd(pl_stride, rss))
        T, batch = r["steps"], out.n.shape[0]
        if (out.states.shape != (T // every, 3, batch, L)
                or out.iters.shape != (batch, T // pl_stride)):
            raise AssertionError(f"f64 {r['label']}: traces {tuple(out.states.shape)} "
                                 f"{tuple(out.iters.shape)}")
        if not (torch.equal(out.states, ref.states) and torch.equal(out.iters, ref.iters)):
            raise AssertionError(f"f64 {r['label']}: state or iteration trace not bitwise "
                                 f"the plain version's")
        rel = float(((out.pl - ref.pl).abs() / ref.pl.abs().clamp_min(1e-300)).max())
        if rel > RECORD_F64_RTOL:
            raise AssertionError(f"f64 {r['label']}: PL rel err {rel:.3e}")
        err64[mode] = max(err64.get(mode, 0.0), float((out.pl - ref.pl).abs().max()))
        print(f"  f64 {r['label']} x {T} steps, {batch} samples: counts and iteration traces "
              f"equal, {out.states.shape[0]} frames and N/P/E bitwise, PL max rel err "
              f"{rel:.3e}, worst per-point iterations {int(out.iters.max())}")
    pl_stride, rss = RECORD_STATES_F32
    (r,) = compare_phase(hk, ladder_inputs(1024, torch.float32, seed, sched=RECORD_SHORT_SCHED,
                                           pl_stride=pl_stride, state_stride=rss), "f32")
    out, ref = r["out"], r["ref"]
    same = (out.iters == ref.iters).all(1)
    scale = ref.states.abs()
    scale[:, 2] = scale[:, 2].amax(-1, keepdim=True).expand(-1, -1, scale.shape[-1])
    rel = ((out.states - ref.states).abs() / scale.clamp_min(1e-30))[:, :, same]
    share, worst = float(same.float().mean()), float(rel.max()) if rel.numel() else 0.0
    if share < F32_MIN_SHARE or worst > RECORD_STATES_F32_RTOL:
        raise AssertionError(f"f32 {r['label']}: iteration traces equal on {share:.4f}, "
                             f"their frames within {worst:.2e}")
    plain32[mode] = [r]
    print(f"  f32 {r['label']} x {r['steps']} steps, {out.n.shape[0]} samples: iteration "
          f"traces equal on "
          f"{share:.4f}, their frames max rel diff {worst:.2e} (<= "
          f"{RECORD_STATES_F32_RTOL}); plain {r['plain_ms']:.1f} ms")
    phase("compare_record_states", t0, "record kernel with state and iteration traces vs "
          "plain(group=1)")


def time_record_states(hk, seed, timing):
    """One record launch with both traces at main_pvsim's shape (1024
    samples, 80,000 steps, PL and state every PVSIM_STRIDE steps, float32),
    timed (warm-up + 1 launch, CUDA events).  What the traces cost (+0.7-1.6%
    in turns with and without them, PERF.md section 6) is timing-only work
    for the port's bench, not re-measured here."""
    mode = "stride_1_record_states"
    t0 = time.perf_counter()
    (r,) = time_phase(hk, ladder_inputs(1024, torch.float32, seed, sched=EXACT_SCHED,
                                        pl_stride=PVSIM_STRIDE, state_stride=PVSIM_STRIDE),
                      reps=1)
    timing[mode] = [r]
    out = r["out"]
    mb = out.states.numel() * out.states.element_size() / 1e6
    print(f"  kernel f32 {r['label']} x {r['steps']} steps, {out.n.shape[0]} samples: "
          f"{r['kernel_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
          f"{100 * r['bound_ms'] / r['kernel_ms']:.1f}% of it reached; the state trace "
          f"{tuple(out.states.shape)} {mb:.1f} MB alone "
          f"{mb * 1e6 / HBM_BYTES_PER_S * 1e3:.4f} ms); conv {int(out.conv.sum())}/"
          f"{out.n.shape[0]}, "
          f"its/sample {float(out.its.float().mean()):.1f}, finite frames "
          f"{bool(torch.isfinite(out.states).all())}")
    phase("time_record_states", t0, "one record launch with both traces at chunk 1024")


def main_pvsim(paths, seed):
    """The forward model's standalone mode at full width: ``python -m
    ...tools.run_sweep`` (its main, in this process) on a sweep npz of
    PVSIM_SAMPLES production-box samples on power_scan's grid, method
    fused_horizon, float32, --device cuda: exactly one record launch with
    the state and iteration traces.  Its PL trace must agree with the PL
    of its state snapshots at the snapshot steps."""
    from bayesian_inference_trpl_tpu_torch.tools import run_sweep
    from bayesian_inference_trpl_tpu_torch.tools.accuracy_gate import sample_production_box
    g = POWER_SCAN
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="trpl_smoke_") as tmp:
        sweep, out = os.path.join(tmp, "sweep.npz"), os.path.join(tmp, "pvsim.npz")
        np.savez(sweep, mat_par=sample_production_box(PVSIM_SAMPLES, seed),
                 length=g["thickness"], time=g["time"], L=g["L"], T=g["T"],
                 tol_exp=g["tol_exp"], max_iters=g["max_iters"], init_mode="exp",
                 ini_par=np.array([1e18 / 1e7 ** 3, 100.0]))
        print(f"  main_pvsim: {PVSIM_SAMPLES} production-box samples, L {g['L']}, "
              f"{g['T']} steps of {g['time'] / g['T'] * 1e3:g} ps, exp initial condition, "
              f"tol_exp {g['tol_exp']}, max_iters {g['max_iters']}, float32, method "
              f"fused_horizon", flush=True)
        paths.zero()
        t1 = time.perf_counter()
        run_sweep.main([sweep, out, "--method", "fused_horizon", "--dtype", "float32",
                        "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launched = {k: v for k, v in paths.launches().items() if v}
        res = dict(np.load(out))
    if launched != {"stride_1_record_states": 1}:
        raise AssertionError(f"main_pvsim launched {launched}, expected one record launch "
                             f"with states")
    paths.counts["stride_1_record_states"] = 1
    n, L = PVSIM_SAMPLES, g["L"]
    steps = res["times"] / (g["time"] / g["T"])
    shapes = {k: res[k].shape for k in ("N", "P", "E", "pl")}
    if shapes != {"N": (n, 6, L), "P": (n, 6, L), "E": (n, 6, L),
                  "pl": (n, g["T"] // PVSIM_STRIDE + 1)}:
        raise AssertionError(f"main_pvsim shapes {shapes}")
    conv = res["converged"]
    finite = all(np.isfinite(res[k][conv]).all() for k in ("N", "P", "E", "pl"))
    if not finite or conv.mean() < 0.99:
        raise AssertionError(f"main_pvsim: converged share {conv.mean():.4f}, finite "
                             f"{finite}")
    mat = res["mat_par"]
    dx = g["thickness"] / L
    pl_snap = (mat[:, 4:5] * (res["N"] * res["P"] - (mat[:, 0] * mat[:, 1])[:, None, None])
               .sum(-1) * dx)
    pl_at = res["pl"][:, np.rint(steps / PVSIM_STRIDE).astype(int)]
    diff = np.abs(pl_snap - pl_at)
    ok = diff <= PVSIM_PL_RTOL * (np.abs(pl_at) + 1e-6 * np.abs(res["pl"][:, :1]))
    if not ok[conv].all():
        raise AssertionError(f"main_pvsim: PL trace and state snapshots disagree at "
                             f"{int((~ok[conv]).sum())} points")
    rel = (diff / np.abs(pl_at))[conv & (np.abs(pl_at) > 1e-6 * np.abs(res["pl"][:, :1])).all(1)]
    phase("main_pvsim", t0, f"run_sweep --device cuda: {n} samples x {g['T']} steps in "
          f"{wall:.2f} s ({n / wall * 60:.0f} sims/min), one record launch; converged "
          f"{conv.mean():.4f}; snapshots at steps {steps.astype(int).tolist()} agree with "
          f"the PL trace (max rel {float(rel.max()) if rel.size else 0.0:.2e})")


def gauss_seidel_grid():
    """[grid] keys of main_gauss_seidel (see GS_T)."""
    return dict(T=GS_T, time=POWER_SCAN["time"] * GS_T / POWER_SCAN["T"], tol_exp=7.0,
                max_iters=GS_MAX_ITERS, step_tol=None, predictor="previous")


def hold_routes(run, label):
    """``run()`` (a solve) on the eager route, then on the graph route (the
    default on the card): every output bitwise equal.  Returns (eager s,
    graph s, the graph run's replays, the eager result)."""
    from bayesian_inference_trpl_tpu_torch.models import step_graph
    secs = []
    for name in ("eager", None):
        torch.cuda.synchronize()
        before = dict(step_graph.replays)
        t0 = time.perf_counter()
        with step_graph.route(name) if name else contextlib.nullcontext():
            out = run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if name:
            ref = out
    replays = {k: v - before[k] for k, v in step_graph.replays.items()}
    for field, a, b in zip(ref._fields, ref, out):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            same = x is None and y is None or (
                x is not None and y is not None and x.shape == y.shape
                and torch.equal(torch.isnan(x), torch.isnan(y))
                and torch.equal(x.nan_to_num(0.0), y.nan_to_num(0.0)))
            if not same:
                raise AssertionError(f"{label}: graph route's {field} not bitwise the "
                                     f"eager route's")
    return secs[0], secs[1], replays, ref


@contextlib.contextmanager
def timed_runners():
    """Every models/step_graph.StepRunner made in the block (models/solver,
    twophase and offgrid and ops/horizon_kernel make them) records each
    piece it runs on the graph route: its key, whether that call captured
    it, the host clock at the call, and CUDA events around the replay
    (device time: the stream is idle when a host-bound loop submits it).
    Yields the list of runners."""
    from bayesian_inference_trpl_tpu_torch.models import offgrid, solver, step_graph, twophase
    from bayesian_inference_trpl_tpu_torch.ops import horizon_kernel
    made, base = [], step_graph.StepRunner

    class Timed(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.calls = []
            made.append(self)

        def run(self, key, fn, kind="step"):
            if self.route != "graph":
                return super().run(key, fn, kind)
            captured = key not in self.graphs
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t = time.perf_counter()
            ev[0].record()
            super().run(key, fn, kind)
            ev[1].record()
            self.calls.append((key, captured, t, ev))

    mods = (solver, twophase, offgrid, horizon_kernel)
    for m in mods:
        m.StepRunner = Timed
    try:
        yield made
    finally:
        for m in mods:
            m.StepRunner = base


def steady_steps(runner, skip):
    """The graph route's steady state over a timed runner's steps after
    the first ``skip`` (by then every step class is captured), each step
    with no capture in it (a Newton loop's final-check variant may first
    come later): host ms per step (between the starts of successive
    steps), device ms per step (the replays' events) and iterations per
    step, means over those steps."""
    torch.cuda.synchronize()
    calls = runner.calls
    starts = [i for i, c in enumerate(calls) if c[0][0] in ("start", "step")]
    host = dev = iters = 0.0
    n = 0
    for lo, hi in zip(starts[skip:], starts[skip + 1:]):
        window = calls[lo:hi]
        if any(c[1] for c in window):
            continue
        n += 1
        host += (calls[hi][2] - calls[lo][2]) * 1e3
        dev += sum(ev[0].elapsed_time(ev[1]) for _, _, _, ev in window)
        iters += sum(1 for c in window if c[0][0] in ("newton", "chord"))
    if not n:
        raise AssertionError("steady_steps: every step after the first captured a piece")
    return dict(steps=n, host_ms=host / n, device_ms=dev / n, iters=iters / n)


def gauss_seidel_phase(paths, hk, solver):
    """main_gauss_seidel: the reference scheme through the CLI, then the
    same TOML with fused_horizon (one full-Newton launch); the checks and
    figures of GS_T's comment; then the graph route against the eager loop
    on the first GS_CHECK_STEPS steps of the same samples (GS_CHECK_STEPS)."""
    from bayesian_inference_trpl_tpu_torch import physics
    from bayesian_inference_trpl_tpu_torch.models import step_graph, trpl
    from bayesian_inference_trpl_tpu_torch.models.driver import SimParams
    from bayesian_inference_trpl_tpu_torch.parallel import runner as runner_mod
    from bayesian_inference_trpl_tpu_torch.tools.posterior_equivalence import (
        compare_posteriors)
    from bayesian_inference_trpl_tpu_torch.utils import sampling
    t0 = time.perf_counter()
    n = GS_LEGACY_POINTS ** sum(lo != hi for lo, hi in zip(MIN_X, MAX_X))
    print(f"  cut: T {POWER_SCAN['T']:,} -> {GS_T:,} steps (dt 25 ps) for main_gauss_seidel; "
          f"max_iters {GS_MAX_ITERS}; {n} legacy-grid samples, one curve", flush=True)
    # The step loop's wall: the solve of the one chunk, synchronised.
    solves, solve = [], runner_mod.solve

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = solve(*a, **kw)
        torch.cuda.synchronize()
        solves.append((time.perf_counter() - t1, res))
        return res

    kw = dict(exact=True, grid_extra=gauss_seidel_grid(), keep_counts=False, num_curves=1,
              dtype="float64", legacy_points=GS_LEGACY_POINTS)
    runner_mod.solve = timed
    try:
        paths.run("", "gauss_seidel", n, {}, name="main_gauss_seidel", **kw)
    finally:
        runner_mod.solve = solve
    replays = paths.last_replays
    launch = Recorder(hk.horizon_chord)
    hk.horizon_chord = launch
    try:
        paths.run("", "fused_horizon", n, {"stride_1_full": 1},
                  name="main_gauss_seidel_full", **kw)
    finally:
        hk.horizon_chord = launch.fn
    # One graph for each step's start and end, the iterations replayed with
    # the exit test lagged one iteration.
    if (len(solves) != 1 or len(launch.calls) != 1 or replays["step"] != 2 * GS_T
            or replays["iteration"] < GS_T):
        raise AssertionError(f"main_gauss_seidel: {len(solves)} solves, "
                             f"{len(launch.calls)} full-Newton launches, replays {replays}")

    cfg = paths.configs["main_gauss_seidel"]
    min_x, max_x = cfg.params.bounds_converted()
    _, _, X_host = sampling.make_grid(1, min_x, max_x, cfg.params.do_log,
                                      cfg.sim_flags.as_dict())
    P_gs, X_gs = paths.results["main_gauss_seidel"]
    P_full, _ = paths.results["main_gauss_seidel_full"]
    if X_gs.tobytes() != (X_host / physics.UNIT_CONVERSIONS).tobytes():
        raise AssertionError("main_gauss_seidel: BAYRAN X differs from make_grid's legacy grid")
    (row,) = compare_posteriors(P_gs[None], P_full[None])
    both = np.isfinite(P_gs) & np.isfinite(P_full)
    rel = float(np.max(np.abs(P_gs[both] - P_full[both]) / np.abs(P_full[both])))
    checks = [("rho", row["spearman_rho"] >= 0.999),
              ("top set", row["top_jaccard"] >= 0.99 or row["top_recall_2k"] >= 1.0),
              ("finite patterns", row["finite_mismatch"] <= GS_FINITE_DIFF * n),
              ("P", rel <= GS_P_RTOL)]
    print(f"  gauss_seidel vs fused_horizon on {int(both.sum())} samples finite in both: "
          f"rho {row['spearman_rho']:.9f}, top-1% Jaccard {row['top_jaccard']:.4f} (recall@2k "
          f"{row['top_recall_2k']:.4f}), finite on one side only {row['finite_mismatch']}, "
          f"max rel P diff {rel:.3e} (bound {GS_P_RTOL:g}); X bitwise make_grid's")
    failed = [c for c, ok in checks if not ok]
    if failed:
        raise AssertionError(f"main_gauss_seidel: {', '.join(failed)} check failed")

    # The figures.  The eager loop ran k sweeps a step where the graph route
    # replays k + 1 (its exit test lags one), or max_iters at the limit.
    wall_s, res = solves[0]
    wall_ms = 1e3 * wall_s / GS_T
    replayed = replays["iteration"]
    sweeps = replayed - GS_T
    at_limit = int(res.max_newton_iters) >= GS_MAX_ITERS
    # Device time of one iteration: newton_iteration replayed as a CUDA
    # graph on the first step's inputs (the loop's ~15 bookkeeping
    # operations left out).
    g = POWER_SCAN
    sim = SimParams(length=g["thickness"], time=gauss_seidel_grid()["time"], L=g["L"],
                    T=GS_T, tol_exp=7.0, max_iters=GS_MAX_ITERS, method="gauss_seidel",
                    predictor="previous")
    mat = torch.as_tensor(physics.nondimensionalize(X_host[:, :12], sim.dx, sim.dt),
                          dtype=torch.float64, device="cuda")
    dn = torch.as_tensor(excitation_profiles(g["L"], g["thickness"], 1)[0] * sim.dx ** 3,
                         dtype=torch.float64, device="cuda")
    n0, p0 = (mat[:, 0:1] + dn[None]).contiguous(), (mat[:, 1:2] + dn[None]).contiguous()
    e0 = torch.zeros_like(n0)
    a0 = torch.as_tensor(trpl.BDF_TABLE[0, 0], dtype=torch.float64, device="cuda")
    args = (n0, p0, e0, -n0, -p0, -e0, trpl.MatParams.from_array(mat), a0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        trpl.newton_iteration(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        trpl.newton_iteration(*args)
    dev_ms = cuda_ms(graph.replay, 20)
    launch_ms = 1e3 * launch.calls[0][2]
    print(f"  gauss_seidel (graph route): wall per BDF step {wall_ms:.3f} ms; iterations per "
          f"step (the eager loop's sweeps) mean {sweeps / GS_T:.2f}, replayed "
          f"{replayed / GS_T:.2f} (the exit lags one"
          + ("; a step reached max_iters, so the sweeps are a lower bound" if at_limit
             else "") + f"); per sample mean "
          f"{float(res.sample_iters.double().mean()) / GS_T:.2f}; converged share "
          f"{float(np.isfinite(P_gs).mean()):.4f}")
    print(f"  gauss_seidel: {1e3 * wall_s / replayed:.3f} ms per replayed iteration "
          f"({1e3 * wall_s / sweeps:.3f} ms per sweep of the eager loop), of which "
          f"{dev_ms:.3f} ms on the card (newton_iteration as a CUDA graph): host share "
          f"{1 - dev_ms * replayed / (1e3 * wall_s):.3f}; the full-Newton launch "
          f"{launch_ms:.1f} ms = {launch_ms / GS_T:.4f} ms per step: the Gauss-Seidel loop "
          f"takes {wall_ms * GS_T / launch_ms:.0f}x its time per step")

    # The graph route against the eager loop on the first steps (each a
    # few hundred sweeps from the initial condition), at the same settings.
    peak = []
    implicit = solver.implicit_step

    def recording(*a, **k):
        out = implicit(*a, **k)
        peak.append(out[3])
        return out
    cfg_check = sim.solver_config()._replace(num_steps=GS_CHECK_STEPS)
    solver.implicit_step = recording
    try:
        eager_s, graph_s, rp, ref = hold_routes(
            lambda: solver.solve(mat, n0, p0, e0, cfg_check, record_pl=True),
            "main_gauss_seidel check")
    finally:
        solver.implicit_step = implicit
    peak = torch.stack(peak).amax(0)
    its = int(rp["iteration"]) - GS_CHECK_STEPS
    print(f"  gauss_seidel graph route vs eager loop, first {GS_CHECK_STEPS} steps, {n} "
          f"samples, float64: N/P/E, PL trace, its and flags bitwise; {its} sweeps: eager "
          f"{1e3 * eager_s / GS_CHECK_STEPS:.2f} ms per step, {1e3 * eager_s / its:.3f} ms "
          f"per sweep; graph {1e3 * graph_s / GS_CHECK_STEPS:.2f} ms per step, "
          f"{1e3 * graph_s / rp['iteration']:.3f} ms per replayed iteration; the share "
          f"that max_iters m would converge over these steps: "
          + ", ".join(f"{m} {float((peak <= m).float().mean()):.4f}"
                      for m in (32, 64, 128, 256)))
    phase("main_gauss_seidel", t0, f"{n} samples x 1 curve x {GS_T} steps, float64: "
          f"Gauss-Seidel vs full Newton PASS; graph route bitwise the eager loop")


def jax_model_err(F, ref):
    """The JAX package's model_err (utils/legacy_pipeline.py:30-46), copied
    as written: the host reference of main_legacy's likelihood."""
    F = np.asarray(F)
    N = int(np.prod(ref))
    pN = 1
    err = []
    for m in range(len(ref)):
        dF = np.abs(F - np.roll(F, -pN))
        dk = ref[m] * pN
        for n in range(pN):
            dF[dk - pN + n:N:dk] = 0
        err.append(dF.max())
        pN *= ref[m]
    return np.array(err)


def jax_forward_lnp(F, values, std, ref):
    """The JAX package's forward_lnp (utils/legacy_pipeline.py:49-61),
    copied as written but for one cast: a float32 F minus a float64 value
    is float64 under numpy >= 2's promotion (NEP 50), float32 under older
    numpy's, so the difference is taken in float64 here whatever numpy this
    machine has.  Also returns each row's sum of its terms' magnitudes,
    the scale of the rounding of a sum of those terms in another order."""
    F = np.asarray(F)
    lnp = np.zeros(len(F))
    scale = np.zeros(len(F))
    for n in range(F.shape[1]):
        sig = jax_model_err(F[:, n], ref)
        sg2 = 2.0 * (sig.max() ** 2 + std[n] ** 2)
        res = (F[:, n].astype(np.float64) - values[n]) ** 2 / sg2
        half_log = np.log(np.pi * sg2) / 2.0
        lnp -= res + half_log
        scale += res + abs(half_log)
    return lnp, scale


class LegacyFloors:
    """main_legacy's min_p, read by grid_refine_bayes as each level starts:
    0 at level 0, then the (LEGACY_KEEP + 1)-th largest posterior mass of
    the level before, computed as grid_refine_bayes computes it from that
    level's likelihood (``scored``: one forward_lnp call per level)."""

    def __init__(self, scored):
        self.scored, self.floors = scored, []

    def __getitem__(self, level):
        if level != len(self.floors) or len(self.scored) != level:
            raise AssertionError(f"LegacyFloors: level {level} asked after "
                                 f"{len(self.scored)} scored levels")
        floor = 0.0
        if level:
            lnp = self.scored[-1][2].cpu().numpy()
            P = np.exp(lnp - np.max(lnp))
            P /= P.sum()
            floor = float(np.sort(P)[-LEGACY_KEEP - 1]) if len(P) > LEGACY_KEEP else 0.0
        self.floors.append(floor)
        return floor


def legacy_phase(paths):
    """main_legacy: grid_refine_bayes with make_trpl_forward on the card
    (see LEGACY_PL_STRIDE).  Checks the launches (one per level slice plus
    the data launch, nothing but the record launch), P (finite, summing to
    1 within 1e-12) and each level's device likelihood against the host
    loop; prints the cells per level, the seconds per level and the best
    cell against the truth.  Returns its record launches."""
    from bayesian_inference_trpl_tpu_torch import physics
    from bayesian_inference_trpl_tpu_torch.models.driver import SimParams
    from bayesian_inference_trpl_tpu_torch.utils import legacy_pipeline as lp
    from bayesian_inference_trpl_tpu_torch.utils import sampling
    g = POWER_SCAN
    t0 = time.perf_counter()
    uc = physics.UNIT_CONVERSIONS
    min_x, max_x = np.asarray(MIN_X) * uc, np.asarray(MAX_X) * uc
    free = min_x != max_x
    refs = ([np.where(free, 2, 1)]
            + [np.isin(np.arange(13), LEGACY_SPLIT) + 1] * (LEGACY_LEVELS - 1))
    sim = SimParams(length=g["thickness"], time=g["time"], L=g["L"], T=g["T"],
                    pl_stride=LEGACY_PL_STRIDE, tol_exp=g["tol_exp"],
                    max_iters=g["max_iters"], method="fused_horizon")
    forward = lp.make_trpl_forward(sim, (1e18 / 1e7 ** 3, 100.0), "exp",
                                   dtype=torch.float32, device="cuda")
    print(f"  main_legacy: L {g['L']}, {g['T']} steps of {g['time'] / g['T'] * 1e3:g} ps, "
          f"PL every {LEGACY_PL_STRIDE} steps ({sim.num_pl} times), float32, fused_horizon, "
          f"exp initial condition, tol_exp {g['tol_exp']}, max_iters {g['max_iters']}; "
          f"levels {[int(np.prod(r)) for r in refs]} sub-cells per kept cell, at most "
          f"{LEGACY_KEEP} kept; max_batch {lp.MAX_BATCH}", flush=True)
    calls, scored = [], []

    def timed_forward(X):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        F = forward(X)
        torch.cuda.synchronize()
        calls.append((len(X), t1, time.perf_counter()))
        return F

    lnp_fn = lp.forward_lnp

    def recording_lnp(F, values, std, ref):
        out = lnp_fn(F, values, std, ref)
        torch.cuda.synchronize()
        scored.append((F, ref, out, time.perf_counter()))
        return out

    rng = np.random.default_rng(paths.seed)
    paths.zero()
    truth = np.asarray(LEGACY_TRUTH) * uc
    clean = forward(truth[None])[0].double().cpu().numpy()
    values = clean * (1.0 + LEGACY_NOISE * rng.standard_normal(clean.size))
    data = (sim.pl_times, values, LEGACY_NOISE * np.abs(values))
    floors = LegacyFloors(scored)
    lp.forward_lnp = recording_lnp
    try:
        N, P = lp.grid_refine_bayes(timed_forward, refs, min_x, max_x, floors, data,
                                    do_log=DO_LOG)
    finally:
        lp.forward_lnp = lnp_fn
    torch.cuda.synchronize()
    launched = {k: v for k, v in paths.launches().items() if v}
    if len(calls) != len(refs) or len(scored) != len(refs):
        raise AssertionError(f"main_legacy: {len(calls)} forward calls and {len(scored)} "
                             f"likelihood calls for {len(refs)} levels")
    want = sum(-(-n // lp.MAX_BATCH) for n, _, _ in calls) + 1
    if launched != {"stride_1_record": want}:
        raise AssertionError(f"main_legacy launched {launched}, expected {want} record "
                             f"launches (one per level slice and the data launch)")
    if not (np.isfinite(P).all() and abs(P.sum() - 1.0) <= 1e-12):
        raise AssertionError(f"main_legacy: P finite {bool(np.isfinite(P).all())}, "
                             f"sums to {P.sum()!r}")
    worst, cancel = 0.0, 0.0
    for level, ((n, t1, t2), (F, ref, lnp, t3)) in enumerate(zip(calls, scored)):
        block = int(np.prod(ref))
        nb = n // block
        picks = np.unique(np.linspace(0, nb - 1, min(nb, LEGACY_HOST_BLOCKS)).round().astype(int))
        Fh, dev = F.cpu().numpy(), lnp.cpu().numpy()
        for b in picks:
            ref_lnp, scale = jax_forward_lnp(Fh[b * block:(b + 1) * block], values, data[2],
                                             ref)
            err = (np.abs(dev[b * block:(b + 1) * block] - ref_lnp) / scale).max()
            if not err <= LEGACY_LNP_RTOL:
                raise AssertionError(f"main_legacy level {level} block {b}: device likelihood "
                                     f"off the host loop by {err:.3e} of its terms' magnitude")
            worst = max(worst, err)
            cancel = max(cancel, float((scale / np.abs(ref_lnp)).max()))
        if level and n // block > LEGACY_KEEP:
            raise AssertionError(f"main_legacy level {level}: {n // block} kept cells")
        kept = "" if level == 0 else (f" ({n // block} kept cells x {block}, floor "
                                      f"{floors.floors[level]:.6e})")
        print(f"  main_legacy level {level}: {n} cells{kept}, one forward call: record launch "
              f"{t2 - t1:.3f} s, likelihood {t3 - t2:.3f} s; {len(picks)} of {nb} blocks held "
              f"to the host loop")
    ind = sampling.index_grid(N[np.argmax(P)][None], refs)
    best = sampling.param_grid(ind, refs, min_x, max_x, np.asarray(DO_LOG))[0] / uc
    names = ("p0", "mu_n", "mu_p", "B", "Sf", "Sb", "C_n", "C_p", "tau_n", "tau_p")
    print("  main_legacy best cell (P " + f"{P.max():.4f}) against the truth: " + ", ".join(
        f"{nm} {best[i]:.4g}/{LEGACY_TRUTH[i]:.4g}"
        for nm, i in zip(names, np.flatnonzero(free))))
    phase("main_legacy", t0, f"grid_refine_bayes on the card: {len(N)} cells at the finest "
          f"level, {want} record launches ({want - 1} levels and the data), P finite and "
          f"normalized, likelihood within {worst:.2e} of the host loop's terms (whose "
          f"magnitudes reach {cancel:.3g} x |lnp|)")
    return want


def device_sampler_phase(seed):
    """random_grid_device on a CUDA generator at DEVICE_SAMPLER_POINTS x 13
    over MIN_X/MAX_X: bounds, pinned columns exactly their bound, the mean
    and variance of log10(x) (log axes) and of x (linear) within
    DEVICE_SAMPLER_SE standard errors of the uniform law's, and the same
    draws from the same seed twice."""
    from bayesian_inference_trpl_tpu_torch.utils.sampling import random_grid_device
    t0 = time.perf_counter()
    n = DEVICE_SAMPLER_POINTS

    def draw():
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return random_grid_device(gen, MIN_X, MAX_X, DO_LOG, n)
    X = draw()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if X.device.type != "cuda" or X.shape != (n, 13) or not torch.equal(X, draw()):
        raise AssertionError(f"device sampler: {X.device} {tuple(X.shape)}, or two draws "
                             f"from seed {seed} differ")
    lo = torch.tensor(MIN_X, dtype=X.dtype, device=X.device)
    hi = torch.tensor(MAX_X, dtype=X.dtype, device=X.device)
    pinned = lo == hi
    if not (torch.equal(X[:, pinned], lo[pinned].expand(n, -1))
            and bool(((X >= lo) & (X <= hi)).all())):
        raise AssertionError("device sampler: a draw outside the box or a pinned column "
                             "not its bound")
    log = torch.tensor(DO_LOG, dtype=torch.bool, device=X.device) & ~pinned
    lin = ~torch.tensor(DO_LOG, dtype=torch.bool, device=X.device) & ~pinned
    Y = torch.cat([X[:, log].log10(), X[:, lin]], 1)
    a = torch.cat([lo[log].log10(), lo[lin]])
    w = torch.cat([hi[log].log10(), hi[lin]]) - a
    mean_se = ((Y.mean(0) - (a + w / 2)) / (w / np.sqrt(12 * n))).abs().max()
    var_se = ((Y.var(0) - w ** 2 / 12) / (w ** 2 * np.sqrt((1 / 80 - 1 / 144) / n))).abs().max()
    if max(float(mean_se), float(var_se)) > DEVICE_SAMPLER_SE:
        raise AssertionError(f"device sampler: moments {float(mean_se):.2f} / "
                             f"{float(var_se):.2f} standard errors off the uniform law's")
    phase("device_sampler", t0, f"random_grid_device on cuda: {n} x 13 float64 in {ms:.1f} ms "
          f"(first call); in the box, pinned columns exact, the same draws twice; moments "
          f"within {float(mean_se):.2f} (mean) and {float(var_se):.2f} (variance) standard "
          f"errors over {int(log.sum())} log and {int(lin.sum())} linear axes")


def hist_inputs(n, seed):
    """float64 samples x, y in [-0.1, 1.1) around the range [0, 1], with
    NaN, +-inf and values exactly on both edges; weights in [0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, y, w = (torch.rand(n, generator=g, dtype=torch.float64, device="cuda")
               for _ in range(3))
    for v, k in ((x, 0), (y, 5)):
        v.mul_(1.2).sub_(0.1)
        v[k::997] = float("nan")
        v[k + 1::991] = float("inf")
        v[k + 2::983] = -float("inf")
        v[k + 3::977] = 0.0
        v[k + 4::971] = 1.0
    return x, y, w


def compare_hist(seed):
    """Both histogram kernels against their plain versions on the card at
    HIST_SAMPLES samples: 1-D at HIST_BINS bins (counts equal, sums within
    HIST_RTOL), 2-D at HIST_BINS^2 (shared-memory path) and
    HIST_GLOBAL_BINS^2 (global-memory path), sums within HIST_RTOL; then
    each timed (CUDA events, 3 launches after a warm-up) at the CLI's bins
    beside its plain version and torch.bincount with the index computation.
    Returns the two entries of the kernels line (launches filled in later
    from main_posterior)."""
    from bayesian_inference_trpl_tpu_torch.ops import histogram as hg
    t0 = time.perf_counter()
    n, nb = HIST_SAMPLES, HIST_BINS
    x, y, w = hist_inputs(n, seed)

    def rel(a, b):
        if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
            raise AssertionError("histogram sums: finite patterns differ")
        err = (a - b).abs()
        r = float((err / b.abs().clamp_min(1e-300)).max())
        if r > HIST_RTOL:
            raise AssertionError(f"histogram sums: rel err {r:.3e} > {HIST_RTOL}")
        return float(err.max())

    kw, kc = hg.hist1d_weighted(x, w, 0.0, 1.0, nb)
    pw, pc = hg.hist1d_weighted_plain(x, w, 0.0, 1.0, nb)
    if not torch.equal(kc, pc):
        raise AssertionError(f"hist1d counts differ in {int((kc != pc).sum())} bins")
    kept = int(((x >= 0) & (x <= 1)).sum())
    if int(kc.sum()) != kept:
        raise AssertionError(f"hist1d counts {int(kc.sum())} != {kept} samples in range")
    err1 = rel(kw, pw)
    err2 = {}
    for b in (nb, HIST_GLOBAL_BINS):
        args = (x, y, w, 0.0, 1.0, b, 0.0, 1.0, b)
        err2[b] = rel(hg.hist2d_weighted(*args), hg.hist2d_weighted_plain(*args))
    torch.cuda.synchronize()
    plans = {(1, nb): hg.launch_plan(1, n, nb)}
    plans.update({(2, b): hg.launch_plan(2, n, b * b) for b in (nb, HIST_GLOBAL_BINS)})
    for (dims, b), pl in plans.items():
        print(f"  hist{dims}d {b}{f'x{b}' if dims == 2 else ''} bins at {n:,} samples: "
              f"{pl['path']} path, {pl['blocks']} blocks of 256 threads, "
              f"{pl['smem_per_block']} B shared memory per block (opt-in limit "
              f"{pl['smem_optin']} B)")
    if plans[2, HIST_GLOBAL_BINS]["path"] != "global" or plans[2, nb]["path"] != "shared":
        raise AssertionError(f"histogram paths {plans}")
    print(f"  hist1d {nb} bins: counts equal ({kept:,} of {n:,} samples in range: NaN, "
          f"+-inf and out-of-range dropped), sums max abs err {err1:.3e}; hist2d "
          + ", ".join(f"{b}x{b}: sums max abs err {e:.3e}" for b, e in err2.items())
          + f" (within {HIST_RTOL} relative)")

    def bincount_1d():
        lo, hi, inv, bins = hg.axis(0.0, 1.0, nb)
        b, keep = hg.bin_index(x, lo, hi, inv, bins)
        return torch.bincount(b[keep], weights=w[keep], minlength=bins)

    def bincount_2d():
        ax, ay = hg.axis(0.0, 1.0, nb), hg.axis(0.0, 1.0, nb)
        a, keep = hg.bin_index(x, *ax)
        b, keep_y = hg.bin_index(y, *ay)
        keep &= keep_y
        return torch.bincount((a * nb + b)[keep], weights=w[keep], minlength=nb * nb)

    rel(bincount_1d(), pw)
    rel(bincount_2d().view(nb, nb), hg.hist2d_weighted_plain(x, y, w, 0.0, 1.0, nb,
                                                             0.0, 1.0, nb))
    out = []
    for dims, kernel, plain, library, err in (
            (1, lambda: hg.hist1d_weighted(x, w, 0.0, 1.0, nb),
             lambda: hg.hist1d_weighted_plain(x, w, 0.0, 1.0, nb), bincount_1d, err1),
            (2, lambda: hg.hist2d_weighted(x, y, w, 0.0, 1.0, nb, 0.0, 1.0, nb),
             lambda: hg.hist2d_weighted_plain(x, y, w, 0.0, 1.0, nb, 0.0, 1.0, nb),
             bincount_2d, err2[nb])):
        ms, plain_ms, lib_ms = (cuda_ms(f, 3) for f in (kernel, plain, library))
        nbytes = n * 8 * (dims + 1) + (nb * 16 if dims == 1 else nb * nb * 8)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = n * (dims * HIST_OPS_AXIS + 1) / PEAK_FP64
        bound = max(t_bytes, t_ops) * 1e3
        name = f"hist{dims}d_weighted"
        print(f"  {name} {nb}{f'x{nb}' if dims == 2 else ''} bins, {n:,} samples: kernel "
              f"{ms:.4f} ms, bound {bound:.4f} ms (bytes, {100 * bound / ms:.1f}% of it "
              f"reached), plain {plain_ms:.4f} ms, torch.bincount {lib_ms:.4f} ms")
        out.append(dict(name=name, route="cuda",
                        source="bayesian_inference_trpl_tpu_torch/csrc/hist_kernel.cu",
                        replaces="bayesian_inference_trpl_tpu/native/src/trpl_native.cpp:"
                                 + ("97" if dims == 1 else "142"),
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                        bound_by="bytes" if t_bytes >= t_ops else "operations",
                        library_ms=lib_ms))
    phase("compare_hist", t0, "histogram kernels vs plain on the card; timed with "
          "CUDA events")
    return out


def main_posterior(paths, n_main, seed):
    """The port's posterior CLI's headless report (--t-factor auto) on
    main's exported BAYRAN pair on the card, then every marginal of its
    corner plot (plotting.corner_marginals: k 1-D, k(k-1)/2 2-D at the
    CLI's 96 bins) and of the pinned PINNED beside them (an empty range:
    k + 1 marginals on the card that launch no kernel), the histogram
    launches counted; all held to the same calls on the CPU.  Also get_data on main's observation file: native
    and csv.reader routes bitwise equal, both timed.  Returns the
    histogram launches."""
    from bayesian_inference_trpl_tpu_torch import native
    from bayesian_inference_trpl_tpu_torch.config import load_config
    from bayesian_inference_trpl_tpu_torch.posterior import cli, plotting
    t0 = time.perf_counter()
    P, X = paths.results["main"]
    with tempfile.TemporaryDirectory(prefix="trpl_smoke_") as tmp:
        cfg = load_config(write_main_inputs(tmp, n_main, seed))
        flags = (cfg.ic_flags.as_dict(), cfg.sim_flags.as_dict())
        obs = cfg.paths.observation_files
        native.load()       # built by the first CLI run's ingest; timed below: parsing
        bio = paths.bio
        t1 = time.perf_counter()
        nat = bio.get_data(obs, *flags, rng=np.random.default_rng(seed))
        t2 = time.perf_counter()
        args = bio._curve_args(*flags, rng=np.random.default_rng(seed))
        rows = [bio._read_rows(f, *args) for f in obs]
        t3 = time.perf_counter()
        for f_nat, f_row in zip(nat, rows):
            for c_nat, c_row in zip(f_nat, f_row):
                if len(c_nat) != len(c_row) or not all(
                        a.tobytes() == b.tobytes() for a, b in zip(c_nat, c_row)):
                    raise AssertionError("get_data: native and csv.reader routes differ")
        print(f"  get_data on main's observations ({os.path.getsize(obs[0]):,} B, "
              f"{len(nat[0][0])} curves): native {t2 - t1:.3f} s, csv.reader "
              f"{t3 - t2:.3f} s, bitwise equal")
        out = os.path.join(tmp, "main")
        bio.export(out, P, X)
        reps, margs, walls = {}, {}, {}
        for dev in ("cuda", "cpu"):
            if dev == "cuda":
                paths.zero()
            t1 = time.perf_counter()
            rep = cli.report(out, device=dev)
            margs[dev] = plotting.corner_marginals(rep.data, rep.params + [PINNED],
                                                   rep.viz.do_log, bins=96)
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = paths.launches()
            walls[dev] = time.perf_counter() - t1
            reps[dev] = rep
    k = len(reps["cuda"].params)
    want = {"hist1d_weighted": k, "hist2d_weighted": k * (k - 1) // 2}
    got = {name: v for name, v in launches.items() if v}
    if got != want:
        raise AssertionError(f"main_posterior launched {got}, expected {want}")
    a, b = reps["cuda"].summary, reps["cpu"].summary
    # P (and all taken from it) is the same function of the data on both
    # devices where the temperature applied is the same, bitwise.
    rtol = POSTERIOR_RTOL if a["temperature"] == b["temperature"] else POSTERIOR_TF_RTOL

    def check(name, u, v, tol):
        u, v = np.asarray(u, dtype=float), np.asarray(v, dtype=float)
        if not np.allclose(u, v, rtol=tol, atol=0, equal_nan=True):
            raise AssertionError(f"main_posterior: {name} on cuda {u} vs cpu {v} "
                                 f"(rtol {tol})")
    if a["num_samples"] != b["num_samples"]:
        raise AssertionError("main_posterior: sample counts differ")
    for key in ("temperature", "temperature_max_uncertainty"):
        check(key, a[key], b[key], POSTERIOR_TF_RTOL)
    for p in b["stats"]:
        check(f"{p} mean, std", list(a["stats"][p].values()), list(b["stats"][p].values()),
              rtol)
        check(f"{p} 95% interval", a["credible_95"][p], b["credible_95"][p], rtol)
    (_, d1, d2), (_, c1, c2) = margs["cuda"], margs["cpu"]
    worst = 0.0
    for got_m, ref_m in [(d1[p], c1[p]) for p in c1] + [(d2[q], c2[q]) for q in c2]:
        for u, v in zip(got_m, ref_m):
            u, v = u.cpu().numpy(), v.numpy()
            check("marginal", u, v, rtol)
            fin = np.isfinite(v) & (v != 0)
            if fin.any():
                worst = max(worst, float(np.max(np.abs(u - v)[fin] / np.abs(v[fin]))))
    pinned = d1[PINNED][0]
    if pinned.device.type != "cuda" or not bool(torch.isinf(pinned).any()):
        raise AssertionError(f"main_posterior: {PINNED}'s marginal is not an empty range's "
                             f"on the card: {pinned}")
    phase("main_posterior", t0, f"cli.report (--t-factor auto) on main's {len(P):,} samples: "
          f"cuda {walls['cuda']:.2f} s, cpu {walls['cpu']:.2f} s (each with the corner "
          f"plot's {k} + {k * (k - 1) // 2} marginals at 96 bins, and pinned {PINNED}'s "
          f"{k + 1}); ESS {a['ess']}, "
          f"temperature {a['temperature']:.6g} (max-uncertainty {a['temperature_max_uncertainty']:.6g}); "
          f"cuda vs cpu: statistics within {rtol}, marginals max rel {worst:.3e}; "
          f"launches {got}")
    return {name: launches[name] for name in want}


def timeshift_phase(paths):
    """tools/timeshift_demo.main (TIMESHIFT_ARGS) on the card: no sample
    non-converged, and the shift grid's shift-0 entry the sample's raw rms
    within float32 rounding; two scoring solves of the ladder (the gate's
    8 samples, then the shift grid of the worst)."""
    from bayesian_inference_trpl_tpu_torch.tools import accuracy_gate, timeshift_demo
    t0 = time.perf_counter()
    if not accuracy_gate.bundled_cache(POWER_SCAN["T"], 8, 0, "synthetic").exists():
        raise FileNotFoundError("timeshift_demo: the b8 s0 exact cache is missing")
    paths.zero()
    res = timeshift_demo.main([*TIMESHIFT_ARGS, "--device", "cuda"])
    torch.cuda.synchronize()
    got = {k: v for k, v in paths.launches().items() if v}
    rungs = len(ladder_schedule(False)[1]) - 1
    want = {"stride_1": 2, "stride_s": 2 * rungs}
    if got != want:
        raise AssertionError(f"timeshift_demo launched {got}, expected {want}")
    if res["non_converged"]:
        raise AssertionError(f"timeshift_demo: {res['non_converged']} samples non-converged")
    zero = res["deltas"].index(0.0)
    (w,) = res["worst"]
    at0 = res["rms_by_shift"][w["sample"]][zero]
    if abs(at0 - w["raw_rms"]) > 2.0 ** -22 * w["raw_rms"]:
        raise AssertionError(f"timeshift_demo: rms at shift 0 {at0!r} != raw rms "
                             f"{w['raw_rms']!r}")
    phase("timeshift_demo", t0, f"synthetic b8 s0 on cuda: sample {w['sample']} raw rms "
          f"{w['raw_rms']:.4e}, at shift 0 {at0:.4e}, best {w['best_shift_steps']:+.2f} steps "
          f"-> {w['aligned_rms']:.4e}; non-converged 0; launches {got}")


def corner_gate(paths):
    """The corner gate (tests/test_corner_gate.py's two tests, their
    bounds): the port's run_sweep.run_solver with fused_horizon in float64
    on the card (one record launch per refinement level) against the
    shipped scipy-oracle results (tools/corner_cache; missing files fail
    the script), for the 32 box corners and the 16 mu-asymmetric corners at
    T0, 2 T0 and 4 T0; at T0 also coupled_newton_pallas (the per-step
    kernel, one launch per step), held to the record launch within
    CORNER_PALLAS_RTOL."""
    from bayesian_inference_trpl_tpu_torch.tools import compare, run_sweep
    from bayesian_inference_trpl_tpu_torch.tools.corner_cache import (
        T0, corner_matrix, corner_sweep, e_corner_matrix, load_oracle)
    t0 = time.perf_counter()
    levels = (T0, 2 * T0, 4 * T0)

    def solve(mat, T, method, want):
        paths.zero()
        t1 = time.perf_counter()
        sol = run_sweep.run_solver(corner_sweep(mat, T), method, "float64", device="cuda")
        torch.cuda.synchronize()
        got = {k: v for k, v in paths.launches().items() if v}
        if got != want:
            raise AssertionError(f"corner gate {method} at T {T}: launched {got}, "
                                 f"expected {want}")
        if not sol["converged"].all():
            raise AssertionError(f"corner gate {method} at T {T}: non-converged corners "
                                 f"{np.where(~sol['converged'])[0].tolist()}")
        return sol, time.perf_counter() - t1

    for name, mat in (("box", corner_matrix()), ("mu-asymmetric", e_corner_matrix())):
        oracle = load_oracle(corner_sweep(mat, T0 * 4))
        errs, sols = {}, {}
        for T in levels:
            sols[T], secs = solve(mat, T, "fused_horizon", {"stride_1_record_states": 1})
            errs[T] = {k: np.asarray(v) for k, v in
                       compare.field_errors(sols[T], oracle, reduce="none").items()}
            print(f"  corner gate {name} ({len(mat)} corners) T {T}: worst N "
                  f"{errs[T]['N'].max():.3e}, P {errs[T]['P'].max():.3e}, E "
                  f"{errs[T]['E'].max():.3e}, PL {errs[T]['PL'].max():.3e}; max |E| "
                  f"{np.abs(sols[T]['E']).max():.3e} V/nm; one record launch, {secs:.2f} s",
                  flush=True)
        pallas, secs = solve(mat, T0, "coupled_newton_pallas", {"newton_step": T0})
        worst = 0.0
        for k in ("N", "P", "pl", "E"):
            a, b = pallas[k], sols[T0][k]
            den = E_SCALE if k == "E" else np.maximum(np.abs(b), 1e-300)
            worst = max(worst, float((np.abs(a - b) / den).max()))
        if worst > CORNER_PALLAS_RTOL:
            raise AssertionError(f"corner gate {name}: coupled_newton_pallas differs from "
                                 f"the record launch by {worst:.3e} > {CORNER_PALLAS_RTOL}")
        print(f"  corner gate {name} T {T0}: coupled_newton_pallas ({T0} per-step "
              f"launches, {secs:.2f} s) agrees with the record launch within {worst:.2e}")
        (corner_box_gate if name == "box" else corner_e_gate)(errs, sols, levels)
    phase("corner_gate", t0, "solver vs scipy oracle on 32 box and 16 mu-asymmetric "
          "corners at T0, 2 T0, 4 T0 (record launch, float64): the JAX package's bounds "
          "PASS")


def corner_box_gate(errs, sols, levels):
    """tests/test_corner_gate.py::test_corner_sweep_parity_with_dt_refined_e_gate's
    bounds."""
    T0, T1, T2 = levels
    e0 = errs[T0]
    checks = [("N max at T0 < 3e-2", e0["N"].max() < 3e-2),
              ("P max at T0 < 3e-2", e0["P"].max() < 3e-2),
              ("PL max at T0 < 4e-2", e0["PL"].max() < 4e-2),
              ("N refinement ratio < 0.5", errs[T1]["N"].max() / e0["N"].max() < 0.5)]
    sig = errs[T0]["E"] > 1e-12
    ratios = np.concatenate([errs[T1]["E"][sig] / errs[T0]["E"][sig],
                             errs[T2]["E"][sig] / errs[T1]["E"][sig]])
    med = float(np.median(ratios)) if ratios.size else float("nan")
    absE = float(np.abs(sols[T0]["E"]).max())
    checks += [(f"meaningful-E corners {int(sig.sum())} >= 16", sig.sum() >= 16),
               (f"E median refinement ratio {med:.4f} < 1.05", med < 1.05),
               (f"ambipolar max |E| {absE:.3e} < 1e-9 V/nm", absE < 1e-9)]
    _gate_verdict("box", checks)


def corner_e_gate(errs, sols, levels):
    """tests/test_corner_gate.py::test_e_corner_gate_mu_asymmetric's bounds."""
    T0, T1, T2 = levels
    e0, e2 = errs[T0], errs[T2]
    med = float(np.median(np.concatenate([errs[T1]["E"] / e0["E"], e2["E"] / errs[T1]["E"]])))
    checks = [("N max at T0 < 4e-2", e0["N"].max() < 4e-2),
              ("P max at T0 < 4e-2", e0["P"].max() < 4e-2),
              ("E max at T0 < 1e-1", e0["E"].max() < 1e-1),
              ("PL max at T0 < 3e-2", e0["PL"].max() < 3e-2),
              ("E max at 4 T0 < 5e-3", e2["E"].max() < 5e-3),
              ("N max at 4 T0 < 4e-3", e2["N"].max() < 4e-3),
              (f"E median refinement ratio {med:.3f} < 0.5", med < 0.5)]
    _gate_verdict("mu-asymmetric", checks)


def _gate_verdict(name, checks):
    failed = [c for c, ok in checks if not ok]
    print(f"  corner gate {name}: " + "; ".join(c for c, _ in checks)
          + (": PASS" if not failed else f": FAIL {failed}"))
    if failed:
        raise AssertionError(f"corner gate {name} FAIL: {failed}")


def resume_phase(paths, seed):
    """main_resume: the CLI on main's inputs stopped by a checkpoint write
    that raises after RESUME_STOP, then run again with --resume; P and the
    exported files bitwise those of an uninterrupted run, and the resumed
    run launches only the chunks left.  Returns the uninterrupted run's
    exported files (name -> bytes)."""
    from bayesian_inference_trpl_tpu_torch.parallel.checkpoint import CheckpointManager

    class Stop(Exception):
        pass

    t0 = time.perf_counter()
    n_chunks = -(-RESUME_SAMPLES // 1024)
    rungs = len(ladder_schedule(False)[1]) - 1
    left = 3 * n_chunks - (RESUME_STOP[0] * n_chunks + RESUME_STOP[1])
    files = {}
    with tempfile.TemporaryDirectory(prefix="trpl_smoke_") as tmp:
        for run_name in ("full", "ckpt"):
            d = os.path.join(tmp, run_name)
            os.makedirs(d)
            cfg_path = write_main_inputs(d, RESUME_SAMPLES, seed)
            if run_name == "full":
                wall, _ = paths.cli(cfg_path, d)
            else:
                orig = CheckpointManager.save_progress

                def stopping(self, state, P):
                    orig(self, state, P)
                    if (state.curve_index, state.chunk_index) == RESUME_STOP:
                        raise Stop()
                CheckpointManager.save_progress = stopping
                try:
                    paths.cli(cfg_path, d)
                    raise AssertionError("main_resume: the stopped run did not stop")
                except Stop:
                    pass
                finally:
                    CheckpointManager.save_progress = orig
                wall, counts = paths.cli(cfg_path, d, "--resume")
                got = {k: v for k, v in counts.items() if v}
                want = {"stride_1": left, "stride_s": left * rungs}
                if got != want:
                    raise AssertionError(f"main_resume: resumed run launched {got}, "
                                         f"expected {want}")
            out = os.path.join(d, "out", "smoke")
            files[run_name] = ({f: open(os.path.join(out, f), "rb").read()
                                for f in sorted(os.listdir(out)) if "_BAYRAN_" in f},
                               paths.bio.load_bayran(out))
            print(f"  main_resume {run_name}: {wall:.2f} s")
    (f_full, (P_full, X_full)), (f_res, (P_res, X_res)) = files["full"], files["ckpt"]
    if (len(f_full) != 2 or f_full != f_res or P_full.tobytes() != P_res.tobytes()
            or X_full.tobytes() != X_res.tobytes()):
        raise AssertionError("main_resume: the resumed run's P or exported files differ "
                             "from the uninterrupted run's")
    phase("main_resume", t0, f"{RESUME_SAMPLES} samples x 3 curves, stopped after the "
          f"checkpoint of curve {RESUME_STOP[0]} chunk {RESUME_STOP[1]}, resumed with "
          f"--resume: {left} chunk-curves launched, P and {len(f_full)} exported files "
          f"bitwise equal, finite share {float(np.isfinite(P_res).mean()):.4f}")
    return f_full


def adaptive_phase(paths, num_points, seed):
    """main_adaptive: main's inputs with adaptive_fine_tau = ADAPTIVE_TAU.
    The bulk's P bitwise main's; the bucket's P bitwise a separate CLI run
    of those samples alone on the bucket's ladder."""
    from bayesian_inference_trpl_tpu_torch.config import GridConfig
    from bayesian_inference_trpl_tpu_torch.models.twophase import geometric_schedule
    from bayesian_inference_trpl_tpu_torch.utils import sampling
    g = POWER_SCAN
    dflt = GridConfig()
    bucket_ladder = dict(
        fast_fine_steps=min(dflt.adaptive_fine_steps, g["T"] // 2),
        fast_max_stride=min(dflt.adaptive_max_stride, g["fast_max_stride"]))
    P_main, X_main = paths.results["main"]
    fine = X_main[:, 9] < ADAPTIVE_TAU                 # tau_n [ns]
    nb, nf = -(-int((~fine).sum()) // 1024), -(-int(fine.sum()) // 1024)
    print(f"  main_adaptive: {int(fine.sum())} of {num_points} samples in the tau_n < "
          f"{ADAPTIVE_TAU:g} ns bucket", flush=True)
    if not fine.any():
        raise AssertionError("main_adaptive: the fine bucket is empty")
    rungs = len(ladder_schedule(False)[1]) - 1
    rungs_f = len(geometric_schedule(
        g["T"], bucket_ladder["fast_fine_steps"], base_stride=g["fast_coarse_stride"],
        coarse_steps_per_phase=g["fast_steps_per_phase"],
        max_stride=bucket_ladder["fast_max_stride"])) - 1
    paths.run("", "fused_horizon_chord", num_points, {}, name="main_adaptive",
              grid_extra=dict(adaptive_fine_tau=ADAPTIVE_TAU), keep_counts=False,
              expected={"stride_1": 3 * (nb + nf), "stride_s": 3 * (nb * rungs + nf * rungs_f)})
    P_ad, X_ad = paths.results["main_adaptive"]
    if X_ad.tobytes() != X_main.tobytes() or P_ad[~fine].tobytes() != P_main[~fine].tobytes():
        raise AssertionError("main_adaptive: the bulk's P differs from main's")

    t0 = time.perf_counter()
    orig = sampling.make_grid

    def bucket_only(*a, **kw):
        idx, P, X = orig(*a, **kw)
        return idx[fine], P[:, fine], X[fine]
    with tempfile.TemporaryDirectory(prefix="trpl_smoke_") as tmp:
        cfg_path = write_main_inputs(tmp, num_points, seed, grid_extra=bucket_ladder)
        sampling.make_grid = bucket_only
        try:
            wall, counts = paths.cli(cfg_path, tmp)
        finally:
            sampling.make_grid = orig
        P_b, X_b = paths.bio.load_bayran(os.path.join(tmp, "out", "smoke"))
    got = {k: v for k, v in counts.items() if v}
    if got != {"stride_1": 3 * nf, "stride_s": 3 * nf * rungs_f}:
        raise AssertionError(f"main_adaptive bucket run launched {got}")
    if X_b.tobytes() != X_main[fine].tobytes() or P_b.tobytes() != P_ad[fine].tobytes():
        raise AssertionError("main_adaptive: the bucket's P differs from a separate run "
                             "of its samples on the bucket's ladder")
    phase("main_adaptive_bucket", t0, f"{int(fine.sum())} bucket samples alone on the "
          f"{bucket_ladder} ladder ({rungs_f} rungs) in {wall:.2f} s: P bitwise the "
          f"routed run's; bulk bitwise main's")


def devices_split(paths):
    """devices_split: tools/dryrun_multichip on the card, a mesh that names
    cuda:0 twice against cuda:0 once at the same global chunk, on every
    route at power_scan's full ladder; launches counted (each chunk once
    per mesh entry), X's likelihoods and flags bitwise.  With more than
    one card visible, also the real mesh against one card."""
    from bayesian_inference_trpl_tpu_torch.config import DeviceConfig
    from bayesian_inference_trpl_tpu_torch.parallel.mesh import make_mesh
    from bayesian_inference_trpl_tpu_torch.tools import dryrun_multichip as dry
    from bayesian_inference_trpl_tpu_torch.utils.validate import connect_to_devices
    t0 = time.perf_counter()
    prob = dry.problem(full=True, num=SPLIT_SAMPLES, interp_num=SPLIT_INTERP_SAMPLES)
    rungs = len(prob.sim.fast_phases) - 1
    per_chunk = {"ongrid": {"stride_1": 1, "stride_s": rungs},
                 "offgrid": {"offgrid": rungs + 1}, "interp": {"stride_1_record": 1}}
    for route in dry.ROUTES:
        n = prob.interp_num if route == "interp" else len(prob.X)
        res = []
        for mesh, cpd in ((["cuda:0"] * 2, SPLIT_CHUNK // 2), (["cuda:0"], SPLIT_CHUNK)):
            paths.zero()
            res.append(dry.run_route(route, make_mesh(mesh), cpd, prob))
            got = {k: v for k, v in paths.launches().items() if v}
            want = {k: v * len(mesh) * -(-n // SPLIT_CHUNK) for k, v in per_chunk[route].items()}
            if got != want:
                raise AssertionError(f"devices_split {route} on {mesh}: launched {got}, "
                                     f"expected {want}")
            print(f"  devices_split {route} on {mesh} at {cpd} per entry: "
                  f"{res[-1][3]:.3f} s, launches {got}", flush=True)
        print("  devices_split " + dry.check_route(route, res[0], res[1],
                                                   -(-n // SPLIT_CHUNK))
              + f"; 2-entry mesh / one entry wall {res[0][3] / res[1][3]:.2f}x", flush=True)
    count = torch.cuda.device_count()
    if count > 1:
        prob = dry.problem(full=True, num=2 * 1024 * count, interp_num=0)
        real = dry.run_route("ongrid", make_mesh(connect_to_devices(DeviceConfig())),
                             1024, prob)
        one = dry.run_route("ongrid", make_mesh(["cuda:0"]), 1024 * count, prob)
        print("  devices_split " + dry.check_route("ongrid", real, one, 2)
              + f"; {count} cards {real[3]:.3f} s against one card {one[3]:.3f} s")
    else:
        print("  devices_split: one card visible; the mesh of real cards was not run")
    phase("devices_split", t0, f"[cuda:0, cuda:0] against [cuda:0] at chunk {SPLIT_CHUNK}: "
          f"on-grid and off-grid {SPLIT_SAMPLES} samples, interpolation "
          f"{SPLIT_INTERP_SAMPLES}, bitwise")


def multiprocess_phase(seed, files_full):
    """main_multiprocess: torchrun with two processes on one card
    (CUDA_VISIBLE_DEVICES=0 for both, the gather over gloo) running the
    CLI on main_resume's inputs: both ranks log num_devices 2, warn that
    they share the card, and launch half of the chunk-curves' kernels
    each; only rank 0 exports, and its files are bitwise main_resume's
    uninterrupted run's."""
    import socket
    t0 = time.perf_counter()
    rungs = len(ladder_schedule(False)[1]) - 1
    per_rank = 3 * -(-RESUME_SAMPLES // 2048)             # chunk-curves, chunk 2 x 1024
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="trpl_smoke_") as tmp:
        cfg_path = write_main_inputs(tmp, RESUME_SAMPLES, seed)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
               "--master-port", str(port), "-m", "bayesian_inference_trpl_tpu_torch.run",
               cfg_path, "--log-dir", os.path.join(tmp, "Logs")]
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="0")
        t1 = time.perf_counter()
        out = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                             capture_output=True, text=True, timeout=MULTIPROCESS_TIMEOUT_S)
        wall = time.perf_counter() - t1
        log = out.stdout + out.stderr
        if out.returncode != 0:
            raise AssertionError(f"main_multiprocess: torchrun exited {out.returncode}:\n"
                                 f"{log[-4000:]}")
        d = os.path.join(tmp, "out", "smoke")
        files = {f: open(os.path.join(d, f), "rb").read()
                 for f in sorted(os.listdir(d)) if "_BAYRAN_" in f}
        n_logs = len(os.listdir(os.path.join(tmp, "Logs")))
    done = [ln for ln in log.splitlines() if "INFO: Done: " in ln]
    infos = {("[rank 1]" in ln): json.loads(ln.split("INFO: Done: ", 1)[1]) for ln in done}
    exports = [ln for ln in log.splitlines() if "Exported BAYRAN files" in ln]
    want = {"stride_1": per_rank, "stride_s": per_rank * rungs}
    for rank, info in sorted(infos.items()):
        print(f"  main_multiprocess rank {int(rank)}: num_devices {info['num_devices']}, "
              f"devices {info['device']}, launches {info['launches']}, solver_time "
              f"{info['solver_time']:.2f} s, runtime {info['runtime']:.2f} s")
        if info["num_devices"] != 2 or info["launches"] != want:
            raise AssertionError(f"main_multiprocess rank {int(rank)}: {info}, expected "
                                 f"num_devices 2 and launches {want}")
    shared = [ln for ln in log.splitlines() if "shares card(s)" in ln]
    if len(shared) != 2:
        raise AssertionError(f"main_multiprocess: {len(shared)} ranks warned of the "
                             f"shared card, expected 2:\n{log[-4000:]}")
    if len(done) != 2 or len(infos) != 2:
        raise AssertionError(f"main_multiprocess: {len(done)} ranks reported:\n{log[-4000:]}")
    if len(exports) != 1 or "[rank 1]" in exports[0] or n_logs != 1:
        raise AssertionError(f"main_multiprocess: exports logged {exports}, {n_logs} log "
                             f"files; only rank 0 exports and writes the run log")
    if files != files_full:
        raise AssertionError("main_multiprocess: the exported files differ from "
                             "main_resume's uninterrupted run's")
    phase("main_multiprocess", t0, f"torchrun 2 processes on one card, {RESUME_SAMPLES} "
          f"samples x 3 curves: {wall:.2f} s wall, {3 * RESUME_SAMPLES / wall * 60:.0f} "
          f"sims/min; {len(files)} files bitwise main_resume's, exported by rank 0 alone")


def profile_phase(paths, seed, card_line):
    """main_profile: main's inputs at PROFILE_SAMPLES samples with [device]
    profile_dir; the trace read back: the device idle share over
    simulate's window and over the chunk loop (first kernel to simulate's
    end), and the longest gaps between kernels.  Around it, C10's launch
    rates (tools/launch_rate.py): before, after the same run untraced (the
    control), after the traced run, after a teardown (gc.collect and a
    synchronize), and in a fresh process."""
    import gc
    from bayesian_inference_trpl_tpu_torch.tools import launch_rate
    rungs = len(ladder_schedule(False)[1]) - 1
    run = functools.partial(paths.run, "", "fused_horizon_chord", PROFILE_SAMPLES,
                            {"stride_1": 1, "stride_s": rungs}, keep_counts=False)
    rates = {"before": launch_rate.launch_us()}
    run(name="main_profile_control")
    rates["after the same run untraced"] = launch_rate.launch_us()
    with tempfile.TemporaryDirectory(prefix="trpl_smoke_") as tdir:
        run(name="main_profile", profile_dir=tdir)
        t0 = time.perf_counter()
        rates["after the traced run"] = launch_rate.launch_us()
        gc.collect()
        torch.cuda.synchronize()
        rates["after gc.collect and synchronize"] = launch_rate.launch_us()
        files = os.listdir(tdir)
        if files != ["trace_rank0.json"]:
            raise AssertionError(f"main_profile: trace files {files}")
        with open(os.path.join(tdir, files[0])) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(os.path.join(tdir, files[0]))
    rep = trace_idle(events)
    print(f"  main_profile: trace {size / 1e6:.1f} MB, {rep['kernels']} kernel events "
          f"({rep['by_name']}); simulate window {rep['window_ms']:.1f} ms, kernels busy "
          f"{rep['busy_ms']:.1f} ms: device idle share {rep['idle']:.4f}; chunk loop (first "
          f"kernel to simulate's end) {rep['loop_ms']:.1f} ms: idle share "
          f"{rep['loop_idle']:.4f}; before the first kernel {rep['lead_ms']:.1f} ms; longest "
          f"gaps between kernels {rep['gaps_ms']} ms; {card_line}")
    out = subprocess.run([sys.executable, "-m",
                          "bayesian_inference_trpl_tpu_torch.tools.launch_rate"],
                         capture_output=True, text=True, timeout=120, check=True)
    rates["in a fresh process"] = json.loads(out.stdout.strip().splitlines()[-1])["rate"]
    ref = rates["before"]
    print(f"  launch rate (us per launch of {launch_rate.LAUNCHES} one-element adds, fastest "
          f"/ median of {launch_rate.REPEATS} loops; against the rate before): " + "; ".join(
              f"{k} {r['min']:.3f} / {r['median']:.3f} ({r['min'] / ref['min'] - 1:+.1%} / "
              f"{r['median'] / ref['median'] - 1:+.1%})" for k, r in rates.items())
          + f"; {card_line}")
    phase("main_profile_trace", t0, "torch.profiler trace of simulate read back; the "
          "launch rates")


def trace_idle(events):
    """Device idle share from a Chrome trace: 1 - (union of kernel
    intervals / window) over the ``simulate`` annotation, and over the
    chunk loop from the first kernel to its end."""
    sim = [e for e in events if e.get("name") == "simulate" and e.get("cat") == "user_annotation"]
    if len(sim) != 1:
        raise AssertionError(f"main_profile: {len(sim)} simulate annotations")
    lo, hi = sim[0]["ts"], sim[0]["ts"] + sim[0]["dur"]
    kern = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi), e["name"])
                  for e in events if e.get("cat") == "kernel")
    kern = [k for k in kern if k[1] > k[0]]
    if not kern:
        raise AssertionError("main_profile: no kernel inside simulate's window")
    busy, gaps, end = [], [], None
    for a, b, _ in kern:
        if end is None or a > end:
            if end is not None:
                gaps.append(a - end)
            busy.append([a, b])
        else:
            busy[-1][1] = max(busy[-1][1], b)
        end = busy[-1][1]
    busy_us = sum(b - a for a, b in busy)
    by_name = {}
    for a, b, name in kern:
        short = re.sub(r"^void |\(anonymous namespace\)::", "", name).split("<")[0][-40:]
        by_name[short] = by_name.get(short, 0) + 1
    first = kern[0][0]
    return dict(kernels=len(kern), by_name=by_name, window_ms=(hi - lo) / 1e3,
                busy_ms=busy_us / 1e3, idle=1 - busy_us / (hi - lo),
                loop_ms=(hi - first) / 1e3, loop_idle=1 - busy_us / (hi - first),
                lead_ms=(first - lo) / 1e3,
                gaps_ms=[round(g / 1e3, 2) for g in sorted(gaps, reverse=True)[:5]])


def gate_phase(hk):
    """tools/accuracy_gate.main on the bundled batch-8 synthetic caches,
    seeds GATE_SEEDS, for each of GATE_METHODS and GATE_ADAPTIVE
    (--adaptive-fine-tau): an asserted run's FAIL exits the script; the
    others print their verdict."""
    from bayesian_inference_trpl_tpu_torch.tools import accuracy_gate as gate
    t0 = time.perf_counter()
    caches = [gate.bundled_cache(POWER_SCAN["T"], 8, s, "synthetic") for s in GATE_SEEDS]
    missing = [str(c) for c in caches if not c.exists()]
    if missing:
        raise FileNotFoundError(f"accuracy gate: exact caches missing: {missing}")
    for method, asserted in GATE_METHODS:
        lays = [hk.launch_layout(8, POWER_SCAN["L"], 8, s, 0, method != "fused_horizon")
                for s in (1, 16, 32, 64)]
        print(f"  gate layout {method} (8 samples, 8 experiments, strides 1/16/32/64): "
              + "; ".join(f"{d['samples_per_block']} per block, {d['smem_per_block']} B"
                          for d in lays))
    reports = []
    orig = gate.run_gate

    def rec(*a, **kw):
        reports.append(orig(*a, **kw))
        return reports[-1]
    gate.run_gate = rec
    try:
        for method, asserted, tau in [m + (None,) for m in GATE_METHODS] + [GATE_ADAPTIVE]:
            for seed in GATE_SEEDS:
                argv = ["--profile", "synthetic", "--batch", "8", "--seed", str(seed),
                        "--T", str(POWER_SCAN["T"]), "--method", method, "--device", "cuda"]
                if tau:
                    argv += ["--adaptive-fine-tau", str(tau)]
                for k in hk.launches:
                    hk.launches[k] = 0
                try:
                    gate.main(argv)
                    verdict = "PASS"
                except SystemExit as exc:
                    if asserted or exc.code != 1:
                        raise
                    verdict = "FAIL (reported, not asserted)"
                r = reports[-1]
                tag = f" adaptive tau {tau:g} ns ({r['adaptive_fine_bucket']} of 8 in the bucket)" \
                    if tau else ""
                print(f"  gate {method}{tag} s{seed}: {verdict}; rms 7-decade "
                      f"{r['rms_log10_pl_max_meas']:.4e}, 10-decade {r['rms_log10_pl_max']:.4e}, "
                      f"mean {r['rms_log10_pl_mean']:.4e}, full {r['rms_log10_pl_max_full']:.4e}; "
                      f"non-converged {r['non_converged']}; fast {r['fast_seconds']} s; "
                      f"launches {dict((k, v) for k, v in hk.launches.items() if v)}",
                      flush=True)
    finally:
        gate.run_gate = orig
    phase("gate", t0, "accuracy gate on exact_T80000_b8_s0/s1 (chord and adaptive "
          "chord asserted)")


def posterior_phase(hk, kind, num_samples, seed):
    """tools/posterior_equivalence.main on the smoke's inputs (on-grid or
    off-grid): the ladder against exact fixed-dt stepping; a FAIL exits.
    Per chunk and curve the ladder launches once per phase and the exact
    side once."""
    from bayesian_inference_trpl_tpu_torch.tools import posterior_equivalence as pe
    name = "posterior" + ("_offgrid" if kind else "")
    rungs = len(ladder_schedule(False)[1]) - 1
    cc = 3 * -(-num_samples // 1024)
    want = ({"offgrid": (rungs + 2) * cc} if kind
            else {"stride_1": 2 * cc, "stride_s": rungs * cc})
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="trpl_smoke_") as tmp:
        cfg_path = write_main_inputs(tmp, num_samples, seed, bool(kind))
        for k in hk.launches:
            hk.launches[k] = 0
        rc = pe.main(["--config", cfg_path, "--num-samples", str(num_samples),
                      "--device", "cuda"])
    if rc != 0:
        raise AssertionError(f"{name}: posterior equivalence FAIL")
    got = {k: v for k, v in hk.launches.items() if v}
    if got != want:
        raise AssertionError(f"{name}: launches {got}, expected {want}")
    phase(name, t0, f"{num_samples} samples x 3 curves, ladder vs exact fixed-dt: PASS; "
          f"launches {got}")


def mode_of(r):
    if r["pl_stride"]:
        return "stride_1_record_states" if r["states"] else "stride_1_record"
    mode = "offgrid" if r["K"] else "stride_1" if r["stride"] == 1 else "stride_s"
    return mode if r["chord"] else mode + "_full"


def compare_modes(hk, kind, method, seed, err64, plain32, timing):
    """Kernel vs plain in float64 (64 samples) and float32 (the chunk, 1024
    samples) on the shortened ladder, then the kernel alone on the full
    ladder at the chunk, timed; on-grid (kind "") or off-grid, chord or
    full Newton (``method``)."""
    offgrid = kind == "offgrid"
    suffix = ("_full" if method == "fused_horizon" else "") + ("_offgrid" if offgrid else "")
    t0 = time.perf_counter()
    run = ladder_inputs(64, torch.float64, seed, offgrid, method, short=True)
    for r in compare_phase(hk, run, "f64"):
        e = check_f64(r)
        err64[mode_of(r)] = max(err64.get(mode_of(r), 0.0), e)
        print(f"  f64 {r['label']} x {r['steps']} steps, 64 samples: "
              f"conv/its/fulls/execs equal, max abs err {e:.3e}, "
              f"final N/P/E bitwise equal, "
              f"conv {int(r['out'].conv.sum())}/64, fulls mean "
              f"{float(r['out'].fulls.float().mean()):.1f}")
    phase(f"compare{suffix}_f64", t0, f"kernel == plain(group=1) within {F64_RTOL} relative")

    t0 = time.perf_counter()
    run = ladder_inputs(1024, torch.float32, seed, offgrid, method, short=True)
    for r in compare_phase(hk, run, "f32"):
        conv_eq, within, rmax, amax = check_f32(r)
        plain32.setdefault(mode_of(r), []).append(r)
        print(f"  f32 {r['label']} x {r['steps']} steps, 1024 samples: "
              f"conv equal {conv_eq:.4f}, sse within {F32_RTOL}: {within:.4f} "
              f"(max rel {rmax:.2e}), final N/P max rel diff "
              f"{state_rel(r['out'], r['ref']):.1e}; plain {r['plain_ms']:.1f} ms; "
              f"its/sample {float(r['out'].its.float().mean()):.1f}, "
              f"execs/sample {float(r['out'].execs.float().mean()):.1f}, "
              f"fulls/sample {float(r['out'].fulls.float().mean()):.1f}")
    phase(f"compare{suffix}_f32", t0, "kernel vs plain(group=1) at chunk 1024")

    t0 = time.perf_counter()
    for r in time_phase(hk, ladder_inputs(1024, torch.float32, seed, offgrid, method)):
        timing.setdefault(mode_of(r), []).append(r)
        out = r["out"]
        print(f"  kernel f32 {r['label']} x {r['steps']} steps, 1024 samples: "
              f"{r['kernel_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{100 * r['bound_ms'] / r['kernel_ms']:.1f}% of it reached); "
              f"conv {int(out.conv.sum())}/1024, its/sample {float(out.its.float().mean()):.1f}, "
              f"fulls/sample {float(out.fulls.float().mean()):.1f}")
    print(f"  after the timed launches: {clocks()}")
    phase(f"time{suffix}", t0, "kernel per launch on the full ladder at chunk 1024")


def compare_newton_step(nk, solver, seed, err64, plain32, timing):
    """The per-step kernel against coupled_newton_step on the recorded
    inputs of steps from every phase of the shortened ladder, run with
    coupled_newton_pallas (float64 and float32, 1024 samples) on the eager
    route, whose steps call the wrapper."""
    from bayesian_inference_trpl_tpu_torch.models import step_graph
    from bayesian_inference_trpl_tpu_torch.models.newton import coupled_newton_step
    T1 = POWER_SCAN["fast_fine_steps"]
    starts = [0, T1] + [T1 + k * SHORT_RUNG_STEPS for k in (1, 2)]
    picks = sorted({s + o for s in starts for o in (0, 1, 2, 5, 40)}
                   | {T1 - 1, T1 + 3 * SHORT_RUNG_STEPS - 1})
    for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
        t0 = time.perf_counter()
        steps, seen = [], [0]
        orig = solver.newton_step

        def rec(*a, **kw):
            if seen[0] in picks:
                steps.append((seen[0], tuple(x.clone() if isinstance(x, torch.Tensor)
                                             else x for x in a[:5]) + a[5:], dict(kw)))
            seen[0] += 1
            return orig(*a, **kw)
        solver.newton_step = rec
        try:
            with step_graph.route("eager"):
                ladder_inputs(1024, dtype, seed, method="coupled_newton_pallas",
                              short=True)(None)
        finally:
            solver.newton_step = orig
        assert seen[0] == T1 + 3 * SHORT_RUNG_STEPS, seen[0]
        worst = 0.0
        for idx, a, kw in steps:
            out = nk.newton_step(*a, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ref = coupled_newton_step(*a, **kw)
            torch.cuda.synchronize()
            # The kernel alone (a bound launch), and with the wrapper's host
            # work (checks, allocation) around each launch.
            r = dict(steps=1, out=out, ref=ref, plain_ms=1e3 * (time.perf_counter() - t1),
                     kernel_ms=cuda_ms(nk.step_launcher(*a, **kw)[0], 20),
                     wrapper_ms=cuda_ms(lambda: nk.newton_step(*a, **kw), 20))
            its, conv = out[3], out[4]
            L = out[0].shape[1]
            ops = L * (its.numel() * OPS_NEWTON_CALL
                       + float(its.double().sum()) * (OPS_ITER + OPS_FULL))
            es = out[0].element_size()
            nbytes = 8 * out[0].numel() * es + 12 * its.numel() * es + 8 * its.numel() + 3 * es
            t_ops, t_bytes = ops / PEAK_FP32, nbytes / HBM_BYTES_PER_S
            r["bound_ms"] = max(t_ops, t_bytes) * 1e3
            r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
            if tag == "f64":
                if not (torch.equal(its, ref[3]) and torch.equal(conv, ref[4])):
                    raise AssertionError(f"f64 newton_step at step {idx}: its/conv differ")
                for x, y in zip(out[:2], ref[:2]):
                    rel = float(((x - y).abs() / y.abs().clamp_min(1e-300)).max())
                    if rel > F64_RTOL:
                        raise AssertionError(f"f64 newton_step at step {idx}: N/P rel "
                                             f"{rel:.3e} > {F64_RTOL}")
                    worst = max(worst, float((x - y).abs().max()))
                escale = ref[2].abs().amax(1, keepdim=True).clamp_min(1e-300)
                erel = float(((out[2] - ref[2]).abs() / escale).max())
                if erel > F64_RTOL:
                    raise AssertionError(f"f64 newton_step at step {idx}: E error "
                                         f"{erel:.3e} of its scale > {F64_RTOL}")
                err64["newton_step"] = max(err64.get("newton_step", 0.0), worst)
                msg = f"its/conv equal, N/P max abs err {worst:.3e}, E {erel:.1e} of scale"
            else:
                conv_eq = float((conv == ref[4]).float().mean())
                both = conv & ref[4]
                rel = torch.maximum(*[((x - y).abs() / y.abs().clamp_min(1e-30)).amax(1)
                                      for x, y in zip(out[:2], ref[:2])])[both]
                within = float((rel <= F32_RTOL).float().mean()) if rel.numel() else 1.0
                if conv_eq < F32_MIN_SHARE or within < F32_MIN_SHARE:
                    raise AssertionError(f"f32 newton_step at step {idx}: conv equal on "
                                         f"{conv_eq:.4f}, N/P within {F32_RTOL} on {within:.4f}")
                plain32.setdefault("newton_step", []).append(r)
                timing.setdefault("newton_step", []).append(r)
                msg = (f"conv equal {conv_eq:.4f}, N/P within {F32_RTOL}: {within:.4f}; "
                       f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}, "
                       f"{100 * r['bound_ms'] / r['kernel_ms']:.1f}% of it reached)")
            print(f"  {tag} newton_step at step {idx}, 1024 samples: {msg}; kernel "
                  f"{r['kernel_ms']:.4f} ms (with the wrapper {r['wrapper_ms']:.4f} ms), "
                  f"plain {r['plain_ms']:.2f} ms; its/sample "
                  f"{float(its.float().mean()):.2f}, conv {int(conv.sum())}/1024")
        phase(f"compare_newton_step_{tag}", t0,
              f"per-step kernel vs coupled_newton_step on {len(steps)} recorded steps")


class MainPaths:
    """The port's CLI on synthetic data, one path per call; the launch
    counts are zeroed just before the run and read just after.  Every
    kernel of the path must have launched exactly as expected, and no
    other."""

    def __init__(self, hk, nk, run_main, bio, args, counts):
        self.hk, self.nk, self.run_main, self.bio = hk, nk, run_main, bio
        self.seed, self.counts = args.seed, counts
        self.results, self.configs = {}, {}

    def launches(self):
        from bayesian_inference_trpl_tpu_torch.ops import histogram
        return dict(self.hk.launches, newton_step=self.nk.launches, **histogram.launches)

    def zero(self):
        from bayesian_inference_trpl_tpu_torch.models import step_graph
        from bayesian_inference_trpl_tpu_torch.ops import histogram
        for d in (self.hk.launches, histogram.launches, step_graph.replays):
            for k in d:
                d[k] = 0
        self.nk.launches = 0

    def cli(self, cfg_path, tmp, *extra):
        """One CLI run; returns (wall seconds, launches); its graph replays
        go to ``last_replays``."""
        self.zero()
        t0 = time.perf_counter()
        try:
            rc = self.run_main([cfg_path, "--log-dir", os.path.join(tmp, "Logs"), *extra])
            torch.cuda.synchronize()
        finally:
            logging.getLogger("bayes-trpl-torch").handlers.clear()
        if rc != 0:
            raise RuntimeError(f"run.main returned {rc}")
        from bayesian_inference_trpl_tpu_torch.models import step_graph
        self.last_replays = dict(step_graph.replays)
        return time.perf_counter() - t0, self.launches()

    def run(self, kind, method, num_points, per_chunk_curve, exact=False,
            grid_extra=None, name=None, expected=None, keep_counts=True, profile_dir=None,
            num_curves=3, dtype="float32", legacy_points=None):
        """Returns the run's wall seconds; its (P, X) go to
        ``results[name]`` and its loaded TOML to ``configs[name]``.
        ``kind``: "" on-grid, "offgrid" or "interp" (the off-grid times
        with offgrid_fused = false: the interpolation fallback).  ``exact``: no ladder (exact fixed-dt mode); its counts
        are kept as ``<kernel>_exact``.  ``grid_extra``: [grid] keys added
        or replaced.  ``expected``: the run's launches per kernel, in place
        of ``per_chunk_curve`` times the chunk-curves.  ``keep_counts``: the
        launches are the kernels line's for their kernels.  ``profile_dir``:
        [device] profile_dir.  ``num_curves``, ``dtype``, ``legacy_points``:
        as write_main_inputs; with ``legacy_points`` the grid holds
        ``num_points`` samples."""
        from bayesian_inference_trpl_tpu_torch.config import load_config
        name = name or "main" + {"fused_horizon_chord": "", "fused_horizon": "_full",
                                 "coupled_newton_pallas": "_newton_step"}[method] + (
                                     f"_{kind}" if kind else "") + ("_exact" if exact else "")
        if kind == "interp":
            grid_extra = dict(grid_extra or {}, offgrid_fused=False)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="trpl_smoke_") as tmp:
            cfg_path = write_main_inputs(tmp, num_points, self.seed, bool(kind), method,
                                         exact, grid_extra, profile_dir, num_curves, dtype,
                                         legacy_points)
            self.configs[name] = load_config(cfg_path)
            T = self.configs[name].grid.num_steps
            print(f"  {name} path: method {method}; num_points reduced 131072 -> "
                  f"{num_points}" + (f" (legacy grid, {legacy_points} per free dimension)"
                                     if legacy_points else "")
                  + f"; {num_curves} curve{'s' if num_curves > 1 else ''} x {T} steps; "
                  f"chunk 1024; {dtype}"
                  + (f"; t = 0 plus {OFFGRID_POINTS} log-spaced times per curve"
                     if kind else "")
                  + (f"; no ladder (exact fixed-dt), {self.configs[name].grid.predictor} "
                     "predictor" if exact else "")
                  + (f"; [grid] {grid_extra}" if grid_extra else ""), flush=True)
            phase(f"{name}_inputs", t0, f"synthetic data and TOML in {tmp}")
            main_s, run_counts = self.cli(cfg_path, tmp)
            P, X = self.bio.load_bayran(os.path.join(tmp, "out", "smoke"))
        if P.shape != (num_points,) or X.shape != (num_points, 13):
            raise AssertionError(f"BAYRAN shapes {P.shape} {X.shape}")
        self.results[name] = (P, X)
        finite = float(np.isfinite(P).mean())
        sims_per_min = num_curves * num_points / main_s * 60.0
        phase(name, t0, f"{num_points} samples x {num_curves} curve"
              f"{'s' if num_curves > 1 else ''}; {sims_per_min:.0f} "
              f"sims/min; finite share of P {finite:.4f}; launches {run_counts}")
        if finite < 0.99:
            raise AssertionError(f"finite share of P {finite:.4f} < 0.99")
        chunk_curves = num_curves * -(-num_points // 1024)
        want = expected or {k: v * chunk_curves for k, v in per_chunk_curve.items()}
        for k, v in run_counts.items():
            if v != want.get(k, 0):
                raise AssertionError(f"{name} path launched the {k} kernel {v} "
                                     f"times, expected {want.get(k, 0)}")
        print("  launches as expected: " + (
            ", ".join(f"{v} {k}" for k, v in want.items()) if expected else
            f"{', '.join(f'{v} {k}' for k, v in per_chunk_curve.items()) or 'no kernel'} "
            f"per chunk per curve, {chunk_curves} chunk-curves"))
        if keep_counts:
            self.counts.update({k + ("_exact" if exact else ""): run_counts[k]
                                for k in want})
        return main_s


if __name__ == "__main__":
    main()
