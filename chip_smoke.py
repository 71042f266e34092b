#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mvrecon_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and imports nothing of JAX or of ``mvrecon_tpu``.
Phases, each of which stops the script with a non-zero exit on failure:

1. header: the card's name and power limit, torch/CUDA versions, TF32
   switches (must be off);
2. build: every hand-written kernel, from ``mvrecon_tpu_torch/csrc/``,
   one ``nvcc`` per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes (K2 also at ``BundleAdjuster``'s Y (12288, 9216),
   from ``bundle_adjust_chunked``'s default chunk of 4096; K1 also at the
   non-fused chunked build's Y (2304, 9000), and its deferred-mirror sum
   over two chunks) and at
   k_rows that are no multiple of a kernel's stage, with its time, the
   plain version's, one PyTorch call's and the bound of the work;
4. pipeline: ``euclidean_reconstruction_large`` at 100k points x 1000
   views, float32, chunk 768, counting kernel launches on that run;
4i. robust chunked: phase 4's scene with 3 % of the observations moved by
   +-0.3 per component (60 sigma), ``bundle_adjust_chunked`` under the
   Huber loss (delta 0.02) from X and t perturbed by 0.02 N(0, 1), 10
   Nielsen iterations, then the same run under the plain loss: every
   output finite, K2 launches == robust retries x chunks, the inlier E at
   the noise floor (< 1.5x) and the robust X's aligned RMSE below half the
   plain run's;
4k. covariance: ``ba_covariance_chunked`` of phase 4's result (chunk 768,
   ``bench.py::bench_covariance``), one warm-up and one timed run: finite
   blocks, the estimated sigma within 5 % of the true one, the pinned
   gauge rows zero, symmetric blocks with no eigenvalue below -1e-6 of
   their largest; its second run, after 4c, holds ``ba_covariance`` and
   the chunked variant on phase 4c's result to 1e-3 of each other in
   float64 and reports their float32 gap;
4n. distorted chunked: phase 4's scene rendered through a shared BAL radial
   (k1, k2) = (-0.3, 0.05) (the port's own terms, then sigma noise),
   ``bundle_adjust_chunked`` (the fused build, K2) with two shared refit
   rounds from zero, 5 Nielsen iterations a segment; K2 launches == retries
   x chunks and no K1; then ``ba_covariance_chunked`` with its distortion;
4o. OPENCV chunked: the same scene through a shared OPENCV (-0.28, 0.035,
   0.018, -0.012), the non-fused build (K1, summed over the chunks with one
   mirror), one refit round; K1 launches == retries x chunks and no K2,
   K1's time a launch inside the run and the build's share of a retry;
   each distorted phase checks E / floor < 1.5 and that the recovered
   model reproduces the true one's displacement over the scene's rays
   (``model_error`` < 0.25), and reports k against the truth;
4r. the other families chunked: phase 4's scene through each of the
   shared fisheye, full OPENCV, FOV and thin-prism truths
   (``FAMILY_TRUTHS``), the non-fused build as in 4o, one shared refit round
   from ``default_distortion`` (the refit's 8 or 6 passes over the chunks
   launch nothing): K1 launches == retries x chunks, no K2, K1's median
   time a launch;
4b. streamed: ``bundle_adjust_streamed`` at 1M points x 500 views from
   host memory, float32, chunk 16384, prefetch 2, counting K1 launches,
   with the time of each pass, the host-to-device rate and the peak
   device memory, which must stay below the observations' 4.0 GB;
4l. streamed covariance: ``ba_covariance_streamed`` of phase 4b's result,
   with both pass times; finite blocks, the peak device memory below the
   observations' bytes;
4j. robust streamed: phase 4b's problem with 3 % gross outliers injected
   into the host observations a chunk at a time, ``bundle_adjust_streamed``
   under the Huber loss for 5 iterations: K1 launches == retries x chunks,
   the inlier E at the floor, the peak device memory below the
   observations' bytes;
4p. distorted streamed: phase 4b's problem re-rendered through the radial
   truth into the host observations a chunk at a time, one refit round,
   3 iterations a segment: K1 launches == retries x chunks, peak device
   memory below the observations' bytes;
4s. full OPENCV streamed: 4p with the full OPENCV truth, whose refit
   streams the observations once for each of its 8 rounds;
4c. dense BA: ``bundle_adjust`` at 10k points x 100 views, float32, from
   the true K and R with X and t perturbed by 0.05 N(0, 1), one warm-up
   and one timed run of 10 iterations, with the time of its layers (the
   derivative build, the Schur product, the Cholesky solve of either
   side); it launches neither kernel;
4d. ``euclidean_reconstruction`` (calibration, then dense BA) on the same
   observations, launching neither kernel;
4m. distorted dense: ``scripts/bench_bal.py``'s distorted problem (20k
   points x 100 views, each point seen by 20 consecutive views, the radial
   truth, 2 % of the observations moved by 0.5 N(0, 1), Huber, two shared
   refit rounds from zero) through ``bundle_adjust``: no launch, the
   inlier E at the floor;
4q. the same problem through each family of 4r, one refit round from
   ``default_distortion``;
4t. ``bal``: the subcommand in process on the card, on COLMAP models of
   4m's scene that ``save_colmap`` writes for OPENCV_FISHEYE, FOV and
   THIN_PRISM_FISHEYE (chunk 768, one refit round, covariance, the
   undistorted pinhole model), checked on its record and on the pinhole
   model it writes;
4u. sparse: ``bundle_adjust_sparse`` (the observation-list core, plain
   PyTorch, no hand-written kernel) on ``bench.py::bench_bal_large``'s
   problem rebuilt on the card: 1M points x 1,600 cameras x 10M
   observations (0.625 % fill), 2 % outliers, Huber 0.02, 12 Nielsen
   iterations, ``cg_tol=1e-2``, ``cg_max_iter=40``, twice: both runs equal
   to the digit, inlier E/floor < 1.5, aligned RMSE < 0.05, the peak device
   memory below the 12.8 GB of the dense (P, F, 2) observations, with
   CUDA-event spans of the build, each CG matvec and the trial error;
4v. the same problem for 3 iterations stored, with ``factor_mode=
   "recompute"`` (E within 1e-4 of stored) and with bfloat16 factors (E
   below the start), each with its peak;
4w. ``bal --sparse`` in process on BAL files of 4m's problem (held: two
   tied refit rounds from the file's points; ``--triangulate-init`` on the
   scene rendered without distortion or outliers; reported: the triangulated
   start with one refit round on the distorted problem, F12), then
   ``resumable_bundle_adjust_sparse`` in 3-iteration segments against one
   continuous run in float64, and a run stopped and re-invoked from its
   checkpoint; phases 4u-4w launch neither kernel;
4x. ``reconstruct`` in process on an npz of the dense headline's scene
   (10k points x 100 views, ``X_gt``), 0.1 % of the observations moved by
   +0.1 and masked out in ``visibility``: float32 with ``--output``,
   ``--output-ply`` and ``--log-json`` (the low-rank depth eigensolve picked,
   since the dense one's Grams exceed the card; status 0, E over the visible
   observations at the floor, the outputs read back at their shapes), then
   ``--float64 --covariance`` (sigma within 5 %); no launch of either kernel;
4y. ``bench-ba`` in process: ``--chunked`` at 100k points x 1000 views,
   chunk 768, 10 iterations (K2 launches, K1 does not), the dense core at
   10k x 100 (no launch), and that run again under ``--profile`` (a trace
   file appears); each below its start E;
4z. the reference-named API: ``BundleAdjuster`` at 20k points x 1000 views,
   whose coupling blocks (2.16 GB) exceed its 1.5 GB threshold, so it runs
   the chunked core (K2) with a scalar debug log ending at its E;
   ``MinimumSpanningTree`` on a 1,000-node graph with tied weights on the
   native route, equal to a plain Kruskal; the perspective shim on a list
   of ten (200, 2) arrays, status 0;
4e. ``euclidean_reconstruction_large`` on phase 4's scene with the camera
   bootstrap (12 iterations on a 10 % subsample, DLT re-triangulation),
   whose K2 launches are the final BA's retries x chunks plus a positive
   multiple of the subsample's chunks;
4f. ``batched_euclidean_reconstruction`` on 256 scenes x 100 views x 200
   points (``bench.py::bench_batched``'s configuration: dual, lowrank,
   blocks of 64 scenes, 15 Nielsen iterations), one warm-up and one timed
   run; every scene status 0 and finite, worst E / floor < 1.5;
4g. the same scenes to convergence (``delta_tol=1e-3``): through the lanes
   with a budget of 40, then by scene compaction
   (``batched_euclidean_to_convergence``), with what the finished lanes
   cost;
4h. ``batched_affine_reconstruction`` on 256 scenes x 12 views x 200
   points (paraperspective; every scene finite and below its start E, the
   median at the floor, at most 10 % of the scenes above 1.5x it, as the
   reference algorithm leaves about 4 %), then ``affine_reconstruction``
   at 10k points x 100 views for each affine model;
   phases 4c-4h launch neither kernel;
5a. point-sharded chunked BA (``parallel/sharded_ba.py``), after 4d: 4o's
   problem, rendered anew into host memory from its seed, through
   ``sharded_bundle_adjust_chunked`` on a one-rank NCCL group, against
   4o's run: the same retries and K1 launches, E within 1e-6, and the
   all-reduce's bytes and time a retry;
5b. the same problem on two ranks on the one card, processes that the
   script starts (``--sharded-rank``) with gloo named for CUDA tensors
   (NCCL takes one rank a card): 5a's retries, E within 1e-5 of 5a's, X,
   K, R, t within ``SHARDED_X_ATOL`` and ``SHARDED_CAM_ATOL`` of 5a's, the
   ranks' results equal; K1 launches, all-reduce bytes and ms a retry and
   peak memory per rank. A rank that fails or passes
   ``SHARDED_RANK_TIMEOUT_S`` stops both and fails the script;
5c. 4c's problem through ``sharded_bundle_adjust`` on the NCCL rank (E
   within 1e-6 of 4c's) and on the two ranks (below the start E), and one
   ``sharded_lm_step`` against ``lm_step`` (E within 1e-6); no K1 or K2
   launch;
5f. ``sharded_ba_covariance`` of 5c's result against ``ba_covariance`` on
   the same state, at one rank and on the two: float64 blocks within 2e-6
   of the largest entry; in float64 and float32 NaN exactly where the
   unsharded blocks have it (F10), the same n_obs and sqrt(sigma^2) within
   5 % of sigma; each wall; the float32 blocks' gap is printed, not held
   (F10);
5e. ``sharded_euclidean_reconstruction`` on 4d's observations at one rank
   and two: status 0, E / floor < 1.5, E within 3e-4 of 4d's, no launch;
5d. ``euclidean_reconstruction_large(mesh=)`` on phase 4's scene at one
   rank and two: the calibration sharded, the chunked BA whole on every
   rank (K2 launches == retries x chunks a rank); status 0, E / floor <
   1.5, E within 1e-4 of phase 4's, the ranks equal; the calibration's
   wall, depth iterations, Gram all-reduce (36 MB at 1000 views) bytes and
   ms an iteration, peak memory;
5g. the commands with ``--shard-points 1`` and no launcher, in process,
   against the same commands unsharded (E within 1e-6, the same launches,
   ``shard_points`` in the record): ``euclidean --float64`` (after 4x),
   4x's float64 ``reconstruct`` with ``--covariance`` (in 4x) and 4t's
   fisheye ``bal --chunk-size 768`` (in 4t; K1 launches == retries x
   chunks);
5h. ``sharded_bundle_adjust_sparse`` (``parallel/sharded_ba_sparse.py``)
   on 4u's list, written once by the script into the ranks' directory
   (1M points x 1,600 cameras x 10M observations, 4u's configuration),
   on the NCCL rank (E, retries and CG iterations equal to 4u's) and on
   the two ranks (E within 1e-4 of 4u's, the ranks equal); aligned RMSE
   < 0.05, no launch; retries, CG iterations, wall, peak memory a rank,
   the all-reduce's bytes and ms a retry and a CG iteration;
5i. ``sharded_affine_reconstruction`` on 4h's 10k x 100 paraperspective
   scene at one rank and two: status 0, E / floor < 1.5, E within
   ``SHARDED_AFFINE_E_RTOL`` of ``affine_reconstruction`` on the same
   scene, the ranks equal, no launch; the sharded calibration's S and R
   within ``SHARDED_AFFINE_CALIB_GAP`` of the unsharded one's (float32
   Gram eigh against SVD); ``shard_scenes`` of 4f's batch at
   one rank (every scene equal to 4f's) and two (each rank its half);
5j. two-rank commands inside the ranks' process group (``cli.main`` with
   ``--shard-points 2``): ``euclidean`` and ``affine`` at 10k x 100 in
   float64, 4t's fisheye ``bal --chunk-size 768`` (K1 under the
   all-reduce: a positive multiple of the chunks a rank) and ``bal
   --sparse`` on 4w's BAL file in float64; rank 0's record against the
   same command at one rank (5g's for ``bal``, new runs for the others),
   E within ``SHARDED_CLI_E_RTOLS``; rank 1 prints nothing; ``bal
   --sparse``'s list through ``sharded_bundle_adjust_sparse`` at cg_tol
   1e-12 at one rank and two: E within 1e-10, the same iterations and
   retries, CG counts within 5 %;
5k. the 2D (points x cameras) BA (``parallel/sharded_ba_2d.py``), after
   5j, in the same one-rank NCCL group and two rank processes: 4c's
   generator and schedule at 10,000 points x 2,000 views in float32
   through ``sharded_bundle_adjust`` (1D, Cholesky; the reference) on the
   NCCL rank, and ``sharded_bundle_adjust_2d`` in both matvec modes on a
   1 x 1 mesh there and on a {points: 1, cameras: 2} mesh of the two
   ranks: finite, below the start E, E / floor < 1.5, the ranks equal, no
   launch, the peak memory a rank at 1 x 2 below 1 x 1's; the E gap to the
   1D run printed. Then float64 at 1,000 points, 5 iterations,
   ``cg_tol=1e-12``: E within 1e-7 of the 1D core's, ring within 1e-9 of
   all_gather, no solve at its CG cap. Each run prints its retries, CG
   iterations a solve, wall and peak memory a rank, and the cameras-axis
   traffic (the gather's bytes and ms a call, the ring's point-to-point
   bytes and ms a matvec, the pmax's bytes a solve) and the row block's
   all-reduce over ``points`` (none on these meshes: a one-rank axis
   sends nothing);
5. the pipelines and the BA cores on small scenes on the card and on the
   CPU (plain versions), which must agree, the streamed core on the card
   with prefetch 0 and 2, which must agree bit for bit, both batched
   pipelines on three small scenes on each side, and a batch whose
   second scene is all NaN, which must end flagged while the others reach
   the floor, the robust dense and chunked cores on the small scene with
   gross outliers, ``ba_covariance`` in float64 (to 1e-8), and the six
   distortion families (one refit round, one iteration a segment) through
   the dense, chunked (fused and non-fused) and streamed cores, and the
   sparse core (stored, recompute, fisheye) card against CPU, and against
   the dense core in float64 on the card;
6. a ``kernels`` JSON line, the ``nvidia-smi`` line, and the result line
   ``{"ok": true, "device": {...}}`` last.

``--points`` shrinks phases 4, 4i, 4k, 4n, 4o, 4r, 4e, 4y's chunked run,
5a-5b and 5d (``--ba-iters`` sets the BA iterations of 4, 4e and 5d),
``--streamed-points`` phases 4b, 4l, 4j, 4p and 4s, ``--dense-points``
phases 4c, 4d, 4k's second run, 4x, 4y's dense runs, 5c, 5e, 5f, 5i,
5j's ``euclidean`` and ``affine`` and 5k (its views stay at 2,000),
``--bal-points`` phases 4m, 4q, 4t, 4w,
5j's ``bal`` runs and 4z's ``BundleAdjuster`` (below 20k points it may
take the dense core, and the launch check follows its choice),
``--sparse-points`` 4u, 4v and 5h, and ``--batched-scenes`` phases 4f-4h
and 5i's ``shard_scenes`` for a quick run; the views and the chunks stay
the main paths', so the kernel checks keep their shapes.

The point-sharded phases 5a-5k run after 4z, from one one-rank NCCL group
and one launch of two rank processes.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import inspect
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, SXM data sheet
H100_3XTF32_FLOPS = 495e12 / 3  # float32-accurate rate: three TF32 products per product
H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores, SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3 rate, SXM data sheet
NOISE = 0.005  # image noise of the synthetic scenes
VIEWS = 1000  # north-star views: the reduced camera system is 9 * 1000 wide
CHUNK = 768  # north-star point chunk: K2's Y has 3 * 768 rows
STREAMED_VIEWS = 500  # streamed design point: 1M points x 500 views
STREAMED_CHUNK = 16384  # the streamed core's default chunk: K1's Y is (49152, 4500)
DENSE_VIEWS = 100  # dense headline (bench.py::bench_headline): 10k points x 100 views
BOOTSTRAP_FRAC = 0.1  # camera bootstrap of phase 4e: a 10 % subsample ...
BOOTSTRAP_ITERS = 12  # ... converged for 12 iterations
BATCH_VIEWS = 100  # bench.py::bench_batched: 256 scenes x 100 views x 200 points
BATCH_SLICES = 10  # the curved tube's 10 slices x 20 angles
BATCH_CHUNK = 64  # scenes per block
AFFINE_VIEWS = 12  # the reference affine demo's views per scene
# Phase 5 limits, from scripts/gpu_cpu_trajectory.py on an H100. From one
# calibration, E after BA iterations 1 and 2 agreed to 7e-7 and 3.1e-6.
# After 8 iterations the whole pipeline's E differed by 1.4e-3: the f32
# calibrations differ (projections by 3.5e-4), and the CPU alone moves E
# by up to 1.0e-3 when only the chunk size (the summation order) changes,
# and by 1.6e-3 from float32 to float64.
EARLY_ITER_RTOL = 2e-5
FINAL_E_RTOL = 5e-3
# The dense core's camera side (100 views x 200 points) forms its (600, 600)
# Schur complement by cancellation: after BA iteration 1 the CPU's float32
# and float64 E differ by 1.2e-5 and the card's float32 by 2.8e-5 from the
# CPU's (scripts/gpu_cpu_trajectory.py). Past iteration 1 a float32 accept
# decision there can flip with the summation order alone (the CPU with the
# points reversed: 1.6e-3 at iteration 2), so the limit holds only while
# both devices take the same path, as they do on this start.
CAMERA_SIDE_RTOL = 1e-4
# Phase 4k: the dense and the chunked covariance sum the Schur complement
# in other orders, and A's inverse amplifies the difference by A's
# condition number (6e7-2e9 on the CPU at 20-100 views, float64); the
# asymmetry of a block set is rounding in the solve against the identity
# and in the lift.
COV_DENSE_CHUNKED_RTOL = 1e-3
COV_ASYMMETRY_RTOL = 1e-3
# Phases 4i and 4j: 3 % of the observations become gross outliers, each
# component moved by +-0.3 (60 sigma, tests/test_robust_ba.py), and BA runs
# under the Huber loss at bench.py's scale (robust="huber", huber_delta=0.02)
OUTLIER_SHARE = 0.03
OUTLIER_SHIFT = 0.3
HUBER_DELTA = 0.02
ROBUST_ITERS = 10  # phase 4i's iterations, robust and plain
K2_DESIGN = ("bf16 wgmma m64n128k16, both operands MN-major from a 4-stage TMA ring of "
             "64-row stages; persistent blocks; the two consumer warpgroups take turns; "
             "old acc prefetched by TMA")
# Distortion phases (4m-4p and phase 5's distortion part): the shared truths
# are scripts/bench_bal.py:46's BAL radial (k1, k2) and
# tests/test_distortion.py::test_tangential_e2e_recovers_geometry_all_cores'
# OPENCV (k1, k2, p1, p2)
RADIAL_TRUTH = (-0.3, 0.05)
OPENCV_TRUTH = (-0.28, 0.035, 0.018, -0.012)
# Phases 4q-4t: the other four families, shared across the cameras, at the
# centres of tests/test_distortion.py's _fisheye_scene, _full_opencv_scene,
# _fov_scene and _thin_prism_scene truths
FAMILY_TRUTHS = {
    "fisheye": (-0.08, 0.02, 0.008, -0.004),
    "full_opencv": (-0.30, 0.05, -0.01, -0.12, 0.02, 0.005, 0.015, -0.01),
    "fov": (0.9,),
    "thin_prism": (-0.06, 0.015, -0.004, 0.002, 0.012, -0.009, 0.006, -0.005),
}
# 4q's start: X and t perturbed by 0.02 N(0, 1), as in 4n, 4o and 4r. On
# 4m's problem from 4m's 0.05 one refit at the start geometry misses the
# full-OPENCV model (model_error 0.65), and further rounds let the geometry
# absorb it (6.2 and 28 after 2 and 3); from 0.02 it still misses it under
# 4m's Huber loss and outliers (0.47: the refit's IRLS weights come from
# the zero model's residuals), not without them (0.15); fisheye, FOV and
# thin prism reach 0.04-0.09 (CPU, float32, 20k x 100:
# scripts/distortion_identifiability.py --bal [--outliers]). 4q holds
# full OPENCV's model on the plain problem and reports it on 4m's.
FAMILY_SIGMA = 0.02
# What a refit must recover: the true model's displacement over the
# scene's observed rays, to MODEL_TOL of its RMS (model_error). The
# parameters themselves are reported against the truth and not checked:
# on these narrow scenes k2 is not identified (model_error's docstring).
MODEL_TOL = 0.25
# Phase 5, distortion: on its 8-view x 80-point problem the CPU's own
# float32 runs part from float64, and from each other when only the order
# of the points or the chunked core's grouping of the sums changes, by
# (scripts/distortion_float32_noise.py) at most 2.8e-5 and 4.9e-5 for
# OPENCV (radial: 2.2e-5 on the dense core; its chunked core is the fused
# bf16 build), 3.7e-5 and 3.0e-5 for fisheye, 1.7e-4 and 2.2e-4 for full
# OPENCV, 9.3e-6 and 1.5e-5 for FOV, and 5.1e-4 and 9.1e-4 for thin prism,
# whose float32 8x8 refit of the theta^2..theta^8 regressors keeps the
# fewest bits: the residuals of about 6e-3 on coordinates of about 0.5 keep
# few bits. A new family's card against the CPU is held to five times the
# larger of its two, rounded up to one significant figure, and to no less
# than 1e-4; radial and OPENCV keep their 1e-4.
DISTORTION_RTOLS = {"radial": 1e-4, "opencv": 1e-4, "fisheye": 2e-4, "full_opencv": 2e-3,
                    "fov": 1e-4, "thin_prism": 5e-3}
DIST_ITERS = 5  # 4n and 4o: Nielsen iterations a segment
# Phases 5a-5c (point-sharded BA). One rank does the arithmetic of the
# unsharded core plus a one-rank all-reduce, so 5a and 5c hold E to 1e-6.
# Two ranks sum each rank's chunks apart and then add the two sums, so
# float32 rounding moves E, and the state by far less than one noise sigma
# (0.005): 5b holds E to 1e-5 of 5a's, X to one sigma and K, R, t to 1e-3.
SHARDED_RANKS = 2
SHARDED_RANK_TIMEOUT_S = 600
SHARDED_E_RTOL_ONE_RANK = 1e-6
SHARDED_E_RTOL_TWO_RANKS = 1e-5
SHARDED_X_ATOL = NOISE
SHARDED_CAM_ATOL = 1e-3
# Phases 5d-5g. 5d's and 5e's calibration eighs the all-reduced (3F, 3F)
# Gram where phases 4 and 4d take the low-rank depth eigensolve, so BA
# starts from another float32 calibration, and at two ranks the sums
# reorder too. On the H100 (a probe of 4, 4c, 4d and 5a-5g) 5d's E came
# 9.8e-8 (one rank) and 9.8e-7 (two) from phase 4's, 5e's 3.0e-5 and
# 1.5e-6 from 4d's; the limits are a hundred and ten times the larger (at
# 2,000 points x 16 views on the CPU 5d's two ranks part by 6e-5: the
# farther BA is from converging, the more its start shows). 5f's float64
# blocks differ from the unsharded ones by the order of the Schur sum
# alone (1.5e-9 of the largest entry at two ranks); JAX's bound is 2e-6.
# 5g's commands at one rank (float64 for euclidean and reconstruct) hold
# E to 1e-6 of their unsharded runs (equal to the digit in the probe).
SHARDED_LARGE_E_RTOL = 1e-4
SHARDED_PIPELINE_E_RTOL = 3e-4
SHARDED_COV_RTOL = 2e-6
SHARDED_CLI_E_RTOL = 1e-6
# Phases 5h-5j. 5h: one rank repeats 4u's arithmetic (the partition at one
# rank is the identity), so E, retries and CG iterations must equal 4u's;
# two ranks sum each rank's half of the list apart, the same operator in
# another summation order, held as 4v holds recompute against stored (on
# the H100, a probe of 4u and 5h-5j, E came equal to 4u's to the digit,
# after 12 retries and 387 CG iterations against 4u's 10 and 308). 5i:
# the sharded affine calibration eighs the all-reduced float32 (2F, 2F)
# Gram where the unsharded one takes the SVD of W, which squares W's
# condition, so S and R differ by more than rounding: on the H100, in
# three runs of the same scene (deterministic), S by 5.65e-5-5.85e-5 of its
# largest entry and R by 6.2e-5-1.30e-4, E after BA by 1.0e-6 (one rank)
# and 2.1e-6 (two) from the unsharded pipeline's; the limits are about ten
# times the largest reading. 5j, two ranks against one: ``euclidean`` and
# ``affine`` in float64 hold 5g's 1e-6 (0.0 in the probe); the float32
# chunked ``bal`` holds 5b's two-rank limit (2.1e-7). ``bal --sparse``
# stops CG at cg_tol 1e-2 on a residual test that the reordered sums move,
# so its count and step part from the one-rank run's once the iterates
# near the optimum (on the H100 its last segment took 487 CG iterations at
# two ranks against 333 at one, E 1.2077e-6 apart, the same in two runs):
# held at about ten times that reading. The same list, start and
# config at cg_tol 1e-12 (``SHARDED_SPARSE_TIGHT``), where CG runs to the
# rounding floor, holds the operator itself: E within 1e-10, iterations
# and retries equal, CG counts within 5 % (the count at 1e-12 still moves
# with the summation order, as ``tests/test_torch_sparse.py`` notes).
SHARDED_SPARSE_E_RTOL = 1e-4
SHARDED_CLI_SPARSE_E_RTOL = 1e-5
SHARDED_SPARSE_TIGHT = dict(cg_tol=1e-12, cg_max_iter=500)
SHARDED_SPARSE_TIGHT_E_RTOL = 1e-10
SHARDED_SPARSE_TIGHT_CG_RTOL = 0.05
SHARDED_AFFINE_E_RTOL = 2e-5
SHARDED_AFFINE_CALIB_GAP = 1e-3
SHARDED_CLI_E_RTOLS = {"euclidean": SHARDED_CLI_E_RTOL, "affine": SHARDED_CLI_E_RTOL,
                       "bal": SHARDED_E_RTOL_TWO_RANKS, "bal_sparse": SHARDED_CLI_SPARSE_E_RTOL}
# Phase 5k, the 2D (points x cameras) BA. In float32 at full width (4c's
# generator and schedule at 10,000 points x 2,000 views: 9F = 18,000
# unknowns) the CG keeps its defaults, cg_tol=1e-10 and cg_max_iter=200:
# the tolerance is below float32's reach, so every solve runs to the cap
# (JAX's semantics too), and the E gap to the 1D core's Cholesky solve is
# printed, not held. The float64 algebra at 1,000 points x 2,000 views, 5
# iterations: cg_tol=1e-12 with a cap no solve reaches, E within 1e-7 of
# the 1D core's (JAX's bound, tests/test_parallel.py) and ring within 1e-9
# of all_gather. Its LM damping starts at 1e-2, not 4c's 1e-4: on the
# H100 at the default a solve took 2,110-8,398 CG iterations (25,115 in
# the run), and the ring at two gloo ranks 189 s; on the CPU at 9F = 1,800
# the damping cut the counts sevenfold.
SHARDED_2D_VIEWS = 2000
SHARDED_2D_F64_POINTS = 1000
SHARDED_2D_F64_ITERS = 5
SHARDED_2D_F64_DAMPING = 1e-2
SHARDED_2D_F64_CG = dict(cg_tol=1e-12, cg_max_iter=40_000)
SHARDED_2D_E_RTOL = 1e-7
SHARDED_2D_RING_E_RTOL = 1e-9
SHARDED_2D_MODES = ("all_gather", "ring")
BAL_WINDOW = 20  # 4m, scripts/bench_bal.py: each point seen by 20 consecutive of 100 views
BAL_OUTLIER_SHARE = 0.02  # ... 2 % of the visible observations moved by 0.5 N(0, 1)
BAL_OUTLIER_SCALE = 0.5
K1_DESIGN = ("3xTF32 on wgmma m64n128k8, Y K-major from a 5-stage TMA ring of 32-row stages; "
             "A split in registers, B's small parts in shared planes one stage ahead; "
             "persistent blocks")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of fn() after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_syrk_acc(torch, fs, sy, k_rows: int, n: int, reps: int, seed: int) -> dict:
    """K2 against its plain version: two accumulations onto a random acc,
    lower tiles within 1e-5 of the largest entry, upper tiles untouched;
    then the timings and the bound at this shape."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    y = torch.randn(k_rows, n, generator=gen, device="cuda").to(torch.bfloat16)
    acc0 = torch.randn(n, n, generator=gen, device="cuda")
    got = acc0.clone()
    fs.syrk_acc(got, y)
    fs.syrk_acc(got, y)
    want = acc0.clone()
    fs.syrk_acc_reference(want, y)
    fs.syrk_acc_reference(want, y)
    torch.cuda.synchronize()
    lower = sy.lower_tile_mask(n, "cuda")
    max_abs = float((got - want).abs().masked_fill(~lower, 0.0).max())
    rel = max_abs / float(want.abs().masked_fill(~lower, 0.0).max())
    upper_same = bool(torch.equal(got.masked_fill(lower, 0.0), acc0.masked_fill(lower, 0.0)))
    del got, want, acc0
    check(rel < 1e-5, f"syrk_acc ({k_rows}, {n}) rel err {rel:.3e} >= 1e-5")
    check(upper_same, f"syrk_acc ({k_rows}, {n}) wrote an upper tile")

    scratch = torch.zeros(n, n, device="cuda")
    ms = time_ms(torch, lambda: fs.syrk_acc(scratch, y), reps)
    plain_ms = time_ms(torch, lambda: fs.syrk_acc_reference(scratch, y), reps)
    library_ms = time_ms(torch, lambda: torch.matmul(y.t(), y), reps)
    del scratch
    pairs = (n // fs.TILE) * (n // fs.TILE + 1) // 2
    flops = 2.0 * k_rows * fs.TILE * fs.TILE * pairs
    nbytes = 2.0 * pairs * fs.TILE * fs.TILE * 4 + k_rows * n * 2
    t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    rec = {
        "shape": [k_rows, n], "max_abs_err": max_abs, "max_rel_err": rel,
        "upper_untouched": upper_same, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "tflops": flops / ms / 1e9, "design": K2_DESIGN,
    }
    print("syrk_acc check " + json.dumps(rec), flush=True)
    return rec


def syrk_lower_work(k_rows: int, n: int) -> tuple[float, float]:
    """(FLOP, bytes) that K1's function needs for Y (k_rows, n): the
    element-wise lower triangle of YᵀY, which is all that ``mirror_lower``
    reads, over the real columns (2 k_rows FLOP for each of its
    n (n + 1) / 2 entries); Y read once and that triangle written once."""
    entries = n * (n + 1) / 2
    return 2.0 * k_rows * entries, (k_rows * n + entries) * 4.0


def check_syrk_lower(torch, sy, k_rows: int, n: int, reps: int, seed: int,
                     k_major: bool = False) -> dict:
    """K1 against its plain version: lower tiles within 1e-5 of the largest
    entry, the mirrored product exactly symmetric; then the timings of the
    kernel, the plain version, one float32 ``torch.matmul(y.t(), y)`` (TF32
    off, the full square) and the bound at this shape. With ``k_major``, Y
    is the K-major (k_rows, n) view of an (n, row_stride(k_rows)) buffer,
    as the streamed path lays it out, whose other columns hold noise the
    kernel must not read; else Y is contiguous row-major, which the wrapper
    copies into that layout first. The kernel is also timed on a
    contiguous row-major copy of Y (``ms_row_major``, the copy included)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if k_major:
        y = torch.randn(n, sy.row_stride(k_rows), generator=gen, device="cuda")[:, :k_rows].T
    else:
        y = torch.randn(k_rows, n, generator=gen, device="cuda")
    want = sy.syrk_lower_reference(y)
    lower = sy.lower_tile_mask(want.shape[0], "cuda")
    scale = float(want.abs().masked_fill(~lower, 0.0).max())
    got = sy.syrk_lower(y)
    torch.cuda.synchronize()
    err = float((got - want).abs().masked_fill(~lower, 0.0).max())
    full = sy.syrk(y)
    symmetric = bool(torch.equal(full, full.T))
    del got, want, full
    check(err / scale < 1e-5, f"syrk_lower ({k_rows}, {n}) rel err {err / scale:.3e}")
    check(symmetric, f"syrk ({k_rows}, {n}) is not exactly symmetric")

    ms = time_ms(torch, lambda: sy.syrk_lower(y), reps)
    y_r = y.contiguous()
    ms_row_major = time_ms(torch, lambda: sy.syrk_lower(y_r), reps)
    del y_r
    plain_ms = time_ms(torch, lambda: sy.syrk_lower_reference(y), max(1, reps // 4))
    library_ms = time_ms(torch, lambda: torch.matmul(y.t(), y), reps)
    flops, nbytes = syrk_lower_work(k_rows, n)
    t_ops, t_bytes = flops / H100_3XTF32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    rec = {
        "shape": [k_rows, n], "layout": "k_major" if k_major else "row_major",
        "strides": list(y.stride()), "max_abs_err": err, "max_rel_err": err / scale,
        "symmetric": symmetric, "ms": ms, "ms_row_major": ms_row_major, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "simt_bound_ms": max(flops / H100_FP32_FLOPS * 1e3, t_bytes), "tflops": flops / ms / 1e9,
        "design": K1_DESIGN,
    }
    print("syrk_lower check " + json.dumps(rec), flush=True)
    return rec


def perturbed_cameras(scene, seed: int, sigma: float = 0.02):
    """Host numpy (X0, K, R, t0): the true K and R, X and t perturbed by
    sigma N(0, 1) from a seeded generator."""
    rng = np.random.default_rng(seed)
    X, K, R, t = (a.cpu().numpy() for a in (scene.X, scene.K, scene.R, scene.t))
    X0 = (X + sigma * rng.standard_normal(X.shape)).astype(X.dtype)
    t0 = (t + sigma * rng.standard_normal(t.shape)).astype(t.dtype)
    return X0, K, R, t0


def perturbed_start(scene, seed: int, sigma: float = 0.02):
    """Host numpy (x (P, F, 2), X0, K, R, t0): ``perturbed_cameras`` with
    the observations."""
    x = scene.x.transpose(0, 1).contiguous().cpu().numpy()
    return (x,) + perturbed_cameras(scene, seed, sigma)


def with_outliers(torch, x, gen):
    """Move ``OUTLIER_SHARE`` of the observations x (..., 2) by
    +-``OUTLIER_SHIFT`` per component, in place, from the generator ``gen``
    on x's device. Returns the inlier mask (...)."""
    outlier = torch.rand(x.shape[:-1], generator=gen, device=x.device) < OUTLIER_SHARE
    sign = torch.randint(0, 2, x.shape, generator=gen, device=x.device).to(x.dtype) * 2.0 - 1.0
    x.add_(outlier[..., None] * sign * OUTLIER_SHIFT)
    return ~outlier


def host_outliers(torch, x_host, gen, chunk: int):
    """``with_outliers`` on host observations (P, F, 2), one point chunk at
    a time through the card, so no (P, F) float array is ever formed on the
    host. Returns the host inlier mask (P, F)."""
    inlier = np.empty(x_host.shape[:2], dtype=bool)
    for lo in range(0, x_host.shape[0], chunk):
        x_c = torch.from_numpy(x_host[lo:lo + chunk]).cuda()
        inlier[lo:lo + chunk] = with_outliers(torch, x_c, gen).cpu().numpy()
        x_host[lo:lo + chunk] = x_c.cpu().numpy()
    return inlier


def inlier_error(torch, res, x, inlier, chunk: int) -> tuple[float, int]:
    """(E over the inlier observations at the state of ``res``, their
    count), f0 = 1: x (P, F, 2) and inlier (P, F), on the host or the card,
    taken a point chunk at a time on the card."""
    from mvrecon_tpu_torch.models.bundle_adjustment import calc_pqr

    e, n = 0.0, 0
    for lo in range(0, x.shape[0], chunk):
        x_c = torch.as_tensor(x[lo:lo + chunk], device="cuda")
        keep = torch.as_tensor(inlier[lo:lo + chunk], device="cuda")
        _, p, q, r = calc_pqr(res.X[lo:lo + chunk], res.K, res.R, res.t)
        e_c = (p / r - x_c[..., 0]) ** 2 + (q / r - x_c[..., 1]) ** 2
        e += float(torch.sum(torch.where(keep, e_c, 0.0), dtype=torch.float64))
        n += int(keep.sum())
    return e, n


def finite(torch, *tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def north_star_scenes(torch, make_synthetic_scene, points: int):
    """Phase 4's warm-up scene and its scene (points x 1000 views), drawn
    anew from one seed, so phase 4e gets the same observations."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    warm = make_synthetic_scene(gen, n_images=VIEWS, n_slices=max(1, points // 200),
                                n_angles=20, dtype=torch.float32)
    scene = make_synthetic_scene(gen, n_images=VIEWS, n_slices=points // 20,
                                 n_angles=20, dtype=torch.float32)
    return warm, scene


def launch_counts(fs, sy) -> tuple[int, int]:
    """(K2, K1) launches since the counts were last set to 0."""
    return fs.launch_counts["syrk_acc"], sy.launch_counts["syrk_lower"]


def reset_launch_counts(fs, sy) -> None:
    fs.reset_launch_counts()
    sy.reset_launch_counts()


def dense_layers(torch, tba, start, config, reps: int) -> dict:
    """Times of the dense core's layers on the card, from CUDA events, at
    one BA problem's start: the derivative build, the damped solve, and
    within it the Schur product (point side) and the Cholesky solve."""
    x, vis, state, free, _ = tba._prepare_problem(*start, 1.0, None, "x-up_z-forward", "cuda")
    derivs, _ = tba._compute_derivs(state, x, vis, free, 1.0)
    c = torch.tensor(config.init_damping, device="cuda")
    npts, nf9 = derivs.matE.shape[0], derivs.matF.shape[2]
    rec = {
        "side": "camera" if 3 * npts < nf9 else "point",
        "derivs_ms": time_ms(torch, lambda: tba._compute_derivs(state, x, vis, free, 1.0), reps),
        "damped_solve_ms": time_ms(torch, lambda: tba._damped_solve(derivs, c, free), reps),
    }
    n = min(3 * npts, nf9)
    a = torch.randn(n, n, device="cuda")
    a = a @ a.T + n * torch.eye(n, device="cuda")
    b = torch.randn(n, device="cuda")
    rec["cholesky_solve_ms"] = time_ms(torch, lambda: tba._chol_solve(a, b), reps)
    rec["cholesky_n"] = n
    if rec["side"] == "point":
        fm = derivs.matF.view(3 * npts, nf9)
        rec["schur_product_ms"] = time_ms(torch, lambda: fm.T @ fm, reps)
        rec["schur_product_shape"] = [nf9, 3 * npts, nf9]
    return rec


def batched_scenes(torch, make_synthetic_scene, n_scenes: int, n_images: int, seed: int):
    """Observations (S, F, 200, 2) of S synthetic scenes drawn in turn
    from one seeded generator on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.stack([make_synthetic_scene(gen, n_images=n_images, n_slices=BATCH_SLICES,
                                             n_angles=20, dtype=torch.float32).x
                        for _ in range(n_scenes)])


def batched_run(torch, fs, sy, run, floor: float):
    """One timed run of a batched pipeline (``run(timer)``), with the
    per-scene outcome summarized: (record, result)."""
    from mvrecon_tpu_torch.runtime.profiling import StageTimer

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(fs, sy)
    timer = StageTimer()
    start = time.perf_counter()
    res = run(timer)
    err = res.error.cpu()
    wall = time.perf_counter() - start
    ratio = (err / floor).tolist()
    finite = [r for r in ratio if math.isfinite(r)]
    rec = {
        "wall_s": wall, "scenes_per_s": err.shape[0] / wall, "stage_walls_s": timer.times,
        "calib_ok": int((res.status.cpu() == 0).sum()), "finite": len(finite),
        "scenes_total": err.shape[0], "max_n_iter": int(res.n_iter.max()),
        "ba_solver_retries": res.ba_log["n_solver_retries"],
        "worst_E_vs_noise_floor": max(ratio) if len(finite) == len(ratio) else float("nan"),
        "median_E_vs_noise_floor": statistics.median(finite) if finite else float("nan"),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launch_counts(fs, sy),
    }
    return rec, res


def check_batched(rec: dict, name: str) -> None:
    n = rec["scenes_total"]
    check(rec["calib_ok"] == n, f"{name}: {rec['calib_ok']} of {n} scenes have status 0")
    check(rec["finite"] == n, f"{name}: {rec['finite']} of {n} scenes are finite")
    check(rec["worst_E_vs_noise_floor"] < 1.5,
          f"{name}: worst E / noise floor {rec['worst_E_vs_noise_floor']:.4f}")
    check(rec["launches"] == (0, 0), f"{name} launched the SYRK kernels {rec['launches']}")


def batched_phases(torch, fs, sy, n_scenes: int, dense_points: int) -> None:
    """Phases 4f-4h: the batched perspective pipeline at 256 scenes x 100
    views, the same scenes to convergence, and the affine pipeline."""
    from mvrecon_tpu_torch.config import LMConfig
    from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu_torch.models.pipelines import affine_reconstruction
    from mvrecon_tpu_torch.parallel.batched import (
        batched_affine_reconstruction,
        batched_euclidean_reconstruction,
        batched_euclidean_to_convergence,
    )
    from mvrecon_tpu_torch.runtime.profiling import StageTimer

    # 4f. scene batching: 256 scenes x 100 views x 200 points
    x_b = batched_scenes(torch, make_synthetic_scene, n_scenes, BATCH_VIEWS, seed=11)
    b_floor = x_b.shape[2] * BATCH_VIEWS * 2 * NOISE**2
    b_cfg = LMConfig(scale_factor=4.0, delta_tol=0.0, max_iter=15, accept_divisor=1.0,
                     init_damping=3e-3, damping="nielsen")
    b_kw = dict(method="dual", eig_method="lowrank", scene_chunk=BATCH_CHUNK)
    batched_euclidean_reconstruction(x_b, config=b_cfg, **b_kw)  # warm-up
    rec_f, res_f = batched_run(torch, fs, sy, lambda timer: batched_euclidean_reconstruction(
        x_b, config=b_cfg, timer=timer, **b_kw), b_floor)
    rec_f.update(scenes=n_scenes, views=BATCH_VIEWS, points=x_b.shape[2], chunk=BATCH_CHUNK,
                 ba_iters=b_cfg.max_iter,
                 host_reads_ba=res_f.ba_log["n_solver_retries"])
    print("batched " + json.dumps(rec_f), flush=True)
    check_batched(rec_f, "batched")
    del res_f

    # 4g. the same scenes to convergence: lanes with a budget of 40, then
    # scene compaction from a budget of 15
    c_cfg = dataclasses.replace(b_cfg, delta_tol=1e-3, max_iter=40)
    rec_g, res_g = batched_run(torch, fs, sy, lambda timer: batched_euclidean_reconstruction(
        x_b, config=c_cfg, timer=timer, **b_kw), b_floor)
    n_it = res_g.n_iter.cpu()
    # every lane of a block pays for the block's slowest lane
    paid = sum(n_it[i:i + BATCH_CHUNK].numel() * int(n_it[i:i + BATCH_CHUNK].max())
               for i in range(0, n_scenes, BATCH_CHUNK))
    rec_g.update(ba_iters=c_cfg.max_iter, delta_tol=c_cfg.delta_tol,
                 converged_early=int((n_it < c_cfg.max_iter).sum()),
                 lane_iterations_used=int(n_it.sum()), lane_iterations_paid=paid,
                 finished_lane_share=1.0 - int(n_it.sum()) / paid)
    del res_g
    rec_t, res_t = batched_run(torch, fs, sy, lambda timer: batched_euclidean_to_convergence(
        x_b, config=dataclasses.replace(b_cfg, delta_tol=1e-3), timer=timer, **b_kw), b_floor)
    rec_t["phases"] = res_t.ba_log["phases"]
    rec_g["to_convergence"] = rec_t
    print("batched_converged " + json.dumps(rec_g), flush=True)
    check_batched(rec_g, "batched_converged (lanes)")
    check_batched(rec_t, "batched_converged (compaction)")
    del res_t, x_b

    # 4h. the affine pipeline: batched at the reference demo's shape, then
    # one scene at 10k points x 100 views for each model
    x_a = batched_scenes(torch, make_synthetic_scene, n_scenes, AFFINE_VIEWS, seed=12)
    a_floor = x_a.shape[2] * AFFINE_VIEWS * 2 * NOISE**2
    a_cfg = LMConfig(scale_factor=2.0, delta_tol=1e-8, max_iter=50)
    f_a = torch.ones(x_a.shape[:2], device="cuda")
    a_log = dataclasses.replace(a_cfg, record_log=True)
    batched_affine_reconstruction(x_a, f_a, config=a_log)  # warm-up
    rec_h, res_h = batched_run(torch, fs, sy, lambda timer: batched_affine_reconstruction(
        x_a, f_a, config=a_log, timer=timer), a_floor)
    ratio = res_h.error.cpu() / a_floor
    rec_h.update(scenes=n_scenes, views=AFFINE_VIEWS, points=x_a.shape[2],
                 model="paraperspective", ba_iters=a_cfg.max_iter,
                 below_start=int((res_h.error < res_h.ba_log["reprojection_error"][:, 0])
                                 .sum()),
                 above_1_5x_floor=int((ratio > 1.5).sum()),
                 worst_scenes_E_vs_noise_floor=ratio.sort().values[-5:].tolist())
    del res_h, x_a
    gen = torch.Generator(device="cuda").manual_seed(13)
    big = make_synthetic_scene(gen, n_images=DENSE_VIEWS, n_slices=dense_points // 20,
                               n_angles=20, dtype=torch.float32)
    big_floor = big.X.shape[0] * DENSE_VIEWS * 2 * NOISE**2
    f_big = torch.ones(DENSE_VIEWS, device="cuda")
    singles = {}
    for model in ("orthographic", "symmetric", "paraperspective"):
        reset_launch_counts(fs, sy)
        a_timer = StageTimer()
        start = time.perf_counter()
        r = affine_reconstruction(big.x, f_big, model=model,
                                  config=dataclasses.replace(a_cfg, record_log=True),
                                  timer=a_timer)
        e_end = float(r.error)
        wall = time.perf_counter() - start
        e_start = float(r.ba_log["reprojection_error"][0])
        singles[model] = {
            "points": big.X.shape[0], "views": DENSE_VIEWS, "wall_s": wall,
            "stage_walls_s": a_timer.times, "ba_n_iter": r.n_iter,
            "ba_solver_retries": r.ba_log["n_solver_retries"], "start_E": e_start,
            "reprojection_error": e_end, "E_vs_noise_floor": e_end / big_floor,
            "launches": launch_counts(fs, sy),
        }
    rec_h["single"] = singles
    print("affine " + json.dumps(rec_h), flush=True)
    check_affine(rec_h)
    for model, rec in singles.items():
        check(math.isfinite(rec["reprojection_error"]), f"affine {model} E is not finite")
        check(rec["reprojection_error"] < rec["start_E"],
              f"affine {model} E {rec['reprojection_error']:.6g} is not below its start "
              f"{rec['start_E']:.6g}")
        check(rec["launches"] == (0, 0), f"affine {model} launched the SYRK kernels")
    del big


def batched_gpu_vs_cpu(torch, fs, sy, d_cfg) -> None:
    """Phase 5, batched: both batched pipelines on three small scenes on
    the card and on the CPU, and the fault isolation of a batch whose
    second scene is all NaN."""
    from mvrecon_tpu_torch.config import LMConfig
    from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu_torch.parallel.batched import (
        batched_affine_reconstruction,
        batched_euclidean_reconstruction,
    )

    reset_launch_counts(fs, sy)
    x_s = batched_scenes(torch, make_synthetic_scene, 3, 6, seed=14)
    s_floor = x_s.shape[2] * 6 * 2 * NOISE**2
    f_s = torch.ones(x_s.shape[:2], device="cuda")
    aff_cfg = LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=10)
    pairs = {
        "euclidean": [batched_euclidean_reconstruction(x_s, method="dual", eig_method="lowrank",
                                                       config=d_cfg, device=dev)
                      for dev in ("cuda", "cpu")],
        "affine": [batched_affine_reconstruction(x_s, f_s, config=aff_cfg, device=dev)
                   for dev in ("cuda", "cpu")],
    }
    batched_small = {}
    for name, (r_g, r_c) in pairs.items():
        e_g, e_c = r_g.error.cpu(), r_c.error.cpu()
        batched_small[name] = {
            "status_gpu": r_g.status.tolist(), "status_cpu": r_c.status.tolist(),
            "n_iter_gpu": r_g.n_iter.tolist(), "n_iter_cpu": r_c.n_iter.tolist(),
            "E_gpu": e_g.tolist(), "E_cpu": e_c.tolist(),
            "E_rel_diff": ((e_g - e_c).abs() / e_c).tolist(), "E_rtol": FINAL_E_RTOL,
        }
    x_nan = x_s.clone()
    x_nan[1] = float("nan")
    r_nan = batched_euclidean_reconstruction(x_nan, method="dual", eig_method="lowrank",
                                             config=d_cfg)
    e_nan = r_nan.error.cpu()
    batched_small["fault_isolation"] = {
        "status": r_nan.status.tolist(), "E": e_nan.tolist(),
        "E_vs_noise_floor": (e_nan / s_floor).tolist(), "limit": 5.0,
    }
    batched_small["launches_gpu"] = launch_counts(fs, sy)
    print("batched_gpu_vs_cpu " + json.dumps(batched_small), flush=True)
    for name in ("euclidean", "affine"):
        rec = batched_small[name]
        check(rec["status_gpu"] == rec["status_cpu"] == [0, 0, 0],
              f"small batched {name} statuses {rec['status_gpu']} {rec['status_cpu']}")
        check(rec["n_iter_gpu"] == rec["n_iter_cpu"], f"small batched {name} iterations differ")
        check(max(rec["E_rel_diff"]) < FINAL_E_RTOL,
              f"small batched {name} E differs by {rec['E_rel_diff']} (limit {FINAL_E_RTOL})")
    rec = batched_small["fault_isolation"]
    check(rec["status"][1] == 2 and not math.isfinite(rec["E"][1]),
          f"the NaN scene is not flagged: status {rec['status'][1]}, E {rec['E'][1]}")
    check(all(rec["E_vs_noise_floor"][i] < 5.0 for i in (0, 2)),
          f"the finite scenes beside the NaN one: E / floor {rec['E_vs_noise_floor']}")
    check(batched_small["launches_gpu"] == (0, 0), "the small batched runs launched a kernel")


# Share of random scenes on which the affine pipeline (the JAX package's
# and the port's alike) ends above 1.5x the noise floor after 50 BA
# iterations: 5 of 128 in float64 on the CPU (scripts/affine_branch_survey.py).
# The check allows up to 10 %.
AFFINE_ABOVE_FLOOR_SHARE = 0.10


def check_affine(rec: dict) -> None:
    """Phase 4h: every scene finite, calibrated and improved by BA, the
    median at the floor, and no more scenes off the floor than the
    reference algorithm leaves there."""
    n = rec["scenes_total"]
    check(rec["calib_ok"] == n, f"batched affine: {rec['calib_ok']} of {n} scenes have status 0")
    check(rec["finite"] == n, f"batched affine: {rec['finite']} of {n} scenes are finite")
    check(rec["below_start"] == n,
          f"batched affine: {rec['below_start']} of {n} scenes end below their start E")
    check(rec["median_E_vs_noise_floor"] < 1.5,
          f"batched affine: median E / noise floor {rec['median_E_vs_noise_floor']:.4f}")
    check(rec["above_1_5x_floor"] <= AFFINE_ABOVE_FLOOR_SHARE * n,
          f"batched affine: {rec['above_1_5x_floor']} of {n} scenes above 1.5x the floor")
    check(rec["launches"] == (0, 0), f"batched affine launched the SYRK kernels {rec['launches']}")


def robust_chunked(torch, fs, sy, scene, config) -> int:
    """Phase 4i: the chunked BA under the Huber loss at phase 4's width,
    from ``perturbed_start`` (sigma 0.02) with 3 % gross outliers, then the
    same run under the plain loss. Returns the robust run's K2 launches."""
    from mvrecon_tpu_torch.models.bundle_adjustment_chunked import bundle_adjust_chunked
    from mvrecon_tpu_torch.ops.procrustes import aligned_rmse

    x = scene.x.transpose(0, 1).contiguous()  # (P, F, 2) on the card
    inlier = with_outliers(torch, x, torch.Generator(device="cuda").manual_seed(21))
    start = perturbed_cameras(scene, seed=21)
    n_points = x.shape[0]
    n_chunks = math.ceil(n_points / CHUNK)
    plain_cfg = dataclasses.replace(config, max_iter=ROBUST_ITERS)
    runs = {}
    for name, cfg in (("robust", dataclasses.replace(plain_cfg, robust="huber",
                                                     huber_delta=HUBER_DELTA)),
                      ("plain", plain_cfg)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts(fs, sy)
        t0 = time.perf_counter()
        res = bundle_adjust_chunked(x, *start, axis="x-up_z-forward", config=cfg,
                                    chunk_size=CHUNK)
        err = float(res.error)
        wall = time.perf_counter() - t0
        launches = launch_counts(fs, sy)
        peak = torch.cuda.max_memory_allocated()
        e_in, n_in = inlier_error(torch, res, x, inlier, 8192)
        runs[name] = {
            "wall_s": wall, "n_iter": res.n_iter, "retries": res.log["n_solver_retries"],
            "syrk_acc_launches": launches[0], "syrk_lower_launches": launches[1],
            "E" if name == "plain" else "weighted_E": err,
            "inlier_E": e_in, "inlier_E_vs_noise_floor": e_in / (n_in * 2 * NOISE**2),
            "aligned_rmse_X": float(aligned_rmse(res.X, scene.X)),
            "max_memory_allocated_gb": peak / 1e9,
            "finite": math.isfinite(err) and finite(torch, res.X, res.K, res.R, res.t),
        }
        del res
    rec = {"points": n_points, "views": x.shape[1], "chunk": CHUNK, "chunks": n_chunks,
           "ba_iters": ROBUST_ITERS, "outliers": int((~inlier).sum()),
           "outlier_share": OUTLIER_SHARE, "outlier_shift": OUTLIER_SHIFT,
           "huber_delta": HUBER_DELTA, **runs}
    print("robust_chunked " + json.dumps(rec), flush=True)
    del x, inlier
    r, p = runs["robust"], runs["plain"]
    check(r["finite"] and p["finite"], "robust chunked: an output is not finite")
    check(r["syrk_acc_launches"] == r["retries"] * n_chunks > 0,
          f"robust chunked: syrk_acc launches {r['syrk_acc_launches']} != retries "
          f"{r['retries']} x chunks {n_chunks}")
    check(r["inlier_E_vs_noise_floor"] < 1.5,
          f"robust chunked: inlier E / floor {r['inlier_E_vs_noise_floor']:.4f}")
    check(r["aligned_rmse_X"] < 0.5 * p["aligned_rmse_X"],
          f"robust chunked: aligned RMSE {r['aligned_rmse_X']:.4g} is not below half the "
          f"plain run's {p['aligned_rmse_X']:.4g}")
    return r["syrk_acc_launches"]


def point_sigma(torch, cov):
    """Per-point position sigma sqrt(trace / 3), as bench.py reports it."""
    return torch.sqrt(torch.diagonal(cov.point_cov, dim1=-2, dim2=-1).sum(-1) / 3.0)


def block_checks(torch, blocks) -> dict:
    """Asymmetry of (N, n, n) covariance blocks relative to their largest
    entry, and each block's smallest eigenvalue over its largest (the worst
    of all blocks)."""
    from mvrecon_tpu_torch.ops.linalg import eigh

    asym = float((blocks - blocks.transpose(-1, -2)).abs().max() / blocks.abs().max())
    w, _ = eigh(0.5 * (blocks + blocks.transpose(-1, -2)))
    return {"asymmetry_rel": asym,
            "min_eig_over_max": float((w[..., 0] / w[..., -1].clamp_min(1e-30)).min())}


def check_blocks(name: str, rec: dict) -> None:
    for kind in ("point", "camera"):
        c = rec[f"{kind}_blocks"]
        check(c["asymmetry_rel"] < COV_ASYMMETRY_RTOL,
              f"{name}: {kind} blocks asymmetric by {c['asymmetry_rel']:.3e}")
        check(c["min_eig_over_max"] >= -1e-6,
              f"{name}: {kind} block eigenvalue ratio {c['min_eig_over_max']:.3e} < -1e-6")


def covariance_chunked(torch, x_pf, res) -> None:
    """Phase 4k: ``ba_covariance_chunked`` on phase 4's result, as
    ``bench.py::bench_covariance`` configures it, one warm-up and one timed
    run."""
    from mvrecon_tpu_torch.models.covariance import ba_covariance_chunked

    def run():
        return ba_covariance_chunked(x_pf, res.X, res.K, res.R, res.t, f0=1.0,
                                     axis="x-up_z-forward", chunk_size=CHUNK)

    run()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    cov = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated()
    sig = point_sigma(torch, cov)
    cam0 = cov.camera_cov[0]
    # camera 1's translation variance along the pinned baseline direction
    # (x-up: column 1 of camera 0's rotation)
    d = res.R[0][:, 1]
    t1 = cov.camera_cov[1, 3:6, 3:6]
    rec = {
        "points": x_pf.shape[0], "views": x_pf.shape[1], "chunk": CHUNK, "wall_s": wall,
        "sigma": math.sqrt(float(cov.sigma2)), "sigma_true": NOISE,
        "n_obs": int(cov.n_obs), "error": float(cov.error),
        "point_sigma_median": float(sig.median()), "point_sigma_max": float(sig.max()),
        "finite": finite(torch, cov.point_cov, cov.camera_cov, cov.sigma2),
        "camera0_pinned_max_abs": float(torch.cat([cam0[3:9].flatten(),
                                                   cam0[:, 3:9].flatten()]).abs().max()),
        "camera1_baseline_var_rel": float(d @ t1 @ d / torch.trace(t1)),
        "max_memory_allocated_gb": peak / 1e9,
        "point_blocks": block_checks(torch, cov.point_cov),
        "camera_blocks": block_checks(torch, cov.camera_cov),
    }
    print("covariance " + json.dumps(rec), flush=True)
    check(rec["finite"], "covariance: a block is not finite")
    check(abs(rec["sigma"] / NOISE - 1.0) < 0.05,
          f"covariance: sigma {rec['sigma']:.6g} against the true {NOISE}")
    check(rec["camera0_pinned_max_abs"] == 0.0, "covariance: camera 0's pinned rows are not zero")
    check(abs(rec["camera1_baseline_var_rel"]) < 1e-5,
          f"covariance: camera 1's pinned baseline variance {rec['camera1_baseline_var_rel']:.3e}")
    check_blocks("covariance", rec)


def covariance_dense_vs_chunked(torch, x, state) -> None:
    """Phase 4k, second run: ``ba_covariance`` against
    ``ba_covariance_chunked`` on phase 4c's result. The two paths are held
    to ``COV_DENSE_CHUNKED_RTOL`` in float64. float32 is reported beside
    it and not checked: the undamped A's condition number (about 6e7 at
    this shape, above 1 / eps of float32) leaves each path several percent
    from float64 on the CPU, and its float32 Cholesky factor can fail,
    which gives NaN blocks (ROADMAP F10)."""
    from mvrecon_tpu_torch.models.covariance import ba_covariance, ba_covariance_chunked

    kw = dict(f0=1.0, axis="x-up_z-forward")
    rec = {"points": x.shape[0], "views": x.shape[1], "chunk": CHUNK,
           "rtol_float64": COV_DENSE_CHUNKED_RTOL}
    covs = {}
    for name, dt in (("float64", torch.float64), ("float32", torch.float32)):
        args = [a.to(dt) for a in (x, *state)]
        torch.cuda.synchronize()
        start = time.perf_counter()
        dense = ba_covariance(*args, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        chunked = ba_covariance_chunked(*args, chunk_size=CHUNK, **kw)
        covs[name] = dense
        rec[name] = {"dense_wall_s": wall, "sigma": math.sqrt(float(dense.sigma2)),
                     "dense_finite": finite(torch, dense.point_cov, dense.camera_cov),
                     "chunked_finite": finite(torch, chunked.point_cov, chunked.camera_cov)}
        for k in ("point_cov", "camera_cov"):
            a, b = getattr(chunked, k), getattr(dense, k)
            rec[name][f"{k}_rel_diff"] = float((a - b).abs().max() / b.abs().max())
    for k in ("point_cov", "camera_cov"):
        a, b = getattr(covs["float32"], k).double(), getattr(covs["float64"], k)
        rec["float32"][f"dense_{k}_vs_float64"] = float((a - b).abs().max() / b.abs().max())
    print("covariance_dense " + json.dumps(rec), flush=True)
    check(rec["float64"]["dense_finite"] and rec["float64"]["chunked_finite"],
          "dense vs chunked covariance (float64): a block is not finite")
    for k in ("point_cov", "camera_cov"):
        diff = rec["float64"][f"{k}_rel_diff"]
        check(diff < COV_DENSE_CHUNKED_RTOL,
              f"dense vs chunked covariance (float64): {k} differs by {diff:.3e}")


def covariance_streamed(torch, x_host, state, full: bool) -> None:
    """Phase 4l: ``ba_covariance_streamed`` on phase 4b's result, the
    observations in host memory."""
    from mvrecon_tpu_torch.models.covariance import ba_covariance_streamed
    from mvrecon_tpu_torch.runtime.profiling import EventTimer

    timer = EventTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    cov = ba_covariance_streamed(x_host, *state, f0=1.0, axis="x-up_z-forward", timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated()
    spans = timer.ms()
    sig = point_sigma(torch, cov)
    rec = {
        "points": x_host.shape[0], "views": x_host.shape[1], "chunk": 4096, "wall_s": wall,
        "pass1_ms": spans["pass1"], "pass2_ms": spans["pass2"],
        "sigma": math.sqrt(float(cov.sigma2)), "n_obs": int(cov.n_obs),
        "point_sigma_median": float(sig.median()), "point_sigma_max": float(sig.max()),
        "finite": finite(torch, cov.point_cov, cov.camera_cov, cov.sigma2),
        "max_memory_allocated_gb": peak / 1e9, "observations_gb": x_host.nbytes / 1e9,
    }
    print("covariance_streamed " + json.dumps(rec), flush=True)
    check(rec["finite"], "streamed covariance: a block is not finite")
    if full:  # the per-chunk peak does not scale with P: the design point's check
        check(peak < x_host.nbytes, f"streamed covariance peak device memory {peak / 1e9:.2f} "
              f"GB is not below the observations' {x_host.nbytes / 1e9:.2f} GB")


def robust_streamed(torch, sy, x_host, start_cams, s_cfg, full: bool) -> int:
    """Phase 4j: the streamed BA under the Huber loss on phase 4b's problem
    with 3 % gross outliers, injected into the host observations in place.
    Returns its K1 launches."""
    from mvrecon_tpu_torch.models.bundle_adjustment_streamed import bundle_adjust_streamed
    from mvrecon_tpu_torch.runtime.profiling import EventTimer

    inlier = host_outliers(torch, x_host, torch.Generator(device="cuda").manual_seed(22),
                           STREAMED_CHUNK)
    cfg = dataclasses.replace(s_cfg, robust="huber", huber_delta=HUBER_DELTA)
    timer = EventTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sy.reset_launch_counts()
    start = time.perf_counter()
    res = bundle_adjust_streamed(x_host, *start_cams, axis="x-up_z-forward", config=cfg,
                                 chunk_size=STREAMED_CHUNK, prefetch=2, timer=timer)
    err = float(res.error)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    k1_launches = sy.launch_counts["syrk_lower"]
    peak = torch.cuda.max_memory_allocated()
    spans = timer.ms()
    retries = res.log["n_solver_retries"]
    chunks = math.ceil(x_host.shape[0] / STREAMED_CHUNK)
    e_in, n_in = inlier_error(torch, res, x_host, inlier, STREAMED_CHUNK)
    rec = {
        "points": x_host.shape[0], "views": x_host.shape[1], "chunk": STREAMED_CHUNK,
        "chunks": chunks, "wall_s": wall, "n_iter": res.n_iter, "retries": retries,
        "pass1_ms": spans["pass1"], "pass2_ms": spans["pass2"],
        "syrk_lower_launches": k1_launches, "outliers": int(inlier.size - inlier.sum()),
        "huber_delta": HUBER_DELTA, "weighted_E": err, "inlier_E": e_in,
        "inlier_E_vs_noise_floor": e_in / (n_in * 2 * NOISE**2),
        "finite": math.isfinite(err) and finite(torch, res.X, res.K, res.R, res.t),
        "max_memory_allocated_gb": peak / 1e9, "observations_gb": x_host.nbytes / 1e9,
    }
    print("robust_streamed " + json.dumps(rec), flush=True)
    check(rec["finite"], "robust streamed: an output is not finite")
    check(k1_launches == retries * chunks > 0,
          f"robust streamed: syrk_lower launches {k1_launches} != retries {retries} x chunks "
          f"{chunks}")
    check(rec["inlier_E_vs_noise_floor"] < 1.5,
          f"robust streamed: inlier E / floor {rec['inlier_E_vs_noise_floor']:.4f}")
    if full:
        check(peak < x_host.nbytes, f"robust streamed peak device memory {peak / 1e9:.2f} GB "
              f"is not below the observations' {x_host.nbytes / 1e9:.2f} GB")
    return k1_launches


def robust_gpu_vs_cpu(torch, fs, sy, small, small_cfg) -> None:
    """Phase 5, robust: the dense and chunked cores under the Huber loss on
    the small scene with 3 % gross outliers, card against CPU; then
    ``ba_covariance`` in float64, card against CPU."""
    from mvrecon_tpu_torch.config import LMConfig
    from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu_torch.models import bundle_adjustment as tba
    from mvrecon_tpu_torch.models.bundle_adjustment_chunked import bundle_adjust_chunked
    from mvrecon_tpu_torch.models.covariance import ba_covariance

    x = small.x.transpose(0, 1).contiguous()
    with_outliers(torch, x, torch.Generator().manual_seed(23))
    start = (x,) + perturbed_cameras(small, seed=5)
    cfg = dataclasses.replace(small_cfg, robust="huber", huber_delta=HUBER_DELTA)
    cores = {
        "dense": lambda dev: tba.bundle_adjust(*start, axis="x-up_z-forward", config=cfg,
                                               device=dev),
        "chunked": lambda dev: bundle_adjust_chunked(*start, axis="x-up_z-forward", config=cfg,
                                                     chunk_size=128, device=dev),
    }
    rec = {}
    for core, run in cores.items():
        reset_launch_counts(fs, sy)
        r_g = run("cuda")
        launches = launch_counts(fs, sy)
        r_c = run("cpu")
        e_g, e_c = (r.log["reprojection_error"].cpu().double() for r in (r_g, r_c))
        n = r_c.n_iter
        rec[core] = {
            "n_iter_gpu": r_g.n_iter, "n_iter_cpu": n, "launches_gpu": launches,
            "E_gpu": e_g[1:n + 1].tolist(), "E_cpu": e_c[1:n + 1].tolist(),
            "E_rel_diff_iters_1_2": ((e_g[1:3] - e_c[1:3]).abs() / e_c[1:3]).tolist(),
            "E_rel_diff_final": abs(float(r_g.error) - float(r_c.error)) / float(r_c.error),
            "early_rtol": EARLY_ITER_RTOL, "final_rtol": FINAL_E_RTOL,
        }

    sc = make_synthetic_scene(torch.Generator().manual_seed(7), n_images=12, n_slices=5,
                              n_angles=20, dtype=torch.float64)
    x64, *cams = perturbed_start(sc, seed=7)
    ba = tba.bundle_adjust(x64, *cams, axis="x-up_z-forward", device="cpu",
                           config=LMConfig(scale_factor=2.0, delta_tol=1e-12, max_iter=20))
    for name, c_cfg in (("plain", LMConfig()),
                        ("huber", LMConfig(robust="huber", huber_delta=NOISE))):
        covs = [ba_covariance(x64, ba.X, ba.K, ba.R, ba.t, axis="x-up_z-forward",
                              config=c_cfg, device=dev) for dev in ("cuda", "cpu")]
        rec[f"covariance_float64_{name}"] = {
            k: float((getattr(covs[0], k).cpu() - getattr(covs[1], k)).abs().max()
                     / getattr(covs[1], k).abs().max())
            for k in ("point_cov", "camera_cov", "sigma2")}
    print("robust_gpu_vs_cpu " + json.dumps(rec), flush=True)
    for core in cores:
        r = rec[core]
        check(r["n_iter_gpu"] == r["n_iter_cpu"], f"robust {core}: iterations differ")
        check(max(r["E_rel_diff_iters_1_2"]) < EARLY_ITER_RTOL,
              f"robust {core}: E after iterations 1-2 differs by {r['E_rel_diff_iters_1_2']}")
        check(r["E_rel_diff_final"] < FINAL_E_RTOL,
              f"robust {core}: final E differs by {r['E_rel_diff_final']:.3e}")
    check(rec["chunked"]["launches_gpu"][0] > 0, "robust chunked on the card did not launch K2")
    for name in ("plain", "huber"):
        diffs = rec[f"covariance_float64_{name}"]
        check(max(diffs.values()) < 1e-8,
              f"float64 covariance ({name}), card against CPU, differs by {diffs}")


def syrk_accumulate_check(torch, sy, k_rows: int, n: int, seed: int) -> dict:
    """K1's deferred-mirror sum, as the non-fused chunked build runs it: two
    chunks' Y (K-major, as the build writes them) summed into one
    accumulator by ``syrk_lower_accumulate``, mirrored once, against the
    plain sum Y1ᵀY1 + Y2ᵀY2 in float64; the result exactly symmetric."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ys = [torch.randn(n, sy.row_stride(k_rows), generator=gen, device="cuda")[:, :k_rows].T
          for _ in range(2)]
    n_acc = sy.syrk_accumulator_dim(n)
    acc = torch.zeros(n_acc, n_acc, device="cuda")
    for y in ys:
        sy.syrk_lower_accumulate(acc, y)
    got = sy.finish_syrk_accumulator(acc, n)
    del acc
    want = sum(y.double().T @ y.double() for y in ys)
    err = float((got.double() - want).abs().max())
    rec = {"shape": [k_rows, n], "chunks": len(ys), "max_abs_err": err,
           "max_rel_err": err / float(want.abs().max()),
           "symmetric": bool(torch.equal(got, got.T))}
    del got, want
    print("syrk_lower_accumulate check " + json.dumps(rec), flush=True)
    check(rec["max_rel_err"] < 1e-5,
          f"syrk_lower_accumulate ({k_rows}, {n}) rel err {rec['max_rel_err']:.3e}")
    check(rec["symmetric"], "the mirrored accumulator is not exactly symmetric")
    return rec


def true_state(tba, scene):
    """The scene's true state as a ``BAState`` (f0 = 1)."""
    f, u = tba.intrinsics_from_K(scene.K, 1.0)
    return tba.BAState(X=scene.X, f=f, u=u, t=scene.t, R=scene.R)


def render_distorted(torch, tba, truth, dist, gen, lo: int, hi: int, model=None):
    """Observations (hi - lo, F, 2) of the true points lo:hi through the
    model of ``dist`` (``model``, or by its columns; the port's own terms:
    the distorted prediction is ``_distorted_residual`` against zero), plus
    ``NOISE`` N(0, 1) from ``gen``; and the largest s = |rho|^2 among
    them."""
    st = truth._replace(X=truth.X[lo:hi])
    _, p, q, r = tba.calc_pqr(st.X, tba.build_K(st.f, st.u, 1.0), st.R, st.t)
    zero = torch.zeros(p.shape + (2,), dtype=p.dtype, device=p.device)
    x = torch.stack(tba._distorted_residual(st, p, q, r, zero, 1.0, dist, model), dim=-1)
    pinhole = dist.new_zeros(dist.shape[:-1] + (2,))  # s does not depend on the model
    s_max = float(tba._distortion_terms(st, p, q, r, 1.0, pinhole)[2].max())
    return x + NOISE * torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device), s_max


def render_all(torch, tba, truth, dist, gen, out, chunk: int = 8192, model=None) -> float:
    """``render_distorted`` of every point into ``out`` (P, F, 2), a card
    tensor or a host array, a chunk at a time; returns the largest s."""
    s_max = 0.0
    for lo in range(0, truth.X.shape[0], chunk):
        hi = min(lo + chunk, truth.X.shape[0])
        x_c, s = render_distorted(torch, tba, truth, dist, gen, lo, hi, model)
        out[lo:hi] = x_c if torch.is_tensor(out) else x_c.cpu().numpy()
        s_max = max(s_max, s)
    return s_max


def monotone_margin(k, s_max: float) -> float:
    """The smallest d(r d)/dr = 1 + 3 k1 s + 5 k2 s^2 over s in [0, s_max]:
    positive when the radial map stays monotone over the scene's rays."""
    s = np.linspace(0.0, s_max, 1001)
    return float((1.0 + 3.0 * k[0] * s + 5.0 * k[1] * s * s).min())


def jacobian_margin(torch, tba, model: str, k, s_max: float) -> float:
    """The smallest determinant of the map's exact 2x2 Jacobian (the
    chain's D, ``_distortion_shift_and_jacobian``) over s in [0, s_max]
    along 16 directions, f = 1 and u = 0, in float64 on the CPU: positive
    when the map stays locally one to one over the scene's rays. For a
    radial map det D = d (r d)' / r, so this is the radial check's sign;
    it also covers the tangential and thin-prism shifts."""
    s = torch.linspace(0.0, s_max, 1001, dtype=torch.float64)
    a = torch.arange(16, dtype=torch.float64) * (math.pi / 8.0)
    rn = torch.sqrt(s)[:, None]
    g1, g2 = rn * torch.cos(a)[None], rn * torch.sin(a)[None]  # (1001, 16): 16 "cameras"
    dist = torch.tensor(k, dtype=torch.float64).expand(16, len(k))
    _, _, (d11, d12, d21, d22) = tba._distortion_shift_and_jacobian(
        torch.ones(16, dtype=torch.float64), torch.zeros((16, 2), dtype=torch.float64), 1.0,
        dist, model, g1, g2)
    return float((d11 * d22 - d12 * d21).min())


def check_monotone(name: str, k, s_max: float, torch=None, tba=None, model=None) -> float:
    """The radial check for radial and OPENCV (``model`` None), the
    Jacobian one (``jacobian_margin``) for another family."""
    margin = (monotone_margin(k, s_max) if model is None
              else jacobian_margin(torch, tba, model, k, s_max))
    check(margin > 0.0, f"{name}: the map of {k} is not monotone up to s = {s_max:.4g}")
    return margin


def distorted_inlier_error(torch, tba, res, x, keep, chunk: int,
                           model=None) -> tuple[float, int]:
    """(E of the distorted residuals over the observations where ``keep``
    (P, F) at the state and distortion of ``res``, their count); x
    (P, F, 2) on the host or the card, taken a point chunk at a time."""
    f, u = tba.intrinsics_from_K(res.K, 1.0)
    cam = tba.BAState(X=res.X, f=f, u=u, t=res.t, R=res.R)
    e, n = 0.0, 0
    for lo in range(0, x.shape[0], chunk):
        x_c = torch.as_tensor(x[lo:lo + chunk], device="cuda")
        k = torch.as_tensor(keep[lo:lo + chunk], device="cuda")
        st = cam._replace(X=res.X[lo:lo + chunk])
        _, p, q, r = tba.calc_pqr(st.X, res.K, res.R, res.t)
        r = torch.where(k, r, torch.ones_like(r))
        rp, rq = tba._distorted_residual(st, p, q, r, x_c, 1.0, res.distortion, model)
        e += float(torch.sum(torch.where(k, rp * rp + rq * rq, 0.0), dtype=torch.float64))
        n += int(k.sum())
    return e, n


def k_error(res, truth) -> float:
    """Largest |k - k_true| over the cameras and parameters."""
    return float((res.distortion - res.distortion.new_tensor(truth)).abs().max())


def model_error(torch, tba, truth, d_fit, d_true, chunk: int = 16384, model=None) -> float:
    """How well a recovered distortion reproduces the true one where the
    scene looks: over every observed ray of the true geometry, the RMS of
    the difference between the two models' displacements (distorted minus
    pinhole prediction) over the RMS of the true displacement. (k1, k2)
    themselves are not identified on these scenes: s = |rho|^2 stays below
    about 0.35, so k2 s^2 trades against k1 s and the geometry at equal E
    (``scripts/distortion_identifiability.py``)."""
    num = den = 0.0
    for lo in range(0, truth.X.shape[0], chunk):
        st = truth._replace(X=truth.X[lo:lo + chunk])
        _, p, q, r = tba.calc_pqr(st.X, tba.build_K(st.f, st.u, 1.0), st.R, st.t)
        zero = torch.zeros(p.shape + (2,), dtype=p.dtype, device=p.device)
        pinhole = torch.stack((p / r, q / r), dim=-1)
        fit, true = (torch.stack(tba._distorted_residual(st, p, q, r, zero, 1.0, d, model),
                                 dim=-1)
                     for d in (d_fit, d_true))
        num += float(torch.sum((fit - true) ** 2, dtype=torch.float64))
        den += float(torch.sum((true - pinhole) ** 2, dtype=torch.float64))
    return math.sqrt(num / den)


def bal_problem(torch, bal_points: int, model: str = "radial", truth_k=RADIAL_TRUTH,
                robust: bool = True, name: str = "distorted_dense"):
    """4m's problem on the card (``scripts/bench_bal.py``'s): the curved tube
    in ``DENSE_VIEWS`` views from generator seed 30, rendered through the
    shared ``truth_k`` of ``model`` with sigma noise, each point seen by
    ``BAL_WINDOW`` consecutive views, ``BAL_OUTLIER_SHARE`` of the visible
    observations moved by 0.5 N(0, 1) when ``robust``. Returns (scene,
    true state, the (F, k) model, x (P, F, 2), vis, inlier mask, outliers,
    s_max, monotone margin)."""
    from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu_torch.models import bundle_adjustment as tba

    gen = torch.Generator(device="cuda").manual_seed(30)
    scene = make_synthetic_scene(gen, n_images=DENSE_VIEWS, n_slices=bal_points // 20,
                                 n_angles=20, dtype=torch.float32)
    truth = true_state(tba, scene)
    npts, nf = scene.X.shape[0], DENSE_VIEWS
    dist = torch.tensor(truth_k, device="cuda").expand(nf, len(truth_k))
    x = torch.empty((npts, nf, 2), device="cuda")
    s_max = render_all(torch, tba, truth, dist, gen, x, model=model)
    margin = check_monotone(name, truth_k, s_max, torch, tba,
                            None if model in ("radial", "opencv") else model)
    centers = torch.randint(0, nf, (npts,), generator=gen, device="cuda")
    lo = (centers - BAL_WINDOW // 2).clamp(0, nf - BAL_WINDOW)
    cams = torch.arange(nf, device="cuda")
    vis = (cams[None] >= lo[:, None]) & (cams[None] < lo[:, None] + BAL_WINDOW)
    seen = vis.flatten().nonzero()[:, 0]
    n_out = int(BAL_OUTLIER_SHARE * seen.numel()) if robust else 0
    pick = seen[torch.rand(seen.numel(), generator=gen, device="cuda").argsort()[:n_out]]
    x.view(-1, 2)[pick] += BAL_OUTLIER_SCALE * torch.randn((n_out, 2), generator=gen,
                                                           device="cuda")
    inlier = vis.clone()
    inlier.view(-1)[pick] = False
    return scene, truth, dist, x, vis, inlier, n_out, s_max, margin


def distorted_dense(torch, fs, sy, bal_points: int, model: str = "radial",
                    truth_k=RADIAL_TRUTH, rounds: int = 2, name: str = "distorted_dense",
                    sigma: float = 0.05, robust: bool = True, hold_model: bool = True) -> dict:
    """Phase 4m: ``scripts/bench_bal.py``'s distorted problem through the
    dense ``bundle_adjust``: 20k points x 100 views, each point seen by 20
    consecutive views, a shared radial (k1, k2) = (-0.3, 0.05), 2 % of the
    visible observations moved by 0.5 N(0, 1), X and t perturbed by
    0.05 N(0, 1), Huber, two shared refit rounds from zero. Phase 4q runs
    the same problem through each family of ``FAMILY_TRUTHS`` with
    ``rounds=1`` from ``default_distortion`` and X and t perturbed by
    ``FAMILY_SIGMA`` (``sigma``); full OPENCV also without the outliers and
    the loss (``robust=False``), where its model is held, since under Huber
    it is reported only (``hold_model=False``, ``FAMILY_SIGMA``'s comment).
    Returns the record."""
    from mvrecon_tpu_torch.config import LMConfig
    from mvrecon_tpu_torch.models import bundle_adjustment as tba
    from mvrecon_tpu_torch.ops.procrustes import aligned_rmse

    scene, truth, dist, x, vis, inlier, n_out, s_max, margin = bal_problem(
        torch, bal_points, model, truth_k, robust, name)
    npts, nf = scene.X.shape[0], DENSE_VIEWS
    start = perturbed_cameras(scene, seed=30, sigma=sigma)
    cfg = LMConfig(scale_factor=4.0, delta_tol=1e-4, max_iter=30, accept_divisor=1.0,
                   init_damping=3e-3, damping="nielsen", robust="huber" if robust else None,
                   huber_delta=HUBER_DELTA, distortion_rounds=rounds, distortion_shared=True,
                   distortion_model=model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(fs, sy)
    t0 = time.perf_counter()
    res = tba.bundle_adjust(x, *start, visibility=vis.float(), axis="x-up_z-forward", config=cfg)
    err = float(res.error)
    wall = time.perf_counter() - t0
    launches = launch_counts(fs, sy)
    e_in, n_in = distorted_inlier_error(torch, tba, res, x, inlier, 4096, model)
    rec = {
        "model": model, "rounds": rounds, "start_sigma": sigma, "robust": robust,
        "model_error_held": hold_model,
        "points": npts, "views": nf, "window": BAL_WINDOW, "observations": int(vis.sum()),
        "outliers": n_out, "wall_s": wall, "n_iter": res.n_iter,
        "retries": res.log["n_solver_retries"], "weighted_E": err, "inlier_E": e_in,
        "inlier_E_vs_noise_floor": e_in / (n_in * 2 * NOISE**2),
        "k": res.distortion[0].tolist(), "k_true": list(truth_k),
        "k_max_abs_err": k_error(res, truth_k),
        "k1_abs_err": abs(float(res.distortion[0, 0]) - truth_k[0]),
        "model_rms_rel_err": model_error(torch, tba, truth, res.distortion, dist, model=model),
        "monotone_margin": margin, "s_max": s_max,
        "aligned_rmse_X": float(aligned_rmse(res.X, scene.X)),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "syrk_acc_launches": launches[0], "syrk_lower_launches": launches[1],
        "finite": math.isfinite(err) and finite(torch, res.X, res.K, res.R, res.t),
    }
    print(f"{name} " + json.dumps(rec), flush=True)
    check(rec["finite"], f"{name}: an output is not finite")
    check(launches == (0, 0), f"{name} launched the SYRK kernels {launches}")
    check(rec["inlier_E_vs_noise_floor"] < 1.5,
          f"{name}: inlier E / floor {rec['inlier_E_vs_noise_floor']:.4f}")
    check(rec["model_rms_rel_err"] < MODEL_TOL or not hold_model,
          f"{name}: the recovered model's displacement is off by "
          f"{rec['model_rms_rel_err']:.4f} of the true one's (limit {MODEL_TOL})")
    return rec


def distorted_chunked(torch, fs, sy, scene, config) -> int:
    """Phase 4n: phase 4's scene rendered through the shared BAL radial
    truth, ``bundle_adjust_chunked`` (the fused build, K2) from X and t
    perturbed by 0.02 N(0, 1), two shared refit rounds from zero and
    ``DIST_ITERS`` Nielsen iterations a segment; then
    ``ba_covariance_chunked`` of its result with its distortion. Returns
    the K2 launches."""
    from mvrecon_tpu_torch.models import bundle_adjustment as tba
    from mvrecon_tpu_torch.models.bundle_adjustment_chunked import bundle_adjust_chunked
    from mvrecon_tpu_torch.models.covariance import ba_covariance_chunked
    from mvrecon_tpu_torch.ops.procrustes import aligned_rmse

    truth = true_state(tba, scene)
    npts, nf = scene.X.shape[0], scene.K.shape[0]
    dist = torch.tensor(RADIAL_TRUTH, device="cuda").expand(nf, 2)
    x = torch.empty((npts, nf, 2), device="cuda")
    s_max = render_all(torch, tba, truth, dist, torch.Generator(device="cuda").manual_seed(31),
                       x)
    margin = check_monotone("distorted chunked", RADIAL_TRUTH, s_max)
    start = perturbed_cameras(scene, seed=31)
    n_chunks = math.ceil(npts / CHUNK)
    cfg = dataclasses.replace(config, max_iter=DIST_ITERS, distortion_rounds=2,
                              distortion_shared=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(fs, sy)
    t0 = time.perf_counter()
    res = bundle_adjust_chunked(x, *start, axis="x-up_z-forward", config=cfg, chunk_size=CHUNK)
    err = float(res.error)
    wall = time.perf_counter() - t0
    launches = launch_counts(fs, sy)
    retries = res.log["n_solver_retries_total"]
    floor = npts * nf * 2 * NOISE**2
    rec = {
        "points": npts, "views": nf, "chunk": CHUNK, "chunks": n_chunks,
        "iters_per_segment": DIST_ITERS, "rounds": cfg.distortion_rounds, "wall_s": wall,
        "n_iter": res.n_iter, "retries": retries, "wall_per_retry_s": wall / retries,
        "syrk_acc_launches": launches[0], "syrk_lower_launches": launches[1],
        "reprojection_error": err, "E_vs_noise_floor": err / floor,
        "k": res.distortion[0].tolist(), "k_true": list(RADIAL_TRUTH),
        "k_max_abs_err": k_error(res, RADIAL_TRUTH),
        "k1_abs_err": abs(float(res.distortion[0, 0]) - RADIAL_TRUTH[0]),
        "model_rms_rel_err": model_error(torch, tba, truth, res.distortion, dist),
        "monotone_margin": margin, "s_max": s_max,
        "aligned_rmse_X": float(aligned_rmse(res.X, scene.X)),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "finite": math.isfinite(err) and finite(torch, res.X, res.K, res.R, res.t),
    }
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cov = ba_covariance_chunked(x, res.X, res.K, res.R, res.t, f0=1.0, axis="x-up_z-forward",
                                chunk_size=CHUNK, distortion=res.distortion)
    sigma = math.sqrt(float(cov.sigma2))
    rec["covariance"] = {
        "wall_s": time.perf_counter() - t0, "sigma": sigma, "sigma_true": NOISE,
        "finite": finite(torch, cov.point_cov, cov.camera_cov, cov.sigma2),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    del cov, res, x
    print("distorted_chunked " + json.dumps(rec), flush=True)
    check(rec["finite"], "distorted chunked: an output is not finite")
    check(launches[0] == retries * n_chunks > 0 and launches[1] == 0,
          f"distorted chunked: launches {launches} != (retries {retries} x chunks {n_chunks}, 0)")
    check(rec["E_vs_noise_floor"] < 1.5,
          f"distorted chunked: E / floor {rec['E_vs_noise_floor']:.4f}")
    check(rec["model_rms_rel_err"] < MODEL_TOL,
          f"distorted chunked: the recovered model's displacement is off by "
          f"{rec['model_rms_rel_err']:.4f} of the true one's (limit {MODEL_TOL})")
    check(rec["covariance"]["finite"], "distorted chunked covariance: a block is not finite")
    check(abs(sigma / NOISE - 1.0) < 0.05,
          f"distorted chunked covariance: sigma {sigma:.6g} against the true {NOISE}")
    return launches[0]


def nonfused_chunked(torch, fs, sy, scene, config, model: str = "opencv",
                     truth_k=OPENCV_TRUTH, seed: int = 32, name: str = "opencv_chunked") -> dict:
    """Phase 4o: phase 4's scene rendered through the shared OPENCV truth,
    ``bundle_adjust_chunked`` (the non-fused build, K1) from X and t
    perturbed by 0.02 N(0, 1), one shared refit round from zeros and
    ``DIST_ITERS`` Nielsen iterations a segment; K1's launches and the
    builds timed by CUDA events inside the run. Phase 4r runs each family
    of ``FAMILY_TRUTHS`` the same way, from ``default_distortion``; the
    refit's passes over the chunks (8 for full OPENCV, 6 for FOV) launch
    no kernel. Returns the record."""
    from mvrecon_tpu_torch.models import bundle_adjustment as tba
    from mvrecon_tpu_torch.models import bundle_adjustment_chunked as tbc
    from mvrecon_tpu_torch.ops.procrustes import aligned_rmse
    from mvrecon_tpu_torch.runtime.profiling import EventTimer

    truth = true_state(tba, scene)
    npts, nf = scene.X.shape[0], scene.K.shape[0]
    dist = torch.tensor(truth_k, device="cuda").expand(nf, len(truth_k))
    x = torch.empty((npts, nf, 2), device="cuda")
    s_max = render_all(torch, tba, truth, dist, torch.Generator(device="cuda").manual_seed(seed),
                       x, model=model)
    margin = check_monotone(name, truth_k, s_max, torch, tba,
                            None if model == "opencv" else model)
    start = perturbed_cameras(scene, seed=seed)
    n_chunks = math.ceil(npts / CHUNK)
    cfg = dataclasses.replace(config, max_iter=DIST_ITERS, distortion_rounds=1,
                              distortion_shared=True, distortion_model=model)
    timer = EventTimer()
    syrk_lower, build = sy.syrk_lower, tbc._build_system

    def timed_syrk_lower(y):
        with timer.span("syrk_lower"):
            return syrk_lower(y)

    def timed_build(*args, **kwargs):
        with timer.span("build"):
            return build(*args, **kwargs)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(fs, sy)
    sy.syrk_lower, tbc._build_system = timed_syrk_lower, timed_build
    try:
        t0 = time.perf_counter()
        res = tbc.bundle_adjust_chunked(x, *start, axis="x-up_z-forward", config=cfg,
                                        chunk_size=CHUNK)
        err = float(res.error)
        wall = time.perf_counter() - t0
    finally:
        sy.syrk_lower, tbc._build_system = syrk_lower, build
    launches = launch_counts(fs, sy)
    spans = timer.ms()
    retries = res.log["n_solver_retries_total"]
    floor = npts * nf * 2 * NOISE**2
    k1_ms = spans["syrk_lower"]
    rec = {
        "model": model, "points": npts, "views": nf, "chunk": CHUNK, "chunks": n_chunks,
        "iters_per_segment": DIST_ITERS, "rounds": cfg.distortion_rounds, "wall_s": wall,
        "n_iter": res.n_iter, "retries": retries, "wall_per_retry_s": wall / retries,
        "retries_last_segment": res.log["n_solver_retries"],
        "syrk_acc_launches": launches[0], "syrk_lower_launches": launches[1],
        "syrk_lower_ms_median": statistics.median(k1_ms), "syrk_lower_ms_min": min(k1_ms),
        "syrk_lower_ms_max": max(k1_ms), "syrk_lower_s_total": sum(k1_ms) / 1e3,
        "build_s_per_retry": statistics.mean(spans["build"]) / 1e3,
        "build_share_of_retry": statistics.mean(spans["build"]) / 1e3 / (wall / retries),
        "reprojection_error": err, "E_vs_noise_floor": err / floor,
        "k": res.distortion[0].tolist(), "k_true": list(truth_k),
        "k_max_abs_err": k_error(res, truth_k),
        "k1_abs_err": abs(float(res.distortion[0, 0]) - truth_k[0]),
        "model_rms_rel_err": model_error(torch, tba, truth, res.distortion, dist, model=model),
        "monotone_margin": margin, "s_max": s_max,
        "aligned_rmse_X": float(aligned_rmse(res.X, scene.X)),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "finite": math.isfinite(err) and finite(torch, res.X, res.K, res.R, res.t),
    }
    del res, x
    print(f"{name} " + json.dumps(rec), flush=True)
    check(rec["finite"], f"{name}: an output is not finite")
    check(launches[1] == retries * n_chunks > 0 and launches[0] == 0,
          f"{name}: launches {launches} != (0, retries {retries} x chunks {n_chunks})")
    check(len(k1_ms) == launches[1], f"{name}: a K1 launch was not timed")
    check(rec["E_vs_noise_floor"] < 1.5, f"{name}: E / floor {rec['E_vs_noise_floor']:.4f}")
    check(rec["model_rms_rel_err"] < MODEL_TOL,
          f"{name}: the recovered model's displacement is off by "
          f"{rec['model_rms_rel_err']:.4f} of the true one's (limit {MODEL_TOL})")
    return rec


def north_star_config(LMConfig, ba_iters: int):
    """Phase 4's Nielsen schedule (``bench.py::bench_northstar_pipeline``)."""
    return LMConfig(scale_factor=4.0, delta_tol=0.0, max_iter=ba_iters, accept_divisor=1.0,
                    init_damping=3e-3, damping="nielsen")


def dense_config(LMConfig):
    """Phase 4c's schedule (``bench.py::bench_headline``): 10 iterations."""
    return LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=10)


def nonfused_problem_host(torch, tba, scene, config, model: str = "opencv",
                          truth_k=OPENCV_TRUTH, seed: int = 32):
    """Phase 4o's problem with its observations in host memory, rendered
    exactly as 4o renders them on the card: (x_host (P, F, 2), start,
    config)."""
    truth = true_state(tba, scene)
    nf = scene.K.shape[0]
    dist = torch.tensor(truth_k, device="cuda").expand(nf, len(truth_k))
    x_host = np.empty((scene.X.shape[0], nf, 2), dtype=np.float32)
    render_all(torch, tba, truth, dist, torch.Generator(device="cuda").manual_seed(seed), x_host,
               model=model)
    cfg = dataclasses.replace(config, max_iter=DIST_ITERS, distortion_rounds=1,
                              distortion_shared=True, distortion_model=model)
    return x_host, perturbed_cameras(scene, seed=seed), cfg


def dense_problem_host(torch, make_synthetic_scene, dense_points: int, views: int = DENSE_VIEWS,
                       dtype=None):
    """Phase 4c's problem as host numpy (x, X0, K, R, t0), drawn from 4c's
    seed (5k's at ``views`` and ``dtype``, float32 by default)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    scene = make_synthetic_scene(gen, n_images=views, n_slices=dense_points // 20,
                                 n_angles=20, dtype=dtype or torch.float32)
    return perturbed_start(scene, seed=3, sigma=0.05)


@contextlib.contextmanager
def timed_allreduces(torch):
    """A context in which every ``torch.distributed.all_reduce`` is timed
    on the host between two syncs (the first call of a process group also
    sets up its communicator); it yields the stats: calls, bytes, ms, the
    first call's ms and each call's (elements, ms)."""
    import torch.distributed as dist

    stats = {"calls": 0, "bytes": 0, "ms": 0.0, "first_ms": None, "sizes": []}
    all_reduce = dist.all_reduce

    def timed_all_reduce(tensor, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = all_reduce(tensor, *args, **kwargs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        stats["ms"] += ms
        stats["first_ms"] = ms if stats["first_ms"] is None else stats["first_ms"]
        stats["calls"] += 1
        stats["bytes"] += tensor.numel() * tensor.element_size()
        stats["sizes"].append((tensor.numel(), ms))
        return out

    dist.all_reduce = timed_all_reduce
    try:
        yield stats
    finally:
        dist.all_reduce = all_reduce


def sharded_run(torch, fs, sy, fn, mesh, problem, **kw) -> tuple[dict, object]:
    """``fn(mesh, *problem, **kw)`` (a sharded BA entry point) with its K1
    and K2 launches, its wall (host clock ending in a sync), this rank's
    peak device memory, and its all-reduces (``timed_allreduces``): calls,
    bytes and time. Returns (record, result)."""
    import torch.distributed as dist

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    reset_launch_counts(fs, sy)
    with timed_allreduces(torch) as stats:
        t0 = time.perf_counter()
        res = fn(mesh, *problem, axis="x-up_z-forward", **kw)
        err = float(res.error)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts(fs, sy)
    rec = {
        "ranks": dist.get_world_size(), "backend": dist.get_backend(), "wall_s": wall,
        "n_iter": int(res.n_iter), "reprojection_error": err,
        "syrk_acc_launches": launches[0], "syrk_lower_launches": launches[1],
        "allreduce_calls": stats["calls"], "allreduce_bytes": stats["bytes"],
        "allreduce_ms": stats["ms"], "allreduce_ms_first_call": stats["first_ms"],
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "peak_over_start_gb": (torch.cuda.max_memory_allocated() - start_bytes) / 1e9,
        "finite": math.isfinite(err) and finite(torch, res.X, res.K, res.R, res.t),
    }
    if res.log is not None:
        rec["retries_last_segment"] = int(res.log["n_solver_retries"])
    return rec, res


@contextlib.contextmanager
def counted_2d(torch):
    """A context in which the 2D core's matvecs are counted, a solve at a
    time (a solve ends at its pmax of delta_xi), and its collectives,
    looked up by name in ``sharded_ba_2d`` (``all_gather_axis``,
    ``ppermute_axis``, ``pmax_axis``, and ``_psum`` by axis), are timed on
    the host between two syncs; it yields the stats: per name (``_psum``
    per axis, the row block apart) calls, bytes (each call's result: the
    all-reduced buffer, or the shard received) and ms, and the CG
    iterations of each solve."""
    from mvrecon_tpu_torch.parallel import sharded_ba_2d as s2d

    names = ("all_gather_axis", "ppermute_axis", "pmax_axis", "_psum")
    stats = {"matvecs": 0, "cg_iters_per_solve": [],
             **{n: {"calls": 0, "bytes": 0, "ms": 0.0} for n in names}}
    saved = {n: getattr(s2d, n) for n in names + ("_gather_matvec", "_ring_matvec")}

    def timed(name):
        def call(v, axis_name, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = saved[name](v, axis_name, *args, **kwargs)
            torch.cuda.synchronize()
            key = name
            if name == "_psum":  # the row block, the rhs, or the ring's dot products
                key = f"_psum {axis_name} {'block' if v.dim() == 2 else 'vector'}"
            st = stats.setdefault(key, {"calls": 0, "bytes": 0, "ms": 0.0})
            st["calls"] += 1
            st["bytes"] += out.numel() * out.element_size()
            st["ms"] += (time.perf_counter() - t0) * 1e3
            if name == "pmax_axis" and v.dim() == 1:  # delta_xi: the solve ends
                stats["cg_iters_per_solve"].append(
                    stats["matvecs"] - sum(stats["cg_iters_per_solve"]))
            return out
        return call

    def counted(name):
        def call(*args, **kwargs):
            stats["matvecs"] += 1
            return saved[name](*args, **kwargs)
        return call

    for name in names:
        setattr(s2d, name, timed(name))
    for name in ("_gather_matvec", "_ring_matvec"):
        setattr(s2d, name, counted(name))
    try:
        yield stats
    finally:
        for name, fn in saved.items():
            setattr(s2d, name, fn)


def sharded_2d_run(torch, fs, sy, mesh, problem, config, mode: str, cg: dict):
    """One ``sharded_bundle_adjust_2d`` run of phase 5k on this rank
    (``sharded_run``, ``counted_2d``): the record with its retries, CG
    iterations a solve, the cameras-axis traffic (the gather's bytes and
    ms a call, the ring's point-to-point bytes and ms a matvec, the pmax's
    bytes a solve) and the row block's all-reduce over the points axis;
    and the result's (X, K, R, t) as host arrays."""
    from mvrecon_tpu_torch.parallel.mesh import mesh_shape
    from mvrecon_tpu_torch.parallel.sharded_ba_2d import sharded_bundle_adjust_2d

    with counted_2d(torch) as c:
        rec, res = sharded_run(torch, fs, sy, sharded_bundle_adjust_2d, mesh, problem,
                               config=config, matvec_mode=mode, **cg)
    solves = c["cg_iters_per_solve"]

    def per_call(name: str) -> dict:
        st = c.get(name, {"calls": 0, "bytes": 0, "ms": 0.0})
        n = max(st["calls"], 1)
        return {"calls": st["calls"], "bytes_per_call": st["bytes"] / n, "ms_per_call": st["ms"] / n}

    rec.update(
        mesh=mesh_shape(mesh), matvec_mode=mode, views=problem[0].shape[1],
        points=problem[0].shape[0], dtype=str(res.X.dtype), cg=cg,
        retries=len(solves), cg_iters_per_solve=solves, matvecs=c["matvecs"],
        gather=per_call("all_gather_axis"), p2p=per_call("ppermute_axis"),
        p2p_ms_per_matvec=c["ppermute_axis"]["ms"] / max(c["matvecs"], 1),
        p2p_bytes_per_matvec=c["ppermute_axis"]["bytes"] / max(c["matvecs"], 1),
        pmax_bytes_per_solve=c["pmax_axis"]["bytes"] / max(len(solves), 1),
        ring_dot_allreduce=per_call("_psum cameras vector"),
        row_block_allreduce={**per_call("_psum points block"),
                             "points_ranks": mesh_shape(mesh)["points"]})
    return rec, [a.cpu().numpy() for a in (res.X, res.K, res.R, res.t)]


def sharded_2d_problems(torch, make_synthetic_scene, dense_points: int) -> dict:
    """Phase 5k's two problems as host numpy, each with its config and CG
    settings: float32 at ``dense_points`` x 2,000 views with 4c's schedule,
    float64 at 1,000 points with 5 iterations."""
    from mvrecon_tpu_torch.config import LMConfig

    f64_points = min(SHARDED_2D_F64_POINTS, dense_points)
    return {
        "float32": (dense_problem_host(torch, make_synthetic_scene, dense_points,
                                       SHARDED_2D_VIEWS), dense_config(LMConfig), {}),
        "float64": (dense_problem_host(torch, make_synthetic_scene, f64_points,
                                       SHARDED_2D_VIEWS, torch.float64),
                    dataclasses.replace(dense_config(LMConfig), max_iter=SHARDED_2D_F64_ITERS,
                                        init_damping=SHARDED_2D_F64_DAMPING),
                    SHARDED_2D_F64_CG),
    }


def sharded_2d_ranks(torch, fs, sy, problems: dict, n_cameras: int) -> tuple[dict, dict]:
    """Phase 5k's 2D runs on a {points: 1, cameras: n_cameras} mesh of this
    process group's ranks: each of ``problems`` (``sharded_2d_problems``)
    in both matvec modes. Returns the records and the results' arrays, by
    ``precision/mode``."""
    from mvrecon_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"points": 1, "cameras": n_cameras})
    recs, arrays = {}, {}
    for prec, (prob, cfg, cg) in problems.items():
        for mode in SHARDED_2D_MODES:
            recs[f"{prec}/{mode}"], arrays[f"{prec}/{mode}"] = sharded_2d_run(
                torch, fs, sy, mesh, prob, cfg, mode, cg)
            torch.cuda.empty_cache()
    return recs, arrays


def sharded_2d_one_rank(torch, fs, sy, dense_points: int) -> tuple[dict, dict]:
    """Phase 5k at one rank (the NCCL group): per problem its start E and
    noise floor, ``sharded_bundle_adjust`` (1D, Cholesky) as the
    reference, then ``sharded_2d_ranks`` on a 1 x 1 mesh."""
    from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu_torch.models import bundle_adjustment as tba
    from mvrecon_tpu_torch.parallel import sharded_ba as sba
    from mvrecon_tpu_torch.parallel.mesh import make_mesh

    ref = {}
    problems = sharded_2d_problems(torch, make_synthetic_scene, dense_points)
    for prec, (prob, cfg, _) in problems.items():
        x, vis, state, _, _ = tba._prepare_problem(*prob, 1.0, None, "x-up_z-forward", "cuda")
        start_E = float(tba._state_error(state, x, vis, 1.0))
        del x, vis, state
        rec, res = sharded_run(torch, fs, sy, sba.sharded_bundle_adjust, make_mesh({"points": 1}),
                               prob, config=cfg)
        rec.update(start_E=start_E, noise_floor=prob[0].shape[0] * prob[0].shape[1] * 2 * NOISE**2,
                   points=prob[0].shape[0], views=prob[0].shape[1])
        ref[prec] = rec
        del res
        torch.cuda.empty_cache()
    recs, arrays = sharded_2d_ranks(torch, fs, sy, problems, 1)
    return {"reference_1d": ref, "runs": recs}, arrays


def check_sharded_2d(one: dict, two: list[dict], two_arrays: list[dict]) -> dict:
    """5k's checks, after its record is printed: every run finite, below
    its start E, E / floor < 1.5 and no K1 or K2 launch; the two ranks'
    results equal; in float32 the peak memory a rank at 1 x 2 below the
    1 x 1 run's; in float64 no solve at its CG cap, E within
    ``SHARDED_2D_E_RTOL`` of the 1D core's and ring within
    ``SHARDED_2D_RING_E_RTOL`` of all_gather on each mesh. The float32
    gaps to the 1D core are printed, not held. Returns the launches of K2
    and K1 by run."""
    ref = one["reference_1d"]
    runs = {f"{key} 1x1": r for key, r in one["runs"].items()}
    runs.update({f"{key} 1x2 rank {i}": t[key] for i, t in enumerate(two) for key in t})
    gaps = {name: abs(r["reprojection_error"] - ref[name.split("/")[0]]["reprojection_error"])
            / ref[name.split("/")[0]]["reprojection_error"] for name, r in runs.items()}
    for label in ["1x1"] + [f"1x2 rank {i}" for i in range(len(two))]:
        e_ag, e_ring = (runs[f"float64/{m} {label}"]["reprojection_error"]
                        for m in SHARDED_2D_MODES)
        gaps[f"float64 ring vs all_gather {label}"] = abs(e_ring - e_ag) / e_ag
    print("sharded_2d " + json.dumps({
        "reference_1d": ref, "runs": runs, "E_rel_gaps": gaps,
        "limits": {"E_rtol_float64": SHARDED_2D_E_RTOL,
                   "ring_E_rtol_float64": SHARDED_2D_RING_E_RTOL}}), flush=True)
    for name, r in runs.items():
        prec = name.split("/")[0]
        e, floor = r["reprojection_error"], ref[prec]["noise_floor"]
        check(r["finite"], f"5k {name}: an output is not finite")
        check(e < ref[prec]["start_E"], f"5k {name}: E {e} is not below the start")
        check(e / floor < 1.5, f"5k {name}: E / floor {e / floor:.4f}")
        check((r["syrk_acc_launches"], r["syrk_lower_launches"]) == (0, 0),
              f"5k {name}: launched a SYRK kernel")
        if prec == "float64":
            check(gaps[name] <= SHARDED_2D_E_RTOL,
                  f"5k {name}: E {gaps[name]:.3e} from the 1D core's")
            check(max(r["cg_iters_per_solve"]) < r["cg"]["cg_max_iter"],
                  f"5k {name}: a CG solve reached its cap")
    for key in one["runs"]:
        check(all(np.array_equal(a, b) for a, b in zip(two_arrays[0][key], two_arrays[1][key]))
              and two[0][key]["reprojection_error"] == two[1][key]["reprojection_error"],
              f"5k {key}: the ranks returned different results")
        if key.startswith("float32"):
            peaks = [t[key]["peak_over_start_gb"] for t in two]
            check(max(peaks) < one["runs"][key]["peak_over_start_gb"],
                  f"5k {key}: peak memory a rank at 1 x 2 {peaks} not below 1 x 1's "
                  f"{one['runs'][key]['peak_over_start_gb']}")
    for name, gap in gaps.items():
        if name.startswith("float64 ring"):
            check(gap <= SHARDED_2D_RING_E_RTOL, f"5k {name}: E {gap:.3e} apart")
    return {key: {name: r[key] for name, r in list(ref.items()) + list(runs.items())}
            for key in ("syrk_acc_launches", "syrk_lower_launches")}


def per_retry(rec: dict, n_chunks: int) -> None:
    """Add the retries (K1 launches over the chunks a rank) and the
    all-reduce's bytes and ms a retry to a chunked record."""
    rec["chunks_per_rank"] = n_chunks
    rec["retries"] = rec["syrk_lower_launches"] // n_chunks
    rec["allreduce_bytes_per_retry"] = rec["allreduce_bytes"] / rec["retries"]
    rec["allreduce_ms_per_retry"] = rec["allreduce_ms"] / rec["retries"]


def sharded_rank(args) -> int:
    """One of phases 5b-5k's two ranks, a process of its own on the one
    card (``--sharded-rank``): it joins a two-rank group with gloo named
    for CUDA tensors (NCCL takes one rank a card), draws 4o's and 4c's
    problems in host memory from their seeds, runs
    ``sharded_bundle_adjust_chunked`` on the first and
    ``sharded_bundle_adjust`` on the second (5b, 5c), the sharded
    covariance of that result (5f), the sharded pipeline on 4c's
    observations (5e), the large pipeline with the mesh on phase 4's
    scene (5d), the sharded sparse core on 4u's list from the ranks'
    directory (5h), the sharded affine pipeline on 4h's 10k x 100 scene
    and its half of 4f's batch by ``shard_scenes`` (5i), the two-rank
    commands (5j) and the 2D BA on a {points: 1, cameras: 2} mesh (5k),
    and writes its records and results to ``--sharded-out``."""
    import torch
    import torch.distributed as dist

    from mvrecon_tpu_torch.config import LMConfig
    from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu_torch.models import bundle_adjustment as tba
    from mvrecon_tpu_torch.ops import fused_schur as fs
    from mvrecon_tpu_torch.ops import syrk as sy
    from mvrecon_tpu_torch.parallel import sharded_ba as sba
    from mvrecon_tpu_torch.parallel.mesh import make_mesh
    from mvrecon_tpu_torch.runtime.distributed import initialize

    world, rank = SHARDED_RANKS, args.sharded_rank
    initialize(f"127.0.0.1:{args.sharded_port}", world, rank, backend="gloo")
    try:
        mesh = make_mesh({"points": world})
        _, scene = north_star_scenes(torch, make_synthetic_scene, args.points)
        x_host, start, cfg = nonfused_problem_host(torch, tba, scene,
                                                   north_star_config(LMConfig, args.ba_iters))
        del scene
        torch.cuda.empty_cache()
        rec, res = sharded_run(torch, fs, sy, sba.sharded_bundle_adjust_chunked, mesh,
                               (x_host,) + start, config=cfg, chunk_size=CHUNK)
        per_retry(rec, math.ceil(math.ceil(x_host.shape[0] / world) / CHUNK))
        out = {f"chunked_{k}": v.cpu().numpy()
               for k, v in zip(("X", "K", "R", "t", "distortion"),
                               (res.X, res.K, res.R, res.t, res.distortion))}
        del res, x_host
        torch.cuda.empty_cache()
        d_rec, d_res = sharded_run(torch, fs, sy, sba.sharded_bundle_adjust, mesh,
                                   dense_problem_host(torch, make_synthetic_scene,
                                                      args.dense_points),
                                   config=dense_config(LMConfig))
        out.update({f"dense_{k}": getattr(d_res, k).cpu().numpy() for k in ("X", "K", "R", "t")})
        d_prob = dense_problem_host(torch, make_synthetic_scene, args.dense_points)
        # 5f on 5c's result; 5e on 4d's observations; 5d on phase 4's scene
        cov_rec = sharded_covariance(torch, mesh, d_prob[0],
                                     [out[f"dense_{k}"] for k in ("X", "K", "R", "t")])
        del d_res
        p_rec, out["pipeline_X"] = sharded_pipeline(torch, fs, sy, mesh,
                                                    d_prob[0].transpose(1, 0, 2),
                                                    dense_config(LMConfig))
        del d_prob
        torch.cuda.empty_cache()
        _, scene = north_star_scenes(torch, make_synthetic_scene, args.points)
        l_rec, out["large_X"] = sharded_large(torch, fs, sy, mesh, scene,
                                              north_star_config(LMConfig, args.ba_iters))
        del scene
        torch.cuda.empty_cache()
        # 5h on 4u's list; 5i on 4h's scene and 4f's batch; 5j's commands
        h_rec, out["sparse_X"] = sharded_sparse(torch, fs, sy, mesh,
                                                os.path.join(args.sharded_out, "sparse.npz"))
        torch.cuda.empty_cache()
        i_rec, out["affine_X"] = sharded_affine(torch, fs, sy, mesh,
                                                affine_scene_host(torch, args.dense_points))
        i_rec["shard_scenes"] = scenes_block(torch, make_mesh({"scenes": world}),
                                             args.batched_scenes)
        argvs = sharded_cli_argv(args.sharded_out, args.dense_points)
        j_rec = sharded_commands(torch, fs, sy, argvs, world)
        tight = sparse_tight(torch, mesh, argvs["bal_sparse"])
        torch.cuda.empty_cache()
        # 5k: the 2D core on a {points: 1, cameras: 2} mesh
        k_rec, k_arrays = sharded_2d_ranks(
            torch, fs, sy, sharded_2d_problems(torch, make_synthetic_scene, args.dense_points),
            world)
        out.update({f"2d.{key}.{n}": a for key, arrs in k_arrays.items()
                    for n, a in zip("XKRt", arrs)})
        out["records"] = np.array(json.dumps({
            "chunked": rec, "dense": d_rec, "covariance": cov_rec, "pipeline": p_rec,
            "large": l_rec, "sparse": h_rec, "affine": i_rec, "commands": j_rec,
            "sparse_tight": tight, "sharded_2d": k_rec}))
        np.savez(f"{args.sharded_out}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
    return 0


def launch_sharded_ranks(args, rank_dir: str) -> list[dict]:
    """Start ``SHARDED_RANKS`` ranks of this script (``sharded_rank``), each
    with its output in a file of ``rank_dir`` (which holds the inputs of
    5h and 5j); stop them all when one fails or after
    ``SHARDED_RANK_TIMEOUT_S``; fail unless each exits 0. Returns each
    rank's arrays and records."""
    from mvrecon_tpu_torch.runtime.distributed import free_port

    port = free_port()
    logs = [open(f"{rank_dir}/rank{r}.log", "w") for r in range(SHARDED_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sharded-rank", str(r), "--sharded-port",
         str(port), "--sharded-out", rank_dir, "--points", str(args.points), "--ba-iters",
         str(args.ba_iters), "--dense-points", str(args.dense_points), "--batched-scenes",
         str(args.batched_scenes)],
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(SHARDED_RANKS)]
    deadline = time.monotonic() + SHARDED_RANK_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    codes = [p.returncode for p in procs]
    if codes != [0] * SHARDED_RANKS:
        for r in range(SHARDED_RANKS):
            with open(f"{rank_dir}/rank{r}.log") as f:
                print(f"rank {r} (exit {codes[r]}):\n" + f.read()[-4000:], file=sys.stderr)
        check(False, f"sharded ranks exited {codes} (timeout {SHARDED_RANK_TIMEOUT_S} s)")
    outs = []
    for r in range(SHARDED_RANKS):
        with np.load(f"{rank_dir}/rank{r}.npz") as z:
            out = {k: z[k] for k in z.files}
        out["records"] = json.loads(str(out["records"]))
        outs.append(out)
    return outs


def max_abs_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def sharded_large(torch, fs, sy, mesh, scene, config) -> tuple[dict, np.ndarray]:
    """Phase 5d on this rank: ``euclidean_reconstruction_large(mesh=)`` on
    phase 4's scene (on the card) and config. The calibration runs
    sharded; the chunked BA (the fused build, K2) runs whole on every
    rank. Its depth iterations are its Gram all-reduces, (3F)^2 values
    each, less the factorization's one. Returns (record, X on the host)."""
    import torch.distributed as dist

    from mvrecon_tpu_torch.models.pipelines import euclidean_reconstruction_large
    from mvrecon_tpu_torch.runtime.profiling import StageTimer

    n_points = scene.X.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    reset_launch_counts(fs, sy)
    timer = StageTimer()
    with timed_allreduces(torch) as ar:
        t0 = time.perf_counter()
        res = euclidean_reconstruction_large(scene.x, config=config, chunk_size=CHUNK, mesh=mesh,
                                             timer=timer)
        err = float(res.error)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts(fs, sy)
    gram_ms = [ms for numel, ms in ar["sizes"] if numel == (3 * VIEWS) ** 2]
    depth_iters = len(gram_ms) - 1
    floor = n_points * VIEWS * 2 * NOISE**2
    rec = {
        "ranks": dist.get_world_size(), "backend": dist.get_backend(), "points": n_points,
        "views": VIEWS, "chunk": CHUNK, "wall_s": wall,
        "calibration_s": timer.times["perspective_self_calibration"],
        "ba_s": timer.times["bundle_adjustment"], "status": res.status,
        "depth_iters": depth_iters, "ba_n_iter": res.n_iter,
        "ba_solver_retries": res.ba_log["n_solver_retries"], "chunks": math.ceil(n_points / CHUNK),
        "syrk_acc_launches": launches[0], "syrk_lower_launches": launches[1],
        "reprojection_error": err, "E_vs_noise_floor": err / floor,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "peak_over_start_gb": (torch.cuda.max_memory_allocated() - start_bytes) / 1e9,
        "gram_allreduce_bytes": (3 * VIEWS) ** 2 * 4, "gram_allreduce_ms": gram_ms,
        "allreduce_calls": ar["calls"], "allreduce_bytes": ar["bytes"],
        "allreduce_ms": ar["ms"], "allreduce_ms_first_call": ar["first_ms"],
        "allreduce_bytes_per_depth_iter": ar["bytes"] / max(depth_iters, 1),
        "allreduce_ms_per_depth_iter": ar["ms"] / max(depth_iters, 1),
        "finite": math.isfinite(err) and finite(torch, res.X, res.K, res.R, res.t),
    }
    return rec, res.X.cpu().numpy()


def check_sharded_large(rec: dict, pipe: dict, name: str) -> None:
    """5d's checks of one rank's record against phase 4's."""
    rec["E_rel_diff_vs_4"] = (abs(rec["reprojection_error"] - pipe["reprojection_error"])
                              / pipe["reprojection_error"])
    check(rec["finite"] and rec["status"] == 0 and rec["depth_iters"] > 0,
          f"{name}: status {rec['status']}, {rec['depth_iters']} depth iterations, finite "
          f"{rec['finite']}")
    check(rec["E_vs_noise_floor"] < 1.5, f"{name}: E / floor {rec['E_vs_noise_floor']:.4f}")
    check(rec["E_rel_diff_vs_4"] <= SHARDED_LARGE_E_RTOL,
          f"{name}: E differs from phase 4's by {rec['E_rel_diff_vs_4']:.3e}")
    check(rec["syrk_acc_launches"] == rec["ba_solver_retries"] * rec["chunks"] > 0
          and rec["syrk_lower_launches"] == 0,
          f"{name}: K2 launches {rec['syrk_acc_launches']} != retries "
          f"{rec['ba_solver_retries']} x chunks {rec['chunks']}, or K1 launched")


def sharded_pipeline(torch, fs, sy, mesh, x_fp, config) -> tuple[dict, np.ndarray]:
    """Phase 5e on this rank: ``sharded_euclidean_reconstruction`` of host
    observations x_fp (F, P, 2) with ``config``. Returns (record, X)."""
    import torch.distributed as dist

    from mvrecon_tpu_torch.parallel.pipelines import sharded_euclidean_reconstruction
    from mvrecon_tpu_torch.runtime.profiling import StageTimer

    torch.cuda.synchronize()
    reset_launch_counts(fs, sy)
    timer = StageTimer()
    t0 = time.perf_counter()
    res = sharded_euclidean_reconstruction(mesh, x_fp, config=config, timer=timer)
    err = float(res.error)
    wall = time.perf_counter() - t0
    launches = launch_counts(fs, sy)
    rec = {"ranks": dist.get_world_size(), "points": x_fp.shape[1], "views": x_fp.shape[0],
           "wall_s": wall, "stage_walls_s": timer.times, "status": res.status,
           "ba_n_iter": res.n_iter, "reprojection_error": err,
           "E_vs_noise_floor": err / (x_fp.shape[1] * x_fp.shape[0] * 2 * NOISE**2),
           "syrk_acc_launches": launches[0], "syrk_lower_launches": launches[1],
           "finite": math.isfinite(err) and finite(torch, res.X, res.calib_X)}
    return rec, res.X.cpu().numpy()


def check_sharded_pipeline(rec: dict, dense_pipe: dict, name: str) -> None:
    """5e's checks of one rank's record against 4d's."""
    rec["E_rel_diff_vs_4d"] = (abs(rec["reprojection_error"] - dense_pipe["reprojection_error"])
                               / dense_pipe["reprojection_error"])
    check(rec["finite"] and rec["status"] == 0, f"{name}: status {rec['status']}")
    check(rec["E_vs_noise_floor"] < 1.5, f"{name}: E / floor {rec['E_vs_noise_floor']:.4f}")
    check(rec["E_rel_diff_vs_4d"] <= SHARDED_PIPELINE_E_RTOL,
          f"{name}: E differs from 4d's by {rec['E_rel_diff_vs_4d']:.3e}")
    check((rec["syrk_acc_launches"], rec["syrk_lower_launches"]) == (0, 0),
          f"{name}: a SYRK kernel launched")


def sharded_covariance(torch, mesh, x_pf, state) -> dict:
    """Phase 5f on this rank: ``sharded_ba_covariance`` against
    ``ba_covariance`` on one state, in float64 and float32: the largest
    difference of each block set over its largest entry, sigma^2's
    relative difference, whether NaN sits where the unsharded result has
    it (F10: the float32 factor can fail), sqrt(sigma^2)/sigma, and each
    wall."""
    from mvrecon_tpu_torch.models.covariance import ba_covariance
    from mvrecon_tpu_torch.parallel import sharded_ba_covariance

    rec = {"points": x_pf.shape[0], "views": x_pf.shape[1]}
    for name, dt in (("float64", torch.float64), ("float32", torch.float32)):
        args = [torch.as_tensor(a, device="cuda").to(dt) for a in (x_pf, *state)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = sharded_ba_covariance(mesh, *args, axis="x-up_z-forward")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        u = ba_covariance(*args, axis="x-up_z-forward")
        r = {"wall_s": wall, "sigma_vs_true": math.sqrt(float(s.sigma2)) / NOISE,
             "sigma2_rel_diff": abs(float(s.sigma2) - float(u.sigma2)) / float(u.sigma2),
             "n_obs_equal": int(s.n_obs) == int(u.n_obs),
             "finite": finite(torch, s.point_cov, s.camera_cov)}
        for k in ("point_cov", "camera_cov"):
            a, b = getattr(s, k), getattr(u, k)
            r[f"{k}_nan_where_unsharded"] = bool(torch.equal(a.isnan(), b.isnan()))
            r[f"{k}_nan_share"] = float(a.isnan().double().mean())
            ok = ~(a.isnan() | b.isnan())
            r[f"{k}_rel_diff"] = (float((a - b)[ok].abs().max() / b[ok].abs().max())
                                  if bool(ok.any()) else None)
        rec[name] = r
    return rec


def check_sharded_covariance(rec: dict, name: str) -> None:
    """5f's checks: float64 finite, its blocks within SHARDED_COV_RTOL of
    the unsharded ones; in both dtypes NaN exactly where the unsharded
    result has it, the same n_obs, sigma^2 within 1e-6 and sqrt(sigma^2)
    within 5 % of the true sigma."""
    r64 = rec["float64"]
    check(r64["finite"], f"{name}: float64 blocks are not finite")
    for k in ("point_cov", "camera_cov"):
        check(r64[f"{k}_rel_diff"] <= SHARDED_COV_RTOL,
              f"{name}: float64 {k} differs by {r64[f'{k}_rel_diff']:.3e}")
    for dt in ("float64", "float32"):
        r = rec[dt]
        check(r["point_cov_nan_where_unsharded"] and r["camera_cov_nan_where_unsharded"],
              f"{name} {dt}: NaN where the unsharded blocks have none, or the reverse")
        check(r["n_obs_equal"] and r["sigma2_rel_diff"] < 1e-6
              and abs(r["sigma_vs_true"] - 1.0) < 0.05,
              f"{name} {dt}: n_obs equal {r['n_obs_equal']}, sigma2 off by "
              f"{r['sigma2_rel_diff']:.3e}, sigma / true {r['sigma_vs_true']:.5f}")


def write_sparse_list(prob, path: str) -> None:
    """5h's input, written once: 4u's observation list, start and truth
    as host arrays in one npz, which every rank of 5h reads (each copies
    only its block of the list to its card)."""
    obs, X_gt, X0, K, R, t0, _ = prob
    np.savez(path, point_idx=obs.point_idx.cpu().numpy(), cam_idx=obs.cam_idx.cpu().numpy(),
             xy=obs.xy.cpu().numpy(), X_gt=X_gt.cpu().numpy(), X0=X0.cpu().numpy(),
             K=K.cpu().numpy(), R=R.cpu().numpy(), t0=t0.cpu().numpy())


def sharded_sparse(torch, fs, sy, mesh, path: str) -> tuple[dict, np.ndarray]:
    """Phase 5h on this rank: ``sharded_bundle_adjust_sparse`` with 4u's
    configuration on 4u's list read from ``path`` (host arrays; the rank
    copies its block of the partition), its wall, peak memory, launches,
    CUDA-event spans and all-reduces (float32): the matvec's (9F,) one a
    CG iteration apart from the others a retry. Returns (record, X on the
    host)."""
    import torch.distributed as dist

    from mvrecon_tpu_torch.ops.procrustes import aligned_rmse
    from mvrecon_tpu_torch.parallel.sharded_ba_sparse import sharded_bundle_adjust_sparse
    from mvrecon_tpu_torch.runtime.profiling import EventTimer

    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    nf, n_obs = d["K"].shape[0], d["point_idx"].shape[0]
    timer = EventTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    reset_launch_counts(fs, sy)
    with timed_allreduces(torch) as ar:
        t0 = time.perf_counter()
        res = sharded_bundle_adjust_sparse(
            mesh, d["point_idx"], d["cam_idx"], d["xy"], d["X0"], d["K"], d["R"], d["t0"],
            axis="x-up_z-forward", config=sparse_config(), cg_tol=1e-2,
            cg_max_iter=SPARSE_CG_MAX, timer=timer)
        err = float(res.error)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts(fs, sy)
    sizes = ar["sizes"]
    mv = [ms for numel, ms in sizes if numel == 9 * nf]
    # a retry's other all-reduces: all but the first (the start E, which
    # also sets up the communicator) and the last (the gather of X)
    per_retry = [(numel, ms) for numel, ms in sizes[1:-1] if numel != 9 * nf]
    retries = res.log["n_solver_retries"]
    spans = timer.ms()
    rec = {
        "ranks": dist.get_world_size(), "backend": dist.get_backend(),
        "points": d["X0"].shape[0], "cams": nf, "observations": n_obs, "wall_s": wall,
        "n_iter": res.n_iter, "retries": retries, "cg_iters_total": res.log["cg_iters_total"],
        "converged": res.log["converged"], "weighted_E": err,
        "syrk_acc_launches": launches[0], "syrk_lower_launches": launches[1],
        "allreduce_calls": ar["calls"], "allreduce_bytes": ar["bytes"],
        "allreduce_ms": ar["ms"], "allreduce_ms_first_call": ar["first_ms"],
        "matvec_allreduces": len(mv), "matvec_allreduce_bytes": 9 * nf * 4,
        "matvec_allreduce_ms_median": statistics.median(mv) if mv else None,
        "matvec_ms_median": statistics.median(spans["matvec"]),
        "allreduce_bytes_per_retry": sum(n for n, _ in per_retry) * 4 / retries,
        "allreduce_ms_per_retry": sum(ms for _, ms in per_retry) / retries,
        "gather_allreduce_bytes": sizes[-1][0] * 4, "gather_allreduce_ms": sizes[-1][1],
        "spans": span_summary(spans),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "peak_over_start_gb": (torch.cuda.max_memory_allocated() - start_bytes) / 1e9,
        "aligned_rmse_vs_gt": float(aligned_rmse(res.X, torch.as_tensor(d["X_gt"],
                                                                         device="cuda"))),
        "finite": math.isfinite(err) and finite(torch, res.X, res.K, res.R, res.t),
    }
    return rec, res.X.cpu().numpy()


def check_sharded_sparse(rec: dict, sparse_rec: dict, name: str) -> None:
    """5h's checks of one rank's record against 4u's: finite, no launch,
    aligned RMSE below 0.05; at one rank E, retries and CG iterations
    equal to 4u's, at two E within ``SHARDED_SPARSE_E_RTOL``."""
    rec["E_rel_diff_vs_4u"] = (abs(rec["weighted_E"] - sparse_rec["weighted_E"])
                               / sparse_rec["weighted_E"])
    check(rec["finite"], f"{name}: an output is not finite")
    check((rec["syrk_acc_launches"], rec["syrk_lower_launches"]) == (0, 0),
          f"{name}: a SYRK kernel launched")
    check(rec["aligned_rmse_vs_gt"] < 0.05,
          f"{name}: aligned RMSE {rec['aligned_rmse_vs_gt']:.5f}")
    if rec["ranks"] == 1:
        same = (rec["weighted_E"], rec["retries"], rec["cg_iters_total"]) == (
            sparse_rec["weighted_E"], sparse_rec["retries"], sparse_rec["cg_iters_total"])
        check(same, f"{name}: E, retries, CG iterations {rec['weighted_E']}, {rec['retries']}, "
              f"{rec['cg_iters_total']} against 4u's {sparse_rec['weighted_E']}, "
              f"{sparse_rec['retries']}, {sparse_rec['cg_iters_total']}")
    else:
        check(rec["E_rel_diff_vs_4u"] <= SHARDED_SPARSE_E_RTOL,
              f"{name}: E differs from 4u's by {rec['E_rel_diff_vs_4u']:.3e}")


def affine_scene_host(torch, dense_points: int) -> np.ndarray:
    """4h's 10k x 100 scene (``batched_phases``, seed 13): x (F, P, 2)."""
    from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene

    gen = torch.Generator(device="cuda").manual_seed(13)
    return make_synthetic_scene(gen, n_images=DENSE_VIEWS, n_slices=dense_points // 20,
                                n_angles=20, dtype=torch.float32).x.cpu().numpy()


def affine_config():
    """4h's affine configuration."""
    from mvrecon_tpu_torch.config import LMConfig

    return LMConfig(scale_factor=2.0, delta_tol=1e-8, max_iter=50)


def sharded_affine(torch, fs, sy, mesh, x_fp: np.ndarray) -> tuple[dict, np.ndarray]:
    """Phase 5i on this rank: ``sharded_affine_reconstruction``
    (paraperspective, f = 1, 4h's configuration) of host observations x_fp
    (F, P, 2), its wall, stages and launches; then the calibration alone
    (``sharded_affine_self_calibration``) and its largest gaps to
    ``affine_self_calibration(canonical_signs=True)`` on the same
    observations: S's over S's largest entry, R's as they are. Returns
    (record, X)."""
    import torch.distributed as dist

    from mvrecon_tpu_torch.models.affine import affine_self_calibration
    from mvrecon_tpu_torch.parallel import (
        sharded_affine_reconstruction,
        sharded_affine_self_calibration,
    )
    from mvrecon_tpu_torch.runtime.profiling import StageTimer

    nf, npts = x_fp.shape[:2]
    f = np.ones(nf, np.float32)
    torch.cuda.synchronize()
    reset_launch_counts(fs, sy)
    timer = StageTimer()
    t0 = time.perf_counter()
    res = sharded_affine_reconstruction(mesh, x_fp, f, config=affine_config(), timer=timer)
    err = float(res.error)
    wall = time.perf_counter() - t0
    launches = launch_counts(fs, sy)
    S, R, ok = sharded_affine_self_calibration(mesh, x_fp, f=f)
    S_u, R_u = affine_self_calibration(x_fp, f=f, canonical_signs=True)
    rec = {"ranks": dist.get_world_size(), "points": npts, "views": nf, "wall_s": wall,
           "stage_walls_s": timer.times, "status": res.status, "ba_n_iter": res.n_iter,
           "reprojection_error": err, "E_vs_noise_floor": err / (npts * nf * 2 * NOISE**2),
           "syrk_acc_launches": launches[0], "syrk_lower_launches": launches[1],
           "calibration_ok": bool(ok),
           "S_gap_vs_unsharded": float((S - S_u).abs().max() / S_u.abs().max()),
           "R_gap_vs_unsharded": float((R - R_u).abs().max()),
           "finite": math.isfinite(err) and finite(torch, res.X, res.calib_X)}
    return rec, res.X.cpu().numpy()


def check_sharded_affine(rec: dict, unsharded_E: float, name: str) -> None:
    """5i's checks of one rank's record: status 0, E / floor < 1.5, E within
    ``SHARDED_AFFINE_E_RTOL`` of the unsharded pipeline's, the
    calibration's S and R gaps within ``SHARDED_AFFINE_CALIB_GAP``, no
    launch."""
    rec["E_rel_diff_vs_unsharded"] = abs(rec["reprojection_error"] - unsharded_E) / unsharded_E
    check(rec["finite"] and rec["status"] == 0 and rec["calibration_ok"],
          f"{name}: status {rec['status']}, ok {rec['calibration_ok']}, finite {rec['finite']}")
    check(rec["E_vs_noise_floor"] < 1.5, f"{name}: E / floor {rec['E_vs_noise_floor']:.4f}")
    check(rec["E_rel_diff_vs_unsharded"] <= SHARDED_AFFINE_E_RTOL,
          f"{name}: E differs from the unsharded pipeline's by "
          f"{rec['E_rel_diff_vs_unsharded']:.3e}")
    gaps = rec["S_gap_vs_unsharded"], rec["R_gap_vs_unsharded"]
    check(max(gaps) <= SHARDED_AFFINE_CALIB_GAP,
          f"{name}: S and R {gaps[0]:.3e}, {gaps[1]:.3e} from the unsharded calibration's")
    check((rec["syrk_acc_launches"], rec["syrk_lower_launches"]) == (0, 0),
          f"{name}: a SYRK kernel launched")


def scenes_block(torch, mesh, n_scenes: int) -> dict:
    """5i's ``shard_scenes``: 4f's batch (``batched_scenes``, seed 11) drawn
    on the card and copied to the host; this rank's block of its scenes
    axis, on its card, against the same scenes of the drawn batch."""
    import torch.distributed as dist

    from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu_torch.parallel.batched import shard_scenes

    x = batched_scenes(torch, make_synthetic_scene, n_scenes, BATCH_VIEWS, seed=11)
    block = shard_scenes(x.cpu().numpy(), mesh)
    r, n = dist.get_rank(), block.shape[0]
    return {"scenes": n_scenes, "block": n, "device": str(block.device),
            "equal": block.is_cuda and bool(torch.equal(block, x[r * n:(r + 1) * n]))}


def sharded_cli_argv(rank_dir: str, dense_points: int) -> dict:
    """5j's commands (``--shard-points`` is added per run): ``euclidean``
    and ``affine`` at 5e's and 4h's 10k x 100 in float64, 4t's fisheye
    ``bal --chunk-size`` (5g's flags, the non-fused build with K1) on the
    COLMAP model 4t wrote into ``rank_dir``, and ``bal --sparse`` on 4w's
    BAL file of 4m's problem (its held run's flags, 5 iterations a
    segment) in float64."""
    synthetic = ["--n-points", str(dense_points), "--n-images", str(DENSE_VIEWS), "--float64"]
    return {
        "euclidean": ["euclidean"] + synthetic,
        "affine": ["affine"] + synthetic,
        "bal": ["bal", os.path.join(rank_dir, "fisheye_model"), "--chunk-size", str(CHUNK),
                "--optimize-distortion", "1", "--shared-k", "--covariance", "--max-iter", "10"],
        "bal_sparse": ["bal", os.path.join(rank_dir, "sparse.bal"), "--sparse", "--float64",
                       "--huber", str(HUBER_DELTA), "--optimize-distortion", "2", "--shared-k",
                       "--max-iter", "5"],
    }


def sharded_commands(torch, fs, sy, argvs: dict, n: int) -> dict:
    """Phase 5j on this rank: each command of ``argvs`` through ``cli.main``
    with ``--shard-points n`` in the process group the rank is in (the
    command joins it), its standard output captured: {name: (stdout, (K2,
    K1) launches, wall)}."""
    import contextlib
    import io

    from mvrecon_tpu_torch.cli import main as cli_main

    out = {}
    for name, argv in argvs.items():
        buf = io.StringIO()
        reset_launch_counts(fs, sy)
        start = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv + ["--shard-points", str(n)])
        out[name] = {"rc": rc, "stdout": buf.getvalue(), "launches": launch_counts(fs, sy),
                     "wall_s": time.perf_counter() - start}
    return out


def sparse_tight(torch, mesh, argv: list) -> dict:
    """5j's witness for ``bal --sparse``: the command's list, start and
    config (``argv`` read by the command's own parser) through
    ``sharded_bundle_adjust_sparse`` on ``mesh`` at
    ``SHARDED_SPARSE_TIGHT``'s cg_tol, where the summation order no longer
    moves CG's step: E, iterations, retries, CG count and wall."""
    from mvrecon_tpu_torch.cli import build_parser
    from mvrecon_tpu_torch.config import LMConfig
    from mvrecon_tpu_torch.parallel.sharded_ba_sparse import sharded_bundle_adjust_sparse
    from mvrecon_tpu_torch.runtime import io as tio

    a = build_parser().parse_args(argv)
    d = tio.load_bal_sparse(a.input)
    cfg = LMConfig(scale_factor=a.scale_factor, delta_tol=a.delta_tol, max_iter=a.max_iter,
                   damping=a.damping, robust=a.robust_loss, huber_delta=a.huber,
                   distortion_rounds=a.optimize_distortion, distortion_shared=a.shared_k)

    def f64(key):
        return torch.tensor(np.asarray(d[key]), dtype=torch.float64)

    start = time.perf_counter()
    res = sharded_bundle_adjust_sparse(
        mesh, d["point_idx"], d["cam_idx"], f64("xy"), f64("X"), f64("K"), f64("R"), f64("t"),
        f0=float(d["f0"]), axis="x-up_z-forward", config=cfg, distortion=f64("distortion"),
        **SHARDED_SPARSE_TIGHT)
    return {**SHARDED_SPARSE_TIGHT, "E": float(res.error), "n_iter": int(res.n_iter),
            "retries": int(res.log["n_solver_retries_total"]),
            "cg_iters_last_segment": int(res.log["cg_iters_total"]),
            "wall_s": time.perf_counter() - start}


def sharded_phases(torch, fs, sy, args, config, opencv_rec: dict, dense_rec: dict, pipe: dict,
                   dense_pipe: dict, sparse_rec: dict, bal_recs: dict, rank_dir: str) -> dict:
    """Phases 5a-5f and 5h-5k, point sharding (``parallel/sharded_ba.py``,
    ``sharded_covariance.py``, ``sharded_calibration.py``,
    ``pipelines.py``, ``sharded_ba_sparse.py``, ``sharded_affine.py``,
    ``batched.shard_scenes`` and the commands' ``--shard-points``) and the
    2D BA (``sharded_ba_2d.py``):

    5a. 4o's problem (rendered anew into host memory from its seed)
    through ``sharded_bundle_adjust_chunked`` under a one-rank NCCL group:
    the same retries and K1 launches as 4o's unsharded run, E within
    ``SHARDED_E_RTOL_ONE_RANK``;
    5b. the same problem on two ranks on the one card (gloo: NCCL takes one
    rank a card), each with half the points: 5a's retries, E within
    ``SHARDED_E_RTOL_TWO_RANKS`` of 5a's, X, K, R, t within
    ``SHARDED_X_ATOL`` and ``SHARDED_CAM_ATOL`` of 5a's, the ranks' results
    equal; K1 launches, all-reduce bytes and ms a retry, peak memory per
    rank;
    5c. 4c's problem through ``sharded_bundle_adjust`` on the NCCL rank (E
    within ``SHARDED_E_RTOL_ONE_RANK`` of 4c's) and on the two ranks
    (reported), and one ``sharded_lm_step`` against ``lm_step``;
    5f. ``sharded_ba_covariance`` of 5c's result against ``ba_covariance``
    in float64 and float32, at one rank and two (``check_sharded_covariance``);
    5e. ``sharded_euclidean_reconstruction`` on 4d's observations with 4c's
    schedule, at one rank and two: status 0, E / floor < 1.5, E within
    ``SHARDED_PIPELINE_E_RTOL`` of 4d's, no launch; the ranks equal;
    5d. ``euclidean_reconstruction_large(mesh=)`` on phase 4's scene and
    config, at one rank and two: status 0, E / floor < 1.5, E within
    ``SHARDED_LARGE_E_RTOL`` of phase 4's, K2 launches == retries x chunks
    on every rank (the BA runs whole on each), the ranks equal; the
    calibration's wall, its Gram all-reduce's bytes and ms and the peak
    memory beside phase 4's;
    5h. ``sharded_bundle_adjust_sparse`` on 4u's list (``rank_dir``'s
    sparse.npz) at one rank and two (``check_sharded_sparse``), the ranks
    equal; retries, CG iterations, wall, peak memory and all-reduce bytes
    and ms a retry and a CG iteration a rank;
    5i. ``sharded_affine_reconstruction`` on 4h's 10k x 100 scene at one
    rank and two (``check_sharded_affine``, against the unsharded
    pipeline run here), the ranks equal; ``shard_scenes`` of 4f's batch at
    one rank (every scene equal to 4f's) and two (each rank its half);
    5j. each command of ``sharded_cli_argv`` at one rank (here; 4t's 5g
    record for ``bal``) and at two (the ranks): rank 0's record with
    ``shard_points`` 2, status 0 where the command has one, E within
    ``SHARDED_CLI_E_RTOLS`` of the one-rank run's; rank 1 prints nothing;
    ``bal``'s K1 launches a positive multiple of its chunks on each rank,
    the others none.
    5k. the 2D BA (``sharded_ba_2d.py``): ``sharded_2d_one_rank`` here,
    ``sharded_2d_ranks`` on the two ranks, ``check_sharded_2d``.

    Returns the launches of K2 and K1 by phase."""
    import torch.distributed as dist

    from mvrecon_tpu_torch.config import LMConfig
    from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu_torch.models import bundle_adjustment as tba
    from mvrecon_tpu_torch.models.pipelines import affine_reconstruction
    from mvrecon_tpu_torch.parallel import sharded_ba as sba
    from mvrecon_tpu_torch.parallel.mesh import make_mesh
    from mvrecon_tpu_torch.runtime.distributed import free_port, initialize

    initialize(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        mesh = make_mesh({"points": 1})
        # 5a
        _, scene = north_star_scenes(torch, make_synthetic_scene, args.points)
        x_host, start, cfg = nonfused_problem_host(torch, tba, scene, config)
        del scene
        torch.cuda.empty_cache()
        rec_a, res_a = sharded_run(torch, fs, sy, sba.sharded_bundle_adjust_chunked, mesh,
                                   (x_host,) + start, config=cfg, chunk_size=CHUNK)
        n_points = x_host.shape[0]
        per_retry(rec_a, math.ceil(n_points / CHUNK))
        floor = n_points * VIEWS * 2 * NOISE**2
        rec_a.update(points=n_points, views=VIEWS, chunk=CHUNK, E_vs_noise_floor=(
            rec_a["reprojection_error"] / floor), unsharded_4o={key: opencv_rec[key] for key in (
                "wall_s", "retries", "retries_last_segment", "syrk_lower_launches",
                "reprojection_error", "E_vs_noise_floor")})
        rec_a["E_rel_diff_vs_4o"] = (abs(rec_a["reprojection_error"]
                                         - opencv_rec["reprojection_error"])
                                     / opencv_rec["reprojection_error"])
        state_a = [t.cpu().numpy() for t in (res_a.X, res_a.K, res_a.R, res_a.t)]
        del res_a, x_host
        torch.cuda.empty_cache()
        print("sharded_chunked_one_rank " + json.dumps(rec_a), flush=True)
        check(rec_a["finite"], "5a: an output is not finite")
        check(rec_a["syrk_lower_launches"] == opencv_rec["syrk_lower_launches"] > 0
              and rec_a["syrk_acc_launches"] == 0,
              f"5a: K1 launches {rec_a['syrk_lower_launches']} != 4o's "
              f"{opencv_rec['syrk_lower_launches']}, or K2 launched")
        check(rec_a["retries_last_segment"] == opencv_rec["retries_last_segment"],
              f"5a: retries {rec_a['retries_last_segment']} != 4o's "
              f"{opencv_rec['retries_last_segment']}")
        check(rec_a["E_rel_diff_vs_4o"] <= SHARDED_E_RTOL_ONE_RANK,
              f"5a: E differs from 4o's by {rec_a['E_rel_diff_vs_4o']:.3e}")

        # 5c, one rank
        d_start = dense_problem_host(torch, make_synthetic_scene, args.dense_points)
        d_cfg = dense_config(LMConfig)
        rec_c, res_c = sharded_run(torch, fs, sy, sba.sharded_bundle_adjust, mesh, d_start,
                                   config=d_cfg)
        rec_c["E_rel_diff_vs_4c"] = (abs(rec_c["reprojection_error"]
                                         - dense_rec["reprojection_error"])
                                     / dense_rec["reprojection_error"])
        rec_c["unsharded_4c"] = {key: dense_rec[key] for key in (
            "wall_s", "n_iter", "reprojection_error", "E_vs_noise_floor")}
        state_c = [a.cpu().numpy() for a in (res_c.X, res_c.K, res_c.R, res_c.t)]
        X_c = state_c[0]
        del res_c
        # one sharded_lm_step against lm_step, from 4c's normalized start
        x, vis, state, free, _ = tba._prepare_problem(*d_start, 1.0, None, "x-up_z-forward",
                                                      "cuda")
        c = torch.tensor(d_cfg.init_damping, device="cuda")
        new_s, e0_s, e1_s = sba.sharded_lm_step(mesh, d_start[0], state, vis, free, c)
        new_u, e0_u, e1_u = tba.lm_step(x, state, vis, free, 1.0, c)
        rec_c["lm_step"] = {
            "E_before": float(e0_s), "E_after": float(e1_s),
            "E_after_rel_diff": abs(float(e1_s) - float(e1_u)) / float(e1_u),
            "X_max_abs_diff": float((new_s.X - new_u.X).abs().max()),
        }
        del x, vis, state, new_s, new_u
        # 5f on 5c's result, 5e on 4d's observations, 5d on phase 4's scene
        cov_f = sharded_covariance(torch, mesh, d_start[0], state_c)
        rec_e, X_e = sharded_pipeline(torch, fs, sy, mesh, d_start[0].transpose(1, 0, 2), d_cfg)
        del d_start
        torch.cuda.empty_cache()
        _, scene = north_star_scenes(torch, make_synthetic_scene, args.points)
        rec_d, X_d = sharded_large(torch, fs, sy, mesh, scene, config)
        del scene
        torch.cuda.empty_cache()
        # 5h, 5i and 5j at one rank
        rec_h, X_h = sharded_sparse(torch, fs, sy, mesh, os.path.join(rank_dir, "sparse.npz"))
        torch.cuda.empty_cache()
        x_aff = affine_scene_host(torch, args.dense_points)
        reset_launch_counts(fs, sy)
        aff_u = affine_reconstruction(x_aff, torch.ones(DENSE_VIEWS, device="cuda"),
                                      config=affine_config())
        aff_u = {"status": aff_u.status, "ba_n_iter": aff_u.n_iter,
                 "reprojection_error": float(aff_u.error), "launches": launch_counts(fs, sy)}
        rec_i, X_i = sharded_affine(torch, fs, sy, mesh, x_aff)
        del x_aff
        rec_i["shard_scenes"] = scenes_block(torch, make_mesh({"scenes": 1}), args.batched_scenes)
        argvs = sharded_cli_argv(rank_dir, args.dense_points)
        one = sharded_commands(torch, fs, sy, {k: v for k, v in argvs.items() if k != "bal"}, 1)
        tight_one = sparse_tight(torch, mesh, argvs["bal_sparse"])
        one["bal"] = {"rc": 0, "stdout": json.dumps(bal_recs["fisheye_sharded"]["record"]),
                      "launches": (bal_recs["fisheye_sharded"]["syrk_acc_launches"],
                                   bal_recs["fisheye_sharded"]["syrk_lower_launches"]),
                      "wall_s": bal_recs["fisheye_sharded"]["wall_s"]}
        torch.cuda.empty_cache()
        # 5k at one rank: the 1D core, then the 2D core on a 1 x 1 mesh
        one_k, _ = sharded_2d_one_rank(torch, fs, sy, args.dense_points)
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # 5b-5k on two ranks, each a process
    t0 = time.perf_counter()
    ranks = launch_sharded_ranks(args, rank_dir)
    launcher_wall = time.perf_counter() - t0
    recs = [r["records"]["chunked"] for r in ranks]
    e_b = [r["reprojection_error"] for r in recs]
    rec_b = {
        "ranks": recs, "launcher_wall_s": launcher_wall,
        "transport": "gloo through the host, two ranks on one card",
        "E_rel_diff_vs_5a": abs(e_b[0] - rec_a["reprojection_error"]) / rec_a["reprojection_error"],
        "X_max_abs_diff_vs_5a": max_abs_diff(ranks[0]["chunked_X"], state_a[0]),
        "K_max_abs_diff_vs_5a": max_abs_diff(ranks[0]["chunked_K"], state_a[1]),
        "R_max_abs_diff_vs_5a": max_abs_diff(ranks[0]["chunked_R"], state_a[2]),
        "t_max_abs_diff_vs_5a": max_abs_diff(ranks[0]["chunked_t"], state_a[3]),
        "ranks_equal": all(np.array_equal(ranks[0][k], r[k]) for r in ranks[1:]
                           for k in ranks[0] if k != "records"),
        "syrk_lower_launches_per_rank": [r["syrk_lower_launches"] for r in recs],
        "allreduce_bytes_per_retry": [r["allreduce_bytes_per_retry"] for r in recs],
        "allreduce_ms_per_retry": [r["allreduce_ms_per_retry"] for r in recs],
        "peak_over_start_gb_per_rank": [r["peak_over_start_gb"] for r in recs],
        "limits": {"E_rtol": SHARDED_E_RTOL_TWO_RANKS, "X_atol": SHARDED_X_ATOL,
                   "K_R_t_atol": SHARDED_CAM_ATOL},
    }
    print("sharded_chunked_two_ranks " + json.dumps(rec_b), flush=True)
    check(all(r["finite"] for r in recs), "5b: an output is not finite")
    check(rec_b["ranks_equal"], "5b: the ranks returned different results")
    check(all(r["syrk_lower_launches"] == r["retries"] * r["chunks_per_rank"] > 0
              and r["syrk_acc_launches"] == 0 for r in recs),
          f"5b: K1 launches {rec_b['syrk_lower_launches_per_rank']} != retries x chunks")
    check(all(r["retries"] == rec_a["retries"]
              and r["retries_last_segment"] == rec_a["retries_last_segment"] for r in recs),
          f"5b: retries {[r['retries'] for r in recs]} != 5a's {rec_a['retries']}")
    check(rec_b["E_rel_diff_vs_5a"] <= SHARDED_E_RTOL_TWO_RANKS,
          f"5b: E differs from 5a's by {rec_b['E_rel_diff_vs_5a']:.3e}")
    check(rec_b["X_max_abs_diff_vs_5a"] <= SHARDED_X_ATOL
          and max(rec_b[f"{k}_max_abs_diff_vs_5a"] for k in "KRt") <= SHARDED_CAM_ATOL,
          "5b: X, K, R or t off 5a's beyond the limits")

    d_recs = [r["records"]["dense"] for r in ranks]
    rec_c["two_ranks"] = {
        "ranks": d_recs,
        "E_rel_diff_vs_4c": abs(d_recs[0]["reprojection_error"] - dense_rec["reprojection_error"])
        / dense_rec["reprojection_error"],
        "X_max_abs_diff_vs_one_rank": max_abs_diff(ranks[0]["dense_X"], X_c),
    }
    print("sharded_dense " + json.dumps(rec_c), flush=True)
    check(rec_c["finite"] and all(r["finite"] for r in d_recs), "5c: an output is not finite")
    check(rec_c["E_rel_diff_vs_4c"] <= SHARDED_E_RTOL_ONE_RANK,
          f"5c: E differs from 4c's by {rec_c['E_rel_diff_vs_4c']:.3e}")
    check(all(r["reprojection_error"] < dense_rec["start_E"] for r in d_recs),
          "5c: the two-rank E is not below the start")
    check(rec_c["lm_step"]["E_after_rel_diff"] <= SHARDED_E_RTOL_ONE_RANK,
          f"5c: sharded_lm_step's E differs by {rec_c['lm_step']['E_after_rel_diff']:.3e}")
    check((rec_c["syrk_acc_launches"], rec_c["syrk_lower_launches"]) == (0, 0)
          and all((r["syrk_acc_launches"], r["syrk_lower_launches"]) == (0, 0) for r in d_recs),
          "5c: the dense sharded core launched a SYRK kernel")

    rec_f = {"one_rank": cov_f, "two_ranks": [r["records"]["covariance"] for r in ranks],
             "rtol_float64": SHARDED_COV_RTOL, "float32_blocks_checked": False}
    print("sharded_covariance " + json.dumps(rec_f), flush=True)
    # F10: the float32 blocks are held only by their NaN pattern, n_obs and
    # sigma^2 until the float32 factor is repaired; their gap is shown
    gaps = {f"{label} {k}": r["float32"][f"{k}_rel_diff"]
            for label, r in [("one rank", cov_f)] + [(f"rank {i} of two", c) for i, c in
                                                     enumerate(rec_f["two_ranks"])]
            for k in ("point_cov", "camera_cov")}
    print("5f: float32 blocks not held against ba_covariance (F10); largest gap over the "
          "largest entry: " + json.dumps(gaps), flush=True)
    check_sharded_covariance(cov_f, "5f one rank")
    for i, r in enumerate(rec_f["two_ranks"]):
        check_sharded_covariance(r, f"5f rank {i} of two")

    e_recs = [r["records"]["pipeline"] for r in ranks]
    for r in [rec_e] + e_recs:
        check_sharded_pipeline(r, dense_pipe, f"5e ({r['ranks']} ranks)")
    rec_e["two_ranks"] = {"ranks": e_recs,
                          "X_max_abs_diff_vs_one_rank": max_abs_diff(ranks[0]["pipeline_X"], X_e)}
    rec_e["unsharded_4d"] = {key: dense_pipe[key] for key in (
        "wall_s", "stage_walls_s", "ba_n_iter", "reprojection_error", "E_vs_noise_floor")}
    rec_e["E_rtol"] = SHARDED_PIPELINE_E_RTOL
    print("sharded_pipeline " + json.dumps(rec_e), flush=True)

    d5_recs = [r["records"]["large"] for r in ranks]
    for r in [rec_d] + d5_recs:
        check_sharded_large(r, pipe, f"5d ({r['ranks']} ranks)")
    rec_d["two_ranks"] = {"ranks": d5_recs,
                          "X_max_abs_diff_vs_one_rank": max_abs_diff(ranks[0]["large_X"], X_d)}
    rec_d["phase_4"] = {key: pipe[key] for key in (
        "wall_s", "calibration_s", "ba_s", "ba_solver_retries", "syrk_acc_launches",
        "reprojection_error", "E_vs_noise_floor", "max_memory_allocated_gb")}
    rec_d["E_rtol"] = SHARDED_LARGE_E_RTOL
    print("sharded_large " + json.dumps(rec_d), flush=True)

    h_recs = [r["records"]["sparse"] for r in ranks]
    for r in [rec_h] + h_recs:
        check_sharded_sparse(r, sparse_rec, f"5h ({r['ranks']} ranks)")
    rec_h["two_ranks"] = {
        "ranks": h_recs, "ranks_equal": bool(np.array_equal(ranks[0]["sparse_X"],
                                                            ranks[1]["sparse_X"])),
        "X_max_abs_diff_vs_one_rank": max_abs_diff(ranks[0]["sparse_X"], X_h)}
    rec_h["unsharded_4u"] = {key: sparse_rec[key] for key in (
        "wall_s", "retries", "cg_iters_total", "weighted_E", "max_memory_allocated_gb",
        "aligned_rmse_vs_gt")}
    rec_h["unsharded_4u"]["matvec_ms_median"] = sparse_rec["spans"]["matvec"]["median_ms"]
    rec_h["E_rtol_two_ranks"] = SHARDED_SPARSE_E_RTOL
    print("sharded_sparse " + json.dumps(rec_h), flush=True)
    check(rec_h["two_ranks"]["ranks_equal"] and h_recs[0]["weighted_E"] == h_recs[1]["weighted_E"],
          "5h: the ranks returned different results")

    i_recs = [r["records"]["affine"] for r in ranks]
    for r in [rec_i] + i_recs:
        check_sharded_affine(r, aff_u["reprojection_error"], f"5i ({r['ranks']} ranks)")
    rec_i["two_ranks"] = {
        "ranks": i_recs, "ranks_equal": bool(np.array_equal(ranks[0]["affine_X"],
                                                            ranks[1]["affine_X"])),
        "X_max_abs_diff_vs_one_rank": max_abs_diff(ranks[0]["affine_X"], X_i)}
    rec_i["unsharded"] = aff_u
    rec_i["E_rtol"] = SHARDED_AFFINE_E_RTOL
    print("sharded_affine " + json.dumps(rec_i), flush=True)
    check(rec_i["two_ranks"]["ranks_equal"], "5i: the ranks returned different results")
    check(aff_u["status"] == 0 and aff_u["launches"] == (0, 0),
          f"5i: the unsharded affine pipeline: {aff_u}")
    blocks = [rec_i["shard_scenes"]] + [r["shard_scenes"] for r in i_recs]
    check(all(b["equal"] and b["block"] * b_n == b["scenes"]
              for b, b_n in zip(blocks, (1, SHARDED_RANKS, SHARDED_RANKS))),
          f"5i: shard_scenes blocks {blocks}")

    j_recs = [r["records"]["commands"] for r in ranks]
    rec_j = {}
    for name in argvs:
        unsh = json.loads(one[name]["stdout"].strip().splitlines()[-1])
        got = json.loads(j_recs[0][name]["stdout"].strip().splitlines()[-1])
        e_rel = abs(got["reprojection_error"] - unsh["reprojection_error"]) / abs(
            unsh["reprojection_error"])
        rec_j[name] = {"argv": argvs[name], "record_rank_0": got, "one_rank_record": unsh,
                       "E_rel_diff_vs_one_rank": e_rel, "E_rtol": SHARDED_CLI_E_RTOLS[name],
                       "walls_s": [r[name]["wall_s"] for r in j_recs],
                       "one_rank_wall_s": one[name]["wall_s"],
                       "launches_per_rank": [r[name]["launches"] for r in j_recs],
                       "one_rank_launches": one[name]["launches"],
                       "rank_1_stdout": j_recs[1][name]["stdout"]}
    tight = [r["records"]["sparse_tight"] for r in ranks]
    rec_j["bal_sparse"]["tight_cg_tol"] = {
        "one_rank": tight_one, "two_ranks": tight,
        "E_rel_diff_vs_one_rank": abs(tight[0]["E"] - tight_one["E"]) / tight_one["E"],
        "E_rtol": SHARDED_SPARSE_TIGHT_E_RTOL, "cg_rtol": SHARDED_SPARSE_TIGHT_CG_RTOL}
    print("sharded_commands " + json.dumps(rec_j), flush=True)
    for name, r in rec_j.items():
        got, unsh = r["record_rank_0"], r["one_rank_record"]
        check(got["shard_points"] == SHARDED_RANKS and unsh["shard_points"] == 1
              and all(rr[name]["rc"] == 0 for rr in j_recs),
              f"5j {name}: shard_points {got['shard_points']}, {unsh['shard_points']}")
        check(got.get("status", 0) == unsh.get("status", 0) == 0,
              f"5j {name}: status {got.get('status')}, one rank {unsh.get('status')}")
        check(r["E_rel_diff_vs_one_rank"] <= r["E_rtol"],
              f"5j {name}: E differs from the one-rank run's by {r['E_rel_diff_vs_one_rank']:.3e}")
        check(r["rank_1_stdout"] == "", f"5j {name}: rank 1 printed {r['rank_1_stdout']!r}")
    n_bal = rec_j["bal"]["record_rank_0"]["points"]
    bal_chunks = math.ceil(math.ceil(n_bal / SHARDED_RANKS) / CHUNK)
    check(all(k2 == 0 and k1 > 0 and k1 % bal_chunks == 0
              for k2, k1 in rec_j["bal"]["launches_per_rank"]),
          f"5j bal: launches (K2, K1) a rank {rec_j['bal']['launches_per_rank']}, not a positive "
          f"multiple of {bal_chunks} chunks of K1")
    check(all(tuple(launches) == (0, 0) for name, r in rec_j.items() if name != "bal"
              for launches in r["launches_per_rank"] + [r["one_rank_launches"]]),
          "5j: a command other than bal launched a SYRK kernel")
    t_rec = rec_j["bal_sparse"]["tight_cg_tol"]
    check(tight[0]["E"] == tight[1]["E"], "5j tight cg_tol: the ranks' E differ")
    check(t_rec["E_rel_diff_vs_one_rank"] <= SHARDED_SPARSE_TIGHT_E_RTOL,
          f"5j tight cg_tol: E differs from the one-rank run's by "
          f"{t_rec['E_rel_diff_vs_one_rank']:.3e}")
    check(all((r["n_iter"], r["retries"]) == (tight_one["n_iter"], tight_one["retries"])
              and abs(r["cg_iters_last_segment"] - tight_one["cg_iters_last_segment"])
              <= SHARDED_SPARSE_TIGHT_CG_RTOL * tight_one["cg_iters_last_segment"]
              for r in tight),
          f"5j tight cg_tol: iterations, retries or CG counts {tight} against {tight_one}")

    k_two = [r["records"]["sharded_2d"] for r in ranks]
    k_launches = check_sharded_2d(one_k, k_two, [
        {key: [r[f"2d.{key}.{n}"] for n in "XKRt"] for key in k_two[0]} for r in ranks])

    def launches_5hij(i: int) -> dict:
        key = ("syrk_acc_launches", "syrk_lower_launches")[i]
        return {"5h": rec_h[key], "5h_per_rank": [r[key] for r in h_recs],
                "5i": rec_i[key], "5i_per_rank": [r[key] for r in i_recs],
                "5j_per_rank": {name: [la[i] for la in r["launches_per_rank"]]
                                for name, r in rec_j.items()},
                "5k": k_launches[key]}

    return {
        "syrk_acc": {"5a": rec_a["syrk_acc_launches"],
                     "5b_per_rank": [r["syrk_acc_launches"] for r in recs],
                     "5c": rec_c["syrk_acc_launches"],
                     "5c_per_rank": [r["syrk_acc_launches"] for r in d_recs],
                     "5d": rec_d["syrk_acc_launches"],
                     "5d_per_rank": [r["syrk_acc_launches"] for r in d5_recs],
                     "5e": rec_e["syrk_acc_launches"],
                     "5e_per_rank": [r["syrk_acc_launches"] for r in e_recs],
                     **launches_5hij(0)},
        "syrk_lower": {"5a": rec_a["syrk_lower_launches"],
                       "5a_unsharded_4o": opencv_rec["syrk_lower_launches"],
                       "5b_per_rank": rec_b["syrk_lower_launches_per_rank"],
                       "5c": rec_c["syrk_lower_launches"],
                       "5c_per_rank": [r["syrk_lower_launches"] for r in d_recs],
                       "5d": rec_d["syrk_lower_launches"],
                       "5d_per_rank": [r["syrk_lower_launches"] for r in d5_recs],
                       "5e": rec_e["syrk_lower_launches"],
                       "5e_per_rank": [r["syrk_lower_launches"] for r in e_recs],
                       **launches_5hij(1)},
    }


def distorted_streamed(torch, sy, x_host, truth, start_cams, s_cfg, full: bool,
                       model: str = "radial", truth_k=RADIAL_TRUTH, seed: int = 33,
                       name: str = "distorted_streamed") -> dict:
    """Phase 4p: phase 4b's problem re-rendered through the shared BAL
    radial truth into the host observations in place, a chunk at a time
    through the card; ``bundle_adjust_streamed`` with one shared refit
    round from zero and 3 iterations a segment. Phase 4s runs it through
    the full OPENCV truth, whose refit streams the observations 8 times
    more. Returns the record."""
    from mvrecon_tpu_torch.models import bundle_adjustment as tba
    from mvrecon_tpu_torch.models.bundle_adjustment_streamed import bundle_adjust_streamed
    from mvrecon_tpu_torch.runtime.profiling import EventTimer

    npts, nf = x_host.shape[0], x_host.shape[1]
    dist = torch.tensor(truth_k, device="cuda").expand(nf, len(truth_k))
    s_max = render_all(torch, tba, truth, dist, torch.Generator(device="cuda").manual_seed(seed),
                       x_host, STREAMED_CHUNK, model=model)
    margin = check_monotone(name, truth_k, s_max, torch, tba,
                            None if model in ("radial", "opencv") else model)
    cfg = dataclasses.replace(s_cfg, max_iter=3, distortion_rounds=1, distortion_shared=True,
                              distortion_model=model)
    timer = EventTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sy.reset_launch_counts()
    t0 = time.perf_counter()
    res = bundle_adjust_streamed(x_host, *start_cams, axis="x-up_z-forward", config=cfg,
                                 chunk_size=STREAMED_CHUNK, prefetch=2, timer=timer)
    err = float(res.error)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_launches = sy.launch_counts["syrk_lower"]
    peak = torch.cuda.max_memory_allocated()
    spans = timer.ms()
    retries = res.log["n_solver_retries"]
    chunks = math.ceil(npts / STREAMED_CHUNK)
    rec = {
        "model": model, "points": npts, "views": nf, "chunk": STREAMED_CHUNK, "chunks": chunks,
        "iters_per_segment": cfg.max_iter, "rounds": cfg.distortion_rounds, "wall_s": wall,
        "n_iter": res.n_iter, "retries": retries, "pass1_ms": spans["pass1"],
        "pass2_ms": spans["pass2"], "syrk_lower_launches": k1_launches,
        "reprojection_error": err, "E_vs_noise_floor": err / (npts * nf * 2 * NOISE**2),
        "k": res.distortion[0].tolist(), "k_true": list(truth_k),
        "k_max_abs_err": k_error(res, truth_k),
        "k1_abs_err": abs(float(res.distortion[0, 0]) - truth_k[0]),
        "model_rms_rel_err": model_error(torch, tba, truth, res.distortion, dist, model=model),
        "monotone_margin": margin, "s_max": s_max,
        "finite": math.isfinite(err) and finite(torch, res.X, res.K, res.R, res.t),
        "max_memory_allocated_gb": peak / 1e9, "observations_gb": x_host.nbytes / 1e9,
    }
    del res
    print(f"{name} " + json.dumps(rec), flush=True)
    check(rec["finite"], f"{name}: an output is not finite")
    check(k1_launches == retries * chunks > 0,
          f"{name}: syrk_lower launches {k1_launches} != retries {retries} x chunks {chunks}")
    check(rec["E_vs_noise_floor"] < 1.5, f"{name}: E / floor {rec['E_vs_noise_floor']:.4f}")
    check(rec["model_rms_rel_err"] < MODEL_TOL,
          f"{name}: the recovered model's displacement is off by "
          f"{rec['model_rms_rel_err']:.4f} of the true one's (limit {MODEL_TOL})")
    if full:
        check(peak < x_host.nbytes, f"{name} peak device memory {peak / 1e9:.2f} GB "
              f"is not below the observations' {x_host.nbytes / 1e9:.2f} GB")
    return rec


def bal_on_card(torch, fs, sy, bal_points: int, rank_dir: str) -> dict:
    """Phase 4t: the ``bal`` subcommand in process, on the card, on COLMAP
    models that the port's ``save_colmap`` writes (binary) into a temporary
    directory: 4m's scene (20k points x 100 views, each point seen by 20
    consecutive views), rendered through the shared OPENCV_FISHEYE, FOV and
    THIN_PRISM_FISHEYE truths with ``NOISE``, X and t perturbed by
    0.02 N(0, 1). ``bal --chunk-size 768 --optimize-distortion 1
    --shared-k --covariance --output-colmap-pinhole --max-iter 10``
    (float32; the model tied across the images, as one physical camera
    takes them: a per-image fisheye refit on 4k rays leaves k3 and k4 in
    the thousands, and the undistortion of such a map diverges): its
    record must name the model, count the problem,
    and reach E / floor < 1.5 with sigma within 5 % of the true one; K1
    launches and K2 does not; the SIMPLE_PINHOLE model it wrote, reloaded,
    has a pinhole error at the refined state below twice the modelled E
    (the JAX package's ``test_cli_bal_output_colmap_pinhole`` bound).
    Returns the records by model."""
    import contextlib
    import io
    import os
    import tempfile

    from mvrecon_tpu_torch.__main__ import main as cli_main
    from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu_torch.models import bundle_adjustment as tba
    from mvrecon_tpu_torch.runtime import io as tio

    gen = torch.Generator(device="cuda").manual_seed(36)
    scene = make_synthetic_scene(gen, n_images=DENSE_VIEWS, n_slices=bal_points // 20,
                                 n_angles=20, dtype=torch.float32)
    truth = true_state(tba, scene)
    npts, nf = scene.X.shape[0], DENSE_VIEWS
    centers = torch.randint(0, nf, (npts,), generator=gen, device="cuda")
    lo = (centers - BAL_WINDOW // 2).clamp(0, nf - BAL_WINDOW)
    cams = torch.arange(nf, device="cuda")
    vis = ((cams[None] >= lo[:, None]) & (cams[None] < lo[:, None] + BAL_WINDOW)).float()
    vis_host = vis.cpu().numpy()
    X0, K, R, t0 = perturbed_cameras(scene, seed=36)
    n_obs = int(vis_host.sum())
    floor = n_obs * 2 * NOISE**2
    recs = {}
    for model in ("fisheye", "fov", "thin_prism"):
        k = FAMILY_TRUTHS[model]
        dist = torch.tensor(k, device="cuda").expand(nf, len(k))
        x = torch.empty((npts, nf, 2), device="cuda")
        s_max = render_all(torch, tba, truth, dist, gen, x, model=model)
        margin = check_monotone(f"bal {model}", k, s_max, torch, tba, model)
        x_host = x.transpose(0, 1).cpu().numpy()
        del x
        with tempfile.TemporaryDirectory() as tmp:
            t_w = time.perf_counter()
            tio.save_colmap(os.path.join(tmp, "model"), x_host, vis_host, X0, R, t0, K[:, 0, 0],
                            principal_point=K[:, :2, 2], distortion=dist.cpu().numpy(),
                            distortion_model=None if model == "fov" else model, binary=True)
            write_s = time.perf_counter() - t_w
            pin = os.path.join(tmp, "pinhole")
            out = io.StringIO()
            reset_launch_counts(fs, sy)
            t_b = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli_main(["bal", os.path.join(tmp, "model"), "--chunk-size", str(CHUNK),
                               "--optimize-distortion", "1", "--shared-k", "--covariance",
                               "--max-iter", "10", "--output-colmap-pinhole", pin])
            wall = time.perf_counter() - t_b
            launches = launch_counts(fs, sy)
            rec = json.loads(out.getvalue().strip().splitlines()[-1])
            d = tio.load_colmap(pin)
        f_p, u_p = tba.intrinsics_from_K(torch.as_tensor(d["K"], device="cuda").float(), 1.0)
        st = tba.BAState(X=torch.as_tensor(d["X"], device="cuda").float(), f=f_p, u=u_p,
                         t=torch.as_tensor(d["t"], device="cuda").float(),
                         R=torch.as_tensor(d["R"], device="cuda").float())
        e_pin = float(tba._state_error(
            st, torch.as_tensor(d["x"].transpose(1, 0, 2), device="cuda").float(),
            torch.as_tensor(d["visibility"], device="cuda").float(), 1.0))
        e_model = rec["reprojection_error"]
        recs[model] = {
            "points": npts, "views": nf, "observations": n_obs, "chunk": CHUNK, "rc": rc,
            "write_s": write_s, "wall_s": wall, "record": rec,
            "E_vs_noise_floor": e_model / floor, "sigma_vs_true": rec["sigma"] / NOISE,
            "pinhole_distortion_zero": not d["distortion"].any(),
            "pinhole_E": e_pin, "pinhole_E_vs_model_E": e_pin / e_model,
            "syrk_acc_launches": launches[0], "syrk_lower_launches": launches[1],
            "monotone_margin": margin, "s_max": s_max,
        }
        print(f"bal_{model} " + json.dumps(recs[model]), flush=True)
        r = recs[model]
        check(rc == 0 and rec["format"] == "colmap" and rec["camera_model"] == model,
              f"bal {model}: rc {rc}, record {rec}")
        check((rec["cams"], rec["points"], rec["observations"]) == (nf, npts, n_obs),
              f"bal {model}: the record counts {rec['cams']}, {rec['points']}, "
              f"{rec['observations']}")
        check(rec["device"] == torch.cuda.get_device_name(0), f"bal {model} ran on {rec['device']}")
        check(math.isfinite(e_model) and r["E_vs_noise_floor"] < 1.5,
              f"bal {model}: E / floor {r['E_vs_noise_floor']:.4f}")
        check(abs(r["sigma_vs_true"] - 1.0) < 0.05,
              f"bal {model}: sigma {rec['sigma']:.6g} against the true {NOISE}")
        check(launches[1] > 0 and launches[0] == 0,
              f"bal {model}: launches (K2, K1) {launches}, not the non-fused build's")
        check(r["pinhole_distortion_zero"] and e_pin < 2.0 * e_model,
              f"bal {model}: the pinhole model's E {e_pin:.6g} against the modelled {e_model:.6g}")
        if model == "fisheye":
            # 5g: the same command with --shard-points 1, the sharded chunked
            # core (the non-fused build, K1, as unsharded for this family), on
            # the model that 5j's two ranks read too
            path = os.path.join(rank_dir, "fisheye_model")
            tio.save_colmap(path, x_host, vis_host, X0, R, t0, K[:, 0, 0],
                            principal_point=K[:, :2, 2], distortion=dist.cpu().numpy(),
                            distortion_model=model, binary=True)
            recs[f"{model}_sharded"] = sharded_command(
                torch, fs, sy, ["bal", path, "--chunk-size", str(CHUNK), "--optimize-distortion",
                                "1", "--shared-k", "--covariance", "--max-iter", "10"], rec,
                launches, "bal")
            chunks = math.ceil(npts / CHUNK)
            k1 = recs[f"{model}_sharded"]["syrk_lower_launches"]
            check(k1 > 0 and k1 % chunks == 0,
                  f"5g bal: K1 launches {k1} are not retries x {chunks} chunks")
    return recs


def distortion_gpu_vs_cpu(torch, fs, sy) -> None:
    """Phase 5, distortion: a small problem (8 views x 80 points) rendered
    through the shared truth of each of the six families, through the
    dense core, the chunked core (the fused build for radial, the
    non-fused one for every other family) and the streamed core, each with
    one shared refit round from ``default_distortion`` and one iteration a
    segment, card against CPU, to ``DISTORTION_RTOLS``."""
    from mvrecon_tpu_torch.config import LMConfig
    from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu_torch.models import bundle_adjustment as tba
    from mvrecon_tpu_torch.models.bundle_adjustment_chunked import bundle_adjust_chunked
    from mvrecon_tpu_torch.models.bundle_adjustment_streamed import bundle_adjust_streamed

    gen = torch.Generator().manual_seed(34)
    sc = make_synthetic_scene(gen, n_images=8, n_slices=4, n_angles=20, dtype=torch.float32)
    truth = true_state(tba, sc)
    cams = perturbed_cameras(sc, seed=34)
    rec = {}
    for model, k in (("radial", RADIAL_TRUTH), ("opencv", OPENCV_TRUTH), *FAMILY_TRUTHS.items()):
        dist = torch.tensor(k).expand(8, len(k))
        x = render_distorted(torch, tba, truth, dist, gen, 0, sc.X.shape[0], model)[0].numpy()
        cfg = LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=1, distortion_rounds=1,
                       distortion_shared=True, distortion_model=model, record_log=True)
        kw = dict(axis="x-up_z-forward", config=cfg)
        cores = {
            "dense": lambda dev: tba.bundle_adjust(x, *cams, device=dev, **kw),
            "chunked": lambda dev: bundle_adjust_chunked(x, *cams, chunk_size=32, device=dev,
                                                         **kw),
            "streamed": lambda dev: bundle_adjust_streamed(x, *cams, chunk_size=32, device=dev,
                                                           **kw),
        }
        for core, run in cores.items():
            reset_launch_counts(fs, sy)
            r_g = run("cuda")
            launches = launch_counts(fs, sy)
            r_c = run("cpu")
            e_g, e_c = float(r_g.error), float(r_c.error)
            rec[f"{model}_{core}"] = {
                "n_iter_gpu": r_g.n_iter, "n_iter_cpu": r_c.n_iter, "E_gpu": e_g, "E_cpu": e_c,
                "E_rel_diff": abs(e_g - e_c) / e_c, "rtol": DISTORTION_RTOLS[model],
                "k_gpu": r_g.distortion[0].tolist(), "k_cpu": r_c.distortion[0].tolist(),
                "k_max_abs_diff": float((r_g.distortion.cpu() - r_c.distortion).abs().max()),
                "launches_gpu": launches,
            }
    print("distortion_gpu_vs_cpu " + json.dumps(rec), flush=True)
    for name, r in rec.items():
        check(r["n_iter_gpu"] == r["n_iter_cpu"], f"distortion {name}: iterations differ")
        check(r["E_rel_diff"] < r["rtol"],
              f"distortion {name}: E differs by {r['E_rel_diff']:.3e} (limit {r['rtol']})")
    k2, k1 = rec["radial_chunked"]["launches_gpu"]
    check(k2 > 0 and k1 == 0, f"radial chunked on the card: launches (K2, K1) {(k2, k1)}")
    for model in ("radial", "opencv", *FAMILY_TRUTHS):
        check(rec[f"{model}_dense"]["launches_gpu"] == (0, 0),
              f"distortion {model} dense launched a kernel")
        check(rec[f"{model}_streamed"]["launches_gpu"][1] > 0,
              f"{model} streamed on the card did not launch syrk_lower")
        if model != "radial":
            k2, k1 = rec[f"{model}_chunked"]["launches_gpu"]
            check(k1 > 0 and k2 == 0, f"{model} chunked on the card: launches (K2, K1) "
                  f"{(k2, k1)}")


SPARSE_CAMS = 1600  # bench.py::bench_bal_large: 1M points x 1,600 cameras ...
SPARSE_WINDOW = 10  # ... each point seen by 10 consecutive cameras: 10M observations
SPARSE_OUTLIER_SHARE = 0.02  # 2 % of the observations moved by 0.5 N(0, 1)
SPARSE_START_SIGMA = 0.05  # X and t perturbed by 0.05 N(0, 1)
SPARSE_CG_MAX = 40
SPARSE_LEVER_ITERS = 3  # 4v: iterations of the stored, recompute and bfloat16 runs
SPARSE_RECOMPUTE_RTOL = 1e-4  # 4v: recompute against stored E (the same operator)


def sparse_config(max_iter: int = 12):
    """4u's LM configuration (``bench.py::bench_bal_large``'s, 12
    iterations)."""
    from mvrecon_tpu_torch.config import LMConfig

    return LMConfig(scale_factor=4.0, delta_tol=1e-4, max_iter=max_iter, accept_divisor=1.0,
                    init_damping=3e-3, damping="nielsen", robust="huber",
                    huber_delta=HUBER_DELTA)


def sparse_problem(torch, n_points: int, seed: int = 0):
    """``scripts/bench_sparse_capacity.py::generate`` on the card from a
    ``torch.Generator``: ``SPARSE_CAMS`` hemisphere cameras at radius 5
    looking at 0.5 N(0, 1) targets, f = 1, the curved tube (n_points // 20
    slices x 20 angles), each point seen by ``SPARSE_WINDOW`` consecutive
    cameras from a random start, sigma noise, 2 % of the observations moved
    by 0.5 N(0, 1), X and t perturbed by 0.05 N(0, 1). Returns (obs, X_gt,
    X0, K, R, t0, inlier mask)."""
    from mvrecon_tpu_torch.geometry.camera import intrinsics, look_at
    from mvrecon_tpu_torch.geometry.scenes import curved_tube_points, sample_hemisphere_points
    from mvrecon_tpu_torch.models.bundle_adjustment_sparse import SparseObs

    gen = torch.Generator(device="cuda").manual_seed(seed)
    nf, win = SPARSE_CAMS, SPARSE_WINDOW
    pos = sample_hemisphere_points(gen, nf, 5.0)
    R, t = look_at(pos, 0.5 * torch.randn(nf, 3, generator=gen, device="cuda"))
    K = intrinsics(torch.ones(nf, device="cuda"), 1.0)
    X = curved_tube_points(n_points // 20, 20, device="cuda")
    npts = X.shape[0]
    lo = torch.randint(0, nf - win + 1, (npts,), generator=gen, device="cuda",
                       dtype=torch.int32)
    pi = torch.arange(npts, device="cuda", dtype=torch.int32).repeat_interleave(win)
    ci = (lo[:, None] + torch.arange(win, device="cuda", dtype=torch.int32)).reshape(-1)
    xy = sparse_project(torch, X, K, R, t, pi, ci)
    n_obs = pi.shape[0]
    xy += NOISE * torch.randn((2, n_obs), generator=gen, device="cuda")
    outlier = torch.rand(n_obs, generator=gen, device="cuda") < SPARSE_OUTLIER_SHARE
    xy += torch.where(outlier, 0.5 * torch.randn((2, n_obs), generator=gen, device="cuda"), 0.0)
    obs = SparseObs(pi, ci, xy, torch.ones(n_obs, device="cuda"))
    X0 = X + SPARSE_START_SIGMA * torch.randn(X.shape, generator=gen, device="cuda")
    t0 = t + SPARSE_START_SIGMA * torch.randn(t.shape, generator=gen, device="cuda")
    return obs, X, X0, K, R, t0, ~outlier


def sparse_project(torch, X, K, R, t, pi, ci, chunk: int = 1 << 22):
    """(2, N) projections of the points ``pi`` through the cameras ``ci``."""
    from mvrecon_tpu_torch.geometry.camera import camera_matrix

    pm = camera_matrix(K, R, t).reshape(-1, 12).T.contiguous()
    Xt = X.T.contiguous()
    out = torch.empty((2, pi.shape[0]), dtype=X.dtype, device=X.device)
    for s in range(0, pi.shape[0], chunk):
        g = pm.index_select(1, ci[s:s + chunk]).view(3, 4, -1)
        pqr = (g[:, :3] * Xt.index_select(1, pi[s:s + chunk])[None]).sum(1) + g[:, 3]
        out[:, s:s + chunk] = pqr[:2] / pqr[2]
    return out


def sparse_inlier_error(torch, res, obs, inlier) -> tuple[float, int]:
    """E over the untouched observations at the result's state."""
    xy = sparse_project(torch, res.X, res.K, res.R, res.t, obs.point_idx, obs.cam_idx)
    e = (((xy - obs.xy) ** 2).sum(0) * inlier).sum()
    return float(e), int(inlier.sum())


def sparse_run(torch, fs, sy, obs, start, config, **kw):
    """One ``bundle_adjust_sparse`` run on the card from the (X0, K, R, t0)
    ``start``: (result, wall s ending in a sync, peak bytes, (K2, K1)
    launches, spans)."""
    from mvrecon_tpu_torch.models.bundle_adjustment_sparse import bundle_adjust_sparse
    from mvrecon_tpu_torch.runtime.profiling import EventTimer

    timer = EventTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(fs, sy)
    t0 = time.perf_counter()
    res = bundle_adjust_sparse(obs, *start, axis="x-up_z-forward", config=config,
                               timer=timer, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (res, wall, torch.cuda.max_memory_allocated(), launch_counts(fs, sy),
            timer.ms())


def span_summary(spans: dict) -> dict:
    return {k: {"count": len(v), "total_ms": sum(v), "median_ms": statistics.median(v)}
            for k, v in spans.items()}


def sparse_full_width(torch, fs, sy, n_points: int):
    """Phase 4u: ``bench_bal_large``'s problem (``sparse_problem``) through
    ``bundle_adjust_sparse`` at full width, stored float32 factors, Huber
    0.02, 12 Nielsen iterations, ``cg_tol=1e-2``, ``cg_max_iter=40``, twice:
    the second run must repeat E, iterations, retries and CG iterations
    exactly; the inlier E/floor below 1.5, the aligned RMSE below 0.05,
    the peak device memory below the 12.8 GB that the dense (P, F, 2)
    observations would take, and no K1 or K2 launch. Returns (problem,
    record)."""
    from mvrecon_tpu_torch.ops.procrustes import aligned_rmse

    t_gen = time.perf_counter()
    obs, X_gt, X0, K, R, t0, inlier = sparse_problem(torch, n_points)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t_gen
    npts, n_obs = X_gt.shape[0], obs.n_obs
    dense_bytes = npts * SPARSE_CAMS * 2 * 4
    cfg = sparse_config()
    kw = dict(cg_tol=1e-2, cg_max_iter=SPARSE_CG_MAX)
    runs = [sparse_run(torch, fs, sy, obs, (X0, K, R, t0), cfg, **kw) for _ in range(2)]
    res, wall, peak, launches, spans = runs[0]
    e_in, n_in = sparse_inlier_error(torch, res, obs, inlier)
    keys = [(float(r.error), r.n_iter, r.log["n_solver_retries"], r.log["cg_iters_total"])
            for r, *_ in runs]
    rec = {
        "points": npts, "cams": SPARSE_CAMS, "observations": n_obs,
        "fill": n_obs / (npts * SPARSE_CAMS), "generate_s": gen_s,
        "wall_s": [r[1] for r in runs], "n_iter": res.n_iter,
        "retries": res.log["n_solver_retries"], "cg_iters_total": res.log["cg_iters_total"],
        "converged": res.log["converged"], "weighted_E": float(res.error),
        "inlier_E": e_in, "inlier_E_vs_noise_floor": e_in / (n_in * 2 * NOISE**2),
        "aligned_rmse_vs_gt": float(aligned_rmse(res.X, X_gt)),
        "aligned_rmse_tpu_reference": 0.02677,
        "max_memory_allocated_gb": peak / 1e9, "dense_observations_gb": dense_bytes / 1e9,
        "repeats_exactly": keys[0] == keys[1], "second_run": keys[1],
        "spans": span_summary(spans), "spans_second_run": span_summary(runs[1][4]),
        "syrk_acc_launches": [r[3][0] for r in runs],
        "syrk_lower_launches": [r[3][1] for r in runs],
        "finite": math.isfinite(float(res.error)) and finite(torch, res.X, res.K, res.R, res.t),
    }
    if n_points < 1_000_000:
        print(f"sparse BA cut to {npts} points x {SPARSE_CAMS} cameras by arguments")
    print("sparse_full_width " + json.dumps(rec), flush=True)
    check(rec["finite"], "sparse BA: an output is not finite")
    check(rec["repeats_exactly"], f"sparse BA does not repeat: {keys}")
    check(all(r[3] == (0, 0) for r in runs), "sparse BA launched a SYRK kernel")
    check(rec["inlier_E_vs_noise_floor"] < 1.5,
          f"sparse BA inlier E / floor {rec['inlier_E_vs_noise_floor']:.4f}")
    check(rec["aligned_rmse_vs_gt"] < 0.05,
          f"sparse BA aligned RMSE {rec['aligned_rmse_vs_gt']:.5f}")
    if n_points >= 1_000_000:
        check(peak < dense_bytes, f"sparse BA peak {peak / 1e9:.2f} GB is not below the dense "
              f"observations' {dense_bytes / 1e9:.2f} GB")
    return (obs, X_gt, X0, K, R, t0, inlier), rec


def sparse_levers(torch, fs, sy, prob) -> dict:
    """Phase 4v: 4u's problem for ``SPARSE_LEVER_ITERS`` iterations with
    stored float32 factors, with ``factor_mode="recompute"`` (``matvec_chunk``
    2^20), whose E must agree with the stored run's within
    ``SPARSE_RECOMPUTE_RTOL``, and with ``factor_dtype="bfloat16"``, whose E
    must be finite and below the start E; each run's peak device memory,
    and no K1 or K2 launch."""
    obs, _, X0, K, R, t0, _ = prob
    cfg = dataclasses.replace(sparse_config(SPARSE_LEVER_ITERS), record_log=True)
    kw = dict(cg_tol=1e-2, cg_max_iter=SPARSE_CG_MAX)
    recs = {}
    for name, extra in (("stored", {}),
                        ("recompute", dict(factor_mode="recompute", matvec_chunk=1 << 20)),
                        ("bfloat16", dict(factor_dtype="bfloat16"))):
        res, wall, peak, launches, spans = sparse_run(torch, fs, sy, obs, (X0, K, R, t0), cfg,
                                                      **kw, **extra)
        recs[name] = {
            "wall_s": wall, "n_iter": res.n_iter, "retries": res.log["n_solver_retries"],
            "cg_iters_total": res.log["cg_iters_total"], "weighted_E": float(res.error),
            "start_E": float(res.log["reprojection_error"][0]),
            "max_memory_allocated_gb": peak / 1e9, "spans": span_summary(spans),
            "syrk_acc_launches": launches[0], "syrk_lower_launches": launches[1],
        }
    e_s, e_r = recs["stored"]["weighted_E"], recs["recompute"]["weighted_E"]
    recs["recompute_E_rel_diff"] = abs(e_r - e_s) / e_s
    recs["recompute_rtol"] = SPARSE_RECOMPUTE_RTOL
    print("sparse_levers " + json.dumps(recs), flush=True)
    for name in ("stored", "recompute", "bfloat16"):
        check((recs[name]["syrk_acc_launches"], recs[name]["syrk_lower_launches"]) == (0, 0),
              f"sparse {name} launched a SYRK kernel")
    check(recs["recompute_E_rel_diff"] < SPARSE_RECOMPUTE_RTOL,
          f"sparse recompute E differs from stored by {recs['recompute_E_rel_diff']:.3e}")
    b = recs["bfloat16"]
    check(math.isfinite(b["weighted_E"]) and b["weighted_E"] < b["start_E"],
          f"sparse bfloat16 E {b['weighted_E']:.6g} against its start {b['start_E']:.6g}")
    return recs


SPARSE_SEGMENT_ITERS = 3  # 4w: the resumable driver's segments ...
SPARSE_RESUME_ITERS = 12  # ... against one continuous run of 12 iterations
# 4w: segmented against continuous, in float64 from rotations made
# orthonormal in float64. Each segment boundary restores the gauge and
# normalizes it again, the identity only where camera 0's rotation is
# orthonormal in the working dtype: float32 rotations taken into float64
# are so only to 1e-8, and the segments then parted by E 7.0e-9, X 1.2e-4
# and c 2.0e-3 of its value (CPU rehearsal, 4k points, cg_tol 1e-10; in
# float32, where an ulp at each boundary grows along the trajectory, E
# 1.4e-6, X 9.6e-3, c 0.88 at 20k points). From float64-orthonormal ones,
# at 4k points and cg_tol 1e-2: E 2.7e-13, X 2.3e-11, c 1.3e-9; the
# limits are about a thousand times that
SPARSE_RESUME_E_RTOL = 1e-10
SPARSE_RESUME_X_ATOL = 1e-8
SPARSE_RESUME_C_RTOL = 1e-6
# phase 5: the sparse core, card against CPU, float32, E after each of two
# iterations. The CPU against itself at other chunk sizes (other summation
# orders) parts by up to 8e-5 at the default cg_tol 1e-2, where CG stops
# early and a changed count changes the step, and by up to 3.4e-6 at
# cg_tol 1e-6, which phase 5 uses: a sixth of the earlier phases' limit.
# The fisheye case parts by 5.1e-5 there and takes its family's limit in
# ``DISTORTION_RTOLS`` (scripts/distortion_float32_noise.py)
SPARSE_GPU_CPU_CG_TOL = 1e-6
SPARSE_GPU_CPU_RTOL = EARLY_ITER_RTOL
SPARSE_DENSE_RTOL = 1e-8  # phase 5: sparse against dense in float64 at cg_tol 1e-10


def bal_sparse_in_process(torch, fs, sy, bal_points: int, argv: list, truth_k=RADIAL_TRUTH,
                          robust: bool = True, keep: str | None = None) -> dict:
    """One ``bal --sparse`` run in process on the card, on a BAL file that
    ``save_bal_sparse`` writes from 4m's scene (rendered through the shared
    radial ``truth_k``, with 4m's outliers when ``robust``; the file's
    points are 4m's 0.05-perturbed start, its distortion zero), with the
    extra flags ``argv`` and ``--output-ply``/``--output-bal``. The BAL file
    has no principal point, so the inlier E/floor is taken at the state the
    command computed (its ``bundle_adjust_sparse`` result) and the outputs
    are read back for their counts; ``keep`` is where a copy of the BAL
    file stays. Returns the record."""
    import contextlib
    import io
    import os
    import tempfile

    from mvrecon_tpu_torch.__main__ import main as cli_main
    from mvrecon_tpu_torch.models import bundle_adjustment as tba
    from mvrecon_tpu_torch.models import bundle_adjustment_sparse as tbs
    from mvrecon_tpu_torch.runtime import io as tio

    scene, _, _, x, vis, inlier, n_out, _, _ = bal_problem(torch, bal_points, truth_k=truth_k,
                                                           robust=robust, name="bal_sparse")
    npts, nf = scene.X.shape[0], DENSE_VIEWS
    X0, K, R, t0 = perturbed_cameras(scene, seed=30, sigma=SPARSE_START_SIGMA)
    pi, ci = vis.nonzero(as_tuple=True)  # row-major: sorted by point
    n_obs = pi.shape[0]
    rec = {"points": npts, "views": nf, "observations": n_obs, "outliers": n_out,
           "truth_k": list(truth_k), "argv": argv}
    results = []
    run = tbs.bundle_adjust_sparse

    def keep_result(*a, **kw):
        results.append(run(*a, **kw))
        return results[-1]

    with tempfile.TemporaryDirectory() as tmp:
        path, ply, out_bal = (os.path.join(tmp, n) for n in ("in.bal", "out.ply", "out.bal"))
        t_w = time.perf_counter()
        tio.save_bal_sparse(path, pi.cpu().numpy(), ci.cpu().numpy(), x[pi, ci].cpu().numpy(),
                            npts, X0, R, t0, K[:, 0, 0], distortion=np.zeros((nf, 2)))
        rec["write_s"] = time.perf_counter() - t_w
        if keep:
            shutil.copyfile(path, keep)
        out = io.StringIO()
        reset_launch_counts(fs, sy)
        tbs.bundle_adjust_sparse = keep_result
        try:
            t_b = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli_main(["bal", path, "--sparse"] + argv + ["--output-ply", ply,
                                                                  "--output-bal", out_bal])
            rec["wall_s"] = time.perf_counter() - t_b
        finally:
            tbs.bundle_adjust_sparse = run
        rec["rc"], rec["launches"] = rc, launch_counts(fs, sy)
        rec["record"] = json.loads(out.getvalue().strip().splitlines()[-1])
        d = tio.load_bal_sparse(out_bal)
        with open(ply, "rb") as fh:
            head = fh.read(4096).decode("ascii", "replace")
    vertex = [ln for ln in head.splitlines() if ln.startswith("element vertex")]
    rec["ply_vertices"] = int(vertex[0].split()[-1]) if vertex else -1
    rec["bal_read_back"] = (int(d["n_points"]), int(d["n_cameras"]), int(d["point_idx"].size))
    e_in, n_in = distorted_inlier_error(torch, tba, results[-1], x, inlier, 4096)
    rec["inlier_E_vs_noise_floor"] = e_in / (n_in * 2 * NOISE**2)
    log = results[-1].log
    rec["last_segment"] = {"retries": log["n_solver_retries"], "converged": log["converged"],
                           "retries_total": log["n_solver_retries_total"]}
    r = rec["record"]
    check(rc == 0 and r["sparse"] and r["observations"] == n_obs
          and (r["cams"], r["points"]) == (nf, npts)
          and r.get("triangulate_init", False) == ("--triangulate-init" in argv),
          f"bal --sparse record {r}")
    check(r["device"] == torch.cuda.get_device_name(0), f"bal --sparse ran on {r['device']}")
    check(rec["ply_vertices"] == npts + nf and rec["bal_read_back"] == (npts, nf, n_obs),
          f"bal --sparse outputs: {rec['ply_vertices']} vertices, {rec['bal_read_back']}")
    check(rec["launches"] == (0, 0), "bal --sparse launched a SYRK kernel")
    return rec


def sparse_entry_points(torch, fs, sy, bal_points: int, rank_dir: str) -> dict:
    """Phase 4w: the sparse entry points on 4m's problem (20k points x 100
    views, 400k observations) as an observation list
    (``bal_sparse_in_process``). ``bal --sparse --huber 0.02
    --optimize-distortion 2 --shared-k`` on 4m's problem (the radial truth,
    2 % outliers, two tied refit rounds from zero, as 4m) and ``bal --sparse
    --triangulate-init --huber 0.02`` on its scene rendered without
    distortion or outliers: inlier E/floor below 1.5 each. ``bal --sparse
    --triangulate-init --huber 0.02 --optimize-distortion 1`` on 4m's
    problem is run and reported, not held: a DLT start that ignores the
    k1 = -0.3 model and 2 % gross outliers, and one per-camera refit from
    zero, leave the LM far from the floor, in the JAX package too (F12).
    Then ``resumable_bundle_adjust_sparse`` (4u's configuration, the true
    model fixed, float64, the start's rotations made orthonormal in
    float64) in 3-iteration segments against one continuous run of 12
    iterations: the same iterations, and E, X and c within
    ``SPARSE_RESUME_*``; a run stopped after one segment and re-invoked
    from its checkpoint equals the segmented run exactly. No K1 or K2
    launch."""
    import os
    import tempfile

    from mvrecon_tpu_torch.models.bundle_adjustment_sparse import SparseObs, bundle_adjust_sparse
    from mvrecon_tpu_torch.runtime.elastic import resumable_bundle_adjust_sparse

    hub = ["--huber", str(HUBER_DELTA)]
    rec = {
        "bal_distorted": bal_sparse_in_process(
            torch, fs, sy, bal_points, hub + ["--optimize-distortion", "2", "--shared-k"],
            keep=os.path.join(rank_dir, "sparse.bal")),
        "bal_triangulated": bal_sparse_in_process(
            torch, fs, sy, bal_points, ["--triangulate-init"] + hub, truth_k=(0.0, 0.0),
            robust=False),
        "bal_triangulated_distorted_reported": bal_sparse_in_process(
            torch, fs, sy, bal_points,
            ["--triangulate-init"] + hub + ["--optimize-distortion", "1"]),
    }
    scene, _, dist, x, vis, _, _, _, _ = bal_problem(torch, bal_points, name="bal_sparse")
    X0, K, R, t0 = (a.astype(np.float64) for a in perturbed_cameras(
        scene, seed=30, sigma=SPARSE_START_SIGMA))
    u, _, vt = np.linalg.svd(R)
    R = u @ vt  # orthonormal in float64 (the gauge round trip needs it)
    pi, ci = vis.nonzero(as_tuple=True)
    n_obs = pi.shape[0]
    xy = x[pi, ci]

    # the resumable driver against one continuous run, float64
    obs = SparseObs(pi.int(), ci.int(), xy.T.double().contiguous(),
                    torch.ones(n_obs, dtype=torch.float64, device="cuda"))
    cfg = sparse_config(SPARSE_RESUME_ITERS)
    kw = dict(axis="x-up_z-forward", cg_tol=1e-2, cg_max_iter=SPARSE_CG_MAX, distortion=dist)
    reset_launch_counts(fs, sy)
    t_c = time.perf_counter()
    cont = bundle_adjust_sparse(obs, X0, K, R, t0, config=cfg, **kw)
    rec["continuous_wall_s"] = time.perf_counter() - t_c
    with tempfile.TemporaryDirectory() as tmp:
        seg, ran = resumable_bundle_adjust_sparse(
            obs, X0, K, R, t0, os.path.join(tmp, "a.npz"), total_iters=SPARSE_RESUME_ITERS,
            segment_iters=SPARSE_SEGMENT_ITERS, config=cfg, **kw)
        ck = os.path.join(tmp, "b.npz")
        _, first = resumable_bundle_adjust_sparse(
            obs, X0, K, R, t0, ck, total_iters=SPARSE_SEGMENT_ITERS,
            segment_iters=SPARSE_SEGMENT_ITERS, config=cfg, **kw)
        resumed, rest = resumable_bundle_adjust_sparse(
            obs, X0, K, R, t0, ck, total_iters=SPARSE_RESUME_ITERS,
            segment_iters=SPARSE_SEGMENT_ITERS, config=cfg, **kw)
    rec["resume_launches"] = launch_counts(fs, sy)
    e_c, e_s = float(cont.error), float(seg.error)
    rec.update(
        continuous_n_iter=cont.n_iter, segmented_n_iter=ran, killed_at=first,
        resumed_n_iter=rest, continuous_E=e_c, segmented_E=e_s,
        E_rel_diff=abs(e_s - e_c) / e_c,
        X_max_abs_diff=float((seg.X - cont.X).abs().max()),
        c_rel_diff=abs(float(seg.log["c"]) - float(cont.log["c"])) / float(cont.log["c"]),
        resumed_equals_segmented=bool(torch.equal(resumed.X, seg.X)
                                      and float(resumed.error) == e_s),
        limits={"E_rtol": SPARSE_RESUME_E_RTOL, "X_atol": SPARSE_RESUME_X_ATOL,
                "c_rtol": SPARSE_RESUME_C_RTOL})
    print("sparse_entry_points " + json.dumps(rec), flush=True)
    for name in ("bal_distorted", "bal_triangulated"):
        check(rec[name]["inlier_E_vs_noise_floor"] < 1.5,
              f"{name}: inlier E / floor {rec[name]['inlier_E_vs_noise_floor']:.4f}")
    check(rec["resume_launches"] == (0, 0), "the resumable runs launched a SYRK kernel")
    check(ran == cont.n_iter and first + rest == ran,
          f"resumable iterations {first} + {rest}, {ran} against {cont.n_iter}")
    check(rec["E_rel_diff"] < SPARSE_RESUME_E_RTOL and rec["X_max_abs_diff"] < SPARSE_RESUME_X_ATOL
          and rec["c_rel_diff"] < SPARSE_RESUME_C_RTOL,
          f"segmented against continuous: E {rec['E_rel_diff']:.3e}, X "
          f"{rec['X_max_abs_diff']:.3e}, c {rec['c_rel_diff']:.3e}")
    check(rec["resumed_equals_segmented"], "the re-invoked run differs from the segmented one")
    return rec


def sparse_gpu_vs_cpu(torch, fs, sy, small) -> dict:
    """Phase 5, sparse: phase 5's small scene (12 views x 400 points) at
    60 % random visibility as an observation list, X and t perturbed by
    0.02 N(0, 1). ``bundle_adjust_sparse`` for two iterations on the card
    and on the CPU, float32, ``cg_tol=1e-6``: stored, recompute (chunks of
    512) and the fisheye truth, fixed, on observations rendered through it;
    E after each iteration within ``SPARSE_GPU_CPU_RTOL``,
    the same iterations and retries. Then the sparse core against the
    port's dense core on the card in float64 at ``cg_tol=1e-10``, 4
    iterations: E within ``SPARSE_DENSE_RTOL``, the same iterations. No K1
    or K2 launch on the card."""
    from mvrecon_tpu_torch.config import LMConfig
    from mvrecon_tpu_torch.models import bundle_adjustment as tba
    from mvrecon_tpu_torch.models.bundle_adjustment_sparse import (
        bundle_adjust_sparse,
        dense_to_sparse_obs,
    )

    x_host, X0, K, R, t0 = perturbed_start(small, seed=5)
    vis = (np.random.default_rng(5).random(x_host.shape[:2]) < 0.6).astype(np.float32)
    nf = K.shape[0]
    fish = np.asarray(FAMILY_TRUTHS["fisheye"], np.float32)[None].repeat(nf, 0)
    x_fish = tba.distort_points(torch.as_tensor(x_host), torch.as_tensor(K[:, 0, 0]),
                                distortion=torch.as_tensor(fish),
                                distortion_model="fisheye").numpy()
    two = LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=2, record_log=True)
    cases = {"stored": (x_host, {}, two),
             "recompute": (x_host, dict(factor_mode="recompute", obs_chunk=512), two),
             "fisheye": (x_fish, dict(distortion=fish),
                         dataclasses.replace(two, distortion_model="fisheye"))}
    reset_launch_counts(fs, sy)
    recs = {}
    for name, (x_in, kw, cfg) in cases.items():
        runs = {dev: bundle_adjust_sparse(dense_to_sparse_obs(x_in, vis, device=dev), X0, K, R,
                                          t0, axis="x-up_z-forward", config=cfg, device=dev,
                                          cg_tol=SPARSE_GPU_CPU_CG_TOL, cg_max_iter=200, **kw)
                for dev in ("cuda", "cpu")}
        e_g, e_c = (runs[d].log["reprojection_error"].cpu()[1:3] for d in ("cuda", "cpu"))
        recs[name] = {
            "E_gpu": e_g.tolist(), "E_cpu": e_c.tolist(),
            "E_rel_diff_iters_1_2": ((e_g - e_c).abs() / e_c).tolist(),
            "n_iter": [runs[d].n_iter for d in ("cuda", "cpu")],
            "retries": [runs[d].log["n_solver_retries"] for d in ("cuda", "cpu")],
            "cg_iters": [runs[d].log["cg_iters_total"] for d in ("cuda", "cpu")],
            "rtol": DISTORTION_RTOLS["fisheye"] if name == "fisheye" else SPARSE_GPU_CPU_RTOL,
        }
    x64 = torch.as_tensor(x_host, dtype=torch.float64, device="cuda")
    four = LMConfig(scale_factor=4.0, delta_tol=0.0, max_iter=4, accept_divisor=1.0,
                    init_damping=3e-3, damping="nielsen")
    d = tba.bundle_adjust(x64, X0, K, R, t0, visibility=vis, axis="x-up_z-forward",
                          config=four)
    s = bundle_adjust_sparse(dense_to_sparse_obs(x_host.astype(np.float64), vis, device="cuda"),
                             X0, K, R, t0, axis="x-up_z-forward", config=four, cg_tol=1e-10,
                             cg_max_iter=500)
    recs["sparse_vs_dense_float64"] = {
        "E_sparse": float(s.error), "E_dense": float(d.error),
        "E_rel_diff": abs(float(s.error) - float(d.error)) / float(d.error),
        "n_iter": [s.n_iter, d.n_iter], "rtol": SPARSE_DENSE_RTOL}
    recs["launches_gpu"] = launch_counts(fs, sy)
    print("sparse_gpu_vs_cpu " + json.dumps(recs), flush=True)
    for name in cases:
        r = recs[name]
        check(r["n_iter"][0] == r["n_iter"][1] and r["retries"][0] == r["retries"][1],
              f"sparse {name}: iterations or retries differ, card against CPU: {r}")
        check(max(r["E_rel_diff_iters_1_2"]) < r["rtol"],
              f"sparse {name}: E differs by {r['E_rel_diff_iters_1_2']} card against CPU "
              f"(limit {r['rtol']})")
    r = recs["sparse_vs_dense_float64"]
    check(r["E_rel_diff"] < SPARSE_DENSE_RTOL and r["n_iter"][0] == r["n_iter"][1],
          f"sparse against dense in float64: {r}")
    check(recs["launches_gpu"] == (0, 0), "the small sparse runs launched a SYRK kernel")
    return recs


RECONSTRUCT_CORRUPT = 0.001  # 4x: share of the observations moved by +0.1 and masked out
RECONSTRUCT_SHIFT = 0.1  # ... as tests/test_f0_and_misc.py's visibility test does
RECONSTRUCT_ITERS = 30  # 4x: the BA's iteration cap (delta_tol 1e-8, the CLI's default)
BENCH_BA_ITERS = 10  # 4y
ADJUSTER_ITERS = 4  # 4z: BundleAdjuster.optimize(is_debug=True), as JAX's test_compat
MST_NODES = 1000  # 4z: the random view graph, ...
MST_EDGES = 20000  # ... with integer weights in [0, 10), so most weights are tied


def run_cli(torch, fs, sy, argv: list) -> tuple[dict, tuple[int, int], float]:
    """One command of the port's command line, in process on the card: (its
    record, the (K2, K1) launches it made, its host wall)."""
    import contextlib
    import io

    from mvrecon_tpu_torch.cli import main as cli_main

    out = io.StringIO()
    reset_launch_counts(fs, sy)
    start = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    wall = time.perf_counter() - start
    launches = launch_counts(fs, sy)
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    check(rc == 0, f"{argv[0]}: rc {rc}")
    check(rec["device"] == torch.cuda.get_device_name(0), f"{argv[0]} ran on {rec['device']}")
    return rec, launches, wall


def sharded_command(torch, fs, sy, argv: list, unsharded: dict, launches: tuple,
                    name: str) -> dict:
    """Phase 5g: ``argv`` with ``--shard-points 1`` in process, no launcher
    (the command forms a one-rank NCCL group of its own and destroys it),
    against the same command's unsharded record and (K2, K1) launches:
    ``shard_points`` in the record, E within ``SHARDED_CLI_E_RTOL``, the
    same launches."""
    import torch.distributed as dist

    rec, got, wall = run_cli(torch, fs, sy, argv + ["--shard-points", "1"])
    e_rel = abs(rec["reprojection_error"] - unsharded["reprojection_error"]) / abs(
        unsharded["reprojection_error"])
    r = {"argv": argv + ["--shard-points", "1"], "wall_s": wall, "record": rec,
         "E_rel_diff_vs_unsharded": e_rel, "E_rtol": SHARDED_CLI_E_RTOL,
         "unsharded_E": unsharded["reprojection_error"], "syrk_acc_launches": got[0],
         "syrk_lower_launches": got[1], "unsharded_launches": list(launches)}
    print(f"sharded_cli_{name} " + json.dumps(r), flush=True)
    check(rec["shard_points"] == 1 and not dist.is_initialized(),
          f"5g {name}: record {rec}, or its process group outlived the command")
    check(e_rel <= SHARDED_CLI_E_RTOL, f"5g {name}: E differs from the unsharded run's by "
          f"{e_rel:.3e}")
    check(tuple(got) == tuple(launches), f"5g {name}: launches (K2, K1) {got} against the "
          f"unsharded run's {launches}")
    return r


def euclidean_on_card(torch, fs, sy) -> dict:
    """Phase 5g's ``euclidean``: the command's default scene (200 points x
    10 views) in float64, unsharded and with ``--shard-points 1``."""
    argv = ["euclidean", "--float64"]
    rec, launches, wall = run_cli(torch, fs, sy, argv)
    check(rec["status"] == 0 and launches == (0, 0), f"euclidean: {rec}, launches {launches}")
    return {"unsharded": {"wall_s": wall, "record": rec, "syrk_acc_launches": launches[0],
                          "syrk_lower_launches": launches[1]},
            "sharded": sharded_command(torch, fs, sy, argv, rec, launches, "euclidean")}


def ply_vertices(path: str) -> int:
    with open(path, "rb") as fh:
        head = fh.read(4096).decode("ascii", "replace")
    vertex = [ln for ln in head.splitlines() if ln.startswith("element vertex")]
    return int(vertex[0].split()[-1]) if vertex else -1


def reconstruct_on_card(torch, fs, sy, dense_points: int) -> dict:
    """Phase 4x: ``reconstruct`` in process on an npz of the dense
    headline's scene (10k points x 100 views, sigma = ``NOISE``, with
    ``X_gt``), 0.1 % of its observations moved by +0.1 and masked out in
    ``visibility``: float32 with ``--output``, ``--output-ply`` and
    ``--log-json``, then ``--float64 --covariance`` (the float32 dense
    covariance at this size is F10's NaN). Holds, at 10k points, that the
    command picked the low-rank depth eigensolve; status 0, E over the
    visible observations / (n_visible 2 sigma^2) < 1.5, the aligned RMSE
    reported, the outputs read back at their shapes, the log file's lines
    equal to the records, sqrt(sigma^2)/sigma within 5 % of 1 with finite
    point sigmas, and no launch of either kernel. Returns the records."""
    import os
    import tempfile

    from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu_torch.runtime import io as tio

    gen = torch.Generator(device="cuda").manual_seed(50)
    scene = make_synthetic_scene(gen, n_images=DENSE_VIEWS, n_slices=dense_points // 20,
                                 n_angles=20, dtype=torch.float32)
    npts = scene.X.shape[0]
    bad = torch.rand((npts, DENSE_VIEWS), generator=gen, device="cuda") < RECONSTRUCT_CORRUPT
    x = scene.x.clone()
    x[bad.T] += RECONSTRUCT_SHIFT
    vis_host = (~bad).float().cpu().numpy()
    n_vis = int(vis_host.sum())
    floor = n_vis * 2 * NOISE**2
    recs = {}
    with tempfile.TemporaryDirectory() as tmp:
        path, out_npz, ply, log = (os.path.join(tmp, n) for n in (
            "tracks.npz", "out.npz", "out.ply", "runs.jsonl"))
        tio.save_observations(path, x.cpu().numpy(), visibility=vis_host,
                              X_gt=scene.X.cpu().numpy())
        for name, extra in (("float32", []), ("float64_covariance", ["--float64", "--covariance"])):
            rec, launches, wall = run_cli(torch, fs, sy, [
                "reconstruct", path, "--max-iter",
                str(RECONSTRUCT_ITERS), "--output", out_npz, "--output-ply", ply,
                "--log-json", log] + extra)
            d = tio.load_observations(out_npz)
            r = {"points": npts, "views": DENSE_VIEWS, "visible": n_vis,
                 "masked": int(bad.sum()), "wall_s": wall, "record": rec,
                 "E_vs_noise_floor": rec["reprojection_error"] / floor,
                 "syrk_acc_launches": launches[0], "syrk_lower_launches": launches[1],
                 "output_shapes": {k: list(v.shape) for k, v in d.items()},
                 "ply_vertices": ply_vertices(ply)}
            if "sigma" in rec:
                r["sigma_vs_true"] = rec["sigma"] / NOISE
            recs[name] = r
            print(f"reconstruct_{name} " + json.dumps(r), flush=True)
            want = {"X": [npts, 3], "K": [DENSE_VIEWS, 3, 3], "R": [DENSE_VIEWS, 3, 3],
                    "t": [DENSE_VIEWS, 3], "x": [DENSE_VIEWS, npts, 2]}
            if "sigma" in rec:
                want.update(point_cov=[npts, 3, 3], camera_cov=[DENSE_VIEWS, 9, 9], sigma2=[])
            # the dual depth loop's dense eigensolve would hold four (F, P, P)
            # arrays, 160 GB at this width in float32
            if dense_points >= 10_000:
                check(rec["eig_method"] == "lowrank",
                      f"reconstruct {name}: eigensolve {rec['eig_method']}")
            check(rec["status"] == 0 and rec["n_visible"] == n_vis
                  and (rec["n_points"], rec["n_views"]) == (npts, DENSE_VIEWS),
                  f"reconstruct {name}: record {rec}")
            check(r["E_vs_noise_floor"] < 1.5,
                  f"reconstruct {name}: E / floor {r['E_vs_noise_floor']:.4f}")
            check(math.isfinite(rec["aligned_rmse_gt"]),
                  f"reconstruct {name}: aligned RMSE {rec['aligned_rmse_gt']}")
            check(r["output_shapes"] == want and r["ply_vertices"] == npts + DENSE_VIEWS,
                  f"reconstruct {name}: outputs {r['output_shapes']}, {r['ply_vertices']} "
                  "vertices")
            check(launches == (0, 0), f"reconstruct {name} launched a SYRK kernel {launches}")
        check(abs(recs["float64_covariance"]["sigma_vs_true"] - 1.0) < 0.05
              and math.isfinite(recs["float64_covariance"]["record"]["point_sigma_max"]),
              f"reconstruct covariance: sigma {recs['float64_covariance']['record']['sigma']}")
        with open(log) as fh:
            lines = [json.loads(line) for line in fh]
        check(lines == [r["record"] for r in recs.values()], "reconstruct --log-json lines")
        # 5g: the float64 run again with --shard-points 1 (the sharded
        # calibration, then the dense sharded core; the covariance unsharded)
        f64 = recs["float64_covariance"]
        recs["float64_covariance_sharded"] = sharded_command(
            torch, fs, sy, ["reconstruct", path, "--max-iter", str(RECONSTRUCT_ITERS),
                            "--float64", "--covariance", "--output", out_npz],
            f64["record"], (f64["syrk_acc_launches"], f64["syrk_lower_launches"]), "reconstruct")
        check(recs["float64_covariance_sharded"]["record"]["sigma"] > 0
              and tio.load_observations(out_npz)["point_cov"].shape == (npts, 3, 3),
              "5g reconstruct: no covariance in the record or the output")
    return recs


def bench_ba_on_card(torch, fs, sy, points: int, dense_points: int) -> dict:
    """Phase 4y: ``bench-ba`` in process, float32. ``--chunked`` at the
    north star's width (100k points x 1000 views, chunk 768, 10
    iterations): the fused build, so K2 launches and K1 does not; the
    dense core at the headline's (10k x 100, 10 iterations), launching
    neither; then the dense run again under ``--profile``, whose trace
    file must appear. Each ends finite and below its start E. Returns
    the records."""
    import os
    import tempfile

    runs = {
        "chunked": ["--chunked", "--points", str(points), "--views", str(VIEWS),
                    "--chunk-size", str(CHUNK)],
        "dense": ["--points", str(dense_points), "--views", str(DENSE_VIEWS)],
    }
    recs = {}
    with tempfile.TemporaryDirectory() as tmp:
        prof = os.path.join(tmp, "profile")
        runs["dense_profiled"] = runs["dense"] + ["--profile", prof]
        for name, argv in runs.items():
            rec, launches, wall = run_cli(torch, fs, sy,
                                          ["bench-ba", "--iters", str(BENCH_BA_ITERS)] + argv)
            npts = rec["points"] // 20 * 20
            r = {"record": rec, "command_wall_s": wall, "syrk_acc_launches": launches[0],
                 "syrk_lower_launches": launches[1],
                 "E_vs_noise_floor": rec["reprojection_error"] / (npts * rec["views"] * 2
                                                                  * NOISE**2)}
            if name == "dense_profiled":
                trace = os.path.join(prof, "trace.json")
                r["trace_bytes"] = os.path.getsize(trace) if os.path.exists(trace) else 0
                if r["trace_bytes"]:
                    with open(trace) as fh:
                        events = json.load(fh)["traceEvents"]
                    r["trace_kernel_events"] = sum(e.get("cat") == "kernel" for e in events)
            recs[name] = r
            print(f"bench_ba_{name} " + json.dumps(r), flush=True)
            err = rec["reprojection_error"]
            check(math.isfinite(err) and err < rec["start_error"],
                  f"bench-ba {name}: E {err} against its start {rec['start_error']}")
            fused = name == "chunked"
            check((launches[0] > 0) == fused and launches[1] == 0,
                  f"bench-ba {name}: launches (K2, K1) {launches}")
    check(recs["dense_profiled"]["trace_bytes"] > 0, "bench-ba --profile wrote no trace")
    return recs


def reference_api_on_card(torch, fs, sy, adjuster_points: int) -> dict:
    """Phase 4z, the reference-named API on the card. ``BundleAdjuster`` at
    20k points x 1000 views, float32, from X and t perturbed by 0.02: its
    (P, F, 27) coupling blocks take 2.16 GB, above the class's 1.5 GB
    threshold, so ``optimize(is_debug=True)`` runs the chunked core (K2)
    for ``ADJUSTER_ITERS`` iterations; its log holds one scalar record an
    iteration, ending at the result's E. ``MinimumSpanningTree`` on a
    1,000-node random graph with tied weights, on the native route, equal
    to a plain Kruskal. The perspective shim on a list of ten (200, 2)
    arrays: status 0. Returns the record."""
    from mvrecon_tpu_torch.bundle_adjustment import BundleAdjuster
    from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu_torch.minimum_spanning_tree import MinimumSpanningTree, UnionFind
    from mvrecon_tpu_torch.perspective_camera_calibration import (
        perspective_self_calibration_full,
    )
    from mvrecon_tpu_torch.runtime.native import mst_native

    gen = torch.Generator(device="cuda").manual_seed(60)
    scene = make_synthetic_scene(gen, n_images=VIEWS, n_slices=adjuster_points // 20,
                                 n_angles=20, dtype=torch.float32)
    npts = scene.X.shape[0]
    X0, K, R, t0 = perturbed_cameras(scene, seed=60)
    x = scene.x.transpose(0, 1).contiguous()
    del scene
    coupling = npts * VIEWS * 27 * x.element_size()
    chunked = coupling > BundleAdjuster.CHUNKED_THRESHOLD_BYTES
    torch.cuda.synchronize()
    reset_launch_counts(fs, sy)
    start = time.perf_counter()
    ba = BundleAdjuster(x, X0, K, R, t0, axis="x-up_z-forward")
    ba.optimize(2.0, 0.0, max_iter=ADJUSTER_ITERS, is_debug=True)
    err = float(ba.result.error)
    wall = time.perf_counter() - start
    launches = launch_counts(fs, sy)
    log = ba.get_log()
    adjuster = {
        "points": npts, "views": VIEWS, "coupling_gb": coupling / 1e9,
        "threshold_gb": BundleAdjuster.CHUNKED_THRESHOLD_BYTES / 1e9, "chunked": chunked,
        "iterations": ADJUSTER_ITERS, "n_iter": ba.result.n_iter, "wall_s": wall,
        "log_keys": sorted(log[0]), "log_E": [r["reprojection_error"] for r in log],
        "reprojection_error": err, "E_vs_noise_floor": err / (npts * VIEWS * 2 * NOISE**2),
        "syrk_acc_launches": launches[0], "syrk_lower_launches": launches[1],
    }
    print("bundle_adjuster " + json.dumps(adjuster), flush=True)
    del x, ba
    if adjuster_points >= 20_000:
        check(chunked, f"BundleAdjuster at {npts} x {VIEWS}: coupling {coupling / 1e9:.2f} GB "
              "is not above the threshold")
    check(adjuster["log_keys"] == (["reprojection_error"] if chunked
                                   else ["basis", "points", "pos", "reprojection_error"]),
          f"BundleAdjuster log keys {adjuster['log_keys']}")
    check(len(log) == adjuster["n_iter"] + 1 and math.isclose(log[-1]["reprojection_error"], err,
                                                              rel_tol=1e-6),
          f"BundleAdjuster log {adjuster['log_E']} does not end at E {err}")
    check(math.isfinite(err) and err < log[0]["reprojection_error"],
          f"BundleAdjuster E {err} against its start {log[0]['reprojection_error']}")
    check((launches[0] > 0) == chunked and launches[1] == 0,
          f"BundleAdjuster launches (K2, K1) {launches}, chunked {chunked}")

    rng = np.random.default_rng(61)
    edges = rng.integers(0, MST_NODES, size=(MST_EDGES, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    weights = rng.integers(0, 10, size=len(edges)).astype(np.float64)
    check(mst_native.available(), f"the native MST did not build: {mst_native.build_error()}")
    start = time.perf_counter()
    tree = MinimumSpanningTree(edges, weights).solve()
    native_s = time.perf_counter() - start
    start = time.perf_counter()
    uf = UnionFind(MST_NODES)
    keep = [k for k in np.argsort(weights, kind="stable")
            if uf.union(int(edges[k, 0]), int(edges[k, 1]))]
    plain_s = time.perf_counter() - start
    mst = {"nodes": MST_NODES, "edges": len(edges), "distinct_weights": 10,
           "tree_edges": len(tree), "native": True, "native_s": native_s, "plain_s": plain_s,
           "equal_to_plain": bool(np.array_equal(tree[:, :2], edges[keep])
                                  and np.array_equal(tree[:, 2], weights[keep]))}
    print("mst " + json.dumps(mst), flush=True)
    check(mst["equal_to_plain"] and len(tree) == MST_NODES - 1,
          f"MST: {len(tree)} edges, equal to the plain Kruskal: {mst['equal_to_plain']}")

    sc = make_synthetic_scene(torch.Generator(device="cuda").manual_seed(62), n_images=10,
                              dtype=torch.float32)
    calib = perspective_self_calibration_full([xi.cpu().numpy() for xi in sc.x], tol=1e-2,
                                              method="dual")
    shim = {"points": calib.X.shape[0], "views": calib.R.shape[0], "status": calib.status,
            "depth_iters": calib.depth_iters, "device": str(calib.X.device),
            "finite": finite(torch, calib.X, calib.R, calib.t, calib.K)}
    print("perspective_shim " + json.dumps(shim), flush=True)
    check(shim["status"] == 0 and shim["finite"] and calib.X.is_cuda
          and tuple(calib.X.shape) == (200, 3),
          f"perspective shim: {shim}")
    return {"bundle_adjuster": adjuster, "mst": mst, "perspective_shim": shim}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--points", type=int, default=100_000)
    parser.add_argument("--ba-iters", type=int, default=8)
    parser.add_argument("--streamed-points", type=int, default=1_000_000)
    parser.add_argument("--dense-points", type=int, default=10_000)
    parser.add_argument("--bal-points", type=int, default=20_000)
    parser.add_argument("--sparse-points", type=int, default=1_000_000)
    parser.add_argument("--batched-scenes", type=int, default=256)
    parser.add_argument("--reps", type=int, default=20)
    # one rank of phases 5b and 5c, started by the script itself
    parser.add_argument("--sharded-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--sharded-port", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--sharded-out", default="", help=argparse.SUPPRESS)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.sharded_rank is not None:
        return sharded_rank(args)
    from mvrecon_tpu_torch.config import LMConfig, resolve_device
    from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu_torch.models import bundle_adjustment as tba
    from mvrecon_tpu_torch.models.bundle_adjustment_chunked import bundle_adjust_chunked
    from mvrecon_tpu_torch.models.bundle_adjustment_streamed import bundle_adjust_streamed
    from mvrecon_tpu_torch.models.perspective import perspective_self_calibration
    from mvrecon_tpu_torch.models.pipelines import (
        euclidean_reconstruction,
        euclidean_reconstruction_large,
    )
    from mvrecon_tpu_torch.ops import _cuda_build
    from mvrecon_tpu_torch.ops import fused_schur as fs
    from mvrecon_tpu_torch.ops import syrk as sy
    from mvrecon_tpu_torch.runtime.profiling import EventTimer, StageTimer

    # 1. header
    smi = nvidia_smi_line()
    resolve_device(None)
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    print(f"tf32 matmul {tf32[0]} cudnn {tf32[1]}", flush=True)
    check(tf32 == (False, False), "TF32 is on")

    # 2. build
    build_s = _cuda_build.build()
    print(f"build: {build_s:.2f} s for {', '.join(_cuda_build.SOURCES)}", flush=True)

    # 3. kernels against their plain versions, at the north-star chunk
    # (Y (3 * 768, 9 * 1024)) and at the small device-test shape
    # K2 also at k_rows not a multiple of its 64-row stage
    _, n_acc = fs.schur_acc_dim(VIEWS)
    k2 = check_syrk_acc(torch, fs, sy, 3 * CHUNK, n_acc, args.reps, seed=0)
    check_syrk_acc(torch, fs, sy, 384, 9 * 512, args.reps, seed=1)
    check_syrk_acc(torch, fs, sy, 300, 9 * 512, args.reps, seed=8)
    # K2 at 4z's Y: BundleAdjuster runs the chunked core at its default chunk
    adjuster_chunk = inspect.signature(bundle_adjust_chunked).parameters["chunk_size"].default
    k2_adjuster = check_syrk_acc(torch, fs, sy, 3 * adjuster_chunk, n_acc, args.reps, seed=12)
    # K1 at the streamed chunk, Y (3 * 16384, 9 * 500) laid out K-major as
    # the streamed path lays it out, at unaligned shapes given row-major
    # (copied by the wrapper) and K-major, and at k_rows not a multiple of
    # its 32-row stage
    k1 = check_syrk_lower(torch, sy, 3 * STREAMED_CHUNK, 9 * STREAMED_VIEWS, args.reps, seed=2,
                          k_major=True)
    check_syrk_lower(torch, sy, 300, 1000, args.reps, seed=3)
    check_syrk_lower(torch, sy, 300, 999, args.reps, seed=6)
    check_syrk_lower(torch, sy, 300, 999, args.reps, seed=7, k_major=True)
    check_syrk_lower(torch, sy, 333, 999, args.reps, seed=9, k_major=True)
    # K1 at the non-fused chunked build's Y (3 * 768, 9 * 1000), K-major as
    # the build writes it, and its deferred-mirror sum over two chunks
    k1_build = check_syrk_lower(torch, sy, 3 * CHUNK, 9 * VIEWS, args.reps, seed=10,
                                k_major=True)
    syrk_accumulate_check(torch, sy, 3 * CHUNK, 9 * VIEWS, seed=11)

    # 4. the pipeline at full width
    config = north_star_config(LMConfig, args.ba_iters)
    warm, scene = north_star_scenes(torch, make_synthetic_scene, args.points)
    euclidean_reconstruction_large(warm.x, config=dataclasses.replace(config, max_iter=1),
                                   chunk_size=CHUNK)
    del warm
    n_points = scene.X.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fs.reset_launch_counts()
    timer = StageTimer()
    start = time.perf_counter()
    res = euclidean_reconstruction_large(scene.x, config=config, chunk_size=CHUNK,
                                         timer=timer)
    err = float(res.error)
    wall = time.perf_counter() - start
    launches = fs.launch_counts["syrk_acc"]
    retries = res.ba_log["n_solver_retries"]
    n_chunks = math.ceil(n_points / CHUNK)
    floor = n_points * VIEWS * 2 * NOISE**2
    pipe = {
        "points": n_points, "views": VIEWS, "chunk": CHUNK,
        "ba_iters": args.ba_iters, "wall_s": wall,
        "calibration_s": timer.times["perspective_self_calibration"],
        "ba_s": timer.times["bundle_adjustment"],
        "status": res.status, "ba_n_iter": res.n_iter, "ba_solver_retries": retries,
        "chunks": n_chunks, "syrk_acc_launches": launches,
        "reprojection_error": err, "E_vs_noise_floor": err / floor,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "syrk_acc_ms_total": launches * k2["ms"],
    }
    if args.points < 100_000:
        print(f"pipeline cut to {n_points} points x {VIEWS} views by arguments")
    print("pipeline " + json.dumps(pipe), flush=True)
    check(math.isfinite(err), "pipeline E is not finite")
    check(pipe["status"] == 0, f"calibration status {pipe['status']}")
    check(pipe["E_vs_noise_floor"] < 1.5, f"E / noise floor {pipe['E_vs_noise_floor']:.3f}")
    check(launches == retries * n_chunks > 0,
          f"syrk_acc launches {launches} != retries {retries} x chunks {n_chunks}")

    # 4i. the chunked BA under the Huber loss on phase 4's scene with 3 %
    # gross outliers; 4k. the covariance of phase 4's result
    k2_robust = robust_chunked(torch, fs, sy, scene, config)
    covariance_chunked(torch, scene.x.transpose(0, 1), res)
    del res
    # 4n. the radial model through the fused build, and its covariance; 4o.
    # the OPENCV model through the non-fused build (K1)
    k2_distorted = distorted_chunked(torch, fs, sy, scene, config)
    opencv_rec = nonfused_chunked(torch, fs, sy, scene, config)
    k1_opencv = opencv_rec["syrk_lower_launches"]
    # 4r. the other four families through the non-fused build (K1)
    family_chunked = {model: nonfused_chunked(torch, fs, sy, scene, config, model, k, 40 + i,
                                              f"{model}_chunked")
                      for i, (model, k) in enumerate(FAMILY_TRUTHS.items())}
    del scene

    # 4b. the host-streamed BA at full width: 1M points x 500 views, the
    # (P, F, 2) observations in host memory
    gen = torch.Generator(device="cuda").manual_seed(4)
    scene = make_synthetic_scene(gen, n_images=STREAMED_VIEWS,
                                 n_slices=args.streamed_points // 20, n_angles=20,
                                 dtype=torch.float32)
    x_host, X0, K0, R0, t0 = perturbed_start(scene, seed=4)
    s_truth = true_state(tba, scene)  # 4p renders the distorted problem from it
    del scene
    torch.cuda.empty_cache()
    n_points = x_host.shape[0]
    s_cfg = LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s_timer = EventTimer()
    sy.reset_launch_counts()
    start = time.perf_counter()
    s_res = bundle_adjust_streamed(x_host, X0, K0, R0, t0, axis="x-up_z-forward", config=s_cfg,
                                   chunk_size=STREAMED_CHUNK, prefetch=2, timer=s_timer)
    s_err = float(s_res.error)
    torch.cuda.synchronize()
    s_wall = time.perf_counter() - start
    k1_launches = sy.launch_counts["syrk_lower"]
    s_peak = torch.cuda.max_memory_allocated()
    spans = s_timer.ms()
    s_retries = s_res.log["n_solver_retries"]
    s_chunks = math.ceil(n_points / STREAMED_CHUNK)
    pass_bytes = s_chunks * STREAMED_CHUNK * (STREAMED_VIEWS * 2 + 1) * 4
    n_passes = 1 + 2 * s_retries  # the starting error, then two per retry
    h2d_ms = sum(spans["h2d"])
    s_floor = n_points * STREAMED_VIEWS * 2 * NOISE**2
    streamed = {
        "points": n_points, "views": STREAMED_VIEWS, "chunk": STREAMED_CHUNK, "prefetch": 2,
        "chunks": s_chunks, "wall_s": s_wall, "n_iter": s_res.n_iter, "retries": s_retries,
        "pass1_ms": spans["pass1"], "pass2_ms": spans["pass2"],
        "h2d_bytes_per_pass": pass_bytes, "h2d_copies": len(spans["h2d"]),
        "h2d_busy_ms": h2d_ms, "h2d_GB_per_s": n_passes * pass_bytes / h2d_ms / 1e6,
        "pass1_GB_per_s": [pass_bytes / t / 1e6 for t in spans["pass1"]],
        "syrk_lower_launches": k1_launches, "syrk_lower_ms_total": k1_launches * k1["ms"],
        "reprojection_error": s_err, "E_vs_noise_floor": s_err / s_floor,
        "max_memory_allocated_gb": s_peak / 1e9, "observations_gb": x_host.nbytes / 1e9,
    }
    if args.streamed_points < 1_000_000:
        print(f"streamed BA cut to {n_points} points x {STREAMED_VIEWS} views by arguments")
    print("streamed " + json.dumps(streamed), flush=True)
    x_nbytes = x_host.nbytes
    check(math.isfinite(s_err), "streamed E is not finite")
    check(streamed["E_vs_noise_floor"] < 1.5,
          f"streamed E / noise floor {streamed['E_vs_noise_floor']:.3f}")
    check(k1_launches == s_retries * s_chunks > 0,
          f"syrk_lower launches {k1_launches} != retries {s_retries} x chunks {s_chunks}")
    # the per-chunk peak does not scale with P: the check is the design point's
    if args.streamed_points >= 1_000_000:
        check(s_peak < x_nbytes, f"streamed peak device memory {s_peak / 1e9:.2f} GB is not "
              f"below the observations' {x_nbytes / 1e9:.2f} GB")

    # 4l. the streamed covariance of phase 4b's result; 4j. the streamed BA
    # under the Huber loss, after gross outliers are injected into the same
    # host observations
    full_streamed = args.streamed_points >= 1_000_000
    covariance_streamed(torch, x_host, (s_res.X, s_res.K, s_res.R, s_res.t), full_streamed)
    del s_res
    k1_robust = robust_streamed(torch, sy, x_host, (X0, K0, R0, t0), s_cfg, full_streamed)
    # 4p. the radial model streamed, re-rendered into the same host array
    k1_distorted = distorted_streamed(torch, sy, x_host, s_truth, (X0, K0, R0, t0), s_cfg,
                                      full_streamed)["syrk_lower_launches"]
    # 4s. the full OPENCV model streamed, re-rendered into the same host array
    full_streamed_rec = distorted_streamed(torch, sy, x_host, s_truth, (X0, K0, R0, t0), s_cfg,
                                           full_streamed, "full_opencv",
                                           FAMILY_TRUTHS["full_opencv"], 37,
                                           "full_opencv_streamed")
    del x_host, X0, s_truth

    # 4c. dense BA at the headline's width: 10k points x 100 views, from
    # the true K and R with X and t perturbed by 0.05 N(0, 1)
    gen = torch.Generator(device="cuda").manual_seed(3)
    d_scene = make_synthetic_scene(gen, n_images=DENSE_VIEWS, n_slices=args.dense_points // 20,
                                   n_angles=20, dtype=torch.float32)
    d_start = [torch.from_numpy(a).cuda() for a in perturbed_start(d_scene, seed=3, sigma=0.05)]
    n_points = d_start[0].shape[0]
    d_floor = n_points * DENSE_VIEWS * 2 * NOISE**2
    d_cfg = LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=10)
    tba.bundle_adjust(*d_start, axis="x-up_z-forward", config=d_cfg)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(fs, sy)
    start = time.perf_counter()
    d_res = tba.bundle_adjust(*d_start, axis="x-up_z-forward",
                              config=dataclasses.replace(d_cfg, record_log=True))
    d_err = float(d_res.error)
    d_wall = time.perf_counter() - start
    d_launches = launch_counts(fs, sy)
    d_e0 = float(d_res.log["reprojection_error"][0])
    d_state = (d_res.X, d_res.K, d_res.R, d_res.t)
    dense = {
        "points": n_points, "views": DENSE_VIEWS, "ba_iters": d_cfg.max_iter, "wall_s": d_wall,
        "n_iter": d_res.n_iter, "start_E": d_e0, "reprojection_error": d_err,
        "E_vs_noise_floor": d_err / d_floor,
        "side": "camera" if 3 * n_points < 9 * DENSE_VIEWS else "point",
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "syrk_acc_launches": d_launches[0], "syrk_lower_launches": d_launches[1],
    }
    del d_res
    dense["layers"] = dense_layers(torch, tba, d_start, d_cfg, args.reps)
    # the camera side at its own shape: 200 points x 100 views (3P < 9F)
    c_scene = make_synthetic_scene(gen, n_images=DENSE_VIEWS, n_slices=10, n_angles=20,
                                   dtype=torch.float32)
    c_start = [torch.from_numpy(a).cuda() for a in perturbed_start(c_scene, seed=3, sigma=0.05)]
    dense["camera_side_layers"] = dense_layers(torch, tba, c_start, d_cfg, args.reps)
    if args.dense_points < 10_000:
        print(f"dense BA cut to {n_points} points x {DENSE_VIEWS} views by arguments")
    print("dense_ba " + json.dumps(dense), flush=True)
    check(math.isfinite(d_err), "dense BA E is not finite")
    check(d_err < d_e0, f"dense BA E {d_err:.6g} is not below its start {d_e0:.6g}")
    check(d_launches == (0, 0), f"dense BA launched the SYRK kernels {d_launches}")
    check(dense["camera_side_layers"]["side"] == "camera", "the camera-side problem is not")
    covariance_dense_vs_chunked(torch, d_start[0], d_state)  # 4k, second run
    del d_state

    # 4d. the dense pipeline on the same observations
    reset_launch_counts(fs, sy)
    d_timer = StageTimer()
    start = time.perf_counter()
    p_res = euclidean_reconstruction(d_scene.x, method="dual", eig_method="lowrank",
                                     config=d_cfg, timer=d_timer)
    p_err = float(p_res.error)
    p_wall = time.perf_counter() - start
    p_launches = launch_counts(fs, sy)
    dense_pipe = {
        "points": n_points, "views": DENSE_VIEWS, "wall_s": p_wall,
        "stage_walls_s": d_timer.times, "status": p_res.status, "ba_n_iter": p_res.n_iter,
        "reprojection_error": p_err, "E_vs_noise_floor": p_err / d_floor,
        "syrk_acc_launches": p_launches[0], "syrk_lower_launches": p_launches[1],
    }
    print("dense_pipeline " + json.dumps(dense_pipe), flush=True)
    del d_scene, d_start, c_scene, c_start, p_res
    check(math.isfinite(p_err), "dense pipeline E is not finite")
    check(dense_pipe["status"] == 0, f"dense pipeline status {dense_pipe['status']}")
    check(dense_pipe["E_vs_noise_floor"] < 1.5,
          f"dense pipeline E / noise floor {dense_pipe['E_vs_noise_floor']:.3f}")
    check(p_launches == (0, 0), f"dense pipeline launched the SYRK kernels {p_launches}")

    # the ranks' directory: 5h's list (from 4u) and 5j's files (from 4t and
    # 4w) are written there, and the two ranks of 5b-5k write their results
    rank_dir = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    atexit.register(shutil.rmtree, rank_dir, True)

    # 4m. scripts/bench_bal.py's distorted problem through the dense core;
    # 4q. the same problem through each of the other four families, one
    # refit round; 4t. the bal subcommand on COLMAP models of three of them
    distorted_dense(torch, fs, sy, args.bal_points)
    for model, k in FAMILY_TRUTHS.items():
        distorted_dense(torch, fs, sy, args.bal_points, model, k, 1, f"{model}_dense",
                        FAMILY_SIGMA, robust=model != "full_opencv")
    distorted_dense(torch, fs, sy, args.bal_points, "full_opencv", FAMILY_TRUTHS["full_opencv"],
                    1, "full_opencv_dense_huber", FAMILY_SIGMA, hold_model=False)
    bal_recs = bal_on_card(torch, fs, sy, args.bal_points, rank_dir)

    # 4u. the sparse observation-list core at bench_bal_large's width: 1M
    # points x 1,600 cameras x 10M observations; 4v. its capacity levers;
    # 4w. its entry points (bal --sparse, the resumable driver)
    sparse_prob, sparse_rec = sparse_full_width(torch, fs, sy, args.sparse_points)
    levers_rec = sparse_levers(torch, fs, sy, sparse_prob)
    write_sparse_list(sparse_prob, os.path.join(rank_dir, "sparse.npz"))  # 5h's input
    del sparse_prob
    torch.cuda.empty_cache()
    entry_rec = sparse_entry_points(torch, fs, sy, args.bal_points, rank_dir)
    torch.cuda.empty_cache()

    # 4x. reconstruct on an npz of the dense headline's scene; 4y. bench-ba,
    # chunked at the north star's width and dense at the headline's; 4z. the
    # reference-named API (BundleAdjuster above its chunked threshold, the
    # native MST, the perspective shim)
    recon_recs = reconstruct_on_card(torch, fs, sy, args.dense_points)
    eucl_rec = euclidean_on_card(torch, fs, sy)  # 5g's euclidean
    bench_recs = bench_ba_on_card(torch, fs, sy, args.points, args.dense_points)
    api_rec = reference_api_on_card(torch, fs, sy, args.bal_points)
    torch.cuda.empty_cache()

    # 5a-5k. point sharding and the 2D BA: one NCCL rank, then two ranks on the card
    sharded_launches = sharded_phases(torch, fs, sy, args, config, opencv_rec, dense, pipe,
                                      dense_pipe, sparse_rec, bal_recs, rank_dir)
    torch.cuda.empty_cache()

    # 4e. the large pipeline with the camera bootstrap, on phase 4's scene
    _, scene = north_star_scenes(torch, make_synthetic_scene, args.points)
    n_points = scene.X.shape[0]
    torch.cuda.synchronize()
    reset_launch_counts(fs, sy)
    b_timer = StageTimer()
    start = time.perf_counter()
    b_res = euclidean_reconstruction_large(scene.x, config=config, chunk_size=CHUNK,
                                           bootstrap_frac=BOOTSTRAP_FRAC,
                                           bootstrap_iters=BOOTSTRAP_ITERS, timer=b_timer)
    b_err = float(b_res.error)
    b_wall = time.perf_counter() - start
    b_launches = fs.launch_counts["syrk_acc"]
    b_retries = b_res.ba_log["n_solver_retries"]
    sub = max(int(n_points * BOOTSTRAP_FRAC), min(n_points, 200))  # the pipeline's subsample
    boot_chunks = math.ceil(sub / min(CHUNK, sub))
    boot_launches = b_launches - b_retries * n_chunks
    boot = {
        "points": n_points, "views": VIEWS, "chunk": CHUNK, "bootstrap_frac": BOOTSTRAP_FRAC,
        "bootstrap_iters": BOOTSTRAP_ITERS, "wall_s": b_wall, "stage_walls_s": b_timer.times,
        "status": b_res.status, "ba_n_iter": b_res.n_iter, "ba_solver_retries": b_retries,
        "syrk_acc_launches": b_launches, "bootstrap_syrk_acc_launches": boot_launches,
        "bootstrap_chunks": boot_chunks, "bootstrap_retries": boot_launches / boot_chunks,
        "reprojection_error": b_err, "E_vs_noise_floor": b_err / floor,
        "E_vs_noise_floor_without_bootstrap": pipe["E_vs_noise_floor"],
    }
    print("bootstrap_pipeline " + json.dumps(boot), flush=True)
    del scene, b_res
    check(math.isfinite(b_err), "bootstrap pipeline E is not finite")
    check(boot["status"] == 0, f"bootstrap pipeline status {boot['status']}")
    check(boot["E_vs_noise_floor"] < 1.5,
          f"bootstrap pipeline E / noise floor {boot['E_vs_noise_floor']:.3f}")
    check(boot_launches > 0 and boot_launches % boot_chunks == 0,
          f"syrk_acc launches {b_launches} != final retries {b_retries} x chunks {n_chunks} "
          f"+ a positive multiple of the bootstrap's {boot_chunks} chunks")

    batched_phases(torch, fs, sy, args.batched_scenes, args.dense_points)

    # 5. the card against the CPU (plain versions) on a small scene: the
    # whole pipeline on each, then BA on each from one calibration
    small = make_synthetic_scene(torch.Generator().manual_seed(1), n_images=12,
                                 n_slices=20, n_angles=20, dtype=torch.float32)
    small_cfg = dataclasses.replace(config, max_iter=8, record_log=True)
    fs.reset_launch_counts()
    r_gpu = euclidean_reconstruction_large(small.x, config=small_cfg, chunk_size=128)
    gpu_launches = fs.launch_counts["syrk_acc"]
    r_cpu = euclidean_reconstruction_large(small.x, config=small_cfg, chunk_size=128,
                                           device="cpu")
    e_gpu, e_cpu = float(r_gpu.error), float(r_cpu.error)
    e_rel = abs(e_gpu - e_cpu) / e_cpu
    calib = perspective_self_calibration(small.x, tol=1e-2, method="dual",
                                         eig_method="lowrank", device="cpu")
    early = dataclasses.replace(small_cfg, max_iter=2)
    logs = [bundle_adjust_chunked(small.x.transpose(0, 1), calib.X, calib.K, calib.R, calib.t,
                                  axis="x-up_z-forward", config=early, chunk_size=128,
                                  device=dev).log["reprojection_error"].cpu()
            for dev in ("cuda", "cpu")]
    early_rel = ((logs[0][1:] - logs[1][1:]).abs() / logs[1][1:]).tolist()
    small_rec = {
        "status_gpu": r_gpu.status, "status_cpu": r_cpu.status, "E_gpu": e_gpu,
        "E_cpu": e_cpu, "E_rel_diff": e_rel, "E_rtol": FINAL_E_RTOL,
        "n_iter_gpu": r_gpu.n_iter, "n_iter_cpu": r_cpu.n_iter,
        "retries_gpu": r_gpu.ba_log["n_solver_retries"],
        "retries_cpu": r_cpu.ba_log["n_solver_retries"],
        "same_start_E_rel_diff_iters_1_2": early_rel, "early_rtol": EARLY_ITER_RTOL,
        "syrk_acc_launches_gpu": gpu_launches,
    }
    print("gpu_vs_cpu " + json.dumps(small_rec), flush=True)
    check(r_gpu.status == r_cpu.status == 0, "small-scene status")
    check(r_gpu.n_iter == r_cpu.n_iter, "small-scene BA iterations differ")
    check(e_rel < FINAL_E_RTOL, f"small-scene E differs by {e_rel:.3e} (limit {FINAL_E_RTOL})")
    check(max(early_rel) < EARLY_ITER_RTOL,
          f"same-start E after iterations 1-2 differs by {early_rel} (limit {EARLY_ITER_RTOL})")
    check(gpu_launches > 0, "small scene on the card did not launch syrk_acc")

    # the streamed core on the same small scene: the card against the CPU
    # from one start, and the card's prefetch depths against each other
    small_start = perturbed_start(small, seed=5)
    s_early = LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=2)
    sy.reset_launch_counts()
    runs = {(dev, depth): bundle_adjust_streamed(*small_start, axis="x-up_z-forward",
                                                 config=s_early, chunk_size=128,
                                                 prefetch=depth, device=dev)
            for dev, depth in (("cuda", 2), ("cuda", 0), ("cpu", 2))}
    k1_small = sy.launch_counts["syrk_lower"]
    r_g, r_s, r_c = runs["cuda", 2], runs["cuda", 0], runs["cpu", 2]
    s_rel = abs(float(r_g.error) - float(r_c.error)) / float(r_c.error)
    same_bits = (float(r_g.error) == float(r_s.error)) and bool(torch.equal(r_g.X, r_s.X))
    small_streamed = {
        "E_gpu": float(r_g.error), "E_cpu": float(r_c.error), "E_rel_diff": s_rel,
        "rtol": EARLY_ITER_RTOL, "n_iter_gpu": r_g.n_iter, "n_iter_cpu": r_c.n_iter,
        "retries_gpu": r_g.log["n_solver_retries"], "retries_cpu": r_c.log["n_solver_retries"],
        "prefetch_0_vs_2_bit_identical": same_bits, "syrk_lower_launches_gpu": k1_small,
    }
    print("streamed_gpu_vs_cpu " + json.dumps(small_streamed), flush=True)
    check(s_rel < EARLY_ITER_RTOL, f"small streamed E differs by {s_rel:.3e}")
    check(r_g.n_iter == r_c.n_iter, "small streamed BA iterations differ")
    check(r_g.log["n_solver_retries"] == r_c.log["n_solver_retries"],
          "small streamed BA retries differ")
    check(same_bits, "streamed results differ between prefetch 0 and 2")
    check(k1_small > 0, "small streamed BA on the card did not launch syrk_lower")

    # the dense core from one start on each device, two iterations, on the
    # point side (12 views x 400 points) and the camera side (100 views x
    # 200 points: 3P = 600 < 9F = 900); then the dense pipeline on the
    # small scene on each device
    reset_launch_counts(fs, sy)
    two = LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=2, record_log=True)
    dense_small = {}
    for side, (nf, n_slices) in {"point": (12, 20), "camera": (100, 10)}.items():
        sc = make_synthetic_scene(torch.Generator().manual_seed(6), n_images=nf,
                                  n_slices=n_slices, n_angles=20, dtype=torch.float32)
        st = perturbed_start(sc, seed=6)
        r_g, r_c = (tba.bundle_adjust(*st, axis="x-up_z-forward", config=two, device=dev)
                    for dev in ("cuda", "cpu"))
        e_g, e_c = (r.log["reprojection_error"].cpu() for r in (r_g, r_c))
        dense_small[side] = {
            "points": st[0].shape[0], "views": nf, "n_iter_gpu": r_g.n_iter,
            "n_iter_cpu": r_c.n_iter, "E_gpu": e_g[1:].tolist(), "E_cpu": e_c[1:].tolist(),
            "E_rel_diff_iters_1_2": ((e_g[1:] - e_c[1:]).abs() / e_c[1:]).tolist(),
        }
    r_gpu = euclidean_reconstruction(small.x, method="dual", eig_method="lowrank", config=d_cfg)
    r_cpu = euclidean_reconstruction(small.x, method="dual", eig_method="lowrank", config=d_cfg,
                                     device="cpu")
    dense_small["pipeline"] = {
        "status_gpu": r_gpu.status, "status_cpu": r_cpu.status, "E_gpu": float(r_gpu.error),
        "E_cpu": float(r_cpu.error), "n_iter_gpu": r_gpu.n_iter, "n_iter_cpu": r_cpu.n_iter,
        "E_rel_diff": abs(float(r_gpu.error) - float(r_cpu.error)) / float(r_cpu.error),
        "E_rtol": FINAL_E_RTOL,
    }
    dense_small["launches_gpu"] = launch_counts(fs, sy)
    dense_small["point"]["rtol"] = EARLY_ITER_RTOL
    dense_small["camera"]["rtol"] = CAMERA_SIDE_RTOL
    print("dense_gpu_vs_cpu " + json.dumps(dense_small), flush=True)
    for side in ("point", "camera"):
        rec = dense_small[side]
        check(rec["n_iter_gpu"] == rec["n_iter_cpu"], f"dense BA ({side} side) iterations differ")
        check(max(rec["E_rel_diff_iters_1_2"]) < rec["rtol"],
              f"dense BA ({side} side) E differs by {rec['E_rel_diff_iters_1_2']} "
              f"(limit {rec['rtol']})")
    rec = dense_small["pipeline"]
    check(rec["status_gpu"] == rec["status_cpu"] == 0, "small dense pipeline status")
    check(rec["n_iter_gpu"] == rec["n_iter_cpu"], "small dense pipeline iterations differ")
    check(rec["E_rel_diff"] < FINAL_E_RTOL,
          f"small dense pipeline E differs by {rec['E_rel_diff']:.3e} (limit {FINAL_E_RTOL})")
    check(dense_small["launches_gpu"] == (0, 0), "the small dense runs launched a SYRK kernel")

    batched_gpu_vs_cpu(torch, fs, sy, d_cfg)
    robust_gpu_vs_cpu(torch, fs, sy, small, small_cfg)
    distortion_gpu_vs_cpu(torch, fs, sy)
    sparse_small = sparse_gpu_vs_cpu(torch, fs, sy, small)

    # the sparse phases' launches of either kernel, by phase: all zero
    def sparse_launches(i: int) -> dict:
        return {"4u": sparse_rec[("syrk_acc_launches", "syrk_lower_launches")[i]],
                "4v": {m: levers_rec[m][("syrk_acc_launches", "syrk_lower_launches")[i]]
                       for m in ("stored", "recompute", "bfloat16")},
                "4w": [entry_rec[m]["launches"][i] for m in (
                    "bal_distorted", "bal_triangulated", "bal_triangulated_distorted_reported")]
                + [entry_rec["resume_launches"][i]],
                "5": sparse_small["launches_gpu"][i]}

    # the command-line and reference-API phases' launches of either kernel
    # the point-sharded phases' launches of either kernel: 5a-5f, and 5g's
    # commands with --shard-points 1
    def sharded_launches_of(i: int) -> dict:
        key = ("syrk_acc_launches", "syrk_lower_launches")[i]
        return {**sharded_launches[key.removesuffix("_launches")],
                "5g": {"euclidean": eucl_rec["sharded"][key],
                       "reconstruct": recon_recs["float64_covariance_sharded"][key],
                       "bal": bal_recs["fisheye_sharded"][key]}}

    def cli_launches(i: int) -> dict:
        key = ("syrk_acc_launches", "syrk_lower_launches")[i]
        return {"launches_reconstruct": {m: r[key] for m, r in recon_recs.items()},
                "launches_bench_ba": {m: r[key] for m, r in bench_recs.items()},
                "launches_bundle_adjuster": api_rec["bundle_adjuster"][key]}

    # 6. result lines
    kernels = [{
        "name": "syrk_acc", "route": "cuda", "source": "mvrecon_tpu_torch/csrc/syrk_acc.cu",
        "replaces": "mvrecon_tpu/ops/pallas_schur.py:95",
        "launches": launches, "launches_dense_ba": d_launches[0],
        "launches_dense_pipeline": p_launches[0], "launches_bootstrap_pipeline": b_launches,
        "launches_robust_chunked": k2_robust, "launches_distorted_chunked": k2_distorted,
        "launches_sparse": sparse_launches(0),
        **cli_launches(0),
        "launches_sharded": sharded_launches_of(0),
        "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
        "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"], "max_rel_err": k2["max_rel_err"],
        "tolerance_rel": 1e-5, "shape": k2["shape"], "tflops": k2["tflops"],
        "design": K2_DESIGN,
        "at_bundle_adjuster": {key: k2_adjuster[key] for key in (
            "shape", "max_abs_err", "max_rel_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "tflops")},
    }, {
        "name": "syrk_lower", "route": "cuda", "source": "mvrecon_tpu_torch/csrc/syrk_lower.cu",
        "replaces": "mvrecon_tpu/ops/pallas_syrk.py:42",
        "launches": k1_launches, "launches_dense_ba": d_launches[1],
        "launches_dense_pipeline": p_launches[1], "launches_robust_streamed": k1_robust,
        "launches_opencv_chunked": k1_opencv, "launches_distorted_streamed": k1_distorted,
        "launches_family_chunked": {m: r["syrk_lower_launches"]
                                    for m, r in family_chunked.items()},
        "ms_median_in_family_chunked": {m: r["syrk_lower_ms_median"]
                                        for m, r in family_chunked.items()},
        "launches_full_opencv_streamed": full_streamed_rec["syrk_lower_launches"],
        "launches_bal": {m: r["syrk_lower_launches"] for m, r in bal_recs.items()},
        "launches_sparse": sparse_launches(1),
        **cli_launches(1),
        "launches_sharded": sharded_launches_of(1),
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"], "simt_bound_ms": k1["simt_bound_ms"],
        "max_rel_err": k1["max_rel_err"], "tolerance_rel": 1e-5, "shape": k1["shape"],
        "tflops": k1["tflops"], "design": K1_DESIGN,
        "at_nonfused_build": {key: k1_build[key] for key in (
            "shape", "layout", "max_abs_err", "max_rel_err", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "tflops")},
    }]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
