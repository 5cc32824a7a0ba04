#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU and check them:
sphere2500 through the whole-solve CG kernel, a 100k-pose graph through
the fused (Chronopoulos-Gear) CG kernel, the same two graphs over SO3,
RxSO3 and Sim3 through those kernels' t = 3, 4 and 7 instantiations,
Euclidean rings of 2, 5, 9 and 16 coordinates through their runtime-t
instantiation, ICP
on 100k-point clouds through the nearest-neighbour kernel, knn(k=8) on
those clouds through the k-nearest kernel, knn on 6-coordinate clouds, and
the general factor-graph routes (no kernel): a chain-dominated and three
random-loop pose graphs, and the inputs the stencil kernels do not take;
then the Lie core's autograd and the paths it opens: Jacobians by
autodiff and robust kernels in SparseLM through the whole-solve kernel,
and the reprojection pose graph; then bundle adjustment in both Schur
modes (no kernel on its path); then IMU preintegration at a million
frames, the dense optimizers (4,096 problems batched), SparseLM's
Adaptive strategy and the point-cloud filters; then LSTSQ on the card,
EPnP at 10,000 problems, the EKF, UKF and PF over 1,000 steps and MPC on
the cart-pole (no kernel on these paths); then trajectory evaluation
(APE/RPE) of a solved sphere2500 graph and of a EuRoC-sized trajectory
pair, SE3 B-splines over 60,000 control poses, a block-sparse E E^T at
ba-trafalgar's size and the 15 examples (no kernel on these paths but
the whole solve's); then knn on descriptor clouds (33 and 128
coordinates) through the nearest-neighbour kernels' wide scans, nnk at
k > 16 (normal estimation, outlier removal and FPFH neighbourhoods at 100k
points, descriptors, k up to N), and the sharded optimizers (parallel/)
at one NCCL rank and at two gloo ranks on the one card (no kernel on
that path).

Phases (any failure raises, so the script exits non-zero):
  1. device: needs torch.cuda; prints nvidia-smi's name and power limit;
     turns TF32 off.
  2. build: compiles pypose_tpu_torch/csrc/stencil_cg{,_tiled,_fused}.cu,
     knn.cu and se3.cu, one nvcc each, all at once (timed as set-up);
     prints ptxas' registers and shared memory (knn.cu: for D = 3 and 8,
     the wide scans and their split pre-pass, every k > 16 scan and the
     select path's kernels), and
     the HGMMA instructions in the float32 wide scans' SASS (cuobjdump),
     which must be there, as many in each of the eight instantiations
     (nn1, the lists of 2-16, past 16, and the select path's counting
     passes and emission), and the DMMA instructions in the float64 ones'
     (past 16, counting passes, emission: three, as many in each); a
     C7520 (serialized wgmma) in ptxas' output fails.
  3. kernel vs plain, on the same random SPD stencil systems on the card,
     each timed with CUDA events (median of 7):
     - the whole-solve cluster kernel at N=40, at sphere2500's shape
       (N=2500, offsets (1, 157), node 0 fixed; converged, and to a
       150-iteration cap), and at N=20,000 (operands in L2, converged and
       to 150 iterations);
     - the fused solver with float32 and with bf16 operands (the plain
       version on the same bf16-rounded operands), and the tiled solver
       beside it, at N=53 (offsets wrap), at the 100k shape (offsets (1,
       993), node 0 fixed) with tol 1e-3 / maxiter 250 and with tol 0 /
       250 iterations, and at N=200,000, past the fused kernel's
       shared-memory mode; the fused kernel's two launches must give the
       same bits, and its device time per solve comes from torch.profiler;
     - the tiled matvec and block-Jacobi kernels alone, one launch each,
       at the 100k shape, with their device time (torch.profiler) and the
       block-Jacobi apply also as one torch.einsum; the tiled solve and
       its two kernels against the fused solve per iteration at t = 6, 7,
       9 and 16 (no route changes);
     - the same three sources at block sizes t = 3, 4 and 7 (SO3, RxSO3,
       Sim3; their templates) and t = 1, 2, 5, 9 and 16 (the runtime-t
       instantiation): the whole solve at N=40 and at sphere2500's shape
       (converged and to 60 iterations, two launches bit-equal; operands
       in shared memory to t = 8, in L2 from t = 9), the tiled and fused
       (float32, bf16) solvers at N=53 and at the 100k shape (tol 1e-3
       and 60 iterations; the fused plan printed: shared-memory mode to
       t = 6, global-memory mode from t = 7), the tiled kernels alone;
       every other t from 1 to 17 at N=40 / 53 alone; the runtime-t
       instantiation forced at t = 3 and 6 (any_t=True) bit for bit
       against the templates and timed beside them (device time); t = 0
       must raise before any launch;
     - nn1 at 100k x 100k on ICP's clouds and on a cloud with duplicated
       points, and nnk at k = 4 and 16 on a 20k x 100k slice of them,
       under pypose_tpu_torch.testing.nnk_tolerance_failures (each index
       the plain one or a near-tie, distinct within a row, each d^2
       within 1e-6 (|a|^2 + |b|^2) + 1e-6 of its pair's float64 d^2),
       with chunked torch.cdist + torch.min (nn1) or torch.topk (nnk)
       timed beside them (two calls a chunk of 64 Mi pairs);
     - se3_mul/se3_act at N = 100,000 and 100,003, within
       1e-6 (1 + max|input|); timed per call over 50 calls and, with
       torch.profiler, by the device time of their kernels.
  4. sphere2500 slice: data/synthetic_sphere2500_seed42.g2o through
     load_g2o, split_chain_edges, pgo_factor and two SparseLM.optimize
     phases (cg_iter 150 then 1200, cg_tol 1e-9), cold then warm; the
     final chi2 must reach pypose's converged chi2
     (data/ref_anchor_sphere2500.json) within 1e-4 relative, and the
     whole-solve kernel must have been launched; prints the CG iterations
     per solve of each phase, and a third, profiled run gives the
     whole-solve kernel's share of the run's device time and wall time.
  5. pgo-100k slice: synthetic_sphere(100000, seed=42) (checked against
     data/jax_anchor_pgo100k_seed42.json's instance checksum), factors as
     bench.py:bench_pgo_100k builds them, SparseLM with TrustRegion(1e4),
     cg_iter 250, cg_tol 1e-3, optimize(steps=6), cold then warm; the
     final chi2 must be within 1e-3 relative of the JAX package's on the
     same instance, the fused kernel must have been launched once per
     solve and neither the tiled nor the whole-solve kernels; a third,
     profiled run gives the fused kernel's share of device time and the
     device's idle share.
  5b. groups: testing.pgo_group_instance of the sphere2500 graph and of
     synthetic_sphere(100000, seed=42) over SO3, RxSO3 and Sim3 (rotations
     only; scale 1 lifted, the initial scales drifted by exp(0.05 N(0,
     1))), each through testing.pgo_optimizer with its anchor file's
     schedule (data/jax_anchor_{so3,rxso3,sim3}_{sphere2500,100k}.json),
     cold then warm: route 'stencil', the whole-solve kernel (sphere2500)
     or the fused kernel (100k) launched once a solve and the other not
     at all, chi2 first step within 1e-4 and final within 1e-3 of the JAX
     anchor, ms per LM step; sim3-sphere2500 also profiled (kernel share,
     idle share).  Then bench.py:bench_pgo_groups' SO3 and Sim3
     ring-plus-random-loops instances at N = 10,000
     (testing.pgo_loops_instance): route 'einsum', no launch, chi2 down
     by at least 1e3 times.
  6. ICP, card against CPU: the same 9,000-point instance (81M pairs, the
     auto-tiled knn route) on the card (nn1 kernel) and on the CPU (the
     chunked Gram path, which the CPU tests hold against the JAX
     package), 8 sweeps each; transforms within 1e-5 in
     |Log(T_card^-1 T_cpu)|_inf.
  7. ICP slice: bench.py:bench_modules' ICP (100,000 points x 3 scaled by
     5.0, target T.Act(src) with T = randn_SE3(sigma=(0.3, 0.05)),
     ReduceToBason(steps=8, patience=8, tol=1e-9)), cold then warm: ms per
     run and per sweep, sweeps, align error |Log(T_est^-1 T)|_inf <= 1e-4,
     and nn1 launched on every sweep of the cold run.
  8. knn-k8: pypose_tpu_torch.knn(src, tgt, k=8) on ICP's 100k-point
     clouds, one nnk launch, held to the tolerance rule against the plain
     version; timed beside the torch path it replaces on CUDA (matmul and
     a stable sort a chunk) and chunked torch.cdist + torch.topk.
  9. knn-d6: knn(ref, nbr, k=1) and k=8 on [10000, 6] float32 clouds
     (torch.Generator seed 0; 1e8 pairs, the auto-tiled route), one nn1
     and one nnk launch, held to the near-tie rules against the plain
     versions and timed beside chunked torch.cdist + torch.min / topk;
     then the same clouds in float64 through the kernels' float64
     instantiation, held to the rules at rtol = atol = 1e-13.
 10. sparse-f64: synthetic_sphere(100) in float64 (four step() calls,
     route 'einsum', no kernel), a Euclidean [64, 3] ring factor
     (testing.ring3_problem, t = 3, three calls: route 'stencil', one
     whole-solve launch a solve on the card) and the same ring at t = 5
     ('stencil' too, the runtime-t instantiation), card against CPU.
 10b. stencil-any-t: testing.ring3_problem at (N, t) = (2500, 9), (100000,
     9), (100000, 2), (100000, 5), (2500, 16) in float32, three step()
     calls each: route 'stencil' through the runtime-t instantiation (the
     whole solve with its operands in L2 at (2500, 9), (100000, 2) and
     (2500, 16); the fused solver with its state in global memory at
     (100000, 9) and in shared memory at (100000, 5)), one launch a solve, the final chi2 within 1e-4 and the
     points within 1e-4 of the same instance through
     SparseLM(matvec='generic') on the card (no kernel); ms a step and the
     kernel's device ms a solve.
 11. pgo-chain: synthetic_sphere(5000, loops_per_pose=0.04, seed=5),
     bench.py:bench_pgo_chain's factors and schedule (route 'chain': the
     einsum CG with the block cyclic reduction preconditioner), and
     pgo-loops: testing.pgo_loops_instance(10000) (bench.py:
     bench_pgo_groups' topology over SE3; route 'einsum' through
     CouplingSpMV), each cold, warm and profiled: 0 kernel launches, chi2
     against its JAX anchor (data/jax_anchor_pgo_chain5k_seed5.json: the
     first step within 3e-4, the final within 1e-2; data/
     jax_anchor_pgo_loops10k.json: entries above 1e-3 within 1e-3, the
     final below 1e-5 of the initial chi2), ms per LM step, CG host
     reads, device operations per LM step and the device's idle share.
 13. autograd: the 32 autograd Functions of lietensor/operation.py at a
     batch of 100,000 on the card against the CPU in float64 (inputs from
     testing.autograd_inputs): the forward, a VJP with a random cotangent
     and a torch.func.jvp, in float64 (within 1e-9 of 1 + max|CPU|, Sim3
     1e-8) and float32 (1e-5, Sim3 1e-4), each op's largest error printed;
     bench.py:130-139's micro-jacrev, vmap(jacrev(SE3(X).Act(p))) at 100k,
     held to [I, skew(-out), 0], ms per call and Jacobians/s.
 14. sphere2500-autodiff: the first step's autodiff J blocks against
     se3_pgo_blocks on the card (1e-5 of 1 + max|J|); then sphere2500
     through bench.py:199-205's two-phase schedule (testing.two_phase)
     with residual-only factors, cold then warm: route 'stencil',
     whole-solve launches only (one a solve), the final chi2 at pypose's
     anchor, ms per LM step beside the closed form's from phase 4.
 15. sim3-sphere2500-autodiff: phase 5b's sim3-sphere2500 with
     residual-only factors, held to its JAX anchor as 5b holds it.
 16. sphere2500-huber: the closed form and the residual-only factor, both
     with Huber(delta=5), the two-phase schedule, cold then warm: route
     'stencil', whole-solve launches only, first step within 1e-4 and
     final within 1e-3 of data/jax_anchor_sphere2500_huber.json, the
     final at pypose's anchor.
 17. reproj-pgo: testing.reproj_pgo_instance (examples/reproj_pgo.py at
     2,500 poses and 7,500 landmarks) on the card (cold, warm) and on the
     CPU: route 'einsum', no kernel; first step within 1e-4 and final
     within 1e-3 of data/jax_anchor_reproj_pgo.json, card against CPU
     alike.
 18. ba-anchored: the JAX package's C=16, P=300 instance
     (data/jax_instance_bal_16_300.npz) through BundleAdjustment with
     TrustRegion(1e4), no gauge, optimize(20, 5, 1e-4) (bench.py:475-480;
     dense Schur), cold then warm: some step at pypose's chi2 352.88898
     (+1e-3, data/ref_anchor_bal_16_300.json), the step printed.
 19. ba-trafalgar: testing.ba_instance('ba-trafalgar') (synthetic_bal at
     257 cameras, 65,132 points, 225,911 observations; checksum against
     data/jax_anchor_ba_trafalgar.json), dense Schur with camera windows,
     bench.py:370-385's schedule, cold, warm and profiled: no kernel
     launched, the first accepted step within 3e-4 and the final within
     1e-3 of the JAX anchor; ms per LM step, RMSE, rejections, host
     reads, idle share; the Gram (optim.ba.schur_gram) and the Cholesky
     timed alone at the cell's shape, their share of device time, the
     Gram's bound and one library call beside it.
 20. ba-large: synthetic_bal at C=2048, P=49,152, 6 observations a
     point: schur='auto' routes to Schur-CG with camera windows;
     bench.py:414-442's schedule, cold, warm and profiled; first accepted
     step and final within 1e-3 of data/jax_anchor_ba_large.json; ms per
     LM step, CG iterations and host reads per step, rejections, idle
     share.
 21. ba-autodiff-huber: bench.py:318-342's C=64, P=8000 problem with
     Huber(5) and a copy of reproj_residual_bal (Jacobians by
     vmap(jacrev)): chi2 per step on the card within 1e-5 of the CPU's;
     its Jacobians against the closed form's on the card (1e-5 of
     max|J|); the closed form cold and warm beside it.
 23. imu-1m: bench.py:bench_imu at B = 1, F = 1,000,000 (float32,
     IMUPreintegrator(reset=True, prop_cov=True); no kernel), cold, warm
     (median of 3) and profiled: ms a call, frames/s, device idle share
     and operations a call; the last frame's rot, vel, pos and 9x9 cov
     against data/jax_anchor_imu_1m.json (twice the port's CPU spread
     plus 1e-6 of each quantity's magnitude) and against the port's CPU
     run (1e-5 of the magnitude), and |q| beside the anchor's 0.99120563.
 24. imu-synth: testing.imu_instance('synth', 100_000) in two halves with
     reset=False: card against CPU in float32 (outputs and carried state,
     Rij included), and in float64 against one call (rot, vel, pos, Rij).
 25. batch-lm: bench.py:bench_batch_lm (4,096 PoseInvB problems, 4 steps,
     Constant(1e-6), testing.batch_lm_instance(4096, 7)), cold, warm and
     profiled: problems/s, max loss, no host read inside the solve
     (sync debug mode 'error'), each loss against
     data/jax_anchor_batch_lm.json and the CPU, no kernel.
 26. dense-lm: a PoseInv module through LM and StopOnPlateau (the loss
     from ~1 to below 1e-6 within 5 steps), GN and make_batch_optimizer
     card against CPU.
 27. sparse-strategies: sphere2500 through SparseLM with Adaptive() (phase
     4's capped CG: chi2 within 1e-3 of the CPU's) and with
     Adaptive(damping=1e-2) (converged CG: within 1e-5) for three steps
     each: route 'stencil', one whole-solve launch a solve.
 28. filters: nbr_filter, knn_filter, voxel_filter (mean and random) and
     random_filter on 4,096 points, card against CPU.
 29. lstsq: what torch.linalg.lstsq (gels) does on the card at 6 x 10 and
     on rank-4 6 x 6 systems, recorded; LSTSQ's SVD route against the
     CPU's within 1e-5.
 30. epnp, epnp-refine: testing.epnp_instance (bench.py:523-545's shapes
     and intrinsics, numpy-drawn) through EPnP at B = 10,000 and refined
     at B = 16, cold, warm and profiled: poses/s, pose errors, candidate
     flips, held by testing.epnp_failures to data/jax_anchor_epnp.json
     and to the port's CPU run; no kernel.
 31. ekf, ukf, pf: filter_rollout over testing.filter_instance(1000)
     (bench.py:776-805's pendulum), cold, warm and profiled: steps/s,
     held by testing.filter_failures to data/jax_anchor_filters.json (the
     PF by its RMSE) and to the CPU run (the PF in float64 on the same
     draws); no kernel.
 32. mpc, mpc-ls: the cart-pole (bench.py:549-600) at T = 32 and at
     T = 128 with the line search, cold, warm and profiled: ms a solve,
     host reads, cost and tail max|theta| held by testing.mpc_failures
     to data/jax_anchor_mpc.json and to the CPU run; no kernel.  The
     tiled kernels' rows also carry their device time with L2 flushed
     before each launch (phase 3).
 33. traj-eval: synthetic_sphere(2500) through optim.sparse.pgo with
     examples/pgo.py's schedule (route 'stencil', whole-solve launches),
     testing.SPHERE_METRICS (APE aligned and Sim3-aligned in degrees, RPE
     by frames and by 5 m of path) on the solved poses card against CPU
     and on the initial poses against data/jax_anchor_metric.json; then
     testing.euroc_instance() (36,000 reference poses at 200 Hz, 3,600
     estimated at 20 Hz, +-2 ms jitter) through testing.EUROC_METRICS
     (Sim3-aligned APE, all-pairs RPE at 1 m), cold, warm and profiled,
     against the anchor and the CPU (testing.metric_failures).
 34. spline: bspline over 60,000 SE3 control poses at interval 0.1
     (599,971 poses), with extrapolate=True, and chspline over 60,000
     waypoints (599,991 points), cold, warm and profiled, held by
     testing.spline_failures to data/jax_anchor_spline.json and the CPU.
 35. bsr: E = J_c^T J_p of ba-trafalgar's initial state (224,821 blocks
     of 6 x 3) as BSR, E^T as BSC: bsr_bsc_matmul(E, E^T) (792,959 block
     pairs, the dense 1,542 x 1,542 product) and bsr_matvec, cold, warm
     and profiled, the host's pair list timed alone; two card runs bit
     for bit, within BSR_RTOL of |E| |E|^T of scipy's float64 product and
     of the CPU's.
 36. examples: the 15 scripts of pypose_tpu_torch/examples/ on the card
     at their default sizes, one subprocess each, EXAMPLE_WORKERS at a
     time (their output printed); each exits 0, pgo takes the stencil
     route and prints its APE RMSE.
 37. (run after 9.) knn-wide: nn1 and nnk(k=8) through the wide scans
     of csrc/knn.cu on FPFH-like clouds (33 coordinates, 50,000 x 50,000)
     and SIFT-like clouds (128, 20,000 x 100,000; also nnk(k=2), the
     ratio test) in float32 (on the tensor cores) and FPFH-like float64
     clouds (10,000 x 10,000; DMMA), each held to its plain version by
     the near-tie rule, timed beside the plain version and chunked
     torch.cdist + torch.min / topk, the device time of each traced in a
     fresh process; knn(k=1) and knn(k=8) on the D = 33 clouds launch one
     nn1 and one nnk, in float32 and in float64.
 37b. knn-bigk: nnk at k > 16 (the lists off the registers, and the
     select-then-sort paths from ops.knn.select_k(dtype, R, D) on and at
     k = N: each case's path, kernels and scratch printed), each case
     once through knn()
     from zeroed counts (one nnk launch): k = 30, 50 and 100 on ICP's
     100k target against itself (normal estimation, outlier removal,
     FPFH neighbourhoods) and k = 1024 (beside the route it replaced),
     k = 30 and 1024 on [knn-d6]'s clouds in float64 (the merge scan;
     the select path), k = 32 and 1024 on [knn-wide]'s FPFH and SIFT
     clouds in float32 (tensor cores: the merge scan; the wide select)
     and on its float64 FPFH clouds (DMMA: the merge scan; the wide
     select), k = 100 on 10,000 SIFT-like
     queries against 1,000,000 (ANN-Benchmarks' sift-128-euclidean
     ground truth's shape; the plain version on every 10th row); through
     ops.knn.nnk, k = 1024 on 10,000 x 100,000, k = N on 4096 x 4096
     points and on 4096 FPFH-like points (float32 and float64); each
     held to the plain version
     by the near-tie rule (its largest d^2 error over the tolerance
     printed), each wide select bit for bit to the tensor-core merge
     scan forced at the same k (ops.knn._nnk_wide_merge, timed beside),
     timed with L2 flushed, its device time traced in a fresh process,
     beside the plain version, the chunked Gram route k > 16 took before
     and chunked torch.cdist + torch.topk, and its bound.
 38. (38.-40. run after 32.) sharded-pgo: parallel.ShardedPGO on
     data/synthetic_sphere2500_seed42.g2o with examples/pgo.py's schedule,
     10 steps, at one rank (an NCCL
     group of one) against SparseLM(matvec='generic', scatter=False) (1e-5
     each step) and data/jax_anchor_sharded_pgo.json (1e-3), and at two
     gloo ranks sharing the card (spawned processes) against the one-rank
     run (1e-4 each step, the ranks' nodes bit-equal); ms a step,
     all_reduce calls a step, idle share; no kernel on the path.
 39. sharded-ba: parallel.ShardedBA on ba-trafalgar (dense Schur, the
     cell's schedule) at one rank and at two gloo ranks, held by accepted
     steps (accepted_hold: the last accepted chi2 within 2e-2 of the
     reference's after as many, at most one accepted step short) to the
     card's BundleAdjustment and to data/jax_anchor_ba_trafalgar.json, the
     ranks' states bit-equal; ms a step; the JAX ShardedBA's final
     (data/jax_anchor_sharded_ba.json) printed beside.
 40. sharded-steps: make_pgo_step (sphere2500) and make_ba_step
     (ba-trafalgar), two steps: chi2 falling in float32 (timed), card
     against CPU in float64 (1e-4; in float32 the raw steps move with the
     order of their sums alone, up to 1.6e-3 on the CPU);
     sharded_stencil_matvec at one rank against StencilSpMV.matvec at the
     pgo-100k shape (1e-6 of max|y|, no message).
 41. prints the kernels' JSON line (each kernel's, each of the t = 3,
     4, 7 instantiations', and the runtime-t instantiations' (t = 9, the
     other t in `cases`, their cost against the templates at t = 3 and 6
     in `runtime_t_cost`), launches on its path,
     error, ms, plain ms, bound_ms from this run's shapes and iteration
     counts at 3.35 TB/s and 67 TFLOP/s float32 (the float32 wide scans
     at three TF32 passes' 165 TFLOP/s), bound_by, library_ms;
     nn1 and nnk also at D = 6, bound at 2 D flop a pair, in float32 and
     in float64 at 67 TFLOP/s; the whole solve's launches on each
     sphere2500 path, launches_by_path), the card line and the result
     line.

Run from the repository root:  python3 chip_smoke.py
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.abspath(__file__))


# Published peaks of one H100 SXM (NVIDIA's data sheet, 700 W): device
# memory, and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def bound(n_bytes, n_flop, flop_per_s=FP32_FLOP_PER_S):
    """The least time the card could take for work that must move
    ``n_bytes`` (each input read once, each output written once) and do
    ``n_flop`` operations at ``flop_per_s`` (float32 by default): (ms,
    'bytes' or 'operations')."""
    b_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    o_ms = 1e3 * n_flop / flop_per_s
    return (b_ms, 'bytes') if b_ms >= o_ms else (o_ms, 'operations')


def cuda_ms(fn, repeat=7):
    """Median milliseconds of ``fn()`` between CUDA events."""
    import torch
    times = []
    out = None
    for _ in range(repeat):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def device_ms(fn, calls=50, match=None):
    """Device time per call of ``fn`` in ms: the sum of the times of the
    kernels (those whose name holds ``match``, if given) that
    torch.profiler records over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # the tracer now and then hands back an empty trace (seen once, on a
    # trace of 50 launches of a 2 us kernel, the 13th trace of its run), or
    # one short of launches (a tiled apply's L2-flushed reading of 12.54 us
    # beside 57.41): trace again, up to three times, and with `match` until
    # it records one matched launch a call; never return a short reading
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if not e.key.startswith('aten::')
                  and (match is None or match in e.key)]
        total_us = sum(e.device_time_total for e in events)
        if total_us > 0 and (match is None
                             or sum(e.count for e in events) == calls):
            return total_us / calls / 1e3
    raise RuntimeError(
        'torch.profiler recorded no device time in three traces' if match
        is None else f'torch.profiler recorded no trace of one {match!r} '
        f'launch a call in three traces of {calls} calls')


def stencil_system(N, loop_offset, n_loops, fixed, t=6):
    import torch
    from pypose_tpu_torch.testing import random_stencil_system
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(
        1234 + N + (0 if t == 6 else t))
    return random_stencil_system(N, loop_offset, n_loops, fixed, gen, dev,
                                 t=t)


def solver_vs_plain(name, solver, plain, system, maxiter, tol):
    """One solver on the card against its plain version on the same
    operands (the block size t read from their shapes): x within 1e-4 of
    max|x| (+1e-5), iterations within one.  Returns (max error, kernel ms,
    plain ms, kernel iterations)."""
    import torch
    offsets, ops = system
    t, N = ops[0].shape
    plain_runs = 7 if t == 6 else 3
    k_ms, (x_k, it_k) = cuda_ms(
        lambda: solver(*ops, offsets, t, maxiter, tol))
    p_ms, (x_p, it_p) = cuda_ms(
        lambda: plain(ops[1], ops[2], ops[3], ops[0], offsets, t, maxiter,
                      tol), repeat=plain_runs)
    it_k, it_p = int(it_k), int(it_p)
    err = float((x_k - x_p).abs().max())
    bound = 1e-4 * float(x_p.abs().max()) + 1e-5
    print(f'[kernel] {name}: t={t} N={N} offsets={offsets} '
          f'maxiter={maxiter} '
          f'tol={tol:g}: iterations kernel {it_k} plain {it_p}; '
          f'max|x_k - x_p| {err:.3e} (bound {bound:.3e}); kernel '
          f'{k_ms:.4f} ms/solve ({1e3 * k_ms / max(it_k, 1):.2f} us/it), '
          f'plain {p_ms:.4f} ms/solve ({1e3 * p_ms / max(it_p, 1):.2f} '
          f'us/it), median of 7 (plain: of {plain_runs})', flush=True)
    check(bool(torch.isfinite(x_k).all()), f'{name}: kernel result not finite')
    check(err <= bound, f'{name}: kernel disagrees with the plain version')
    check(abs(it_k - it_p) <= 1, f'{name}: iteration counts differ')
    return err, k_ms, p_ms, it_k


def whole_solve_vs_plain(name, N, loop_offset, n_loops, fixed, maxiter,
                         tol, t=6):
    """The cluster kernel at block size t against its plain version, and a
    second launch that must repeat it bit for bit; returns (err, ms, plain
    ms, iterations)."""
    import torch
    from pypose_tpu_torch.ops import stencil_cg as scg
    system = stencil_system(N, loop_offset, n_loops, fixed, t)
    offsets, ops = system
    smem = scg.stencil_cg_smem_fits(N, t, len(offsets))
    check(scg.stencil_cg_fits(N, t, len(offsets)),
          f'N={N} is past the whole-solve kernel\'s budgets')
    where = 'shared memory' if smem else 'L2'
    out = solver_vs_plain(
        f'whole-solve, {name}, operands in {where}',
        scg.stencil_cg_transposed, scg._cg_body_torch, system, maxiter, tol)
    x1, it1 = scg.stencil_cg_transposed(*ops, offsets, t, maxiter, tol)
    x2, it2 = scg.stencil_cg_transposed(*ops, offsets, t, maxiter, tol)
    check(torch.equal(x1, x2) and int(it1) == int(it2),
          f'whole-solve, {name}: two launches differ')
    return out


def fused_vs_plain(name, system, maxiter, tol, operand_dtype):
    """The fused kernel with float32 or bf16 operands against its plain
    version on the same stored operands (bf16: rounded, then widened), as
    solver_vs_plain holds it, and a second launch that must repeat it bit
    for bit; returns (err, ms, plain ms, iterations)."""
    import torch
    from pypose_tpu_torch.ops import stencil_cg as scg
    offsets, (b_T, *ops) = system
    t = b_T.shape[0]
    stored = scg.round_operands(*ops, operand_dtype)
    widened = [a.float() for a in stored]

    def fused(*args):
        return scg.stencil_cg_fused(b_T, *stored, *args[4:],
                                    operand_dtype=operand_dtype)
    out = solver_vs_plain(name, fused, scg._fused_cg_torch,
                          (offsets, (b_T, *widened)), maxiter, tol)
    x1, it1 = fused(*system[1], offsets, t, maxiter, tol)
    x2, it2 = fused(*system[1], offsets, t, maxiter, tol)
    check(torch.equal(x1, x2) and int(it1) == int(it2),
          f'{name}: two launches differ')
    return out


def oversize_solvers_vs_plain(name, system, maxiter, tol):
    """The tiled and the fused solver (float32 and bf16 operands) on one
    system, each against its plain version; returns {route: (err, ms,
    plain ms, iterations)} for routes 'tiled', 'fused', 'fused_bf16'."""
    import torch
    from pypose_tpu_torch.ops import stencil_cg as scg
    t, N = system[1][0].shape
    plan = scg.fused_plan(N, t, system[1][0].device)
    print(f'[kernel] {name}: fused kernel plan at t={t}: {plan} (state in '
          f'{"shared" if plan["smem"] else "global"} memory)', flush=True)
    out = {
        'tiled': solver_vs_plain(f'tiled, {name}', scg.stencil_cg_tiled,
                                 scg._tiled_cg_torch, system, maxiter, tol),
        'fused': fused_vs_plain(f'fused f32, {name}', system, maxiter, tol,
                                None),
        'fused_bf16': fused_vs_plain(f'fused bf16, {name}', system, maxiter,
                                     tol, torch.bfloat16)}
    t_ms, t_it = out['tiled'][1], out['tiled'][3]
    for route in ('fused', 'fused_bf16'):
        f_ms, f_it = out[route][1], out[route][3]
        print(f'[kernel] {name}: {route} {f_ms:.4f} ms/solve ({f_it} it, '
              f'{1e3 * f_ms / max(f_it, 1):.2f} us/it) vs tiled {t_ms:.4f} '
              f'ms/solve ({t_it} it, {1e3 * t_ms / max(t_it, 1):.2f} us/it): '
              f'{route}/tiled {f_ms / t_ms:.3f}', flush=True)
    return out, plan


# the block sizes at which the tiled solve is timed against the fused one
# per iteration (the 100k shape: t = 6 at 250 iterations, phase 3's own;
# the others block_size_kernels' 60)
TILED_VS_FUSED_T = (6, 7, 9, 16)


def tiled_vs_fused(runs):
    """The tiled solve against the fused solve per iteration at the 100k
    shape, from ``runs`` = {t: (oversize_solvers_vs_plain's routes at
    the cap, tiled_kernels_vs_plain's)}: the whole tiled solve (CUDA
    events: its two kernels and the CG state's torch ops, a host read
    every CHECK_EVERY iterations) and its two kernels' device time alone
    (L2 flushed, warm) against the fused solve (float32 operands); prints
    one line a t and returns {t: us an iteration by what}."""
    out = {}
    for t, (routes, alone) in runs.items():
        (_, t_ms, _, t_it), (_, f_ms, _, f_it) = routes['tiled'], \
            routes['fused']
        row = {'tiled_solve_us': 1e3 * t_ms / max(t_it, 1),
               'tiled_kernels_flushed_us': alone['mv'][5] + alone['pc'][5],
               'tiled_kernels_warm_us': alone['mv'][4] + alone['pc'][4],
               'fused_us': 1e3 * f_ms / max(f_it, 1),
               'iterations': (t_it, f_it)}
        print(f'[kernel] tiled vs fused solve, 100k shape, t={t}, us an '
              f'iteration: tiled solve {row["tiled_solve_us"]:.2f} (its '
              f'kernels alone {row["tiled_kernels_flushed_us"]:.2f} L2 '
              f'flushed, {row["tiled_kernels_warm_us"]:.2f} warm) vs fused '
              f'{row["fused_us"]:.2f} ({t_it} and {f_it} iterations): '
              f'kernels / fused {row["tiled_kernels_flushed_us"] / row["fused_us"]:.3f} '
              f'flushed, solve / fused '
              f'{row["tiled_solve_us"] / row["fused_us"]:.3f}', flush=True)
        out[t] = row
    return out


def fused_device_ms(system, maxiter, tol):
    """Device time of one fused solve (torch.profiler, the kernel alone,
    over 5 solves) with float32 and with bf16 operands; returns {route:
    ms}."""
    import torch
    from pypose_tpu_torch.ops import stencil_cg as scg
    offsets, (b_T, *ops) = system
    out = {}
    for route, dtype in (('fused', None), ('fused_bf16', torch.bfloat16)):
        stored = scg.round_operands(*ops, dtype)
        out[route] = device_ms(
            lambda: scg.stencil_cg_fused(b_T, *stored, offsets, 6, maxiter,
                                         tol, operand_dtype=dtype),
            calls=5, match='fused_pcg')
        print(f'[kernel] {route}, 100k shape, {maxiter} iterations: device '
              f'time {out[route]:.4f} ms/solve (torch.profiler, the kernel '
              'alone)', flush=True)
    return out


def tiled_kernels_vs_plain(system, launches=20):
    """The tiled matvec and block-Jacobi kernels alone, one launch each on
    a random vector, against their plain versions; times are per launch
    (CUDA events over ``launches`` launches, median of 7).  The
    block-Jacobi apply is also timed as one PyTorch call (``torch.einsum``
    over the [t, t, N] blocks); no one call computes the stencil matvec.
    Each kernel's device time per launch comes from torch.profiler, warm
    (its operands stay in the 50 MB L2 across the repeated launches) and
    with L2 flushed before each launch (a 128 MB buffer zeroed; only the
    kernel's own time counted), so that the flushed time is read against
    the bytes the launch must move.  Returns {kernel: (err, us, plain us,
    library us or None, device us, device us with L2 flushed)}."""
    import torch
    from pypose_tpu_torch.ops import stencil_cg as scg
    offsets, (b_T, A_T, Minv_T, C_T) = system
    t = b_T.shape[0]
    gen = torch.Generator(device=b_T.device).manual_seed(7)
    v = torch.randn(b_T.shape, generator=gen, device=b_T.device)
    M3 = Minv_T.view(t, t, -1)
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=v.device)
    pairs = {
        'mv': (lambda: scg._tiled_mv_launch(A_T, C_T, v, offsets, t),
               lambda: scg._stencil_matvec_torch(A_T, C_T, offsets, t, v),
               None, 4 * (t * t * (1 + len(offsets)) + 2 * t)),
        'pc': (lambda: scg._tiled_pc_launch(Minv_T, v, t),
               lambda: scg._block_mul(Minv_T, v, t),
               lambda: torch.einsum('iun,un->in', M3, v),
               4 * (t * t + 2 * t))}
    out = {}
    for kname, (kern, plain, library, bytes_per_node) in pairs.items():
        k_ms, y_k = cuda_ms(lambda: [kern() for _ in range(launches)][-1])
        p_ms, y_p = cuda_ms(lambda: [plain() for _ in range(launches)][-1])
        err = float((y_k - y_p).abs().max())
        bound = 1e-5 * float(y_p.abs().max()) + 1e-6
        k_us, p_us = 1e3 * k_ms / launches, 1e3 * p_ms / launches
        l_us = None
        if library is not None:
            l_ms, y_l = cuda_ms(
                lambda: [library() for _ in range(launches)][-1])
            l_us = 1e3 * l_ms / launches
            check(float((y_l - y_p).abs().max()) <= bound,
                  f'tiled {kname}: the library call disagrees')
        d_us = 1e3 * device_ms(kern)
        f_us = 1e3 * device_ms(lambda: (flush.zero_(), kern()),
                               match=f'tiled_{kname}')
        gbs = bytes_per_node * v.shape[1] / (d_us * 1e3)
        print(f'[kernel] tiled {kname} alone, t={t} N={v.shape[1]}: '
              f'max|y_k - y_p| {err:.3e} (bound {bound:.3e}); kernel {k_us:.2f} '
              f'us/launch, device time {d_us:.2f} us/launch ({gbs:.0f} GB/s '
              f'if every operand and vector '
              f'byte is read or written once: {bytes_per_node} B/node), '
              f'{f_us:.2f} us with L2 flushed before each launch '
              f'({bytes_per_node * v.shape[1] / (f_us * 1e3):.0f} GB/s), '
              f'plain {p_us:.2f} us, one library call '
              f'{"none" if l_us is None else f"{l_us:.2f} us"}', flush=True)
        check(err <= bound, f'tiled {kname} disagrees with its plain version')
        out[kname] = (err, k_us, p_us, l_us, d_us, f_us)
    return out


# each kernel module's launch counters
COUNTERS = {
    'stencil_cg': ('LAUNCHES', 'FUSED_LAUNCHES', 'TILED_MV_LAUNCHES',
                   'TILED_PC_LAUNCHES'),
    'knn': ('NN1_LAUNCHES', 'NNK_LAUNCHES'),
    'se3': ('SE3_MUL_LAUNCHES', 'SE3_ACT_LAUNCHES')}


def _counters():
    """(module, its counter names) for each kernel module."""
    from pypose_tpu_torch import ops
    return [(getattr(ops, mod), names) for mod, names in COUNTERS.items()]


def reset_counts():
    for mod, names in _counters():
        for name in names:
            setattr(mod, name, 0)


def read_counts():
    return {name: getattr(mod, name) for mod, names in _counters()
            for name in names}


def sphere2500_problem(dev):
    """The main path's problem as bench.py:bench_pgo_sphere2500 builds it;
    returns (initial poses, make_optimizer(cg_iter, cg_tol, strategy),
    TrustRegion(1e4) unless another strategy is given)."""
    import torch
    from pypose_tpu_torch.datasets import find_data, load_g2o
    from pypose_tpu_torch.optim.sparse import (SparseLM, pgo_factor,
                                               split_chain_edges)
    from pypose_tpu_torch.optim.strategy import TrustRegion

    ds = load_g2o(find_data('synthetic_sphere2500_seed42.g2o'), device=dev)
    n = ds['nodes'].lshape[0]
    fixed = torch.zeros(n, dtype=torch.bool, device=dev)
    fixed[0] = True
    edges = ds['edges']
    runs, rest = split_chain_edges(edges)
    factors = []
    for rows in list(runs) + [rest]:
        rows = torch.as_tensor(rows, device=dev)
        factors.append(pgo_factor(edges[rows], ds['poses'][rows]))

    def mk(cg_iter, cg_tol, strategy=None):
        return SparseLM({'poses': ds['nodes']}, factors,
                        strategy=TrustRegion(radius=1e4) if strategy is None
                        else strategy,
                        fixed={'poses': fixed}, cg_iter=cg_iter,
                        cg_tol=cg_tol)
    return ds['nodes'], mk


def first_step_agreement(dev):
    """One LM step of the first phase on the card (kernel) and on the CPU
    (plain version, the path the CPU tests hold against the JAX package):
    chi2 agrees within 1e-3 relative (f32, CG runs to its 150-iteration
    cap with sums in another order)."""
    chi = {}
    for d in (dev, 'cpu'):
        _, mk = sphere2500_problem(d)
        chi[str(d)] = mk(150, 1e-9).step()
    card, cpu = chi[str(dev)], chi['cpu']
    print(f'[slice] first LM step: chi2 {card:.6f} on the card, {cpu:.6f} '
          'on the CPU', flush=True)
    check(abs(card - cpu) <= 1e-3 * abs(cpu),
          'first LM step disagrees between card and CPU')


def sphere2500_slice(dev):
    """The main path, cold then warm, against the pypose anchor."""
    import torch
    from pypose_tpu_torch.datasets import find_data

    with open(find_data('ref_anchor_sphere2500.json')) as f:
        anchor = json.load(f)
    target = anchor['final_chi2'] * (1 + 1e-4)

    t0 = time.perf_counter()
    nodes, mk = sphere2500_problem(dev)
    opt, opt2 = mk(150, 1e-9), mk(1200, 1e-9)
    torch.cuda.synchronize()
    n = nodes.lshape[0]
    print(f'[slice] set-up: load_g2o + factors + SparseLM in '
          f'{time.perf_counter() - t0:.3f} s; {n} poses, offsets '
          f'{opt._stencil_all.offsets}, precond {opt.precond}, route '
          f'{opt.route}', flush=True)
    check(opt.route == opt2.route == 'stencil',
          f'sphere2500 takes route {opt.route}, not the stencil kernels')

    def run(label):
        opt.params = {'poses': nodes}
        opt.strategy_state = None
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        ev[0].record()
        opt.optimize(steps=6, decreasing=1e-6, patience=2)
        ev[1].record()
        opt2.params, opt2.strategy_state = opt.params, opt.strategy_state
        chi2 = opt2.optimize(steps=6, decreasing=1e-7, patience=2)
        ev[2].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        ms1, ms2 = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        hist = list(opt.history) + list(opt2.history)
        n1, n2 = len(opt.history), len(opt2.history)
        hit = next((i + 1 for i, h in enumerate(hist) if h <= target), None)
        if hit is None:
            to_target = None
        elif hit <= n1:
            to_target = ms1 * hit / n1
        else:
            to_target = ms1 + ms2 * (hit - n1) / n2
        print(f'[slice] {label}: chi2 history {hist}', flush=True)
        print(f'[slice] {label}: CG iterations per solve, per LM step: '
              f'phase 1 (cg_iter 150) {opt.cg_iterations}, phase 2 (cg_iter '
              f'1200) {opt2.cg_iterations}', flush=True)
        print(f'[slice] {label}: {n1}+{n2} LM steps in {ms1 + ms2:.3f} ms '
              f'(CUDA events; host {1e3 * wall:.3f} ms), '
              f'{(ms1 + ms2) / (n1 + n2):.3f} ms/LM step; final chi2 '
              f'{chi2:.6f}, target {target:.6f} (pypose {anchor["final_chi2"]}'
              f' +1e-4 rel) reached at step {hit} after '
              f'{to_target if to_target is None else round(to_target, 3)} ms',
              flush=True)
        X = opt2.params['poses'].tensor()
        check(tuple(X.shape) == (n, 7), f'poses have shape {tuple(X.shape)}')
        check(bool(torch.isfinite(X).all()), 'poses are not finite')
        check(chi2 <= target,
              f'final chi2 {chi2} above the pypose anchor {target}')
        return ms1 + ms2, n1 + n2

    # the path's launches: counted from zero over the cold run only
    reset_counts()
    cold_ms, cold_steps = run('cold')
    counts = read_counts()
    solves = sum(len(s) for o in (opt, opt2) for s in o.cg_iterations)
    check(counts['LAUNCHES'] == solves > 0 and counts['FUSED_LAUNCHES'] == 0,
          f'the slice launched the whole-solve CG kernel '
          f'{counts["LAUNCHES"]} times for {solves} solves')
    print(f'[slice] cold run launched the whole-solve CG kernel '
          f'{counts["LAUNCHES"]} times; all counts {counts}', flush=True)
    warm_ms, warm_steps = run('warm')
    # a third run under torch.profiler: the whole-solve kernel's share
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ms, _ = run('profiled')
    kernels = [e for e in prof.key_averages()
               if not e.key.startswith('aten::')]
    pcg_us = sum(e.device_time_total for e in kernels
                 if 'stencil_pcg' in e.key)
    dev_us = sum(e.device_time_total for e in kernels)
    check(pcg_us > 0, 'the profiler saw no whole-solve kernel')
    print(f'[slice] profiled run: whole-solve kernel {pcg_us / 1e3:.3f} ms '
          f'of {dev_us / 1e3:.3f} ms device time and {ms:.3f} ms of the run '
          f'(CUDA events): {pcg_us / dev_us:.4f} of device time, '
          f'{pcg_us / 1e3 / ms:.4f} of the run', flush=True)
    return counts, {'ms_per_step_cold': cold_ms / cold_steps,
                    'ms_per_step_warm': warm_ms / warm_steps}


def pgo100k_slice(dev):
    """The large pose graph, cold then warm, against the JAX anchor on the
    same instance, then a profiled run; returns the cold run's launch
    counts and {'ms_per_step', 'idle_share', 'fused_share'} of the
    profiled run."""
    import torch
    from pypose_tpu_torch.datasets import find_data, synthetic_sphere
    from pypose_tpu_torch.ops.stencil_cg import stencil_cg_fits
    from pypose_tpu_torch.optim.sparse import (SparseLM, pgo_factor,
                                               split_chain_edges)
    from pypose_tpu_torch.optim.strategy import TrustRegion
    from pypose_tpu_torch.testing import instance_checksum

    with open(find_data('jax_anchor_pgo100k_seed42.json')) as f:
        anchor = json.load(f)
    sched = anchor['schedule']
    target = anchor['final_chi2'] * (1 + 1e-3)

    t0 = time.perf_counter()
    N = 100_000
    ds = synthetic_sphere(N, seed=42, device=dev)
    got, want = instance_checksum(ds), anchor['instance_checksum']
    same = got['n_edges'] == want['n_edges'] and all(
        abs(got[k] - want[k]) <= 1e-6 * abs(want[k])
        for k in ('nodes_abs_sum', 'poses_abs_sum'))
    check(same, f'pgo-100k instance checksum {got} differs from the '
          f'anchor file\'s {want}: the JAX anchor does not apply to this '
          'instance')
    edges = ds['edges']
    runs, rest = split_chain_edges(edges)
    factors = [pgo_factor(edges[torch.as_tensor(r, device=dev)],
                          ds['poses'][torch.as_tensor(r, device=dev)])
               for r in list(runs) + ([rest] if len(rest) else [])]
    fixed = torch.zeros(N, dtype=torch.bool, device=dev)
    fixed[0] = True
    opt = SparseLM({'poses': ds['nodes']}, factors,
                   strategy=TrustRegion(radius=sched['radius']),
                   fixed={'poses': fixed}, cg_iter=sched['cg_iter'],
                   cg_tol=sched['cg_tol'])
    torch.cuda.synchronize()
    offsets = opt._stencil_all.offsets
    print(f'[pgo-100k] set-up: synthetic_sphere + factors + SparseLM in '
          f'{time.perf_counter() - t0:.3f} s; {N} poses, {edges.shape[0]} '
          f'edges, offsets {offsets}, precond {opt.precond}, route '
          f'{opt.route}; instance checksum {got}', flush=True)
    check(opt.route == 'stencil',
          f'pgo-100k takes route {opt.route}, not the stencil kernels')
    check(not stencil_cg_fits(N, 6, len(offsets)),
          'pgo-100k fits the whole-solve budget: it would not test the '
          'fused route')

    def run(label):
        opt.params = {'poses': ds['nodes']}
        opt.strategy_state = None
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        ev[0].record()
        chi2 = opt.optimize(steps=sched['steps'],
                            decreasing=sched['decreasing'],
                            patience=sched['patience'])
        ev[1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        ms = ev[0].elapsed_time(ev[1])
        steps = len(opt.history)
        print(f'[pgo-100k] {label}: chi2 history {opt.history}', flush=True)
        print(f'[pgo-100k] {label}: CG iterations per solve, per LM step: '
              f'{opt.cg_iterations}', flush=True)
        print(f'[pgo-100k] {label}: {steps} LM steps in {ms:.3f} ms (CUDA '
              f'events; host {1e3 * wall:.3f} ms), {ms / steps:.3f} ms/LM '
              f'step; final chi2 {chi2:.6f}, target {target:.6f} (JAX '
              f'{anchor["final_chi2"]} on this instance +1e-3 rel)',
              flush=True)
        X = opt.params['poses'].tensor()
        check(tuple(X.shape) == (N, 7), f'poses have shape {tuple(X.shape)}')
        check(bool(torch.isfinite(X).all()), 'poses are not finite')
        check(chi2 <= target,
              f'final chi2 {chi2} above the JAX anchor {target}')
        return ms, steps

    reset_counts()
    run('cold')
    counts = read_counts()
    solves = sum(len(s) for s in opt.cg_iterations)
    check(counts['FUSED_LAUNCHES'] == solves,
          f'the fused kernel launched {counts["FUSED_LAUNCHES"]} times for '
          f'{solves} solves')
    check(counts['TILED_MV_LAUNCHES'] == counts['TILED_PC_LAUNCHES'] == 0,
          'the pgo-100k slice launched the tiled CG kernels')
    check(counts['LAUNCHES'] == 0,
          'the pgo-100k slice launched the whole-solve kernel')
    print(f'[pgo-100k] cold run launch counts {counts} ({solves} solves)',
          flush=True)
    run('warm')
    # a third run under torch.profiler: the fused kernel's share of device
    # time, and the share of the run the device is idle
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ms, steps = run('profiled')
    kernels = [e for e in prof.key_averages()
               if not e.key.startswith('aten::')]
    fused_us = sum(e.device_time_total for e in kernels
                   if 'fused_pcg' in e.key)
    dev_us = sum(e.device_time_total for e in kernels)
    check(fused_us > 0, 'the profiler saw no fused kernel')
    profiled = {'ms_per_step': ms / steps,
                'idle_share': 1 - dev_us / 1e3 / ms,
                'fused_share': fused_us / dev_us}
    print(f'[pgo-100k] profiled run: fused kernel {fused_us / 1e3:.3f} ms of '
          f'{dev_us / 1e3:.3f} ms device time ({profiled["fused_share"]:.4f})'
          f' and {ms:.3f} ms of the run (CUDA events); device idle share '
          f'{profiled["idle_share"]:.4f}', flush=True)
    return counts, profiled


def icp_instance(N, dev):
    """bench.py:bench_modules' ICP instance: N points x 3 scaled by 5.0
    (from torch.Generator seed 0) and T = randn_SE3(sigma=(0.3, 0.05))
    (seed 3), target T.Act(src); made on the CPU, then moved, so every
    device sees the same values.  Returns (src, T, tgt) on ``dev``."""
    import torch
    import pypose_tpu_torch as ppt
    src = torch.randn((N, 3), generator=torch.Generator().manual_seed(0)) \
        * 5.0
    T = ppt.randn_SE3(sigma=(0.3, 0.05),
                      generator=torch.Generator().manual_seed(3))
    return src.to(dev), T.to(dev), T.Act(src).to(dev)


def icp_stepper():
    from pypose_tpu_torch.utils import ReduceToBason
    return ReduceToBason(steps=8, patience=8, tol=1e-9)


def align_err(T_est, T):
    return float((T_est.Inv() @ T).Log().tensor().abs().max())


def cdist_topk(ref, nbr, k):
    """The k nearest neighbours by two PyTorch calls a chunk of reference
    rows (torch.cdist, then torch.topk; chunks of 64 Mi pairs): a
    yardstick for nnk, used nowhere in the port."""
    import torch
    chunk = max(1, (64 << 20) // nbr.shape[0])
    vals, idxs = [], []
    for s in range(0, ref.shape[0], chunk):
        v, i = torch.cdist(ref[s:s + chunk], nbr).topk(k, largest=False)
        vals.append(v)
        idxs.append(i)
    return torch.cat(vals) ** 2, torch.cat(idxs)


def nnk_vs_plain(name, ref, nbr, k):
    """nnk against its plain version under the tolerance rule of
    pypose_tpu_torch.testing.nnk_tolerance_failures, with chunked
    torch.cdist + torch.topk timed beside it; returns (max|d2_k - d2_p|,
    kernel ms, plain ms, cdist + topk ms)."""
    import torch
    from pypose_tpu_torch.ops import knn as K
    from pypose_tpu_torch.testing import nnk_tolerance_failures
    k_ms, (d_k, i_k) = cuda_ms(lambda: K.nnk(ref, nbr, k))
    p_ms, (d_p, i_p) = cuda_ms(lambda: K._nnk_torch(ref, nbr, k))
    c_ms, _ = cuda_ms(lambda: cdist_topk(ref, nbr, k))
    got = nnk_tolerance_failures(ref, nbr, d_k, i_k, i_p)
    err = float((d_k - d_p).abs().max())
    print(f'[kernel] nnk, {name}: {tuple(ref.shape)} x {tuple(nbr.shape)}, '
          f'k={k}: {got}; max|d2_k - d2_p| {err:.3e}; kernel {k_ms:.4f} ms, '
          f'plain {p_ms:.4f} ms, torch.cdist + torch.topk (two calls a '
          f'chunk) {c_ms:.4f} ms, median of 7', flush=True)
    check(bool(torch.isfinite(d_k).all()), f'nnk, {name}: d2 not finite')
    check(got['index_failures'] == got['repeat_failures']
          == got['d2_failures'] == 0,
          f'nnk, {name}: outside the tolerance: {got}')
    return err, k_ms, p_ms, c_ms


def cdist_min(ref, nbr):
    """Nearest neighbours by two PyTorch calls a chunk of reference rows
    (torch.cdist, then torch.min; chunks of 64 Mi pairs): a yardstick for
    nn1, used nowhere in the port."""
    import torch
    chunk = max(1, (64 << 20) // nbr.shape[0])
    vals, idxs = [], []
    for s in range(0, ref.shape[0], chunk):
        v, i = torch.cdist(ref[s:s + chunk], nbr).min(1)
        vals.append(v)
        idxs.append(i)
    return torch.cat(vals) ** 2, torch.cat(idxs)


def nn1_vs_plain(name, ref, nbr):
    """nn1 against its plain version under the tolerance rule of
    pypose_tpu_torch.testing.nn1_tolerance_failures; returns (max|d2_k -
    d2_p|, kernel ms, plain ms, cdist + min ms)."""
    import torch
    from pypose_tpu_torch.ops import knn as K
    from pypose_tpu_torch.testing import nn1_tolerance_failures
    k_ms, (d_k, i_k) = cuda_ms(lambda: K.nn1(ref, nbr))
    p_ms, (d_p, i_p) = cuda_ms(lambda: K._nn1_torch(ref, nbr))
    c_ms, _ = cuda_ms(lambda: cdist_min(ref, nbr))
    got = nn1_tolerance_failures(ref, nbr, d_k, i_k, i_p)
    err = float((d_k - d_p).abs().max())
    print(f'[kernel] nn1, {name}: {tuple(ref.shape)} x {tuple(nbr.shape)}: '
          f'{got}; max|d2_k - d2_p| {err:.3e}; kernel {k_ms:.4f} ms, plain '
          f'{p_ms:.4f} ms, torch.cdist + torch.min (two calls a chunk) '
          f'{c_ms:.4f} ms, median of 7', flush=True)
    check(bool(torch.isfinite(d_k).all()), f'nn1, {name}: d2 not finite')
    check(got['index_failures'] == 0 and got['d2_failures'] == 0,
          f'nn1, {name}: outside the tolerance: {got}')
    return err, k_ms, p_ms, c_ms


def point_kernels_vs_plain(dev):
    """nn1, nnk and the SE3 kernels against their plain versions at the
    ICP slice's shapes; returns {kernel: (err, ms, plain ms, ...)}: nn1
    and nnk with their two-call reference's ms, the SE3 entries with the
    device ms of kernel and plain version."""
    import torch
    import pypose_tpu_torch as ppt
    from pypose_tpu_torch.lietensor import operation as op
    from pypose_tpu_torch.ops import se3 as S
    src, _, tgt = icp_instance(100_000, dev)
    icp_err, k_ms, p_ms, c_ms = nn1_vs_plain('ICP clouds', src, tgt)
    # every target point twice, and a copy of 1000 source points
    dup = torch.cat([tgt[:50_000], tgt[:50_000], src[:1000]])
    dup_err = nn1_vs_plain('duplicated points', src[:50_000].contiguous(),
                           dup)[0]
    out = {'nn1': (max(icp_err, dup_err), k_ms, p_ms, c_ms)}
    ref = src[:20_000].contiguous()
    for k in (4, 16):
        out[f'nnk{k}'] = nnk_vs_plain('ICP clouds', ref, tgt, k)
    gen = torch.Generator().manual_seed(5)
    for N in (100_000, 100_003):
        X = ppt.randn_SE3(N, sigma=2.0, generator=gen).tensor().to(dev)
        Y = ppt.randn_SE3(N, sigma=2.0, generator=gen).tensor().to(dev)
        p = (5.0 * torch.randn((N, 3), generator=gen)).to(dev)
        for kname, kern, plain, other in (
                ('se3_mul', S.se3_mul_fused, op.SE3_Mul, Y),
                ('se3_act', S.se3_act_fused, op.SE3_Act, p)):
            err = float((kern(X, other) - plain(X, other)).abs().max())
            bound = 1e-6 * (1 + max(float(X.abs().max()),
                                    float(other.abs().max())))
            check(err <= bound, f'{kname} disagrees with its plain version')
            if kname in out:              # N = 100,003: correctness only
                out[kname] = (max(err, out[kname][0]), *out[kname][1:])
                print(f'[kernel] {kname}: N={N}: max|z_k - z_p| {err:.3e} '
                      f'(bound {bound:.3e})', flush=True)
                continue
            # per call over 50 calls (the wrapper's host cost shows here),
            # and the device time of the calls' kernels alone
            k_ms, _ = cuda_ms(lambda: [kern(X, other) for _ in range(50)])
            p_ms, _ = cuda_ms(lambda: [plain(X, other) for _ in range(50)])
            k_dev, p_dev = (device_ms(lambda: kern(X, other)),
                            device_ms(lambda: plain(X, other)))
            print(f'[kernel] {kname}: N={N}: max|z_k - z_p| {err:.3e} '
                  f'(bound {bound:.3e}); per call over 50 calls: kernel '
                  f'{20 * k_ms:.2f} us, plain {20 * p_ms:.2f} us (CUDA '
                  f'events, median of 7); device time per call: kernel '
                  f'{1e3 * k_dev:.2f} us, plain {1e3 * p_dev:.2f} us '
                  '(torch.profiler)', flush=True)
            out[kname] = (err, k_ms / 50, p_ms / 50, k_dev, p_dev)
    return out


def icp_card_vs_cpu(dev):
    """One 9,000-point instance through ICP on the card and on the CPU."""
    import pypose_tpu_torch as ppt
    est = {}
    for d in (dev, 'cpu'):
        src, T, tgt = icp_instance(9000, d)
        est[str(d)] = ppt.ICP(stepper=icp_stepper())(src, tgt).to('cpu')
    card, cpu = est[str(dev)], est['cpu']
    T = icp_instance(9000, 'cpu')[1]
    gap = align_err(card, cpu)
    print(f'[icp-9000] |Log(T_card^-1 T_cpu)|_inf {gap:.3e} (bound 1e-5); '
          f'align err card {align_err(card, T):.3e}, CPU '
          f'{align_err(cpu, T):.3e}', flush=True)
    check(gap <= 1e-5, 'ICP at 9,000 points disagrees between card and CPU')


def icp_slice(dev):
    """ICP at 100k points, cold then warm; returns the cold run's launch
    counts."""
    import torch
    import pypose_tpu_torch as ppt

    t0 = time.perf_counter()
    src, T, tgt = icp_instance(100_000, dev)
    icp = ppt.ICP(stepper=icp_stepper())
    torch.cuda.synchronize()
    print(f'[icp] set-up: clouds and ICP in {time.perf_counter() - t0:.3f} '
          f's; {src.shape[0]} points, T = {T.tensor().tolist()}', flush=True)

    def run(label):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        ev[0].record()
        T_est = icp(src, tgt)
        ev[1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        ms = ev[0].elapsed_time(ev[1])
        sweeps = icp.stepper.steps
        err = align_err(T_est, T)
        print(f'[icp] {label}: {sweeps} sweeps in {ms:.3f} ms (CUDA events; '
              f'host {1e3 * wall:.3f} ms), {ms / sweeps:.3f} ms/sweep; '
              f'align err {err:.3e} (bound 1e-4)', flush=True)
        check(tuple(T_est.shape) == (7,), f'T has shape {tuple(T_est.shape)}')
        check(bool(torch.isfinite(T_est.tensor()).all()), 'T is not finite')
        check(err <= 1e-4, f'ICP align error {err} above 1e-4')
        return sweeps

    reset_counts()
    sweeps = run('cold')
    counts = read_counts()
    # one association per sweep, and one more for the returned transform
    check(counts['NN1_LAUNCHES'] == sweeps + 1,
          f'nn1 launched {counts["NN1_LAUNCHES"]} times over {sweeps} sweeps')
    print(f'[icp] cold run launch counts {counts}', flush=True)
    run('warm')
    return counts


def knn_k8_phase(dev):
    """knn(k=8) on ICP's 100k-point clouds through the public entry point:
    one nnk launch, held to the tolerance rule against the plain version,
    timed beside the torch path it replaces on CUDA and beside chunked
    torch.cdist + torch.topk.  Returns (launch counts, max|d2 - d2_p|, ms,
    plain ms, torch path ms, cdist + topk ms)."""
    import torch
    import pypose_tpu_torch as ppt
    from pypose_tpu_torch.function import geometry
    from pypose_tpu_torch.ops import knn as K
    from pypose_tpu_torch.testing import nnk_tolerance_failures
    src, _, tgt = icp_instance(100_000, dev)
    k = 8
    reset_counts()
    res = ppt.knn(src, tgt, k=k)
    torch.cuda.synchronize()
    counts = read_counts()
    others = {n: c for n, c in counts.items() if n != 'NNK_LAUNCHES' and c}
    check(counts['NNK_LAUNCHES'] == 1 and not others,
          f'knn(k=8) launched {counts}')
    p_ms, (d_p, i_p) = cuda_ms(lambda: K._nnk_torch(src, tgt, k), repeat=3)
    d2 = res.values ** 2
    got = nnk_tolerance_failures(src, tgt, d2, res.indices, i_p)
    err = float((d2 - d_p).abs().max())
    check(tuple(res.indices.shape) == (100_000, k)
          and bool(torch.isfinite(res.values).all()),
          'knn(k=8): wrong shape or not finite')
    check(got['index_failures'] == got['repeat_failures']
          == got['d2_failures'] == 0,
          f'knn(k=8): outside the tolerance: {got}')
    k_ms, _ = cuda_ms(lambda: ppt.knn(src, tgt, k=k))
    chunk = max(128, (64 << 20) // tgt.shape[0])
    t_ms, _ = cuda_ms(lambda: geometry._knn_gram(src, tgt, k, False, chunk),
                      repeat=3)
    c_ms, _ = cuda_ms(lambda: cdist_topk(src, tgt, k), repeat=3)
    print(f'[knn-k8] knn(src, tgt, k=8), 100k x 100k ICP clouds: launch '
          f'counts {counts}; {got}; max|d2 - d2_p| {err:.3e}; knn '
          f'{k_ms:.4f} ms (median of 7), the torch path it replaces '
          f'(matmul + stable sort a chunk) {t_ms:.4f} ms, torch.cdist + '
          f'torch.topk {c_ms:.4f} ms, plain nnk {p_ms:.4f} ms (median of '
          '3)', flush=True)
    return counts, err, k_ms, p_ms, t_ms, c_ms


def device_totals(prof):
    """(device ms, device operations) of a torch.profiler trace: the
    kernels, copies and sets on the card, summed from the trace's raw
    events.  ``key_averages`` also counts the CUDA runtime's calls (45,148
    entries against 21,527 device events on one [mpc] trace), and it
    builds a Python object for every event, which on a trace of 10^5-10^6
    launches (the filters' rollouts, MPC) takes ~45 times longer
    (measured on the CPU: 7.7 s against 0.17 s for 10^5 events)."""
    from torch.autograd import DeviceType
    ns = n = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and \
                not e.name().startswith('aten::'):
            ns += e.duration_ns()
            n += 1
    return ns / 1e6, n


def profiled_run(run):
    """``run('profiled')`` -> (ms, steps) under torch.profiler: (ms,
    steps, device ms, device operations), as :func:`device_totals` reads
    them."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ms, steps = run('profiled')
    return (ms, steps, *device_totals(prof))


def general_graph_phase(tag, ds, anchor_name, route, hold):
    """A pose graph of the general routes (no stencil kernel) through
    testing.pgo_optimizer with the anchor file's schedule, cold, warm and
    profiled: route, launch counts (every kernel count 0), CG host reads,
    chi2 against the JAX anchor (``hold(history, anchor)`` raises if
    outside), ms per LM step, device operations per LM step and the
    device's idle share.  Returns a dict of those numbers."""
    import torch
    from pypose_tpu_torch.datasets import find_data
    from pypose_tpu_torch.optim import solver
    from pypose_tpu_torch.testing import instance_checksum, pgo_optimizer

    with open(find_data(anchor_name)) as f:
        anchor = json.load(f)
    sched = anchor['schedule']
    got, want = instance_checksum(ds), anchor['instance_checksum']
    check(got['n_edges'] == want['n_edges'] and all(
        abs(got[k] - want[k]) <= 1e-6 * abs(want[k])
        for k in ('nodes_abs_sum', 'poses_abs_sum')),
        f'{tag}: instance checksum {got} differs from the anchor\'s {want}')
    t0 = time.perf_counter()
    opt = pgo_optimizer(ds, **sched)
    torch.cuda.synchronize()
    n = ds['nodes'].shape[0]
    print(f'[{tag}] set-up: SparseLM in {time.perf_counter() - t0:.3f} s; '
          f'{n} poses, {ds["edges"].shape[0]} edges, route {opt.route}, '
          f'precond {opt.precond} (JAX: {anchor["jax_precond"]}), matvecs '
          f'{[type(sp).__name__ for sp in opt._spmv]}', flush=True)
    check(opt.route == route, f'{tag}: route {opt.route}, expected {route}')

    def run(label):
        opt.params = {'poses': ds['nodes']}
        opt.strategy_state = None
        reads = solver.CG_HOST_READS
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        ev[0].record()
        chi2 = opt.optimize(steps=sched['steps'],
                            decreasing=sched['decreasing'],
                            patience=sched['patience'])
        ev[1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        ms, steps = ev[0].elapsed_time(ev[1]), len(opt.history)
        print(f'[{tag}] {label}: chi2 history {opt.history} (JAX anchor '
              f'{anchor["history"]})', flush=True)
        print(f'[{tag}] {label}: CG iterations per solve, per LM step: '
              f'{opt.cg_iterations}; CG host reads '
              f'{solver.CG_HOST_READS - reads}', flush=True)
        print(f'[{tag}] {label}: {steps} LM steps in {ms:.3f} ms (CUDA '
              f'events; host {1e3 * wall:.3f} ms), {ms / steps:.3f} ms/LM '
              f'step; final chi2 {chi2:.7g}, JAX anchor '
              f'{anchor["final_chi2"]:.7g} (relative gap '
              f'{chi2 / anchor["final_chi2"] - 1:.3e})', flush=True)
        X = opt.params['poses'].tensor()
        check(tuple(X.shape) == (n, 7) and bool(torch.isfinite(X).all()),
              f'{tag}: poses of shape {tuple(X.shape)} or not finite')
        hold(opt.history, anchor)
        return ms, steps

    reset_counts()
    cold_ms, cold_steps = run('cold')
    counts = read_counts()
    check(not any(counts.values()),
          f'{tag}: the general route launched kernels: {counts}')
    print(f'[{tag}] cold run launch counts {counts}', flush=True)
    warm_ms, warm_steps = run('warm')
    ms, steps, dev_ms, n_ops = profiled_run(run)
    out = {'route': opt.route, 'final_chi2': opt.history[-1],
           'anchor_chi2': anchor['final_chi2'],
           'ms_per_step_cold': cold_ms / cold_steps,
           'ms_per_step_warm': warm_ms / warm_steps,
           'ms_per_step_profiled': ms / steps,
           'device_ops_per_step': n_ops / steps,
           'idle_share': 1 - dev_ms / ms}
    print(f'[{tag}] profiled run: {dev_ms:.3f} ms device time of {ms:.3f} '
          f'ms (idle share {out["idle_share"]:.4f}), {n_ops} device '
          f'operations, {out["device_ops_per_step"]:.1f} an LM step',
          flush=True)
    return out


def hold_chain(hist, anchor):
    """pgo-chain's tolerances (tests/test_torch_pgo_chain_anchor.py): the
    first step within 3e-4 of the anchor's, the final chi2 within 1e-2."""
    first = hist[0] / anchor['history'][0] - 1
    final = hist[-1] / anchor['final_chi2'] - 1
    check(abs(first) <= 3e-4 and abs(final) <= 1e-2,
          f'pgo-chain: first step {first:.3e} or final {final:.3e} '
          'outside its tolerance of the JAX anchor')


def hold_loops(hist, anchor):
    """pgo-loops-10k's tolerances (tests/test_torch_pgo_loops_anchor.py):
    entries above 1e-3 within 1e-3 of the anchor's, the final below 1e-5
    of the initial chi2."""
    want = anchor['history']
    check(len(hist) == len(want) and all(
        abs(h / w - 1) <= 1e-3 for h, w in zip(hist, want) if w > 1e-3)
        and hist[-1] < 1e-5 * anchor['initial_chi2'],
        'pgo-loops: chi2 history outside its tolerance of the JAX anchor')


def pgo_chain_phase(dev):
    from pypose_tpu_torch.datasets import synthetic_sphere
    return general_graph_phase(
        'pgo-chain', synthetic_sphere(5000, loops_per_pose=0.04, seed=5,
                                      device=dev),
        'jax_anchor_pgo_chain5k_seed5.json', 'chain', hold_chain)


def pgo_loops_phase(dev):
    from pypose_tpu_torch.testing import pgo_loops_instance
    return general_graph_phase(
        'pgo-loops', pgo_loops_instance(10_000, device=dev),
        'jax_anchor_pgo_loops10k.json', 'einsum', hold_loops)


def sparse_f64_phase(dev):
    """The inputs at the edge of the stencil kernels, card against CPU:
    synthetic_sphere(100) in float64 (four step() calls, cg_iter 150,
    cg_tol 1e-9; chi2 within 1e-8; route 'einsum', no kernel), a Euclidean
    [64, 3] ring factor in float32 (testing.ring3_problem, three step()
    calls; chi2 within 1e-4; route 'stencil': on the card one whole-solve
    launch a solve, through its t = 3 template) and the same ring at t = 5
    (route 'stencil' too, through the runtime-t instantiation)."""
    import torch
    from pypose_tpu_torch.datasets import synthetic_sphere
    from pypose_tpu_torch.optim.sparse import SparseLM
    from pypose_tpu_torch.optim.strategy import TrustRegion
    from pypose_tpu_torch.testing import pgo_optimizer, ring3_problem

    def sphere(d):
        return pgo_optimizer(synthetic_sphere(100, dtype=torch.float64,
                                              device=d),
                             radius=1e4, cg_iter=150, cg_tol=1e-9)

    def ring(t):
        def make(d):
            params, factors, fixed = ring3_problem(device=d, t=t)
            return SparseLM(params, factors,
                            strategy=TrustRegion(radius=1e4), fixed=fixed,
                            cg_iter=100, cg_tol=1e-8)
        return make

    for name, make, steps, rtol, route in (
            ('sphere100 float64', sphere, 4, 1e-8, 'einsum'),
            ('ring3 float32', ring(3), 3, 1e-4, 'stencil'),
            ('ring t=5 float32', ring(5), 3, 1e-4, 'stencil')):
        hist = {}
        for d in (dev, 'cpu'):
            opt = make(d)
            check(opt.route == route,
                  f'sparse-f64, {name}: route {opt.route}, expected {route}')
            reset_counts()
            t0 = time.perf_counter()
            hist[str(d)] = []
            solves = 0
            for _ in range(steps):
                hist[str(d)].append(opt.step())
                solves += len(opt.cg_iterations[0])
            ms = 1e3 * (time.perf_counter() - t0) / steps
            counts = read_counts()
            whole = solves if route == 'stencil' and d != 'cpu' else 0
            check(counts.pop('LAUNCHES') == whole
                  and not any(counts.values()),
                  f'sparse-f64, {name} on {d}: launch counts {read_counts()}'
                  f' for {solves} solves on route {route}')
            print(f'[sparse-f64] {name} on {d}: route {opt.route}, chi2 '
                  f'{hist[str(d)]}, CG iterations {opt.cg_iterations}, '
                  f'{ms:.3f} ms/LM step (host clock), whole-solve launches '
                  f'{whole}, no other kernel', flush=True)
        card, cpu = hist[str(dev)], hist['cpu']
        gap = max(abs(a / b - 1) for a, b in zip(card, cpu))
        print(f'[sparse-f64] {name}: card against CPU, largest relative '
              f'chi2 gap {gap:.3e} (bound {rtol:g})', flush=True)
        check(gap <= rtol, f'sparse-f64, {name}: card and CPU disagree')


# The float64 instantiations' near-tie rule: nnk_tolerance_failures at
# rtol = atol = 1e-13 (~450 float64 ulps of |a|^2 + |b|^2).
F64_TOL = dict(rtol=1e-13, atol=1e-13)


def knn_d6_phase(dev):
    """knn(ref, nbr, k=1) and k=8 on [10000, 6] clouds (1e8 pairs, the
    auto-tiled route), in float32 and then in float64: one nn1 and one
    nnk launch each, held to the near-tie rules against the plain
    versions (float64 at F64_TOL).  Returns {kernel: (err, ms, plain ms,
    cdist ms)} for 'nn1', 'nnk', 'nn1_f64' and 'nnk_f64'."""
    import torch
    import pypose_tpu_torch as ppt
    from pypose_tpu_torch.ops import knn as K
    from pypose_tpu_torch.testing import nnk_tolerance_failures
    gen = torch.Generator().manual_seed(0)
    ref = torch.randn((10_000, 6), generator=gen).to(dev)
    nbr = torch.randn((10_000, 6), generator=gen).to(dev)
    out = {}
    for suffix, r, n, tol in (('', ref, nbr, {}),
                              ('_f64', ref.double(), nbr.double(), F64_TOL)):
        for k, counter in ((1, 'NN1_LAUNCHES'), (8, 'NNK_LAUNCHES')):
            reset_counts()
            res = ppt.knn(r, n, k=k)
            torch.cuda.synchronize()
            counts = read_counts()
            others = {c: v for c, v in counts.items() if c != counter and v}
            check(counts[counter] == 1 and not others
                  and res.values.dtype == r.dtype,
                  f'knn-d6, k={k}, {r.dtype}: launch counts {counts}')
            plain = (lambda: [a[:, None] for a in K._nn1_torch(r, n)]) \
                if k == 1 else (lambda: K._nnk_torch(r, n, k))
            p_ms, (d_p, i_p) = cuda_ms(plain, repeat=3)
            got = nnk_tolerance_failures(r, n, res.values ** 2, res.indices,
                                         i_p, **tol)
            err = float((res.values ** 2 - d_p).abs().max())
            check(got['index_failures'] == got['repeat_failures']
                  == got['d2_failures'] == 0,
                  f'knn-d6, k={k}, {r.dtype}: outside the tolerance: {got}')
            k_ms, _ = cuda_ms(lambda: K.nnk(r, n, k))
            c_ms, _ = cuda_ms((lambda: cdist_min(r, n)) if k == 1 else
                              (lambda: cdist_topk(r, n, k)), repeat=3)
            print(f'[knn-d6] knn(k={k}), [10000, 6] x [10000, 6] {r.dtype}: '
                  f'launch counts {counts}; {got}; max|d2 - d2_p| {err:.3e}; '
                  f'kernel {k_ms:.4f} ms (median of 7), plain {p_ms:.4f} ms, '
                  f'torch.cdist + torch.{"min" if k == 1 else "topk"} '
                  f'{c_ms:.4f} ms (median of 3)', flush=True)
            out[('nn1' if k == 1 else 'nnk') + suffix] = (err, k_ms, p_ms,
                                                          c_ms)
    return out


GROUP_TAN = {'SO3': 3, 'RxSO3': 4, 'SE3': 6, 'Sim3': 7}


def group_instance(anchor, dev):
    """The instance a group anchor file was computed on
    (tests/test_torch_pgo_groups_anchor.py): pgo_group_instance of the
    vendored sphere2500 graph or of synthetic_sphere(100000, seed=42) over
    the file's group, its scale draw from the file's seed."""
    import torch
    from pypose_tpu_torch.datasets import (find_data, load_g2o,
                                           synthetic_sphere)
    from pypose_tpu_torch.testing import pgo_group_instance
    if anchor['graph'] == 'sphere2500':
        ds = load_g2o(find_data('synthetic_sphere2500_seed42.g2o'),
                      device=dev)
    else:
        ds = synthetic_sphere(100_000, seed=42, device=dev)
    return pgo_group_instance(
        ds, anchor['group'],
        torch.Generator().manual_seed(anchor['scale_seed']))


def group_graph_phase(name, dev, kernel, profiled=False, autodiff=False):
    """A pose graph over SO3, RxSO3 or Sim3 on the 'stencil' route, built
    by testing.pgo_optimizer with its anchor file's schedule
    (data/jax_anchor_<name>.json), cold then warm (and, if asked, under
    torch.profiler): route 'stencil'; ``kernel`` ('whole' or 'fused')
    launched once a solve and the other not at all; the chi2 history held
    to the JAX anchor (first step within 1e-4 relative, final within
    1e-3); ms per LM step.  ``autodiff``: residual-only factors (the
    Jacobian by autodiff), tagged '-autodiff'.  Returns a dict of the cold
    run's launch counts and those numbers."""
    import torch
    from pypose_tpu_torch.datasets import find_data
    from pypose_tpu_torch.ops import stencil_cg as scg
    from pypose_tpu_torch.testing import instance_checksum, pgo_optimizer

    tag = name.replace('_', '-') + ('-autodiff' if autodiff else '')
    with open(find_data(f'jax_anchor_{name}.json')) as f:
        anchor = json.load(f)
    sched, group = anchor['schedule'], anchor['group']
    t = GROUP_TAN[group]
    t0 = time.perf_counter()
    ds = group_instance(anchor, dev)
    got, want = instance_checksum(ds), anchor['instance_checksum']
    check(got['n_edges'] == want['n_edges'] and all(
        abs(got[k] - want[k]) <= 1e-6 * abs(want[k])
        for k in ('nodes_abs_sum', 'poses_abs_sum')),
        f'{tag}: instance checksum {got} differs from the anchor\'s {want}')
    opt = pgo_optimizer(ds, autodiff=autodiff, **sched)
    check(all((f.batched_jacobian is None) == autodiff
              for f in opt.factors), f'{tag}: factors not as asked')
    torch.cuda.synchronize()
    n = ds['nodes'].shape[0]
    offsets = opt._stencil_all.offsets
    whole_fits = scg.stencil_cg_fits(n, t, len(offsets))
    where = ('operands in shared memory'
             if scg.stencil_cg_smem_fits(n, t, len(offsets))
             else 'operands in L2') if whole_fits else \
        f'fused kernel plan {scg.fused_plan(n, t, dev)}'
    print(f'[{tag}] set-up: instance + SparseLM in '
          f'{time.perf_counter() - t0:.3f} s; {n} {group} nodes (t = {t}), '
          f'{ds["edges"].shape[0]} edges, offsets {offsets}, route '
          f'{opt.route}, {where}', flush=True)
    check(opt.route == 'stencil', f'{tag}: route {opt.route}, not stencil')
    check(whole_fits == (kernel == 'whole'),
          f'{tag}: the whole-solve budget says {whole_fits}, expected the '
          f'{kernel} kernel')

    def run(label):
        opt.params = {'poses': ds['nodes']}
        opt.strategy_state = None
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        ev[0].record()
        chi2 = opt.optimize(steps=sched['steps'],
                            decreasing=sched['decreasing'],
                            patience=sched['patience'])
        ev[1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        ms, steps = ev[0].elapsed_time(ev[1]), len(opt.history)
        first = opt.history[0] / anchor['history'][0] - 1
        final = chi2 / anchor['final_chi2'] - 1
        print(f'[{tag}] {label}: chi2 history {opt.history} (JAX anchor '
              f'{anchor["history"]}); CG iterations per solve, per LM '
              f'step: {opt.cg_iterations}', flush=True)
        print(f'[{tag}] {label}: {steps} LM steps in {ms:.3f} ms (CUDA '
              f'events; host {1e3 * wall:.3f} ms), {ms / steps:.3f} ms/LM '
              f'step; against the JAX anchor: first step {first:.3e} (bound '
              f'1e-4), final {final:.3e} (bound 1e-3)', flush=True)
        X = opt.params['poses'].tensor()
        check(tuple(X.shape) == tuple(ds['nodes'].shape)
              and bool(torch.isfinite(X).all()),
              f'{tag}: nodes of shape {tuple(X.shape)} or not finite')
        check(steps == len(anchor['history']) and abs(first) <= 1e-4
              and abs(final) <= 1e-3,
              f'{tag}: chi2 history outside its tolerance of the JAX anchor')
        return ms, steps

    reset_counts()
    cold_ms, cold_steps = run('cold')
    counts = read_counts()
    solves = sum(len(s) for s in opt.cg_iterations)
    mine, other = ('LAUNCHES', 'FUSED_LAUNCHES') if kernel == 'whole' \
        else ('FUSED_LAUNCHES', 'LAUNCHES')
    check(counts[mine] == solves > 0 and counts[other] == 0
          and counts['TILED_MV_LAUNCHES'] == counts['TILED_PC_LAUNCHES'] == 0,
          f'{tag}: launch counts {counts} for {solves} solves on the '
          f'{kernel} kernel')
    print(f'[{tag}] cold run launch counts {counts} ({solves} solves)',
          flush=True)
    warm_ms, warm_steps = run('warm')
    out = {'counts': counts, 'final_chi2': opt.history[-1],
           'anchor_chi2': anchor['final_chi2'],
           'ms_per_step_cold': cold_ms / cold_steps,
           'ms_per_step_warm': warm_ms / warm_steps}
    if profiled:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ms, steps = run('profiled')
        kernels = [e for e in prof.key_averages()
                   if not e.key.startswith('aten::')]
        match = 'stencil_pcg' if kernel == 'whole' else 'fused_pcg'
        k_us = sum(e.device_time_total for e in kernels if match in e.key)
        dev_us = sum(e.device_time_total for e in kernels)
        check(k_us > 0, f'{tag}: the profiler saw no {match} kernel')
        out.update(ms_per_step_profiled=ms / steps,
                   idle_share=1 - dev_us / 1e3 / ms,
                   kernel_share=k_us / dev_us,
                   device_ops_per_step=device_totals(prof)[1] / steps)
        print(f'[{tag}] profiled run: {match} {k_us / 1e3:.3f} ms of '
              f'{dev_us / 1e3:.3f} ms device time '
              f'({out["kernel_share"]:.4f}) and {ms:.3f} ms of the run '
              f'(CUDA events); device idle share {out["idle_share"]:.4f}; '
              f'{out["device_ops_per_step"]:.1f} device operations an LM '
              'step', flush=True)
    return out


def pgo_groups_phase(dev):
    """bench.py:bench_pgo_groups' two instances (SO3 rotation averaging
    and Sim3 scale drift on a ring with random loops, N = 10,000, exact
    measurements; cg_iter 100, cg_tol 1e-8, six steps), cold then warm:
    route 'einsum', no kernel launched, chi2 down by at least 1e3 times.
    Returns {group: numbers}."""
    import torch
    from pypose_tpu_torch.testing import pgo_loops_instance, pgo_optimizer
    out = {}
    for group in ('SO3', 'Sim3'):
        ds = pgo_loops_instance(10_000, device=dev, group=group)
        opt = pgo_optimizer(ds, radius=1e4, cg_iter=100, cg_tol=1e-8,
                            split_chains=False)
        check(opt.route == 'einsum',
              f'pgo-groups, {group}: route {opt.route}')
        initial = float(opt._chi2(opt.params))
        reset_counts()
        times = {}
        for label in ('cold', 'warm'):
            opt.params = {'poses': ds['nodes']}
            opt.strategy_state = None
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            chi2 = opt.optimize(steps=6, decreasing=1e-10, patience=2)
            ev[1].record()
            torch.cuda.synchronize()
            times[label] = ev[0].elapsed_time(ev[1]) / len(opt.history)
        counts = read_counts()
        X = opt.params['poses'].tensor()
        print(f'[pgo-groups] {group}: {ds["nodes"].shape[0]} nodes, '
              f'{ds["edges"].shape[0]} edges, route {opt.route}, matvecs '
              f'{[type(sp).__name__ for sp in opt._spmv]}; chi2 {initial:.6g}'
              f' -> {opt.history}; CG iterations {opt.cg_iterations}; '
              f'{times["cold"]:.3f} ms/LM step cold, {times["warm"]:.3f} '
              f'warm (CUDA events); launch counts {counts}', flush=True)
        check(not any(counts.values()),
              f'pgo-groups, {group}: kernels launched: {counts}')
        check(bool(torch.isfinite(X).all()) and chi2 * 1e3 <= initial,
              f'pgo-groups, {group}: chi2 {initial} -> {chi2}: not down by '
              '1e3 times')
        out[group] = {'initial_chi2': initial, 'final_chi2': chi2,
                      'ms_per_step_cold': times['cold'],
                      'ms_per_step_warm': times['warm']}
    return out


AUTOGRAD_N = 100_000


def autograd_phase(dev, smi):
    """The 32 autograd Functions at a batch of 100,000 on the card against
    the CPU in float64: the forward, a VJP with a random cotangent and a
    torch.func.jvp, in float64 (within 1e-9 of 1 + max|CPU|; 1e-8 for the
    Sim3 ops) and in float32 (1e-5; 1e-4 for Sim3, whose rules go through
    sim3_Jl's float32 squarings: tests/test_torch_autograd.py's bounds),
    the largest error of each printed; then
    bench.py:130-139's micro-jacrev, vmap(jacrev(SE3(X).Act(p))) at 100k
    in float32, held to its closed form [I, skew(-out), 0] and timed.
    Returns {op: (float64 error, float32 error)} and the jacrev numbers."""
    import numpy as np
    import torch
    import pypose_tpu_torch as ppt
    from pypose_tpu_torch.lietensor import operation as op
    from pypose_tpu_torch.testing import autograd_inputs

    def evaluate(fn, args, ct, tans):
        args = [a.clone().requires_grad_() for a in args]
        out = fn(*args)
        vjp = torch.autograd.grad(out, args, ct)
        _, tan = torch.func.jvp(fn, tuple(a.detach() for a in args),
                                tuple(tans))
        return [out.detach(), *vjp, tan]

    errs = {}
    t0 = time.perf_counter()
    for i, (name, cls) in enumerate(op.FUNCTIONS.items()):
        rng = np.random.default_rng(i)
        args, on_group = autograd_inputs(name, AUTOGRAD_N, rng)
        fn = getattr(op, name)
        out = fn(*args)
        ct = torch.from_numpy(rng.normal(size=out.shape))
        tans = []
        for a, g in zip(args, on_group):
            t = torch.from_numpy(rng.normal(size=a.shape))
            if g:
                t[..., -1] = 0.0
            tans.append(t)
        ref = evaluate(fn, args, ct, tans)
        got = {}
        for dtype in (torch.float64, torch.float32):
            def to(x):
                return x.to(device=dev, dtype=dtype)
            res = evaluate(fn, [to(a) for a in args], to(ct),
                           tuple(to(t) for t in tans))
            got[dtype] = max(float((r.double().cpu() - w).abs().max())
                             / (1 + float(w.abs().max()))
                             for r, w in zip(res, ref))
            check(all(bool(torch.isfinite(r).all()) for r in res),
                  f'autograd, {name} {dtype}: non-finite result on the card')
        sim3 = name.split('_')[0] in ('Sim3', 'sim3')
        b64, b32 = (1e-8, 1e-4) if sim3 else (1e-9, 1e-5)
        print(f'[autograd] {name}: forward, VJP, JVP at {AUTOGRAD_N}, card '
              f'against CPU float64: float64 {got[torch.float64]:.3e} '
              f'(bound {b64:g}), float32 {got[torch.float32]:.3e} (bound '
              f'{b32:g})', flush=True)
        check(got[torch.float64] <= b64 and got[torch.float32] <= b32,
              f'autograd, {name}: the card disagrees with the CPU')
        errs[name] = (got[torch.float64], got[torch.float32])
    print(f'[autograd] 32 Functions checked in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)

    gen = torch.Generator().manual_seed(0)
    X = ppt.randn_SE3(AUTOGRAD_N, generator=gen).tensor().to(dev)
    p = torch.randn((AUTOGRAD_N, 3), generator=gen).to(dev)
    jac = torch.func.vmap(torch.func.jacrev(
        lambda X, p: ppt.SE3(X).Act(p)))
    ms, J = cuda_ms(lambda: jac(X, p))
    out = ppt.SE3(X).Act(p)
    want = torch.cat([op.SE3_Act_Jacobian(out),
                      torch.zeros_like(out[..., None])], -1)
    err = float((J - want).abs().max()) / (1 + float(out.abs().max()))
    check(tuple(J.shape) == (AUTOGRAD_N, 3, 7) and err <= 1e-5,
          f'micro-jacrev: shape {tuple(J.shape)}, error {err:.3e}')
    print(f'[autograd] micro-jacrev (bench.py:130-139), vmap(jacrev(SE3(X)'
          f'.Act(p))) at {AUTOGRAD_N} in float32: {ms:.3f} ms/call, '
          f'{AUTOGRAD_N / ms * 1e3:.4e} Jacobians/s (CUDA events, median of '
          f'7; {smi}); against [I, skew(-out), 0] {err:.3e}', flush=True)
    return errs, {'ms': ms, 'jacobians_per_s': AUTOGRAD_N / ms * 1e3,
                  'err': err}


def sphere2500_variant(tag, dev, kernel=None, autodiff=False, anchor=None):
    """sphere2500 through bench.py:199-205's two-phase schedule
    (testing.two_phase) with ``kernel`` and/or residual-only factors
    (``autodiff``), cold then warm: route 'stencil', whole-solve launches
    only, one a solve; the final chi2 at pypose's anchor; with ``anchor``
    (a data/jax_anchor_*.json name) the first step within 1e-4 and the
    final within 1e-3 of the JAX package's.  Returns the cold run's launch
    counts, the final chi2 and ms per LM step cold and warm."""
    import torch
    from pypose_tpu_torch.datasets import find_data, load_g2o
    from pypose_tpu_torch.testing import pgo_optimizer, two_phase

    with open(find_data('ref_anchor_sphere2500.json')) as f:
        target = json.load(f)['final_chi2'] * (1 + 1e-4)
    if anchor is not None:
        with open(find_data(f'jax_anchor_{anchor}.json')) as f:
            anchor = json.load(f)
    ds = load_g2o(find_data('synthetic_sphere2500_seed42.g2o'), device=dev)
    kw = dict(radius=1e4, cg_tol=1e-9, kernel=kernel, autodiff=autodiff)
    opt, opt2 = (pgo_optimizer(ds, cg_iter=150, **kw),
                 pgo_optimizer(ds, cg_iter=1200, **kw))
    check(opt.route == opt2.route == 'stencil',
          f'{tag}: route {opt.route}, not stencil')
    check(all((f.batched_jacobian is None) == autodiff
              and (f.kernel is kernel) for f in opt.factors),
          f'{tag}: factors not as asked')

    def run(label):
        opt.params, opt.strategy_state = {'poses': ds['nodes']}, None
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        final, hist = two_phase(opt, opt2)
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1])
        X = opt2.params['poses'].tensor()
        check(bool(torch.isfinite(X).all()), f'{tag}: poses not finite')
        line = (f'[{tag}] {label}: chi2 history {hist}; {len(hist)} LM steps '
                f'in {ms:.3f} ms (CUDA events), {ms / len(hist):.3f} ms/LM '
                f'step; final {final:.6f}, pypose target {target:.6f}')
        if anchor is not None:
            first = hist[0] / anchor['history'][0] - 1
            last = final / anchor['final_chi2'] - 1
            line += (f'; against the JAX anchor: first step {first:.3e} '
                     f'(bound 1e-4), final {last:.3e} (bound 1e-3)')
            check(abs(first) <= 1e-4 and abs(last) <= 1e-3,
                  f'{tag}: chi2 outside its tolerance of the JAX anchor')
        print(line, flush=True)
        check(final <= target, f'{tag}: final chi2 {final} above the pypose '
              f'anchor {target}')
        return ms / len(hist), final

    reset_counts()
    cold, final = run('cold')
    counts = read_counts()
    solves = sum(len(s) for o in (opt, opt2) for s in o.cg_iterations)
    launched = {k: v for k, v in counts.items() if v and k != 'LAUNCHES'}
    check(counts['LAUNCHES'] == solves > 0 and not launched,
          f'{tag}: launch counts {counts} for {solves} solves')
    print(f'[{tag}] cold run launch counts {counts} ({solves} solves)',
          flush=True)
    warm, _ = run('warm')
    return {'counts': counts, 'final_chi2': final, 'ms_per_step_cold': cold,
            'ms_per_step_warm': warm}


def autodiff_blocks_phase(dev):
    """sphere2500's first-step Jacobian blocks on the card: the autodiff
    blocks of each residual-only factor against se3_pgo_blocks' closed
    form, within 1e-5 (1 + max|J|) (the CPU: 1.5e-6)."""
    from pypose_tpu_torch.datasets import find_data, load_g2o
    from pypose_tpu_torch.optim.sparse import SparseLM
    from pypose_tpu_torch.testing import pgo_factors
    ds = load_g2o(find_data('synthetic_sphere2500_seed42.g2o'), device=dev)
    closed, auto = pgo_factors(ds), pgo_factors(ds, autodiff=True)
    opt = SparseLM({'poses': ds['nodes']}, closed + auto)
    worst = 0.0
    for i, (c, a) in enumerate(zip(closed, auto)):
        _, Jc = opt._edge_r_jac(opt.params, c, i)
        _, Ja = opt._edge_r_jac(opt.params, a, len(closed) + i)
        Jc, Ja = Jc['poses'], Ja['poses']
        check(Ja.shape == Jc.shape, f'autodiff blocks {tuple(Ja.shape)}')
        worst = max(worst, float((Ja - Jc).abs().max())
                    / (1 + float(Jc.abs().max())))
    print(f'[sphere2500-autodiff] first step on the card: autodiff J blocks '
          f'against se3_pgo_blocks {worst:.3e} (bound 1e-5)', flush=True)
    check(worst <= 1e-5, 'sphere2500-autodiff: J blocks disagree')
    return worst


def reproj_phase(dev):
    """testing.reproj_pgo_instance (examples/reproj_pgo.py at 2,500 poses
    and 7,500 landmarks) with its anchor file's schedule, on the card
    (cold, warm) and on the CPU: route 'einsum', no kernel launched; each
    chi2 history's first step within 1e-4 and final within 1e-3 of the
    JAX anchor (data/jax_anchor_reproj_pgo.json) and the card's of the
    CPU's.  Returns the card's numbers."""
    import torch
    from pypose_tpu_torch.datasets import find_data
    from pypose_tpu_torch.testing import (reproj_pgo_instance,
                                          reproj_pgo_optimizer)
    with open(find_data('jax_anchor_reproj_pgo.json')) as f:
        anchor = json.load(f)
    sched = anchor['schedule']

    def held(hist, want, what):
        first = hist[0] / want[0] - 1
        final = hist[-1] / want[-1] - 1
        print(f'[reproj-pgo] {what}: first step {first:.3e} (bound 1e-4), '
              f'final {final:.3e} (bound 1e-3)', flush=True)
        check(abs(first) <= 1e-4 and abs(final) <= 1e-3,
              f'reproj-pgo: {what} outside its tolerance')

    hist, out = {}, {}
    for d, labels in ((dev, ('cold', 'warm')), ('cpu', ('cpu',))):
        ds = reproj_pgo_instance(device=d)
        got = {k: float((v.tensor() if hasattr(v, 'ltype') else v)
                        .double().abs().sum())
               for k, v in ds.items() if k in anchor['instance_checksum']}
        check(all(abs(got[k] - v) <= 1e-6 * abs(v)
                  for k, v in anchor['instance_checksum'].items()),
              f'reproj-pgo on {d}: instance checksum {got}')
        opt = reproj_pgo_optimizer(ds, **sched)
        check(opt.route == 'einsum', f'reproj-pgo: route {opt.route}')
        reset_counts()
        for label in labels:
            opt.params = {'poses': ds['poses'], 'landmarks': ds['landmarks']}
            opt.strategy_state = None
            w0 = time.perf_counter()
            opt.optimize(steps=sched['steps'], decreasing=sched['decreasing'],
                         patience=sched['patience'])
            if d != 'cpu':
                torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - w0) / len(opt.history)
            out[f'ms_per_step_{label}'] = ms
            print(f'[reproj-pgo] {label} on {d}: chi2 history {opt.history};'
                  f' CG iterations {opt.cg_iterations}; {ms:.3f} ms/LM step '
                  '(host clock, synchronized)', flush=True)
        counts = read_counts()
        check(not any(counts.values()),
              f'reproj-pgo on {d}: kernels launched: {counts}')
        hist[d] = list(opt.history)
        held(hist[d], anchor['history'], f'{d} against the JAX anchor')
    held(hist[dev], hist['cpu'], 'card against the CPU')
    out['final_chi2'] = hist[dev][-1]
    return out


def ba_user_residual(pose, point, camera, pixel):
    """A copy of optim.ba.reproj_residual_bal: not the same function, so
    BundleAdjustment takes its Jacobians by vmap(jacrev)."""
    import torch
    Xc = pose.Act(point)
    p = -Xc[..., :2] / Xc[..., 2:3]
    r2 = torch.sum(p * p, -1, keepdim=True)
    distortion = 1.0 + camera[..., 1:2] * r2 + camera[..., 2:3] * r2 * r2
    return camera[..., 0:1] * distortion * p - pixel


def ba_runner(tag, opt, ds, sched):
    """run(label) -> (ms, steps): ``opt.optimize`` with the cell's schedule
    from the initial problem, timed by CUDA events; prints the chi2
    history, rejections, CG iterations and host reads (BundleAdjustment's
    and the Schur CG's) and keeps the last run's in ``run.last``."""
    import torch
    from pypose_tpu_torch.optim import ba, solver

    def run(label):
        opt.poses, opt.points, opt.strategy_state = (ds['poses'],
                                                      ds['points'], None)
        reads, cg_reads = ba.HOST_READS, solver.CG_HOST_READS
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        ev[0].record()
        opt.optimize(steps=sched['steps'], patience=sched['patience'],
                     decreasing=sched['decreasing'])
        ev[1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        ms, steps = ev[0].elapsed_time(ev[1]), len(opt.history)
        run.last = {'history': list(opt.history),
                    'rejections': list(opt.rejections),
                    'cg_iterations': opt.cg_iterations,
                    'host_reads': ba.HOST_READS - reads,
                    'cg_host_reads': solver.CG_HOST_READS - cg_reads}
        print(f'[{tag}] {label}: chi2 history {opt.history}; rejections '
              f'{opt.rejections}; CG iterations per solve '
              f'{opt.cg_iterations}; host reads {run.last["host_reads"]} '
              f'(BundleAdjustment) + {run.last["cg_host_reads"]} (Schur CG);'
              f' {steps} LM steps in {ms:.3f} ms (CUDA events; host '
              f'{1e3 * wall:.3f} ms), {ms / steps:.3f} ms/LM step',
              flush=True)
        check(bool(torch.isfinite(opt.points).all())
              and bool(torch.isfinite(opt.poses.tensor()).all()),
              f'{tag}: parameters not finite')
        return ms, steps
    return run


def ba_cell(tag, dev, name, route, anchor=None, profiled=False,
            **overrides):
    """A bundle-adjustment cell through testing.ba_instance and
    ba_optimizer with its bench.py schedule (testing.BA_SCHEDULES), cold
    and warm (and profiled): the route ('dense' or 'cg') and the camera
    windows asserted, no kernel launched (the path has none), the
    instance checksum and the chi2 against the JAX anchor ``anchor``
    (the first accepted step and the final within testing.BA_HOLD).
    ``overrides`` go to ba_optimizer.  Returns the numbers and the
    optimizer."""
    import torch
    from pypose_tpu_torch.datasets import find_data
    from pypose_tpu_torch.testing import (BA_HOLD, BA_SCHEDULES, ba_instance,
                                          ba_optimizer, bal_checksum)
    sched = BA_SCHEDULES[name]
    t0 = time.perf_counter()
    ds = ba_instance(name, device=dev)
    opt = ba_optimizer(ds, name, **overrides)
    torch.cuda.synchronize()
    O = ds['pixels'].shape[0]
    print(f'[{tag}] set-up: problem and BundleAdjustment in '
          f'{time.perf_counter() - t0:.3f} s; C={opt.C} P={opt.P} O={O}, '
          f'route {"dense" if opt._use_dense_schur else "cg"}, camera '
          f'windows {opt._cam_win is not None}', flush=True)
    check(opt._use_dense_schur == (route == 'dense'),
          f'{tag}: route not {route}')
    if anchor is not None:
        with open(find_data(f'jax_anchor_{anchor}.json')) as f:
            anchor = json.load(f)
        got, want = bal_checksum(ds), anchor['instance_checksum']
        check(got['n_obs'] == want['n_obs'] and all(
            abs(got[k] - want[k]) <= 1e-9 * abs(want[k])
            for k in ('poses_abs_sum', 'points_abs_sum', 'pixels_abs_sum')),
            f'{tag}: instance checksum {got} differs from {want}')
        check(opt._cam_win is not None, f'{tag}: camera windows off')
    run = ba_runner(tag, opt, ds, sched)
    reset_counts()
    cold_ms, cold_steps = run('cold')
    counts = read_counts()
    check(not any(counts.values()), f'{tag}: kernels launched: {counts}')
    print(f'[{tag}] cold run launch counts {counts}', flush=True)
    warm_ms, warm_steps = run('warm')
    last = run.last
    hist = last['history']
    out = {'ms_per_step_cold': cold_ms / cold_steps,
           'ms_per_step_warm': warm_ms / warm_steps, 'steps': warm_steps,
           'history': hist, 'final_chi2': hist[-1],
           'rmse_px': (hist[-1] / O) ** 0.5,
           'rejections': sum(last['rejections']),
           'host_reads_per_step': (last['host_reads']
                                   + last['cg_host_reads']) / warm_steps,
           'cg_iterations_per_step': sum(map(sum, last['cg_iterations']))
           / warm_steps}
    if anchor is not None:
        first_tol, final_tol = BA_HOLD[name]
        init = anchor['initial_chi2']
        first = next(h for h in hist if h < init) / next(
            h for h in anchor['history'] if h < init) - 1
        final = hist[-1] / anchor['final_chi2'] - 1
        print(f'[{tag}] against the JAX anchor (initial {init:.7g}, '
              f'history {anchor["history"]}): first accepted step '
              f'{first:.3e} (bound {first_tol:g}), final {final:.3e} (bound '
              f'{final_tol:g}); reprojection RMSE {out["rmse_px"]:.4f} px',
              flush=True)
        check(abs(first) <= first_tol and abs(final) <= final_tol,
              f'{tag}: chi2 outside its tolerance of the JAX anchor')
        out.update(first_gap=first, final_gap=final)
    if profiled:
        ms, steps, dev_ms, n_ops = profiled_run(run)
        out.update(idle_share=1 - dev_ms / ms, device_ms=dev_ms,
                   device_ops_per_step=n_ops / steps,
                   solves=sum(map(len, run.last['cg_iterations'])))
        print(f'[{tag}] profiled run: {dev_ms:.3f} ms device time of '
              f'{ms:.3f} ms (idle share {out["idle_share"]:.4f}), {n_ops} '
              f'device operations, {n_ops / steps:.1f} an LM step',
              flush=True)
    return out, opt


def schur_pieces_ms(opt, solves, dev_ms):
    """The dense solve's Gram (optim.ba.schur_gram on a bf16 T1 of the
    cell's shape, random values) and its Cholesky factor and four solves
    (one and three refinement passes) on an SPD S of the cell's size,
    timed alone by CUDA events; their share of the profiled run's device
    time at ``solves`` dense solves; the Gram's bound (the bytes of T1
    and M once; 2 (6C)^2 3P operations at the bf16 tensor-core peak, the
    least the same product of bf16 values could take, and at the
    float32 peak, which the float32 product runs at) and one library
    call, ``torch.mm(..., out_dtype=torch.float32)`` on the bf16 values,
    where the card's torch has it."""
    import torch
    from pypose_tpu_torch.optim.ba import schur_gram
    C, P, dev = opt.C, opt.P, opt.device
    gen = torch.Generator(device=dev).manual_seed(0)
    T1 = torch.randn((3 * P, 6 * C), generator=gen, device=dev).to(
        torch.bfloat16)
    gram_ms, M = cuda_ms(lambda: schur_gram(T1))
    n = 6 * C
    flop = 2.0 * n * n * 3 * P
    bytes_ = 2 * T1.numel() + 4 * n * n
    b_bf16 = bound(bytes_, flop, 989e12)
    b_f32 = bound(bytes_, flop)
    try:
        lib_ms, M_lib = cuda_ms(lambda: torch.mm(
            T1.T, T1, out_dtype=torch.float32))
        lib_err = float((M_lib - M).abs().max() / M.abs().max())
    except (RuntimeError, TypeError) as e:
        lib_ms, lib_err = None, f'not available: {e}'[:80]
    S = (M.double() + n * torch.eye(n, device=dev,
                                    dtype=torch.float64)).float()
    rhs = torch.randn((n, 1), generator=gen, device=dev)

    def chol():
        L, _ = torch.linalg.cholesky_ex(S)
        for _ in range(4):
            torch.cholesky_solve(rhs, L)
    chol_ms, _ = cuda_ms(chol)
    out = {'gram_ms': gram_ms, 'gram_bound_ms': b_bf16[0],
           'gram_bound_by': b_bf16[1], 'gram_f32_bound_ms': b_f32[0],
           'gram_library_ms': lib_ms, 'gram_library_rel_err': lib_err,
           'cholesky_ms': chol_ms,
           'gram_share_of_device_time': solves * gram_ms / dev_ms,
           'cholesky_share_of_device_time': solves * chol_ms / dev_ms}
    print(f'[ba-trafalgar] Schur pieces alone at T1 [{3 * P}, {n}] bf16: '
          f'Gram {gram_ms:.3f} ms (bound {b_bf16[0]:.3f} ms by '
          f'{b_bf16[1]} at 989 TFLOP/s bf16; {b_f32[0]:.3f} ms at 67 '
          f'TFLOP/s float32), one library call (torch.mm, bf16 in, float32 '
          f'out) {lib_ms} (relative difference {lib_err}); Cholesky and '
          f'four solves of S [{n}, {n}] {chol_ms:.3f} ms; shares of the '
          f'profiled run\'s device time at {solves} solves: Gram '
          f'{out["gram_share_of_device_time"]:.4f}, Cholesky '
          f'{out["cholesky_share_of_device_time"]:.4f}', flush=True)
    return out


def ba_phase(dev):
    """[ba-anchored], [ba-trafalgar], [ba-large], [ba-autodiff-huber]:
    BundleAdjustment on the card (no kernel on its path: torch ops and
    library products).  Returns each cell's numbers."""
    import torch
    from pypose_tpu_torch.datasets import find_data
    from pypose_tpu_torch.testing import (BA_SCHEDULES, ba_instance,
                                          ba_optimizer)
    out = {}
    # [ba-anchored]: the JAX package's C=16 instance to pypose's chi2
    with open(find_data('ref_anchor_bal_16_300.json')) as f:
        ref = json.load(f)
    target = ref['final_chi2'] * (1 + 1e-3)
    anchored, _ = ba_cell('ba-anchored', dev, 'ba-anchored', 'dense')
    hist = anchored['history']
    hit = next((i + 1 for i, h in enumerate(hist) if h <= target), None)
    print(f'[ba-anchored] chi2 {ref["initial_chi2"]:.7g} -> {hist}; pypose '
          f'target {ref["final_chi2"]:.8g} (+1e-3) '
          + (f'hit at step {hit}' if hit else 'NOT HIT'), flush=True)
    check(hit is not None, '[ba-anchored] pypose\'s chi2 not reached')
    out['ba-anchored'] = dict(anchored, hit_step=hit)

    # [ba-trafalgar]: dense Schur at trafalgar scale
    traf, opt = ba_cell('ba-trafalgar', dev, 'ba-trafalgar', 'dense',
                        anchor='ba_trafalgar', profiled=True)
    traf.update(schur_pieces_ms(opt, traf['solves'], traf['device_ms']))
    out['ba-trafalgar'] = traf
    del opt
    torch.cuda.empty_cache()

    # [ba-large]: C=2048, auto-routed Schur-CG with windowed camera sums
    out['ba-large'], opt = ba_cell('ba-large', dev, 'ba-large', 'cg',
                                   anchor='ba_large', profiled=True)
    del opt
    torch.cuda.empty_cache()

    # [ba-autodiff-huber]: vmap(jacrev) Jacobians and a Huber kernel,
    # card against the CPU, and the closed form beside it
    name = 'ba-autodiff-huber'
    sched = BA_SCHEDULES[name]
    ds = ba_instance(name, device='cpu')
    opt = ba_optimizer(ds, name, residual=ba_user_residual)
    opt.optimize(steps=sched['steps'], patience=sched['patience'],
                 decreasing=sched['decreasing'])
    hists = {'cpu': list(opt.history)}
    auto, opt = ba_cell(f'{name} autodiff', dev, name, 'dense',
                        residual=ba_user_residual)
    hists['card'] = auto['history']
    closed_out, closed = ba_cell(f'{name} closed form', dev, name, 'dense')
    obs = closed._obs_data()
    ds = ba_instance(name, device=dev)
    T, X = ds['poses'].tensor(), ds['points']
    err = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(opt._r_jac(obs, T, X)[1:],
                              closed._r_jac(obs, T, X)[1:]))
    print(f'[{name}] Jc, Jp by vmap(jacrev) against the closed form on the '
          f'card: largest error {err:.3e} of max|J| (bound 1e-5)', flush=True)
    check(err <= 1e-5, f'[{name}] autodiff Jacobians off')
    out[name] = dict(auto, jacobian_err=err)
    out[f'{name} closed form'] = closed_out
    gaps = [abs(a / b - 1) for a, b in zip(hists['card'], hists['cpu'])]
    print(f'[{name}] card {hists["card"]} against the CPU {hists["cpu"]}: '
          f'largest relative gap {max(gaps):.3e} (bound 1e-5)', flush=True)
    check(len(hists['card']) == len(hists['cpu']) and max(gaps) <= 1e-5,
          f'[{name}] card and CPU chi2 differ')
    out[name]['card_cpu_gap'] = max(gaps)
    return out


# ---------------------------------------------------------------------------
# 23.-28. IMU preintegration, the dense optimizers, SparseLM's other
# strategies and the point-cloud filters (no kernel on these paths)
# ---------------------------------------------------------------------------

def synced_ms(fn):
    """(host milliseconds of ``fn()`` between two synchronizations, its
    result)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def profiled_call(fn):
    """One call of ``fn`` under torch.profiler: (host ms between
    synchronizations, device ms, device operations), as
    :func:`device_totals` reads them."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ms, _ = synced_ms(fn)
    return (ms, *device_totals(prof))


def no_launches(tag):
    counts = read_counts()
    check(not any(counts.values()),
          f'{tag}: a path without kernels launched some: {counts}')
    return counts


def imu_last_frame(out):
    """rot, vel, pos at the last frame, the 9x9 cov (float64 numpy) and
    |q| at the last frame."""
    import numpy as np
    res = {}
    for k in ('rot', 'vel', 'pos', 'cov'):
        v = out[k].tensor() if hasattr(out[k], 'tensor') else out[k]
        v = v.detach().cpu().double().numpy()[0]
        res[k] = v if k == 'cov' else v[-1]
    res['q_norm'] = float(np.linalg.norm(res['rot']))
    return res


# card against the port's CPU run: the largest difference of each quantity
# within this share of its largest magnitude (the measured gap is printed)
IMU_CARD_CPU_RTOL = 1e-5


def imu_phase(dev):
    """imu-1m: bench.py:bench_imu at B = 1, F = 1,000,000 (float32,
    reset, with the covariance), cold, warm and profiled; the last frame
    against data/jax_anchor_imu_1m.json (twice the port's CPU spread plus
    1e-6 of the quantity's magnitude, tests/test_torch_imu_anchor.py) and
    against the port's CPU run (IMU_CARD_CPU_RTOL)."""
    import numpy as np
    import torch
    from pypose_tpu_torch.datasets import find_data
    from pypose_tpu_torch.module import IMUPreintegrator
    from pypose_tpu_torch.testing import imu_instance

    with open(find_data('jax_anchor_imu_1m.json')) as f:
        anchor = json.load(f)
    F = 1_000_000
    t0 = time.perf_counter()
    x = imu_instance('bench', F, device=dev)
    integ = IMUPreintegrator(reset=True, prop_cov=True, device=dev)
    torch.cuda.synchronize()
    print(f'[imu-1m] set-up: input and module in '
          f'{time.perf_counter() - t0:.3f} s', flush=True)
    reset_counts()
    cold_ms, out = synced_ms(lambda: integ(*x))
    counts = no_launches('imu-1m')
    warm = [synced_ms(lambda: integ(*x))[0] for _ in range(3)]
    warm_ms = statistics.median(warm)
    prof_ms, dev_ms, n_ops = profiled_call(lambda: integ(*x))
    got = imu_last_frame(out)
    t0 = time.perf_counter()
    cpu = imu_last_frame(IMUPreintegrator(reset=True, prop_cov=True)(
        *imu_instance('bench', F, device='cpu')))
    cpu_s = time.perf_counter() - t0
    gaps, bad = {}, []
    for k in ('rot', 'vel', 'pos', 'cov', 'q_norm'):
        want = np.asarray(anchor['float32'][k])
        tol = 2 * anchor['port_cpu_spread'][k] + 1e-6 * np.abs(want).max()
        err = float(np.abs(np.asarray(got[k]) - want).max())
        cerr = float(np.abs(np.asarray(got[k]) - np.asarray(cpu[k])).max())
        ctol = IMU_CARD_CPU_RTOL * max(np.abs(want).max(), 1e-30)
        gaps[k] = {'anchor': err, 'anchor_tol': tol, 'cpu': cerr,
                   'cpu_tol': ctol}
        if not (err <= tol and cerr <= ctol):
            bad.append(k)
    print(f'[imu-1m] last frame on the card: rot {got["rot"].tolist()}, vel '
          f'{got["vel"].tolist()}, pos {got["pos"].tolist()}; |q| '
          f'{got["q_norm"]:.8f} (JAX anchor {anchor["float32"]["q_norm"]:.8f}'
          f', 0.99120563 expected; float64 pos {anchor["float64"]["pos"]})',
          flush=True)
    print(f'[imu-1m] largest difference and its bound, against the JAX '
          f'anchor and against the port\'s CPU run ({cpu_s:.2f} s): {gaps}',
          flush=True)
    check(not bad, f'imu-1m: {bad} outside their tolerances')
    check(all(np.isfinite(np.asarray(v)).all() for v in got.values()),
          'imu-1m: a result is not finite')
    out = {'frames': F, 'ms_cold': cold_ms, 'ms_warm': warm_ms,
           'ms_warm_runs': warm, 'frames_per_s': F / (warm_ms / 1e3),
           'ms_profiled': prof_ms, 'device_ms': dev_ms,
           'idle_share': 1 - dev_ms / prof_ms, 'device_ops_per_call': n_ops,
           'q_norm': got['q_norm'], 'counts': counts}
    print(f'[imu-1m] {F} frames: cold {cold_ms:.3f} ms, warm {warm_ms:.3f} '
          f'ms (median of {warm}) = {out["frames_per_s"]:.4e} frames/s; '
          f'profiled call {prof_ms:.3f} ms, device {dev_ms:.3f} ms (idle '
          f'share {out["idle_share"]:.4f}), {n_ops} device operations; '
          f'launch counts {counts}', flush=True)
    return out


def imu_synth_phase(dev):
    """imu-synth: testing.imu_instance('synth', 100_000) through
    IMUPreintegrator(reset=False) in two halves, on the card against the
    CPU in float32 (every output of both calls and the carried state: pos,
    rot, vel, cov and Rij), and in float64 on the card against one call
    over all frames.  float32 bound: each frame's so3 Exp takes sin and
    cos of its own angle, whose last bits differ between the card's and
    the CPU's math libraries, and the unrenormalised product carries every
    such bit through 1e5 frames; so each quantity is held within twice the
    largest gap that one-ulp nudges of the input (gyro up, gyro down, acc
    up) make on the CPU in this run.  float64: on the card against one call
    over all
    frames (rot, vel, pos and Rij continue exactly up to rounding: 1e-7
    of each quantity's magnitude; float32's unrenormalised quaternion
    products drift apart between the two ways, so the float32 halves are
    held to the CPU's halves).  The covariance continued across calls is
    not the one-call covariance in either package (the reference's
    ascending product A_1 ... A_F does not split at a call boundary), so
    the float64 halves' covariance is held to the CPU's (1e-9)."""
    import torch
    from pypose_tpu_torch.module import IMUPreintegrator
    from pypose_tpu_torch.testing import imu_instance

    F, h = 100_000, 50_000

    def halves(d, dtype, nudge=None):
        x = imu_instance('synth', F, device=d, dtype=dtype)
        if nudge is not None:
            i, sign = nudge
            x = list(x)
            x[i] = torch.nextafter(x[i], torch.full_like(x[i], sign * 1e30))
        m = IMUPreintegrator(reset=False, prop_cov=True, dtype=dtype,
                             device=d)
        outs = [m(*(v[:, :h] for v in x)), m(*(v[:, h:] for v in x))]
        state = {k: getattr(m, k) for k in ('pos', 'rot', 'vel', 'cov')}
        state['Rij'] = m.Rij
        return outs, state, x

    def arr(v):
        v = v.tensor() if hasattr(v, 'tensor') else v
        return v.detach().cpu().double()

    def rel_gap(a, b):
        a, b = arr(a), arr(b)
        return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))

    def all_gaps(a, b):
        (ao, astate), (bo, bstate) = a, b
        gaps = {f'call{i + 1}.{k}': rel_gap(ao[i][k], bo[i][k])
                for i in range(2) for k in ('rot', 'vel', 'pos', 'cov')}
        gaps.update({f'state.{k}': rel_gap(astate[k], bstate[k])
                     for k in astate})
        return gaps

    reset_counts()
    card = halves(dev, torch.float32)[:2]
    counts = no_launches('imu-synth')
    cpu = halves('cpu', torch.float32)[:2]
    gaps = all_gaps(card, cpu)
    nudged = [all_gaps(halves('cpu', torch.float32, n)[:2], cpu)
              for n in ((1, 1), (1, -1), (2, 1))]
    bound = {k: 2 * max(g[k] for g in nudged) for k in gaps}
    print(f'[imu-synth] float32 halves, card against CPU (relative to each '
          f'quantity\'s magnitude) and the bound (twice the CPU\'s one-ulp '
          f'nudge spread): ' + ', '.join(
              f'{k} {gaps[k]:.3e} ({bound[k]:.3e})' for k in gaps),
          flush=True)
    check(all(gaps[k] <= bound[k] for k in gaps),
          'imu-synth: card and CPU halves differ by more than the nudge '
          'spread')
    h64, s64, x64 = halves(dev, torch.float64)
    c64 = halves('cpu', torch.float64)[0]
    one = IMUPreintegrator(reset=False, prop_cov=True, dtype=torch.float64,
                           device=dev)
    whole = one(*x64)
    cont = {k: rel_gap(arr(h64[1][k])[0, -1], arr(whole[k])[0, -1])
            for k in ('rot', 'vel', 'pos')}
    cont['Rij'] = rel_gap(s64['Rij'], one.Rij)
    cov_cpu = rel_gap(h64[1]['cov'], c64[1]['cov'])
    cov_one = rel_gap(h64[1]['cov'], whole['cov'])
    print(f'[imu-synth] float64 on the card, two halves against one call: '
          f'{cont} (bound 1e-7); the halves\' covariance against the CPU\'s '
          f'{cov_cpu:.3e} (bound 1e-9), against one call\'s {cov_one:.3e} '
          f'(the reference\'s product order); launch counts {counts}',
          flush=True)
    check(max(cont.values()) <= 1e-7 and cov_cpu <= 1e-9,
          'imu-synth: the float64 continuation differs')
    return {'card_cpu_gap': gaps, 'bound': bound,
            'continuation_gap_f64': max(cont.values()),
            'cov_halves_vs_one_call_f64': cov_one}


def batch_lm_phase(dev):
    """batch-lm: bench.py:bench_batch_lm at B = 4,096, 4 steps,
    Constant(1e-6), targets testing.batch_lm_instance(4096, 7), cold,
    warm and profiled; no host read inside the solve
    (torch.cuda.set_sync_debug_mode('error') around one), one to read the
    max loss; each problem's loss within 1e-10 of
    data/jax_anchor_batch_lm.json and below 1e-8, the params checksum
    within 1e-6; the card against the port's CPU run (losses 1e-10,
    params 1e-5)."""
    import numpy as np
    import torch
    from pypose_tpu_torch.datasets import find_data
    from pypose_tpu_torch.optim import make_batch_optimizer
    from pypose_tpu_torch.optim.strategy import Constant
    from pypose_tpu_torch.testing import batch_lm_instance

    with open(find_data('jax_anchor_batch_lm.json')) as f:
        anchor = json.load(f)
    B, steps = 4096, 4

    def checksum(v):
        v = v.tensor() if hasattr(v, 'tensor') else v
        return float(v.detach().double().abs().sum())

    targets, model = batch_lm_instance(B, 7, device=dev)
    solve = make_batch_optimizer(model, steps=steps,
                                 strategy=Constant(damping=1e-6))
    reset_counts()
    cold_ms, (params, losses) = synced_ms(lambda: solve(targets))
    counts = no_launches('batch-lm')
    warm = [synced_ms(lambda: solve(targets))[0] for _ in range(3)]
    warm_ms = statistics.median(warm)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        params, losses = solve(targets)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    max_loss = float(losses.max())          # the solve's one host read
    prof_ms, dev_ms, n_ops = profiled_call(lambda: solve(targets))
    la = np.asarray(anchor['losses'])
    lerr = float(np.abs(losses.double().cpu().numpy() - la).max())
    prel = checksum(params['pose']) / anchor['params_checksum'] - 1
    trel = checksum(targets) / anchor['targets_checksum'] - 1
    t0 = time.perf_counter()
    ct, cm = batch_lm_instance(B, 7, device='cpu')
    cparams, closses = make_batch_optimizer(
        cm, steps=steps, strategy=Constant(damping=1e-6))(ct)
    cpu_s = time.perf_counter() - t0
    cl = float((losses.cpu() - closses).abs().max())
    cp = float((params['pose'].tensor().cpu()
                - cparams['pose'].tensor()).abs().max())
    print(f'[batch-lm] {B} problems x {steps} steps: max loss {max_loss:.3e} '
          f'(JAX anchor {anchor["max_loss"]:.3e}); each loss within '
          f'{lerr:.3e} of the anchor (bound 1e-10), params checksum '
          f'{prel:.3e}, targets checksum {trel:.3e} (bounds 1e-6); card '
          f'against the CPU ({cpu_s:.2f} s): losses {cl:.3e} (1e-10), params '
          f'{cp:.3e} (1e-5)', flush=True)
    check(max_loss < 1e-8 and lerr <= 1e-10 and abs(prel) <= 1e-6
          and abs(trel) <= 1e-6, 'batch-lm: outside the JAX anchor')
    check(cl <= 1e-10 and cp <= 1e-5, 'batch-lm: card and CPU differ')
    out = {'problems': B, 'steps': steps, 'ms_cold': cold_ms,
           'ms_warm': warm_ms, 'ms_warm_runs': warm,
           'problems_per_s': B / (warm_ms / 1e3), 'max_loss': max_loss,
           'host_reads_in_solve': 0, 'host_reads_per_solve': 1,
           'ms_profiled': prof_ms, 'device_ms': dev_ms,
           'idle_share': 1 - dev_ms / prof_ms, 'device_ops_per_solve': n_ops,
           'counts': counts}
    print(f'[batch-lm] cold {cold_ms:.3f} ms, warm {warm_ms:.3f} ms (median '
          f'of {warm}) = {out["problems_per_s"]:.4e} problems/s; host reads '
          f'a solve: 0 inside it (sync debug mode "error" raised nothing), 1 '
          f'for the max loss; profiled solve {prof_ms:.3f} ms, device '
          f'{dev_ms:.3f} ms (idle share {out["idle_share"]:.4f}), {n_ops} '
          f'device operations; launch counts {counts}', flush=True)
    return out


def dense_lm_phase(dev):
    """dense-lm: .claude/skills/verify/SKILL.md's flow 2 on the card, a
    PoseInv module (2 x 2 se3 from zero, SE3 inputs of sigma 0.3) through
    LM under StopOnPlateau: the loss from ~1 to below 1e-6 within 5 steps; GN's steps and a
    make_batch_optimizer solve (64 problems) on the card against the
    CPU (losses 1e-4 relative plus 1e-9, parameters 1e-5)."""
    import torch
    import pypose_tpu_torch as pp
    from pypose_tpu_torch.optim.scheduler import StopOnPlateau
    from pypose_tpu_torch.optim.strategy import Constant
    from pypose_tpu_torch.testing import batch_lm_instance

    start = pp.identity_se3(2, 2)
    inp = pp.randn_SE3(2, 2, sigma=0.3,
                       generator=torch.Generator().manual_seed(1))

    class PoseInv(pp.Module):
        def __init__(self):
            super().__init__()
            self.pose = pp.Parameter(pp.se3(start.tensor().clone()))

        def forward(self, x):
            return (self.pose.Exp() @ x).Log().tensor()

    reset_counts()
    m = PoseInv().to(dev)
    x = inp.to(dev)
    opt = pp.optim.LM(m)
    initial = float(opt.model.loss(opt._params(), x))
    ms, loss = synced_ms(lambda: StopOnPlateau(
        opt, steps=10, patience=3, decreasing=1e-9).optimize(x))
    hit = next((i + 1 for i, h in enumerate(opt.history) if h < 1e-6), None)
    print(f'[dense-lm] LM + StopOnPlateau: loss {initial:.4e} -> '
          f'{opt.history} ({ms:.3f} ms, one host read); below 1e-6 at step '
          f'{hit}', flush=True)
    check(0.1 < initial < 10 and hit is not None and hit < 6,
          'dense-lm: the loss did not fall below 1e-6 within 5 steps')
    hist = {}
    for d in (dev, 'cpu'):
        g = PoseInv().to(d)
        o = pp.optim.GN(g)
        hist[str(d)] = ([o.step(inp.to(d)) for _ in range(5)],
                        g.pose.tensor().detach().cpu())
    (gc, pc), (gh, ph) = hist[str(dev)], hist['cpu']
    gap = max(abs(a - b) / (abs(b) + 1e-5) for a, b in zip(gc, gh))
    pgap = float((pc - ph).abs().max())
    print(f'[dense-lm] GN 5 steps, card {gc}, CPU {gh}; parameters '
          f'{pgap:.3e} apart', flush=True)
    check(all(abs(a - b) <= 1e-4 * abs(b) + 1e-9 for a, b in zip(gc, gh))
          and pgap <= 1e-5, 'dense-lm: GN card and CPU differ')
    res = {}
    for d in (dev, 'cpu'):
        tg, mod = batch_lm_instance(64, 3, device=d)
        res[str(d)] = pp.optim.make_batch_optimizer(
            mod, steps=4, strategy=Constant(damping=1e-6))(tg)
    (bp, bl), (cp, cl) = res[str(dev)], res['cpu']
    lgap = float((bl.cpu() - cl).abs().max())
    bgap = float((bp['pose'].tensor().cpu() - cp['pose'].tensor()).abs()
                 .max())
    print(f'[dense-lm] make_batch_optimizer, 64 problems: card against CPU '
          f'losses {lgap:.3e}, params {bgap:.3e}', flush=True)
    check(lgap <= 1e-9 and bgap <= 1e-5 and float(bl.max()) < 1e-8,
          'dense-lm: the batched solve differs between card and CPU')
    counts = no_launches('dense-lm')
    return {'history': opt.history, 'ms': ms, 'gn_gap': gap,
            'batch_gap': lgap, 'counts': counts}


def sparse_strategies_phase(dev):
    """sparse-strategies: sphere2500 (phase 4's factors) through SparseLM
    with Adaptive for three LM steps, route 'stencil', one whole-solve
    launch a solve, card against the port's CPU run of the same schedule:
    - Adaptive() with phase 4's capped CG (cg_iter 150, cg_tol 1e-9): its
      damping sits at its floor (1e-6), the capped CG does not converge
      and its last bits follow the summation order (three CPU processes
      gave first steps 3216.6526, 3216.6597 and 3216.6755), so each step
      is held within 1e-3, as phase 4 holds its first step;
    - Adaptive(damping=1e-2) with converged solves (cg_iter 500, cg_tol
      1e-6: 87, 138 and 228 iterations on the CPU), whose damping halves
      each step: each step within 1e-5."""
    from pypose_tpu_torch.optim.strategy import Adaptive
    out = {}
    for tag, strategy, cg, bound in (
            ('Adaptive()', Adaptive, (150, 1e-9), 1e-3),
            ('Adaptive(damping=1e-2)', lambda: Adaptive(damping=1e-2),
             (500, 1e-6), 1e-5)):
        hist = {}
        for d in (dev, 'cpu'):
            _, mk = sphere2500_problem(d)
            opt = mk(*cg, strategy=strategy())
            check(opt.route == 'stencil', f'sparse-strategies: route '
                  f'{opt.route}')
            if d == dev:
                reset_counts()
            h, its, damp = [], [], []
            for _ in range(3):
                h.append(opt.step())
                its.append(opt.cg_iterations[0])
                damp.append(opt.strategy_state['damping'].item())
            if d == dev:
                counts, solves = read_counts(), sum(len(i) for i in its)
            hist[str(d)] = (h, its, damp)
        (card, its, dcard), (cpu, cits, dcpu) = hist[str(dev)], hist['cpu']
        gaps = [abs(a / b - 1) for a, b in zip(card, cpu)]
        print(f'[sparse-strategies] {tag}, cg_iter {cg[0]}, cg_tol {cg[1]}: '
              f'chi2 card {card}, CPU {cpu} (largest relative gap '
              f'{max(gaps):.3e}, bound {bound}); CG iterations card {its}, '
              f'CPU {cits}; damping {dcard} / {dcpu}; launch counts '
              f'{counts}', flush=True)
        check(max(gaps) <= bound, f'sparse-strategies: {tag} card and CPU '
              'chi2 differ')
        check(counts['LAUNCHES'] == solves and counts['FUSED_LAUNCHES'] == 0
              and not any(v for k, v in counts.items() if k != 'LAUNCHES'),
              f'sparse-strategies: {counts["LAUNCHES"]} whole-solve launches '
              f'for {solves} solves')
        out[tag] = {'history': card, 'card_cpu_gap': max(gaps),
                    'damping': dcard, 'counts': counts}
    out['counts'] = {'LAUNCHES': sum(v['counts']['LAUNCHES']
                                     for v in out.values())}
    return out


def filters_phase(dev):
    """filters: nbr_filter, knn_filter (the dense 4,096^2 distance matrix),
    voxel_filter (mean and random) and random_filter on a 4,096-point
    cloud (torch.Generator seed 0) on the card against the CPU, the
    random ones from equal generators: equal masks and rows, values
    within 1e-5."""
    import torch
    import pypose_tpu_torch as pp
    pts = torch.randn(4096, 3, generator=torch.Generator().manual_seed(0))

    def run(d):
        P = pts.to(d)
        return {'nbr': pp.nbr_filter(P, 8, 0.25, return_mask=True)[1],
                'knn': pp.knn_filter(P, 8),
                'knn_radius': pp.knn_filter(P, 4, radius=0.25),
                'voxel': pp.voxel_filter(P, [0.25, 0.25, 0.25]),
                'voxel_random': pp.voxel_filter(
                    P, [0.25] * 3, random=True,
                    generator=torch.Generator().manual_seed(1)),
                'random': pp.random_filter(
                    P, 1000, torch.Generator().manual_seed(2))}
    reset_counts()
    ms, card = synced_ms(lambda: run(dev))
    counts = no_launches('filters')
    cpu = run('cpu')
    gaps = {}
    for k in card:
        a, b = card[k].cpu(), cpu[k]
        check(a.shape == b.shape, f'filters: {k} shapes {tuple(a.shape)} '
              f'and {tuple(b.shape)}')
        gaps[k] = float((a.double() - b.double()).abs().max()) if \
            a.numel() else 0.0
    print(f'[filters] 4,096 points: card {ms:.3f} ms; card against CPU '
          f'{gaps} (bound 1e-5; masks equal); kept {int(cpu["nbr"].sum())} '
          f'by nbr_filter, {cpu["voxel"].shape[0]} voxels; launch counts '
          f'{counts}', flush=True)
    check(max(gaps.values()) <= 1e-5, 'filters: card and CPU differ')
    return {'ms': ms, 'gaps': gaps}


# ---------------------------------------------------------------------------
# EPnP, the filters' rollouts and MPC (no kernel on their paths)
# ---------------------------------------------------------------------------

def lstsq_phase(dev):
    """lstsq: what torch.linalg.lstsq does on the card (its one CUDA
    driver, gels) on 5 x (6, 10) float32 systems and on 5 x (6, 6) systems
    of exact rank 4 (integer factors; EPnP's N = 4 and N = 3 beta
    systems), recorded and not relied on; then LSTSQ on the card (the SVD
    minimum-norm route) against LSTSQ on the CPU (gelsy, which the CPU
    tests hold to the JAX package) on the same arrays, within 1e-5 (1 +
    magnitude)."""
    import numpy as np
    import torch
    from pypose_tpu_torch.optim.solver import LSTSQ
    rng = np.random.default_rng(0)
    cases = {'6x10': rng.normal(size=(5, 6, 10)),
             '6x6 rank 4': rng.integers(-3, 4, size=(5, 6, 4))
             @ rng.integers(-3, 4, size=(5, 4, 6))}
    b = torch.tensor(rng.normal(size=(5, 6)), dtype=torch.float32)
    gaps = {}
    for name, A in cases.items():
        A = torch.tensor(A, dtype=torch.float32)
        want = LSTSQ()(A, b)
        try:
            lib = torch.linalg.lstsq(A.to(dev), b.to(dev)[..., None]
                                     ).solution[..., 0].cpu()
            lib_note = (f'returns; largest gap from the minimum-norm answer '
                        f'{float((lib - want).abs().max()):.3e}, finite '
                        f'{bool(torch.isfinite(lib).all())}')
        except RuntimeError as e:
            lib_note = f'raises {type(e).__name__}: {str(e).splitlines()[0]}'
        got = LSTSQ()(A.to(dev), b.to(dev)).cpu()
        gaps[name] = float((got - want).abs().max())
        print(f'[lstsq] {name}: torch.linalg.lstsq on the card {lib_note}; '
              f'LSTSQ on the card (SVD route) against the CPU\'s: largest '
              f'gap {gaps[name]:.3e}', flush=True)
        check(gaps[name] <= 1e-5 * (1 + float(want.abs().max())),
              f'lstsq: LSTSQ on the card is off the CPU\'s at {name}')
    return gaps


def epnp_phase(dev):
    """[epnp] and [epnp-refine]: testing.epnp_instance(B) (bench.py:
    bench_modules' shapes and intrinsics, numpy-drawn, float32) through
    EPnP at B = 10,000 (refine=False) and B = 16 (refine=True), cold, warm
    (median of 3) and profiled; poses/s, the pose errors against the true
    poses, the chosen candidates; held by testing.epnp_failures to
    data/jax_anchor_epnp.json and to the port's CPU run on the same
    instance (every problem)."""
    import torch
    from pypose_tpu_torch.datasets import find_data
    from pypose_tpu_torch.module import EPnP
    from pypose_tpu_torch.testing import (EPNP_CELLS, epnp_failures,
                                          epnp_instance, epnp_solve,
                                          epnp_stats)
    with open(find_data('jax_anchor_epnp.json')) as f:
        anchor = json.load(f)
    out = {}
    for name, (B, refine) in EPNP_CELLS.items():
        d = epnp_instance(B, device=dev)
        check(abs(float(d['pixels'].double().abs().sum())
                  / anchor[name]['instance_checksum'] - 1) < 1e-12,
              f'{name}: the instance is not the anchor\'s')
        epnp = EPnP(intrinsics=d['intrinsics'], refine=refine)

        def run():
            return epnp(d['points'], d['pixels'])
        reset_counts()
        cold_ms, _ = synced_ms(run)
        counts = no_launches(name)
        warm = [synced_ms(run)[0] for _ in range(3)]
        warm_ms = statistics.median(warm)
        prof_ms, dev_ms, n_ops = profiled_call(run)
        # the 12 x 12 eigh of this instance's M^T M: the path's float64
        # (cast in and out included) against float32
        c = epnp._candidates(d['points'], d['pixels'], d['intrinsics'])
        MtM = epnp._mtm(d['pixels'], c['alpha'], d['intrinsics'])
        eigh_ms = {
            'float64': cuda_ms(lambda: torch.linalg.eigh(
                MtM.double())[1].float())[0],
            'float32': cuda_ms(lambda: torch.linalg.eigh(MtM)[1])[0]}
        card = epnp_solve(d, refine)
        t0 = time.perf_counter()
        cpu = epnp_solve(epnp_instance(B, device='cpu'), refine)
        cpu_s = time.perf_counter() - t0
        bad, nums = epnp_failures(name, anchor[name], *card)
        cbad, cnums = epnp_failures(
            f'{name} card-cpu', {'stats': epnp_stats(cpu[2]),
                                 'candidates': cpu[1], 'poses': cpu[0],
                                 'errors': cpu[2]}, *card)
        res = {'B': B, 'refine': refine, 'ms_cold': cold_ms,
               'ms_warm': warm_ms, 'ms_warm_runs': warm,
               'poses_per_s': B / (warm_ms / 1e3), 'ms_profiled': prof_ms,
               'device_ms': dev_ms, 'idle_share': 1 - dev_ms / prof_ms,
               'device_ops_per_call': n_ops, 'anchor': nums,
               'card_cpu': cnums, 'cpu_s': cpu_s, 'eigh_ms': eigh_ms,
               'counts': counts}
        print(f'[{name}] B={B} n=12 refine={refine}: cold {cold_ms:.3f} ms, '
              f'warm {warm_ms:.3f} ms (median of {warm}) = '
              f'{res["poses_per_s"]:.4e} poses/s; profiled call '
              f'{prof_ms:.3f} ms, device {dev_ms:.3f} ms (idle share '
              f'{res["idle_share"]:.4f}), {n_ops} device operations; pose '
              f'error median {nums["stats"]["median"]:.3e}, p99 '
              f'{nums["stats"]["p99"]:.3e}, max {nums["stats"]["max"]:.3e} '
              f'(JAX anchor {anchor[name]["stats"]}); candidate flips '
              f'against the JAX anchor {nums["flips"]}, against the CPU '
              f'{cnums["flips"]}; largest pose gap to the anchor\'s first '
              f'{len(anchor[name]["poses"])} {nums["pose_gap"]:.3e}, to the '
              f'CPU {cnums["pose_gap"]:.3e} (CPU run {cpu_s:.2f} s); the '
              f'eigh of M^T M (CUDA events, median of 7) '
              f'{eigh_ms["float64"]:.3f} ms in float64, '
              f'{eigh_ms["float32"]:.3f} ms in float32; launch counts '
              f'{counts}', flush=True)
        check(not bad and not cbad, f'{name}: {bad + cbad}')
        check(all(bool(torch.isfinite(torch.as_tensor(v)).all())
                  for v in card), f'{name}: a result is not finite')
        out[name] = res
    return out


def filters_rollout_phase(dev):
    """[ekf], [ukf], [pf]: filter_rollout over testing.filter_instance(1000)
    (bench.py:bench_filters' pendulum, N = 2, Q = 1e-4 I, R = 1e-2 I,
    numpy-drawn, float32); the PF of 1,000 particles from a torch.Generator
    seeded 0.  Each cold, warm (median of 2) and profiled, in steps/s;
    held by testing.filter_failures to data/jax_anchor_filters.json (the
    PF by its RMSE against the true state: its draws differ) and to the
    port's CPU run.  The PF is held to the CPU's on the same draws
    (testing.pf_draws, made on the CPU) in float64, where no resampling
    index flips: in float32 the cumulative sums' last bits differ between
    the devices, and a uniform draw that falls between them picks another
    particle (on the CPU, a float32 cumsum summed in another order moved
    the estimates by 6e-3 within 50 steps)."""
    import numpy as np
    import torch
    from pypose_tpu_torch.datasets import find_data
    from pypose_tpu_torch.testing import (FILTER_CELLS, filter_failures,
                                          filter_instance, filter_rmse,
                                          filter_rollouts, filter_summary,
                                          pf_draws)
    with open(find_data('jax_anchor_filters.json')) as f:
        anchor = json.load(f)
    d = filter_instance(device=dev)
    check(abs(float(d['ys'].double().abs().sum())
              / anchor['instance_checksum'] - 1) < 1e-12,
          'filters: the instance is not the anchor\'s')
    T = d['ys'].shape[0]
    t0 = time.perf_counter()
    cpu, dc = filter_rollouts('cpu', kinds=('ekf', 'ukf'))
    cpu_s = time.perf_counter() - t0
    cpu_ref = filter_summary(cpu, dc['truth'])
    out = {}
    for kind in FILTER_CELLS:
        def run():
            return filter_rollouts(dev, kinds=(kind,), d=d)[0]
        reset_counts()
        cold_ms, card = synced_ms(run)
        counts = no_launches(kind)
        warm = [synced_ms(run)[0] for _ in range(2)]
        warm_ms = statistics.median(warm)
        prof_ms, dev_ms, n_ops = profiled_call(run)
        bad, gaps = filter_failures(anchor, d['truth'], card)
        if kind == 'pf':
            d64 = {k: v.double() for k, v in d.items()}
            draws = pf_draws(T)
            card64 = filter_rollouts(
                dev, kinds=('pf',), d=d64,
                draws=tuple(v.to(dev) for v in draws))[0]
            cpu64 = filter_rollouts(
                'cpu', kinds=('pf',), d={k: v.cpu() for k, v in d64.items()},
                draws=draws)[0]
            cbad, cgaps = filter_failures(filter_summary(cpu64, dc['truth']),
                                          dc['truth'], card64, exact=('pf',),
                                          tol=1e-9)
        else:
            cbad, cgaps = filter_failures(cpu_ref, dc['truth'], card,
                                          exact=(kind,))
        xs = card[kind][0]
        res = {'T': T, 'ms_cold': cold_ms, 'ms_warm': warm_ms,
               'ms_warm_runs': warm, 'steps_per_s': T / (warm_ms / 1e3),
               'ms_profiled': prof_ms, 'device_ms': dev_ms,
               'idle_share': 1 - dev_ms / prof_ms,
               'device_ops_per_call': n_ops,
               'rmse': filter_rmse(xs, d['truth']),
               'rmse_jax': anchor[kind]['rmse'], 'anchor_gaps': gaps,
               'cpu_gaps': cgaps, 'counts': counts}
        print(f'[{kind}] {T}-step rollout: cold {cold_ms:.3f} ms, warm '
              f'{warm_ms:.3f} ms (median of {warm}) = '
              f'{res["steps_per_s"]:.4e} steps/s; profiled call '
              f'{prof_ms:.3f} ms, device {dev_ms:.3f} ms (idle share '
              f'{res["idle_share"]:.4f}), {n_ops} device operations; RMSE '
              f'against the true state {res["rmse"]:.6f} (JAX '
              f'{res["rmse_jax"]:.6f}); gaps to the JAX anchor {gaps}, to '
              f'the CPU run {cgaps}'
              + (' (float64, the same draws)' if kind == 'pf' else '')
              + f' (CPU EKF and UKF rollouts {cpu_s:.2f} s); launch counts '
              f'{counts}', flush=True)
        check(not bad and not cbad, f'{kind}: {bad + cbad}')
        check(bool(np.isfinite(xs.detach().cpu().numpy()).all()),
              f'{kind}: an estimate is not finite')
        out[kind] = res
    return out


def mpc_phase(dev):
    """[mpc] and [mpc-ls]: bench.py:bench_modules' cart-pole through MPC at
    T = 32 (ReduceToBason(steps=5)) and at T = 128 (line_search=True,
    ReduceToBason(steps=30)), float32, cold, warm and profiled, with the
    host reads of the iteration loops; cost and tail max|theta| held by
    testing.mpc_failures to data/jax_anchor_mpc.json (1e-4 relative, 1e-3)
    and to the port's CPU run (1e-4 relative and 1e-4: twice the CPU's
    spread under +-3-ulp nudges of theta0, 4.3e-5 and 3.6e-5 at T = 32)."""
    import torch
    from pypose_tpu_torch.datasets import find_data
    from pypose_tpu_torch.module import mpc as mpc_mod
    from pypose_tpu_torch.testing import (MPC_CELLS, mpc_cell, mpc_failures,
                                          mpc_tail)
    with open(find_data('jax_anchor_mpc.json')) as f:
        anchor = json.load(f)
    out = {}
    for name, (T, steps, ls) in MPC_CELLS.items():
        reset_counts()
        reads = mpc_mod.HOST_READS
        cold_ms, (x, u, cost) = synced_ms(lambda: mpc_cell(name, dev))
        counts = no_launches(name)
        reads = mpc_mod.HOST_READS - reads
        warm = [synced_ms(lambda: mpc_cell(name, dev))[0]
                for _ in range(2)]
        warm_ms = statistics.median(warm)
        prof_ms, dev_ms, n_ops = profiled_call(
            lambda: mpc_cell(name, dev))
        t0 = time.perf_counter()
        cx, _, ccost = mpc_cell(name, 'cpu')
        cpu_s = time.perf_counter() - t0
        bad = mpc_failures(name, anchor[name], x, cost)
        cbad = mpc_failures(name, {'cost': float(ccost[0]),
                                   'tail': mpc_tail(cx)}, x, cost,
                            rtol=1e-4, tail_tol=1e-4, against='the CPU')
        c = float(cost[0])
        res = {'T': T, 'line_search': ls, 'ms_cold': cold_ms,
               'ms_warm': warm_ms, 'ms_warm_runs': warm,
               'ms_profiled': prof_ms, 'device_ms': dev_ms,
               'idle_share': 1 - dev_ms / prof_ms,
               'device_ops_per_call': n_ops, 'host_reads': reads,
               'cost': c, 'tail': mpc_tail(x), 'cost_cpu': float(ccost[0]),
               'tail_cpu': mpc_tail(cx), 'cost_jax': anchor[name]['cost'],
               'tail_jax': anchor[name]['tail'], 'cpu_s': cpu_s,
               'counts': counts}
        print(f'[{name}] cart-pole T={T} line_search={ls}: cold '
              f'{cold_ms:.3f} ms, warm {warm_ms:.3f} ms (median of {warm}); '
              f'profiled call {prof_ms:.3f} ms, device {dev_ms:.3f} ms (idle '
              f'share {res["idle_share"]:.4f}), {n_ops} device operations, '
              f'{reads} host reads; cost {c:.6f} (CPU {res["cost_cpu"]:.6f} '
              f'in {cpu_s:.2f} s, JAX {res["cost_jax"]:.6f}), tail '
              f'max|theta| {res["tail"]:.6f} (CPU {res["tail_cpu"]:.6f}, JAX '
              f'{res["tail_jax"]:.6f}); launch counts {counts}', flush=True)
        check(not bad and not cbad, f'{name}: {bad + cbad}')
        check(bool(torch.isfinite(x).all()) and bool(torch.isfinite(u).all()),
              f'{name}: the trajectory is not finite')
        out[name] = res
    return out


# ---------------------------------------------------------------------------
# trajectory evaluation, splines, block-sparse products and the examples
# (no kernel on their paths but the whole solve's)
# ---------------------------------------------------------------------------

def _metric_fns():
    from pypose_tpu_torch.metric import ape, rpe
    return {'ape': ape, 'rpe': rpe}


def _rel_equal(a, b, what):
    check(all(abs(a[k] / b[k] - 1) < 1e-12 for k in b),
          f'{what}: the instance is not the anchor\'s ({a} against {b})')


def traj_eval_phase(dev):
    """[traj-eval] (a) synthetic_sphere(2500) solved by optim.sparse.pgo
    with examples/pgo.py's schedule (TrustRegion(radius=1e4), 10 steps,
    cg_iter 150, cg_tol 1e-6): route 'stencil' and the whole-solve kernel
    launched; testing.SPHERE_METRICS on the solved poses, the card's
    statistics against the port's CPU metric on the same poses, and on
    (ground truth, initial poses) against data/jax_anchor_metric.json;
    (b) testing.euroc_instance() (36,000 reference poses at 200 Hz, 3,600
    estimated at 20 Hz) through testing.EUROC_METRICS, cold, warm and
    profiled, against the anchor and the CPU (testing.metric_failures)."""
    import contextlib
    import io
    import numpy as np
    from pypose_tpu_torch.datasets import find_data, synthetic_sphere
    from pypose_tpu_torch.optim.sparse import pgo
    from pypose_tpu_torch.optim.strategy import TrustRegion
    from pypose_tpu_torch.testing import (EUROC_METRICS, SPHERE_METRICS,
                                          abs_sums, euroc_instance,
                                          instance_checksum,
                                          metric_failures, metric_stats)
    t_phase = time.perf_counter()
    with open(find_data('jax_anchor_metric.json')) as f:
        anchor = json.load(f)
    fns = _metric_fns()
    ds = synthetic_sphere(2500, device=dev)
    _rel_equal(instance_checksum(ds), anchor['sphere2500']['instance_checksum'],
               'traj-eval sphere2500')
    stamps = np.arange(2500, dtype=np.float64)
    reset_counts()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        solve_ms, (nodes, hist) = synced_ms(lambda: pgo(
            ds['nodes'], ds['edges'], ds['poses'], infos=ds['infos'],
            steps=10, strategy=TrustRegion(radius=1e4), cg_iter=150,
            cg_tol=1e-6, verbose=True))
    counts = read_counts()
    check("pgo: route 'stencil'" in log.getvalue(),
          f'traj-eval: pgo did not take the stencil route: '
          f'{log.getvalue().splitlines()[:1]}')
    check(counts['LAUNCHES'] >= len(hist) and not any(
        v for k, v in counts.items() if k != 'LAUNCHES'),
        f'traj-eval: the solve launched {counts} for {len(hist)} steps')
    solved = (stamps, ds['gt'], stamps, nodes)
    card_ms, card = synced_ms(lambda: metric_stats(fns, SPHERE_METRICS,
                                                   *solved))
    warm_ms = statistics.median(
        [synced_ms(lambda: metric_stats(fns, SPHERE_METRICS, *solved))[0]
         for _ in range(3)])
    cpu = metric_stats(fns, SPHERE_METRICS, stamps, ds['gt'].to('cpu'),
                       stamps, nodes.to('cpu'))
    bad, gap = metric_failures(cpu, card)
    check(not bad, f'traj-eval: the card\'s metric of the solved poses is '
          f'off the CPU\'s: {bad}')
    init = metric_stats(fns, SPHERE_METRICS, stamps, ds['gt'], stamps,
                        ds['nodes'])
    abad, agap = metric_failures(anchor['sphere2500']['stats'], init)
    check(not abad, f'traj-eval: the metric of the initial poses is off '
          f'the JAX anchor: {abad}')
    rmse = card['ape-align']['RMSE']
    print(f'[traj-eval] sphere2500: pgo (route stencil) chi2 {hist[0]:.6e} '
          f'-> {hist[-1]:.6e} in {len(hist)} steps, {solve_ms:.3f} ms, '
          f'whole-solve launches {counts["LAUNCHES"]}; APE RMSE against '
          f'ground truth (aligned) {rmse:.6f} (initial '
          f'{init["ape-align"]["RMSE"]:.6f}); four metric calls on the card '
          f'{card_ms:.3f} ms cold, {warm_ms:.3f} ms warm (median of 3); '
          f'card against CPU largest gap {gap:.3e}, '
          f'initial poses against the JAX anchor {agap:.3e}', flush=True)
    out = {'pgo_ms': solve_ms, 'chi2': hist, 'launches': counts['LAUNCHES'],
           'ape_rmse': rmse, 'sphere_metric_ms_cold': card_ms,
           'sphere_metric_ms_warm': warm_ms,
           'sphere_card_cpu_gap': gap, 'sphere_anchor_gap': agap}

    d = euroc_instance(device=dev)
    _rel_equal(abs_sums({k: d[k] for k in ('rpose', 'epose')}),
               anchor['euroc']['instance_checksum'], 'traj-eval euroc')
    args = (d['rstamp'], d['rpose'], d['estamp'], d['epose'])
    res = {}
    reset_counts()
    for name in EUROC_METRICS:
        one = {name: EUROC_METRICS[name]}

        def run():
            return metric_stats(fns, one, *args)
        cold_ms, got = synced_ms(run)
        warm = [synced_ms(run)[0] for _ in range(3)]
        prof_ms, dev_ms, n_ops = profiled_call(run)
        res[name] = {'ms_cold': cold_ms, 'ms_warm': statistics.median(warm),
                     'ms_warm_runs': warm, 'ms_profiled': prof_ms,
                     'device_ms': dev_ms, 'idle_share': 1 - dev_ms / prof_ms,
                     'device_ops_per_call': n_ops, 'stats': got[name]}
    got = {k: v['stats'] for k, v in res.items()}
    t0 = time.perf_counter()
    c = euroc_instance(device='cpu')
    cpu = metric_stats(fns, EUROC_METRICS, c['rstamp'], c['rpose'],
                       c['estamp'], c['epose'])
    cpu_s = time.perf_counter() - t0
    bad, gap = metric_failures(cpu, got)
    abad, agap = metric_failures(anchor['euroc']['stats'], got)
    for name, r in res.items():
        print(f'[traj-eval] euroc {name}: cold {r["ms_cold"]:.3f} ms, warm '
              f'{r["ms_warm"]:.3f} ms (median of {r["ms_warm_runs"]}); '
              f'profiled call {r["ms_profiled"]:.3f} ms, device '
              f'{r["device_ms"]:.3f} ms (idle share {r["idle_share"]:.4f}), '
              f'{r["device_ops_per_call"]} device operations; {r["stats"]}',
              flush=True)
    print(f'[traj-eval] euroc: card against CPU ({cpu_s:.2f} s) largest gap '
          f'{gap:.3e}, against the JAX anchor {agap:.3e} (bound '
          f'METRIC_ATOL + METRIC_RTOL |value|); phase '
          f'{time.perf_counter() - t_phase:.1f} s wall', flush=True)
    check(not bad and not abad, f'traj-eval euroc: {bad + abad}')
    check(all(np.isfinite(list(v.values())).all() for v in got.values()),
          'traj-eval: a statistic is not finite')
    no_launches('traj-eval euroc')
    out['euroc'] = res
    out['euroc_card_cpu_gap'], out['euroc_anchor_gap'] = gap, agap
    out['wall_s'] = time.perf_counter() - t_phase
    return out


def spline_phase(dev):
    """[spline] bspline over testing.spline_instance()'s 60,000 SE3 control
    poses at interval 0.1 (599,971 poses), again with extrapolate=True,
    and chspline over its 60,000 waypoints (599,991 points), float32,
    cold, warm and profiled; each output's testing.spline_summary held by
    testing.spline_failures to data/jax_anchor_spline.json and to the
    port's CPU run."""
    import pypose_tpu_torch as ppt
    from pypose_tpu_torch.datasets import find_data
    from pypose_tpu_torch.testing import (abs_sums, spline_calls,
                                          spline_failures, spline_instance,
                                          spline_summary)
    t_phase = time.perf_counter()
    with open(find_data('jax_anchor_spline.json')) as f:
        anchor = json.load(f)
    d = spline_instance(device=dev)
    c = spline_instance(device='cpu')
    _rel_equal(abs_sums(d), anchor['instance_checksum'], 'spline')
    out = {}
    reset_counts()
    for (name, run), cpu_run in zip(spline_calls(ppt, d).items(),
                                    spline_calls(ppt, c).values()):
        cold_ms, got = synced_ms(run)
        warm = [synced_ms(run)[0] for _ in range(3)]
        prof_ms, dev_ms, n_ops = profiled_call(run)
        got = spline_summary(got)
        bad, gaps = spline_failures(anchor[name], got)
        cbad, cgaps = spline_failures(spline_summary(cpu_run()), got)
        r = {'rows': got['rows'], 'ms_cold': cold_ms,
             'ms_warm': statistics.median(warm), 'ms_warm_runs': warm,
             'ms_profiled': prof_ms, 'device_ms': dev_ms,
             'idle_share': 1 - dev_ms / prof_ms, 'device_ops_per_call': n_ops,
             'anchor_gaps': gaps, 'cpu_gaps': cgaps}
        print(f'[spline] {name}: {got["rows"]} rows; cold {cold_ms:.3f} ms, '
              f'warm {r["ms_warm"]:.3f} ms (median of {warm}); profiled '
              f'call {prof_ms:.3f} ms, device {dev_ms:.3f} ms (idle share '
              f'{r["idle_share"]:.4f}), {n_ops} device operations; gaps to '
              f'the JAX anchor {gaps}, to the CPU {cgaps}', flush=True)
        check(not bad and not cbad, f'spline {name}: {bad + cbad}')
        out[name] = r
    no_launches('spline')
    out['wall_s'] = time.perf_counter() - t_phase
    print(f'[spline] phase {out["wall_s"]:.1f} s wall', flush=True)
    return out


# bsr_bsc_matmul and bsr_matvec against float64: each entry within this
# share of its |E| |E|^T (or |E| |x|) entry (measured 3.8e-7 and 2.1e-7
# on the CPU at ba-trafalgar)
BSR_RTOL = 1e-5


def bsr_phase(dev):
    """[bsr] E = J_c^T J_p of testing.ba_instance('ba-trafalgar') at its
    initial state (testing.bsr_instance: a 6 x 3 block a camera-point
    pair, as BSR; E^T as BSC): bsr_bsc_matmul(E, E^T), the dense 1,542 x
    1,542 E E^T, and bsr_matvec(E, x), cold, warm and profiled, with the
    host's pair and plan building timed alone; two card runs bit for bit,
    each entry within BSR_RTOL of |E| |E|^T of scipy's float64 product
    (testing.bsr_reference), and of the port's CPU result."""
    import numpy as np
    import scipy.sparse
    import torch
    from pypose_tpu_torch.sparse import bsr_bsc_matmul, bsr_matvec
    from pypose_tpu_torch.sparse.ops import _segment_plan, bsr_bsc_pairs
    from pypose_tpu_torch.testing import (ba_instance, bsr_instance,
                                          bsr_reference)
    t_phase = time.perf_counter()
    m = bsr_instance(ba_instance('ba-trafalgar', device=dev))
    E, Et = m['E'], m['Et']
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    ai, bi, oi = bsr_bsc_pairs(E, Et)
    plan = _segment_plan(oi)
    host_ms = 1e3 * (time.perf_counter() - t0)
    x = torch.randn(E.shape[1], generator=torch.Generator().manual_seed(0))
    xd = x.to(dev)
    reset_counts()
    res = {}
    for name, run in (('matmul', lambda: bsr_bsc_matmul(E, Et)),
                      ('matvec', lambda: bsr_matvec(E, xd))):
        cold_ms, first = synced_ms(run)
        warm = [synced_ms(run)[0] for _ in range(3)]
        prof_ms, dev_ms, n_ops = profiled_call(run)
        check(torch.equal(first, run()), f'bsr {name}: two card runs '
              'differ')
        res[name] = {'out': first, 'ms_cold': cold_ms,
                     'ms_warm': statistics.median(warm),
                     'ms_warm_runs': warm, 'ms_profiled': prof_ms,
                     'device_ms': dev_ms, 'idle_share': 1 - dev_ms / prof_ms,
                     'device_ops_per_call': n_ops}
    no_launches('bsr')
    ref = bsr_reference(E)
    scale = bsr_reference(E._replace(values=E.values.abs()))
    M = scipy.sparse.bsr_matrix((E.values.detach().cpu().double().numpy(),
                                 E.col_indices, E.crow_indices), shape=E.shape)
    x64 = x.double().numpy()
    mv_ref, mv_scale = M @ x64, abs(M) @ np.abs(x64)
    t0 = time.perf_counter()
    mc = bsr_instance(ba_instance('ba-trafalgar', device='cpu'))
    cpu = {'matmul': bsr_bsc_matmul(mc['E'], mc['Et']),
           'matvec': bsr_matvec(mc['E'], x)}
    cpu_s = time.perf_counter() - t0
    gaps = {}
    for name, want, sc in (('matmul', ref, scale),
                           ('matvec', mv_ref, mv_scale)):
        got = res[name].pop('out').cpu().double().numpy()
        sc = np.maximum(sc, 1e-300)
        gaps[name] = {'f64': float((np.abs(got - want) / sc).max()),
                      'cpu': float((np.abs(got - cpu[name].double().numpy())
                                    / sc).max())}
        res[name]['gaps'] = gaps[name]
    res.update(pairs=len(ai), blocks=E.values.shape[0], host_plan_ms=host_ms,
               setup_s=setup_s, cpu_s=cpu_s)
    for name in ('matmul', 'matvec'):
        r = res[name]
        print(f'[bsr] {name}: cold {r["ms_cold"]:.3f} ms, warm '
              f'{r["ms_warm"]:.3f} ms (median of {r["ms_warm_runs"]}); '
              f'profiled call {r["ms_profiled"]:.3f} ms, device '
              f'{r["device_ms"]:.3f} ms (idle share {r["idle_share"]:.4f}), '
              f'{r["device_ops_per_call"]} device operations; largest gap '
              f'of |E| |E|^T (|E| |x|) to float64 {r["gaps"]["f64"]:.3e}, '
              f'to the CPU {r["gaps"]["cpu"]:.3e} (bound {BSR_RTOL})',
              flush=True)
    res['wall_s'] = time.perf_counter() - t_phase
    print(f'[bsr] E: {res["blocks"]} blocks of 6 x 3, {E.shape}; '
          f'{res["pairs"]} block pairs; host pair list and summation plan '
          f'{host_ms:.3f} ms (in each matmul call); set-up (instance and E) '
          f'{setup_s:.2f} s; CPU run {cpu_s:.2f} s; phase '
          f'{res["wall_s"]:.1f} s wall', flush=True)
    check(all(g <= BSR_RTOL for v in gaps.values() for g in v.values()),
          f'bsr: off float64 or the CPU: {gaps}')
    return res


# the port's examples, one subprocess each, run at their default sizes
EXAMPLES = ('pgo', 'bundle_adjustment', 'reproj_pgo', 'imu_integration',
            'imu_corrector', 'filters', 'mpc_cartpole', 'dynamics',
            'icp_align', 'splines', 'rotation_averaging', 'mini_slam',
            'bicycle', 'mpc_linear_learning', 'pointcloud_registration')
EXAMPLE_WORKERS = 4


def examples_phase():
    """[examples] the 15 scripts of pypose_tpu_torch/examples/ on the card
    at their default sizes, one subprocess each (EXAMPLE_WORKERS at a
    time); each must exit 0 (the learning examples assert their own
    improvement); the pgo example must take the stencil route and print
    its APE RMSE.  Each example's output is printed, its lines prefixed
    with its name."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))

    def one(name):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-m', f'pypose_tpu_torch.examples.{name}'],
            capture_output=True, text=True, timeout=600, cwd=root)
        return name, proc, time.perf_counter() - t0

    with ThreadPoolExecutor(EXAMPLE_WORKERS) as pool:
        runs = [f.result() for f in [pool.submit(one, n) for n in EXAMPLES]]
    out, failed = {}, []
    for name, proc, s in runs:
        lines = proc.stdout.strip().splitlines()
        print('\n'.join(f'[examples] {name} | {line}' for line in lines),
              flush=True)
        out[name] = {'rc': proc.returncode, 's': s,
                     'last': lines[-1] if lines else ''}
        print(f'[examples] {name}: rc {proc.returncode}, {s:.1f} s wall; '
              f'{out[name]["last"]}', flush=True)
        if proc.returncode != 0:
            failed.append(name)
            print(proc.stderr[-2000:], flush=True)
    pgo_out = dict((n, p) for n, p, _ in runs)['pgo'].stdout
    ape_line = [line for line in pgo_out.splitlines() if 'APE RMSE' in line]
    print(f'[examples] pgo: {pgo_out.splitlines()[1:2]}; {ape_line}; phase '
          f'{time.perf_counter() - t_phase:.1f} s wall', flush=True)
    check(not failed, f'examples: {failed} exited non-zero')
    check("pgo: route 'stencil'" in pgo_out and ape_line,
          'examples: pgo did not take the stencil route or print its APE')
    out['wall_s'] = time.perf_counter() - t_phase
    return out


BLOCK_SIZE_CAP = 60


def block_size_kernels(t):
    """The whole-solve, tiled and fused kernels at block size t (their
    template at t = 3, 4, 7, else the runtime-t instantiation) against
    their plain versions, as t = 6 is held: N = 53 (40 for
    the whole solve), sphere2500's shape (converged, and to a cap, two
    launches bit-equal) and the 100k shape (tol 1e-3, and to a cap), and
    the tiled matvec and block-Jacobi kernels alone.  The capped runs stop
    at 60 iterations: these systems converge by 1e-6 in ~30 (sphere2500
    shape) or by 1e-3 in ~15 (100k shape), so past ~120 iterations |r|^2
    underflows float32, and with a tol of 0 the kernel and the plain
    version, summing in another order, may then stop at different counts.
    Returns {'whole': (err, ms, plain ms, it), 'tiled' / 'fused' /
    'fused_bf16': the same at the 100k cap, 'err': {route: largest
    error}, 'plan': the fused plan at the 100k shape, 'alone':
    tiled_kernels_vs_plain's}."""
    whole = [whole_solve_vs_plain('N=40', 40, 9, 15, False, 500, 1e-6, t),
             whole_solve_vs_plain('sphere2500 shape', 2500, 157, 2000, True,
                                  500, 1e-6, t),
             whole_solve_vs_plain('sphere2500 shape, 60 iterations', 2500,
                                  157, 2000, True, BLOCK_SIZE_CAP, 0.0, t)]
    small, _ = oversize_solvers_vs_plain(
        'N=53', stencil_system(53, 9, 15, False, t), 200, 1e-7)
    big_system = stencil_system(100_000, 993, 80_000, True, t)
    big, plan = oversize_solvers_vs_plain('100k shape, tol 1e-3', big_system,
                                          250, 1e-3)
    full, _ = oversize_solvers_vs_plain('100k shape, 60 iterations',
                                        big_system, BLOCK_SIZE_CAP, 0.0)
    alone = tiled_kernels_vs_plain(big_system)
    out = {'whole': (max(w[0] for w in whole), *whole[-1][1:]),
           'plan': plan, 'alone': alone,
           'err': {r: max(x[r][0] for x in (small, big, full))
                   for r in ('tiled', 'fused', 'fused_bf16')}}
    out.update(full)
    return out


# block sizes held at the small shapes alone: every t from 1 to 17 but 6
# (phase 3's own) and those block_size_kernels holds at the full shapes
SMALL_ONLY_T = (8, 10, 11, 12, 13, 14, 15, 17)


def small_shape_kernels(t):
    """The three sources at block size t on the small systems alone: the
    whole solve at N = 40, the tiled and fused (float32, bf16) solvers at
    N = 53, each against its plain version (two launches bit-equal but
    the tiled solver's); returns {route: largest error}."""
    whole = whole_solve_vs_plain('N=40', 40, 9, 15, False, 500, 1e-6, t)
    small, _ = oversize_solvers_vs_plain(
        'N=53', stencil_system(53, 9, 15, False, t), 200, 1e-7)
    return {'whole': whole[0], **{r: v[0] for r, v in small.items()}}


def runtime_t_cost(t):
    """The runtime-t instantiation forced at a template's block size
    (``any_t=True``) against the template, on the systems the templates
    are timed on: the whole solve at sphere2500's shape (150 iterations),
    the fused solver at the 100k shape (float32 and bf16 operands, 250
    iterations), the tiled matvec and block-Jacobi kernels alone at the
    100k shape (one launch).  Each pair must agree bit for bit (x and the
    iteration count, or y).  Device time per call from torch.profiler
    (the kernel alone), taken template, runtime, runtime, template, each
    side's two readings averaged.  Returns {kernel: (template ms, runtime
    ms, bit-equal)}."""
    import torch
    from pypose_tpu_torch.ops import stencil_cg as scg
    offsets, ops = stencil_system(2500, 157, 2000, True, t)
    offsets_b, (b_T, *big) = stencil_system(100_000, 993, 80_000, True, t)
    gen = torch.Generator(device=b_T.device).manual_seed(7)
    v = torch.randn(b_T.shape, generator=gen, device=b_T.device)

    def fused(dtype):
        stored = scg.round_operands(*big, dtype)
        return lambda any_t: scg.stencil_cg_fused(
            b_T, *stored, offsets_b, t, 250, 0.0, operand_dtype=dtype,
            any_t=any_t)
    # (run(any_t) -> (x or y, iterations or None), kernel name, calls)
    pairs = {
        'whole': (lambda any_t: scg.stencil_cg_transposed(
            *ops, offsets, t, 150, 0.0, any_t=any_t), 'stencil_pcg', 20),
        'fused': (fused(None), 'fused_pcg', 10),
        'fused_bf16': (fused(torch.bfloat16), 'fused_pcg', 10),
        'tiled_mv': (lambda any_t: (scg._tiled_mv_launch(
            big[0], big[2], v, offsets_b, t, any_t), None), 'tiled_mv', 50),
        'tiled_pc': (lambda any_t: (scg._tiled_pc_launch(
            big[1], v, t, any_t), None), 'tiled_pc', 50)}
    out = {}
    for name, (run, match, calls) in pairs.items():
        a, b = run(False), run(True)
        same = bool(torch.equal(a[0], b[0])) and (
            a[1] is None or int(a[1]) == int(b[1]))
        ms = {False: [], True: []}
        for any_t in (False, True, True, False):
            ms[any_t].append(device_ms(lambda: run(any_t), calls=calls,
                                       match=match))
        tm, rm = statistics.mean(ms[False]), statistics.mean(ms[True])
        print(f'[kernel] runtime-t cost, {name}, t={t}: template {tm:.5f} '
              f'ms, runtime-t {rm:.5f} ms a call (device time, '
              f'{calls} calls, readings template {ms[False]}, runtime-t '
              f'{ms[True]}): runtime-t / template {rm / tm:.3f}; bit-equal '
              f'{same}', flush=True)
        check(same, f'runtime-t cost, {name}, t={t}: the runtime-t '
              'instantiation differs from the template')
        out[name] = (tm, rm, same)
    return out


# [stencil-any-t]: (tag, N, t, the solver stencil_cg takes there: at
# t = 2 the 100k ring's operands (9.6 MB) and state (200,512 B a CTA) fit
# the whole solve's budgets, its L2 mode; at t = 5 they do not, and the
# fused solver keeps its state in shared memory)
ANY_T_CASES = (('ring-t9-2500', 2500, 9, 'whole'),
               ('ring-t9-100k', 100_000, 9, 'fused'),
               ('ring-t2-100k', 100_000, 2, 'whole'),
               ('ring-t5-100k', 100_000, 5, 'fused'),
               ('ring-t16-2500', 2500, 16, 'whole'))
ANY_T_STEPS = 3


def stencil_any_t_phase(dev):
    """SparseLM through the stencil kernels' runtime-t instantiation:
    testing.ring3_problem (Euclidean relative displacements i -> i+1 and
    i -> i+5 over N points of t coordinates, node 0 fixed, float32) at
    ANY_T_CASES' sizes (the whole solve with its operands in L2, the
    fused solver with its state in global and in shared memory),
    ANY_T_STEPS step() calls with the ring cases' schedule
    (TrustRegion(1e4), cg_iter 100, cg_tol 1e-8), counted from zero:
    route 'stencil', one launch a solve of the kernel stencil_cg takes
    (the whole solve within stencil_cg_fits, else the fused solver) and
    no other; the final chi2 within 1e-4 relative of the same instance
    through SparseLM(matvec='generic') on the card (route 'einsum', no
    kernel), the points within 1e-4 of their largest magnitude; ms a step
    (host clock), and the kernel's device time a solve from one more,
    profiled step.  Returns {tag: numbers}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pypose_tpu_torch.ops import stencil_cg as scg
    from pypose_tpu_torch.optim.sparse import SparseLM
    from pypose_tpu_torch.optim.strategy import TrustRegion
    from pypose_tpu_torch.testing import ring3_problem
    out = {}
    for tag, N, t, solver in ANY_T_CASES:
        def make(matvec):
            params, factors, fixed = ring3_problem(N=N, t=t, device=dev)
            return SparseLM(params, factors,
                            strategy=TrustRegion(radius=1e4), fixed=fixed,
                            cg_iter=100, cg_tol=1e-8, matvec=matvec)

        def run(opt):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            hist, solves = [], 0
            for _ in range(ANY_T_STEPS):
                hist.append(opt.step())
                solves += len(opt.cg_iterations[0])
            torch.cuda.synchronize()
            return (hist, solves, 1e3 * (time.perf_counter() - t0)
                    / ANY_T_STEPS, read_counts())
        opt = make('auto')
        n_off = len(opt._stencil_all.offsets)
        whole = scg.stencil_cg_fits(N, t, n_off)
        where = (('shared memory' if scg.stencil_cg_smem_fits(N, t, n_off)
                  else 'L2') if whole else
                 ('shared memory' if scg.fused_plan(N, t, dev)['smem']
                  else 'global memory'))
        check(opt.route == 'stencil' and whole == (solver == 'whole'),
              f'stencil-any-t, {tag}: route {opt.route}, whole solve '
              f'{whole}; expected stencil through the {solver} solver')
        hist, solves, ms, counts = run(opt)
        counter = 'LAUNCHES' if solver == 'whole' else 'FUSED_LAUNCHES'
        launches = counts.pop(counter)
        check(launches == solves and not any(counts.values()),
              f'stencil-any-t, {tag}: {launches} {counter} for {solves} '
              f'solves, other counts {counts}')
        ref = make('generic')
        check(ref.route == 'einsum', f'stencil-any-t, {tag}: the generic '
              f'reference took route {ref.route}')
        r_hist, _, r_ms, r_counts = run(ref)
        check(not any(r_counts.values()), f'stencil-any-t, {tag}: the '
              f'generic reference launched {r_counts}')
        gap = abs(hist[-1] / r_hist[-1] - 1)
        x, x_ref = opt.params['x'], ref.params['x']
        x_gap = float((x - x_ref).abs().max() / x_ref.abs().max())
        prof_opt = make('auto')
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prof_opt.step()
            torch.cuda.synchronize()
        kname = 'stencil_pcg' if solver == 'whole' else 'fused_pcg'
        p_solves = len(prof_opt.cg_iterations[0])
        dev_ms = sum(e.device_time_total for e in prof.key_averages()
                     if kname in e.key) / 1e3 / p_solves
        print(f'[stencil-any-t] {tag}: N={N} t={t}, route {opt.route}, '
              f'{solver} solve (operands in {where}), chi2 {hist}, CG '
              f'iterations of the last step {opt.cg_iterations}, {launches} '
              f'{counter} for {solves} solves, no other launch; '
              f'{ms:.3f} ms/LM step (host clock); the kernel '
              f'{dev_ms:.4f} device ms a solve (torch.profiler, '
              f'{p_solves} solves of one step); matvec=\'generic\' '
              f'(einsum, no kernel) chi2 {r_hist}, {r_ms:.3f} ms/LM step; '
              f'final chi2 gap {gap:.3e} (bound 1e-4), points {x_gap:.3e} '
              'of their largest magnitude (bound 1e-4)', flush=True)
        check(all(map(math.isfinite, hist)) and bool(
            torch.isfinite(x).all()), f'stencil-any-t, {tag}: not finite')
        check(gap <= 1e-4 and x_gap <= 1e-4, f'stencil-any-t, {tag}: the '
              'stencil route disagrees with matvec=\'generic\'')
        out[tag] = dict(N=N, t=t, solver=solver, operands_in=where,
                        launches=launches, solves=solves, chi2=hist,
                        generic_chi2=r_hist, chi2_gap=gap, x_gap=x_gap,
                        ms_per_step=ms, generic_ms_per_step=r_ms,
                        device_ms_per_solve=dev_ms)
    return out


# ---------------------------------------------------------------------------
# 37.-40. C12 (the knn kernels past 8 coordinates) and the sharded path
# ---------------------------------------------------------------------------

# [knn-wide]: (tag, coordinates, reference rows, neighbours, dtype, the
# k of each case: nn1 at 1, else nnk; k = 2 is Lowe's ratio test)
WIDE_CASES = (('fpfh', 33, 50_000, 50_000, 'float32', (1, 8)),
              ('sift', 128, 20_000, 100_000, 'float32', (1, 8, 2)),
              ('fpfh-f64', 33, 10_000, 10_000, 'float64', (1, 8)))
# float64 and TF32 on the tensor cores, dense (NVIDIA's H100 SXM data
# sheet; float64 outside them is 34 TFLOP/s, but the cross term of a
# distance scan is a GEMM that DMMA computes in full float64)
FP64_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12


def descriptors(kind, n, gen):
    """float64 descriptor clouds on the CPU: FPFH-like (three 11-bin
    histograms, each summing to 100) or SIFT-like (128 values, unit
    length, clipped at 0.2 and normalised again)."""
    import torch
    if kind.startswith('fpfh'):
        h = torch.rand((n, 3, 11), generator=gen, dtype=torch.float64)
        return (100 * h / h.sum(-1, keepdim=True)).reshape(n, 33)
    v = torch.rand((n, 128), generator=gen, dtype=torch.float64)
    v = (v / v.norm(dim=-1, keepdim=True)).clamp(max=0.2)
    return v / v.norm(dim=-1, keepdim=True)


def knn_bound(R, N, D, k, f64):
    """2 D flop a pair; the clouds read once, d2 and the int64 indices
    written once.  float64 at its tensor-core peak (DMMA); float32 at the
    faster of the SIMT peak and three TF32 passes on the tensor cores
    (3 x 2 D flop a pair at 495 TFLOP/s, the precision the near-tie rule
    needs)."""
    return bound((8 if f64 else 4) * (R + N) * D + (16 if f64 else 12) * R * k,
                 2 * R * N * D, FP64_FLOP_PER_S if f64 else
                 max(FP32_FLOP_PER_S, TF32_FLOP_PER_S / 3))


def wide_clouds(dev):
    """{tag: (ref, nbr)} of WIDE_CASES on ``dev``, drawn in order from
    generator seed 0."""
    import torch
    gen = torch.Generator().manual_seed(0)
    out = {}
    for tag, D, R, N, dt, _ in WIDE_CASES:
        dtype = getattr(torch, dt)
        out[tag] = tuple(descriptors(tag, n, gen).to(dtype).to(dev)
                         for n in (R, N))
    return out


def wide_call(ref, nbr, k):
    """The kernel of a [knn-wide] case as (d2 [R, k], idx [R, k])."""
    from pypose_tpu_torch.ops import knn as K
    if k == 1:
        return [a[:, None] for a in K.nn1(ref, nbr)]
    return K.nnk(ref, nbr, k)


def wide_device_worker():
    """Run in a fresh process by :func:`wide_device_ms`: the device ms of
    one call of each [knn-wide] case under torch.profiler, as a JSON line
    {"tag k": ms}."""
    import torch
    dev = torch.device('cuda', 0)
    clouds = wide_clouds(dev)
    out = {}
    for tag, _, _, _, _, ks in WIDE_CASES:
        for k in ks:
            wide_call(*clouds[tag], k)
            torch.cuda.synchronize()
            out[f'{tag} {k}'] = profiled_call(
                lambda: wide_call(*clouds[tag], k))[1]
    print(json.dumps(out))


def wide_device_ms():
    """The [knn-wide] calls' device time, traced in a fresh process: late
    in this script torch.profiler handed back empty traces of these calls
    on two full runs, where a fresh process traces them."""
    res = subprocess.run(
        [sys.executable, '-c',
         'import chip_smoke; chip_smoke.wide_device_worker()'],
        capture_output=True, text=True, timeout=300, cwd=str(_ROOT))
    check(res.returncode == 0,
          f'knn-wide: the profiling process failed: {res.stderr[-2000:]}')
    return json.loads(res.stdout.strip().splitlines()[-1])


def compiled_kernels(lib, match, op='HGMMA'):
    """{kernel: [ptxas' registers / shared memory line, its spill line,
    ``op`` instructions in its SASS (None where cuobjdump cannot say)]} of
    the kernels of the built ``lib`` whose mangled name holds one of
    ``match``."""
    import shutil
    from pypose_tpu_torch.ops import _build
    out, entry, spill = {}, '', ''
    for line in lib.with_suffix('.log').read_text().splitlines():
        if 'Compiling entry' in line:
            entry = line.strip()
        elif 'spill' in line:
            spill = line.strip()
        elif 'Used' in line and any(m in entry for m in match):
            out[entry.split("'")[1]] = [line.strip(), spill, None]
    tool = shutil.which('cuobjdump') or os.path.join(
        os.path.dirname(_build.nvcc_path()), 'cuobjdump')
    try:
        sass = subprocess.run([tool, '-sass', str(lib)], capture_output=True,
                              text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        print(f'[build] cuobjdump -sass {lib.name}: {e}', flush=True)
        return out
    name = None
    for line in sass.splitlines():
        if 'Function : ' in line:
            name = line.split('Function : ')[1].strip()
            if name in out:
                out[name][2] = 0
        elif name in out and op in line:
            out[name][2] += 1
    return out


def knn_wide_phase(dev):
    """[knn-wide] The wide scans of csrc/knn.cu (D > 8): nn1 and nnk(k=8)
    on FPFH-like clouds (D = 33, 50,000 x 50,000), SIFT-like clouds
    (D = 128, 20,000 x 100,000; also nnk(k=2), the ratio test) in float32
    (the tensor-core scans) and FPFH-like 10,000 x 10,000 in float64 (the
    DMMA scans), each held to its plain version by the near-tie rule
    (float64 at F64_TOL) and timed (CUDA events, median of 7; device time
    of one call under torch.profiler in a fresh process, wide_device_ms)
    beside the plain version (one call) and chunked torch.cdist +
    torch.min / topk with TF32 off (one call); then the main path,
    knn(ref, nbr, k=1) and k=8 on the D = 33 clouds in float32 and in
    float64, each counted from zero: one nn1 and one nnk launch, the
    kernels' results.  Returns {('nn1' | 'nnk', case): numbers} (case:
    the tag, with ', k=2' for the ratio test) and the main path's counts
    ({'float32' | 'float64': {counter: launches}})."""
    import torch
    import pypose_tpu_torch as ppt
    from pypose_tpu_torch.ops import knn as K
    from pypose_tpu_torch.testing import nnk_tolerance_failures
    clouds = wide_clouds(dev)
    device = wide_device_ms()
    out = {}
    for tag, D, R, N, dt, ks in WIDE_CASES:
        f64 = dt == 'float64'
        ref, nbr = clouds[tag]
        for k in ks:
            if k == 1:
                def plain():
                    return [a[:, None] for a in K._nn1_torch(ref, nbr)]

                def lib():
                    return cdist_min(ref, nbr)
            else:
                def plain():
                    return K._nnk_torch(ref, nbr, k)

                def lib():
                    return cdist_topk(ref, nbr, k)
            k_ms, (d_k, i_k) = cuda_ms(lambda: wide_call(ref, nbr, k))
            p_ms, (d_p, i_p) = cuda_ms(plain, repeat=1)
            c_ms, _ = cuda_ms(lib, repeat=1)
            got = nnk_tolerance_failures(ref, nbr, d_k, i_k, i_p,
                                         **(F64_TOL if f64 else {}))
            err = float((d_k - d_p).abs().max())
            b = knn_bound(R, N, D, k, f64)
            d_ms = device[f'{tag} {k}'] or None
            name = 'nn1' if k == 1 else 'nnk'
            print(f'[knn-wide] {name}, {tag} [{R}, {D}] x [{N}, {D}] {dt}'
                  f'{"" if k == 1 else f", k={k}"}: {got}; max|d2_k - d2_p| '
                  f'{err:.3e}; kernel {k_ms:.4f} ms (median of 7; device '
                  f'{"not measured" if d_ms is None else f"{d_ms:.4f} ms"}'
                  f'), plain {p_ms:.4f} ms, torch.cdist + '
                  f'torch.{"min" if k == 1 else "topk"} {c_ms:.4f} ms (one '
                  f'call each); bound {b[0]:.4f} ms ({b[1]})', flush=True)
            check(bool(torch.isfinite(d_k).all()),
                  f'knn-wide {name} {tag}: d2 not finite')
            check(got['index_failures'] == got['repeat_failures']
                  == got['d2_failures'] == 0,
                  f'knn-wide {name} {tag}: outside the tolerance: {got}')
            case = tag if k in (1, 8) else f'{tag}, k={k}'
            out[(name, case)] = dict(err=err, ms=k_ms, device_ms=d_ms,
                                     plain_ms=p_ms, cdist_ms=c_ms, bound=b,
                                     dtype=dt,
                                     shape=f'[{R}, {D}] x [{N}, {D}] {dt}'
                                     f'{"" if k == 1 else f", k={k}"}',
                                     idx=i_k)
    # the main path: knn on the FPFH clouds, each kernel counted from zero
    counts = {}
    for tag, dt in (('fpfh', 'float32'), ('fpfh-f64', 'float64')):
        ref, nbr = clouds[tag]
        counts[dt] = {}
        for k, counter in ((1, 'NN1_LAUNCHES'), (8, 'NNK_LAUNCHES')):
            reset_counts()
            res = ppt.knn(ref, nbr, k=k)
            torch.cuda.synchronize()
            c = read_counts()
            others = {n: v for n, v in c.items() if n != counter and v}
            check(c[counter] == 1 and not others,
                  f'knn-wide: knn(k={k}) at D = 33 {dt}: launch counts {c}')
            check(torch.equal(res.indices,
                              out[('nn1' if k == 1 else 'nnk', tag)]['idx']),
                  f'knn-wide: knn(k={k}) {dt} differs from its kernel')
            counts[dt][counter] = c[counter]
            print(f'[knn-wide] knn(ref, nbr, k={k}) on the D = 33 {dt} '
                  f'clouds: launch counts {c}', flush=True)
    for v in out.values():
        del v['idx']
    return out, counts


# [knn-bigk]: (tag, clouds, k, the k > 16 family it takes (the register-
# tiled one: the merge scan below ops.knn.select_k(dtype), the select
# path from it on and at k = N), its users); the
# clouds of bigk_clouds, each case called through knn() but the two range
# cases, which call ops.knn.nnk
BIGK_CASES = (
    ('normals', 'icp', 30, 'register-tiled float32',
     'Open3D normal estimation, KDTreeSearchParamKNN(knn=30)'),
    ('outliers', 'icp', 50, 'register-tiled float32',
     'PCL StatisticalOutlierRemoval, setMeanK(50)'),
    ('fpfh-nbhd', 'icp', 100, 'register-tiled float32',
     'Open3D FPFH, KDTreeSearchParamHybrid(max_nn=100)'),
    ('d6-f64', 'd6-f64', 30, 'register-tiled float64', 'float64 clouds'),
    ('fpfh-33', 'fpfh', 32, 'tensor-core float32',
     'descriptor neighbourhoods'),
    ('fpfh-33-1024', 'fpfh', 1024, 'tensor-core float32',
     'coverage: the wide family at large k'),
    ('fpfh-33-f64', 'fpfh-f64', 32, 'DMMA float64',
     'descriptor neighbourhoods in float64'),
    ('sift-128', 'sift', 32, 'tensor-core float32',
     'SIFT-width descriptors'),
    ('range-100k', 'icp', 1024, 'register-tiled float32',
     'coverage: k ~ 1000 at ICP scale, beside the route it replaced'),
    ('range', 'range', 1024, 'register-tiled float32', 'coverage: range'),
    ('full', 'full', 4096, 'register-tiled float32',
     'coverage: a whole row sorted'),
    ('d6-f64-1024', 'd6-f64', 1024, 'register-tiled float64',
     'coverage: the float64 select path'),
    ('sift-128-1024', 'sift', 1024, 'tensor-core float32',
     'coverage: large k at SIFT width'),
    ('fpfh-33-f64-1024', 'fpfh-f64', 1024, 'DMMA float64',
     'coverage: the float64 wide family at large k'),
    ('fpfh-33-full', 'fpfh-full', 4096, 'tensor-core float32',
     'coverage: a whole row sorted at D = 33'),
    ('fpfh-33-f64-full', 'fpfh-f64-full', 4096, 'DMMA float64',
     'coverage: a whole row sorted at D = 33 in float64'),
    ('sift-gt', 'sift-gt', 100, 'tensor-core float32',
     'the exact ground truth of ANN-Benchmarks\' sift-128-euclidean (10k '
     'queries, 1M base, 100 neighbours)'))
BIGK_RANGE = ('range', 'full', 'fpfh-33-full', 'fpfh-33-f64-full')
# cases whose plain version runs on every SUBSET-th reference row alone
# (sift-gt's plain version over all 10,000 rows would sort 10^10 pairs)
BIGK_SUBSET = {'sift-gt': 10}


def bigk_clouds(dev):
    """{name: (ref, nbr)} of BIGK_CASES on ``dev``: ICP's 100k target
    against itself (and in float64, for probes/knn_probes.py
    --crossover); [knn-d6]'s [10000, 6] clouds in float64; [knn-wide]'s
    FPFH-like clouds (50,000^2 float32, 10,000^2 float64) and SIFT-like
    clouds (20,000 x 100,000 float32; their first 10,000 x 20,000 in
    float64, for --crossover); 10,000 ICP
    source points against the 100k target; 4096 target points against
    themselves; the FPFH clouds' first 4096 rows against themselves (in
    float32 and float64); and 10,000 SIFT-like queries against 1,000,000
    (generator seed 1)."""
    import torch
    src, _, tgt = icp_instance(100_000, dev)
    gen = torch.Generator().manual_seed(0)
    d6 = [torch.randn((10_000, 6), generator=gen).double().to(dev)
          for _ in range(2)]
    wide = wide_clouds(dev)
    full = tgt[:4096].contiguous()
    tgt64 = tgt.double()
    fpfh_full = wide['fpfh'][0][:4096].contiguous()
    fpfh64_full = wide['fpfh-f64'][0][:4096].contiguous()
    sift64 = (wide['sift'][0][:10_000].double(),
              wide['sift'][1][:20_000].double())
    gen = torch.Generator().manual_seed(1)
    sift_gt = tuple(descriptors('sift', n, gen).float().to(dev)
                    for n in (10_000, 1_000_000))
    return {'icp': (tgt, tgt), 'icp-f64': (tgt64, tgt64),
            'd6-f64': tuple(d6), 'fpfh': wide['fpfh'],
            'fpfh-f64': wide['fpfh-f64'], 'sift': wide['sift'],
            'range': (src[:10_000].contiguous(), tgt), 'full': (full, full),
            'fpfh-full': (fpfh_full, fpfh_full),
            'fpfh-f64-full': (fpfh64_full, fpfh64_full), 'sift-f64': sift64,
            'sift-gt': sift_gt}


def bigk_device_worker(tags=None):
    """Run in a fresh process by :func:`bigk_device_ms`: the device ms of
    one ops.knn.nnk call of each [knn-bigk] case (or of those in
    ``tags``) under torch.profiler, as a JSON line {tag: ms}."""
    import torch
    from pypose_tpu_torch.ops import knn as K
    clouds = bigk_clouds(torch.device('cuda', 0))
    out = {}
    for tag, cl, k, _, _ in BIGK_CASES:
        if tags and tag not in tags:
            continue
        ref, nbr = clouds[cl]
        K.nnk(ref, nbr, k)
        torch.cuda.synchronize()
        out[tag] = profiled_call(lambda: K.nnk(ref, nbr, k))[1]
    print(json.dumps(out))


def bigk_device_ms(tags=None):
    """The [knn-bigk] calls' device time, traced in a fresh process (late
    in this script torch.profiler traced knn calls empty)."""
    res = subprocess.run(
        [sys.executable, '-c',
         f'import chip_smoke; chip_smoke.bigk_device_worker({tags!r})'],
        capture_output=True, text=True, timeout=300, cwd=str(_ROOT))
    check(res.returncode == 0,
          f'knn-bigk: the profiling process failed: {res.stderr[-2000:]}')
    return json.loads(res.stdout.strip().splitlines()[-1])


def flushed_ms(fn, repeat=7):
    """Median ms of ``fn()`` between CUDA events, the 50 MB L2 flushed
    (64 MB zeroed) before each call; and the last call's result."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.float32, device='cuda')
    times, out = [], None
    for _ in range(repeat):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def d2_err_over_tol(ref, nbr, d2, idx, rtol=1e-6, atol=1e-6):
    """The largest |d2 - |a - b|^2| over the near-tie rule's tolerance
    rtol (|a|^2 + |b|^2) + atol, in float64, by chunks of rows."""
    worst = 0.0
    for s in row_chunks(ref, idx):
        a = ref[s].double()[:, None, :]
        b = nbr.double()[idx[s]]
        exact = ((a - b) ** 2).sum(-1)
        tol = rtol * ((a * a).sum(-1) + (b * b).sum(-1)) + atol
        worst = max(worst, float(((d2[s].double() - exact).abs() / tol)
                                 .max()))
    return worst


def row_chunks(ref, idx):
    """Slices of reference rows whose [rows, k, D] float64 gathers take
    about 1 GB each (sift-128-1024's whole one would take 21 GB)."""
    R, k = idx.shape
    step = max(1, (1 << 27) // (k * ref.shape[1]))
    return [slice(s, s + step) for s in range(0, R, step)]


def rule_by_rows(ref, nbr, d2, idx, idx_plain, **tol):
    """testing.nnk_tolerance_failures by chunks of rows (row_chunks): its
    counts summed, its largest d^2 error the largest."""
    from pypose_tpu_torch.testing import nnk_tolerance_failures
    got = {}
    for s in row_chunks(ref, idx):
        part = nnk_tolerance_failures(ref[s], nbr, d2[s], idx[s],
                                      idx_plain[s], **tol)
        for key, v in part.items():
            got[key] = max(got.get(key, v), v) if key == 'max_d2_err' \
                else got.get(key, 0) + v
    return got


def knn_bigk_phase(dev, tags=None):
    """[knn-bigk] nnk at k > 16 (csrc/knn.cu's k > 16 scans, and the
    select-then-sort paths at k >= ops.knn.select_k(dtype, R, D) and
    k = N): each case of BIGK_CASES (or of those in ``tags``) called once
    through knn() (ops.knn.nnk for the range cases) from zeroed counts,
    one nnk launch and no other, its path and the bytes the wrapper
    allocates beside the outputs (ops.knn.nnk_plan) printed; held to the
    plain version by the near-tie rule (float64 at F64_TOL; sift-gt on
    every 10th row, BIGK_SUBSET), its largest d^2 error over the
    tolerance printed; the kernel timed (CUDA events, median of 7, L2
    flushed before each call), its device time traced in a fresh process
    (bigk_device_ms), beside the plain version, the chunked Gram route
    k > 16 took before (function/geometry.py: _knn_gram) and chunked
    torch.cdist + torch.topk (one call each), and the bound (D <= 8:
    bound(), 2 D flop a pair at 67 TFLOP/s, float32 SIMT or float64
    DMMA; D > 8: knn_bound()).  Returns {tag: numbers}."""
    import torch
    import pypose_tpu_torch as ppt
    from pypose_tpu_torch.function import geometry
    from pypose_tpu_torch.ops import knn as K
    t0 = time.perf_counter()
    device = bigk_device_ms(tags)
    clouds = bigk_clouds(dev)
    out = {}
    for tag, cl, k, family, users in BIGK_CASES:
        if tags and tag not in tags:
            continue
        ref, nbr = clouds[cl]
        (R, D), N = ref.shape, nbr.shape[0]
        f64 = ref.dtype == torch.float64
        tol = F64_TOL if f64 else {}
        plan = K.nnk_plan(R, N, D, k, ref.dtype)
        reset_counts()
        if tag in BIGK_RANGE:
            d2, idx = K.nnk(ref, nbr, k)
        else:
            res = ppt.knn(ref, nbr, k=k)
            d2, idx = res.values ** 2, res.indices
        torch.cuda.synchronize()
        counts = read_counts()
        others = {n: c for n, c in counts.items() if n != 'NNK_LAUNCHES' and c}
        check(counts['NNK_LAUNCHES'] == 1 and not others,
              f'knn-bigk {tag}: launch counts {counts}')
        check(tuple(idx.shape) == (R, k) and bool(torch.isfinite(d2).all()),
              f'knn-bigk {tag}: wrong shape or not finite')
        rows = torch.arange(0, R, BIGK_SUBSET.get(tag, 1), device=dev)
        sub = ref[rows].contiguous()
        p_ms, (d_p, i_p) = cuda_ms(lambda: K._nnk_torch(sub, nbr, k),
                                   repeat=1)
        got = rule_by_rows(sub, nbr, d2[rows], idx[rows], i_p, **tol)
        ratio = d2_err_over_tol(ref, nbr, d2, idx, **tol)
        err = float((d2[rows] - d_p).abs().max())
        del d_p, i_p
        check(got['index_failures'] == got['repeat_failures']
              == got['d2_failures'] == 0,
              f'knn-bigk {tag}: outside the tolerance: {got}')
        k_ms, (d_k, i_k) = flushed_ms(lambda: K.nnk(ref, nbr, k))
        # the wide select paths against the tensor-core merge scan forced
        # at the same k: the same bits
        merge_ms = same = None
        if plan['route'] == 'select' and plan['family'].startswith(
                'tensor-core'):
            merge_ms, (d_m, i_m) = flushed_ms(
                lambda: K._nnk_wide_merge(ref, nbr, k), repeat=3)
            same = torch.equal(d_k, d_m) and torch.equal(i_k, i_m)
            del d_m, i_m
            check(same, f'knn-bigk {tag}: the wide select path and the '
                        'merge scan differ')
        del d_k, i_k
        chunk = max(128, (64 << 20) // N)
        g_ms, _ = cuda_ms(lambda: geometry._knn_gram(ref, nbr, k, False,
                                                     chunk), repeat=1)
        c_ms, _ = cuda_ms(lambda: cdist_topk(ref, nbr, k), repeat=1)
        b = knn_bound(R, N, D, k, f64) if D > 8 else bound(
            (8 if f64 else 4) * (R + N) * D + (16 if f64 else 12) * R * k,
            2 * R * N * D, FP64_FLOP_PER_S if f64 else FP32_FLOP_PER_S)
        d_ms = device.get(tag) or None
        print(f'[knn-bigk] {tag} ({users}): {family}, [{R}, {D}] x [{N}, '
              f'{D}] {ref.dtype}, k={k}, through '
              f'{"ops.knn.nnk" if tag in BIGK_RANGE else "knn"}: path '
              f'{plan["route"]} (scratch {plan["scratch_bytes"]} B, partial '
              f'lists {plan["part_bytes"]} B); launch '
              f'counts {counts}; {got} (plain version on '
              f'{len(rows)} rows); largest d2 error {ratio:.3f} of '
              f'its tolerance; max|d2 - d2_p| {err:.3e}; kernel '
              f'{k_ms:.4f} ms (median of 7, L2 flushed; device '
              f'{"not measured" if d_ms is None else f"{d_ms:.4f} ms"}), '
              + ('' if same is None else
                 f'the merge scan forced {merge_ms:.4f} ms (median of 3, '
                 f'L2 flushed; bit-equal {same}), ')
              + f'plain {p_ms:.4f} ms ({len(rows)} rows), _knn_gram '
              f'{g_ms:.4f} ms, torch.cdist + torch.topk {c_ms:.4f} ms (one '
              f'call each); bound {b[0]:.4f} ms ({b[1]})', flush=True)
        out[tag] = dict(family=family, shape=f'[{R}, {D}] x [{N}, {D}] '
                        f'{str(ref.dtype)[6:]}, k={k}', route=plan['route'],
                        kernels=plan['family'], merge_ms=merge_ms,
                        bit_equal_to_merge=same,
                        scratch_bytes=plan['scratch_bytes'],
                        part_bytes=plan['part_bytes'],
                        launches=counts['NNK_LAUNCHES'],
                        err=err, err_over_tol=ratio, ms=k_ms, device_ms=d_ms,
                        plain_ms=p_ms, plain_rows=len(rows), gram_ms=g_ms,
                        cdist_ms=c_ms, bound=b)
    print(f'[knn-bigk] phase {time.perf_counter() - t0:.1f} s', flush=True)
    return out


G2O = 'synthetic_sphere2500_seed42.g2o'
# examples/pgo.py's schedule (what [traj-eval]'s pgo runs)
SHARDED_PGO = dict(cg_iter=150, cg_tol=1e-6, steps=10)
SHARDED_BA_CELL = 'ba-trafalgar'


def sharded_pgo_run(mesh, dev):
    """ShardedPGO on the vendored sphere2500 graph over ``mesh``, one
    step() at a time: (history, ms per step, all_reduce calls per step,
    the optimizer)."""
    from pypose_tpu_torch.datasets import find_data, load_g2o
    from pypose_tpu_torch.parallel import ShardedPGO, mesh as pmesh
    ds = load_g2o(find_data(G2O), device=dev)
    opt = ShardedPGO(ds['nodes'], ds['edges'], ds['poses'],
                     infos=ds['infos'], mesh=mesh,
                     cg_iter=SHARDED_PGO['cg_iter'],
                     cg_tol=SHARDED_PGO['cg_tol'])
    reduces = pmesh.ALL_REDUCES
    hist, ms = [], []
    for _ in range(SHARDED_PGO['steps']):
        t, loss = synced_ms(opt.step)
        hist.append(loss)
        ms.append(t)
    return (hist, ms, (pmesh.ALL_REDUCES - reduces) / SHARDED_PGO['steps'],
            opt)


def sharded_ba_run(mesh, dev):
    """ShardedBA on the ba-trafalgar cell over ``mesh`` with the cell's
    schedule: (history, ms per step, all_reduce calls per step, the
    optimizer)."""
    from pypose_tpu_torch.parallel import ShardedBA, mesh as pmesh
    from pypose_tpu_torch.testing import BA_SCHEDULES, ba_instance
    sched = BA_SCHEDULES[SHARDED_BA_CELL]
    ds = ba_instance(SHARDED_BA_CELL, device=dev)
    opt = ShardedBA(ds['poses'], ds['points'], ds['cam_idx'], ds['pt_idx'],
                    ds['pixels'], ds['cameras'], mesh=mesh,
                    **{k: v for k, v in sched.items()
                       if k not in ('steps', 'patience', 'decreasing')})
    reduces = pmesh.ALL_REDUCES
    ms, _ = synced_ms(lambda: opt.optimize(
        steps=sched['steps'], patience=sched['patience'],
        decreasing=sched['decreasing']))
    steps = len(opt.history)
    return (list(opt.history), ms / steps,
            (pmesh.ALL_REDUCES - reduces) / steps, opt)


def _two_rank_worker(rank, world, directory):
    """One of the two gloo ranks that share the card: ShardedPGO and
    ShardedBA as the one-rank phases run them; results to
    ``directory/rank<r>.pt``."""
    import os
    import torch
    import torch.distributed as dist
    from pypose_tpu_torch.optim.sparse import require_full_fp32
    from pypose_tpu_torch.parallel import make_mesh
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    require_full_fp32(dev)
    dist.init_process_group('gloo', store=dist.FileStore(
        os.path.join(directory, 'store'), world), rank=rank,
        world_size=world)
    try:
        mesh = make_mesh()
        hist, ms, reduces, opt = sharded_pgo_run(mesh, dev)
        pgo = dict(hist=hist, ms=ms, reduces=reduces,
                   nodes=opt.nodes.cpu(), backend=dist.get_backend(),
                   world=dist.get_world_size(),
                   local_edges=opt.lm.factors[0].num_edges)
        del opt
        hist, ms, reduces, opt = sharded_ba_run(mesh, dev)
        ba = dict(hist=hist, ms=ms, reduces=reduces,
                  poses=opt.poses.tensor().cpu(), points=opt.points.cpu(),
                  local_obs=int(opt.pixels.shape[0]))
        torch.save(dict(pgo=pgo, ba=ba),
                   os.path.join(directory, f'rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


def sharded_two_ranks():
    """ShardedPGO and ShardedBA at two gloo ranks sharing the one card
    (spawned processes): each rank's results and the spawn's wall time."""
    import os
    import tempfile
    import torch
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_two_rank_worker, args=(2, d), nprocs=2,
                           join=True, start_method='spawn')
        res = [torch.load(os.path.join(d, f'rank{r}.pt'), weights_only=False)
               for r in range(2)]
    wall = time.perf_counter() - t0
    print(f'[sharded] two gloo ranks on one card: spawn, both runs and '
          f'join in {wall:.1f} s', flush=True)
    return res


def rel_gap(a, b):
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def sharded_pgo_phase(dev, two):
    """[sharded-pgo] ShardedPGO on data/synthetic_sphere2500_seed42.g2o
    (4,499 edges, identity information matrices) with examples/pgo.py's
    schedule, 10 steps, at one rank (make_mesh() with nothing set up: an
    NCCL group of one), counted from zero (no kernel on this path): chi2
    each step within 1e-5 relative of SparseLM(matvec='generic',
    scatter=False) with the same strategy and CG settings on the card,
    the final within 1e-3 of data/jax_anchor_sharded_pgo.json; then the
    two gloo ranks (``two``): each step within 1e-4 of the one-rank run,
    the ranks' final nodes bit-equal; ms a step, all_reduce calls a step,
    and a profiled one-rank run's device idle share."""
    import json
    import torch
    import torch.distributed as dist
    from pypose_tpu_torch.datasets import find_data, load_g2o
    from pypose_tpu_torch.optim.sparse import SparseLM, pgo_factor
    from pypose_tpu_torch.optim.strategy import TrustRegion
    from pypose_tpu_torch.parallel import make_mesh
    mesh = make_mesh()
    check(dist.get_backend() == 'nccl' and dist.get_world_size() == 1,
          'sharded-pgo: make_mesh() did not make an NCCL group of one')
    reset_counts()
    hist, ms, reduces, opt = sharded_pgo_run(mesh, dev)
    counts = no_launches('[sharded-pgo]')
    ds = load_g2o(find_data(G2O), device=dev)
    n = ds['nodes'].shape[0]
    fixed = torch.zeros(n, dtype=torch.bool, device=dev)
    fixed[0] = True
    ref = SparseLM({'poses': ds['nodes']},
                   [pgo_factor(ds['edges'], ds['poses'], ds['infos'])],
                   strategy=TrustRegion(radius=1e4), fixed={'poses': fixed},
                   cg_iter=SHARDED_PGO['cg_iter'],
                   cg_tol=SHARDED_PGO['cg_tol'], matvec='generic',
                   scatter=False)
    ref_ms, ref_hist = synced_ms(
        lambda: [ref.step() for _ in range(SHARDED_PGO['steps'])])
    with open(find_data('jax_anchor_sharded_pgo.json')) as f:
        anchor = json.load(f)
    gap_ref = rel_gap(hist, ref_hist)
    gap_anchor = hist[-1] / anchor['final_chi2'] - 1
    print(f'[sharded-pgo] one rank (NCCL): chi2 {hist}; SparseLM(generic) '
          f'{ref_hist}: largest relative gap {gap_ref:.3e} (bound 1e-5); '
          f'JAX anchor final {anchor["final_chi2"]}: {gap_anchor:.3e} '
          f'(bound 1e-3); {statistics.median(ms):.3f} ms a step (median; '
          f'SparseLM {ref_ms / SHARDED_PGO["steps"]:.3f} ms), {reduces} '
          f'all_reduce calls a step; launch counts {counts}', flush=True)
    check(gap_ref <= 1e-5, 'sharded-pgo: one rank differs from SparseLM')
    check(abs(gap_anchor) <= 1e-3, 'sharded-pgo: off the JAX anchor')
    # a fresh run's steps under the profiler (set-up outside it)
    from pypose_tpu_torch.parallel import ShardedPGO
    opt = ShardedPGO(ds['nodes'], ds['edges'], ds['poses'],
                     infos=ds['infos'], mesh=mesh,
                     cg_iter=SHARDED_PGO['cg_iter'],
                     cg_tol=SHARDED_PGO['cg_tol'])
    p_ms, dev_ms, ops = profiled_call(
        lambda: [opt.step() for _ in range(SHARDED_PGO['steps'])])
    # an empty trace measures nothing
    idle = 1 - dev_ms / p_ms if ops else None
    print(f'[sharded-pgo] profiled one-rank run: {dev_ms:.3f} ms device '
          f'time of {p_ms:.3f} ms, {ops} device operations: idle share '
          f'{"not measured" if idle is None else f"{idle:.3f}"}',
          flush=True)
    r0, r1 = two[0]['pgo'], two[1]['pgo']
    gap_two = rel_gap(r0['hist'], hist)
    same = torch.equal(r0['nodes'], r1['nodes']) and r0['hist'] == r1['hist']
    print(f'[sharded-pgo] two gloo ranks on the card ({r0["backend"]}, '
          f'world {r0["world"]}, {r0["local_edges"]} edges a rank): chi2 '
          f'{r0["hist"]}; largest relative gap to one rank {gap_two:.3e} '
          f'(bound 1e-4); final nodes bit-equal across ranks: {same}; '
          f'{statistics.median(r0["ms"]):.3f} ms a step (median), '
          f'{r0["reduces"]} all_reduce calls a step', flush=True)
    check(r0['backend'] == 'gloo' and r0['world'] == 2,
          'sharded-pgo: the two ranks did not run gloo at world size 2')
    check(gap_two <= 1e-4, 'sharded-pgo: two ranks differ from one')
    check(same, 'sharded-pgo: the two ranks ended on different states')
    return dict(hist=hist, ms_per_step=statistics.median(ms),
                all_reduces_per_step=reduces, gap_sparse_lm=gap_ref,
                gap_anchor=gap_anchor, idle_share=idle,
                device_ms=dev_ms, profiled_ms=p_ms,
                two_ranks=dict(hist=r0['hist'],
                               ms_per_step=statistics.median(r0['ms']),
                               all_reduces_per_step=r0['reduces'],
                               gap_one_rank=gap_two), counts=counts)


def sharded_ba_phase(dev, two):
    """[sharded-ba] ShardedBA on testing.ba_instance('ba-trafalgar') with
    the cell's schedule (dense Schur), at one rank (NCCL) counted from
    zero (no kernel), and the two gloo ranks (``two``), each held to the
    card's BundleAdjustment with the same schedule and to the JAX
    BundleAdjustment's data/jax_anchor_ba_trafalgar.json by
    :func:`accepted_hold` at 2e-2 (the JAX package's hold of the dense
    ShardedBA to BundleAdjustment); the two ranks' poses bit-equal; ms a
    step.  The JAX ShardedBA's own run over 8 virtual devices
    (data/jax_anchor_sharded_ba.json) is printed beside: its fourth step
    is rejected on the knife edge, and its final (68,480) is the others'
    fourth accepted step, one behind their 65,385."""
    import json
    import torch
    from pypose_tpu_torch.datasets import find_data
    from pypose_tpu_torch.parallel import make_mesh
    from pypose_tpu_torch.testing import (BA_SCHEDULES, ba_instance,
                                          ba_optimizer)
    sched = BA_SCHEDULES[SHARDED_BA_CELL]
    card = ba_optimizer(ba_instance(SHARDED_BA_CELL, device=dev),
                        SHARDED_BA_CELL)
    card.optimize(steps=sched['steps'], patience=sched['patience'],
                  decreasing=sched['decreasing'])
    card_hist = list(card.history)
    del card
    mesh = make_mesh()
    reset_counts()
    hist, ms, reduces, opt = sharded_ba_run(mesh, dev)
    counts = no_launches('[sharded-ba]')
    check(opt._use_dense_schur, 'sharded-ba: not the dense Schur route')
    with open(find_data('jax_anchor_ba_trafalgar.json')) as f:
        anchor = json.load(f)
    with open(find_data('jax_anchor_sharded_ba.json')) as f:
        jax_sharded = json.load(f)['final_chi2']
    r0, r1 = two[0]['ba'], two[1]['ba']
    same = torch.equal(r0['poses'], r1['poses']) and \
        torch.equal(r0['points'], r1['points'])
    gaps = {}
    for who, h in (('one rank', hist), ('two ranks', r0['hist'])):
        gaps[who] = (accepted_hold(h, card_hist),
                     accepted_hold(h, anchor['history']))
        print(f'[sharded-ba] {who}: chi2 {h}; against the card\'s '
              f'BundleAdjustment {card_hist}: {gaps[who][0]}; against the '
              f'JAX BundleAdjustment anchor {anchor["history"]}: '
              f'{gaps[who][1]} (bounds 2e-2, at most one accepted step '
              f'short); the JAX ShardedBA\'s final over 8 devices: '
              f'{jax_sharded}', flush=True)
        check(all(g['ok'] for g in gaps[who]),
              f'sharded-ba: {who} off its holds')
    print(f'[sharded-ba] one rank {ms:.3f} ms a step, {reduces} all_reduce '
          f'calls a step; two ranks ({r0["local_obs"]} observations a '
          f'rank) {r0["ms"]:.3f} ms a step, {r0["reduces"]} all_reduce '
          f'calls a step; poses and points bit-equal across ranks: {same};'
          f' launch counts {counts}', flush=True)
    check(same, 'sharded-ba: the two ranks ended on different states')
    return dict(hist=hist, ms_per_step=ms, all_reduces_per_step=reduces,
                gaps=gaps, two_ranks=dict(hist=r0['hist'],
                                          ms_per_step=r0['ms'],
                                          all_reduces_per_step=r0['reduces']),
                counts=counts)


def accepted_hold(hist, ref, rtol=2e-2):
    """A chi2 history held to a reference history by accepted steps: the
    chi2 after each accepted step (a step that leaves chi2 where it was
    had every retry rejected), the run's last against the reference's
    after as many accepted steps, within ``rtol``, and the run at most one
    accepted step short of the reference (a step on a TrustRegion knife
    edge, where the summation order decides, may be rejected).  Returns
    the numbers and 'ok'."""
    def accepted(h):
        out = [h[0]]
        for v in h[1:]:
            if v < out[-1]:
                out.append(v)
        return out
    a, r = accepted(hist), accepted(ref)
    gap = a[-1] / r[min(len(a), len(r)) - 1] - 1
    return dict(accepted=len(a), reference_accepted=len(r), gap=gap,
                ok=abs(gap) <= rtol and len(a) >= len(r) - 1)


def sharded_steps_phase(dev):
    """[sharded-steps] make_pgo_step on the sphere2500 graph and
    make_ba_step on ba-trafalgar, two steps each, at one rank (NCCL) on
    the card: chi2 falls in float32 (timed), and the card agrees with the
    CPU (no mesh) within 1e-4 in float64.  In float32 a raw step's second
    chi2 moves with the order of the sums alone: on the CPU, permuting the
    edges moves make_pgo_step's by up to 1.6e-3 and make_ba_step's by
    1.6e-4 (1e-12 in float64), and the card's scatter-add (atomics) sums
    in a new order every run.  Then sharded_stencil_matvec at one rank
    against StencilSpMV.matvec at the pgo-100k shape (N = 100,000, t = 6,
    offsets 1 and 993), within 1e-6 of max|y|, with no message sent."""
    import torch
    from pypose_tpu_torch.datasets import find_data, load_g2o
    from pypose_tpu_torch.ops.spmv import StencilSpMV
    from pypose_tpu_torch.parallel import (make_ba_step, make_mesh,
                                           make_pgo_step, stencil)
    from pypose_tpu_torch.testing import ba_instance
    mesh = make_mesh()
    out = {}
    reset_counts()
    cpu = torch.device('cpu')
    for name in ('pgo', 'ba'):
        res = {}
        for where, d, m, dt in (('card', dev, mesh, torch.float32),
                                ('card f64', dev, mesh, torch.float64),
                                ('cpu f64', cpu, None, torch.float64)):
            if name == 'pgo':
                ds = load_g2o(find_data(G2O), device=d)
                step = make_pgo_step(ds['nodes'].shape[0], mesh=m)
                state = [ds['nodes'].tensor().to(dt)]
                args = (ds['edges'], ds['poses'].tensor().to(dt))
            else:
                ds = ba_instance(SHARDED_BA_CELL, device=d, dtype=dt)
                step = make_ba_step(ds['poses'].shape[0],
                                    ds['points'].shape[0], mesh=m)
                state = [ds['poses'].tensor(), ds['points']]
                args = (ds['cam_idx'], ds['pt_idx'], ds['pixels'],
                        ds['cameras'][ds['cam_idx']])
            chi, ms = [], []
            for _ in range(2):
                t, outs = synced_ms(lambda: step(*state, *args)) \
                    if d.type == 'cuda' else (0.0, step(*state, *args))
                state, c = list(outs[:-1]), float(outs[-1])
                chi.append(c)
                ms.append(t)
            res[where] = chi, ms
            check(chi[1] < chi[0], f'sharded-steps: {name} chi2 did not '
                  f'fall ({where}): {chi}')
        gap = rel_gap(res['card f64'][0], res['cpu f64'][0])
        print(f'[sharded-steps] make_{name}_step: card chi2 float32 '
              f'{res["card"][0]}, float64 {res["card f64"][0]}; CPU float64 '
              f'{res["cpu f64"][0]}: largest relative gap {gap:.3e} (bound '
              f'1e-4); card ms a step (float32) {res["card"][1]}', flush=True)
        check(gap <= 1e-4, f'sharded-steps: make_{name}_step card and CPU '
              'differ')
        out[name] = dict(chi2=res['card'][0], ms=res['card'][1], gap=gap)
    no_launches('[sharded-steps]')
    N, t = 100_000, 6
    ii = torch.arange(N)
    edges = torch.cat([torch.stack([ii, (ii + 1) % N], 1),
                       torch.stack([ii[:80_000], ii[:80_000] + 993], 1)])
    st = StencilSpMV(edges, N, t, device=dev)
    gen = torch.Generator().manual_seed(0)
    C = (0.1 * torch.randn((len(st.offsets), N, t, t), generator=gen)).to(dev)
    D = (torch.eye(t) + 0.1 * torch.randn((N, t, t), generator=gen)).to(dev)
    x = torch.randn((N, t), generator=gen).to(dev)
    before = stencil.MESSAGES
    y = stencil.sharded_stencil_matvec(st, make_mesh(axis='mp'), 'mp')(C, D,
                                                                        x)
    want = st.matvec(C, D, x)
    err = float((y - want).abs().max() / want.abs().max())
    sent = stencil.MESSAGES - before
    print(f'[sharded-steps] sharded_stencil_matvec at one rank, N={N}, '
          f't={t}, offsets {st.offsets}: max|y - y_ref| / max|y_ref| '
          f'{err:.3e} (bound 1e-6), {sent} messages', flush=True)
    check(err <= 1e-6 and sent == 0,
          'sharded-steps: the one-rank stencil matvec is off')
    out['stencil'] = dict(err=err, messages=sent)
    return out


def main():
    t_script = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this script needs an NVIDIA GPU')
    from pypose_tpu_torch.ops import _build, knn, se3
    from pypose_tpu_torch.ops import stencil_cg as scg
    from pypose_tpu_torch.ops.stencil_cg import TEMPLATE_T
    from pypose_tpu_torch.optim.sparse import require_full_fp32

    # 1. device
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader', '-i', '0'],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device('cuda', 0)
    require_full_fp32(dev)
    print(f'[device] {smi}; torch {torch.__version__} CUDA '
          f'{torch.version.cuda}; python {sys.version.split()[0]}; '
          f'{torch.cuda.device_count()} visible', flush=True)

    # 2. build: one nvcc per source, all at once
    stencil = ('stencil_cg', 'stencil_cg_tiled', 'stencil_cg_fused')
    t0 = time.perf_counter()
    paths = _build.build_all(stencil + ('knn', 'se3'))
    for name in stencil:
        scg._kernel_lib(name)
    knn._kernel_lib()
    se3._kernel_lib()
    print(f'[build] {", ".join(p.name for p in paths)} ready in '
          f'{time.perf_counter() - t0:.2f} s (set-up)', flush=True)
    for path in paths:
        log = path.with_suffix('.log')
        if not log.exists():
            continue
        entry = spill = ''
        for line in log.read_text().splitlines():
            if 'Compiling entry' in line:
                entry = line.strip()
            elif 'spill' in line:
                spill = line.strip()
            # csrc/knn.cu: the float32 and float64 instantiations for D = 3
            # and D = 8, the warp merge scan's at every D, and the wide
            # scans
            elif 'Used' in line and path.stem != 'libknn':
                # the stencil kernels: each template, and the runtime-t
                # instantiation (template argument 0, tiled_*_any_t, or
                # the ring matvec)
                kind = '' if 'stencil' not in path.stem else (
                    ' (runtime t)' if 'ILi0E' in entry or 'any_t' in entry
                    or 'tiled_mv_ring' in entry else ' (template)')
                print(f'[build] {path.stem}{kind}: {entry}\n[build] '
                      f'{path.stem}: {spill}; {line.strip()}', flush=True)
            elif 'Used' in line and ('wide' in entry
                                     or 'big' in entry or 'sel_' in entry
                                     or 'warp_scan' in entry
                                     or 'tf32_split' in entry
                                     or any(f'I{t}Li{d}E' in entry
                                            for t in 'fd' for d in (3, 8))):
                print(f'[build] {path.stem}: {entry}\n[build] {path.stem}: '
                      f'{spill}; {line.strip()}', flush=True)
    # the wide scans run on the tensor cores: HGMMA in the float32 ones'
    # SASS, DMMA in the float64 ones'; eight instantiations a type (nn1,
    # nnk at 2, 4, 8, 16 and past 16 (K = 0), and the select path's
    # counting passes and emission (K = -1, -2)), one count a type
    for tname, code, op, many in (('float32', 'f', 'HGMMA', 8),
                                  ('float64', 'd', 'DMMA', 8)):
        # the mangled names: wide_tc_scan<float, K> is wide_tc_scanIf...
        tc = compiled_kernels(_build.BUILD / 'libknn.so',
                              (f'wide_tc_scanI{code}',), op)
        for name, (used, spill, n) in tc.items():
            print(f'[build] libknn: {name}: {op} instructions in its SASS '
                  f'{"not read (no cuobjdump)" if n is None else n}; '
                  f'{used}; {spill}', flush=True)
        counts = {n for _, _, n in tc.values()}
        check(len(tc) == many and (counts == {None} or
                                   (len(counts) == 1 and min(counts) > 0)),
              f'the {tname} wide scans: {many} instantiations with one '
              f'{op} count expected, found {tc}')
    # ptxas warns C7520 where it serializes the wgmmas
    knn_log = (_build.BUILD / 'libknn.log').read_text()
    check('C7520' not in knn_log,
          'ptxas serialized wgmma in csrc/knn.cu (C7520): '
          + '; '.join(l for l in knn_log.splitlines() if 'C7520' in l))
    print('[build] libknn: no C7520 (serialized wgmma) in ptxas\' output',
          flush=True)

    # 3. kernels vs plain versions on the card
    whole = [
        whole_solve_vs_plain('N=40', 40, 9, 15, False, 500, 1e-6),
        whole_solve_vs_plain('sphere2500 shape', 2500, 157, 2000, True, 500,
                             1e-6),
        whole_solve_vs_plain('N=20,000', 20_000, 157, 16_000, True, 500,
                             1e-6),
        whole_solve_vs_plain('N=20,000, 150 iterations', 20_000, 157, 16_000,
                             True, 150, 0.0)]
    # tol 0 runs the full 150 iterations, as the first phase's solves do
    whole.append(whole_solve_vs_plain(
        'sphere2500 shape, 150 iterations', 2500, 157, 2000, True, 150, 0.0))
    _, k_ms, p_ms, k_it = whole[-1]
    small, _ = oversize_solvers_vs_plain(
        'N=53', stencil_system(53, 9, 15, False), 200, 1e-7)
    big_system = stencil_system(100_000, 993, 80_000, True)
    big, big_plan = oversize_solvers_vs_plain('100k shape, tol 1e-3',
                                              big_system, 250, 1e-3)
    full, _ = oversize_solvers_vs_plain('100k shape, 250 iterations',
                                        big_system, 250, 0.0)
    check(big_plan['smem'], 'the 100k shape is past the fused kernel\'s '
          'shared-memory mode')
    fused_dev = fused_device_ms(big_system, 250, 0.0)
    alone = tiled_kernels_vs_plain(big_system)
    del big_system
    past, past_plan = oversize_solvers_vs_plain(
        'N=200,000', stencil_system(200_000, 993, 160_000, True), 250, 1e-3)
    check(not past_plan['smem'], 'N=200,000 is within the fused kernel\'s '
          'shared-memory mode: it would not test the global mode')
    # the same kernels at the other groups' block sizes (their templates)
    # and at t = 1, 2, 5, 9, 16 (the runtime-t instantiation), on the full
    # shapes; every other t from 1 to 17 on the small ones
    by_t = {t: block_size_kernels(t) for t in (3, 4, 7, 1, 2, 5, 9, 16)}
    check(all(by_t[t]['plan']['smem'] == (t <= 6) for t in by_t),
          'the fused plan at the 100k shape: shared-memory mode expected up '
          'to t = 6 (6t + tt floats a node: 7 at t = 1, 55 at t = 5), '
          'global-memory mode from t = 7 (91 floats a node, 758 nodes a '
          f'CTA): {({t: r["plan"]["smem"] for t, r in by_t.items()})}')
    small_t = {t: small_shape_kernels(t) for t in SMALL_ONLY_T}
    # the runtime-t instantiation's cost at a template's t
    rt_cost = {t: runtime_t_cost(t) for t in (3, 6)}
    vs_fused = tiled_vs_fused({t: (full, alone) if t == 6 else
                               (by_t[t], by_t[t]['alone'])
                               for t in TILED_VS_FUSED_T})
    offsets0, ops0 = stencil_system(40, 9, 15, False, 5)
    before = read_counts()
    for solver in (scg.stencil_cg_transposed, scg.stencil_cg_tiled,
                   scg.stencil_cg_fused):
        try:
            solver(*(a[:0] for a in ops0), offsets0, 0, 5, 1e-6)
        except ValueError as e:
            print(f'[kernel] {solver.__name__} at t=0 raises: {e}',
                  flush=True)
        else:
            raise RuntimeError(f'{solver.__name__} took t=0 on the card')
    check(read_counts() == before, 't = 0 launched a kernel')
    point = point_kernels_vs_plain(dev)

    # 4., 5., 7.-11. the paths, each counted from zero over its cold run
    first_step_agreement(dev)
    sphere_counts, sphere_ms = sphere2500_slice(dev)
    pgo_counts, pgo_prof = pgo100k_slice(dev)
    groups = {name: group_graph_phase(name, dev, kernel,
                                      profiled=name == 'sim3_sphere2500')
              for name, kernel in (('so3_sphere2500', 'whole'),
                                   ('rxso3_sphere2500', 'whole'),
                                   ('sim3_sphere2500', 'whole'),
                                   ('so3_100k', 'fused'),
                                   ('rxso3_100k', 'fused'),
                                   ('sim3_100k', 'fused'))}
    groups_loops = pgo_groups_phase(dev)
    icp_card_vs_cpu(dev)
    icp_counts = icp_slice(dev)
    k8_counts, k8_err, k8_ms, k8_plain, k8_torch, k8_lib = knn_k8_phase(dev)
    d6 = knn_d6_phase(dev)
    # 37. the knn kernels past 8 coordinates (the wide scans)
    wide, wide_counts = knn_wide_phase(dev)
    # 37b. nnk at k > 16
    bigk = knn_bigk_phase(dev)
    sparse_f64_phase(dev)
    # the runtime-t instantiation on SparseLM's path
    any_t = stencil_any_t_phase(dev)
    general = {'pgo-chain': pgo_chain_phase(dev),
               'pgo-loops': pgo_loops_phase(dev)}
    # 13.-17. the Lie core's autograd and the paths it opens
    from pypose_tpu_torch.optim.kernel import Huber
    autograd_errs, jacrev = autograd_phase(dev, smi)
    blocks_err = autodiff_blocks_phase(dev)
    autodiff = {'sphere2500-autodiff': sphere2500_variant(
        'sphere2500-autodiff', dev, autodiff=True)}
    print(f'[sphere2500-autodiff] ms/LM step cold, warm: autodiff '
          f'{autodiff["sphere2500-autodiff"]["ms_per_step_cold"]:.3f}, '
          f'{autodiff["sphere2500-autodiff"]["ms_per_step_warm"]:.3f}; '
          f'closed form (the [slice] phase of this run) '
          f'{sphere_ms["ms_per_step_cold"]:.3f}, '
          f'{sphere_ms["ms_per_step_warm"]:.3f}', flush=True)
    autodiff['sim3-sphere2500-autodiff'] = group_graph_phase(
        'sim3_sphere2500', dev, 'whole', autodiff=True)
    for form in ('closed form', 'autodiff'):
        autodiff[f'sphere2500-huber {form}'] = sphere2500_variant(
            f'sphere2500-huber {form}', dev, kernel=Huber(delta=5.0),
            autodiff=form == 'autodiff', anchor='sphere2500_huber')
    reproj = reproj_phase(dev)
    # 18.-21. bundle adjustment (no kernel on its path)
    ba_cells = ba_phase(dev)
    # 23.-28. IMU, the dense optimizers, SparseLM's other strategies and
    # the filters (no kernel on their paths but the whole solve's)
    newer = {'imu-1m': imu_phase(dev), 'imu-synth': imu_synth_phase(dev),
             'batch-lm': batch_lm_phase(dev),
             'dense-lm': dense_lm_phase(dev),
             'sparse-strategies': sparse_strategies_phase(dev),
             'filters': filters_phase(dev)}
    # 29.-32. LSTSQ on the card, EPnP, the filters' rollouts and MPC (no
    # kernel on their paths)
    lstsq_phase(dev)
    newer.update(epnp_phase(dev))
    newer.update(filters_rollout_phase(dev))
    newer.update(mpc_phase(dev))
    # 38.-40. the sharded path (no kernel on it)
    two = sharded_two_ranks()
    sharded = {'sharded-pgo': sharded_pgo_phase(dev, two),
               'sharded-ba': sharded_ba_phase(dev, two),
               'sharded-steps': sharded_steps_phase(dev)}
    # 33.-36. trajectory evaluation, splines, block-sparse products and the
    # examples (no kernel on their paths but the whole solve's)
    newer.update({'traj-eval': traj_eval_phase(dev),
                  'spline': spline_phase(dev), 'bsr': bsr_phase(dev),
                  'examples': examples_phase()})

    # results: each kernel's bound from this run's shapes (two offsets;
    # float32 operands and vectors, 4 bytes a float)
    def route_err(route):
        return max(r[route][0] for r in (small, big, full, past))

    n_off = 2
    N2500, N100k, icp_n, nnk_r = 2500, 100_000, 100_000, 20_000

    # the whole solve: b, A, Minv, C read once, x written once; per node
    # and iteration the matvec's tt (2 + 2 n_off) FMA with Minv, three dots
    # and three updates of t
    def pcg_bound(t, its):
        return bound(4 * N2500 * (2 * t + (2 + n_off) * t * t),
                     2 * its * N2500 * (t * t * (2 + 2 * n_off) + 6 * t))

    def mv_bound(t):
        return bound(4 * N100k * (t * t * (1 + n_off) + 2 * t),
                     2 * N100k * t * t * (1 + 2 * n_off))

    def pc_bound(t):
        return bound(4 * N100k * (t * t + 2 * t), 2 * N100k * t * t)

    # fused Chronopoulos-Gear solve: operands once; per iteration the
    # matvec, Minv, three dots and four updates
    def fused_bound(t, its):
        return bound(4 * N100k * (2 * t + (2 + n_off) * t * t),
                     2 * its * N100k * (t * t * (2 + 2 * n_off) + 7 * t))

    mv_b, pc_b = mv_bound(6), pc_bound(6)
    f_it = full['fused'][3]
    fused_b = fused_bound(6, f_it)
    # nearest neighbours: 3 FMA a pair; the clouds read once, d2 and the
    # int64 index written once
    nn1_b = bound(4 * 2 * icp_n * 3 + 12 * icp_n, 6 * icp_n * icp_n)
    nnk_b = bound(4 * (nnk_r + icp_n) * 3 + 12 * nnk_r * 16,
                  6 * nnk_r * icp_n)
    # knn-d6: 2 D flop a pair at D = 6, 10k x 10k
    d6_n = 10_000
    nn1_d6_b = bound(4 * 2 * d6_n * 6 + 12 * d6_n, 12 * d6_n * d6_n)
    nnk_d6_b = bound(4 * 2 * d6_n * 6 + 12 * d6_n * 8, 12 * d6_n * d6_n)
    # the same in float64, its operations at FP64_FLOP_PER_S
    nn1_d6_b64 = bound(8 * 2 * d6_n * 6 + 16 * d6_n, 12 * d6_n * d6_n,
                       FP64_FLOP_PER_S)
    nnk_d6_b64 = bound(8 * 2 * d6_n * 6 + 16 * d6_n * 8, 12 * d6_n * d6_n,
                       FP64_FLOP_PER_S)
    # SE3: [N, 7] x [N, 7] -> [N, 7] (~60 flop), [N, 7] x [N, 3] -> [N, 3]
    # (~30 flop)
    se3_b = {'se3_mul': bound(4 * N100k * 21, 60 * N100k),
             'se3_act': bound(4 * N100k * 13, 30 * N100k)}

    def entry(name, source, replaces, launches, err, ms, plain_ms, b,
              library_ms=None, **kw):
        return dict(name=name, route='cuda', source=src + source,
                    replaces=replaces, launches=launches, max_abs_err=err,
                    ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                    library_ms=library_ms, **kw)

    src = 'pypose_tpu_torch/csrc/'
    pallas = 'pypose_tpu/ops/pallas_cg.py:'
    l2_ms = whole[3][1]
    kernels = [
        entry('stencil_pcg', 'stencil_cg.cu', pallas + '101',
              sphere_counts['LAUNCHES'], max(w[0] for w in whole), k_ms,
              p_ms, pcg_bound(6, k_it),
              ms_of=f'one {k_it}-iteration solve, sphere2500 shape, '
                    'operands in shared memory',
              ms_l2_operands=l2_ms,
              ms_l2_operands_of='one 150-iteration solve, N=20,000',
              launches_by_path={
                  'sphere2500': sphere_counts['LAUNCHES'],
                  **{k: v['counts']['LAUNCHES'] for k, v in autodiff.items()
                     if k.startswith('sphere2500')},
                  'sparse-strategies (Adaptive)': newer['sparse-strategies'][
                      'counts']['LAUNCHES']}),
        entry('stencil_tiled_mv', 'stencil_cg_tiled.cu', pallas + '131',
              pgo_counts['TILED_MV_LAUNCHES'],
              max(alone['mv'][0], route_err('tiled')), alone['mv'][1] / 1e3,
              alone['mv'][2] / 1e3, mv_b, device_ms=alone['mv'][4] / 1e3,
              device_ms_l2_flushed=alone['mv'][5] / 1e3,
              ms_of='one launch, 100k shape (device_ms: torch.profiler, '
                    'operands warm in L2; device_ms_l2_flushed: L2 flushed '
                    'before each launch; vs_fused: us an iteration of the '
                    'tiled solve and of its kernels alone against the '
                    'fused solve, 100k shape, t = 6 at 250 iterations, '
                    'the others at 60)',
              vs_fused=vs_fused, routed=False),
        entry('stencil_tiled_pc', 'stencil_cg_tiled.cu', pallas + '149',
              pgo_counts['TILED_PC_LAUNCHES'],
              max(alone['pc'][0], route_err('tiled')), alone['pc'][1] / 1e3,
              alone['pc'][2] / 1e3, pc_b, library_ms=alone['pc'][3] / 1e3,
              library='torch.einsum over the [t, t, N] blocks',
              device_ms=alone['pc'][4] / 1e3,
              device_ms_l2_flushed=alone['pc'][5] / 1e3,
              ms_of='one launch, 100k shape (device_ms: torch.profiler, '
                    'operands warm in L2; device_ms_l2_flushed: L2 flushed '
                    'before each launch)',
              routed=False),
        entry('stencil_fused', 'stencil_cg_fused.cu',
              pallas + '253, :290', pgo_counts['FUSED_LAUNCHES'],
              max(route_err('fused'), route_err('fused_bf16')),
              full['fused'][1], full['fused'][2], fused_b,
              ms_bf16=full['fused_bf16'][1],
              plain_ms_bf16=full['fused_bf16'][2],
              device_ms=fused_dev['fused'],
              device_ms_bf16=fused_dev['fused_bf16'],
              tiled_ms=full['tiled'][1],
              ms_global_mode=past['fused'][1],
              ms_global_mode_of=f'N=200,000, tol 1e-3, {past["fused"][3]} '
                                'iterations, state in global memory',
              ms_of=f'one {f_it}-iteration solve, 100k shape, float32 '
                    'operands (ms_bf16: bf16 operands; device_ms: '
                    'torch.profiler; tiled_ms: the tiled solver on the '
                    'same system)', routed=True),
        entry('nn1', 'knn.cu', 'pypose_tpu/ops/pallas_knn.py:22',
              icp_counts['NN1_LAUNCHES'], max(point['nn1'][0], d6['nn1'][0]),
              point['nn1'][1],
              point['nn1'][2], nn1_b, ms_of='100k x 100k, ICP clouds',
              two_call_reference_ms=point['nn1'][3],
              two_call_reference='torch.cdist then torch.min, per chunk of '
                                 '64 Mi pairs: two calls, no one call',
              ms_d6=d6['nn1'][1], plain_ms_d6=d6['nn1'][2],
              bound_ms_d6=nn1_d6_b[0], bound_by_d6=nn1_d6_b[1],
              two_call_reference_ms_d6=d6['nn1'][3],
              ms_d6_of='knn(k=1), [10000, 6] x [10000, 6] float32, one '
                       'launch (max_abs_err includes it)',
              ms_d6_f64=d6['nn1_f64'][1], plain_ms_d6_f64=d6['nn1_f64'][2],
              bound_ms_d6_f64=nn1_d6_b64[0], bound_by_d6_f64=nn1_d6_b64[1],
              max_abs_err_d6_f64=d6['nn1_f64'][0],
              routed=True),
        entry('nnk', 'knn.cu', 'pypose_tpu/ops/pallas_knn.py:50',
              k8_counts['NNK_LAUNCHES'],
              max(point['nnk4'][0], point['nnk16'][0], k8_err, d6['nnk'][0]),
              point['nnk16'][1], point['nnk16'][2], nnk_b,
              library_ms=point['nnk16'][3],
              library='torch.cdist then torch.topk, per chunk of 64 Mi pairs',
              ms_k4=point['nnk4'][1], plain_ms_k4=point['nnk4'][2],
              library_ms_k4=point['nnk4'][3], knn_k8_ms=k8_ms,
              knn_k8_torch_path_ms=k8_torch, knn_k8_library_ms=k8_lib,
              knn_k8_plain_ms=k8_plain,
              ms_d6_k8=d6['nnk'][1], plain_ms_d6_k8=d6['nnk'][2],
              bound_ms_d6_k8=nnk_d6_b[0], bound_by_d6_k8=nnk_d6_b[1],
              library_ms_d6_k8=d6['nnk'][3],
              ms_d6_f64_k8=d6['nnk_f64'][1],
              plain_ms_d6_f64_k8=d6['nnk_f64'][2],
              bound_ms_d6_f64_k8=nnk_d6_b64[0],
              bound_by_d6_f64_k8=nnk_d6_b64[1],
              max_abs_err_d6_f64_k8=d6['nnk_f64'][0],
              ms_of='k=16 (ms_k4: k=4), 20k x 100k slice of the ICP clouds; '
                    'knn_k8: knn(k=8) at 100k x 100k, launches from it',
              routed=True)]
    # the same three sources at block sizes 3, 4 and 7: launches from the
    # cold runs of the group's sphere2500 graph (whole solve) and 100k
    # graph (fused)
    for t, g in ((3, 'so3'), (4, 'rxso3'), (7, 'sim3')):
        r = by_t[t]
        w_err, w_ms, w_plain, w_it = r['whole']
        kernels += [
            entry(f'stencil_pcg_t{t}', 'stencil_cg.cu', pallas + '101',
                  groups[f'{g}_sphere2500']['counts']['LAUNCHES'], w_err,
                  w_ms, w_plain, pcg_bound(t, w_it), block_size=t,
                  **({'launches_by_path': {
                      'sim3-sphere2500': groups['sim3_sphere2500'][
                          'counts']['LAUNCHES'],
                      'sim3-sphere2500-autodiff': autodiff[
                          'sim3-sphere2500-autodiff']['counts']['LAUNCHES']}}
                     if t == 7 else {}),
                  ms_of=f'one {w_it}-iteration solve, sphere2500 shape, '
                        'operands in shared memory; launches from '
                        f'{g}-sphere2500', routed=True),
            entry(f'stencil_tiled_mv_t{t}', 'stencil_cg_tiled.cu',
                  pallas + '131', 0,
                  max(r['alone']['mv'][0], r['err']['tiled']),
                  r['alone']['mv'][1] / 1e3, r['alone']['mv'][2] / 1e3,
                  mv_bound(t), device_ms=r['alone']['mv'][4] / 1e3,
                  device_ms_l2_flushed=r['alone']['mv'][5] / 1e3,
                  block_size=t, routed=False,
                  ms_of='one launch, 100k shape (device_ms: '
                        'torch.profiler, operands warm in L2; '
                        'device_ms_l2_flushed: L2 flushed before each '
                        'launch)'),
            entry(f'stencil_tiled_pc_t{t}', 'stencil_cg_tiled.cu',
                  pallas + '149', 0,
                  max(r['alone']['pc'][0], r['err']['tiled']),
                  r['alone']['pc'][1] / 1e3, r['alone']['pc'][2] / 1e3,
                  pc_bound(t), library_ms=r['alone']['pc'][3] / 1e3,
                  library='torch.einsum over the [t, t, N] blocks',
                  device_ms=r['alone']['pc'][4] / 1e3,
                  device_ms_l2_flushed=r['alone']['pc'][5] / 1e3,
                  block_size=t, routed=False,
                  ms_of='one launch, 100k shape (device_ms: '
                        'torch.profiler, operands warm in L2; '
                        'device_ms_l2_flushed: L2 flushed before each '
                        'launch)'),
            entry(f'stencil_fused_t{t}', 'stencil_cg_fused.cu',
                  pallas + '253, :290',
                  groups[f'{g}_100k']['counts']['FUSED_LAUNCHES'],
                  max(r['err']['fused'], r['err']['fused_bf16']),
                  r['fused'][1], r['fused'][2],
                  fused_bound(t, r['fused'][3]),
                  ms_bf16=r['fused_bf16'][1],
                  plain_ms_bf16=r['fused_bf16'][2], tiled_ms=r['tiled'][1],
                  state_in='shared memory' if r['plan']['smem']
                  else 'global memory', block_size=t, routed=True,
                  ms_of=f'one {r["fused"][3]}-iteration solve, 100k shape, '
                        'float32 operands (ms_bf16: bf16 operands; '
                        'tiled_ms: the tiled solver on the same system); '
                        f'launches from {g}-100k')]
    # the runtime-t instantiations (template argument 0; tiled_*_any_t):
    # the headline numbers at t = 9, every full-shape t in `cases`, the
    # small shapes' errors at the other t, the cost against the templates
    # at t = 3 and 6; launches from [stencil-any-t], each case counted
    # from zero
    def any_t_launches(solver):
        return {tag: v['launches'] for tag, v in any_t.items()
                if v['solver'] == solver}

    def cost(name):
        return {t: dict(template_ms=c[name][0], ms=c[name][1],
                        bit_equal=c[name][2]) for t, c in rt_cost.items()}

    def small_err(route):
        return {t: e[route] for t, e in small_t.items()}

    def tiled_cases(kname, b_fn):
        return {t: dict(ms=r['alone'][kname][1] / 1e3,
                        plain_ms=r['alone'][kname][2] / 1e3,
                        library_ms=None if r['alone'][kname][3] is None
                        else r['alone'][kname][3] / 1e3,
                        device_ms=r['alone'][kname][4] / 1e3,
                        device_ms_l2_flushed=r['alone'][kname][5] / 1e3,
                        bound_ms=b_fn(t)[0], bound_by=b_fn(t)[1],
                        max_abs_err=max(r['alone'][kname][0],
                                        r['err']['tiled']))
                for t, r in by_t.items() if t not in TEMPLATE_T}

    any_ts = [t for t in by_t if t not in TEMPLATE_T]
    r9 = by_t[9]
    w_launch, f_launch = any_t_launches('whole'), any_t_launches('fused')
    kernels += [
        entry('stencil_pcg_any_t', 'stencil_cg.cu', pallas + '101',
              sum(w_launch.values()),
              max([by_t[t]['whole'][0] for t in any_ts]
                  + list(small_err('whole').values())),
              r9['whole'][1], r9['whole'][2], pcg_bound(9, r9['whole'][3]),
              block_size=9, launches_by_path=w_launch,
              cases={t: dict(ms=by_t[t]['whole'][1],
                             plain_ms=by_t[t]['whole'][2],
                             iterations=by_t[t]['whole'][3],
                             bound_ms=pcg_bound(t, by_t[t]['whole'][3])[0],
                             bound_by=pcg_bound(t, by_t[t]['whole'][3])[1],
                             max_abs_err=by_t[t]['whole'][0],
                             operands_in='shared memory'
                             if scg.stencil_cg_smem_fits(N2500, t, n_off)
                             else 'L2') for t in any_ts},
              max_abs_err_small=small_err('whole'),
              runtime_t_cost=cost('whole'),
              ms_of=f'one {r9["whole"][3]}-iteration solve, sphere2500 '
                    'shape, t = 9, operands in L2 (cases: t = 1, 2, 5, 9, '
                    '16; max_abs_err_small: N = 40 at the other t; '
                    'runtime_t_cost: device ms of one 150-iteration solve '
                    'at sphere2500\'s shape, template against runtime-t); '
                    'launches from [stencil-any-t]', routed=True),
        entry('stencil_tiled_mv_any_t', 'stencil_cg_tiled.cu',
              pallas + '131', 0,
              max(v['max_abs_err'] for v in
                  tiled_cases('mv', mv_bound).values()),
              r9['alone']['mv'][1] / 1e3, r9['alone']['mv'][2] / 1e3,
              mv_bound(9), device_ms=r9['alone']['mv'][4] / 1e3,
              device_ms_l2_flushed=r9['alone']['mv'][5] / 1e3,
              block_size=9, cases=tiled_cases('mv', mv_bound),
              max_abs_err_small=small_err('tiled'),
              runtime_t_cost=cost('tiled_mv'), routed=False,
              kernel_by_t={t: 'tiled_mv_ring' if t >= 5 else
                           'tiled_mv_any_t' for t in any_ts},
              ms_of='one launch, 100k shape, t = 9 (device_ms: '
                    'torch.profiler, operands warm in L2; '
                    'device_ms_l2_flushed: L2 flushed before each launch; '
                    'runtime_t_cost: device ms of one launch; '
                    'kernel_by_t: the runtime-t matvec takes the ring '
                    '(persistent CTAs fed by bulk copies) from t = 5)'),
        entry('stencil_tiled_pc_any_t', 'stencil_cg_tiled.cu',
              pallas + '149', 0,
              max(v['max_abs_err'] for v in
                  tiled_cases('pc', pc_bound).values()),
              r9['alone']['pc'][1] / 1e3, r9['alone']['pc'][2] / 1e3,
              pc_bound(9), library_ms=r9['alone']['pc'][3] / 1e3,
              library='torch.einsum over the [t, t, N] blocks',
              device_ms=r9['alone']['pc'][4] / 1e3,
              device_ms_l2_flushed=r9['alone']['pc'][5] / 1e3,
              block_size=9, cases=tiled_cases('pc', pc_bound),
              runtime_t_cost=cost('tiled_pc'), routed=False,
              ms_of='one launch, 100k shape, t = 9 (as '
                    'stencil_tiled_mv_any_t)'),
        entry('stencil_fused_any_t', 'stencil_cg_fused.cu',
              pallas + '253, :290', sum(f_launch.values()),
              max([max(by_t[t]['err']['fused'], by_t[t]['err']['fused_bf16'])
                   for t in any_ts]
                  + [max(e['fused'], e['fused_bf16'])
                     for e in small_t.values()]),
              r9['fused'][1], r9['fused'][2],
              fused_bound(9, r9['fused'][3]), block_size=9,
              launches_by_path=f_launch,
              cases={t: dict(ms=by_t[t]['fused'][1],
                             plain_ms=by_t[t]['fused'][2],
                             ms_bf16=by_t[t]['fused_bf16'][1],
                             plain_ms_bf16=by_t[t]['fused_bf16'][2],
                             tiled_ms=by_t[t]['tiled'][1],
                             iterations=by_t[t]['fused'][3],
                             bound_ms=fused_bound(t, by_t[t]['fused'][3])[0],
                             bound_by=fused_bound(t, by_t[t]['fused'][3])[1],
                             max_abs_err=max(by_t[t]['err']['fused'],
                                             by_t[t]['err']['fused_bf16']),
                             state_in='shared memory'
                             if by_t[t]['plan']['smem'] else 'global memory')
                     for t in any_ts},
              max_abs_err_small={t: max(e['fused'], e['fused_bf16'])
                                 for t, e in small_t.items()},
              runtime_t_cost={t: dict(fused=v, fused_bf16=w) for (t, v), w
                              in zip(cost('fused').items(),
                                     cost('fused_bf16').values())},
              ms_of=f'one {r9["fused"][3]}-iteration solve, 100k shape, '
                    't = 9, float32 operands, state in global memory '
                    '(cases: t = 1, 2, 5, 9, 16, ms_bf16 with bf16 operands; '
                    'runtime_t_cost: device ms of one 250-iteration solve '
                    'at the 100k shape); launches from [stencil-any-t]',
              routed=True)]
    for kname, line in (('se3_mul', '51'), ('se3_act', '68')):
        kernels.append(entry(
            kname, 'se3.cu', 'pypose_tpu/ops/pallas_se3.py:' + line,
            icp_counts[kname.upper() + '_LAUNCHES'], point[kname][0],
            point[kname][1], point[kname][2], se3_b[kname],
            device_ms=point[kname][3], plain_device_ms=point[kname][4],
            ms_of='per call over 50 calls, N=100,000 (device_ms: kernel '
                  'time alone, torch.profiler)', routed=False))
    # the wide scans (D > 8): launches from knn's main path at D = 33,
    # float32 (three-pass TF32) and float64 (DMMA) apart
    for kname, line, counter, dt, first in (
            ('nn1', '176', 'NN1_LAUNCHES', 'float32', 'fpfh'),
            ('nnk', '138', 'NNK_LAUNCHES', 'float32', 'fpfh'),
            ('nn1', '176', 'NN1_LAUNCHES', 'float64', 'fpfh-f64'),
            ('nnk', '138', 'NNK_LAUNCHES', 'float64', 'fpfh-f64')):
        cases = {tag: v for (n, tag), v in wide.items()
                 if n == kname and v['dtype'] == dt}
        fp = cases[first]
        kernels.append(entry(
            f'{kname}_wide' + ('_f64' if dt == 'float64' else ''), 'knn.cu',
            'pypose_tpu/ops/pallas_knn.py:' + line,
            wide_counts[dt][counter], max(v['err'] for v in cases.values()),
            fp['ms'], fp['plain_ms'], fp['bound'],
            library_ms=None if kname == 'nn1' else fp['cdist_ms'],
            library=None if kname == 'nn1' else
            'torch.cdist then torch.topk, per chunk of 64 Mi pairs',
            two_call_reference_ms=fp['cdist_ms'] if kname == 'nn1' else None,
            device_ms=fp['device_ms'],
            cases={tag: dict(shape=v['shape'], ms=v['ms'],
                             device_ms=v['device_ms'], plain_ms=v['plain_ms'],
                             cdist_ms=v['cdist_ms'], bound_ms=v['bound'][0],
                             bound_by=v['bound'][1], max_abs_err=v['err'])
                   for tag, v in cases.items()},
            ms_of=f'{fp["shape"]} (FPFH-like; on the tensor cores: '
                  f'{"DMMA" if dt == "float64" else "three-pass TF32"}); '
                  f'cases: every {dt} shape; launches from knn() on the '
                  f'D = 33 {dt} clouds', routed=True))
    # k > 16: one entry a scan family, and one for the select-then-sort
    # path (the register-tiled families' cases that took it); launches
    # from its first case's call through knn() (counted from zero)
    tiled = ('normals', 'outliers', 'fpfh-nbhd', 'range-100k', 'range',
             'full')
    scan = tuple(t for t in tiled if bigk[t]['route'] == 'scan')
    select = tuple(t for t in tiled if bigk[t]['route'] == 'select')
    wide = ('fpfh-33', 'fpfh-33-1024', 'sift-128', 'sift-128-1024',
            'fpfh-33-full', 'sift-gt')
    wide_scan = tuple(t for t in wide if bigk[t]['route'] == 'scan')
    wide_select = tuple(t for t in wide if bigk[t]['route'] == 'select')
    # the float64 wide family past k = 16 on DMMA: the merge scan at 32,
    # the select path at 1024 and k = N
    wide64 = ('fpfh-33-f64', 'fpfh-33-f64-1024', 'fpfh-33-f64-full')
    wide64_select = ('fpfh-33-f64-1024', 'fpfh-33-f64-full')
    check(select and scan and bigk['d6-f64']['route'] == 'scan'
          and bigk['d6-f64-1024']['route'] == 'select'
          and all(bigk[t]['kernels'] == 'tensor-core' for t in wide)
          and 'fpfh-33' in wide_scan and 'sift-128' in wide_scan
          and 'fpfh-33-1024' in wide_select
          and 'fpfh-33-full' in wide_select
          and all(bigk[t]['kernels'] == 'tensor-core-f64' for t in wide64)
          and bigk['fpfh-33-f64']['route'] == 'scan'
          and all(bigk[t]['route'] == 'select' for t in wide64_select),
          f'knn-bigk: paths '
          f'{({t: (v["route"], v["kernels"]) for t, v in bigk.items()})}')
    first_via_knn = [t for t in select if t not in BIGK_RANGE]
    for kname, line, first, tags in (
            ('nnk_select', '50', (first_via_knn or select)[0], select),
            ('nnk_select_f64', '50', 'd6-f64-1024', ('d6-f64-1024',)),
            ('nnk_warp_scan', '50', scan[0], scan),
            ('nnk_warp_scan_f64', '50', 'd6-f64', ('d6-f64',)),
            ('nnk_wide_bigk', '138', 'fpfh-33', wide_scan),
            ('nnk_wide_select', '138', 'fpfh-33-1024', wide_select),
            ('nnk_wide_bigk_f64', '138', 'fpfh-33-f64', ('fpfh-33-f64',)),
            ('nnk_wide_select_f64', '138', 'fpfh-33-f64-1024',
             wide64_select)):
        fc = bigk[first]
        kernels.append(entry(
            kname, 'knn.cu', 'pypose_tpu/ops/pallas_knn.py:' + line,
            fc['launches'], max(bigk[t]['err'] for t in tags), fc['ms'],
            fc['plain_ms'], fc['bound'], library_ms=fc['cdist_ms'],
            library='torch.cdist then torch.topk, per chunk of 64 Mi pairs',
            device_ms=fc['device_ms'], gram_ms=fc['gram_ms'],
            gram='function/geometry.py:_knn_gram, the route k > 16 took '
                 'before',
            cases={t: dict(family=bigk[t]['family'], shape=bigk[t]['shape'],
                           route=bigk[t]['route'],
                           scratch_bytes=bigk[t]['scratch_bytes'],
                           part_bytes=bigk[t]['part_bytes'],
                           ms=bigk[t]['ms'], device_ms=bigk[t]['device_ms'],
                           plain_ms=bigk[t]['plain_ms'],
                           gram_ms=bigk[t]['gram_ms'],
                           cdist_ms=bigk[t]['cdist_ms'],
                           bound_ms=bigk[t]['bound'][0],
                           bound_by=bigk[t]['bound'][1],
                           max_abs_err=bigk[t]['err'],
                           err_over_tol=bigk[t]['err_over_tol'],
                           plain_rows=bigk[t]['plain_rows'],
                           merge_ms=bigk[t]['merge_ms'],
                           bit_equal_to_merge=bigk[t]['bit_equal_to_merge'])
                   for t in tags},
            ms_of=f'{fc["shape"]} ({fc["family"]}, {fc["route"]} path; '
                  'L2 flushed); cases: every shape; launches from its call '
                  'through knn()',
            routed=True))
    for tag, numbers in sharded.items():
        print(f'[{tag}] {numbers}', flush=True)
    print(f'[pgo-100k] profiled run {pgo_prof}', flush=True)
    for tag, numbers in any_t.items():
        print(f'[stencil-any-t] {tag}: {numbers}', flush=True)
    for tag, numbers in general.items():
        print(f'[{tag}] {numbers}', flush=True)
    for name, numbers in groups.items():
        print(f'[{name.replace("_", "-")}] {numbers}', flush=True)
    print(f'[pgo-groups] {groups_loops}', flush=True)
    print(f'[sphere2500] closed form {sphere_ms}', flush=True)
    for tag, numbers in autodiff.items():
        print(f'[{tag}] {numbers}', flush=True)
    print(f'[reproj-pgo] {reproj}', flush=True)
    for tag, numbers in ba_cells.items():
        print(f'[{tag}] {numbers}', flush=True)
    for tag, numbers in newer.items():
        print(f'[{tag}] {numbers}', flush=True)
    print(f'[autograd] micro-jacrev {jacrev}; largest float64 error '
          f'{max(e[0] for e in autograd_errs.values()):.3e}, float32 '
          f'{max(e[1] for e in autograd_errs.values()):.3e}; autodiff J '
          f'blocks {blocks_err:.3e}', flush=True)
    routed_unlaunched = [k['name'] for k in kernels
                         if k.get('routed', True) and k['launches'] < 1]
    check(not routed_unlaunched,
          f'kernels on a path with no launch there: {routed_unlaunched}')
    print(f'[total] the script took {time.perf_counter() - t_script:.1f} s '
          '(PERF.md: 634.0 s on the H100 before the runtime-t stencil '
          'kernels)',
          flush=True)
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
