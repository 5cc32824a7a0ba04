#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU and check them:
sphere2500 through the whole-solve CG kernel, a 100k-pose graph through
the fused (Chronopoulos-Gear) CG kernel, the same two graphs over SO3,
RxSO3 and Sim3 through those kernels' t = 3, 4 and 7 instantiations, ICP
on 100k-point clouds through the nearest-neighbour kernel, knn(k=8) on
those clouds through the k-nearest kernel, knn on 6-coordinate clouds, and
the general factor-graph routes (no kernel): a chain-dominated and three
random-loop pose graphs, and the inputs the stencil kernels do not take;
then the Lie core's autograd and the paths it opens: Jacobians by
autodiff and robust kernels in SparseLM through the whole-solve kernel,
and the reprojection pose graph; then bundle adjustment in both Schur
modes (no kernel on its path).

Phases (any failure raises, so the script exits non-zero):
  1. device: needs torch.cuda; prints nvidia-smi's name and power limit;
     turns TF32 off.
  2. build: compiles pypose_tpu_torch/csrc/stencil_cg{,_tiled,_fused}.cu,
     knn.cu and se3.cu, one nvcc each, all at once (timed as set-up);
     prints ptxas' registers and shared memory (knn.cu: for D = 3 and 8).
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
       block-Jacobi apply also as one torch.einsum;
     - the same three sources at block sizes t = 3, 4 and 7 (SO3, RxSO3,
       Sim3): the whole solve at N=40 and at sphere2500's shape
       (converged and to 60 iterations, two launches bit-equal), the
       tiled and fused (float32, bf16) solvers at N=53 and at the 100k
       shape (tol 1e-3 and 60 iterations; the fused plan printed:
       shared-memory mode at t = 3 and 4, global-memory mode at t = 7),
       the tiled kernels alone; t = 5 must raise;
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
     ('einsum', no kernel), card against CPU.
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
 22. prints the kernels' JSON line (each kernel's, and each of the t = 3,
     4, 7 instantiations', launches on its path,
     error, ms, plain ms, bound_ms from this run's shapes and iteration
     counts at 3.35 TB/s and 67 TFLOP/s float32, bound_by, library_ms;
     nn1 and nnk also at D = 6, bound at 2 D flop a pair, in float32 and
     in float64 at 34 TFLOP/s; the whole solve's launches on each
     sphere2500 path, launches_by_path), the card line and the result
     line.

Run from the repository root:  python3 chip_smoke.py
"""

import json
import statistics
import subprocess
import sys
import time


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
    # trace of 50 launches of a 2 us kernel, the 13th trace of its run):
    # trace again, up to three times, before failing
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.device_time_total for e in prof.key_averages()
                       if not e.key.startswith('aten::')
                       and (match is None or match in e.key))
        if total_us > 0:
            return total_us / calls / 1e3
    raise RuntimeError('torch.profiler recorded no device time in three '
                       'traces')


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
    Each kernel's device time per launch comes from torch.profiler.
    Returns {kernel: (err, us, plain us, library us or None, device
    us)}."""
    import torch
    from pypose_tpu_torch.ops import stencil_cg as scg
    offsets, (b_T, A_T, Minv_T, C_T) = system
    t = b_T.shape[0]
    gen = torch.Generator(device=b_T.device).manual_seed(7)
    v = torch.randn(b_T.shape, generator=gen, device=b_T.device)
    M3 = Minv_T.view(t, t, -1)
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
        gbs = bytes_per_node * v.shape[1] / (d_us * 1e3)
        print(f'[kernel] tiled {kname} alone, t={t} N={v.shape[1]}: '
              f'max|y_k - y_p| {err:.3e} (bound {bound:.3e}); kernel {k_us:.2f} '
              f'us/launch, device time {d_us:.2f} us/launch ({gbs:.0f} GB/s '
              f'if every operand and vector '
              f'byte is read or written once: {bytes_per_node} B/node), '
              f'plain {p_us:.2f} us, one library call '
              f'{"none" if l_us is None else f"{l_us:.2f} us"}', flush=True)
        check(err <= bound, f'tiled {kname} disagrees with its plain version')
        out[kname] = (err, k_us, p_us, l_us, d_us)
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
    returns (initial poses, make_optimizer(cg_iter, cg_tol))."""
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

    def mk(cg_iter, cg_tol):
        return SparseLM({'poses': ds['nodes']}, factors,
                        strategy=TrustRegion(radius=1e4),
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


def profiled_run(run):
    """``run('profiled')`` -> (ms, steps) under torch.profiler: (ms,
    steps, device ms, device operations), the operations being the
    kernels, copies and sets the profiler saw."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ms, steps = run('profiled')
    ops = [e for e in prof.key_averages() if not e.key.startswith('aten::')]
    return (ms, steps, sum(e.device_time_total for e in ops) / 1e3,
            sum(e.count for e in ops))


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
    calls; chi2 within 1e-4; route 'stencil': t = 3 is a block size the
    kernels are built for, so on the card one whole-solve launch a solve)
    and the same ring at t = 5 (route 'einsum', no kernel)."""
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
            ('ring t=5 float32', ring(5), 3, 1e-4, 'einsum')):
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
                   device_ops_per_step=sum(e.count for e in kernels) / steps)
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


BLOCK_SIZE_CAP = 60


def block_size_kernels(t):
    """The whole-solve, tiled and fused kernels' instantiation for block
    size t against their plain versions, as t = 6 is held: N = 53 (40 for
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


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this script needs an NVIDIA GPU')
    from pypose_tpu_torch.ops import _build, knn, se3
    from pypose_tpu_torch.ops import stencil_cg as scg
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
            # and D = 8 only
            elif 'Used' in line and (path.stem != 'libknn' or any(
                    f'I{t}Li{d}E' in entry for t in 'fd' for d in (3, 8))):
                print(f'[build] {path.stem}: {entry}\n[build] {path.stem}: '
                      f'{spill}; {line.strip()}', flush=True)

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
    # the same kernels' instantiations for the other groups' block sizes
    by_t = {t: block_size_kernels(t) for t in (3, 4, 7)}
    check(by_t[3]['plan']['smem'] and by_t[4]['plan']['smem']
          and not by_t[7]['plan']['smem'],
          'the fused plan at the 100k shape: shared-memory mode expected at '
          't = 3 and 4 (27 and 40 floats a node), global-memory mode at '
          't = 7 (91 floats a node, 758 nodes a CTA)')
    for solver in (scg.stencil_cg_transposed, scg.stencil_cg_tiled,
                   scg.stencil_cg_fused):
        offsets5, ops5 = stencil_system(40, 9, 15, False, 5)
        try:
            solver(*ops5, offsets5, 5, 5, 1e-6)
        except ValueError as e:
            print(f'[kernel] {solver.__name__} at t=5 raises: {e}',
                  flush=True)
        else:
            raise RuntimeError(f'{solver.__name__} took t=5 on the card')
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
    sparse_f64_phase(dev)
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
    # the same in float64, its operations at 34 TFLOP/s (NVIDIA's H100 SXM
    # data sheet, float64 outside the tensor cores)
    nn1_d6_b64 = bound(8 * 2 * d6_n * 6 + 16 * d6_n, 12 * d6_n * d6_n, 34e12)
    nnk_d6_b64 = bound(8 * 2 * d6_n * 6 + 16 * d6_n * 8, 12 * d6_n * d6_n,
                       34e12)
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
                     if k.startswith('sphere2500')}}),
        entry('stencil_tiled_mv', 'stencil_cg_tiled.cu', pallas + '131',
              pgo_counts['TILED_MV_LAUNCHES'],
              max(alone['mv'][0], route_err('tiled')), alone['mv'][1] / 1e3,
              alone['mv'][2] / 1e3, mv_b, device_ms=alone['mv'][4] / 1e3,
              ms_of='one launch, 100k shape (device_ms: torch.profiler)',
              routed=False),
        entry('stencil_tiled_pc', 'stencil_cg_tiled.cu', pallas + '149',
              pgo_counts['TILED_PC_LAUNCHES'],
              max(alone['pc'][0], route_err('tiled')), alone['pc'][1] / 1e3,
              alone['pc'][2] / 1e3, pc_b, library_ms=alone['pc'][3] / 1e3,
              library='torch.einsum over the [t, t, N] blocks',
              device_ms=alone['pc'][4] / 1e3,
              ms_of='one launch, 100k shape (device_ms: torch.profiler)',
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
                  block_size=t, routed=False,
                  ms_of='one launch, 100k shape (device_ms: '
                        'torch.profiler)'),
            entry(f'stencil_tiled_pc_t{t}', 'stencil_cg_tiled.cu',
                  pallas + '149', 0,
                  max(r['alone']['pc'][0], r['err']['tiled']),
                  r['alone']['pc'][1] / 1e3, r['alone']['pc'][2] / 1e3,
                  pc_bound(t), library_ms=r['alone']['pc'][3] / 1e3,
                  library='torch.einsum over the [t, t, N] blocks',
                  device_ms=r['alone']['pc'][4] / 1e3, block_size=t,
                  routed=False,
                  ms_of='one launch, 100k shape (device_ms: '
                        'torch.profiler)'),
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
    for kname, line in (('se3_mul', '51'), ('se3_act', '68')):
        kernels.append(entry(
            kname, 'se3.cu', 'pypose_tpu/ops/pallas_se3.py:' + line,
            icp_counts[kname.upper() + '_LAUNCHES'], point[kname][0],
            point[kname][1], point[kname][2], se3_b[kname],
            device_ms=point[kname][3], plain_device_ms=point[kname][4],
            ms_of='per call over 50 calls, N=100,000 (device_ms: kernel '
                  'time alone, torch.profiler)', routed=False))
    print(f'[pgo-100k] profiled run {pgo_prof}', flush=True)
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
    print(f'[autograd] micro-jacrev {jacrev}; largest float64 error '
          f'{max(e[0] for e in autograd_errs.values()):.3e}, float32 '
          f'{max(e[1] for e in autograd_errs.values()):.3e}; autodiff J '
          f'blocks {blocks_err:.3e}', flush=True)
    routed_unlaunched = [k['name'] for k in kernels
                         if k.get('routed', True) and k['launches'] < 1]
    check(not routed_unlaunched,
          f'kernels on a path with no launch there: {routed_unlaunched}')
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
