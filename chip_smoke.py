#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU and check them:
sphere2500 through the whole-solve CG kernel, a 100k-pose graph through
the tiled CG kernels, and ICP on 100k-point clouds through the
nearest-neighbour kernel.

Phases (any failure raises, so the script exits non-zero):
  1. device: needs torch.cuda; prints nvidia-smi's name and power limit;
     turns TF32 off.
  2. build: compiles pypose_tpu_torch/csrc/stencil_cg{,_tiled,_fused}.cu,
     knn.cu and se3.cu, one nvcc each, all at once (timed as set-up);
     prints ptxas' registers and shared memory.
  3. kernel vs plain, on the same random SPD stencil systems on the card,
     each timed with CUDA events (median of 7):
     - the whole-solve kernel at N=40 and at sphere2500's shape (N=2500,
       offsets (1, 157), node 0 fixed; converged, and to a 150-iteration
       cap);
     - the tiled and the fused solvers at N=53 (offsets wrap) and at the
       100k shape (offsets (1, 993), node 0 fixed) with tol 1e-3 /
       maxiter 250 and with tol 0 / 250 iterations, fused beside tiled;
     - the tiled matvec and block-Jacobi kernels alone, one launch each,
       at the 100k shape;
     - nn1 at 100k x 100k on ICP's clouds, and nnk at k = 4 and 16 on a
       20k x 100k slice of them: indices equal on >= 99.99% of rows, d^2
       within 1e-6 (|a|^2 + |b|^2) + 1e-6 everywhere;
     - se3_mul/se3_act at N = 100,000 and 100,003, within
       1e-6 (1 + max|input|); timed per call over 50 calls and, with
       torch.profiler, by the device time of their kernels.
  4. sphere2500 slice: data/synthetic_sphere2500_seed42.g2o through
     load_g2o, split_chain_edges, pgo_factor and two SparseLM.optimize
     phases (cg_iter 150 then 1200, cg_tol 1e-9), cold then warm; the
     final chi2 must reach pypose's converged chi2
     (data/ref_anchor_sphere2500.json) within 1e-4 relative, and the
     whole-solve kernel must have been launched.
  5. pgo-100k slice: synthetic_sphere(100000, seed=42) (checked against
     data/jax_anchor_pgo100k_seed42.json's instance checksum), factors as
     bench.py:bench_pgo_100k builds them, SparseLM with TrustRegion(1e4),
     cg_iter 250, cg_tol 1e-3, optimize(steps=6), cold then warm; the
     final chi2 must be within 1e-3 relative of the JAX package's on the
     same instance, the tiled kernels must have been launched and the
     whole-solve kernel not.
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
  8. prints the kernels' JSON line, the card line and the result line.

Run from the repository root:  python3 chip_smoke.py
"""

import json
import statistics
import subprocess
import sys
import time


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


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


def device_ms(fn, calls=50):
    """Device time per call of ``fn`` in ms: the sum of the kernels'
    times that torch.profiler records over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.key_averages()
                   if not e.key.startswith('aten::'))
    check(total_us > 0, 'torch.profiler recorded no device time')
    return total_us / calls / 1e3


def stencil_system(N, loop_offset, n_loops, fixed):
    import torch
    from pypose_tpu_torch.testing import random_stencil_system
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(1234 + N)
    return random_stencil_system(N, loop_offset, n_loops, fixed, gen, dev)


def solver_vs_plain(name, solver, plain, system, maxiter, tol):
    """One solver on the card against its plain version on the same
    operands: x within 1e-4 of max|x| (+1e-5), iterations within one.
    Returns (max error, kernel ms, plain ms, kernel iterations)."""
    import torch
    offsets, ops = system
    t = 6
    N = ops[0].shape[1]
    k_ms, (x_k, it_k) = cuda_ms(
        lambda: solver(*ops, offsets, t, maxiter, tol))
    p_ms, (x_p, it_p) = cuda_ms(
        lambda: plain(ops[1], ops[2], ops[3], ops[0], offsets, t, maxiter,
                      tol))
    it_k, it_p = int(it_k), int(it_p)
    err = float((x_k - x_p).abs().max())
    bound = 1e-4 * float(x_p.abs().max()) + 1e-5
    print(f'[kernel] {name}: N={N} offsets={offsets} maxiter={maxiter} '
          f'tol={tol:g}: iterations kernel {it_k} plain {it_p}; '
          f'max|x_k - x_p| {err:.3e} (bound {bound:.3e}); kernel '
          f'{k_ms:.4f} ms/solve ({1e3 * k_ms / max(it_k, 1):.2f} us/it), '
          f'plain {p_ms:.4f} ms/solve ({1e3 * p_ms / max(it_p, 1):.2f} '
          'us/it), median of 7', flush=True)
    check(bool(torch.isfinite(x_k).all()), f'{name}: kernel result not finite')
    check(err <= bound, f'{name}: kernel disagrees with the plain version')
    check(abs(it_k - it_p) <= 1, f'{name}: iteration counts differ')
    return err, k_ms, p_ms, it_k


def whole_solve_vs_plain(name, N, loop_offset, n_loops, fixed, maxiter,
                         tol):
    from pypose_tpu_torch.ops import stencil_cg as scg
    err, k_ms, p_ms, _ = solver_vs_plain(
        f'whole-solve, {name}', scg.stencil_cg_transposed,
        scg._cg_body_torch,
        stencil_system(N, loop_offset, n_loops, fixed), maxiter, tol)
    return err, k_ms, p_ms


def oversize_solvers_vs_plain(name, system, maxiter, tol):
    """The tiled and the fused solver on one system, each against its
    plain version; returns {route: (err, ms, plain ms, iterations)}."""
    from pypose_tpu_torch.ops import stencil_cg as scg
    out = {
        'tiled': solver_vs_plain(f'tiled, {name}', scg.stencil_cg_tiled,
                                 scg._tiled_cg_torch, system, maxiter, tol),
        'fused': solver_vs_plain(f'fused, {name}', scg.stencil_cg_fused,
                                 scg._fused_cg_torch, system, maxiter, tol)}
    (_, t_ms, _, t_it), (_, f_ms, _, f_it) = out['tiled'], out['fused']
    print(f'[kernel] {name}: fused {f_ms:.4f} ms/solve ({f_it} it, '
          f'{1e3 * f_ms / max(f_it, 1):.2f} us/it) vs tiled {t_ms:.4f} '
          f'ms/solve ({t_it} it, {1e3 * t_ms / max(t_it, 1):.2f} us/it): '
          f'fused/tiled {f_ms / t_ms:.3f}', flush=True)
    return out


def tiled_kernels_vs_plain(system, launches=20):
    """The tiled matvec and block-Jacobi kernels alone, one launch each on
    a random vector, against their plain versions; times are per launch
    (CUDA events over ``launches`` launches, median of 7).  Returns
    {kernel: (err, us, plain us)}."""
    import torch
    from pypose_tpu_torch.ops import stencil_cg as scg
    offsets, (b_T, A_T, Minv_T, C_T) = system
    t = 6
    gen = torch.Generator(device=b_T.device).manual_seed(7)
    v = torch.randn(b_T.shape, generator=gen, device=b_T.device)
    pairs = {
        'mv': (lambda: scg._tiled_mv_launch(A_T, C_T, v, offsets, t),
               lambda: scg._stencil_matvec_torch(A_T, C_T, offsets, t, v),
               4 * (t * t * (1 + len(offsets)) + 2 * t)),
        'pc': (lambda: scg._tiled_pc_launch(Minv_T, v, t),
               lambda: scg._block_mul(Minv_T, v, t),
               4 * (t * t + 2 * t))}
    out = {}
    for kname, (kern, plain, bytes_per_node) in pairs.items():
        k_ms, y_k = cuda_ms(lambda: [kern() for _ in range(launches)][-1])
        p_ms, y_p = cuda_ms(lambda: [plain() for _ in range(launches)][-1])
        err = float((y_k - y_p).abs().max())
        bound = 1e-5 * float(y_p.abs().max()) + 1e-6
        k_us, p_us = 1e3 * k_ms / launches, 1e3 * p_ms / launches
        gbs = bytes_per_node * v.shape[1] / (k_us * 1e3)
        print(f'[kernel] tiled {kname} alone, N={v.shape[1]}: max|y_k - '
              f'y_p| {err:.3e} (bound {bound:.3e}); kernel {k_us:.2f} '
              f'us/launch ({gbs:.0f} GB/s if every operand and vector '
              f'byte is read or written once: {bytes_per_node} B/node), '
              f'plain {p_us:.2f} us', flush=True)
        check(err <= bound, f'tiled {kname} disagrees with its plain version')
        out[kname] = (err, k_us, p_us)
    return out


# each kernel module's launch counters
COUNTERS = {
    'stencil_cg': ('LAUNCHES', 'TILED_MV_LAUNCHES', 'TILED_PC_LAUNCHES',
                   'FUSED_AXPY_LAUNCHES', 'FUSED_MV_LAUNCHES'),
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
          f'{opt._stencil_all.offsets}, precond {opt.precond}', flush=True)

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
              f'{opt.cg_iterations + opt2.cg_iterations}', flush=True)
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

    # the path's launches: counted from zero over the cold run only
    reset_counts()
    run('cold')
    counts = read_counts()
    check(counts['LAUNCHES'] > 0,
          'the slice never launched the whole-solve CG kernel')
    print(f'[slice] cold run launched the whole-solve CG kernel '
          f'{counts["LAUNCHES"]} times; all counts {counts}', flush=True)
    run('warm')
    return counts


def pgo100k_slice(dev):
    """The large pose graph, cold then warm, against the JAX anchor on the
    same instance; returns the cold run's launch counts."""
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
          f'edges, offsets {offsets}, precond {opt.precond}; instance '
          f'checksum {got}', flush=True)
    check(not stencil_cg_fits(N, 6, len(offsets)),
          'pgo-100k fits the whole-solve budget: it would not test the '
          'tiled route')

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

    reset_counts()
    run('cold')
    counts = read_counts()
    check(counts['TILED_MV_LAUNCHES'] > 0 and counts['TILED_PC_LAUNCHES'] > 0,
          'the pgo-100k slice never launched the tiled CG kernels')
    check(counts['LAUNCHES'] == 0,
          'the pgo-100k slice launched the whole-solve kernel')
    print(f'[pgo-100k] cold run launch counts {counts}', flush=True)
    run('warm')
    return counts


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


def knn_vs_plain(name, kernel, plain, ref, nbr):
    """A knn kernel against its plain version on the same clouds: indices
    equal on >= 99.99% of rows, and d^2 (each row's k values, ascending)
    within 1e-6 (|a|^2 + |b|^2) + 1e-6 of the plain version's everywhere,
    so also on rows whose neighbours differ.  Returns (max|d2 error|,
    kernel ms, plain ms)."""
    import torch
    k_ms, (d_k, i_k) = cuda_ms(kernel)
    p_ms, (d_p, i_p) = cuda_ms(plain)
    d_k, i_k = d_k.reshape(len(ref), -1), i_k.reshape(len(ref), -1)
    d_p, i_p = d_p.reshape(len(ref), -1), i_p.reshape(len(ref), -1)
    an = (ref * ref).sum(-1, keepdim=True)
    bn = (nbr * nbr).sum(-1)[i_p]
    bound = 1e-6 * (an + bn) + 1e-6
    err = float((d_k - d_p).abs().max())
    same_rows = float((i_k == i_p).all(-1).double().mean())
    bitwise = bool(torch.equal(d_k, d_p) and torch.equal(i_k, i_p))
    print(f'[kernel] {name}: {tuple(ref.shape)} x {tuple(nbr.shape)}, k='
          f'{d_k.shape[1]}: rows with equal indices {same_rows:.6f}; '
          f'max|d2_k - d2_p| {err:.3e} (bound >= {float(bound.min()):.3e}); '
          f'bitwise equal {bitwise}; kernel {k_ms:.4f} ms, plain '
          f'{p_ms:.4f} ms, median of 7', flush=True)
    check(bool(torch.isfinite(d_k).all()), f'{name}: d2 not finite')
    check(same_rows >= 0.9999, f'{name}: indices differ on more than 0.01% '
          'of rows')
    check(bool(((d_k - d_p).abs() <= bound).all()),
          f'{name}: d2 outside the bound')
    return err, k_ms, p_ms


def point_kernels_vs_plain(dev):
    """nn1, nnk and the SE3 kernels against their plain versions at the
    ICP slice's shapes; returns {kernel: (err, ms, plain ms)}, the SE3
    entries with the device ms of kernel and plain version appended."""
    import torch
    import pypose_tpu_torch as ppt
    from pypose_tpu_torch.lietensor import operation as op
    from pypose_tpu_torch.ops import knn as K, se3 as S
    src, _, tgt = icp_instance(100_000, dev)
    out = {'nn1': knn_vs_plain('nn1, ICP clouds', lambda: K.nn1(src, tgt),
                               lambda: K._nn1_torch(src, tgt), src, tgt)}
    ref = src[:20_000].contiguous()
    for k in (4, 16):
        out[f'nnk{k}'] = knn_vs_plain(
            'nnk, ICP clouds', lambda: K.nnk(ref, tgt, k),
            lambda: K._nnk_torch(ref, tgt, k), ref, tgt)
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
        if log.exists():
            for line in log.read_text().splitlines():
                if 'Used' in line or 'Compiling entry' in line:
                    print(f'[build] {path.stem}: {line.strip()}', flush=True)

    # 3. kernels vs plain versions on the card
    err40, _, _ = whole_solve_vs_plain('N=40', 40, 9, 15, False, 500, 1e-6)
    err2500, _, _ = whole_solve_vs_plain('sphere2500 shape', 2500, 157,
                                         2000, True, 500, 1e-6)
    # tol 0 runs the full 150 iterations, as the first phase's solves do
    err150, k_ms, p_ms = whole_solve_vs_plain(
        'sphere2500 shape, 150 iterations', 2500, 157, 2000, True, 150, 0.0)
    small = oversize_solvers_vs_plain('N=53', stencil_system(53, 9, 15, False),
                                      200, 1e-7)
    big_system = stencil_system(100_000, 993, 80_000, True)
    big = oversize_solvers_vs_plain('100k shape, tol 1e-3', big_system, 250,
                                    1e-3)
    full = oversize_solvers_vs_plain('100k shape, 250 iterations',
                                     big_system, 250, 0.0)
    alone = tiled_kernels_vs_plain(big_system)
    del big_system
    point = point_kernels_vs_plain(dev)

    # 4., 5. and 7. the paths, each counted from zero over its cold run
    first_step_agreement(dev)
    sphere_counts = sphere2500_slice(dev)
    pgo_counts = pgo100k_slice(dev)
    icp_card_vs_cpu(dev)
    icp_counts = icp_slice(dev)

    # 8. results
    def route_err(route):
        return max(r[route][0] for r in (small, big, full))

    src = 'pypose_tpu_torch/csrc/'
    pallas = 'pypose_tpu/ops/pallas_cg.py:'
    kernels = [
        dict(name='stencil_pcg', route='cuda', source=src + 'stencil_cg.cu',
             replaces=pallas + '101', launches=sphere_counts['LAUNCHES'],
             max_abs_err=max(err40, err2500, err150), ms=k_ms, plain_ms=p_ms,
             ms_of='one 150-iteration solve, sphere2500 shape'),
        dict(name='stencil_tiled_mv', route='cuda',
             source=src + 'stencil_cg_tiled.cu', replaces=pallas + '131',
             launches=pgo_counts['TILED_MV_LAUNCHES'],
             max_abs_err=max(alone['mv'][0], route_err('tiled')),
             ms=alone['mv'][1] / 1e3, plain_ms=alone['mv'][2] / 1e3,
             ms_of='one launch, 100k shape'),
        dict(name='stencil_tiled_pc', route='cuda',
             source=src + 'stencil_cg_tiled.cu', replaces=pallas + '149',
             launches=pgo_counts['TILED_PC_LAUNCHES'],
             max_abs_err=max(alone['pc'][0], route_err('tiled')),
             ms=alone['pc'][1] / 1e3, plain_ms=alone['pc'][2] / 1e3,
             ms_of='one launch, 100k shape')]
    for kname, line, counter in (('axpy', '253', 'FUSED_AXPY_LAUNCHES'),
                                 ('mv', '290', 'FUSED_MV_LAUNCHES')):
        kernels.append(dict(
            name=f'stencil_fused_{kname}', route='cuda',
            source=src + 'stencil_cg_fused.cu', replaces=pallas + line,
            launches=pgo_counts[counter], max_abs_err=route_err('fused'),
            ms=full['fused'][1], plain_ms=full['fused'][2],
            ms_of='one 250-iteration fused solve (both passes), 100k shape',
            routed=False))
    knn_src, se3_src = src + 'knn.cu', src + 'se3.cu'
    kernels += [
        dict(name='nn1', route='cuda', source=knn_src,
             replaces='pypose_tpu/ops/pallas_knn.py:22',
             launches=icp_counts['NN1_LAUNCHES'],
             max_abs_err=point['nn1'][0], ms=point['nn1'][1],
             plain_ms=point['nn1'][2], ms_of='100k x 100k, ICP clouds'),
        dict(name='nnk', route='cuda', source=knn_src,
             replaces='pypose_tpu/ops/pallas_knn.py:50',
             launches=icp_counts['NNK_LAUNCHES'],
             max_abs_err=max(point['nnk4'][0], point['nnk16'][0]),
             ms=point['nnk16'][1], plain_ms=point['nnk16'][2],
             ms_k4=point['nnk4'][1], plain_ms_k4=point['nnk4'][2],
             ms_of='k=16 (ms_k4: k=4), 20k x 100k slice of the ICP clouds',
             routed=False)]
    for kname, line in (('se3_mul', '51'), ('se3_act', '68')):
        kernels.append(dict(
            name=kname, route='cuda', source=se3_src,
            replaces='pypose_tpu/ops/pallas_se3.py:' + line,
            launches=icp_counts[kname.upper() + '_LAUNCHES'],
            max_abs_err=point[kname][0], ms=point[kname][1],
            plain_ms=point[kname][2], device_ms=point[kname][3],
            plain_device_ms=point[kname][4],
            ms_of='per call over 50 calls, N=100,000 (device_ms: kernel '
                  'time alone, torch.profiler)', routed=False))
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
