#!/usr/bin/env python3
"""Drive the PyTorch port's sphere2500 pose-graph path once on one NVIDIA
GPU and check it.

Phases (any failure raises, so the script exits non-zero):
  1. device: needs torch.cuda; prints nvidia-smi's name and power limit;
     turns TF32 off.
  2. build: compiles pypose_tpu_torch/csrc/stencil_cg.cu with nvcc (timed
     as set-up).
  3. kernel vs plain: the whole-solve CG kernel against its plain PyTorch
     version on the same random SPD stencil systems on the card, at N=40
     and at sphere2500's shape (N=2500, t=6, offsets (1, 157), node 0
     fixed, converged and run to a 150-iteration cap); both timed with
     CUDA events (median of 7).
  4. slice: data/synthetic_sphere2500_seed42.g2o through load_g2o,
     split_chain_edges, pgo_factor and two SparseLM.optimize phases
     (cg_iter 150 then 1200, cg_tol 1e-9), cold then warm; the final chi2
     must reach pypose's converged chi2 (data/ref_anchor_sphere2500.json)
     within 1e-4 relative, and the kernel must have been launched.
  5. prints the kernels' JSON line, the card line and the result line.

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


def kernel_vs_plain(name, N, loop_offset, n_loops, fixed, maxiter, tol):
    import torch
    from pypose_tpu_torch.ops import stencil_cg as scg
    from pypose_tpu_torch.testing import random_stencil_system
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(1234 + N)
    offsets, ops = random_stencil_system(N, loop_offset, n_loops, fixed, gen,
                                         dev)
    t = 6
    k_ms, (x_k, it_k) = cuda_ms(
        lambda: scg.stencil_cg_transposed(*ops, offsets, t, maxiter, tol))
    p_ms, (x_p, it_p) = cuda_ms(
        lambda: scg._cg_body_torch(ops[1], ops[2], ops[3], ops[0], offsets,
                                   t, maxiter, tol))
    it_k, it_p = int(it_k), int(it_p)
    err = float((x_k - x_p).abs().max())
    bound = 1e-4 * float(x_p.abs().max()) + 1e-5
    print(f'[kernel] {name}: N={N} offsets={offsets} fixed={fixed} '
          f'maxiter={maxiter} tol={tol:g}: iterations kernel {it_k} plain '
          f'{it_p}; max|x_k - x_p| {err:.3e} (bound {bound:.3e}); kernel '
          f'{k_ms:.4f} ms/solve ({1e3 * k_ms / max(it_k, 1):.2f} us/it), '
          f'plain {p_ms:.4f} ms/solve ({1e3 * p_ms / max(it_p, 1):.2f} '
          'us/it), median of 7', flush=True)
    check(bool(torch.isfinite(x_k).all()), f'{name}: kernel result not finite')
    check(err <= bound, f'{name}: kernel disagrees with the plain version')
    check(abs(it_k - it_p) <= 1, f'{name}: iteration counts differ')
    return err, k_ms, p_ms


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
    from pypose_tpu_torch.ops import stencil_cg as scg

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

    # the main path's launches: counted from zero over the cold run only
    scg.LAUNCHES = 0
    run('cold')
    launches = scg.LAUNCHES
    check(launches > 0, 'the slice never launched the stencil CG kernel')
    print(f'[slice] cold run launched the stencil CG kernel {launches} '
          'times', flush=True)
    run('warm')
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this script needs an NVIDIA GPU')
    from pypose_tpu_torch.ops import _build
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

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build('stencil_cg')
    scg._kernel_lib()
    print(f'[build] {lib_path.name} ready in {time.perf_counter() - t0:.2f} '
          's (set-up)', flush=True)
    log = lib_path.with_suffix('.log')
    if log.exists():
        for line in log.read_text().splitlines():
            if 'ptxas info' in line:
                print(f'[build] {line.strip()}', flush=True)

    # 3. kernel vs plain on the card
    err40, _, _ = kernel_vs_plain('N=40', 40, 9, 15, False, 500, 1e-6)
    err2500, _, _ = kernel_vs_plain('sphere2500 shape', 2500, 157, 2000,
                                    True, 500, 1e-6)
    # tol 0 runs the full 150 iterations, as the first phase's solves do
    err150, k_ms, p_ms = kernel_vs_plain('sphere2500 shape, 150 iterations',
                                         2500, 157, 2000, True, 150, 0.0)

    # 4. the slice
    first_step_agreement(dev)
    launches = sphere2500_slice(dev)

    # 5. results
    print(json.dumps({'kernels': [{
        'name': 'stencil_pcg',
        'route': 'cuda',
        'source': 'pypose_tpu_torch/csrc/stencil_cg.cu',
        'replaces': 'pypose_tpu/ops/pallas_cg.py:101',
        'launches': launches,
        'max_abs_err': max(err40, err2500, err150),
        'ms': k_ms,
        'plain_ms': p_ms,
    }]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
