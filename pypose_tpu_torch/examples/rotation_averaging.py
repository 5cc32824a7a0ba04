"""Rotation averaging (SO3 synchronization) and a Sim3 scale-drift pose
graph through the group-generic factor-graph stack.

Counterpart of ``examples/rotation_averaging.py``: ``pgo_factor`` takes
any group whose storage supports Inv, @ and Log, and SparseLM follows
the ltype (tangent size, retraction, CG).

    python -m pypose_tpu_torch.examples.rotation_averaging [--nodes 200]
        [--device cpu]
"""

import argparse
import time

import numpy as np
import torch


def solve_graph(name, truth, noisy, edges, steps):
    from pypose_tpu_torch.optim.sparse import SparseLM, pgo_factor
    from pypose_tpu_torch.optim.strategy import TrustRegion

    N = truth.lshape[0]
    dev = truth.device
    Z = truth[edges[:, 0]].Inv() @ truth[edges[:, 1]]
    fixed = torch.zeros(N, dtype=torch.bool, device=dev)
    fixed[0] = True
    opt = SparseLM({'x': noisy}, [pgo_factor(edges, Z, name='x')],
                   strategy=TrustRegion(radius=1e4), fixed={'x': fixed},
                   cg_iter=100, cg_tol=1e-10)
    t0 = time.perf_counter()
    final = opt.optimize(steps=steps, decreasing=1e-10, patience=3)
    X = opt.params['x']
    G = X[0] @ truth[0].Inv()          # the global left gauge
    err = ((G.Inv() @ X).Inv() @ truth).Log().tensor()
    print(f'[{name}] chi2 {opt.history[0]:.3e} -> {final:.3e} in '
          f'{len(opt.history)} LM steps ({time.perf_counter()-t0:.2f}s); '
          f'max tangent error vs truth {float(err.abs().max()):.2e}')
    return final


def main():
    parser = argparse.ArgumentParser(
        description='SO3 rotation averaging + Sim3 pose graph')
    parser.add_argument('--nodes', type=int, default=200)
    parser.add_argument('--steps', type=int, default=10)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cpu' to run on the CPU")
    args = parser.parse_args()
    dev = torch.device(args.device)

    import pypose_tpu_torch as pp

    N = args.nodes
    ii = np.arange(N - 1)
    rng = np.random.default_rng(0)
    loops = rng.integers(0, N, size=(max(N // 10, 2), 2))
    loops = loops[loops[:, 0] != loops[:, 1]]
    edges = torch.as_tensor(np.concatenate(
        [np.stack([ii, ii + 1], 1), [[N - 1, 0]], loops], 0),
        dtype=torch.int64, device=dev)

    gen = torch.Generator().manual_seed(0)
    # SO3: multi-view rotation synchronization
    truth = pp.randn_SO3(N, generator=gen, device=dev)
    noisy = truth @ pp.randn_SO3(N, sigma=0.1, generator=gen, device=dev)
    solve_graph('so3-averaging', truth, noisy, edges, args.steps)

    # Sim3: monocular-SLAM style scale-drift correction
    truth = pp.randn_Sim3(N, sigma=(0.3, 0.2, 0.1), generator=gen,
                          device=dev)
    noisy = truth @ pp.randn_Sim3(N, sigma=(0.1, 0.05, 0.05), generator=gen,
                                  device=dev)
    solve_graph('sim3-pgo', truth, noisy, edges, args.steps)


if __name__ == '__main__':
    main()
