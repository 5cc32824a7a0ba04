"""Pose-graph optimization example.

Counterpart of ``examples/pgo.py`` (parking-garage.g2o with LM +
TrustRegion in the reference).  Runs on a g2o file if given, else on the
synthetic sphere world; prints the solve's route and, where the instance
has ground truth, the aligned APE against it.

    python -m pypose_tpu_torch.examples.pgo [--g2o FILE] [--poses 2500]
        [--device cpu]
"""

import argparse
import time

import numpy as np
import torch


def main():
    parser = argparse.ArgumentParser(description='Pose Graph Optimization')
    parser.add_argument('--g2o', type=str, default=None,
                        help='path to a g2o file (VERTEX_SE3:QUAT)')
    parser.add_argument('--poses', type=int, default=2500)
    parser.add_argument('--steps', type=int, default=10)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cpu' to run on the CPU")
    parser.add_argument('--radius', type=float, default=1e4,
                        help='trust region radius')
    args = parser.parse_args()

    from pypose_tpu_torch.datasets import load_g2o, synthetic_sphere
    from pypose_tpu_torch.metric import ape
    from pypose_tpu_torch.optim.sparse import pgo
    from pypose_tpu_torch.optim.strategy import TrustRegion

    if args.g2o:
        ds = load_g2o(args.g2o, device=args.device)
    else:
        ds = synthetic_sphere(args.poses, device=args.device)
    print(f'poses: {ds["nodes"].lshape[0]}, edges: {ds["edges"].shape[0]}')

    t0 = time.time()
    nodes, hist = pgo(ds['nodes'], ds['edges'], ds['poses'],
                      infos=ds.get('infos'), steps=args.steps,
                      strategy=TrustRegion(radius=args.radius),
                      cg_iter=150, cg_tol=1e-6, verbose=True)
    if nodes.device.type == 'cuda':
        torch.cuda.synchronize()
    print(f'chi2: {hist[0]:.4e} -> {hist[-1]:.4e} in {time.time()-t0:.2f}s')

    if 'gt' in ds:
        stamps = np.arange(nodes.lshape[0], dtype=np.float64)
        result = ape(stamps, ds['gt'], stamps, nodes, etype='translation',
                     align=True, otype='RMSE')
        print(f'APE RMSE vs ground truth (aligned): {float(result):.4f}')


if __name__ == '__main__':
    main()
