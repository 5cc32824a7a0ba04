"""Bundle adjustment example (Schur-complement LM).

Counterpart of ``examples/bundle_adjustment.py`` (BAL problems, 20 LM
steps in the reference).  Runs on a BAL file if given, else a synthetic
ring-of-cameras problem.

    python -m pypose_tpu_torch.examples.bundle_adjustment [--bal FILE]
        [--steps 20] [--device cpu]
"""

import argparse
import time

import torch


def main():
    parser = argparse.ArgumentParser(description='Bundle Adjustment')
    parser.add_argument('--bal', type=str, default=None,
                        help='path to a BAL problem file')
    parser.add_argument('--cams', type=int, default=32)
    parser.add_argument('--points', type=int, default=2000)
    parser.add_argument('--steps', type=int, default=20)
    parser.add_argument('--huber', type=float, default=None)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cpu' to run on the CPU")
    args = parser.parse_args()

    from pypose_tpu_torch.datasets import load_bal, synthetic_bal
    from pypose_tpu_torch.optim.ba import BundleAdjustment
    from pypose_tpu_torch.optim.kernel import Huber

    if args.bal:
        ds = load_bal(args.bal, device=args.device)
    else:
        ds = synthetic_bal(n_cams=args.cams, n_points=args.points,
                           device=args.device)
    O = ds['pixels'].shape[0]
    print(f'cameras: {ds["poses"].lshape[0]}, points: '
          f'{ds["points"].shape[0]}, observations: {O}')

    kernel = Huber(delta=args.huber) if args.huber else None
    ba = BundleAdjustment(ds['poses'], ds['points'], ds['cam_idx'],
                          ds['pt_idx'], ds['pixels'], ds['cameras'],
                          kernel=kernel, fix_first_pose=True,
                          cg_iter=50, cg_tol=1e-6)
    t0 = time.time()
    for i in range(args.steps):
        loss = ba.step()
        print(f'step {i:2d}: chi2 {loss:.6e}  (rejects {ba.reject_count})')
        if ba.reject_count >= ba.reject:
            break
    print(f'done in {time.time()-t0:.2f}s; '
          f'mean reproj error {(loss / O) ** 0.5:.4f} px')


if __name__ == '__main__':
    main()
