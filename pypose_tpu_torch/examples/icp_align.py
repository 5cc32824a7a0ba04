"""ICP point-cloud alignment example.

Counterpart of ``examples/icp_align.py`` (the reference's ICP example).

    python -m pypose_tpu_torch.examples.icp_align [--points 500]
        [--device cpu]
"""

import argparse
import math

import torch


def main():
    parser = argparse.ArgumentParser(description='ICP alignment')
    parser.add_argument('--points', type=int, default=500)
    parser.add_argument('--noise', type=float, default=0.005)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cpu' to run on the CPU")
    args = parser.parse_args()

    import pypose_tpu_torch as pp
    from pypose_tpu_torch.module import ICP
    from pypose_tpu_torch.utils import ReduceToBason

    gen = torch.Generator().manual_seed(0)
    # a synthetic "scan": a ring with noise
    t = torch.linspace(0, 2 * math.pi, args.points)
    source = torch.stack([torch.cos(t), torch.sin(t), 0.1 * torch.sin(5 * t)],
                         -1)
    source = source + args.noise * torch.randn(source.shape, generator=gen)
    source = source.to(args.device)

    T_true = pp.randn_SE3(sigma=(0.4, 0.2), generator=gen,
                          device=args.device)
    target = T_true.Act(source)

    icp = ICP(stepper=ReduceToBason(steps=150, patience=8, tol=1e-9,
                                    verbose=False))
    T_est = icp(source, target)
    err = (T_est.Inv() @ T_true).Log().tensor()
    print('true  :', T_true.tensor().cpu().numpy())
    print('est   :', T_est.tensor().cpu().numpy())
    print('tangent error:', float(err.abs().max()))


if __name__ == '__main__':
    main()
