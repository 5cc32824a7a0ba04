"""Spline interpolation example: cubic Hermite on R^3 and the SE3 B-spline.

Counterpart of ``examples/splines.py`` (the reference's spline example).

    python -m pypose_tpu_torch.examples.splines [--interval 0.2]
        [--device cpu]
"""

import argparse

import torch


def main():
    parser = argparse.ArgumentParser(description='Splines')
    parser.add_argument('--interval', type=float, default=0.2)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cpu' to run on the CPU")
    args = parser.parse_args()

    import pypose_tpu_torch as pp

    gen = torch.Generator().manual_seed(0)
    # cubic Hermite on R^3
    knots = torch.randn(6, 3, generator=gen).to(args.device)
    curve = pp.chspline(knots, interval=args.interval)
    print('chspline:', tuple(knots.shape), '->', tuple(curve.shape))
    k = int(1 / args.interval)
    print('  knot residual:', float((curve[::k] - knots).abs().max()))

    # SE3 B-spline over control poses
    poses = pp.randn_SE3(8, sigma=(0.5, 0.2), generator=gen,
                         device=args.device)
    traj = pp.bspline(poses, interval=args.interval)
    print('bspline:', tuple(poses.lshape), '->', tuple(traj.lshape))
    step = (traj[:-1].Inv() @ traj[1:]).Log().tensor()
    print('  max inter-pose tangent step:', float(step.abs().max()))

    # the extrapolated variant covers the full range
    traj2 = pp.bspline(poses, interval=args.interval, extrapolate=True)
    print('bspline extrapolate:', tuple(traj2.lshape))


if __name__ == '__main__':
    main()
