"""Reprojection-constrained pose graph: odometry factors and landmark
observation factors in one factor graph.

Counterpart of ``examples/reproj_pgo.py`` (the reference's reprojpgo
workload): SE3 poses and R^3 landmarks optimized jointly through the
general ``Factor`` API.  The instance is
``testing.reproj_pgo_instance`` (numpy-drawn: a circle of poses, 6
observed landmarks a pose).

    python -m pypose_tpu_torch.examples.reproj_pgo [--device cpu]
"""

import argparse

import torch


def main():
    parser = argparse.ArgumentParser(description='Reprojection PGO')
    parser.add_argument('--poses', type=int, default=40)
    parser.add_argument('--landmarks', type=int, default=120)
    parser.add_argument('--steps', type=int, default=12)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cpu' to run on the CPU")
    args = parser.parse_args()

    from pypose_tpu_torch.optim.sparse import Factor, SparseLM, pgo_factor
    from pypose_tpu_torch.testing import reproj_pgo_instance

    N, L = args.poses, args.landmarks
    ds = reproj_pgo_instance(N, L, obs_per=6, device=args.device)
    dev = ds['edges'].device

    # odometry edges i -> i+1 (mod N)
    odo = pgo_factor(ds['edges'], ds['odometry'])

    # landmark observations in the camera frame
    def obs_residual(values, meas):
        X = values['poses'][0]
        lm = values['landmarks'][0]
        return X.Act(lm) - meas

    obs = Factor(obs_residual,
                 indices={'poses': ds['obs_pose'][:, None],
                          'landmarks': ds['obs_landmark'][:, None]},
                 consts=ds['meas'])

    # noisy initialization, pose 0 anchored
    fixed = {'poses': torch.zeros(N, dtype=torch.bool, device=dev),
             'landmarks': torch.zeros(L, dtype=torch.bool, device=dev)}
    fixed['poses'][0] = True
    opt = SparseLM({'poses': ds['poses'], 'landmarks': ds['landmarks']},
                   [odo, obs], fixed=fixed, cg_iter=150, cg_tol=1e-7)
    for i in range(args.steps):
        loss = opt.step()
        print(f'step {i:2d}: chi2 {loss:.5e}')
        if opt.reject_count > 0:
            break

    err_p = (opt.params['poses'].Inv() @ ds['gt_poses']).Log().tensor()
    err_l = opt.params['landmarks'] - ds['gt_landmarks']
    print('mean pose err:', float(err_p.abs().mean()))
    print('mean landmark err:', float(err_l.abs().mean()))


if __name__ == '__main__':
    main()
