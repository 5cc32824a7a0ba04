"""IMU preintegration example on KITTI raw data or a synthetic trajectory.

Counterpart of ``examples/imu_integration.py`` (KITTI raw IMU in the
reference).  Point ``--kitti`` at an extracted drive directory (holding
``oxts/``) to integrate the real stream and report the drift against the
OXTS ground truth; without it a smooth trajectory is synthesized.

    python -m pypose_tpu_torch.examples.imu_integration [--frames 500]
        [--kitti DIR] [--device cpu]
"""

import argparse

import numpy as np
import torch


def synthesize_imu(frames, dt=0.01, seed=0, device='cuda'):
    """Ground truth: a circular drive (yaw rate 0.5 rad/s, radius 5 m)
    with measurement noise; (dt, gyro, acc) of shape [1, frames, *]."""
    w = 0.5
    gyro = np.zeros((frames, 3))
    gyro[:, 2] = w
    R = 5.0
    acc = np.zeros((frames, 3))
    acc[:, 1] = R * w * w  # centripetal, toward the centre (body +y)
    acc[:, 2] = 9.81007    # gravity compensation measured by the IMU
    rng = np.random.default_rng(seed)
    gyro += rng.normal(size=gyro.shape) * 1e-4
    acc += rng.normal(size=acc.shape) * 1e-3

    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=device)[None]
    return t(np.full((frames, 1), dt)), t(gyro), t(acc)


def main():
    parser = argparse.ArgumentParser(description='IMU Preintegration')
    parser.add_argument('--frames', type=int, default=500)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cpu' to run on the CPU")
    parser.add_argument('--kitti', type=str, default=None,
                        help='path to an extracted KITTI raw drive '
                             '(directory containing oxts/)')
    args = parser.parse_args()

    from pypose_tpu_torch.module import IMUPreintegrator

    if args.kitti:
        from pypose_tpu_torch.datasets import load_kitti_imu
        data = load_kitti_imu(args.kitti, device=args.device)
        F = min(args.frames, data['dt'].shape[0])
        integrator = IMUPreintegrator(
            rot=data['gt_rot'][0], vel=data['gt_vel'][0],
            reset=True, prop_cov=True, device=args.device)
        # integrate frames 0..F-2: the state after k steps sits at frame
        # k, so the last comparable ground-truth entry is gt_pos[F-1]
        out = integrator(data['dt'][None, :F - 1],
                         data['gyro'][None, :F - 1],
                         data['acc'][None, :F - 1])
        pos = out['pos'][0, -1].cpu().numpy()
        gt = data['gt_pos'][F - 1].cpu().numpy()
        print('KITTI drive: %d frames' % F)
        print('integrated position:', pos)
        print('ground-truth position:', gt)
        print('drift: %.3f m' % float(np.linalg.norm(pos - gt)))
        print('covariance trace:', float(torch.trace(out['cov'][0])))
        return

    dt, gyro, acc = synthesize_imu(args.frames, device=args.device)
    integrator = IMUPreintegrator(
        vel=torch.tensor([2.5, 0., 0.]), reset=True, prop_cov=True,
        device=args.device)
    out = integrator(dt, gyro, acc)
    print('final position:', out['pos'][0, -1].cpu().numpy())
    print('final velocity:', out['vel'][0, -1].cpu().numpy())
    print('final rotation (rpy):', out['rot'][0, -1].euler().cpu().numpy())
    print('covariance trace:', float(torch.trace(out['cov'][0])))


if __name__ == '__main__':
    main()
