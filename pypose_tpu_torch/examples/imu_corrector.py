"""Learn an IMU bias corrector by backpropagating through preintegration.

Counterpart of ``examples/imu_corrector.py`` (the reference trains a small
network through the differentiable IMUPreintegrator): a constant gyro and
accelerometer bias learned with ``torch.optim.Adam`` (the JAX example's
optax Adam) against the ground-truth end pose of a synthetic motion.

    python -m pypose_tpu_torch.examples.imu_corrector [--iters 200]
        [--device cpu]
"""

import argparse

import torch

TRUE_GYRO_BIAS = (0.02, -0.01, 0.015)
TRUE_ACC_BIAS = (0.1, -0.05, 0.08)


def bias_loss(F, device='cuda', dtype=torch.float32):
    """The example's problem: a ``loss(gyro_bias, acc_bias)`` that
    integrates the biased measurements, corrected by the given biases,
    and compares the end pose with the clean motion's (rotation error's
    squared norm plus position error's); also the true biases."""
    import pypose_tpu_torch as pp
    from pypose_tpu_torch.module import IMUPreintegrator

    kw = dict(dtype=dtype, device=device)
    true_gyro_bias = torch.tensor(TRUE_GYRO_BIAS, **kw)
    true_acc_bias = torch.tensor(TRUE_ACC_BIAS, **kw)
    # ground truth motion: a constant rotation rate and acceleration
    dt = torch.full((1, F, 1), 0.01, **kw)
    gyro_clean = torch.tensor([0., 0., 0.7], **kw).expand(1, F, 3)
    acc_clean = torch.tensor([0.5, 0., 9.81007], **kw).expand(1, F, 3)
    integ = IMUPreintegrator(reset=True, prop_cov=False, **kw)
    gt = integ(dt, gyro_clean, acc_clean)
    gt_pos = gt['pos'][0, -1]
    gt_rot = gt['rot'][0, -1].tensor()
    # measured = clean + bias
    gyro_meas = gyro_clean + true_gyro_bias
    acc_meas = acc_clean + true_acc_bias

    def loss(gyro_bias, acc_bias):
        out = integ(dt, gyro_meas - gyro_bias, acc_meas - acc_bias)
        rot_err = (out['rot'][0, -1].Inv() @ pp.SO3(gt_rot)).Log().tensor()
        pos_err = out['pos'][0, -1] - gt_pos
        return torch.sum(rot_err ** 2) + torch.sum(pos_err ** 2)
    return loss, true_gyro_bias, true_acc_bias


def main():
    parser = argparse.ArgumentParser(description='IMU corrector training')
    parser.add_argument('--iters', type=int, default=200)
    parser.add_argument('--frames', type=int, default=50)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cpu' to run on the CPU")
    args = parser.parse_args()

    loss_fn, true_gyro_bias, true_acc_bias = bias_loss(args.frames,
                                                       args.device)
    gyro_bias = torch.zeros(3, device=args.device, requires_grad=True)
    acc_bias = torch.zeros(3, device=args.device, requires_grad=True)
    opt = torch.optim.Adam([gyro_bias, acc_bias], lr=1e-2)
    for i in range(args.iters):
        opt.zero_grad()
        loss = loss_fn(gyro_bias, acc_bias)
        loss.backward()
        opt.step()
        if i % 50 == 0:
            print(f'iter {i:4d}: loss {float(loss.detach()):.3e}')
    print('learned gyro bias:', gyro_bias.detach().cpu().numpy(),
          'true:', true_gyro_bias.cpu().numpy())
    print('learned acc bias :', acc_bias.detach().cpu().numpy(),
          'true:', true_acc_bias.cpu().numpy())


if __name__ == '__main__':
    main()
