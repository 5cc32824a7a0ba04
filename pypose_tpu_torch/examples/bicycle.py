"""Bicycle kinematics filtered with EKF / UKF / PF.

Counterpart of ``examples/bicycle.py`` (the reference's filter/bicycle.py:
the 2D bicycle kinematic model driven by forward speed and steering rate,
estimated by the three filters; printed error statistics in place of its
plots).

    python -m pypose_tpu_torch.examples.bicycle [--steps 40]
        [--device cpu]
"""

import argparse
import math

import torch


def main():
    parser = argparse.ArgumentParser(description='Bicycle model filtering')
    parser.add_argument('--steps', type=int, default=40)
    parser.add_argument('--particles', type=int, default=400)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cpu' to run on the CPU")
    args = parser.parse_args()
    dev = torch.device(args.device)

    from pypose_tpu_torch.module import EKF, NLS, PF, UKF

    class Bicycle(NLS):
        """2D bicycle kinematics: state (x, y, theta), input (speed,
        steering rate)."""

        def state_transition(self, state, input, t=None):
            theta = state[..., 2] + input[..., 1]
            x = state[..., 0] + input[..., 0] * torch.cos(theta)
            y = state[..., 1] + input[..., 0] * torch.sin(theta)
            return torch.stack([x, y, theta], dim=-1)

        def observation(self, state, input, t=None):
            return state

    N = 3
    q, r = 0.02, 0.05
    Q = torch.eye(N, device=dev) * q ** 2
    R = torch.eye(N, device=dev) * r ** 2
    filters = {
        'EKF': EKF(Bicycle(), Q, R),
        'UKF': UKF(Bicycle(), Q, R),
        'PF': PF(Bicycle(), Q, R, particles=args.particles),
    }

    model = Bicycle()
    noise = torch.Generator().manual_seed(0)
    pf_gen = torch.Generator(device=dev).manual_seed(0)
    state = torch.zeros(N, device=dev)                # the true state
    est = {k: torch.zeros(N, device=dev) for k in filters}
    P = {k: torch.eye(N, device=dev) * 0.1 for k in filters}
    sq = {k: 0.0 for k in filters}

    for i in range(args.steps):
        # constant speed, sinusoidal steering: the reference's circuit
        u = torch.tensor([0.3, 0.1 * math.sin(0.2 * i)], device=dev)
        state = model.state_transition(state, u) \
            + torch.randn(N, generator=noise).to(dev) * q
        obs = model.observation(state, u) \
            + torch.randn(N, generator=noise).to(dev) * r
        for name, f in filters.items():
            kwargs = {}
            if name == 'PF':
                f.model.reset()
                kwargs = {'generator': pf_gen}
            est[name], P[name] = f(est[name], obs, u, P[name], **kwargs)
            sq[name] = sq[name] + float(torch.sum((est[name] - state) ** 2))

    obs_only = math.sqrt(r ** 2 * N)
    print(f'true final state: {state.cpu().numpy()}')
    for name in filters:
        rmse = math.sqrt(sq[name] / args.steps)
        print(f'{name}: RMSE {rmse:.4f} (raw observation noise '
              f'{obs_only:.4f})')
        assert rmse < 0.5, f'{name} diverged'


if __name__ == '__main__':
    main()
