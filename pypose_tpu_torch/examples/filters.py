"""State estimation with EKF / UKF / PF on a nonlinear system.

Counterpart of ``examples/filters.py`` (the reference's EKF example, and
EKF against UKF against PF on a nonlinear system): a noisy pendulum
observed through (sin, cos) of its angle.

    python -m pypose_tpu_torch.examples.filters [--steps 100]
        [--device cpu]
"""

import argparse

import torch


def main():
    parser = argparse.ArgumentParser(description='EKF vs UKF vs PF')
    parser.add_argument('--steps', type=int, default=100)
    parser.add_argument('--particles', type=int, default=1000)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cpu' to run on the CPU")
    args = parser.parse_args()
    dev = torch.device(args.device)

    from pypose_tpu_torch.module import EKF, NLS, PF, UKF

    class Pendulum(NLS):
        def state_transition(self, state, input, t=None):
            th, om = state[..., 0], state[..., 1]
            dt = 0.05
            om = om + dt * (-9.81 * torch.sin(th) + input[..., 0])
            th = th + dt * om
            return torch.stack([th, om], dim=-1)

        def observation(self, state, input, t=None):
            return torch.stack([torch.sin(state[..., 0]),
                                torch.cos(state[..., 0])], dim=-1)

    model = Pendulum()
    N, M = 2, 2
    q, r = 0.01, 0.05
    Q = torch.eye(N, device=dev) * q ** 2
    R = torch.eye(M, device=dev) * r ** 2

    filters = {
        'EKF': EKF(Pendulum(), Q, R),
        'UKF': UKF(Pendulum(), Q, R),
        'PF': PF(Pendulum(), Q, R, particles=args.particles),
    }

    noise = torch.Generator().manual_seed(0)
    pf_gen = torch.Generator(device=dev).manual_seed(0)
    state = torch.tensor([0.8, 0.0], device=dev)
    estim = {k: torch.zeros(N, device=dev) for k in filters}
    P = {k: torch.eye(N, device=dev) for k in filters}
    sq_err = {k: 0.0 for k in filters}

    for i in range(args.steps):
        u = torch.zeros(1, device=dev)
        w = torch.randn(N, generator=noise).to(dev)
        v = torch.randn(M, generator=noise).to(dev)
        state, _ = model(state + q * w, u)
        obs = model.observation(state, u) + r * v
        for name, filt in filters.items():
            kwargs = {'generator': pf_gen} if name == 'PF' else {}
            estim[name], P[name] = filt(estim[name], obs, u, P[name],
                                        **kwargs)
            sq_err[name] += float(torch.sum((estim[name] - state) ** 2))

    for name in filters:
        rmse = (sq_err[name] / args.steps) ** 0.5
        print(f'{name}: RMSE {rmse:.4f}')


if __name__ == '__main__':
    main()
