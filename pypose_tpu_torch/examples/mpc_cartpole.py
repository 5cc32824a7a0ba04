"""MPC swing-up on a cart-pole-like system.

Counterpart of ``examples/mpc_cartpole.py`` (the reference's MPC example).

    python -m pypose_tpu_torch.examples.mpc_cartpole [--horizon 15]
        [--device cpu]
"""

import argparse

import torch


def main():
    parser = argparse.ArgumentParser(description='MPC on cartpole')
    parser.add_argument('--horizon', type=int, default=15)
    parser.add_argument('--iters', type=int, default=5)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cpu' to run on the CPU")
    args = parser.parse_args()
    dev = torch.device(args.device)

    from pypose_tpu_torch.module import MPC, NLS
    from pypose_tpu_torch.utils import ReduceToBason

    class CartPole(NLS):
        def state_transition(self, state, input, t=None):
            # state: [x, dx, th, dth]
            x, dx, th, dth = (state[..., 0], state[..., 1],
                              state[..., 2], state[..., 3])
            f = input[..., 0]
            dt, g, mc, mp, l = 0.05, 9.81, 1.0, 0.1, 0.5
            tmp = (f + mp * l * dth ** 2 * torch.sin(th)) / (mc + mp)
            thacc = (g * torch.sin(th) - torch.cos(th) * tmp) / \
                (l * (4.0 / 3 - mp * torch.cos(th) ** 2 / (mc + mp)))
            xacc = tmp - mp * l * thacc * torch.cos(th) / (mc + mp)
            return torch.stack([x + dt * dx, dx + dt * xacc,
                                th + dt * dth, dth + dt * thacc], dim=-1)

        def observation(self, state, input, t=None):
            return state

    system = CartPole()
    T = args.horizon
    ns, nc = 4, 1
    Q = torch.diag(torch.tensor([1., 0.1, 10., 0.1, 0.01], device=dev))[None]
    p = torch.zeros((1, ns + nc), device=dev)
    mpc = MPC(system, Q, p, T, stepper=ReduceToBason(steps=args.iters))
    x0 = torch.tensor([[0.0, 0.0, 0.3, 0.0]], device=dev)
    x, u, cost = mpc(0.05, x0)
    print('final state:', x[0, -1].cpu().numpy())
    print('cost:', float(cost[0]))


if __name__ == '__main__':
    main()
