"""Dynamics examples: a Floquet-style LTV rollout and neural-network
dynamics learning.

Counterpart of ``examples/dynamics.py`` (the reference's floquet,
neuralnet and cartpole dynamics examples): the MLP is trained with
``torch.optim.Adam`` (the JAX example's optax Adam), then linearized
through ``NLS``.

    python -m pypose_tpu_torch.examples.dynamics [--steps 100]
        [--device cpu]
"""

import argparse
import math

import torch


def main():
    parser = argparse.ArgumentParser(description='Dynamics examples')
    parser.add_argument('--steps', type=int, default=100)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cpu' to run on the CPU")
    args = parser.parse_args()
    dev = torch.device(args.device)

    from pypose_tpu_torch.module import LTV, NLS

    # ---- Floquet-style periodic LTV system ------------------------------
    class Floquet(LTV):
        def __init__(self):
            eye = torch.eye(2, device=dev)
            super().__init__(None, eye[:, :1], eye,
                             torch.zeros((2, 1), device=dev))

        @property
        def A(self):
            c = math.cos(2 * math.pi * float(self.systime) / 100)
            return torch.tensor([[1., c * 0.1], [c * 0.1, 1.]], device=dev)

        @property
        def B(self):
            s = math.sin(2 * math.pi * float(self.systime) / 50)
            return torch.tensor([[s], [1.0]], device=dev)

    sys_ltv = Floquet()
    x = torch.tensor([1., 1.], device=dev)
    traj = [x]
    for k in range(args.steps):
        u = torch.ones(1, device=dev) * 0.1
        x, y = sys_ltv(x, u)
        traj.append(x)
    traj = torch.stack(traj)
    print('Floquet LTV rollout:', tuple(traj.shape), 'final state',
          x.cpu().numpy())

    # ---- neural-network dynamics learning -------------------------------
    class TrueSys(NLS):
        def state_transition(self, state, input, t=None):
            return torch.stack([
                state[..., 0] + 0.1 * state[..., 1],
                state[..., 1] + 0.1 * (torch.sin(state[..., 0])
                                       + input[..., 0])], dim=-1)

        def observation(self, state, input, t=None):
            return state

    def mlp(params, x):
        h = torch.tanh(x @ params['w1'] + params['b1'])
        return h @ params['w2'] + params['b2']

    gen = torch.Generator().manual_seed(0)
    params = {'w1': 0.5 * torch.randn(3, 32, generator=gen),
              'b1': torch.zeros(32),
              'w2': 0.5 * torch.randn(32, 2, generator=gen),
              'b2': torch.zeros(2)}
    params = {k: v.to(dev).requires_grad_() for k, v in params.items()}

    true_sys = TrueSys()
    # training data: random transitions
    xs = torch.randn(512, 2, generator=gen).to(dev)
    us = torch.randn(512, 1, generator=gen).to(dev)
    ys = true_sys.state_transition(xs, us)

    opt = torch.optim.Adam(list(params.values()), lr=1e-2)
    for i in range(300):
        opt.zero_grad()
        loss = torch.mean((mlp(params, torch.cat([xs, us], -1)) - ys) ** 2)
        loss.backward()
        opt.step()
    print(f'NN dynamics fit: final MSE {float(loss.detach()):.2e}')

    # plug the learned net into an NLS for linearization-based control
    trained = {k: v.detach() for k, v in params.items()}

    class LearnedSys(NLS):
        def state_transition(self, state, input, t=None):
            return mlp(trained, torch.cat([state, input], -1))

        def observation(self, state, input, t=None):
            return state

    lsys = LearnedSys()
    x0 = torch.tensor([0.5, -0.2], device=dev)
    u0 = torch.tensor([0.1], device=dev)
    lsys.forward(x0, u0)
    lsys.set_refpoint(state=x0, input=u0)
    A_learned = lsys.A
    true_sys.forward(x0, u0)
    true_sys.set_refpoint(state=x0, input=u0)
    A_true = true_sys.A
    print('linearization A (learned vs true) max diff:',
          float((A_learned - A_true).abs().max()))


if __name__ == '__main__':
    main()
