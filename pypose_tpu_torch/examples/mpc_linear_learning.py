"""Learning LTI dynamics by differentiating through MPC.

Counterpart of ``examples/mpc_linear_learning.py`` (the reference's
mpc/linear.py): an expert MPC runs on the true linear system; a learner's
(A, B) are recovered by RMSprop (``torch.optim.RMSprop``, the JAX
example's hand-written update) on the imitation loss, the gradients
flowing through MPC's final, differentiable LQR pass.  The loss that
must halve is read on one held-out batch before and after training (the
JAX example compares its first and last training batches' losses).

    python -m pypose_tpu_torch.examples.mpc_linear_learning [--iters 60]
        [--device cpu]
"""

import argparse

import torch

N_BATCH, N_STATE, N_CTRL, T = 5, 3, 3, 5
A_TRUE = ((1.1267, -0.0441, -0.0279), (-0.1533, 1.1775, 0.1631),
          (0.1618, 0.1238, 0.9489))
B_TRUE = ((0.4567, 0.7805, 0.0319), (-0.5938, -0.5724, 0.0422),
          (-0.1804, -0.2535, 1.7218))
A_INIT = ((1.2082, -0.1587, -0.3358), (0.2137, 0.8831, -0.1797),
          (0.1807, 0.2676, 0.7561))
B_INIT = ((-0.3033, -0.4966, 0.0820), (-0.9567, 1.0006, -0.9712),
          (0.0227, -0.6663, 0.2731))
P_COST = (0.6336, -0.2203, -0.1395, -0.7664, 0.8874, 0.8153)


def imitation(device='cuda', dtype=torch.float32):
    """The example's problem (the reference's linear.py:33-51): (``run``,
    ``loss``), where ``run(A, B, x_init)`` is MPC's (x, u, cost) on the LTI
    system (A, B) and ``loss(A, B, x_init, x_true, u_true)`` the imitation
    loss, mean squared input and state errors."""
    from pypose_tpu_torch.module import LTI, MPC
    from pypose_tpu_torch.utils import ReduceToBason

    kw = dict(dtype=dtype, device=device)
    n_sc = N_STATE + N_CTRL
    C = torch.eye(N_STATE, **kw)
    D = torch.zeros((N_STATE, N_CTRL), **kw)
    c1 = torch.zeros(N_STATE, **kw)
    c2 = torch.zeros(N_STATE, **kw)
    Q = torch.eye(n_sc, **kw).repeat(N_BATCH, T, 1, 1)
    p = torch.tensor(P_COST, **kw).repeat(N_BATCH, T, 1)

    def run(A, B, x_init):
        lti = LTI(A, B, C, D, c1, c2)
        mpc = MPC(lti, Q, p, T, stepper=ReduceToBason(steps=1))
        return mpc(1, x_init)

    def loss(A, B, x_init, x_true, u_true):
        x_pred, u_pred, _ = run(A, B, x_init)
        return torch.mean((u_true - u_pred) ** 2) + \
            torch.mean((x_true - x_pred) ** 2)
    return run, loss


def main():
    parser = argparse.ArgumentParser(description='MPC linear learning')
    parser.add_argument('--iters', type=int, default=60)
    parser.add_argument('--lr', type=float, default=2e-2)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cpu' to run on the CPU")
    args = parser.parse_args()
    dev = torch.device(args.device)

    run, loss_fn = imitation(dev)
    A_true = torch.tensor(A_TRUE, device=dev)
    B_true = torch.tensor(B_TRUE, device=dev)
    A = torch.tensor(A_INIT, device=dev, requires_grad=True)
    B = torch.tensor(B_INIT, device=dev, requires_grad=True)
    opt = torch.optim.RMSprop([A, B], lr=args.lr, alpha=0.9, eps=1e-8)
    gen = torch.Generator().manual_seed(0)

    def expert(x_init):
        with torch.no_grad():
            x_true, u_true, _ = run(A_true, B_true, x_init)
        return x_init, x_true, u_true

    # the imitation loss before and after training is read on one
    # held-out batch: the training batches' losses vary by ~2x from draw
    # to draw
    held_out = expert(torch.randn(N_BATCH, N_STATE, generator=gen).to(dev))
    with torch.no_grad():
        first = float(loss_fn(A, B, *held_out))
    for it in range(args.iters):
        batch = expert(torch.randn(N_BATCH, N_STATE, generator=gen).to(dev))
        opt.zero_grad()
        loss = loss_fn(A, B, *batch)
        loss.backward()
        opt.step()
        if it % 10 == 0:
            print(f'iter {it}: imitation loss {float(loss.detach()):.4e}')
    with torch.no_grad():
        last = float(loss_fn(A, B, *held_out))
    print(f'loss {first:.4e} -> {last:.4e}; '
          f'|A - A_true| max {float((A.detach() - A_true).abs().max()):.3f}')
    assert last < first * 0.5, 'learning through MPC failed to improve'


if __name__ == '__main__':
    main()
