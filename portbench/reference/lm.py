"""The plain reference of a pose-graph solve: Levenberg-Marquardt with a
trust-region damping rule and block-Jacobi preconditioned CG on the
normal equations, node 0 fixed, unweighted chi2 = sum_e |r_e|^2.

It states the algorithm the benchmark holds the program to, from the
published description of sparse LM for pose graphs (a Ceres-style trust
region, CG on J^T J + damping, the StopOnPlateau rule), in plain PyTorch:
edge Jacobians by forward-mode autodiff of ``lie.residual`` under the left
retraction, sums over edges by ``index_add_``, a dense CG loop that reads
its stop test on the host.  It imports nothing of the program and takes
nothing the program made.

``solve`` runs it in :class:`lie.Arith`'s precision: float64 to judge,
TF32 as the control.  ``chi2`` is the judge's recomputation of a returned
solution's objective.
"""

import torch

from . import lie

# the damping rule: Ceres-style trust region (radius grows 2x on a gain
# ratio above 0.5, shrinks by a factor that itself halves on each poor
# step below 1e-3), the LM diagonal clamped to [1e-6, 1e32], at most 16
# rejected retries a step
HIGH, LOW, UP, DOWN, FACTOR = 0.5, 1e-3, 2.0, 0.5, 0.5
CLAMP = (1e-6, 1e32)
REJECT = 16


class Graph:
    """A pose graph: ``nodes [N, 8]`` initial poses, ``edges [E, 2]``,
    ``meas [E, 8]`` measurements, over ``group`` ('SE3' or 'Sim3'), node 0
    fixed; tensors in the arithmetic's dtype on one device."""

    def __init__(self, nodes, edges, meas, group, ar=lie.F64):
        self.ar = ar
        self.group = group
        self.t = lie.TANGENT[group]
        self.nodes = nodes.to(ar.dtype)
        self.meas = meas.to(ar.dtype)
        self.edges = edges.to(device=nodes.device, dtype=torch.int64)
        self.N = nodes.shape[0]
        self.free = torch.ones(self.N, 1, dtype=ar.dtype,
                               device=nodes.device)
        self.free[0] = 0.0

    def residuals(self, X):
        i, j = self.edges[:, 0], self.edges[:, 1]
        return lie.residual(X[i], X[j], self.meas, self.group, self.ar)

    def jacobians(self, X):
        """(r [E, t], J [E, t, 2t]): d r / d (delta_i, delta_j) at 0 under
        X_k <- Exp(delta_k) X_k."""
        i, j = self.edges[:, 0], self.edges[:, 1]
        Xi, Xj, t, g, ar = X[i], X[j], self.t, self.group, self.ar

        def f(d):
            return lie.residual(lie.retract(d[:, :t], Xi, g, ar),
                                lie.retract(d[:, t:], Xj, g, ar),
                                self.meas, g, ar)

        zero = torch.zeros(Xi.shape[0], 2 * t, dtype=X.dtype,
                           device=X.device)
        cols = []
        for k in range(2 * t):
            e = torch.zeros_like(zero)
            e[:, k] = 1.0
            r, col = torch.func.jvp(f, (zero,), (e,))
            cols.append(col)
        return r, torch.stack(cols, -1)

    def operator(self, H, Hij):
        """J^T J of the free nodes as one sparse CSR matrix [N t, N t]
        (the fixed node's rows and columns empty), from the per-node
        blocks H [N, t, t] and per-edge couplings Hij [E, t, t]
        (duplicate entries summed)."""
        t, N = self.t, self.N
        if not hasattr(self, '_coo'):
            a = torch.arange(t, device=H.device)
            rr, cc = a[:, None].expand(t, t), a[None, :].expand(t, t)
            n = torch.arange(N, device=H.device)[:, None, None] * t
            i = self.edges[:, 0, None, None] * t
            j = self.edges[:, 1, None, None] * t
            rows = torch.cat([(n + rr).reshape(-1), (i + rr).reshape(-1),
                              (j + cc).reshape(-1)])
            cols = torch.cat([(n + cc).reshape(-1), (j + cc).reshape(-1),
                              (i + rr).reshape(-1)])
            f, fe = self.free[:, 0], self.free[self.edges, 0].prod(-1)
            keep = torch.cat([f[:, None, None].expand(N, t, t).reshape(-1),
                              fe[:, None, None].expand(-1, t, t).reshape(-1),
                              fe[:, None, None].expand(-1, t, t).reshape(-1)])
            self._coo = (torch.stack([rows, cols]), keep)
        idx, keep = self._coo
        vals = torch.cat([H.reshape(-1), Hij.reshape(-1), Hij.reshape(-1)])
        if self.ar.precision == 'tf32':
            vals = lie.round_tf32(vals)
        return torch.sparse_coo_tensor(idx, vals * keep, (N * t, N * t)) \
            .coalesce().to_sparse_csr()

    def node_sum(self, per_edge_i, per_edge_j):
        out = per_edge_i.new_zeros((self.N,) + tuple(per_edge_i.shape[1:]))
        out.index_add_(0, self.edges[:, 0], per_edge_i)
        out.index_add_(0, self.edges[:, 1], per_edge_j)
        return out


def chi2(graph, X):
    """sum_e |r_e|^2 of poses ``X`` [N, 8]."""
    r = graph.residuals(X.to(graph.ar.dtype))
    return float((r * r).sum())


def _trust_region(state, q):
    radius = 1.0 / state['damping']
    if q > HIGH:
        radius *= UP
    elif q <= LOW:
        radius *= state['down']
    down = DOWN if q > LOW else state['down'] * FACTOR
    return {'damping': 1.0 / min(max(radius, 1e-6), 1e16),
            'down': min(max(down, 1e-6), 1e16)}


def _pcg(A, M, b, maxiter, tol):
    """Preconditioned CG from x = 0; stops when |r|^2 <= tol^2 |b|^2 or
    after ``maxiter`` iterations."""
    x = torch.zeros_like(b)
    r = b
    z = M(r)
    gamma = (r * z).sum()
    tol2 = tol * tol * float((b * b).sum())
    p = z
    it = 0
    while it < maxiter and float((r * r).sum()) > tol2:
        Ap = A(p)
        denom = (p * Ap).sum()
        alpha = gamma / torch.where(denom == 0, 1e-31, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        gamma_new = (r * z).sum()
        p = z + gamma_new / torch.where(gamma == 0, 1e-31, gamma) * p
        gamma = gamma_new
        it += 1
    return x, it


def lm_step(graph, X, state, cg_iter, cg_tol):
    """One LM step with damping retries; returns (X, loss, last, state,
    rejections, CG iterations of each solve)."""
    ar, t, free = graph.ar, graph.t, graph.free
    i, j = graph.edges[:, 0], graph.edges[:, 1]
    r, J = graph.jacobians(X)
    Ji, Jj = J[..., :t], J[..., t:]
    JiT, JjT = Ji.transpose(-1, -2), Jj.transpose(-1, -2)
    b = -graph.node_sum(ar.mv(JiT, r), ar.mv(JjT, r)) * free
    H = graph.node_sum(ar.mm(JiT, Ji), ar.mm(JjT, Jj))
    op = graph.operator(H, ar.mm(JiT, Jj))
    diag_raw = torch.diagonal(H, dim1=-2, dim2=-1)
    diag = diag_raw.clamp(*CLAMP)
    last = float((r * r).sum())
    eye = torch.eye(t, dtype=H.dtype, device=H.device)
    fixed_eye = (1.0 - free)[..., None] * eye

    def solve(damping):
        dcorr = (diag - diag_raw + damping * diag) * free

        def A(x):
            xr = lie.round_tf32(x) if ar.precision == 'tf32' else x
            y = (op @ xr.reshape(-1)).reshape(x.shape)
            return y + dcorr * x + x * (1.0 - free)

        B = H + (diag * (1.0 + damping) - diag_raw)[..., None] * eye \
            + 1e-8 * eye
        Minv = torch.linalg.inv_ex(B)[0] * free[..., None] + fixed_eye

        def M(x):
            return ar.mv(Minv, x)
        return _pcg(A, M, b, cg_iter, cg_tol)

    count, its = 0, []
    while True:
        x, it = solve(state['damping'])
        its.append(it)
        bad = not bool(torch.isfinite(x).all())
        D = torch.zeros_like(x) if bad else x * free
        cand = lie.retract(D, X, graph.group, ar)
        rc = graph.residuals(cand)
        loss_new = float((rc * rc).sum())
        JD = ar.mv(Ji, D[i]) + ar.mv(Jj, D[j])
        pred = -float((JD * (2.0 * r + JD)).sum())
        bad = bad or not torch.isfinite(torch.tensor(loss_new))
        q = (last - loss_new) / (pred if pred != 0 else 1e-31)
        q = q if pred > 0 else -1.0
        state = _trust_region(state, q)
        rejectable = last < loss_new and not bad
        if count >= REJECT or not rejectable:
            if bad:
                return X, last, last, state, count, its
            return cand, loss_new, last, state, count, its
        count += 1


def solve(graph, radius, phases):
    """The whole solve: ``phases`` a list of dicts (cg_iter, cg_tol, steps,
    decreasing, patience), run in turn from ``graph.nodes``, the damping
    state carried from one to the next; each phase stops after
    ``patience`` steps whose chi2 fell by less than ``decreasing``, or
    after a step with rejections that also fell by less.  Returns (X,
    chi2 history of each phase, CG iterations of each step of each
    phase)."""
    X = graph.nodes
    state = {'damping': 1.0 / radius, 'down': DOWN}
    hist, its = [], []
    for ph in phases:
        h, itp, pat = [], [], 0
        for _ in range(ph['steps']):
            X, loss, last, state, count, it = lm_step(
                graph, X, state, ph['cg_iter'], ph['cg_tol'])
            small = last - loss < ph['decreasing']
            h.append(loss)
            itp.append(it)
            pat = pat + 1 if small else 0
            if pat >= ph['patience'] or (count > 0 and small):
                break
        hist.append(h)
        its.append(itp)
    return X, hist, its
