r"""Coupling-block and circulant-stencil SpMV for factor-graph normal
equations.

Counterpart of ``pypose_tpu/ops/spmv.py``.  For an arity-2 factor graph,

    A = D + sum_e [ C_e (i <- j) + C_e^T (j <- i) ],   C_e = J_i^T W J_j.

:class:`StencilSpMV`: pose graphs are near-circulant, odometry edges have
offset j - i = 1 and loop closures cluster on few offsets.  Grouping edges
by circular offset turns the coupling part of ``A x`` into offset
stencils,

    y += C_d x_{n+d};   y_{n+d} += C_d^T x_n,

with no gathers.  The per-offset channels ``C [n_off, N, t, t]`` are what
the CG kernels of ``ops/stencil_cg.py`` consume.

:class:`CouplingSpMV`: any arity-2 graph.  Chain edges (j = i + 1 over
consecutive i) couple by slices; every other edge is sorted by its
destination's tile of 128 nodes at construction, so its contributions
accumulate through a static one-hot ``[T, 128, K]`` product, one
``torch.bmm`` a direction: a fixed summation order, no scatter atomics.
The one-hot product needs float32 matmuls without TF32, which the
constructor turns off on CUDA (``optim.sparse.require_full_fp32``).
"""

import numpy as np
import torch

TILE = 128


def _coupling_flat(J, WJ):
    """C_e = J_i^T W J_j as flat [E, t*t] rows (row-major t x t)."""
    t = J.shape[-1]
    return torch.einsum('edt,edu->etu', WJ[:, :, 0, :],
                        J[:, :, 1, :]).reshape(-1, t * t)


def _index(a, device):
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


class CouplingSpMV:
    r"""Static structure of one arity-2 factor's coupling blocks, and its
    matvec.

    Args:
        edges: int [E, 2] node index pairs (host array or tensor; the
            structure is static).
        n_nodes: number of nodes N.
        tan: tangent dim t.
        device, dtype: of the index and one-hot tensors (dtype: that of
            the vectors :meth:`couple` will see).

    Per LM step :meth:`precompute` turns the weighted Jacobian blocks into
    the operator's state; :meth:`couple` and :meth:`matvec` apply it.
    """

    def __init__(self, edges, n_nodes, tan, device=None,
                 dtype=torch.float32):
        from ..optim.sparse import require_full_fp32
        edges = edges.cpu().numpy() if torch.is_tensor(edges) \
            else np.asarray(edges)
        self.N = int(n_nodes)
        self.tan = int(tan)
        self.E = edges.shape[0]
        self.T = (self.N + TILE - 1) // TILE
        self.device = device
        self.dtype = dtype
        if device is not None:
            require_full_fp32(device)
        chain = edges[:, 1] == edges[:, 0] + 1
        self.chain_rows = np.nonzero(chain)[0]
        self.loop_rows = np.nonzero(~chain)[0]
        ci, cj = edges[self.chain_rows, 0], edges[self.chain_rows, 1]
        li, lj = edges[self.loop_rows, 0], edges[self.loop_rows, 1]
        # chain rows couple by slices when their i are consecutive; else
        # they take the one-hot path as well (dir_ci, dir_cj)
        self._chain_contig = bool(len(ci) > 0 and np.all(np.diff(ci) == 1))
        self.ci0 = int(ci[0]) if self._chain_contig else 0
        self._cr = _index(self.chain_rows, device)
        # direction name -> (rows of the factor, destination, source):
        # 'i' accumulates C x_j at i, 'j' accumulates C^T x_i at j
        dirs = {'i': (self.loop_rows, li, lj), 'j': (self.loop_rows, lj, li)}
        if not self._chain_contig and len(ci):
            dirs.update(ci=(self.chain_rows, ci, cj),
                        cj=(self.chain_rows, cj, ci))
        self.dirs = {name: self._build_dir(rows, dst, src)
                     for name, (rows, dst, src) in dirs.items()
                     if len(rows)}

    def _build_dir(self, rows, dst, src):
        """Rows sorted by destination tile (stably), each tile padded to a
        common K: dict(rows [T*K] factor rows (padding: row 0), valid
        [T*K, 1], onehot [T, TILE, K], src [T*K] x-source rows, K)."""
        R = len(dst)
        order_ = np.argsort(dst, kind='stable')
        tile_of = dst[order_] // TILE
        counts = np.bincount(tile_of, minlength=self.T)
        K = max(int(counts.max()), 1)
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        k = np.arange(R) - first[tile_of]
        order = np.full((self.T, K), -1, np.int64)
        onehot = np.zeros((self.T, TILE, K), np.float32)
        srcp = np.zeros((self.T, K), np.int64)
        order[tile_of, k] = order_
        onehot[tile_of, dst[order_] - tile_of * TILE, k] = 1.0
        srcp[tile_of, k] = src[order_]
        order = order.reshape(-1)
        return dict(rows=_index(rows[np.maximum(order, 0)], self.device),
                    valid=torch.as_tensor((order >= 0)[:, None],
                                          dtype=self.dtype,
                                          device=self.device),
                    onehot=torch.as_tensor(onehot, dtype=self.dtype,
                                           device=self.device),
                    src=_index(srcp.reshape(-1), self.device), K=K)

    def precompute(self, J, WJ):
        """The operator's state from the weighted Jacobian blocks J, WJ
        [E, d, 2, t]: the chain's blocks ``Cc [Ec, t, t]`` and, for each
        direction, its blocks in tile order (``C^T`` for the j sides)."""
        t = self.tan
        Cf = _coupling_flat(J, WJ)
        state = {}
        if self._chain_contig:
            state['Cc'] = Cf[self._cr].reshape(-1, t, t)
        for name, dirn in self.dirs.items():
            Cd = (Cf[dirn['rows']] * dirn['valid']).reshape(-1, t, t)
            state['C' + name] = Cd if name in ('i', 'ci') \
                else Cd.transpose(-1, -2)
        return state

    def _apply_dir(self, dirn, Cd, x):
        """One direction: gather the sources, couple, accumulate by the
        one-hot product."""
        c = torch.einsum('etu,eu->et', Cd, x[dirn['src']])
        out = torch.bmm(dirn['onehot'], c.reshape(self.T, dirn['K'], -1))
        return out.reshape(self.T * TILE, -1)[:self.N]

    def couple(self, state, x):
        """Off-diagonal part of ``A x``: sum_e C_e x_j at i and C_e^T x_i
        at j."""
        y = torch.zeros_like(x)
        if 'Cc' in state:
            Cc, i0 = state['Cc'], self.ci0
            Ec = Cc.shape[0]
            y[i0:i0 + Ec] += torch.einsum('etu,eu->et', Cc,
                                          x[i0 + 1:i0 + 1 + Ec])
            y[i0 + 1:i0 + 1 + Ec] += torch.einsum('etu,et->eu', Cc,
                                                  x[i0:i0 + Ec])
        for name, dirn in self.dirs.items():
            y = y + self._apply_dir(dirn, state['C' + name], x)
        return y

    def matvec(self, state, D, x):
        """``A x`` with D [N, t, t] diagonal blocks."""
        return torch.einsum('ntu,nu->nt', D, x) + self.couple(state, x)


class StencilSpMV:
    r"""Circulant-stencil SpMV: the gather-free form for banded graphs.

    Args:
        edges: int [E, 2] node index pairs (host array or tensor; the
            structure is static).
        n_nodes: number of nodes N.
        tan: tangent dim t (6 for SE3).
        max_offsets: refuse graphs needing more offset channels.
        device: device of the per-step channel tensors.

    Construction raises ``ValueError`` when the graph needs more than
    ``max_offsets`` channels, or when the channels would be mostly zeros
    (``n_off * N > 4 E``).  Duplicate (i, offset) edges sum into one
    channel slot.
    """

    def __init__(self, edges, n_nodes, tan, max_offsets=16, device=None):
        edges = edges.cpu().numpy() if torch.is_tensor(edges) \
            else np.asarray(edges)
        self.N = int(n_nodes)
        self.tan = int(tan)
        E = edges.shape[0]
        delta = (edges[:, 1] - edges[:, 0]) % self.N
        offsets = np.unique(delta)
        if len(offsets) > max_offsets:
            raise ValueError(f'{len(offsets)} distinct circular offsets '
                             f'> max_offsets={max_offsets}')
        if len(offsets) * self.N > 4 * max(E, 1):
            # stencil work is O(n_off * N) whatever E is, so sparse
            # channels lose to a coupling-block formulation
            raise ValueError('stencil channels too sparse '
                             f'({len(offsets)} offsets x {self.N} nodes '
                             f'for {E} edges)')
        self.offsets = [int(d) for d in offsets]
        # channel slot of edge e: (offset index, source node i)
        off_index = np.searchsorted(offsets, delta)
        self._slot = torch.as_tensor(off_index * self.N + edges[:, 0],
                                     dtype=torch.int64, device=device)
        self.E = E

    def precompute(self, J, WJ):
        """Channels ``C [n_off, N, t, t]`` from one factor's blocks."""
        return self.precompute_multi([(J, WJ)])

    def precompute_multi(self, pairs):
        """Channels from per-factor (J, WJ) weighted-block pairs whose
        concatenated edge order matches this object's construction order
        (how SparseLM merges all its factors into one stencil)."""
        t = self.tan
        C = torch.cat([_coupling_flat(J, WJ) for J, WJ in pairs], dim=0)
        chan = C.new_zeros((len(self.offsets) * self.N, t * t))
        # accumulate=True sums duplicate slots in a fixed order on the
        # card too (sort-based), where index_add_ would use atomics
        chan.index_put_((self._slot,), C, accumulate=True)
        return chan.reshape(len(self.offsets), self.N, t, t)

    def couple(self, C, x):
        """Off-diagonal part of ``A x`` via the offset stencils."""
        y = torch.zeros_like(x)
        for k, d in enumerate(self.offsets):
            xr = torch.roll(x, -d, dims=0)
            y = y + torch.einsum('ntu,nu->nt', C[k], xr)
            back = torch.einsum('ntu,nt->nu', C[k], x)
            y = y + torch.roll(back, d, dims=0)
        return y

    def matvec(self, C, D, x):
        """``A x`` with D [N, t, t] diagonal blocks."""
        return torch.einsum('ntu,nu->nt', D, x) + self.couple(C, x)
