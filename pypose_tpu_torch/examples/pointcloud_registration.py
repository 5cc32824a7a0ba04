"""Point-cloud registration beyond ICP: filtering and direct alignment.

Counterpart of ``examples/pointcloud_registration.py`` (the reference's
pcr/pointcloud.py bunny demo: downsample with the point-cloud filters,
then align).  The cloud is a synthesized structured surface (a torus
with noise); the demo runs ``voxel_filter``, ``random_filter``,
``knn_filter`` and ``nbr_filter`` and both alignment routes: ``svdtf``
(Kabsch, known correspondences, SE3) and ``svdstf`` (Umeyama with
scale, Sim3), then ICP.

    python -m pypose_tpu_torch.examples.pointcloud_registration
        [--points 2000] [--device cpu]
"""

import argparse
import math

import torch


def bunny_like(n, generator):
    """A structured surface (torus with noise) standing in for the bunny."""
    u = torch.rand(n, generator=generator) * 2 * math.pi
    v = torch.rand(n, generator=generator) * 2 * math.pi
    R, r = 1.0, 0.35
    pts = torch.stack([(R + r * torch.cos(v)) * torch.cos(u),
                       (R + r * torch.cos(v)) * torch.sin(u),
                       r * torch.sin(v)], dim=-1)
    return pts + torch.randn(n, 3, generator=generator) * 0.005


def main():
    parser = argparse.ArgumentParser(description='Point-cloud registration')
    parser.add_argument('--points', type=int, default=2000)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cpu' to run on the CPU")
    args = parser.parse_args()
    dev = torch.device(args.device)

    import pypose_tpu_torch as pp
    from pypose_tpu_torch.module import ICP

    gen = torch.Generator().manual_seed(0)
    source = bunny_like(args.points, gen).to(dev)

    # --- the reference demo's filter chain ------------------------------
    vox = pp.voxel_filter(source, voxel=torch.tensor([0.2, 0.2, 0.2],
                                                     device=dev))
    rnd = pp.random_filter(source, num=min(500, args.points), generator=gen)
    knnf = pp.knn_filter(source, k=4)
    nbr = pp.nbr_filter(source, nbr=4, radius=0.3)
    print(f'filters: voxel {source.shape[0]} -> {vox.shape[0]}; '
          f'random -> {rnd.shape[0]}; knn-smooth -> {knnf.shape[0]}; '
          f'nbr -> {nbr.shape[0]}')

    # --- rigid alignment with known correspondences (svdtf, Kabsch) ----
    T_true = pp.randn_SE3(sigma=(0.5, 0.3), generator=gen, device=dev)
    target = T_true.Act(source)
    T_est = pp.svdtf(source, target)
    err = float((T_est.Inv() @ T_true).Log().tensor().abs().max())
    print(f'svdtf (Kabsch): pose error {err:.2e}')
    assert err < 1e-4

    # --- similarity alignment (svdstf, Umeyama, Sim3) ------------------
    scale = 1.7
    tgt_s = scale * T_true.Act(source)
    S_est = pp.svdstf(source, tgt_s)
    s_est = float(S_est.tensor()[..., 7])
    s_err = abs(s_est - scale)
    print(f'svdstf (Umeyama): recovered scale {s_est:.4f} (true {scale}), '
          f'err {s_err:.2e}')
    assert s_err < 1e-3

    # --- unknown correspondences: ICP -----------------------------------
    T_small = pp.randn_SE3(sigma=(0.1, 0.05), generator=gen, device=dev)
    T_icp = ICP()(source, T_small.Act(source))
    icp_err = float((T_icp.Inv() @ T_small).Log().tensor().abs().max())
    print(f'ICP (unknown correspondences): pose error {icp_err:.2e}')
    assert icp_err < 1e-2


if __name__ == '__main__':
    main()
