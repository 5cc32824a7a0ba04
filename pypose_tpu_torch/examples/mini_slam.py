"""Mini structure-from-motion pipeline: EPnP initialization, Schur bundle
adjustment, APE evaluation.

Counterpart of ``examples/mini_slam.py``: the library's components
composed on one synthetic scene (the per-frame EPnP solves as one
batched call).

    python -m pypose_tpu_torch.examples.mini_slam [--frames 12]
        [--device cpu]
"""

import argparse
import math

import numpy as np
import torch


def main():
    parser = argparse.ArgumentParser(description='mini SfM pipeline')
    parser.add_argument('--frames', type=int, default=12)
    parser.add_argument('--points', type=int, default=200)
    parser.add_argument('--pix-noise', type=float, default=1.0)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cpu' to run on the CPU")
    args = parser.parse_args()
    dev = torch.device(args.device)

    import pypose_tpu_torch as pp
    from pypose_tpu_torch.metric import ape
    from pypose_tpu_torch.module import EPnP
    from pypose_tpu_torch.optim.ba import (BundleAdjustment,
                                          reproj_residual_pinhole)

    C, P = args.frames, args.points
    f, cx, cy = 500.0, 320.0, 240.0
    K = torch.tensor([[f, 0, cx], [0, f, cy], [0, 0, 1.]], device=dev)

    # scene: a camera ring looking at a point cloud
    ang = 2 * math.pi * torch.arange(C, device=dev) / C
    centers = torch.stack([6 * torch.cos(ang), 6 * torch.sin(ang),
                           1.5 + 0 * ang], -1)
    # world -> camera: the camera's z axis looks at the origin
    fwd = -centers / torch.linalg.norm(centers, dim=-1, keepdim=True)
    up = torch.tensor([0., 0., 1.], device=dev).expand(fwd.shape)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
    down = torch.linalg.cross(fwd, right)
    R_wc = torch.stack([right, down, fwd], dim=-2)
    t_wc = -torch.einsum('cij,cj->ci', R_wc, centers)
    gt_pose = pp.SE3(torch.cat(
        [t_wc, pp.mat2SO3(R_wc, check=False).tensor()], -1))
    # a compact cloud: every point safely in front of every camera
    gen = torch.Generator().manual_seed(0)
    world = 1.5 * torch.randn(P, 3, generator=gen)
    world[:, 2] *= 0.5
    world = world.to(dev)

    # observations: every camera sees every point (pinhole, noisy pixels)
    pts_cam = gt_pose.unsqueeze(-2).Act(world)          # [C, P, 3]
    pixels = pp.point2pixel(pts_cam, K)
    pixels = pixels + args.pix_noise * torch.randn(
        pixels.shape, generator=gen).to(dev)

    # 1) per-frame EPnP initialization (all frames in one batched call)
    epnp = EPnP(intrinsics=K, refine=False)
    init_pose = epnp(world.expand(C, P, 3), pixels)
    err0 = pp.reprojerr(world.expand(C, P, 3), pixels, K, init_pose,
                        reduction='norm')
    print(f'EPnP init: mean reproj {float(err0.mean()):.3f} px')

    # 2) bundle adjustment over poses and points (noisy triangulation)
    ci = torch.arange(C, device=dev).repeat_interleave(P)
    pi = torch.arange(P, device=dev).repeat(C)
    init_pts = world + 0.05 * torch.randn(world.shape, generator=gen).to(dev)
    cam_params = torch.tensor([f, cx, cy], device=dev).expand(C, 3)
    ba = BundleAdjustment(init_pose, init_pts, ci, pi,
                          pixels.reshape(-1, 2), cam_params,
                          residual=reproj_residual_pinhole,
                          fix_first_pose=True, cg_iter=40, cg_tol=1e-6)
    chi2 = ba.optimize(steps=8, patience=8, decreasing=0.0)
    O = C * P
    print(f'BA refined: chi2 {chi2:.4e} '
          f'(reproj RMSE {math.sqrt(chi2 / O):.3f} px)')

    # 3) trajectory evaluation (aligned APE: the gauge may drift)
    stamps = np.arange(C, dtype=np.float64)
    for name, est in [('EPnP ', init_pose), ('BA   ', ba.poses)]:
        r = ape(stamps, gt_pose, stamps, est, etype='translation',
                align=True, otype='RMSE')
        print(f'{name} APE RMSE: {float(r):.5f}')


if __name__ == '__main__':
    main()
