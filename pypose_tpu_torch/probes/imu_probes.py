r"""Probes of the IMU path on an NVIDIA GPU.

- scan: a [1, 1,000,000, 3] float32 tensor (the IMU's velocity
  increments at ``bench.py:bench_imu``'s size) summed along the frames by
  ``torch.cumsum`` over dimension 1, an outer dimension, and by the IMU's
  ``_cumsum`` (the last dimension, float64 accumulation): the device
  time of each (CUDA events, median of 7) and its largest gap from a
  float64 sum on the CPU, relative to the largest |sum|.
- quat: the per-frame quaternion so3(gyro dt).Exp() of
  ``testing.imu_instance('bench')`` on the card and on the CPU, as
  uint32 bits, and for ``imu_instance('synth', 100_000)`` the number of
  frames whose quaternion bits differ between card and CPU.
- imu: one ``IMUPreintegrator`` call at 10^6 frames under
  ``torch.profiler``: device time and launches by kernel, the top 8.

Run from the repository root on a machine with the GPU:

    python3 -m pypose_tpu_torch.probes.imu_probes
"""

import statistics
import sys

import numpy as np
import torch

from pypose_tpu_torch.lietensor.utils import so3
from pypose_tpu_torch.module import IMUPreintegrator
from pypose_tpu_torch.module.imu_preintegrator import _cumsum
from pypose_tpu_torch.testing import imu_instance


def event_ms(fn, repeat=7):
    times = []
    for _ in range(repeat):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def scan_probe(dev):
    gen = torch.Generator().manual_seed(0)
    x = (0.005 * (1 + torch.rand(1, 1_000_000, 3, generator=gen)))
    ref = torch.cumsum(x.double(), dim=1)
    scale = float(ref.abs().max())
    xd = x.to(dev)
    for name, fn in (('torch.cumsum, dim 1 (outer)',
                      lambda: torch.cumsum(xd, dim=1)),
                     ('_cumsum (last dim, float64)', lambda: _cumsum(xd))):
        ms = event_ms(fn)
        gap = float((fn().cpu().double() - ref).abs().max()) / scale
        print(f'[scan] {name}: {ms:.3f} ms, largest gap from the float64 '
              f'sum {gap:.3e} of max|sum|', flush=True)


def quat_probe(dev):
    for name, F in (('bench', 4), ('synth', 100_000)):
        q = {}
        for d in ('cpu', dev):
            dt, gyro, _ = imu_instance(name, F, device=d)
            q[str(d)] = so3(gyro * dt).Exp().tensor().cpu().numpy()
        card, cpu = q[str(dev)], q['cpu']
        diff = int((card.view(np.uint32) != cpu.view(np.uint32)).any(-1)
                   .sum())
        print(f'[quat] {name}: first frame bits card '
              f'{card[0, 0].view(np.uint32).tolist()}, CPU '
              f'{cpu[0, 0].view(np.uint32).tolist()}; {diff} of {F} frames '
              'differ', flush=True)


def imu_probe(dev):
    from torch.profiler import ProfilerActivity, profile
    x = imu_instance('bench', 1_000_000, device=dev)
    integ = IMUPreintegrator(reset=True, prop_cov=True, device=dev)
    integ(*x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        integ(*x)
        torch.cuda.synchronize()
    ops = sorted((e for e in prof.key_averages()
                  if not e.key.startswith('aten::')),
                 key=lambda e: -e.device_time_total)
    total = sum(e.device_time_total for e in ops)
    print(f'[imu] one call at 10^6 frames: {total / 1e3:.3f} ms device '
          f'time, {sum(e.count for e in ops)} launches; the top 8:',
          flush=True)
    for e in ops[:8]:
        print(f'[imu]   {e.device_time_total / 1e3:8.3f} ms {e.count:6d} x '
              f'{e.key[:90]}', flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit('imu_probes: needs an NVIDIA GPU')
    dev = torch.device('cuda', 0)
    print(f'[device] {torch.cuda.get_device_name(0)}', flush=True)
    scan_probe(dev)
    quat_probe(dev)
    imu_probe(dev)


if __name__ == '__main__':
    sys.exit(main())
