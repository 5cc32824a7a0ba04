r"""Wall-clock timer that waits for the device.

Counterpart of ``pypose_tpu/utils/timer.py:14-41`` (which waits with
``jax.block_until_ready``): here ``torch.cuda.synchronize`` on the card,
nothing on the CPU.
"""

import time

import torch


class Timer:
    """Seconds between :meth:`tic`/:meth:`start` and :meth:`toc`/
    :meth:`end`, the device's queued work finished at both ends.

    Args:
        device: the device to wait for; the card (``'cuda'``) unless the
            caller asks for the CPU, where there is nothing to wait for.
    """

    def __init__(self, device=None):
        self.device = torch.device('cuda' if device is None else device)
        self.synchronize()
        self.start_time = time.time()

    def synchronize(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def tic(self):
        self.start()

    def start(self):
        self.synchronize()
        self.start_time = time.time()

    def end(self, reset=True):
        self.synchronize()
        duration = time.time() - self.start_time
        if reset:
            self.start_time = time.time()
        return duration

    def toc(self, verbose=False):
        d = self.end()
        if verbose:
            print(f'Time: {d:.6f} s')
        return d
