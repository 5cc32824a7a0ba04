r"""Environment report: Python, PyTorch, CUDA, nvcc and the GPU.

Counterpart of ``pypose_tpu/utils/collect_env.py`` (which reports JAX and
its devices).  The GPU's name and power limit come from
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``, the
form in which every time of this project is tagged.

    python -m pypose_tpu_torch.utils.collect_env
"""

import os
import platform
import shutil
import subprocess
import sys


def _run(cmd):
    """The command's output, or why there is none."""
    if shutil.which(cmd[0]) is None and not os.path.exists(cmd[0]):
        return f'{os.path.basename(cmd[0])} not found'
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f'<unavailable: {e}>'
    if proc.returncode != 0:
        return f'<{os.path.basename(cmd[0])} exited {proc.returncode}>'
    return proc.stdout.strip()


def get_pretty_env_info():
    from .. import __version__
    from ..ops._build import nvcc_path
    lines = ['pypose_tpu_torch version: ' + __version__,
             'Python version: ' + sys.version.replace('\n', ' '),
             'Platform: ' + platform.platform()]
    import torch
    lines += ['PyTorch version: ' + torch.__version__,
              'PyTorch CUDA version: ' + str(torch.version.cuda),
              'CUDA available: ' + str(torch.cuda.is_available())]
    if torch.cuda.is_available():
        lines += ['GPU count: ' + str(torch.cuda.device_count()),
                  'GPU 0: ' + torch.cuda.get_device_name(0)]
    try:
        nvcc = nvcc_path()
    except RuntimeError:
        lines.append('nvcc: not found')
    else:
        lines.append('nvcc: ' + _run([nvcc, '--version']).splitlines()[-1])
    lines.append('nvidia-smi (name, power limit): ' + _run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader']).replace('\n', '; '))
    import numpy
    lines.append('NumPy version: ' + numpy.__version__)
    for var in ('CUDA_VISIBLE_DEVICES', 'CUDA_HOME'):
        if os.environ.get(var):
            lines.append(f'{var}={os.environ[var]}')
    return '\n'.join(lines)


def collect_env():
    print(get_pretty_env_info())


if __name__ == '__main__':
    collect_env()
