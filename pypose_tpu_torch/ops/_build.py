r"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles alone into
``_build/lib<name>.so`` (listed in ``.gitignore``) at first use, for
``sm_90a`` (H100).  The library is rebuilt when its source is newer.  A
missing ``nvcc`` or a failed compile raises with the compiler's output;
nothing falls back.  The compiler's report (``-Xptxas -v``: registers,
shared memory, spills) is kept beside the library as ``lib<name>.log``.
"""

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / 'csrc'
BUILD = PACKAGE / '_build'

NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']


def nvcc_path():
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    raise RuntimeError('nvcc not found (PATH, $CUDA_HOME/bin, '
                       '/usr/local/cuda/bin): the CUDA toolkit is needed to '
                       'build pypose_tpu_torch/csrc')


def build(name):
    """Compile ``csrc/<name>.cu`` if its library is missing or older than
    the source; returns the library's path."""
    src = CSRC / f'{name}.cu'
    out = BUILD / f'lib{name}.so'
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    BUILD.mkdir(exist_ok=True)
    tmp = BUILD / f'lib{name}.{os.getpid()}.so'
    cmd = [nvcc_path(), *NVCC_FLAGS, '-o', str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}) building '
                           f'{src}:\n{proc.stdout}{proc.stderr}')
    (BUILD / f'lib{name}.log').write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a stub
    return out


def load(name):
    """Build if needed and load ``lib<name>.so``."""
    return ctypes.CDLL(str(build(name)))
