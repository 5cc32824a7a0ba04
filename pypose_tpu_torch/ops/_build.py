r"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles alone into
``_build/lib<name>.so`` (listed in ``.gitignore``) at first use, for
``sm_90a`` (H100).  The library is rebuilt when its source, or a shared
header ``csrc/*.cuh``, is newer.  :func:`build_all` runs one ``nvcc`` per
source, all at once.  A missing ``nvcc`` or a failed compile raises with
the compiler's output; nothing falls back.  The compiler's report (``-Xptxas -v``: registers,
shared memory, spills) is kept beside the library as ``lib<name>.log``.
:func:`bind` loads a library and declares its C functions, each of which
returns ``cudaGetLastError()``; :func:`raise_on` turns a non-zero code
into an exception.
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


def _stale(name):
    src = CSRC / f'{name}.cu'
    out = BUILD / f'lib{name}.so'
    if not out.exists():
        return True
    newest = max(p.stat().st_mtime for p in [src, *CSRC.glob('*.cuh')])
    return out.stat().st_mtime < newest


def build_all(names):
    """Compile each ``csrc/<name>.cu`` whose library is missing or older
    than its sources, in parallel nvcc processes; returns the libraries'
    paths in the order of ``names``."""
    BUILD.mkdir(exist_ok=True)
    running = {}
    for name in names:
        if name in running or not _stale(name):
            continue
        tmp = BUILD / f'lib{name}.{os.getpid()}.so'
        cmd = [nvcc_path(), *NVCC_FLAGS, '-o', str(tmp),
               str(CSRC / f'{name}.cu')]
        running[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f'nvcc failed ({proc.returncode}) building '
                          f'{CSRC / name}.cu:\n{log}')
            continue
        (BUILD / f'lib{name}.log').write_text(log)
        # atomic: a concurrent loader never sees a stub
        os.replace(tmp, BUILD / f'lib{name}.so')
    if failed:
        raise RuntimeError('\n'.join(failed))
    return [BUILD / f'lib{name}.so' for name in names]


def build(name):
    """Compile ``csrc/<name>.cu`` if needed; returns the library's path."""
    return build_all([name])[0]


def load(name):
    """Build if needed and load ``lib<name>.so``."""
    return ctypes.CDLL(str(build(name)))


def bind(name, signatures):
    """Build if needed and load ``lib<name>.so``; declare the argument
    types of each C function in ``signatures`` (name -> ctypes argtypes;
    each returns an int error code) and of ``ppt_cuda_error_string``."""
    lib = load(name)
    for fname, argtypes in signatures.items():
        fn = getattr(lib, fname)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ppt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ppt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def raise_on(lib, rc, what):
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f'{what} launch failed: '
                           + lib.ppt_cuda_error_string(rc).decode())
