r"""The native dataset tokenizers (g2o, BAL), built from source and loaded
with ctypes.

Counterpart of ``pypose_tpu/native/__init__.py:24-102``.  The package
keeps its own copy of the C++ source (``native/src/loader.cpp``), which
``g++ -O2 -shared -fPIC -std=c++17`` compiles at first use into
``pypose_tpu_torch/_build/libppt_loader.so`` (listed in ``.gitignore``),
again when the source is newer.  A missing compiler, a failed build, an
unreadable file or a malformed one raises: there is no fallback on the
load path.  :func:`parse_g2o_plain` and :func:`parse_bal_plain` are the
plain Python parses the native ones are held against; both give the same
numpy arrays, float64 values and int64 indices.
"""

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..ops._build import BUILD

SRC = Path(__file__).resolve().parent / 'src' / 'loader.cpp'
LIB = BUILD / 'libppt_loader.so'
CXX_FLAGS = ['-O2', '-shared', '-fPIC', '-std=c++17']

_lib = None


def build():
    """Compile ``loader.cpp`` into ``_build/libppt_loader.so`` if the
    library is missing or older than the source; returns its path."""
    if LIB.exists() and LIB.stat().st_mtime >= SRC.stat().st_mtime:
        return LIB
    cxx = shutil.which('g++')
    if cxx is None:
        raise RuntimeError('g++ not found on PATH: it is needed to build '
                           f'{SRC}')
    BUILD.mkdir(exist_ok=True)
    tmp = BUILD / f'libppt_loader.{os.getpid()}.so'
    proc = subprocess.run([cxx, *CXX_FLAGS, '-o', str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'g++ failed ({proc.returncode}) building {SRC}:'
                           f'\n{proc.stdout}{proc.stderr}')
    # atomic: a concurrent loader never sees a partial library
    os.replace(tmp, LIB)
    return LIB


def get_lib():
    """Build if needed, load, and declare the C functions."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    i64p = ctypes.POINTER(ctypes.c_int64)
    vp = ctypes.c_void_p
    lib.ppt_g2o_parse.restype = vp
    lib.ppt_g2o_parse.argtypes = [ctypes.c_char_p, i64p, i64p,
                                  ctypes.POINTER(ctypes.c_int)]
    lib.ppt_g2o_copy.restype = None
    lib.ppt_g2o_copy.argtypes = [vp] * 6
    lib.ppt_g2o_free.restype = None
    lib.ppt_g2o_free.argtypes = [vp]
    lib.ppt_bal_parse.restype = vp
    lib.ppt_bal_parse.argtypes = [ctypes.c_char_p, i64p, i64p, i64p,
                                  ctypes.POINTER(ctypes.c_int)]
    lib.ppt_bal_copy.restype = None
    lib.ppt_bal_copy.argtypes = [vp] * 6
    lib.ppt_bal_free.restype = None
    lib.ppt_bal_free.argtypes = [vp]
    _lib = lib
    return lib


def _ptr(arr):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _parse(kind, path, n_sizes):
    lib = get_lib()
    sizes = [ctypes.c_int64() for _ in range(n_sizes)]
    err = ctypes.c_int()
    handle = getattr(lib, f'ppt_{kind}_parse')(
        os.fsencode(path), *[ctypes.byref(s) for s in sizes],
        ctypes.byref(err))
    if not handle:
        what = 'cannot read' if err.value == -1 else 'malformed'
        raise ValueError(f'{kind} parse: {what}: {path}')
    return lib, handle, [s.value for s in sizes]


def parse_g2o(path):
    """Native g2o parse -> (vertex_ids [N], vertices [N, 7], edges [E, 2],
    measures [E, 7], infos [E, 21] upper-triangular, row-major)."""
    lib, h, (V, E) = _parse('g2o', path, 2)
    out = (np.empty(V, np.int64), np.empty((V, 7)), np.empty((E, 2),
                                                              np.int64),
           np.empty((E, 7)), np.empty((E, 21)))
    try:
        lib.ppt_g2o_copy(h, *[_ptr(a) for a in out])
    finally:
        lib.ppt_g2o_free(h)
    return out


def parse_bal(path):
    """Native BAL parse -> (cam_idx [O], pt_idx [O], pixels [O, 2],
    cameras [C, 9], points [P, 3])."""
    lib, h, (C, P, O) = _parse('bal', path, 3)
    out = (np.empty(O, np.int64), np.empty(O, np.int64), np.empty((O, 2)),
           np.empty((C, 9)), np.empty((P, 3)))
    try:
        lib.ppt_bal_copy(h, *[_ptr(a) for a in out])
    finally:
        lib.ppt_bal_free(h)
    return out


def parse_g2o_plain(path):
    """The plain Python parse of :func:`parse_g2o` (the JAX package's
    fallback, ``pypose_tpu/datasets.py:120-139``): the same arrays."""
    vids, verts, edges, meas, infos = [], [], [], [], []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == 'VERTEX_SE3:QUAT':
                vids.append(int(tok[1]))
                verts.append([float(x) for x in tok[2:9]])
            elif tok[0] == 'EDGE_SE3:QUAT':
                edges.append([int(tok[1]), int(tok[2])])
                meas.append([float(x) for x in tok[3:10]])
                infos.append([float(x) for x in tok[10:31]])
    return (np.asarray(vids, np.int64), np.asarray(verts).reshape(-1, 7),
            np.asarray(edges, np.int64).reshape(-1, 2),
            np.asarray(meas).reshape(-1, 7),
            np.asarray(infos).reshape(-1, 21))


def parse_bal_plain(path):
    """The plain Python parse of :func:`parse_bal`
    (``pypose_tpu/datasets.py:171-182``): the same arrays."""
    with open(path) as f:
        it = iter(f.read().split())
    C, P, O = int(next(it)), int(next(it)), int(next(it))
    cam_idx = np.empty(O, np.int64)
    pt_idx = np.empty(O, np.int64)
    pixels = np.empty((O, 2))
    for o in range(O):
        cam_idx[o] = int(next(it))
        pt_idx[o] = int(next(it))
        pixels[o] = (float(next(it)), float(next(it)))
    cams = np.array([float(next(it)) for _ in range(9 * C)]).reshape(C, 9)
    points = np.array([float(next(it)) for _ in range(3 * P)]).reshape(P, 3)
    return cam_idx, pt_idx, pixels, cams, points
