from . import smallinv, spmv, stencil_cg  # noqa: F401
