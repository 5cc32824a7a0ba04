from . import knn, se3, smallinv, spmv, stencil_cg  # noqa: F401
