from . import (block_tridiag, knn, se3, smallinv, spmv,  # noqa: F401
               stencil_cg)
