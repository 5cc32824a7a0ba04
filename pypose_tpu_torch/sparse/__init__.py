from .ops import (BSR, BSC, dense_to_bsr, dense_to_bsc, bsr_to_dense,  # noqa: F401
                  bsr_bsc_matmul, bsr_matvec, _sparse_csr_mm)

__all__ = ['BSR', 'BSC', 'dense_to_bsr', 'dense_to_bsc', 'bsr_to_dense',
           'bsr_bsc_matmul', 'bsr_matvec']
