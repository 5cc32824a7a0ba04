from .ops import (pm, cumops, cummul, cumprod, cumops_, cummul_,  # noqa: F401
                  cumprod_)

__all__ = ['pm', 'cumops', 'cummul', 'cumprod', 'cumops_', 'cummul_',
           'cumprod_']
