from .sparse import (  # noqa: F401
    Factor, SparseLM, pgo_factor, split_chain_edges)
from .solver import PINV, LSTSQ, Cholesky, CG, PCG  # noqa: F401
from .strategy import Adaptive, Constant, TrustRegion  # noqa: F401
from . import ba  # noqa: F401
from .ba import BundleAdjustment  # noqa: F401
from . import kernel  # noqa: F401
