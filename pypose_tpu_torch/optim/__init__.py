from .sparse import (  # noqa: F401
    Factor, SparseLM, pgo_factor, split_chain_edges)
from .strategy import TrustRegion  # noqa: F401
