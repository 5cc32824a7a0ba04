from .sparse import (  # noqa: F401
    Factor, SparseLM, pgo_factor, split_chain_edges)
from .solver import PINV, LSTSQ, Cholesky, CG, PCG  # noqa: F401
from .strategy import Adaptive, Constant, TrustRegion  # noqa: F401
from . import ba  # noqa: F401
from .ba import BundleAdjustment  # noqa: F401
from . import kernel  # noqa: F401
from . import corrector, functional, implicit, scheduler  # noqa: F401
from . import solver, strategy  # noqa: F401
from .optimizer import (  # noqa: F401
    GaussNewton, GN, LevenbergMarquardt, LM, RobustModel, batch_optimize,
    make_batch_optimizer)
from .functional import modjac, modjacrev, modjacfwd  # noqa: F401
from .implicit import least_squares  # noqa: F401
