from .checking import is_lietensor, is_SE3  # noqa: F401
from .geometry import KNNResult, knn, svdtf, svdstf  # noqa: F401
