from .checking import is_lietensor, is_SE3  # noqa: F401
from .geometry import (  # noqa: F401
    KNNResult, cart2homo, homo2cart, point2pixel, pixel2point, reprojerr,
    knn, svdtf, svdstf)
