from .checking import is_lietensor, is_SE3, hasnan  # noqa: F401
from .geometry import (  # noqa: F401
    KNNResult, cart2homo, homo2cart, point2pixel, pixel2point, reprojerr,
    knn, svdtf, svdstf, nbr_filter, random_filter, voxel_filter, knn_filter)
from .linalg import bvv, bmv, bvmv  # noqa: F401
