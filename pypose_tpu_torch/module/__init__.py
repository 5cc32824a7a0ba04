from .icp import ICP  # noqa: F401
from .imu_preintegrator import IMUPreintegrator  # noqa: F401
