from .dynamics import System, LTI, LTV, NLS  # noqa: F401
from .ekf import EKF  # noqa: F401
from .ukf import UKF  # noqa: F401
from .pf import PF  # noqa: F401
from .imu_preintegrator import IMUPreintegrator  # noqa: F401
from .lqr import LQR  # noqa: F401
from .mpc import MPC  # noqa: F401
from .pnp import EPnP  # noqa: F401
from .icp import ICP  # noqa: F401
from .loss import GeodesicLoss, geodesic_loss  # noqa: F401
from .filtering import rollout as filter_rollout  # noqa: F401

__all__ = ['System', 'LTI', 'LTV', 'NLS', 'EKF', 'UKF', 'PF',
           'IMUPreintegrator', 'LQR', 'MPC', 'EPnP', 'ICP', 'GeodesicLoss',
           'geodesic_loss', 'filter_rollout']
