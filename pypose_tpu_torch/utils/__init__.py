from .stepper import ReduceToBason, _Stepper  # noqa: F401
from .collect_env import collect_env, get_pretty_env_info
from . import checkpoint
from .timer import Timer

__all__ = ['ReduceToBason', 'collect_env', 'get_pretty_env_info',
           'checkpoint', 'Timer']
