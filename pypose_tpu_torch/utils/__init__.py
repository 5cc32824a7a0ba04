from .stepper import ReduceToBason, _Stepper  # noqa: F401
