from .icp import ICP  # noqa: F401
