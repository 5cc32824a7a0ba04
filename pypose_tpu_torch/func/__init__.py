from .jac import jacrev, jacfwd

__all__ = ['jacrev', 'jacfwd']
