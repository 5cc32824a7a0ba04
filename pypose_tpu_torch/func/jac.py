r"""Functional Jacobians over LieTensor-valued functions.

Counterpart of ``pypose_tpu/func/jac.py``.  LieTensor is a torch pytree
node (``lietensor/lietensor.py``), so ``torch.func.jacrev`` and
``jacfwd`` take and return LieTensors with their ltype kept; these are
thin aliases.  Jacobians with respect to group-valued arguments follow
the left-perturbation convention (storage-shaped, zero tail), from the
Functions' ``backward`` (``jacrev``) and ``jvp`` (``jacfwd``) rules.
"""

import torch


def jacrev(func, argnums=0, *, has_aux=False, chunk_size=None):
    """Reverse-mode Jacobian (``torch.func.jacrev``); LieTensor inputs and
    outputs keep their ltype."""
    return torch.func.jacrev(func, argnums=argnums, has_aux=has_aux,
                             chunk_size=chunk_size)


def jacfwd(func, argnums=0, *, has_aux=False):
    """Forward-mode Jacobian (``torch.func.jacfwd``) through the
    Functions' ``jvp`` rules."""
    return torch.func.jacfwd(func, argnums=argnums, has_aux=has_aux)
