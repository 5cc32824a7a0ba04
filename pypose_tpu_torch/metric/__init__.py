from .ape_rpe import (StampedSE3, matching_time_indices, associate_traj,  # noqa: F401
                      compute_error, pair_id, ape, rpe)

__all__ = ['StampedSE3', 'ape', 'rpe']
