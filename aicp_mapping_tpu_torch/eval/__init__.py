from .kitti import (  # noqa: F401
    ate_rmse,
    average_errors,
    calc_sequence_errors,
    rpe,
    trajectory_distances,
    umeyama_alignment,
)
