"""Camera-path helpers (the dataset loaders are not ported yet)."""

from dexnerf_tpu_torch.data.blender import (
    pose_spherical,
    rotate_phi_x,
    rotate_theta_y,
    translate_z,
)

__all__ = ["pose_spherical", "rotate_phi_x", "rotate_theta_y", "translate_z"]
