"""Functional core: encodings, rays, sampling, compositing."""

from dexnerf_tpu_torch.core.encoding import (
    encoding_dim,
    frequency_bands,
    positional_encoding,
)
from dexnerf_tpu_torch.core.rays import (
    get_ray_bundle_c2w,
    get_ray_bundle_w2c,
    ndc_rays,
    ndc_t_to_world_depth,
    pixel_grid,
)
from dexnerf_tpu_torch.core.sampling import (
    hierarchical_z_vals,
    linspace,
    sample_pdf,
    stratified_z_vals,
    weights_to_cdf,
)
from dexnerf_tpu_torch.core.volrend import (
    VolumeRenderOutputs,
    composite,
    concat_outputs,
    cumprod_exclusive,
    depth_confidence,
    ray_dists,
    sigma_threshold_depth,
    sigma_to_weights,
    volume_render_radiance_field,
)

__all__ = [
    "VolumeRenderOutputs",
    "composite",
    "concat_outputs",
    "cumprod_exclusive",
    "depth_confidence",
    "encoding_dim",
    "frequency_bands",
    "get_ray_bundle_c2w",
    "get_ray_bundle_w2c",
    "hierarchical_z_vals",
    "linspace",
    "ndc_rays",
    "ndc_t_to_world_depth",
    "pixel_grid",
    "positional_encoding",
    "ray_dists",
    "sample_pdf",
    "sigma_threshold_depth",
    "sigma_to_weights",
    "stratified_z_vals",
    "volume_render_radiance_field",
    "weights_to_cdf",
]
