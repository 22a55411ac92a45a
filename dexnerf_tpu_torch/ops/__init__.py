"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version beside it. Kernels are built at first use, never at import.

Modules, each with its launch counter ``<module>.launches``:
``fused_render`` (the fused render pass, kernel 1), ``fused_mlp`` (the
field forward, kernel 2), ``fused_mlp_train`` (the training field, whose
backward is kernel 3), ``fused_train_loss`` (the fused train-loss pass,
kernel 4), ``resample`` (the hierarchical resample, kernel 5),
``sample_pdf`` (the inverse-CDF op, kernel 6); ``_weight_grads`` (the
f32 scratch and weight-gradient launches of kernels 3 and 4; their bf16
counterparts are ``fused_train_loss.Bf16Gradients``) and ``_build`` (nvcc
+ ctypes loader); ``host_rows``, the ray cache's host C++ gather, built
with the host compiler. Kernels 1-4 each have an f32 and a bf16 route, chosen
by ``compute_dtype``; ``launches_bf16`` counts the bf16 route's.

The names the JAX package's ``ops`` exports for kernels 2, 3 and 6 are
exported here too. No re-exported name equals a module's, so
``from dexnerf_tpu_torch.ops import fused_render`` stays the module."""

from dexnerf_tpu_torch.ops.fused_mlp import make_fused_flexible_field
from dexnerf_tpu_torch.ops.fused_mlp_train import make_fused_flexible_field_train
from dexnerf_tpu_torch.ops.sample_pdf import sample_pdf_branchless, sample_pdf_pallas

__all__ = [
    "make_fused_flexible_field",
    "make_fused_flexible_field_train",
    "sample_pdf_branchless",
    "sample_pdf_pallas",
]
