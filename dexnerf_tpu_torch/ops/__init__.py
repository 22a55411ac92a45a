"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version beside it. Kernels are built at first use, never at import.

Modules: ``fused_render`` (the fused render pass and its launch counter,
``dexnerf_tpu_torch.ops.fused_render.launches``), ``fused_train_loss``
(the fused train-loss pass, ``...fused_train_loss.launches``), ``_build``
(nvcc + ctypes loader)."""
