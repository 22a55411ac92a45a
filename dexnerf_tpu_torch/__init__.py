"""dexnerf_tpu_torch — the PyTorch + CUDA port of ``dexnerf_tpu``.

A second package beside the JAX one, for NVIDIA Hopper cards. Each module
keeps the path and public names of its JAX counterpart (for example
``dexnerf_tpu_torch/core/volrend.py::volume_render_radiance_field``), and
every Pallas kernel on a ported path is a CUDA kernel written by hand under
``ops/csrc/``, with a plain PyTorch version beside it. This package never
imports JAX; only the parity tests import both.

Ported so far: the serving path (``apps/serve.py``) with Dex-NeRF
σ-threshold depth, through the fused render kernel, and single-device
training (``apps/train.py``) through the fused train-loss kernel.
"""

__version__ = "0.1.0"
