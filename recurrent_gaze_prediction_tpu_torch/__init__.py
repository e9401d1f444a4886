"""recurrent_gaze_prediction_tpu_torch: the PyTorch/CUDA port of
recurrent_gaze_prediction_tpu, for one NVIDIA H100.

It imports torch, numpy and the standard library only (never jax, never the
JAX package), keeps the JAX package's module names and public layouts
(NHWC activations, HWIO kernels, [B,T,1024,7,7] features), and runs its
entry points on the card unless the caller passes device="cpu".

  config    — the port's copy of the config dataclasses
  ops       — layers, normalizers, initializers, the ConvGRU cell, and the
              hand-written CUDA kernels (ops.kernels, sources in csrc/)
  models    — gaze_grcn and gaze_grcn77 as nn.Modules
  registry  — name -> model
  bridge    — weights to and from the JAX package's parameter trees
  serving   — bundles, the dynamic batcher and the HTTP server
"""

__version__ = "0.1.0"
