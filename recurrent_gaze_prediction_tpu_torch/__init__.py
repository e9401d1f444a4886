"""recurrent_gaze_prediction_tpu_torch: the PyTorch/CUDA port of
recurrent_gaze_prediction_tpu, for one NVIDIA H100.

It imports torch, numpy and the standard library only (never jax, never the
JAX package), keeps the JAX package's module names and public layouts
(NHWC activations, HWIO kernels, [B,T,1024,7,7] features), and runs its
entry points on the card unless the caller passes device="cpu".

  config    — the port's copy of the config dataclasses
  ops       — layers, normalizers, initializers, the ConvGRU, ConvLSTM
              and flat GRU cells, and the hand-written CUDA kernels
              (ops.kernels, sources in csrc/): the ConvGRU forward
              recurrence and its two backward kernels, with the autograd
              Functions the trainer runs, and the ConvLSTM forward
              recurrence
  models    — the ten gaze model families of the JAX registry as
              nn.Modules, ShallowNet, the C3D tower, the raw-video
              pipeline, and the carried-state streaming steps
  registry  — name -> model
  bridge    — weights and optimizer moments from the JAX package's trees
  data      — clip datasets, the synthetic corpus, the CRC / Hollywood2
              loader, gazemap preprocessing, seq chunking and the `.c3d`
              codec (numpy copies), video frames and the attention frames
              (torch), and the host-to-device batch copy and its prefetch
              thread
  action    — the Hollywood2 action classifier over gaze-attended C3D
              features and its record shards
  train     — optimizer, train/eval steps, fit loops, checkpoints, metrics,
              ShallowNet pretraining
  eval      — the saliency metrics batched on the device, the NumPy
              protocol, the evaluator, the checkpoint sweep, visualization
  serving   — bundles, the dynamic batcher and the HTTP server
  cli       — serve, train_gaze, train_fused, evaluate_gaze,
              pretrain_shallownet, process_gazemap, extract_features,
              extract_map, create_records, action_classification
"""

__version__ = "0.1.0"
