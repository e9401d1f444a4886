"""Ops of the port: layers, normalizers, initializers, the ConvGRU cell and
the hand-written CUDA kernels (`ops.kernels`)."""
