"""Ops of the port: layers, normalizers, initializers, the ConvGRU and
ConvLSTM cells and the hand-written CUDA kernels (`ops.kernels`)."""
