"""Hand-written CUDA kernels of the port (sources in ../../csrc), their
wrappers and autograd Functions, the build, and the on-card parity checks:
`convgru` (forward, B1), `convgru_vjp2` (backward stage 2, B2, the default
train path), `convgru_vjp` (monolithic backward, B4), `convlstm` (the
peephole ConvLSTM forward, B3) and `conv3d_int8` (a layer of the int8 C3D
tower and its int8 max pool, Q1)."""
