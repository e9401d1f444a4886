"""Hand-written CUDA kernels of the port (sources in ../../csrc), their
wrappers and autograd Functions, the build, and the on-card parity checks:
`route` (which recurrence runs, decided from the shapes: the models call
it), `convgru` (forward, B1, and what the cluster kernels share),
`convgru_vjp2` (the backward's recursion, B2), `convgru_vjp` (B4's phases G
and W, B4's wrapper, and the one trainable ConvGRU Function over G, B2 and
W), `convgru_small` (the cascade's small ConvGRU forward and backward, B5),
`convgru_grid` (the cascade's wide ConvGRU forward and backward's
recursion, B6), `convlstm` (the peephole ConvLSTM forward, B3),
`conv3d_int8` (a layer of the int8 C3D tower and its int8 max pool, Q1) and
`gemm` (the dense layers' bf16 products with f32 sums, M1)."""
