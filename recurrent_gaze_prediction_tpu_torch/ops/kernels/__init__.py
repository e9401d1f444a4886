"""Hand-written CUDA kernels of the port (sources in ../../csrc), their
wrappers, the build, and the on-card parity check."""
