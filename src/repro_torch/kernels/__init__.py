"""Hand-written CUDA kernels for the flat-bus buckets, with their plain versions."""
