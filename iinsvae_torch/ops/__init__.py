"""Plain tensor ops (pooling, norms, conv) and the CUDA kernels (kernels/)."""
