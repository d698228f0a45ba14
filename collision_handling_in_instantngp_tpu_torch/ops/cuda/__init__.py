"""The port's CUDA kernels (K1-K6, K8-K12) and their plain versions."""
