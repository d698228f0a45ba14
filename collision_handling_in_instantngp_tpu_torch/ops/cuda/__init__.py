"""Kernels (K1-K3) and their plain versions."""
