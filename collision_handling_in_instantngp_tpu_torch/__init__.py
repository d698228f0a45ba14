"""PyTorch / CUDA port of collision_handling_in_instantngp_tpu for NVIDIA
Hopper (H100).

A package of its own beside the JAX one: it imports torch and numpy, never
jax nor the JAX package. The GNGF training path at scaled geometry runs its
index network on four hand-written CUDA kernels (``ops/cuda/``); every
kernel has a plain PyTorch version beside it that the CPU path and the tests
use.
"""

from .config import ExperimentConfig, ModelConfig, experiment_from_grid_id  # noqa: F401
