"""deep_rl_grasping_tpu_torch — the PyTorch/CUDA port of deep_rl_grasping_tpu.

A second package beside the JAX one. Plain tensor code is PyTorch; the two
hot kernels of the evaluation path (the contact-solver substep loop and the
depth/segmentation ray-caster) are hand-written CUDA C++ under `csrc/`,
compiled with plain `nvcc` at first use and bound with `ctypes`
(`ops/build.py`). Every kernel has a plain PyTorch version beside it, which
is what runs for tensors on the CPU.

The package imports nothing of JAX, Flax, Optax, PyYAML or the JAX package.
"""

__version__ = "0.1.0"
