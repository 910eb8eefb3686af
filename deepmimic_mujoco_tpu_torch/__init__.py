"""deepmimic_mujoco_tpu_torch: the PyTorch/CUDA port of deepmimic_mujoco_tpu.

The same rigid-body physics, imitation env and policy as the JAX
package, written batch-major in PyTorch for an NVIDIA H100. The fused
mass-matrix and constraint solve is a hand-written CUDA kernel
(``ops/csrc/fused_solve.cu``), built with nvcc at first use and bound
with ctypes. On CPU tensors every kernel wrapper takes its plain torch
version, which is what the tests run.

The package imports torch, numpy and the standard library only; it
never imports JAX or the JAX package. Assets are read in place from
``deepmimic_mujoco_tpu/assets`` (see ``models/assets.py``).
"""

__version__ = "0.1.0"
