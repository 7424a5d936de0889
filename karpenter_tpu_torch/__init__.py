"""PyTorch/CUDA port of the provisioning solver.

The package mirrors ``karpenter_tpu``'s layout (``api``, ``cloudprovider``,
``solver``) and keeps its own copies of the modules it needs: it imports
``torch`` and numpy, never ``jax`` and nothing of the JAX package. The
packing kernels are hand-written CUDA C++ for Hopper
(``solver/csrc/pack_solve.cu``), built with nvcc at first use; each has a
plain PyTorch version beside it in ``solver/torch_solver.py``.
"""
