"""The benchmark of ``karpenter_tpu_torch``, the PyTorch and CUDA port: see
``README.md``."""
