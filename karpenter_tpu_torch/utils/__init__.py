"""Utilities of the port: copies of the parts of ``karpenter_tpu/utils``
that the solver needs."""
