"""turbo_tpu_torch: the batched FlatZinc solver in PyTorch with hand-written
CUDA kernels for Hopper (sm_90a). The JAX package ``turbo_tpu`` is its
reference; the host layers are shared through ``turbo_tpu_torch.host``."""
__version__ = "0.1.0"
