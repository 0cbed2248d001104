"""Hand-written CUDA kernels for the Chebyshev filter hot loop (Hopper, sm_90a).

  - cheb_pass.py: one scalar Chebyshev step per launch, with its plain
    PyTorch version ``cheb_pass_reference`` beside it;
  - vec_pass.py: one coupled vector step per launch (B-grid pair or C-grid
    taps), with its plain version ``vec_pass_reference`` beside it;
  - dispatch.py: the scalar and vector filter applies built on those kernels;
  - build.py: compiles ``gcm_filters_tpu_torch/csrc/*.cu`` with nvcc at first
    use and loads the shared libraries with ctypes.
"""
from .dispatch import make_cuda_scalar_apply, make_cuda_vector_apply

__all__ = ["make_cuda_scalar_apply", "make_cuda_vector_apply"]
