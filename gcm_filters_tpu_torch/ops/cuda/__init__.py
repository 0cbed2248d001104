"""Hand-written CUDA kernels for the Chebyshev filter hot loop (Hopper, sm_90a).

  - cheb_pass.py: one scalar Chebyshev step per launch, with its plain
    PyTorch version ``cheb_pass_reference`` beside it;
  - vec_pass.py: one coupled vector step per launch (B-grid pair or C-grid
    taps), with its plain version ``vec_pass_reference`` beside it;
  - local_pass.py, vec_local_pass.py: the same steps on a halo-extended
    shard block (the sharded engine's local compute), with their plain
    versions ``local_pass_reference`` and ``vec_local_pass_reference``, and
    the fused round of each (``local_fused_pass``, ``vec_local_fused_pass``:
    several steps per launch on shared-memory tiles);
  - ring_pass.py: the same steps on all y-shards of a ring in one launch,
    the halo rows exchanged by the kernel itself, with their plain versions
    ``ring_pass_reference`` and ``vec_ring_pass_reference``, and the fused
    passes of each (``ring_fused_pass``, ``vec_ring_fused_pass``: several
    steps per launch, the halo rows sent once per pass);
  - dispatch.py: the scalar and vector filter applies built on those kernels;
  - build.py: compiles ``gcm_filters_tpu_torch/csrc/*.cu`` with nvcc at first
    use and loads the shared libraries with ctypes.
"""
from .dispatch import make_cuda_scalar_apply, make_cuda_vector_apply

__all__ = ["make_cuda_scalar_apply", "make_cuda_vector_apply"]
