"""Spatial domain decomposition over a ``torch.distributed`` device mesh.

PyTorch-port counterpart of ``gcm_filters_tpu/parallel``: the (y, x) field is
sharded over a named ``DeviceMesh`` and the Chebyshev recurrence runs in
wide-halo rounds, one halo exchange (halo.py) per round and the local step
kernel (ops/cuda/local_pass.py for scalars, ops/cuda/vec_local_pass.py for
(u, v) pairs) on the halo-extended block in between (sharded.py).
"""
from .sharded import make_sharded_scalar_apply, make_sharded_vector_apply

__all__ = ["make_sharded_scalar_apply", "make_sharded_vector_apply"]
