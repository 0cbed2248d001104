"""Spatial domain decomposition of the filter.

PyTorch-port counterpart of ``gcm_filters_tpu/parallel``. Over a named
``torch.distributed`` ``DeviceMesh`` the (y, x) field is sharded and the
Chebyshev recurrence runs in wide-halo rounds, one halo exchange (halo.py) per
round and the local step kernel (ops/cuda/local_pass.py for scalars,
ops/cuda/vec_local_pass.py for (u, v) pairs) on the halo-extended block in
between (sharded.py). Over a :class:`ResidentMesh`, several y-shards held on
one device, the ring engine (ring.py) runs every step as one launch of a
kernel that exchanges the halo rows itself (ops/cuda/ring_pass.py).
"""
from .ring import ResidentMesh, make_ring_scalar_apply, make_ring_vector_apply, ring_enabled
from .sharded import make_sharded_scalar_apply, make_sharded_vector_apply

__all__ = [
    "ResidentMesh",
    "make_ring_scalar_apply",
    "make_ring_vector_apply",
    "make_sharded_scalar_apply",
    "make_sharded_vector_apply",
    "ring_enabled",
]
