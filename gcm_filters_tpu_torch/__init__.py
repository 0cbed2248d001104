"""gcm_filters_tpu_torch: the PyTorch / CUDA port of gcm_filters_tpu.

Diffusion-based spatial filtering of gridded GCM data on an NVIDIA GPU. The
package mirrors ``gcm_filters_tpu`` module for module; the JAX package stays
the reference that the port is tested against, and the port imports none of
it (nor JAX).

Public API:
  - ``Filter``             -- the user-facing filter class: ``apply`` for the
    9 scalar grids, ``apply_to_vector`` for the 2 vector grids, and their
    streamed twins (``device`` picks the card, default ``cuda``;
    ``device="cpu"`` runs the plain PyTorch versions of the kernels;
    ``mesh``/``spatial_axes`` shard scalar and vector filtering over a
    ``DeviceMesh``, or over a ``ResidentMesh`` through the ring engine), plus
    ``plot_shape`` and ``grid_ds``
  - ``ResidentMesh``       -- several y-shards held on one device, the mesh
    of the ring engine (parallel/ring.py)
  - ``BaseScalarOperator``, ``BaseVectorOperator`` -- bases for free-form
    ``Filter(custom_operator=...)`` operators
  - ``FilterShape``        -- GAUSSIAN | TAPER target shapes
  - ``GridType``           -- the 11 grid discretizations
  - ``required_grid_vars`` -- grid-variable introspection per grid type
"""

from .models.grids import GridType, required_grid_vars
from .filter_spec import FilterShape, FilterSpec, filter_params
from .filter import Filter
from .ops.custom import BaseScalarOperator, BaseVectorOperator
from .parallel.ring import ResidentMesh

__version__ = "0.1.0"

__all__ = [
    "Filter",
    "BaseScalarOperator",
    "BaseVectorOperator",
    "FilterShape",
    "FilterSpec",
    "GridType",
    "ResidentMesh",
    "required_grid_vars",
    "filter_params",
    "__version__",
]
