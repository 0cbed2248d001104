"""The user-facing ``Filter`` class.

PyTorch-port counterpart of ``gcm_filters_tpu/filter.py``: the same
constructor arguments, validation order, error messages and warnings,
``.apply`` on arrays, tensors and dicts of them (scalar grids),
``.apply_to_vector`` on (u, v) pairs (vector grids), and the host chunk loops
``.apply_streamed`` and ``.apply_to_vector_streamed``. ``device`` (default
the CUDA card) replaces the JAX package's ``use_pallas``: on ``cuda`` every
step runs the hand-written kernel, on ``cpu`` its plain PyTorch version.
There is no switch that turns the kernel off, and no silent move to the CPU
when no card is present.

Inputs have the spatial dims last (``(..., y, x)``, latitude first); leading
dims are batched. ``apply`` and ``apply_to_vector`` return tensors on
``device``; the streamed methods return numpy arrays.

Not ported yet (see ROADMAP.md): the xarray adapter, ``plot_shape``,
``grid_ds``, ``mesh`` sharding and ``custom_operator``.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import field as dc_field
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .engine import _compute_dtype
from .filter_spec import FilterShape, compute_filter_spec, compute_n_steps_default
from .models.grids import GridType, is_area_weighted, is_vector_grid, required_grid_vars
from .ops.cuda.dispatch import make_cuda_scalar_apply, make_cuda_vector_apply
from .ops.laplacians import build_operator


def _validate_dims(dims):
    """Normalize/validate the `dims` argument (two spatial dim names)."""
    if dims is None:
        return None
    dims = tuple(dims)
    if len(dims) != 2:
        raise ValueError("`dims` must name exactly two spatial dimensions")
    return dims


def _read_chunk(a, lead, start: int, stop: int) -> np.ndarray:
    """Entries ``start:stop`` of the flattened leading dims ``lead`` of the
    array-like ``a``, as one numpy array."""
    if len(lead) == 1:
        # one contiguous range read per chunk: the access pattern a chunked
        # store serves best
        return np.asarray(a[start:stop])
    idx = np.unravel_index(np.arange(start, stop), lead)
    return np.stack([np.asarray(a[tuple(i[j] for i in idx)]) for j in range(stop - start)])


@dataclasses.dataclass
class Filter:
    """A diffusion-based smoothing filter for gridded data.

    Parameters
    ----------
    filter_scale : float
        The filter scale (meaning depends on the filter shape).
    dx_min : float
        The smallest grid spacing, in the same units as ``filter_scale``.
    filter_shape : FilterShape
        GAUSSIAN -- target response exp(-(k filter_scale)^2 / 24);
        TAPER -- unity below the transition band, zero above the cutoff.
    transition_width : float
        Nondimensional width of the TAPER transition region (> 1).
    ndim : int
        Dimensionality of the Laplacian's grid.
    n_steps : int
        Number of Chebyshev steps; 0 selects the default heuristic.
    grid_type : GridType
        Which grid discretization / Laplacian to use (9 scalar grids, 2
        vector grids).
    grid_vars : dict
        Grid variables required by ``grid_type``
        (see :func:`required_grid_vars`).
    dtype : optional torch dtype
        Inputs are cast to it first; ``None`` keeps the input's dtype. The
        filter computes in float64 for float64 inputs, else in float32.
    device : optional torch device or str
        Where the filter runs; ``None`` means ``torch.device("cuda")``.
    exact_nan : bool
        Keep the per-step NaN scrub of wet cells in the kernel instead of
        the h-space elimination (see ops/cuda/dispatch.py).
    """

    filter_scale: float
    dx_min: float
    filter_shape: FilterShape = FilterShape.GAUSSIAN
    transition_width: float = np.pi
    ndim: int = 2
    n_steps: int = 0
    grid_type: GridType = GridType.REGULAR
    grid_vars: dict = dc_field(default_factory=dict, repr=False)
    dtype: Optional[torch.dtype] = None
    device: Optional[Union[str, torch.device]] = None
    exact_nan: bool = False

    def __post_init__(self):
        # An unknown grid type is a KeyError before any other validation.
        if not isinstance(self.grid_type, GridType):
            raise KeyError(self.grid_type)
        # Fixed-factor (area-weighted) filtering happens on the unit-spacing
        # transformed grid, so dx_min must be 1.
        if is_area_weighted(self.grid_type) and self.dx_min != 1:
            raise ValueError(
                "Provided Laplacian is for simple fixed factor filtering, "
                "where transformed field is filtered on a regular grid with "
                "dx = dy = 1. dx_min must be set to 1."
            )

        if self.transition_width <= 1:
            raise ValueError("Transition width must be > 1.")

        if self.ndim > 2:
            if self.n_steps < 3:
                raise ValueError("When ndim > 2, you must set n_steps manually")
            n_steps_default = self.n_steps  # no default heuristic beyond 2-D
        else:
            n_steps_default = compute_n_steps_default(
                self.ndim,
                self.filter_shape,
                self.filter_scale,
                self.dx_min,
                self.transition_width,
            )

        if self.n_steps < 3:
            self.n_steps = n_steps_default

        if self.n_steps < n_steps_default:
            warnings.warn(
                "You have set n_steps below the default. Results might not be accurate.",
                stacklevel=2,
            )

        self.filter_spec = compute_filter_spec(
            self.filter_scale,
            self.dx_min,
            self.filter_shape,
            self.transition_width,
            self.ndim,
            self.n_steps,
        )

        # Build the grid operator (validates grid_vars names and physics).
        self.operator = build_operator(self.grid_type, self.grid_vars)
        self._is_vector = is_vector_grid(self.grid_type)
        self.device = torch.device("cuda" if self.device is None else self.device)
        self._scalar = None
        self._vector = None

    def _scalar_fn(self):
        if self._scalar is None:
            self._scalar = make_cuda_scalar_apply(
                self.operator, self.filter_spec, exact_nan=self.exact_nan
            )
        return self._scalar

    def _vector_fn(self):
        if self._vector is None:
            self._vector = make_cuda_vector_apply(self.operator, self.filter_spec)
        return self._vector

    def _operator_name(self) -> str:
        return str(self.grid_type)

    def _coerce(self, arr) -> torch.Tensor:
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Filter runs on the CUDA card by default, but torch finds no "
                "CUDA device. Pass device='cpu' to run the plain PyTorch "
                "version on the CPU."
            )
        x = torch.as_tensor(arr)
        if self.dtype is not None:
            x = x.to(self.dtype)
        return x.to(self.device)

    def apply(self, ds, dims: Optional[Sequence[str]] = None):
        """Filter data with a scalar Laplacian.

        Parameters
        ----------
        ds : array, tensor, or dict of them
            Data to filter. Arrays must have the spatial dims last, latitude
            first among them (``(..., y, x)``); leading dims are batched.
            For dicts every variable carrying both spatial dims is
            filtered; everything else passes through unchanged.
        dims : sequence of str, optional
            Names of the two spatial dimensions (dict entries given as
            ``(array, dims)`` pairs only). Latitude first.
        """
        if self._is_vector:
            raise ValueError(
                f"Provided Laplacian {self._operator_name()} is a vector Laplacian. "
                "The ``.apply`` method is only suitable for scalar Laplacians."
            )
        if isinstance(ds, dict):
            return self._apply_dict(ds, dims)
        return self._scalar_fn()(self._coerce(ds))

    def _apply_dict(self, ds: Dict, dims: Optional[Sequence[str]] = None):
        """Dataset-analogue semantics on a plain dict of arrays.

        Entries may be plain arrays or ``(array, dims_tuple)`` pairs naming
        each array's dimensions. With ``dims`` (the two spatial dim names),
        named entries are selected by *dimension names*: filtered iff they
        carry both names, which must be the trailing two dims in order
        (latitude first). Plain arrays are selected by trailing shape against
        the grid's spatial shape. Grids without 2-D grid variables (e.g.
        REGULAR) carry no intrinsic shape; if plain entries then disagree on
        their trailing 2-D shape, selection would silently depend on dict
        insertion order, so that case raises -- name the dims instead.
        """
        named = {}
        plain = {}
        for key, var in ds.items():
            if (
                isinstance(var, tuple)
                and len(var) == 2
                and not np.isscalar(var[0])
                and isinstance(var[1], (tuple, list))
                and all(isinstance(d, str) for d in var[1])
            ):
                named[key] = var
            else:
                plain[key] = var
        if named and dims is None:
            raise ValueError(
                "Dict entries with named dims ((array, dims) pairs) require "
                "the `dims` argument naming the two spatial dimensions."
            )
        dims = _validate_dims(dims)

        ny_nx = self._spatial_shape()
        if ny_nx is None:
            shapes = {
                tuple(np.shape(v)[-2:])
                for v in plain.values()
                if np.ndim(v) >= 2
            }
            if len(shapes) > 1:
                raise ValueError(
                    f"Ambiguous dict input: variables have multiple distinct "
                    f"trailing 2-D shapes {sorted(shapes)} and grid type "
                    f"{self.grid_type} carries no grid variables to "
                    f"disambiguate. Pass entries as (array, dims) pairs with "
                    f"the `dims` argument to name the spatial dimensions."
                )
            ny_nx = shapes.pop() if shapes else None

        filtered = {}
        any_filtered = False
        for key, var in ds.items():
            if key in named:
                arr, var_dims = named[key]
                var_dims = tuple(var_dims)
                if all(d in var_dims for d in dims):
                    if var_dims[-2:] != dims:
                        raise ValueError(
                            f"Variable {key!r} has spatial dims {dims} but "
                            f"not as its trailing two dimensions in order "
                            f"(latitude first); transpose it to "
                            f"(..., {dims[0]}, {dims[1]})."
                        )
                    # keep the (array, dims) form so the output dict can
                    # round-trip through .apply with its dims metadata intact
                    filtered[key] = (self._scalar_fn()(self._coerce(arr)), var_dims)
                    any_filtered = True
                else:
                    filtered[key] = (arr, var_dims)
                continue
            arr = var if torch.is_tensor(var) else np.asarray(var)
            if arr.ndim >= 2 and tuple(arr.shape[-2:]) == ny_nx:
                if named:
                    # A bare array selected only by a coincidental trailing
                    # shape while other entries name their dims: warn.
                    warnings.warn(
                        f"Variable {key!r} is selected for filtering only "
                        f"because its trailing shape matches the grid "
                        f"{ny_nx}. Other entries name their dims "
                        f"explicitly; pass {key!r} as an (array, dims) "
                        f"pair too so selection is by dimension names, "
                        f"not coincidental shape.",
                        stacklevel=2,
                    )
                filtered[key] = self._scalar_fn()(self._coerce(arr))
                any_filtered = True
            else:
                filtered[key] = var
        if not any_filtered:
            warnings.warn(
                "No variables in the dataset had all of the given "
                "dimensions, so nothing was filtered.",
                stacklevel=2,
            )
        return filtered

    def _spatial_shape(self) -> Optional[Tuple[int, int]]:
        for name in required_grid_vars(self.grid_type):
            v = self.grid_vars.get(name)
            if v is not None and np.ndim(v) >= 2:
                return tuple(np.shape(v)[-2:])
        return None

    def apply_to_vector(self, ufield, vfield, dims: Optional[Sequence[str]] = None):
        """Filter a vector field (u, v) with a vector Laplacian.

        ``ufield`` and ``vfield`` are arrays or tensors of equal shape with
        the spatial dims last, latitude first (``(..., y, x)``); leading dims
        are batched. Returns the filtered pair as tensors on ``device``.
        ``dims`` is accepted for the JAX package's signature; plain arrays
        carry no dim names, so it is not read.
        """
        if not self._is_vector:
            raise ValueError(
                f"Provided Laplacian {self._operator_name()} is a scalar Laplacian. "
                "The ``.apply_to_vector`` method is only suitable for vector Laplacians."
            )
        return self._vector_fn()(self._coerce(ufield), self._coerce(vfield))

    def _empty_dtype(self, *arrays) -> np.dtype:
        """The result dtype of an empty batch: what a non-empty one returns."""
        def torch_dtype(a):
            d = getattr(a, "dtype", np.float64)
            return d if isinstance(d, torch.dtype) else torch.from_numpy(np.zeros(0, d)).dtype

        dtypes = [self.dtype] if self.dtype is not None else [torch_dtype(a) for a in arrays]
        return torch.empty(0, dtype=_compute_dtype(*dtypes)).numpy().dtype

    def apply_streamed(self, data, chunk: int = 16):
        """Filter an out-of-core batch by streaming leading-dim chunks.

        ``data`` may be any array-like (numpy, memory-mapped, zarr array) with
        shape ``(batch..., y, x)`` too large for device memory; chunks of
        ``chunk`` slices are moved to ``device``, filtered, and returned as
        one numpy array.
        """
        if self._is_vector:
            raise ValueError(
                f"Provided Laplacian {self._operator_name()} is a vector Laplacian. "
                "The ``.apply_streamed`` method is only suitable for scalar Laplacians."
            )
        shape = tuple(data.shape)
        if len(shape) < 3:
            return self.apply(np.asarray(data)).cpu().numpy()
        lead = shape[:-2]
        n = int(np.prod(lead))
        if n == 0:
            return np.empty(shape, dtype=self._empty_dtype(data))
        fn = self._scalar_fn()
        out = None
        for start in range(0, n, chunk):
            stop = min(start + chunk, n)
            res = fn(self._coerce(_read_chunk(data, lead, start, stop))).cpu().numpy()
            if out is None:
                out = np.empty(shape, dtype=res.dtype)
            out.reshape((n,) + shape[-2:])[start:stop] = res
        return out

    def apply_to_vector_streamed(self, ufield, vfield, chunk: int = 16):
        """Filter an out-of-core (u, v) batch by streaming leading-dim chunks.

        Vector twin of :meth:`apply_streamed`: ``ufield`` and ``vfield`` are
        array-likes of equal shape ``(batch..., y, x)``; chunks of ``chunk``
        slice pairs are moved to ``device``, filtered, and returned as two
        numpy arrays.
        """
        if not self._is_vector:
            raise ValueError(
                f"Provided Laplacian {self._operator_name()} is a scalar Laplacian. "
                "The ``.apply_to_vector_streamed`` method is only suitable "
                "for vector Laplacians."
            )
        shape = tuple(ufield.shape)
        if tuple(vfield.shape) != shape:
            raise ValueError(
                "ufield and vfield must have the same shape; got "
                f"{shape} and {tuple(vfield.shape)}"
            )
        if len(shape) < 3:
            fu, fv = self.apply_to_vector(np.asarray(ufield), np.asarray(vfield))
            return fu.cpu().numpy(), fv.cpu().numpy()
        lead = shape[:-2]
        n = int(np.prod(lead))
        if n == 0:
            dtype = self._empty_dtype(ufield, vfield)
            return np.empty(shape, dtype=dtype), np.empty(shape, dtype=dtype)
        fn = self._vector_fn()
        out_u = out_v = None
        for start in range(0, n, chunk):
            stop = min(start + chunk, n)
            ru, rv = fn(self._coerce(_read_chunk(ufield, lead, start, stop)),
                        self._coerce(_read_chunk(vfield, lead, start, stop)))
            ru, rv = ru.cpu().numpy(), rv.cpu().numpy()
            if out_u is None:
                out_u = np.empty(shape, dtype=ru.dtype)
                out_v = np.empty(shape, dtype=rv.dtype)
            out_u.reshape((n,) + shape[-2:])[start:stop] = ru
            out_v.reshape((n,) + shape[-2:])[start:stop] = rv
        return out_u, out_v
