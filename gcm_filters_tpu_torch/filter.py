"""The user-facing ``Filter`` class.

PyTorch-port counterpart of ``gcm_filters_tpu/filter.py``: the same
constructor arguments, validation order, error messages and warnings,
``.apply`` on arrays, tensors and dicts of them (scalar grids),
``.apply_to_vector`` on (u, v) pairs (vector grids), the host chunk loops
``.apply_streamed`` and ``.apply_to_vector_streamed``, ``.plot_shape``,
``.grid_ds``, ``custom_operator``, ``mesh`` sharding of scalar and vector
filters, and xarray objects when xarray is installed. ``device`` (default
the CUDA card) replaces the JAX package's ``use_pallas``: on ``cuda`` every
step runs the hand-written kernel, on ``cpu`` its plain PyTorch version. There is no
switch that turns the kernel off, and no silent move to the CPU when no card
is present.

Inputs have the spatial dims last (``(..., y, x)``, latitude first); leading
dims are batched. ``apply`` and ``apply_to_vector`` return tensors on
``device``; the streamed methods return numpy arrays. With a ``DeviceMesh``,
``apply`` returns a ``DTensor`` sharded over it and ``apply_to_vector`` a
pair of them (``.full_tensor()`` gathers). With a
``parallel.ring.ResidentMesh`` (several y-shards held on one device) the
ring engine runs and both return plain global tensors on ``device``.
"""
from __future__ import annotations

import dataclasses
import sys
import warnings
from dataclasses import field as dc_field
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .engine import _compute_dtype, scalar_filter_apply, vector_filter_apply
from .filter_spec import (
    FilterShape,
    TargetSpec,
    compute_filter_spec,
    compute_n_steps_default,
    target_function,
)
from .models.grids import GridType, is_area_weighted, is_vector_grid, required_grid_vars
from .ops.cuda.dispatch import make_cuda_scalar_apply, make_cuda_vector_apply
from .ops.custom import as_protocol_adapter, operator_is_vector
from .ops.laplacians import build_operator
from .ops.stencil import BGridVectorStencil, CGridVectorOperator, ScalarStencil5
from .utils.telemetry import setup_span, span


def _validate_dims(dims, required: bool = False):
    """Normalize/validate the `dims` argument (two spatial dim names)."""
    if dims is None:
        if required:
            raise ValueError("xarray inputs require the `dims` argument")
        return None
    dims = tuple(dims)
    if len(dims) != 2:
        raise ValueError("`dims` must name exactly two spatial dimensions")
    return dims


def _maybe_xarray():
    """The xarray module, or None: it is an optional dependency."""
    try:
        import xarray as xr

        # reject stand-ins (a test harness may stub an `xarray` module with
        # bare Dataset/DataArray classes for isinstance checks)
        if not hasattr(xr, "apply_ufunc"):
            return None
        return xr
    except ImportError:
        return None


def _loaded_xarray():
    """The xarray module if the program has already imported it, else None.

    ``apply`` and ``apply_to_vector`` ask this on every call: an xarray input
    implies that xarray is loaded, and unlike :func:`_maybe_xarray` this never
    attempts an import (a failed import costs the host about a millisecond
    per call, as much as a whole 11-step apply takes it to enqueue).
    """
    xr = sys.modules.get("xarray")
    return xr if xr is not None and hasattr(xr, "apply_ufunc") else None


def _read_chunk(a, lead, start: int, stop: int) -> np.ndarray:
    """Entries ``start:stop`` of the flattened leading dims ``lead`` of the
    array-like ``a``, as one numpy array."""
    if len(lead) == 1:
        # one contiguous range read per chunk: the access pattern a chunked
        # store serves best
        return np.asarray(a[start:stop])
    idx = np.unravel_index(np.arange(start, stop), lead)
    return np.stack([np.asarray(a[tuple(i[j] for i in idx)]) for j in range(stop - start)])


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A result as one numpy array; a sharded result is gathered first."""
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.cpu().numpy()


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
    mesh, spatial_axes :
        A ``torch.distributed.device_mesh.DeviceMesh`` with named dims plus
        the two dim names to shard the (y, x) spatial dims over, enabling
        the halo-exchange domain decomposition (scalar and vector filters).
        ``None`` entries leave that dim unsharded. Every rank of the mesh
        builds the same ``Filter`` from the global ``grid_vars`` and calls
        ``apply`` or ``apply_to_vector`` together; the mesh's device type
        must be ``device``'s. A ``parallel.ring.ResidentMesh(p_y, device)``
        with ``spatial_axes=("y", None)`` instead cuts the field into ``p_y``
        y-shards on one device and runs the ring engine (parallel/ring.py),
        whose step kernel exchanges the halo rows itself: unbatched 2-D
        float32 fields with ``ny`` divisible by ``p_y``; anything else raises
        a ``ValueError``.
    batch_axis : optional str
        A mesh dim to shard dim 0 of a ``(batch, y, x)`` field over.
    halo_steps : optional int
        Chebyshev steps per halo exchange round (default: up to 16).
    exact_nan : bool
        Keep the per-step NaN scrub of wet cells in the kernel instead of
        the h-space elimination (see ops/cuda/dispatch.py).
    custom_operator : optional object
        A user-built operator instead of a registry grid type;
        ``grid_type``/``grid_vars`` are then ignored. Framework stencil
        types (``ops.stencil.ScalarStencil5``, ``BGridVectorStencil``,
        ``CGridVectorOperator``) run through the step kernels and mesh
        sharding. Free-form protocol operators (see
        ops/custom.py) run arbitrary torch math through the eager engine on
        ``device``, single-device only.
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
    mesh: Optional[object] = dc_field(default=None, repr=False)
    spatial_axes: Tuple[Optional[str], Optional[str]] = (None, None)
    batch_axis: Optional[str] = None
    halo_steps: Optional[int] = None
    exact_nan: bool = False
    custom_operator: Optional[object] = dc_field(default=None, repr=False)

    def __post_init__(self):
        # grid_type/grid_vars are ignored with a custom operator, so its
        # grid-derived validations are skipped too.
        if self.custom_operator is None:
            # An unknown grid type is a KeyError before any other validation.
            if not isinstance(self.grid_type, GridType):
                raise KeyError(self.grid_type)
            # Fixed-factor (area-weighted) filtering happens on the
            # unit-spacing transformed grid, so dx_min must be 1.
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

        with setup_span("gft.setup.spec"):
            self.filter_spec = compute_filter_spec(
                self.filter_scale,
                self.dx_min,
                self.filter_shape,
                self.transition_width,
                self.ndim,
                self.n_steps,
            )

        # Build the grid operator (validates grid_vars names and physics),
        # unless the user supplied one directly.
        if self.custom_operator is not None:
            self.operator = self.custom_operator
            self._is_vector = operator_is_vector(self.operator)
            if self.mesh is not None and not self._is_framework_operator():
                raise ValueError(
                    "Free-form (protocol) custom operators cannot be sharded "
                    "with mesh=: the engine cannot know their communication "
                    "pattern. Express the operator as a framework stencil "
                    "type (ScalarStencil5 / BGridVectorStencil / "
                    "CGridVectorOperator) to use the mesh machinery, or drop "
                    "mesh= to run it single-device."
                )
        else:
            with setup_span("gft.setup.operator"):
                self.operator = build_operator(self.grid_type, self.grid_vars)
            self._is_vector = is_vector_grid(self.grid_type)
        self.device = torch.device("cuda" if self.device is None else self.device)
        if self.mesh is not None and self.mesh.device_type != self.device.type:
            raise ValueError(
                f"mesh is a {self.mesh.device_type!r} mesh but the filter's device is "
                f"{str(self.device)!r}; pass device={self.mesh.device_type!r} or a mesh "
                f"of the filter's device type"
            )
        self._scalar = None
        self._vector = None

    def _is_framework_operator(self) -> bool:
        return isinstance(
            self.operator, (ScalarStencil5, BGridVectorStencil, CGridVectorOperator))

    def _resident_ring(self, make):
        """The ring apply built by ``make(ring_module)``, when ``mesh`` is a
        ``ResidentMesh``; None for any other mesh. Behind a resident mesh
        there is no other engine, so whatever keeps the ring from running
        raises."""
        if self.mesh is None:
            return None
        from .parallel import ring

        if not isinstance(self.mesh, ring.ResidentMesh):
            return None
        if self.batch_axis is not None:
            raise ValueError("batch_axis cannot be sharded over a ResidentMesh: the ring "
                             "engine takes unbatched 2-D fields")
        if not ring.ring_enabled():
            raise ValueError("the ring engine is switched off (GCM_FILTERS_TPU_RING=0) and a "
                             "ResidentMesh has no other engine")
        fn = make(ring)
        if fn is None:
            raise ValueError(
                f"a ResidentMesh runs the ring engine, which needs a strict 1-D y "
                f"decomposition of a framework stencil operator: spatial_axes must be "
                f"({self.mesh.name!r}, None), got {tuple(self.spatial_axes)}")
        return fn

    def _scalar_fn(self):
        if self._scalar is None:
            self._scalar = self._resident_ring(lambda ring: ring.make_ring_scalar_apply(
                self.operator, self.filter_spec, self.mesh, self.spatial_axes,
                exact_nan=self.exact_nan, halo_steps=self.halo_steps))
        if self._scalar is None:
            if self.mesh is not None:
                from .parallel.sharded import make_sharded_scalar_apply

                self._scalar = make_sharded_scalar_apply(
                    self.operator, self.filter_spec, self.mesh, self.spatial_axes,
                    batch_axis=self.batch_axis, halo_steps=self.halo_steps,
                    exact_nan=self.exact_nan,
                )
            elif self._is_framework_operator():
                self._scalar = make_cuda_scalar_apply(
                    self.operator, self.filter_spec, exact_nan=self.exact_nan
                )
            else:
                # free-form protocol operator: the eager engine, no kernel
                adapter = as_protocol_adapter(self.operator)
                self._scalar = lambda f: scalar_filter_apply(adapter, self.filter_spec, f)
        return self._scalar

    def _vector_fn(self):
        if self._vector is None:
            self._vector = self._resident_ring(lambda ring: ring.make_ring_vector_apply(
                self.operator, self.filter_spec, self.mesh, self.spatial_axes,
                halo_steps=self.halo_steps))
        if self._vector is None:
            if self.mesh is not None:
                from .parallel.sharded import make_sharded_vector_apply

                self._vector = make_sharded_vector_apply(
                    self.operator, self.filter_spec, self.mesh, self.spatial_axes,
                    batch_axis=self.batch_axis, halo_steps=self.halo_steps,
                )
            elif self._is_framework_operator():
                self._vector = make_cuda_vector_apply(self.operator, self.filter_spec)
            else:
                adapter = as_protocol_adapter(self.operator)
                self._vector = lambda u, v: vector_filter_apply(
                    adapter, self.filter_spec, u, v)
        return self._vector

    def _operator_name(self) -> str:
        return "custom_operator" if self.custom_operator is not None else str(self.grid_type)

    @property
    def grid_ds(self):
        """The grid variables as a dataset.

        An ``xarray.Dataset`` when xarray is installed; otherwise a plain
        dict copy: xarray is an optional dependency. Grid variables supplied
        as DataArrays keep their own dim names; plain 2-D arrays get the
        default ``("y", "x")`` labels.
        """
        xr = _maybe_xarray()
        if xr is not None:
            def entry(v):
                if hasattr(v, "dims"):  # DataArray: preserve the user's dims
                    return v
                if np.ndim(v) == 2:
                    return (("y", "x"), np.asarray(v))
                return v

            return xr.Dataset({k: entry(v) for k, v in self.grid_vars.items()})
        return dict(self.grid_vars)

    def plot_shape(self, ax=None):
        """Plot the target filter response and its Chebyshev approximation."""
        import matplotlib.pyplot as plt

        spec = self.filter_spec
        F = target_function(
            self.filter_shape,
            TargetSpec(spec.s_max, self.filter_scale, self.transition_width),
        )
        t = np.linspace(-1, 1, 10001)
        k = np.sqrt(spec.s_max * (t + 1) / 2)
        if ax is None:
            _, ax = plt.subplots()
        ax.plot(k, F(t), color="tab:blue", label="target filter", linewidth=2.5)
        ax.plot(
            k,
            np.polynomial.chebyshev.chebval(t, spec.p),
            color="tab:orange",
            linestyle="--",
            label=f"Chebyshev approximation (n_steps={self.n_steps})",
            linewidth=2.5,
        )
        ax.axvline(
            2 * np.pi / self.filter_scale,
            color="0.3",
            linestyle=":",
            label="filter cutoff wavenumber",
        )
        # Zoom to the transition band when the grid resolves scales far
        # below the cutoff; otherwise the interesting region is a sliver.
        ax.set_xlim(left=0)
        if self.filter_scale / self.dx_min > 10:
            ax.set_xlim(right=4 * np.pi / self.filter_scale)
        ax.set_ylim(bottom=-0.1, top=1.1)
        ax.set_xlabel("wavenumber k")
        ax.set_ylabel("filter response")
        ax.grid(True, alpha=0.4)
        ax.legend()
        return ax

    def _coerce(self, arr) -> torch.Tensor:
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Filter runs on the CUDA card by default, but torch finds no "
                "CUDA device. Pass device='cpu' to run the plain PyTorch "
                "version on the CPU."
            )
        if not isinstance(arr, (torch.Tensor, np.ndarray)):
            # lists and scalars take numpy's dtypes (float64 for Python
            # floats), as the JAX package's inputs do, not torch's float32
            arr = np.asarray(arr)
        x = torch.as_tensor(arr)
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.mesh is not None:
            return x  # the sharded apply moves only this rank's block
        return x.to(self.device)

    def apply(self, ds, dims: Optional[Sequence[str]] = None):
        """Filter data with a scalar Laplacian.

        Parameters
        ----------
        ds : array, tensor, dict of them, xarray.DataArray or xarray.Dataset
            Data to filter. Arrays must have the spatial dims last, latitude
            first among them (``(..., y, x)``); leading dims are batched.
            For dicts and Datasets every variable carrying both spatial dims
            is filtered; everything else passes through unchanged.
        dims : sequence of str, optional
            Names of the two spatial dimensions (xarray inputs, and dict
            entries given as ``(array, dims)`` pairs). Latitude first.
        """
        with span("gft.apply"):
            if self._is_vector:
                raise ValueError(
                    f"Provided Laplacian {self._operator_name()} is a vector Laplacian. "
                    "The ``.apply`` method is only suitable for scalar Laplacians."
                )
            xr = _loaded_xarray()
            if xr is not None and isinstance(ds, (xr.DataArray, xr.Dataset)):
                return self._apply_xarray(ds, dims)
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

    def _apply_xarray(self, ds, dims):
        import xarray as xr

        dims = _validate_dims(dims, required=True)

        if isinstance(ds, xr.Dataset):
            filtered = ds.copy(deep=True)
            any_filtered = False
            for key, var in filtered.variables.items():
                if all(d in var.dims for d in dims):
                    filtered[key] = self._apply_xr_dataarray(var, dims)
                    any_filtered = True
            if not any_filtered:
                warnings.warn(
                    f"No variables in the dataset had all of the given "
                    f"dimensions ({dims}), so nothing was filtered.",
                    stacklevel=2,
                )
            return filtered
        return self._apply_xr_dataarray(ds, dims)

    def _xr_out_dtype(self, da) -> np.dtype:
        if self.dtype is None:
            return da.dtype
        return torch.empty(0, dtype=self.dtype).numpy().dtype

    def _apply_xr_dataarray(self, da, dims):
        import xarray as xr

        fn = self._scalar_fn()
        return xr.apply_ufunc(
            lambda x: _to_numpy(fn(self._coerce(x))),
            da,
            input_core_dims=[dims],
            output_core_dims=[dims],
            output_dtypes=[self._xr_out_dtype(da)],
            dask="parallelized",
        )

    def apply_to_vector(self, ufield, vfield, dims: Optional[Sequence[str]] = None):
        """Filter a vector field (u, v) with a vector Laplacian.

        ``ufield`` and ``vfield`` are arrays or tensors of equal shape with
        the spatial dims last, latitude first (``(..., y, x)``); leading dims
        are batched. Returns the filtered pair as tensors on ``device``, or,
        with a ``mesh``, as ``DTensor``s sharded over it (the inputs are then
        global fields, identical on every rank, or ``DTensor``s sharded like
        the results). xarray DataArrays need ``dims``, the names of the two
        spatial dimensions; plain arrays carry no dim names, so for them it
        is not read.
        """
        with span("gft.apply_to_vector"):
            if not self._is_vector:
                raise ValueError(
                    f"Provided Laplacian {self._operator_name()} is a scalar Laplacian. "
                    "The ``.apply_to_vector`` method is only suitable for vector Laplacians."
                )
            xr = _loaded_xarray()
            if xr is not None and isinstance(ufield, xr.DataArray):
                dims = _validate_dims(dims, required=True)
                fn = self._vector_fn()

                def _np_fn(u, v):
                    fu, fv = fn(self._coerce(u), self._coerce(v))
                    return _to_numpy(fu), _to_numpy(fv)

                out_dtype = self._xr_out_dtype(ufield)
                return xr.apply_ufunc(
                    _np_fn,
                    ufield,
                    vfield,
                    input_core_dims=2 * [dims],
                    output_core_dims=2 * [dims],
                    output_dtypes=[out_dtype, out_dtype],
                    dask="parallelized",
                )
            return self._vector_fn()(self._coerce(ufield), self._coerce(vfield))

    def _empty_dtype(self, *arrays) -> np.dtype:
        """The result dtype of an empty batch: what a non-empty one returns."""
        def torch_dtype(a):
            d = getattr(a, "dtype", np.float64)
            return d if isinstance(d, torch.dtype) else torch.from_numpy(np.zeros(0, d)).dtype

        dtypes = [self.dtype] if self.dtype is not None else [torch_dtype(a) for a in arrays]
        return torch.empty(0, dtype=_compute_dtype(*dtypes)).numpy().dtype

    def _streamed(self, fn, arrays, chunk: int):
        """``fn`` over the array-likes ``arrays`` (one a component, equal
        shapes ``(batch..., y, x)`` with a non-empty batch) in chunks of
        ``chunk`` slices of the flattened batch dims: one numpy array a
        component. ``fn`` takes one tensor a component and returns a tuple."""
        shape = tuple(arrays[0].shape)
        lead = shape[:-2]
        n = int(np.prod(lead))
        outs = None
        for start in range(0, n, chunk):
            stop = min(start + chunk, n)
            with span("gft.stream.read"):
                parts = [_read_chunk(a, lead, start, stop) for a in arrays]
            with span("gft.stream.upload", bytes=sum(p.nbytes for p in parts)):
                xs = [self._coerce(p) for p in parts]
            res = fn(*xs)
            with span("gft.stream.download",
                      bytes=sum(r.numel() * r.element_size() for r in res)):
                res = [_to_numpy(r) for r in res]
            with span("gft.stream.assemble"):
                if outs is None:
                    outs = [np.empty(shape, dtype=r.dtype) for r in res]
                for out, r in zip(outs, res):
                    out.reshape((n,) + shape[-2:])[start:stop] = r
        return outs

    def apply_streamed(self, data, chunk: int = 16):
        """Filter an out-of-core batch by streaming leading-dim chunks.

        ``data`` may be any array-like (numpy, memory-mapped, zarr array) with
        shape ``(batch..., y, x)`` too large for device memory; chunks of
        ``chunk`` slices are moved to ``device``, filtered, and returned as
        one numpy array. With a ``mesh`` every chunk goes through the sharded
        apply and is gathered (a collective: every rank streams the same
        data and gets the whole result).
        """
        with span("gft.apply_streamed"):
            if self._is_vector:
                raise ValueError(
                    f"Provided Laplacian {self._operator_name()} is a vector Laplacian. "
                    "The ``.apply_streamed`` method is only suitable for scalar Laplacians."
                )
            shape = tuple(data.shape)
            if len(shape) < 3:
                return _to_numpy(self.apply(np.asarray(data)))
            if int(np.prod(shape[:-2])) == 0:
                return np.empty(shape, dtype=self._empty_dtype(data))
            fn = self._scalar_fn()
            (out,) = self._streamed(lambda x: (fn(x),), (data,), chunk)
            return out

    def apply_to_vector_streamed(self, ufield, vfield, chunk: int = 16):
        """Filter an out-of-core (u, v) batch by streaming leading-dim chunks.

        Vector twin of :meth:`apply_streamed`: ``ufield`` and ``vfield`` are
        array-likes of equal shape ``(batch..., y, x)``; chunks of ``chunk``
        slice pairs are moved to ``device``, filtered, and returned as two
        numpy arrays. With a ``mesh`` every chunk goes through the sharded
        apply and is gathered, as in :meth:`apply_streamed`.
        """
        with span("gft.apply_to_vector_streamed"):
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
                return _to_numpy(fu), _to_numpy(fv)
            if int(np.prod(shape[:-2])) == 0:
                dtype = self._empty_dtype(ufield, vfield)
                return np.empty(shape, dtype=dtype), np.empty(shape, dtype=dtype)
            return tuple(self._streamed(self._vector_fn(), (ufield, vfield), chunk))
