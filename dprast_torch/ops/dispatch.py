"""Backend registry and selection (PyTorch port of `dprast/ops/dispatch.py`).

A backend is a kernel strategy:

- ``"xla"``     plain-torch scatter/gather oracle (`dprast_torch.ops.core`),
                any dims, any device (the name is the JAX package's)
- ``"binned"``  slot-scheduled tile-binned kernels (`splat_binned`),
                2-D and 3-D grids
- ``"auto"``    the JAX package's choice for the given dims / grid /
                device

`auto` follows the JAX package's rules with "the inputs are on CUDA" in
place of "running on a TPU".  Where those rules pick the matmul backend,
which this package does not have yet, `resolve_pair` raises
`NotImplementedError` naming ROADMAP A8; it never substitutes another
backend.
"""

from __future__ import annotations

from dprast_torch.ops import core, splat_binned

_REGISTRY = {}


def register(name: str, fwd, bwd, supports, vjp_pair=None):
    """supports: (n_out, grid_size | None, n_points | None) -> bool.

    `vjp_pair` is an optional fused autograd pair ``(fwd_res(grid, *args)
    -> (out, residuals), bwd_res(grid, residuals, args, ds_dout) ->
    PullbackResult)`` that `dprast_torch.ad` uses when both directions
    run on this backend, so that the pullback reuses the forward's
    preparation."""
    _REGISTRY[name] = (fwd, bwd, supports, vjp_pair)


register("xla", core.raster_fwd, core.raster_pullback,
         lambda n_out, grid=None, n_points=None: True,
         vjp_pair=(core.raster_fwd_res, core.raster_pullback_res))
register("binned", splat_binned.raster_fwd, splat_binned.raster_pullback,
         splat_binned.supported,
         vjp_pair=(splat_binned.raster_fwd_res,
                   splat_binned.raster_pullback_res))


def available_backends() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def default_backend() -> str:
    return "auto"


def _matmul_supported(n_out: int) -> bool:
    # the JAX package's `splat_matmul.supported`
    return n_out in (1, 2, 3)


def resolve(backend: str, n_out: int, grid_size=None, n_points=None, *,
            accelerator: bool = False, f64: bool = False) -> str:
    """Map 'auto' to a strategy name for the given output rank / grid.

    `accelerator` says the inputs are on a CUDA device, `f64` that they
    are float64.  f64 inputs keep the f64 oracle on every device (the JAX
    package reaches the same end on the CPU; on a TPU under x64 it takes
    its matmul backend, which this package replaces by the oracle so that
    f64 stays f64)."""
    if backend != "auto":
        if backend not in _REGISTRY:
            raise ValueError(
                f"Unknown backend {backend!r}; available: "
                f"{available_backends()}")
        if not _REGISTRY[backend][2](n_out, grid_size, n_points):
            raise ValueError(
                f"Backend {backend!r} does not support N_out={n_out} "
                f"grid={grid_size}")
        return backend
    if not accelerator or f64:
        return "xla"
    if grid_size is not None:
        # large grids: dense one-hot paths do O(prod(grid)) work per
        # point; the binned backend does O(tile), and very sparse cases
        # go to the scatter oracle, whose cost scales with splats
        voxels = 1
        for s in grid_size:
            voxels *= s
        if voxels > (256 * 256 if n_out == 2 else 32 ** 3):
            if splat_binned.profitable(n_out, grid_size, n_points):
                return "binned"
            return "xla"
    if _matmul_supported(n_out):
        return "matmul"
    return "xla"


def resolve_pair(backend: str, n_out: int, grid_size=None, n_points=None,
                 *, accelerator: bool = False,
                 f64: bool = False) -> tuple[str, str]:
    """Per-direction (forward, backward) strategy.  As in the JAX package,
    `auto` runs both directions of a single-tile 2-D grid above 64 per
    axis on the binned backend, where the JAX rules would say matmul."""
    name = resolve(backend, n_out, grid_size, n_points,
                   accelerator=accelerator, f64=f64)
    if (backend == "auto" and name == "matmul" and grid_size is not None
            and n_out == 2 and splat_binned._single_tile(grid_size)
            and min(grid_size) > 64
            and splat_binned.profitable(n_out, grid_size, n_points)):
        name = "binned"
    if name == "matmul":
        raise NotImplementedError(
            f"'auto' picks the matmul backend for N_out={n_out} "
            f"grid={grid_size} on CUDA; it is not ported yet (ROADMAP A8)")
    return name, name


def fwd_fn(backend: str):
    return _REGISTRY[backend][0]


def bwd_fn(backend: str):
    return _REGISTRY[backend][1]


def vjp_pair(backend: str):
    """Fused autograd pair for `backend`, or None."""
    return _REGISTRY[backend][3]
