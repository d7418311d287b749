"""Backend registry and selection (PyTorch port of `dprast/ops/dispatch.py`).

A backend is a kernel strategy:

- ``"xla"``     the scatter/gather oracle (`dprast_torch.ops.core`), any
                dims, any device (the name is the JAX package's): on the
                card three kernels (`csrc/xla_path.cu`: X1 the neighbour
                stage, the stable sort, X2 the fixed-order scatter, X3
                the pullback's gather), plain torch on the CPU and where
                a second derivative records a graph
- ``"matmul"``  scatter-free one-hot matrix products (`splat_matmul`),
                1-D to 3-D grids
- ``"binned"``  slot-scheduled tile-binned kernels (`splat_binned`),
                2-D and 3-D grids
- ``"auto"``    the fastest faithful backend for the given dims / grid
                / device, as measured on the card

plus the two documented ~2e-3 fast modes ``"matmul_bf16"`` (one bf16 plane
per value operand) and ``"binned_bf16"`` (B1 rounds each weight product to
bf16, B4 the cotangent window; ``terms=1``), which `auto` never picks, as
in the JAX package.  On Hopper `binned_bf16` saves no work: the kernels
have no matrix product whose operands it narrows.

`auto` on CUDA tensors: 2-D and 3-D grids go to `binned` where
`splat_binned.profitable` says so, everything else (very sparse large
grids, grids of more than 4,096 tiles, 1-D grids, ranks above 3) to
`xla`, which runs X1-X3 there; float64 inputs and every CPU call go to
`xla`.  `matmul`, which the JAX package picks for small grids
on its own chip, is picked nowhere: on the H100 it is the slowest fused
step in every regime read (the rows are in `resolve`'s docstring).  It
stays selectable by name.
"""

from __future__ import annotations

import functools

from dprast_torch.ops import core, splat_binned, splat_matmul

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
register("matmul", splat_matmul.raster_fwd, splat_matmul.raster_pullback,
         lambda n_out, grid=None, n_points=None:
         splat_matmul.supported(n_out))
register("matmul_bf16",
         functools.partial(splat_matmul.raster_fwd, terms=1),
         functools.partial(splat_matmul.raster_pullback, terms=1),
         lambda n_out, grid=None, n_points=None:
         splat_matmul.supported(n_out))
register("binned", splat_binned.raster_fwd, splat_binned.raster_pullback,
         splat_binned.supported,
         vjp_pair=(splat_binned.raster_fwd_res,
                   splat_binned.raster_pullback_res))
register("binned_bf16",
         functools.partial(splat_binned.raster_fwd, terms=1),
         functools.partial(splat_binned.raster_pullback, terms=1),
         splat_binned.supported,
         vjp_pair=(functools.partial(splat_binned.raster_fwd_res, terms=1),
                   functools.partial(splat_binned.raster_pullback_res,
                                     terms=1)))


def available_backends() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def default_backend() -> str:
    return "auto"


def resolve(backend: str, n_out: int, grid_size=None, n_points=None, *,
            accelerator: bool = False, f64: bool = False) -> str:
    """Map 'auto' to a strategy name for the given output rank / grid.

    `accelerator` says the inputs are on a CUDA device, `f64` that they
    are float64.  f64 inputs keep the f64 oracle on every device (the JAX
    package reaches the same end on the CPU; on a TPU under x64 it takes
    its matmul backend, which this package replaces by the oracle so that
    f64 stays f64).

    On CUDA `auto` never picks `matmul`: a rule taken from the rows that
    `chip_smoke.py` [matmul] reads (NVIDIA H100 80GB HBM3, 700.00 W;
    uniform weights; median ms of the fused step, forward + pullback, in
    turns matmul, xla, binned, binned, xla, matmul, all of one call).
    `binned`'s column is read with its coordinate stage as one kernel
    (`csrc/coords.cu`); with the eager stage an earlier call read 7.6844,
    2.5556, 2.7632, 7.7503, 4.0930 and 5.3064 there (beside `matmul`
    90.4135 and `xla` 19.0378 in its first row):

        grid x poses x points     matmul       xla    binned
        64^2 x 64 x 10^5         90.1773   19.3486    2.3504
        64^2 x  4 x 10^5         10.3951    3.7466    1.8429
        64^2 x  1 x 10^5          4.4984    2.4525    1.3361
        32^2 x 64 x 10^5         55.2163   19.6254    2.1583
        64^2 x 64 x 10^3          4.9772    2.4126    1.4147
        32^3 x  4 x 10^5         47.3453    4.2418    5.5479
        (4096,) x 4 x 10^4       10.7568    1.8195    (2-D, 3-D only)

    (Rows of few poses and small clouds are paced by the host and differ
    by up to 2x between calls; their order within a call does not.)

    `matmul` is the fastest in none of them, so 2-D and 3-D grids take
    `binned` where `splat_binned.profitable` holds (the slot frame's
    padding does not dwarf the cloud) and `xla` otherwise, and 1-D grids
    and ranks above 3 take `xla`."""
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
    if grid_size is not None and splat_binned.profitable(n_out, grid_size,
                                                         n_points):
        return "binned"
    return "xla"


def resolve_pair(backend: str, n_out: int, grid_size=None, n_points=None,
                 *, accelerator: bool = False,
                 f64: bool = False) -> tuple[str, str]:
    """Per-direction (forward, backward) strategy: both directions run on
    the backend `resolve` names."""
    name = resolve(backend, n_out, grid_size, n_points,
                   accelerator=accelerator, f64=f64)
    return name, name


def fwd_fn(backend: str):
    return _REGISTRY[backend][0]


def bwd_fn(backend: str):
    return _REGISTRY[backend][1]


def vjp_pair(backend: str):
    """Fused autograd pair for `backend`, or None."""
    return _REGISTRY[backend][3]
