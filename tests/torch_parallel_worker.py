"""One process of a Gloo group on the CPU for `tests/test_torch_parallel.py`
(no test of its own: pytest collects nothing here).

Run as ``python tests/torch_parallel_worker.py RANK WORLD N_POSES N_POINTS
STORE OUT``: it joins the group of WORLD processes through the file
STORE, builds the N_POSES x N_POINTS mesh, runs every case of `CASES` that
names this mesh through `dprast_torch.parallel.raster_sharded`, writes the
images and gradients to ``OUT/rank<RANK>.npz`` and destroys the group.
The test process reads the files and compares them with the
single-device results.  Imports torch and numpy only.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

MESHES = ((2, 2), (1, 4), (4, 1))
KEYS = ("points", "rotation", "translation", "background", "out_weight",
        "point_weight")

# name: grid, the fixtures' (seed, n_points, batch, n_out), dtype, backend,
# point weights ("given" per point, "default" None, "scalar" 1.3), and
# the meshes the case runs on
_ALL = MESHES
CASES = {
    "f32": dict(grid=(16, 16), fx=(3, 37, 8, 2), dtype="float32",
                backend="auto", weights="given", meshes=_ALL),
    "f64": dict(grid=(16, 16), fx=(3, 37, 8, 2), dtype="float64",
                backend="xla", weights="given", meshes=_ALL),
    "batch7": dict(grid=(16, 16), fx=(11, 29, 7, 2), dtype="float32",
                   backend="auto", weights="given", meshes=_ALL),
    "default36": dict(grid=(16, 16), fx=(19, 36, 8, 2), dtype="float32",
                      backend="auto", weights="default", meshes=_ALL),
    "default37": dict(grid=(16, 16), fx=(19, 37, 8, 2), dtype="float32",
                      backend="auto", weights="default", meshes=_ALL),
    "binned256": dict(grid=(256, 256), fx=(13, 67, 4, 2), dtype="float32",
                      backend="binned", weights="given", meshes=_ALL),
    "binned256_scalar": dict(grid=(256, 256), fx=(19, 64, 8, 2),
                             dtype="float32", backend="binned",
                             weights="scalar", meshes=((2, 2), (1, 4))),
    "binned3d": dict(grid=(8, 16, 128), fx=(17, 53, 4, 3), dtype="float32",
                     backend="binned", weights="given",
                     meshes=((2, 2), (4, 1))),
}
SCALAR_WEIGHT = 1.3


def loss_scale(dtype) -> float:
    """The loss is ``sum(sin(scale * image))``.  The fixtures' images
    reach ~100, where the cosine turns the image's float32 rounding
    (1e-7 relative) into a 3e-6 error of the gradients on one device
    already; so float32 cases scale the image to order 1 first and
    float64 cases do not."""
    return 1.0 if np.dtype(dtype) == np.float64 else 1.0 / 64


def load_fixtures():
    """`fixtures` of dprast/utils/testing.py (pure numpy), loaded by path
    so that the JAX package's `__init__` never runs in a worker."""
    spec = importlib.util.spec_from_file_location(
        "dprast_numpy_fixtures",
        os.path.join(ROOT, "dprast", "utils", "testing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.fixtures


def case_inputs(name, fixtures):
    """The numpy inputs of a case, in `KEYS` order; point_weight is None
    or a 0-d array where the case says so."""
    case = CASES[name]
    seed, n_points, batch, n_out = case["fx"]
    fx = fixtures(seed=seed, n_points=n_points, batch_size=batch, n_in=3,
                  n_out=n_out)
    args = [np.asarray(fx[k], case["dtype"]) for k in KEYS]
    if case["weights"] == "default":
        args[5] = None
    elif case["weights"] == "scalar":
        args[5] = np.asarray(SCALAR_WEIGHT, case["dtype"])
    return args


def loss_and_grads(render, args):
    """``sum(sin(loss_scale * render(*leaves)))`` and its gradients for
    the inputs that are given -> (image, {key: gradient}) as numpy
    arrays."""
    leaves = [None if a is None else torch.from_numpy(a).requires_grad_()
              for a in args]
    out = render(*leaves)
    given = [(k, x) for k, x in zip(KEYS, leaves) if x is not None]
    scale = loss_scale(args[0].dtype)
    grads = torch.autograd.grad(torch.sum(torch.sin(scale * out)),
                                [x for _, x in given])
    return out.detach().numpy(), {k: g.numpy()
                                  for (k, _), g in zip(given, grads)}


def run_cases(mesh, shape, results):
    from dprast_torch.parallel import raster_sharded, raster_sharded_local
    fixtures = load_fixtures()
    for name, case in CASES.items():
        if shape not in case["meshes"]:
            continue
        args = case_inputs(name, fixtures)

        def render(*leaves, case=case):
            return raster_sharded(case["grid"], *leaves, mesh=mesh,
                                  backend=case["backend"])

        out, grads = loss_and_grads(render, args)
        results[f"{name}/out"] = out
        for key, g in grads.items():
            results[f"{name}/{key}"] = g

    # the pose rows of this process, and the gradients of a loss that
    # stays sharded over poses: each process backpropagates its own term
    args = case_inputs("batch7", fixtures)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    rows, (start, stop) = raster_sharded_local((16, 16), *leaves, mesh=mesh)
    results["local/rows"] = rows.detach().numpy()
    results["local/range"] = np.asarray([start, stop])
    grads = torch.autograd.grad(
        torch.sum(torch.sin(loss_scale(np.float32) * rows)), leaves)
    for key, g in zip(KEYS, grads):
        results[f"local/{key}"] = g.numpy()

    # an empty cloud gives the background image
    eye = np.tile(np.eye(2, dtype=np.float32)[None], (4, 1, 1))
    results["empty/out"] = raster_sharded(
        (8, 8), np.zeros((0, 2), np.float32), eye,
        np.zeros((4, 2), np.float32), 3.0, mesh=mesh, device="cpu").numpy()
    rows, span = raster_sharded_local(
        (8, 8), np.zeros((0, 2), np.float32), eye,
        np.zeros((4, 2), np.float32), 3.0, mesh=mesh, device="cpu")
    results["empty/local_rows"] = np.asarray(
        [rows.shape[0], span[1] - span[0]])

    # a single pose is refused, before any collective
    try:
        raster_sharded((8, 8), np.zeros((5, 2), np.float32),
                       np.eye(2, dtype=np.float32),
                       np.zeros(2, np.float32), mesh=mesh, device="cpu")
    except ValueError as exc:
        results["unbatched/raised"] = np.asarray(
            "requires batched poses" in str(exc))
    else:
        results["unbatched/raised"] = np.asarray(False)

    # second derivatives: the f64 oracle keeps its own through the
    # sharded call, a kernel backend raises as on one device
    args = case_inputs("f64", fixtures)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = raster_sharded((16, 16), *leaves, mesh=mesh, backend="xla")
    (g_pts,) = torch.autograd.grad(torch.sum(torch.sin(out)), leaves[0],
                                   create_graph=True)
    second = torch.autograd.grad(torch.sum(g_pts ** 2), leaves[:3])
    for key, g in zip(KEYS, second):
        results[f"second/{key}"] = g.numpy()
    args = case_inputs("binned256", fixtures)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = raster_sharded((256, 256), *leaves, mesh=mesh, backend="binned")
    try:
        torch.autograd.grad(torch.sum(out ** 2), leaves[0],
                            create_graph=True)
    except RuntimeError as exc:
        results["second/binned_raised"] = np.asarray(
            "differentiated once" in str(exc))
    else:
        results["second/binned_raised"] = np.asarray(False)


def main(argv):
    rank, world, n_poses, n_points = (int(a) for a in argv[:4])
    store, out_dir = argv[4], argv[5]
    torch.set_num_threads(1)
    from dprast_torch.parallel import make_mesh, multihost
    multihost.initialize(init_method=f"file://{store}", world_size=world,
                         rank=rank, backend="gloo", timeout=120)
    try:
        mesh = make_mesh(n_poses, n_points)
        results = {"mesh/coords": np.asarray(mesh.coords),
                   "mesh/poses_group": np.asarray(
                       mesh.group_ranks("poses")),
                   "mesh/points_group": np.asarray(
                       mesh.group_ranks("points"))}
        run_cases(mesh, (n_poses, n_points), results)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **results)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
