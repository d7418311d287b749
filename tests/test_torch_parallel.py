"""The port's distribution layer (`dprast_torch.parallel`) on the CPU:
the mesh and the slicing without a process group, against
`dprast.parallel` on a virtual 8-device JAX mesh; and `raster_sharded`
over real Gloo groups of four processes (`tests/torch_parallel_worker.py`,
one start per mesh, every case in it), against the port's single-device
`raster` and the JAX package's on the same numpy inputs.

Tolerances (scaled max-abs, ``max|a - b| / max(max|b|, 1)``): 1e-6 to the
single-device port and 1e-5 to JAX in float32, 1e-10 to both in float64;
the ranks of one group agree bit for bit.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dprast  # noqa: E402
import dprast.parallel as jparallel  # noqa: E402
import dprast_torch  # noqa: E402
from dprast.utils.testing import fixtures  # noqa: E402
from dprast_torch import ad as tad  # noqa: E402
from dprast_torch.parallel import (make_mesh, multihost,  # noqa: E402
                                   raster_sharded, raster_sharded_local,
                                   shard_raster_args, sharded)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_worker as worker  # noqa: E402

torch.set_num_threads(1)

KEYS = worker.KEYS
WORLD = 4
# seconds a group of workers may take before it is killed
GROUP_TIMEOUT = 300


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1.0))


# ---------------------------------------------------------------------------
# without a process group
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 1), (1, 4), (2, 2)])
def test_mesh_layout_is_row_major(shape):
    """Ranks are laid out as `np.arange(n).reshape(poses, points)`, as the
    JAX package lays its devices out: the "points" group is a row, the
    "poses" group a column."""
    n_poses, n_points = shape
    grid = np.arange(n_poses * n_points).reshape(shape)
    for rank in range(n_poses * n_points):
        mesh = sharded.Mesh(n_poses, n_points, rank)
        i, j = mesh.coords
        assert grid[i, j] == rank
        assert mesh.shape == {"poses": n_poses, "points": n_points}
        assert mesh.index("poses") == i and mesh.index("points") == j
        assert mesh.group_ranks("points") == list(grid[i, :])
        assert mesh.group_ranks("poses") == list(grid[:, j])
        assert not mesh.groups
    with pytest.raises(ValueError):
        sharded.Mesh(n_poses, n_points, n_poses * n_points)


def test_make_mesh_without_a_group():
    """Where `torch.distributed` is not initialised `make_mesh()` is the
    1 x 1 mesh, and any other shape is refused as the JAX package refuses
    a shape that is not its device count."""
    assert not torch.distributed.is_initialized()
    for args in ((), (1,), (None, 1), (1, 1)):
        mesh = make_mesh(*args)
        assert mesh.shape == {"poses": 1, "points": 1}
        assert mesh.coords == (0, 0) and not mesh.groups
    for args in ((3, 3), (2,), (None, 2), (2, 2)):
        with pytest.raises(ValueError, match="processes"):
            make_mesh(*args)
    with pytest.raises(ValueError):
        jparallel.make_mesh(3, 3)
    assert sharded.POSES_AXIS == jparallel.sharded.POSES_AXIS
    assert sharded.POINTS_AXIS == jparallel.sharded.POINTS_AXIS
    assert set(jparallel.__all__) <= set(dprast_torch.parallel.__all__)


def _f32_args(n_points, batch, seed=3):
    fx = fixtures(seed=seed, n_points=n_points, batch_size=batch, n_in=3,
                  n_out=2)
    return [np.asarray(fx[k], np.float32) for k in KEYS]


@pytest.mark.parametrize("batch", [7, 8])
def test_shard_raster_args_matches_jax(batch):
    """The padded arrays of `dprast.parallel.shard_raster_args` on the
    2 x 4 JAX mesh, cut into blocks, are the port's local arrays of each
    of the eight processes, bit for bit: 37 points pad to 40 with weight
    0, 7 poses to 8 with inert poses."""
    args = _f32_args(37, batch)
    placed, p, b = jparallel.shard_raster_args(
        jparallel.make_mesh(2, 4), *(jnp.asarray(a) for a in args))
    assert (p, b) == (37, batch)
    padded = [np.asarray(a) for a in placed]
    assert padded[0].shape[0] == 40 and padded[1].shape[0] == 8
    on_points = (True, False, False, False, False, True)
    for rank in range(8):
        mesh = sharded.Mesh(2, 4, rank)
        local, p_t, b_t = shard_raster_args(
            mesh, *(torch.from_numpy(a) for a in args))
        assert (p_t, b_t) == (37, batch)
        i, j = mesh.coords
        for got, want, pts_axis in zip(local, padded, on_points):
            k, n = (j, 4) if pts_axis else (i, 2)
            size = want.shape[0] // n
            block = want[k * size:(k + 1) * size]
            assert got.dtype == torch.float32
            assert got.numpy().tobytes() == block.tobytes()
            assert got.shape == block.shape


@pytest.mark.parametrize("n_points,weights,fast", [
    (36, None, True), (37, None, False), (36, 1.5, True),
    (36, "given", False)])
def test_pw_fast_rule(n_points, weights, fast, monkeypatch):
    """The uniform-weight fast path reaches a shard only when the weights
    were uniform and the points axis needs no padding."""
    args = _f32_args(n_points, 8)
    args[5] = args[5] if weights == "given" else weights
    seen = []

    def spy(grid_size, backend, pw_uniform, *rest):
        seen.append((pw_uniform, rest[0].shape[0], rest[5].shape[0]))
        return real(grid_size, backend, pw_uniform, *rest)

    real = tad.raster_canonical
    monkeypatch.setattr(tad, "raster_canonical", spy)
    # four points shards and no process group: the shard runs, the sum
    # over "points" after it raises
    with pytest.raises(RuntimeError, match="no process group"):
        raster_sharded((16, 16), *args, mesh=sharded.Mesh(1, 4, 1),
                       device="cpu")
    rows = -(-n_points // 4)
    assert seen == [(fast, rows, rows)]


@pytest.mark.parametrize("backend", ["xla", "binned", "matmul"])
def test_one_by_one_mesh_equals_raster(backend):
    """On the 1 x 1 mesh the layer runs the single-device operations: the
    image equals `raster`'s bit for bit (the background, added after the
    render here, is the default 0), and so do the gradients."""
    args = _f32_args(37, 5)
    args[3] = np.zeros_like(args[3])
    mesh = make_mesh()

    def run(render):
        return worker.loss_and_grads(render, args)

    out, grads = run(lambda *a: raster_sharded(
        (16, 16), *a, mesh=mesh, backend=backend))
    ref, ref_grads = run(lambda *a: dprast_torch.raster(
        (16, 16), *a, backend=backend))
    assert out.tobytes() == ref.tobytes()
    for key in KEYS:
        if key == "background":
            # summed by autograd's broadcast rule here, by the backend
            # there
            assert _scaled(grads[key], ref_grads[key]) < 1e-6
        else:
            assert grads[key].tobytes() == ref_grads[key].tobytes(), key
    rows, span = raster_sharded_local(
        (16, 16), *(torch.from_numpy(a) for a in args), mesh=mesh,
        backend=backend)
    assert span == (0, 5) and rows.numpy().tobytes() == ref.tobytes()


def test_sharded_entry_points_need_a_card_or_the_cpu(monkeypatch):
    """With numpy inputs and no `device` the layer runs on the card and
    raises where there is none, as `raster` does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _f32_args(12, 3)
    for fn in (raster_sharded, raster_sharded_local):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn((8, 8), *args, mesh=make_mesh())
    out = raster_sharded((8, 8), *args, mesh=make_mesh(), device="cpu")
    assert out.device.type == "cpu" and out.shape == (3, 8, 8)
    with pytest.raises(ValueError, match="requires batched poses"):
        raster_sharded((8, 8), args[0], args[1][0], args[2][0],
                       mesh=make_mesh(), device="cpu")
    with pytest.raises(ValueError, match="Unknown backend"):
        raster_sharded((8, 8), args[0][:0], *args[1:5], mesh=make_mesh(),
                       device="cpu", backend="bogus")


def test_initialize_without_a_cluster_forms_no_group(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "SLURM_JOB_NUM_NODES",
                "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    multihost.initialize()
    assert not torch.distributed.is_initialized()
    mesh = multihost.pod_mesh()
    assert mesh.shape == {"poses": 1, "points": 1}
    multihost.shutdown()    # nothing to destroy: a no-op


# ---------------------------------------------------------------------------
# over Gloo groups of four processes
# ---------------------------------------------------------------------------


def _run_group(shape, out_dir):
    """Start the four workers of one mesh, wait for them under one
    deadline, kill what is left at it -> the ranks' result files."""
    store = out_dir / "store"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, str(rank), str(WORLD),
         str(shape[0]), str(shape[1]), str(store), str(out_dir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(WORLD)]
    deadline = time.monotonic() + GROUP_TIMEOUT
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, (
            f"worker {rank} of mesh {shape} exited {proc.returncode}:\n"
            f"{out[-3000:]}")
    return [dict(np.load(out_dir / f"rank{rank}.npz"))
            for rank in range(WORLD)]


@pytest.fixture(scope="module")
def group_results(tmp_path_factory):
    """mesh shape -> the four ranks' results; each mesh's group of
    workers is started once, at its first use."""
    done = {}

    def get(shape):
        if shape not in done:
            done[shape] = _run_group(
                shape, tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}"))
        return done[shape]

    return get


_REFERENCES = {}


def _references(name):
    """(image, gradients) of a case on one device: through the port's
    `raster` on the case's backend, and through the JAX package."""
    if name in _REFERENCES:
        return _REFERENCES[name]
    case = worker.CASES[name]
    args = worker.case_inputs(name, fixtures)
    port = worker.loss_and_grads(
        lambda *a: dprast_torch.raster(case["grid"], *a,
                                       backend=case["backend"]), args)
    given = [i for i, a in enumerate(args) if a is not None]
    scale = worker.loss_scale(case["dtype"])

    def loss(*vals):
        full = [None] * 6
        for i, v in zip(given, vals):
            full[i] = v
        return jnp.sum(jnp.sin(scale * dprast.raster(case["grid"], *full)))

    vals = [jnp.asarray(args[i]) for i in given]
    assert all(v.dtype == case["dtype"] for v in vals)
    out = dprast.raster(case["grid"], *(
        None if a is None else jnp.asarray(a) for a in args))
    grads = jax.grad(loss, argnums=tuple(range(len(given))))(*vals)
    ref = (np.asarray(out), {KEYS[i]: np.asarray(g)
                             for i, g in zip(given, grads)})
    _REFERENCES[name] = (port, ref)
    return _REFERENCES[name]


GROUP_CASES = [(shape, name) for shape in worker.MESHES
               for name, case in worker.CASES.items()
               if shape in case["meshes"]]
_IDS = [f"{s[0]}x{s[1]}-{n}" for s, n in GROUP_CASES]


def _case_arrays(results, name):
    return {k.split("/", 1)[1]: v for k, v in results.items()
            if k.startswith(name + "/")}


@pytest.mark.parametrize("shape,name", GROUP_CASES, ids=_IDS)
def test_sharded_matches_single_device_port(shape, name, group_results):
    """Image and gradients on every rank against `dprast_torch.raster` on
    the same backend."""
    (ref_out, ref_grads), _ = _references(name)
    tol = 1e-10 if worker.CASES[name]["dtype"] == "float64" else 1e-6
    for rank, results in enumerate(group_results(shape)):
        got = _case_arrays(results, name)
        assert got["out"].dtype == ref_out.dtype
        assert _scaled(got.pop("out"), ref_out) < tol, (rank, "image")
        assert set(got) == set(ref_grads)
        for key, g in got.items():
            assert g.dtype == ref_grads[key].dtype
            assert _scaled(g, ref_grads[key]) < tol, (rank, key)


@pytest.mark.parametrize("shape,name", GROUP_CASES, ids=_IDS)
def test_sharded_matches_jax(shape, name, group_results):
    """Image and gradients on every rank against the JAX package's
    `raster` and `jax.grad`."""
    _, (ref_out, ref_grads) = _references(name)
    tol = 1e-10 if worker.CASES[name]["dtype"] == "float64" else 1e-5
    for rank, results in enumerate(group_results(shape)):
        got = _case_arrays(results, name)
        assert _scaled(got.pop("out"), ref_out) < tol, (rank, "image")
        for key, g in got.items():
            assert _scaled(g, ref_grads[key]) < tol, (rank, key)


@pytest.mark.parametrize("shape", worker.MESHES,
                         ids=[f"{s[0]}x{s[1]}" for s in worker.MESHES])
def test_every_rank_holds_the_same_results(shape, group_results):
    """SPMD: after the collectives every rank holds rank 0's image and
    gradients, bit for bit, in every case; and the groups are the mesh's
    rows and columns."""
    ranks = group_results(shape)
    grid = np.arange(WORLD).reshape(shape)
    per_rank = ("mesh/", "local/rows", "local/range", "empty/local_rows")
    for rank, results in enumerate(ranks):
        i, j = results["mesh/coords"]
        assert grid[i, j] == rank
        assert list(results["mesh/points_group"]) == list(grid[i, :])
        assert list(results["mesh/poses_group"]) == list(grid[:, j])
        assert set(results) == set(ranks[0])
        for key, value in results.items():
            if key.startswith(per_rank):
                continue
            assert value.tobytes() == ranks[0][key].tobytes(), (rank, key)


@pytest.mark.parametrize("shape", worker.MESHES,
                         ids=[f"{s[0]}x{s[1]}" for s in worker.MESHES])
def test_local_rows_and_sharded_loss(shape, group_results):
    """`raster_sharded_local` gives each rank its pose rows of the image
    (7 poses: the last block is short or empty), and backpropagating each
    rank's own term of a loss summed over pose blocks gives every rank
    the full gradients."""
    (ref_out, ref_grads), _ = _references("batch7")
    size = -(-7 // shape[0])
    for rank, results in enumerate(group_results(shape)):
        i = rank // shape[1]
        start, stop = results["local/range"]
        assert (start, stop) == (min(i * size, 7), min((i + 1) * size, 7))
        assert _scaled(results["local/rows"], ref_out[start:stop]) < 1e-6
        for key in KEYS:
            assert _scaled(results[f"local/{key}"], ref_grads[key]) < 1e-6, (
                rank, key)


@pytest.mark.parametrize("shape", worker.MESHES,
                         ids=[f"{s[0]}x{s[1]}" for s in worker.MESHES])
def test_empty_cloud_unbatched_and_second_derivative(shape, group_results):
    """An empty cloud gives the background; a single pose raises; the
    f64 oracle's second derivative through the sharded call equals the
    single-device one, and a kernel backend refuses one."""
    args = worker.case_inputs("f64", fixtures)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = dprast_torch.raster((16, 16), *leaves, backend="xla")
    (g_pts,) = torch.autograd.grad(torch.sum(torch.sin(out)), leaves[0],
                                   create_graph=True)
    second = torch.autograd.grad(torch.sum(g_pts ** 2), leaves[:3])
    size = -(-4 // shape[0])
    for rank, results in enumerate(group_results(shape)):
        assert results["empty/out"].shape == (4, 8, 8)
        np.testing.assert_array_equal(results["empty/out"], 3.0)
        assert list(results["empty/local_rows"]) == [size, size]
        assert bool(results["unbatched/raised"])
        assert bool(results["second/binned_raised"])
        for key, ref in zip(KEYS, second):
            assert _scaled(results[f"second/{key}"], ref.numpy()) < 1e-10, (
                rank, key)


@pytest.mark.slow   # ~50 s here: shard_map's compile of forward and grad
def test_port_matches_jax_raster_sharded(group_results):
    """The port on its 2 x 2 Gloo mesh against the JAX package's own
    `raster_sharded` on a 2 x 2 mesh of four virtual devices."""
    args = worker.case_inputs("f32", fixtures)
    mesh = jparallel.make_mesh(2, 2, devices=jax.devices()[:4])
    vals = tuple(jnp.asarray(a) for a in args)
    scale = worker.loss_scale(np.float32)

    def loss(*a):
        return jnp.sum(jnp.sin(scale * jparallel.raster_sharded(
            (16, 16), *a, mesh=mesh, backend="xla")))

    ref_out = np.asarray(jparallel.raster_sharded(
        (16, 16), *vals, mesh=mesh, backend="xla"))
    ref_grads = jax.grad(loss, argnums=tuple(range(6)))(*vals)
    for results in group_results((2, 2)):
        got = _case_arrays(results, "f32")
        assert _scaled(got["out"], ref_out) < 1e-5
        for key, ref in zip(KEYS, ref_grads):
            assert _scaled(got[key], np.asarray(ref)) < 1e-5, key
