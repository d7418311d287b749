"""Smoke tests for the PyTorch twins of the example applications, on the
CPU at tiny step counts, as `tests/test_examples.py` runs the JAX ones;
and their blurs against the JAX examples' on the same arrays."""

import ast
import importlib.util
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(2)

_EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_EX, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_langevin_demo_decreases_loss():
    m = _load("fit_langevin_torch")
    target = m.make_target(torch.Generator().manual_seed(42), "cpu")
    assert target.shape == m.GRID and target.dtype == torch.float32
    points, _, _, hist = m.langevin_fit(target, steps=40, log_every=1000)
    assert points.shape == (m.N_POINTS, 2) and points.dtype == torch.float32
    assert hist[-1][1] < hist[0][1]
    # a seed gives the same run
    again = m.langevin_fit(target, steps=3, log_every=1000)[3]
    assert again == m.langevin_fit(target, steps=3, log_every=1000)[3]


def test_langevin_main_writes_its_arrays(tmp_path):
    m = _load("fit_langevin_torch")
    hist = m.main(["--steps", "5", "--device", "cpu", "--out",
                   str(tmp_path)])
    assert hist[-1][1] < hist[0][1]
    assert np.load(tmp_path / "final.npy").shape == m.GRID
    assert np.load(tmp_path / "target.npy").shape == m.GRID


def test_langevin_fast_mode_runs():
    m = _load("fit_langevin_torch")
    target = m.make_target(torch.Generator().manual_seed(42), "cpu")
    hist = m.langevin_fit(target, steps=5, log_every=1000,
                          backend="binned_bf16")[3]
    assert hist[-1][1] < hist[0][1]


def test_tomography_demo_runs():
    m = _load("tomography_torch")
    rots = m.view_matrices("cpu")
    assert rots.shape == (m.N_VIEWS, 2, 3) and rots.dtype == torch.float32
    truth = m.make_truth(torch.Generator().manual_seed(1), "cpu")
    assert truth.shape == (m.N_POINTS, 3) and truth.dtype == torch.float32
    import dprast_torch
    img = m.blur(dprast_torch.raster(m.GRID, truth, rots,
                                     torch.zeros((m.N_VIEWS, 2))))
    assert img.shape == (m.N_VIEWS,) + m.GRID
    first, final = m.reconstruct(steps=3, device="cpu")
    assert final < first


def test_tomography_main_asserts_convergence():
    """Three steps do not halve the loss: `main` keeps the JAX example's
    assert."""
    m = _load("tomography_torch")
    with pytest.raises(AssertionError, match="converge"):
        m.main(["--steps", "3", "--device", "cpu"])


@pytest.mark.parametrize("name", ["fit_langevin_torch", "tomography_torch",
                                  "sharded_fit_torch"])
def test_examples_raise_without_a_card(name, monkeypatch):
    """The examples run on the card by default and raise where there is
    none; nothing carries on on the CPU unasked."""
    m = _load(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        m.main(["--steps", "1"])


def test_blurs_match_the_jax_examples():
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((3, 20, 24)).astype(np.float32)
    t = _load("tomography_torch")
    j = _load("tomography")
    np.testing.assert_allclose(t.blur(torch.from_numpy(imgs)).numpy(),
                               np.asarray(j.blur(jnp.asarray(imgs))),
                               atol=1e-5)
    ft = _load("fit_langevin_torch")
    fj = _load("fit_langevin")
    np.testing.assert_allclose(
        ft.gaussian_blur_fft(torch.from_numpy(imgs[0]), 2.0).numpy(),
        np.asarray(fj.gaussian_blur_fft(jnp.asarray(imgs[0]), 2.0)),
        atol=1e-5)


def test_sharded_fit_demo_decreases_loss():
    """The multi-device fitting demo on the 1 x 1 mesh (no process group)
    must reduce its loss, as `tests/test_examples.py` asks of the JAX
    one; its inputs are the JAX example's."""
    m = _load("sharded_fit_torch")
    j = _load("sharded_fit")
    assert (m.GRID, m.N_VIEWS, m.N_POINTS) == (j.GRID, j.N_VIEWS, j.N_POINTS)
    rots = m.view_matrices()
    assert rots.dtype == torch.float32
    np.testing.assert_array_equal(rots.numpy(), np.asarray(j.view_matrices()))
    pts, hist = m.fit(steps=25, log_every=1000, device="cpu")
    assert pts.shape == (m.N_POINTS, 3) and pts.dtype == torch.float32
    assert hist[-1][1] < hist[0][1], hist
    assert not torch.distributed.is_initialized()


def test_sharded_fit_blur_matches_the_jax_example():
    imgs = np.random.default_rng(0).standard_normal((3, 20, 24)).astype(
        np.float32)
    t = _load("sharded_fit_torch")
    j = _load("sharded_fit")
    np.testing.assert_allclose(t.blur(torch.from_numpy(imgs)).numpy(),
                               np.asarray(j.blur(jnp.asarray(imgs))),
                               atol=1e-6)


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.update(OMP_NUM_THREADS="1", **{k: str(v) for k, v in extra.items()})
    return env


def test_sharded_fit_on_a_two_process_mesh_matches_one_process():
    """`main` under the environment a launcher sets (two processes, Gloo,
    a 2 x 1 mesh: three of the six views each): after two steps rank 0
    holds the losses of the 1 x 1 mesh within 1e-6, and both processes
    destroy their group and exit 0."""
    path = os.path.join(_EX, "sharded_fit_torch.py")
    code = ("import importlib.util, torch\n"
            "torch.set_num_threads(1)\n"
            f"spec = importlib.util.spec_from_file_location('m', {path!r})\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "hist = m.main(['--steps', '2', '--device', 'cpu'])\n"
            "assert not torch.distributed.is_initialized()\n"
            "print('HIST', [h[1] for h in hist])\n")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=_clean_env(RANK=rank, LOCAL_RANK=rank, WORLD_SIZE=2,
                       LOCAL_WORLD_SIZE=2, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=port)) for rank in range(2)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=240)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out[-3000:]
    assert "mesh Mesh(poses=2, points=1" in outs[0]
    assert "processes:" not in outs[1]      # rank 0 alone reports
    losses = [ast.literal_eval(line[5:]) for out in outs
              for line in out.splitlines() if line.startswith("HIST ")]
    assert len(losses) == 2 and losses[0] == losses[1]
    m = _load("sharded_fit_torch")
    _, hist = m.fit(steps=2, log_every=1000, device="cpu")
    for got, (_, want) in zip(losses[0], hist):
        assert abs(got - want) <= 1e-6 * max(abs(want), 1.0)


def test_initialize_raises_where_the_group_cannot_form():
    """A configured run whose rendezvous address answers nothing raises
    within its timeout and forms no group: no fall-back to one
    process."""
    code = ("import torch\n"
            "from dprast_torch.parallel import multihost\n"
            "try:\n"
            "    multihost.initialize(backend='gloo', timeout=3)\n"
            "except Exception as exc:\n"
            "    print('RAISED', type(exc).__name__)\n"
            "print('GROUP', torch.distributed.is_initialized())\n")
    root = os.path.dirname(_EX)
    env = _clean_env(RANK=1, WORLD_SIZE=2, MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=_free_port())
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    done = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-3000:]
    assert "RAISED" in done.stdout, done.stdout + done.stderr[-2000:]
    assert "GROUP False" in done.stdout
