"""Smoke tests for the PyTorch twins of the example applications, on the
CPU at tiny step counts, as `tests/test_examples.py` runs the JAX ones;
and their blurs against the JAX examples' on the same arrays."""

import importlib.util
import os

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


@pytest.mark.parametrize("name", ["fit_langevin_torch", "tomography_torch"])
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
