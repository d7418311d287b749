"""dprast_torch's harness (`dprast_torch.benchmarks`,
`dprast_torch.utils.profiling`) on the CPU: the stage profiler's
standalone stages against the same stages inside the backend, B4's
window layouts against each other, the JAX package's experiment kernels
(`benchmarks/exp_xsel.py`, `benchmarks/exp_band.py`) through the Pallas
interpreter against the port's twin, the two experiments' own checks, and
the timing hooks.

The kernels' plain twins stand in for the CUDA instances here;
`chip_smoke.py` holds the instances to the twins on the card.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from benchmarks import exp_band as jexp_band  # noqa: E402
from benchmarks import exp_xsel as jexp_xsel  # noqa: E402
from dprast.ops import splat_binned as jbin  # noqa: E402
from dprast.utils.testing import fixtures  # noqa: E402
from dprast_torch.benchmarks import (  # noqa: E402
    exp_b1_cluster, exp_band, exp_xsel)
from dprast_torch.benchmarks import profile_binned  # noqa: E402
from dprast_torch.ops import splat_binned as tbin  # noqa: E402
from dprast_torch.utils import profiling  # noqa: E402

torch.set_num_threads(2)


def _scaled_err(out, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(np.asarray(out, np.float64) - ref))
                 / max(float(np.max(np.abs(ref))), 1.0))


PROFILE_CASES = {"256x256": ((256, 256), 2000, 2),
                 "16x16x256": ((16, 16, 256), 2000, 1)}


@pytest.mark.parametrize("case", list(PROFILE_CASES))
def test_profile_stages_match_the_backend(case):
    """Every stage is timed, and the standalone B1 / B4 launches give the
    bits of the same stages inside `_fwd_impl` and `_pullback_from_frame`
    on the same frame (in 2-D with B3 as the pullback's unfold stage, the
    route the profiler times; the default route, B4 on the cotangent
    itself, gives the same rows)."""
    grid, points, batch = PROFILE_CASES[case]
    n_out = len(grid)
    res = profile_binned.run(grid, points, batch, device="cpu", iters=1,
                             warmup=0)
    stages = tuple(s for s in profile_binned.STAGES
                   if n_out == 2 or s != "bwd kernel grid")
    assert tuple(res["ms"]) == stages
    assert all(ms >= 0 for ms in res["ms"].values())
    assert len(profile_binned.report(res)) == 1 + len(stages)
    pts, rot, tr, pw, g = res["inputs"]
    ow, bg = torch.ones(batch), torch.zeros(batch)
    seen = {}

    def splat(*args, terms):
        seen["splat_args"] = args
        seen["ext"] = tbin.fwd_splat_enc(*args, terms=terms)
        return seen["ext"]

    def gather(*args, terms, layout):
        seen["gather_args"], seen["layout"] = args, layout
        seen["buf"] = tbin.bwd_gather_enc(*args, terms=terms, layout=layout)
        return seen["buf"]

    out, (data, slot_tile) = tbin._fwd_impl(
        grid, pts, rot, tr, bg, ow, pw, with_residuals=True, splat=splat)
    assert torch.equal(seen["ext"], res["ext"])
    for a, b in zip(seen["splat_args"], res["fwd_splat_enc_args"],
                    strict=True):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert torch.equal(data, res["frame"][0])
    frame = (grid, data[:, :n_out], data[:, -1], slot_tile, pts, rot, ow, pw,
             g)
    tbin._pullback_from_frame(*frame, chunk=res["chunk"], gather=gather,
                              unfold=tbin.band_unfold)
    assert seen["layout"] == "natural"
    assert torch.equal(seen["buf"], res["buf"])
    for a, b in zip(seen["gather_args"], res["bwd_gather_enc_args"],
                    strict=True):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    tbin._pullback_from_frame(*frame, chunk=res["chunk"], gather=gather)
    assert seen["layout"] == ("grid" if n_out == 2 else "natural")
    assert torch.equal(seen["buf"], res["buf"])
    # the profiler's fold stage is the forward's fold (ow = 1, bg = 0)
    ts = tbin.tile_shape_for(grid)
    fold = tbin.band_fold(res["ext"], grid, ts, ow, bg) if n_out == 2 \
        else tbin._fold(res["ext"], grid, ts, True)
    assert torch.equal(fold, out)


def test_profile_single_tile_has_no_unfold_or_unsort():
    res = profile_binned.run((64, 64), 500, 2, device="cpu", iters=1,
                             warmup=0)
    # the epilogue, which unsorts on several tiles, runs on one too
    assert "unfold" not in res["ms"] and "bwd unsort" not in res["ms"]
    assert "bwd epilogue" in res["ms"]
    assert res["unfold"] is None and res["nt"] == 1
    with pytest.raises(ValueError, match="chunk"):
        profile_binned.run((64, 64), 500, 2, chunk=128, device="cpu")


def _frame_2d(grid, n_points=300, batch=2, seed=5):
    """A standalone pullback frame, its lane planes, and a cotangent."""
    pts, rot, tr = (torch.from_numpy(np.asarray(v, np.float32)) for v in
                    list(fixtures(seed=seed, n_points=n_points,
                                  batch_size=batch, n_in=3,
                                  n_out=2).values())[:3])
    data, slot_tile, chunk = tbin._bwd_frame(grid, pts, rot, tr)
    lane_b = tbin._planes_bwd(data[:, :2], tbin.tile_shape_for(grid))
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (batch,) + grid).astype(np.float32))
    return slot_tile, lane_b, g, chunk


@pytest.mark.parametrize("grid", [(256, 256), (96, 80)])
def test_window_layouts_bit_equal(grid):
    """B4 at terms=2 reads the same values from a transposed window and
    from a presplit pair as from the natural window."""
    slot_tile, lane_b, g, chunk = _frame_2d(grid)
    ts = tbin.tile_shape_for(grid)
    win = tbin._unfold(g, grid, ts) if not tbin._single_tile(grid) else g
    natural = tbin.bwd_gather(slot_tile, lane_b, win, chunk, terms=2)
    win_t = win.transpose(-1, -2).contiguous()
    transposed = tbin.bwd_gather(slot_tile, lane_b, win_t, chunk, terms=2,
                                 layout="transposed")
    presplit = tbin.bwd_gather(slot_tile, lane_b, exp_band.split2(win_t),
                               chunk, terms=2, layout="presplit")
    assert torch.equal(transposed, natural)
    assert torch.equal(presplit, natural)
    assert torch.equal(natural, tbin._bwd_gather_plain(
        slot_tile, lane_b, win, chunk, terms=2))
    # the split differs from the exact gather by about 2^-17 relative
    exact = tbin.bwd_gather(slot_tile, lane_b, win, chunk)
    assert 0 < _scaled_err(natural, exact) < 1e-5


def _pallas_rows(kernel, grid, slot_tile, lane_b, windows, chunk, block):
    """Run one of the JAX experiments' gather kernels through the
    interpreter -> its raw (B, 3, s_pad) rows.  `windows` are the kernel's
    window operands, each cut per slot by `block` (single tile: the whole
    window of the pose; multi-tile: the slot's tile)."""
    bsz, n_lane, s_pad = lane_b.shape
    if block == "tile":
        index = lambda b, s, st: (b, st[b, s], 0, 0)  # noqa: E731
        shape = (1, 1) + tuple(windows[0].shape[2:])
    else:
        index = lambda b, s, st: (b, 0, 0)  # noqa: E731
        shape = (1,) + tuple(windows[0].shape[1:])
    w_specs = [pl.BlockSpec(shape, index, memory_space=pltpu.VMEM)
               for _ in windows]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(bsz, s_pad // chunk),
        in_specs=[pl.BlockSpec((1, n_lane, chunk),
                               lambda b, s, st: (b, 0, s),
                               memory_space=pltpu.VMEM)] + w_specs,
        out_specs=pl.BlockSpec((1, 3, chunk), lambda b, s, st: (b, 0, s),
                               memory_space=pltpu.VMEM))
    return np.asarray(pl.pallas_call(
        functools.partial(kernel, ts=tbin.tile_shape_for(grid), chunk=chunk,
                          n_out=2),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((bsz, 3, s_pad), jnp.float32),
        interpret=True)(jnp.asarray(slot_tile.numpy()),
                        jnp.asarray(lane_b.numpy()),
                        *(jnp.asarray(w) for w in windows)))


def test_xsel_kernel_matches_twin():
    """JAX's `_kernel_absums` (one tile, transposed cotangent, masked row
    sums) against B4's twin at terms=2 on the natural cotangent."""
    grid = (96, 80)
    slot_tile, lane_b, g, chunk = _frame_2d(grid)
    rows = _pallas_rows(jexp_xsel._kernel_absums, grid, slot_tile, lane_b,
                        [g.transpose(-1, -2).numpy()], chunk, "pose")
    twin = tbin._bwd_gather_plain(slot_tile, lane_b, g, chunk, terms=2)
    err = _scaled_err(twin, rows)
    assert err < 1e-6, f"_kernel_absums vs twin: {err:.3e}"


@pytest.mark.parametrize("variant", ["NN", "TN", "presplit"])
def test_band_kernels_match_twin(variant):
    """JAX's `_bwd_kernel_orient` (transposed windows with NN, natural
    with TN) and `_bwd_kernel_presplit` against B4's twin at terms=2 on
    the natural windows."""
    grid = (256, 256)
    slot_tile, lane_b, g, chunk = _frame_2d(grid)
    win = tbin._unfold(g, grid, tbin.tile_shape_for(grid))
    win_t = win.transpose(-1, -2).contiguous()
    if variant == "presplit":
        kernel = jexp_band._bwd_kernel_presplit
        hi, lo = exp_band.split2(win_t)
        windows = [jnp.asarray(hi.float().numpy()).astype(jnp.bfloat16),
                   jnp.asarray(lo.float().numpy()).astype(jnp.bfloat16)]
    else:
        kernel = functools.partial(jexp_band._bwd_kernel_orient,
                                   transposed=variant == "NN")
        windows = [(win_t if variant == "NN" else win).numpy()]
    rows = _pallas_rows(kernel, grid, slot_tile, lane_b, windows, chunk,
                        "tile")
    twin = tbin._bwd_gather_plain(slot_tile, lane_b, win, chunk, terms=2)
    err = _scaled_err(twin, rows)
    assert err < 1e-6, f"{variant} vs twin: {err:.3e}"


def test_experiments_own_checks():
    """The two experiments at a small size: the candidate agrees with the
    base exactly, and NN, TN and presplit agree bit for bit."""
    res = exp_xsel.run("cpu", (128, 128), 3000, 2, iters=1, warmup=0)
    assert res["max_abs_diff"] == 0.0 and res["scale"] > 0
    assert set(res["ms"]) == {"base", "candidate"}
    assert len(exp_xsel.report(res)) == 4
    res = exp_band.run("cpu", (300, 300), 3000, 2, iters=1, warmup=0)
    assert res["nn_tn_bit_exact"] and res["presplit_bit_exact"]
    assert set(res["ms"]) == {"NN", "TN", "presplit"}
    assert "NN vs TN bit-exact: True" in exp_band.report(res)
    with pytest.raises(ValueError, match="single tile"):
        exp_xsel.run("cpu", (300, 300))
    with pytest.raises(ValueError, match="multi-tile"):
        exp_band.run("cpu", (128, 128))


@pytest.mark.parametrize("module", [profile_binned, exp_xsel, exp_band,
                                    exp_b1_cluster])
def test_cuda_device_never_falls_back(module, monkeypatch):
    """The scripts' default device is the card; without one they exit
    instead of timing the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="is False"):
        module.main([])


def test_profiling_hooks(tmp_path, monkeypatch):
    calls = []
    ms, spread = profiling.time_fn(lambda: calls.append(1), "cpu", iters=5,
                                   warmup=2)
    assert len(calls) == 7 and ms >= 0 and spread >= 0
    with profiling.trace(tmp_path / "trace", device="cpu") as prof:
        with profiling.annotate("splat"):
            torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").exists()
    assert any(e.key == "splat" for e in prof.key_averages())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.time_fn(lambda: None, "cuda")
    with pytest.raises(ValueError, match="no clock"):
        profiling.time_fn(lambda: None, "meta")


def test_chip_smoke_bounds_and_library_routes():
    """`chip_smoke.py`'s yardsticks on the CPU: the `F.fold` / `F.unfold`
    routes compute what B2 / B3 compute, and a kernel's bound counts each
    byte of its arguments once."""
    import chip_smoke as cs
    grid = (300, 200)
    ts, nt = tbin.tile_shape_for(grid), tbin.n_tiles(grid)
    rng = np.random.default_rng(2)
    ext = torch.from_numpy(rng.standard_normal((2, nt, 128, 128)).astype(
        np.float32))
    ow = torch.tensor([0.5, 2.0])
    bg = torch.tensor([0.25, -1.0])
    np.testing.assert_allclose(
        cs.fold_library(ext, grid, ts, ow, bg).numpy(),
        tbin._band_fold_plain(ext, grid, ts, ow, bg).numpy(), rtol=1e-6,
        atol=1e-6)
    g = torch.from_numpy(rng.standard_normal((2,) + grid).astype(np.float32))
    assert torch.equal(cs.unfold_library(g, grid, ts),
                       tbin._unfold(g, grid, ts))
    slot_tile, lane_b, _, chunk = _frame_2d(grid)
    rows = int(slot_tile[:, -1].sum()) * chunk
    assert cs.live_rows(slot_tile, chunk) == rows
    n_bytes = (rows * 4 + 2 * 3 * lane_b.shape[-1] + slot_tile.numel()
               + g.numel()) * 4
    assert cs.b4_bound(slot_tile, lane_b, g, chunk) == (
        n_bytes / cs.HBM_BYTES_PER_S * 1e3, "bytes")
    assert cs.copy_bound(g, ext) == cs.bound((g.numel() + ext.numel()) * 4,
                                             0)
    assert cs.bound(1, 1e9)[1] == "operations"


def test_chip_smoke_b1_helpers():
    """`chip_smoke.py`'s B1 helpers on the CPU: the bound reads the slot
    table once, the slots per tile add up to the live slots, and the
    sparse frame has what it promises while its dead rows change nothing."""
    import chip_smoke as cs
    grid = (300, 200)
    pts, rot, tr, pw = (torch.from_numpy(a)
                        for a in cs.flagship_inputs(3, 900, 2))
    args, _ = tbin._fwd_frame(grid, pts, rot, tr, pw, True)
    st, lane, nt, win, chunk = args
    rows = cs.live_rows(st, chunk)
    n_bytes = (rows * 4 + st.numel() + 2 * nt * 128 * 128) * 4
    assert cs.b1_bound(*args) == (n_bytes / cs.HBM_BYTES_PER_S * 1e3,
                                  "bytes")
    per_tile = cs.slots_per_tile(st, nt)
    assert per_tile.shape == (2, nt) and bool((per_tile >= 1).all())
    assert torch.equal(per_tile.sum(1), st[:, -1].long())
    sparse = cs.sparse_frame(tbin, grid, pts * 0.2, rot, tr)
    assert bool((cs.slots_per_tile(sparse[0], nt) == 0).any())
    data, st_b, _ = tbin._bwd_frame(grid, pts * 0.2, rot, tr)
    clean = tbin._planes_fwd(data[:, :2], None).contiguous()
    assert not torch.equal(clean, sparse[1])
    assert torch.equal(tbin._fwd_splat_plain(*sparse),
                       tbin._fwd_splat_plain(st_b, clean, *sparse[2:]))


@pytest.mark.parametrize("grid", [(128, 128), (300, 200), (8, 16, 200)])
def test_chip_smoke_b7_bounds(grid):
    """`chip_smoke.py`'s bounds of what the main path runs since B7, on the
    CPU: B1 and B4 on the frame read its encoded planes (and B1 the
    weight) once for each live row, the frame gather the sort's index, the
    sources and the frame once, B6 writing a single tile's frame the cloud,
    the poses, the frame and its slot table once."""
    import chip_smoke as cs
    n_out = len(grid)
    pts, rot, tr, pw = (torch.from_numpy(a) for a in cs.flagship_inputs(
        3, 900, 2))
    if n_out == 3:
        rot = torch.from_numpy(_rotations(2))
        tr = torch.zeros((2, 3))
    ts, win = tbin.tile_shape_for(grid), tbin._window(grid)
    data, st, nt, chunk = tbin._fwd_prep(grid, pts, rot, tr, pw, False)
    assert data.shape[1] == n_out + 2
    rows = cs.live_rows(st, chunk)
    wins = 2 * nt * int(np.prod(win))
    b1 = cs.b1_enc_bound(st, data, nt, win, chunk)
    assert b1 == cs.bound((rows * (n_out + 1) + st.numel() + wins) * 4,
                          rows * ((14 if n_out == 2 else 34)
                                  + cs.DECODE_OPS * n_out))
    g = torch.zeros((2,) + grid)
    src = tbin._unfold(g, grid, ts) if n_out == 3 else g
    s_pad = data.shape[2]
    b4 = cs.b4_enc_bound(st, data[:, :n_out], src, chunk)
    assert b4[0] == ((rows * n_out + 2 * (n_out + 1) * s_pad + st.numel())
                     * 4 + src.numel() * 4) / cs.HBM_BYTES_PER_S * 1e3
    if tbin._single_tile(grid):
        frame, table = tbin.direct_frame(grid, ts, pts, rot, tr, None, chunk)
        assert cs.direct_frame_bound(pts, rot, tr, frame, table) == cs.bound(
            (pts.numel() + rot.numel() + tr.numel() + frame.numel()
             + table.numel()) * 4,
            2 * 2 * pts.shape[0] * cs.coords_ops(3, n_out))
    else:
        key, locs, _ = tbin._keys_and_local(grid, ts, pts, rot, tr)
        perm, sorted_keys, _ = tbin._slot_order(key, nt, chunk, True, True)
        for index, index_bytes in ((perm, 8), (sorted_keys, 4)):
            frame = tbin.frame_gather(index, locs, pw)
            assert torch.equal(frame.view(torch.int32),
                               data.view(torch.int32))
            assert cs.frame_gather_bound(
                frame, n_out, pts.shape[0], index) == cs.bound(
                (2 * s_pad * index_bytes + (2 * n_out + 1) * pts.shape[0] * 4
                 + frame.numel() * 4), 0)


def _rotations(n_poses):
    """`n_poses` proper 3 x 3 rotations, float32, from a seed."""
    q, r = np.linalg.qr(np.random.default_rng(5).standard_normal(
        (n_poses, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q.astype(np.float32)


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """`slots.cuh` is compiled into two sources and is no source itself:
    an edit to it must still name a new library."""
    import shutil

    from dprast_torch.ops import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    before = _build._library_path()
    assert before == _build._library_path()
    with open(csrc / "slots.cuh", "a") as f:
        f.write("// edited\n")
    assert _build._library_path() != before
    assert all((csrc / name).exists()
               for name in _build._SOURCES + _build._HEADERS)


def test_profiler_lists_a_step_by_kernel():
    """`profile_binned --by-kernel` traces the fused step and sums it by
    operator; on the CPU (the twins) the rows are the host's operators."""
    from dprast_torch.benchmarks import profile_binned
    res = profile_binned.step_by_kernel((256, 256), 400, 2, device="cpu",
                                        calls=2, iters=1, warmup=0)
    assert res["rows"] and res["busy_us"] > 0 and res["step_ms"] > 0
    assert res["launches"] == sum(row[2] for row in res["rows"])
    times = [row[1] for row in res["rows"]]
    assert times == sorted(times, reverse=True)
    lines = profile_binned.report_by_kernel(res, top=5)
    assert len(lines) == 1 + min(5, len(res["rows"]))
    assert "fused step" in lines[0]


class _Row:
    """A row of a trace's `key_averages()`: on the card a kernel timed on
    the card, else a host operator timed by its own time."""

    def __init__(self, key, on_card, us, count):
        from torch.autograd import DeviceType
        self.key, self.count = key, count
        self.device_type = DeviceType.CUDA if on_card else DeviceType.CPU
        self.device_time_total = us if on_card else 0.0
        self.self_cpu_time_total = 0.0 if on_card else us


# ten calls' rows: splat twice a call, gather once, and a host operator
_CARD_ROWS = [_Row("gather_kernel", True, 100.0, 10),
              _Row("aten::mm", False, 999.0, 10),
              _Row("splat_kernel<2>", True, 600.0, 20)]


def _traces(monkeypatch, *rows):
    """`profiling.trace` yields a profiler whose `key_averages()` are
    `rows[i]` at its i-th entry (the last ones after that) -> the devices
    of the traces entered."""
    import contextlib
    import types
    entered = []

    @contextlib.contextmanager
    def trace(log_dir, device="cuda"):
        got = rows[min(len(entered), len(rows) - 1)]
        entered.append(device)
        yield types.SimpleNamespace(key_averages=lambda: got)

    monkeypatch.setattr(profiling, "trace", trace)
    return entered


def _host_ops():
    x = torch.ones(64, 64)
    x + 1
    x + 2
    x.mm(x)


def _reader_sorted(monkeypatch):
    rows = profiling.by_kernel(_host_ops, 4, "cpu")
    times = [row[1] for row in rows]
    assert times == sorted(times, reverse=True)
    count = {name: n for name, _, n in rows}
    assert count["aten::add"] == 2 and count["aten::mm"] == 1


def _reader_names_str(monkeypatch):
    rows = profiling.by_kernel(_host_ops, 3, "cpu", "aten::mm")
    assert [(name, n) for name, _, n in rows] == [("aten::mm", 1)]
    assert rows[0][1] > 0


def _reader_names_tuple(monkeypatch):
    rows = profiling.by_kernel(_host_ops, 3, "cpu", ("aten::mm", "::add"))
    assert {name: n for name, _, n in rows} == {"aten::mm": 1,
                                                "aten::add": 2}


def _reader_card_rows(monkeypatch):
    entered = _traces(monkeypatch, _CARD_ROWS)
    assert profiling.by_kernel(lambda: None, 10) == [
        ("splat_kernel<2>", 60.0, 2.0), ("gather_kernel", 10.0, 1.0)]
    assert entered == ["cuda"]


def _reader_launch_us(monkeypatch):
    _traces(monkeypatch, _CARD_ROWS)
    assert profiling.launch_us(lambda: None, "splat_kernel") == 30.0
    assert profiling.launch_us(lambda: None, "gather_kernel") == 10.0


def _reader_device_busy(monkeypatch):
    _traces(monkeypatch, _CARD_ROWS)
    assert profiling.device_busy(lambda: None, calls=10) == (70.0, 3.0)


def _reader_retried(monkeypatch):
    entered = _traces(monkeypatch, [], _CARD_ROWS[1:], _CARD_ROWS)
    assert profiling.launch_us(lambda: None, "gather_kernel") == 10.0
    assert len(entered) == 3


def _reader_not_measured(monkeypatch):
    entered = _traces(monkeypatch, _CARD_ROWS[1:2])
    assert profiling.by_kernel(lambda: None, names="splat") is None
    assert profiling.launch_us(lambda: None, "splat") is None
    assert profiling.device_busy(lambda: None) == (0, 0)
    assert len(entered) == 9


READER_CASES = {"sorted, launches a call": _reader_sorted,
                "names as a string": _reader_names_str,
                "names as a tuple": _reader_names_tuple,
                "card rows by device time": _reader_card_rows,
                "launch_us a launch": _reader_launch_us,
                "device_busy the rows' sums": _reader_device_busy,
                "a trace without rows retried": _reader_retried,
                "three empty traces": _reader_not_measured}


@pytest.mark.parametrize("case", list(READER_CASES))
def test_trace_reader(case, monkeypatch):
    """`profiling.by_kernel`, the one reader of a `torch.profiler` trace,
    and `launch_us` / `device_busy` as sums over its rows: rows by falling
    time with their launches a call (count / calls), on the CPU the host's
    operators by their own time, on the card the kernels by device time
    (a stand-in trace); a `names` filter as a string or a tuple; µs a
    launch where a call launches a kernel twice; a trace that came back
    without the rows asked for traced again, and not measured (None)
    after three."""
    READER_CASES[case](monkeypatch)


@pytest.mark.parametrize("grid", [(128, 128), (300, 200), (8, 16, 200)])
@pytest.mark.parametrize("weighted", [False, True])
def test_chip_smoke_b8_bounds(grid, weighted):
    """`chip_smoke.epilogue_bounds` on the arguments the main path hands
    the epilogue: a bound for each of the two kernels that run at the
    shape (one tile: `epilogue_tile`, `epilogue_poses`; several:
    `epilogue_rows`, `epilogue_points`) and for the function, each
    bound by bytes, the function's below the sum of the kernels'."""
    import chip_smoke as cs
    args, kw = cs.b8_args(tbin, grid, 3, 2000, torch.device("cpu"),
                          weighted=weighted, terms=0)
    bounds = cs.epilogue_bounds(tbin, args, kw)
    kernels = (("epilogue_tile", "epilogue_poses") if tbin._single_tile(grid)
               else ("epilogue_rows", "epilogue_points"))
    assert set(bounds) == {*kernels, "function"}
    assert all(b[0] > 0 and b[1] == "bytes" for b in bounds.values())
    assert bounds["function"][0] < sum(bounds[k][0] for k in kernels)
