"""The density fit's step (DiffPointRasterisation.jl's README.md:192 row
with per-point weights, whose gradient upstream's `raster_pullback!`
returns: `src/raster_pullback.jl:55-58`), at a CPU test's size, through
`dprast_torch.raster` and `torch.autograd.grad`, against the benchmark's
plain reference (`perfbench/references/raster.py`: torch in float64,
sparse, nothing of the port).

Inputs as the benchmark's `proj1024_fit_pw` cell makes them
(`perfbench/inputs.py`): a cloud N(0, 0.4^2) moved 0.004 off the truth,
rotations about one axis, one weight a point uniform on [0.5, 2.0] drawn
from the seed, the reference's render of the weighted truth as the
target; the step is `mean((pred - target)^2)` and the gradients of the
points, the rotations, the translations and the point weights, which
require grad.  A (P,) weight is never uniform (`api._normalise`), so
`binned` carries it as a plane of the frame, and B1 and B8 run their
weighted forms: on one tile (128^2) B6's frame and `epilogue_tile`'s
plain form, on several (300x200, 3 x 2 tiles) the sort, the frame gather
and E1 / E2's plain form.  `xla` is the reference path of the CPU (what
`auto` takes here).  The `binned_bf16` fast mode is the control: it must
fail a tolerance.
"""

import json
import math

import pytest

torch = pytest.importorskip("torch")

import dprast_torch  # noqa: E402
from dprast_torch.ops import splat_binned  # noqa: E402
from perfbench import inputs  # noqa: E402
from perfbench.references import raster as ref  # noqa: E402

torch.set_num_threads(2)

F64 = torch.float64
N_POINTS, N_POSES = 2000, 4
SEED = 2 ** 31 + 28
# the cell's range (`perfbench/configs/proj_1024sq_1e5_pw.json`)
WEIGHTS = {"uniform": [0.5, 2.0]}
GRIDS = {"128sq": (128, 128), "300x200": (300, 200)}

# Tolerances, each a share of the float64 reference:
# - the forward: the accuracy contract, max |out - ref| over every voxel /
#   max(max |ref|, 1) within 1e-5 (the float32 program reads ~1e-7, the
#   bf16 mode ~1e-3: it rounds the weight plane and the coordinates);
# - the loss, |L - L_ref| / L_ref: a mean of float32 squares, whose
#   rounding is ~1e-7 of it, so 1e-5;
# - each gradient, ||g - g_ref|| / ||g_ref||: B4 and B8 sum in float32
#   and float64 over 2,000 points a pose (~1e-6 of a norm); a point that
#   float32 puts on the other side of a voxel edge moves its own position
#   gradient whole, and 1e-4 leaves that room at 2,000 points.  The
#   weights' gradient is each point's interpolated cotangent summed over
#   4 poses, continuous in the point's place, so it reads ~1e-7 and shares
#   the bound.
FWD_TOL, LOSS_TOL, GRAD_TOL = 1e-5, 1e-5, 1e-4
LEAVES = ("points", "rotation", "translation", "point_weight")

# (backend, grid, within the tolerances)
CASES = {f"{backend}-{g}": (backend, grid, True)
         for backend in ("binned", "xla") for g, grid in GRIDS.items()}
CASES["binned_bf16-300x200-control"] = ("binned_bf16", GRIDS["300x200"],
                                        False)


def _inputs(grid):
    """The cell's inputs at the test's size -> (points, rotation,
    translation, point_weight, target)."""
    config = {"grid": list(grid), "n_in": 3, "n_points": N_POINTS,
              "poses_per_call": N_POSES, "pool_poses": N_POSES,
              "points_sigma": 0.4, "translation_sigma": 0.1,
              "weights": {"point_weight": WEIGHTS}}
    data = inputs.make(config, {"init_jitter": 0.004}, SEED, "cpu")
    target = inputs.targets(config, data, ref)[0]
    return (data.points, data.rotation[0], data.translation[0],
            data.point_weight, target)


def _step(grid, backend, leaves, target):
    pred = dprast_torch.raster(grid, *leaves[:3], point_weight=leaves[3],
                               backend=backend)
    loss = torch.mean((pred - target) ** 2)
    return pred.detach(), loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("case", list(CASES))
def test_density_fit_step_against_reference(case):
    backend, grid, sound = CASES[case]
    points, rot, tr, pw, target = _inputs(grid)
    assert pw.shape == (N_POINTS,) and 0.5 <= float(pw.min()) \
        and float(pw.max()) <= 2.0
    leaves = [t.clone().requires_grad_(True) for t in (points, rot, tr, pw)]
    pred, loss, grads = _step(grid, backend, leaves, target)

    weights = ref.Weights(point_weight=pw.to(F64))
    want = ref.fit_step(grid, points.to(F64), rot.to(F64), tr.to(F64),
                        target, weights=weights)
    got = {
        "out_err": ref.forward_error(grid, pred, points, rot, tr,
                                     weights=weights),
        "loss_gap": abs(float(loss) - want.loss) / want.loss}
    for name, g, g_ref in zip(LEAVES, grads, (
            want.d_points, want.d_rotation, want.d_translation,
            want.d_point_weight)):
        assert g.shape == g_ref.shape and g.dtype == torch.float32
        norm = float(torch.linalg.vector_norm(g_ref))
        assert norm > 0 and math.isfinite(norm)
        got[name] = float(torch.linalg.vector_norm(g.to(F64) - g_ref)) / norm
    tols = {"out_err": FWD_TOL, "loss_gap": LOSS_TOL,
            **{name: GRAD_TOL for name in LEAVES}}
    within = {k: got[k] <= tols[k] for k in tols}
    if sound:
        assert all(within.values()), got
    else:
        assert not all(within.values()), got


def test_reference_needs_the_weights():
    """The weights reach the comparison: the program given all-ones
    weights that stay in the graph (`pw * 0 + 1`) fails the forward and
    the weights' gradient against the reference of the drawn ones."""
    grid = GRIDS["300x200"]
    points, rot, tr, pw, target = _inputs(grid)
    leaves = [t.clone().requires_grad_(True) for t in (points, rot, tr, pw)]
    ones = leaves[:3] + [leaves[3] * 0 + 1]
    pred = dprast_torch.raster(grid, *ones[:3], point_weight=ones[3],
                               backend="binned")
    loss = torch.mean((pred - target) ** 2)
    d_pw = torch.autograd.grad(loss, leaves[3])[0]
    weights = ref.Weights(point_weight=pw.to(F64))
    want = ref.fit_step(grid, points.to(F64), rot.to(F64), tr.to(F64),
                        target, weights=weights)
    assert ref.forward_error(grid, pred.detach(), points, rot, tr,
                             weights=weights) > FWD_TOL
    # the chain rule through `* 0` leaves the drawn weights no gradient
    assert float(torch.linalg.vector_norm(d_pw)) == 0.0
    assert float(torch.linalg.vector_norm(want.d_point_weight)) > 0


def _spans(fn, tmp_path):
    """fn() under a CPU capture -> (its result, the names of the program's
    spans in the order they started)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((float(e["ts"]), e["name"]) for e in events
                   if e.get("ph") == "X"
                   and e.get("name", "").startswith("dprast."))
    return out, [name for _, name in spans]


def test_weighted_frame_and_epilogue_ran(tmp_path, monkeypatch):
    """On several tiles the forward's frame carries the weight plane
    (n_out + 2 planes: coordinates, weight, id), each real row's weight
    that of the point its id names and each filler row's 0; the spans of
    one step show the sort, the frame gather, B1, B2, B4 and B8, once
    each, and no gradient span of its own for the weights (B8 writes
    `d_pw` beside the others)."""
    grid = GRIDS["300x200"]
    points, rot, tr, pw, target = _inputs(grid)
    leaves = [t.clone().requires_grad_(True) for t in (points, rot, tr, pw)]
    frames = []
    frame = splat_binned._frame

    def spy(*args, **kwargs):
        frames.append(frame(*args, **kwargs))
        return frames[-1]

    monkeypatch.setattr(splat_binned, "_frame", spy)
    _, names = _spans(lambda: _step(grid, "binned", leaves, target),
                      tmp_path)

    assert len(frames) == 1   # the fused pair: the pullback reuses it
    data = frames[0][0]
    assert data.shape[:2] == (N_POSES, len(grid) + 2)
    ids = data[:, -1]
    real = ids < N_POINTS
    assert int(real.sum()) == N_POSES * N_POINTS
    w_rows = data[:, len(grid)]
    assert torch.equal(w_rows[real], pw[ids[real].long()])
    assert torch.equal(w_rows[~real], torch.zeros_like(w_rows[~real]))

    assert "dprast.raster[binned/binned]" in names
    assert "dprast.pullback[binned]" in names
    for stage in ("dprast.b9.slot_prep", "dprast.sort",
                  "dprast.frame_gather", "dprast.b1.splat",
                  "dprast.b2.fold", "dprast.b4.gather",
                  "dprast.b8.epilogue"):
        assert names.count(stage) == 1, (stage, names)
    assert not {n for n in names if n.startswith("dprast.grad.")}, names
