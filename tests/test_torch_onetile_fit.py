"""The flagship's fit step on one tile (DiffPointRasterisation.jl's
README.md:191 row, 3-D -> 2-D onto 128^2, at a CPU test's size), through
`dprast_torch.raster` and `torch.autograd.grad`, against the benchmark's
plain reference (`perfbench/references/raster.py`: torch in float64,
sparse, nothing of the port).

Inputs as the benchmark's fit cells make them (`perfbench/inputs.py`,
at the flagship's grid): a cloud N(0, 0.4^2) moved 0.004 off the truth,
rotations about one axis, the reference's render of the truth as the
target; the step is `mean((pred - target)^2)` and the gradients of the
points, the rotations and the translations.  `binned` on the CPU runs the
kernels' plain versions on the single-tile path: B6 writing the tile's
frame, B1 on the tile, B4 reading the cotangent itself, B8's epilogue.
Their spans (`profiling.annotate`) show that path ran and that no stage
of the multi-tile path did.  `auto` takes `xla` on the CPU (the card's
`binned` at these shapes, as `dispatch.resolve_pair` says).  The
`binned_bf16` fast mode is the control: it must fail a tolerance.
"""

import json
import math

import pytest

torch = pytest.importorskip("torch")

import dprast_torch  # noqa: E402
from dprast_torch.ops import dispatch  # noqa: E402
from perfbench import inputs  # noqa: E402
from perfbench.references import raster as ref  # noqa: E402

torch.set_num_threads(2)

F64 = torch.float64
N_POINTS, N_POSES = 2000, 4
SEED = 2 ** 31 + 23
GRIDS = {"128sq": (128, 128), "100x72": (100, 72)}

# Tolerances, each a share of the float64 reference:
# - the forward: the accuracy contract, max |out - ref| over every voxel /
#   max(max |ref|, 1) within 1e-5 (the float32 program reads ~1e-7, the
#   bf16 mode ~1e-3);
# - the loss, |L - L_ref| / L_ref: a mean of 65,536 float32 squares, whose
#   rounding is ~1e-7 of it, so 1e-5;
# - each gradient, ||g - g_ref|| / ||g_ref||: B4 and B8 sum in float32
#   and float64 over 2,000 points a pose (~1e-6 of a norm); a point that
#   float32 puts on the other side of a voxel edge moves its own
#   gradient whole, and 1e-4 leaves that room at 2,000 points while the
#   bf16 mode's rounded cotangent reads ~1e-3.
FWD_TOL, LOSS_TOL, GRAD_TOL = 1e-5, 1e-5, 1e-4
LEAVES = ("points", "rotation", "translation")

ONE_TILE = ("dprast.b6.coords", "dprast.b1.splat", "dprast.scale",
            "dprast.b4.gather", "dprast.b8.epilogue")
MULTI_TILE = ("dprast.b9.slot_prep", "dprast.sort", "dprast.frame_gather",
              "dprast.b2.fold")

# (backend asked, grid, the pair the CPU resolves, within the tolerances)
CASES = {f"{backend}-{g}": (backend, grid, pair, True)
         for backend, pair in (("auto", "xla/xla"),
                               ("binned", "binned/binned"))
         for g, grid in GRIDS.items()}
CASES["binned_bf16-128sq-control"] = ("binned_bf16", GRIDS["128sq"],
                                      "binned_bf16/binned_bf16", False)


def _inputs(grid):
    """The cell's inputs at the test's size -> (points, rotation,
    translation, target)."""
    config = {"grid": list(grid), "n_in": 3, "n_points": N_POINTS,
              "poses_per_call": N_POSES, "pool_poses": N_POSES,
              "points_sigma": 0.4, "translation_sigma": 0.1, "weights": {}}
    data = inputs.make(config, {"init_jitter": 0.004}, SEED, "cpu")
    target = inputs.targets(config, data, ref)[0]
    return data.points, data.rotation[0], data.translation[0], target


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


@pytest.mark.parametrize("case", list(CASES))
def test_onetile_fit_step_against_reference(case, tmp_path):
    backend, grid, pair, sound = CASES[case]
    points, rot, tr, target = _inputs(grid)
    leaves = [t.clone().requires_grad_(True) for t in (points, rot, tr)]

    def step():
        pred = dprast_torch.raster(grid, *leaves, backend=backend)
        loss = torch.mean((pred - target) ** 2)
        return pred.detach(), loss.detach(), torch.autograd.grad(loss,
                                                                 leaves)

    (pred, loss, grads), names = _spans(step, tmp_path)

    # the path that ran
    assert f"dprast.raster[{pair}]" in names
    assert f"dprast.pullback[{pair.split('/')[1]}]" in names
    if pair.startswith("binned"):
        for stage in ONE_TILE:
            assert names.count(stage) == 1, (stage, names)
        assert not set(MULTI_TILE) & set(names), names
    # on the card `auto` takes the single-tile binned path here and at the
    # flagship's 10^5 points
    for n in (N_POINTS, 100_000):
        assert dispatch.resolve_pair("auto", 2, grid, n, accelerator=True) \
            == ("binned", "binned")

    want = ref.fit_step(grid, points.to(F64), rot.to(F64), tr.to(F64),
                        target)
    got = {
        "out_err": ref.forward_error(grid, pred, points, rot, tr),
        "loss_gap": abs(float(loss) - want.loss) / want.loss}
    for name, g, g_ref in zip(LEAVES, grads, (want.d_points, want.d_rotation,
                                              want.d_translation)):
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
