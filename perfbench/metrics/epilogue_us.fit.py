"""epilogue_us.fit: device microseconds a step launched inside the
program's `dprast.b8.epilogue` spans (the binned pullback's B8: on
several tiles E1 `epilogue_rows` and E2 `epilogue_points`, on one tile
`epilogue_tile` and `epilogue_poses`; with per-point weights their
weighted forms, which also write `d_point_weight`), in the attributing
capture of a traced fit run (`perfbench/spans.py`); left out where the
program emits no span."""

from perfbench import spans


def read(ctx):
    return spans.fit_step_us(ctx, ("dprast.b8.epilogue",))
