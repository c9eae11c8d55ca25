"""The share of the time in which no operation ran on the card: one minus
the device's busy time per traced step (the union of the device's intervals
in the profiler's trace, after the window) over the measured window's wall
time per step.  The window sets the pace, since a profiler slows a
host-paced step; the busy time per step does not move under it.  One
reader for every kind of cell, found for `device_idle.<kind>`: each of
those moves its own cells' end-to-end metric, as BENCHMARK.json says, so
this file names none."""

MOVES = None


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.attempted:
        return None
    return 100 * (1 - (tr.busy_s() / tr.steps)
                  / (ctx.window_s / ctx.attempted))
