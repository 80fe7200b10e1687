"""The volume solves' least time on the chip (``benchmark.roofline3d``, from
the storey, the goal voxel and the sweep count) over the device time of
every operation inside the solve spans, whatever its name."""

from benchmark import roofline3d, volume


def read(run):
    if run.trace is None or not run.trace.device or not run.items:
        return None
    spans = run.trace.named("planner.solve")
    if len(spans) != len(run.items):
        return None
    taken = sum(run.trace.device_time(a, b) for _, a, b in spans)
    if taken <= 0:
        return None
    locked = volume.locked(run.map.obstacle, run.config)
    return 100.0 * roofline3d.solves_least_seconds(locked, run.items) / taken
