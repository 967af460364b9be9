"""The program's own spans and counters, as its tracing registry
(``glorie_slam_tpu_torch.utils.phase_timer.snapshot``) holds them after a
traced run: the sums of the last profiler session, which is the run's
profiled stretch. A program without that registry reads as nothing."""


def registry(rec):
    """(spans {name: {"calls", "host_s"}}, counts {name: total}) of the
    stretch, or None where the run was not traced or the program keeps no
    registry. The program is imported here, when a reader asks."""
    if rec.trace is None or not rec.stretch_units:
        return None
    try:
        from glorie_slam_tpu_torch.utils import phase_timer
    except ImportError:
        return None
    snapshot = getattr(phase_timer, "snapshot", None)
    if snapshot is None:
        return None
    snap = snapshot()
    return snap["spans"], snap["counts"]


def summed(table, prefix, key=None):
    """Sum over the entries whose name starts with ``prefix`` (of field
    ``key`` where the entries are records), or None where there is none."""
    vals = [v if key is None else v[key] for k, v in table.items()
            if k.startswith(prefix)]
    return sum(vals) if vals else None
