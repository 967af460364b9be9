"""corr_lookup_roofline_pct: the least time of every 4-level correlation
lookup in the profiled stretch (yardstick.roofline.lookup_pyramid, counted
from each call's inputs) over the device time under the span around
cuda_corr.lookup_pyramid, in percent of the H100 SXM peaks."""

from benchmark.yardstick import roofline


def read(rec):
    t = rec.trace
    calls = rec.calls.get("lookup")
    if t is None or not calls:
        return None
    dev = t.span_device_s.get("kernel.lookup_pyramid")
    if not dev:
        return None
    least = sum(roofline.lookup_pyramid_least_s(
        c["iis"], c["jjs"], c["coords"], c["dims"], shared=c["shared"])
        for c in calls)
    return 100.0 * least / dev
