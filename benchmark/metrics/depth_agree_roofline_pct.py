"""depth_agree_roofline_pct: the least time of every 4-corner depth
agreement in the profiled stretch (yardstick.roofline.depth_agree) over
the device time under the span around cuda_corr.depth_agree, in percent of
the H100 SXM peaks."""

from benchmark.yardstick import roofline


def read(rec):
    t = rec.trace
    calls = rec.calls.get("agree")
    if t is None or not calls:
        return None
    dev = t.span_device_s.get("kernel.depth_agree")
    if not dev:
        return None
    least = sum(roofline.depth_agree_least_s(c["jxs"], c["cu"], c["ht"],
                                             c["wd"]) for c in calls)
    return 100.0 * least / dev
