"""Reduction of a ``torch.profiler`` chrome trace to the per-layer numbers.

The traced stretch is the interval of the host range named ``STRETCH``
(opened around the profiled steps, which end in a synchronize). Within it:

* device activity is every kernel, memcpy and memset on any stream; the
  busy time is the length of the union of their intervals, so two streams
  that overlap count once (annotations mirrored on the device timeline are
  not activity);
* a span's device time is the summed duration of the device work launched
  (runtime call, matched by its correlation id) on a host thread while a
  range of that name was open there;
* the idle gaps are the stretches of the window with no device activity,
  each named by the host ranges and the innermost operator open on the
  busiest host thread at the gap's middle.
"""

import bisect
import json
from collections import defaultdict

STRETCH = "bench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")


def load(path):
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def union_length(intervals):
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Reduced:
    """The stretch's numbers, times in seconds."""

    def __init__(self, window_s, busy_s, kernels, span_device_s, device_ops,
                 idle_gaps):
        self.window_s = window_s
        self.busy_s = busy_s
        self.kernels = kernels
        self.span_device_s = span_device_s
        self.device_ops = device_ops
        self.idle_gaps = idle_gaps


def _x(events, cats):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def reduce(events, top=10):
    """Reduce chrome-trace ``events`` (dicts with ph, cat, name, ts, dur in
    microseconds, tid, args) over the ``STRETCH`` range."""
    stretch = [e for e in _x(events, ("user_annotation",))
               if e["name"] == STRETCH]
    if not stretch:
        raise ValueError(f"no '{STRETCH}' range in the trace")
    s0 = min(e["ts"] for e in stretch)
    s1 = max(e["ts"] + e["dur"] for e in stretch)

    dev = [e for e in _x(events, DEVICE_CATS)
           if e["ts"] < s1 and e["ts"] + e["dur"] > s0]
    iv = [(max(e["ts"], s0), min(e["ts"] + e["dur"], s1)) for e in dev]
    busy = union_length(iv)

    by_corr = defaultdict(float)
    op_time = defaultdict(float)
    kernels = 0
    for e in dev:
        d = min(e["ts"] + e["dur"], s1) - max(e["ts"], s0)
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            by_corr[corr] += e["dur"]
        op_time[e["name"]] += d
        kernels += e["cat"] == "kernel"

    spans = defaultdict(list)         # (name, tid) -> [(start, end)]
    for e in _x(events, ("user_annotation",)):
        if e["name"] != STRETCH and e["ts"] < s1 and e["ts"] + e["dur"] > s0:
            spans[(e["name"], e["tid"])].append((e["ts"], e["ts"] + e["dur"]))
    starts = {k: sorted(v) for k, v in spans.items()}
    span_us = defaultdict(float)
    for r in _x(events, ("cuda_runtime", "cuda_driver")):
        corr = r.get("args", {}).get("correlation")
        if corr not in by_corr or not (s0 <= r["ts"] <= s1):
            continue
        for (name, tid), ivs in starts.items():
            if tid != r["tid"]:
                continue
            i = bisect.bisect_right(ivs, (r["ts"], float("inf"))) - 1
            if i >= 0 and ivs[i][0] <= r["ts"] <= ivs[i][1]:
                span_us[name] += by_corr[corr]

    busy_iv = merged(iv)
    gaps, prev = [], s0
    for s, e in busy_iv:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if s1 > prev:
        gaps.append((prev, s1))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = _x(events, HOST_CATS)
    counts = defaultdict(int)
    for e in host:
        counts[e["tid"]] += 1
    main = max(counts, key=counts.get) if counts else None
    host_main = [e for e in host if e["tid"] == main]
    named = []
    for g0, g1 in gaps[:top]:
        mid = 0.5 * (g0 + g1)
        open_ = sorted((e for e in host_main
                        if e["ts"] <= mid <= e["ts"] + e["dur"]),
                       key=lambda e: (e["ts"], -e["dur"]))
        ranges = [e["name"] for e in open_ if e["cat"] == "user_annotation"
                  and e["name"] != STRETCH]
        inner = [e["name"] for e in open_ if e["cat"] != "user_annotation"]
        label = " > ".join(ranges + inner[-1:]) or "no host range"
        named.append([label, (g1 - g0) * 1e-6])
    ops = sorted(op_time.items(), key=lambda kv: -kv[1])[:top]
    return Reduced(
        window_s=(s1 - s0) * 1e-6, busy_s=busy * 1e-6, kernels=kernels,
        span_device_s={k: v * 1e-6 for k, v in span_us.items()},
        device_ops=[[k, v * 1e-6] for k, v in ops], idle_gaps=named)
