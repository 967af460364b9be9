"""map_mfu: the least time of the decoders' forward and backward in the
stretch's train steps (rays x samples points, nn_num neighbours, at the
configuration's widths; counted from shapes) at the float32 peak, over the
stretch's seconds, in percent."""

from benchmark.yardstick import flops, peaks


def read(rec):
    t = rec.trace
    calls = rec.calls.get("step")
    if rec.kind != "map" or t is None or not calls or not t.window_s:
        return None
    total = sum(flops.decoder_step(rec.cfg, c["rays"], c["samples"],
                                   c["cap"], c["stage"]) for c in calls)
    return 100.0 * total / peaks.FP32_FLOPS / t.window_s
