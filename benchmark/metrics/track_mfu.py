"""track_mfu: the least time of the model work the stretch's keyframes
needed, over the stretch's seconds, in percent. The DROID net's
convolutions (encoders per image, the update module per edge and round,
GraphAgg per frame, counted from each call's shapes) at the bf16 peak and
the DPT's forward at the float32 peak (the configuration states bf16 for
the net and float32 with TF32 off for the DPT)."""

from benchmark.yardstick import flops, peaks


def read(rec):
    t = rec.trace
    if rec.kind != "track" or t is None or not t.window_s:
        return None
    net = 0
    for part, b, h, w, frames, with_agg, up in rec.calls.get("net", ()):
        if part in ("fnet", "cnet"):
            net += flops.encoder(part, b, h, w)
        elif part == "update":
            net += flops.update(b, h, w, frames, with_agg, up)
        else:
            net += flops.agg(b, h, w, frames)
    dpt = len(rec.calls.get("dpt", ())) * flops.dpt(rec.dpt_size)
    if not net and not dpt:
        return None
    least = net / peaks.BF16_FLOPS + dpt / peaks.FP32_FLOPS
    return 100.0 * least / t.window_s
