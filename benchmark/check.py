"""The comparison that decides ``correct``.

Tracking cells: at one keyframe of the window drawn from the seed, the
first call of each checked stage was captured (``probes``): its inputs and
what the program returned. Each stage is recomputed by the plain reference
(``reference/``) from those inputs with the benchmark's own weights, and
each number is the gap between the program's output and the reference's:

* ``dpt`` (its head's output before the last ReLU), ``fnet``, ``cnet``,
  ``update``, ``lookup``: relative L2 gap |prog - ref| / |ref| (for
  ``update`` the worst of its outputs);
* ``dba``: RMS gap, in pixels, of the flow that the solve's poses and
  disparities induce on its edges (``flow_gap``);
* ``dspo``: relative gap of the step the solve made, |prog - ref| /
  |ref - input|, the worst of its outputs;
* ``depth_filter``: the share of agreement counts that differ.

Mapper cell: the reference follows the program's first three train steps
of each stage captured in the window's first keyframe (``geometry``: the
keyframe's first steps; ``color``: the colour stage's first steps, in the
window) from the state before the first of them (decoders, features and
Adam's moments), on the same ray batches. ``loss``: the worst relative gap
of a step's loss; ``grad``: the worst gap between the norms of a leaf's
first gradient (as Adam received it) in the program and the reference,
against the larger of the reference's norm of that leaf and of the median
leaf; ``change``: the same for each leaf's change over the three steps.
Leaves whose reference gradient is under a thousandth of the median leaf's
move by round-off alone and are left out of ``change``. The colour stage's
numbers carry the suffix ``.color``; where the configuration trains the
colour decoder, its leaves and the colour features have to be among those
that ``change`` compares.

A number that is missing, not finite, or over its limit makes the run not
correct. The limits are in ``limits/<cell>.json``.
"""

import math
import sys

import torch

from .reference import mapping as map_ref, projective, tracking as ref
from .reference.precision import Precision


def rel_l2(prog, want):
    prog, want = prog.float(), want.float()
    if prog.shape != want.shape:
        return math.inf
    den = float(torch.linalg.vector_norm(want))
    num = float(torch.linalg.vector_norm(prog - want))
    if not math.isfinite(num):
        return math.inf
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def step_gap(prog, want, start):
    """|prog - want| / |want - start| for the results of one solve."""
    den = float(torch.linalg.vector_norm(want.float() - start.float()))
    num = float(torch.linalg.vector_norm(prog.float() - want.float()))
    if not math.isfinite(num):
        return math.inf
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def flow_gap(args, got, want):
    """The DBA's results compared by the flow they induce on the solve's
    own edges: the RMS, in pixels, of flow(prog) - flow(ref) over the
    pixels valid in the reference. Directions the edges cannot see (the
    gauge, ill-conditioned depth) move no flow and are not compared. A gap
    relative to the step's own flow change swung over four decades from
    keyframe to keyframe, as small steps met float32 rounding of the poses."""
    poses, disps, intr = args[0], args[1], args[2]
    ii = torch.as_tensor(args[6], device=disps.device).long()
    jj = torch.as_tensor(args[7], device=disps.device).long()
    keep = ii >= 0
    ii, jj = ii[keep], jj[keep]

    def flow(p, d):
        return projective.projective_transform(p.float(), d.float(),
                                               intr.float(), ii, jj)
    c_p, _ = flow(got[0], got[1])
    c_r, valid = flow(want[0], want[1])
    m = (valid[..., 0] > 0) & torch.isfinite(c_r).all(-1)
    if not bool(m.any()):
        return math.inf
    gap = float(torch.sqrt(((c_p - c_r)[m] ** 2).sum(-1).mean()))
    return gap if math.isfinite(gap) else math.inf


def tracking_numbers(cap, nets, control=False):
    """Numbers of the captured stages. ``nets``: {"droid": reference DROID
    net, "dpt": reference DPT}. ``control``: the reference in the control's
    precision stands in for the program's outputs."""
    prec = Precision(control)
    base = Precision(False)
    out = {}

    def prog_or_control(program_out, compute):
        return compute(prec) if control else program_out

    if "dpt" in cap:
        c = cap["dpt"]
        want = ref.dpt_head(nets["dpt"], c["x"], base)
        got = prog_or_control(c["out"], lambda p: ref.dpt_head(
            nets["dpt"], c["x"], p))
        out["dpt"] = rel_l2(got, want)
    for enc in ("fnet", "cnet"):
        if enc in cap:
            c = cap[enc]
            want = ref.encoder(nets["droid"], enc, c["args"][0], base)
            got = prog_or_control(c["out"], lambda p: ref.encoder(
                nets["droid"], enc, c["args"][0], p))
            out[enc] = rel_l2(got, want)
    if "update" in cap:
        c = cap["update"]
        want = ref.update(nets["droid"], c["args"], c["kwargs"], base)
        got = prog_or_control(c["out"], lambda p: ref.update(
            nets["droid"], c["args"], c["kwargs"], p))
        out["update"] = max(rel_l2(g, w) for g, w in zip(got, want)
                            if w is not None)
    if "lookup" in cap:
        c = cap["lookup"]
        want = ref.lookup_pyramid(*c["args"], base)
        got = prog_or_control(c["out"],
                              lambda p: ref.lookup_pyramid(*c["args"], p))
        out["lookup"] = rel_l2(got, want)
    if "dba" in cap:
        c = cap["dba"]
        want = ref.dba(c["args"], c["kwargs"], base)
        got = prog_or_control(c["out"],
                              lambda p: ref.dba(c["args"], c["kwargs"], p))
        out["dba"] = flow_gap(c["args"], got, want)
    if "dspo" in cap:
        c = cap["dspo"]
        want = ref.dspo(c["args"], c["kwargs"], base)
        got = prog_or_control(c["out"],
                              lambda p: ref.dspo(c["args"], c["kwargs"], p))
        a = c["args"]
        out["dspo"] = max(step_gap(got[0], want[0], a[1]),
                          step_gap(got[1], want[1], a[7]),
                          step_gap(got[2], want[2], a[8]))
    if "depth_filter" in cap:
        c = cap["depth_filter"]
        a = c["args"]
        want = ref.depth_filter(*a[:5], base)
        got = prog_or_control(c["out"],
                              lambda p: ref.depth_filter(*a[:5], p))
        out["depth_filter"] = float((got.float() != want.float()).float()
                                    .mean())
    return out


def _norms(leaves):
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in leaves.items()}


def _median(values):
    vals = sorted(values)
    if not vals:
        return 0.0
    n = len(vals)
    return 0.5 * (vals[(n - 1) // 2] + vals[n // 2])


def mapping_numbers(cap, cfg, control=False):
    """Numbers of the mapper's captured steps (see the module doc): each
    captured stage's, missing stages' as infinite."""
    out = {}
    for stage, suffix in (("geometry", ""), ("color", ".color")):
        c = cap.get(stage)
        if c is None or "final" not in c:
            nums = dict.fromkeys(("loss", "grad", "change"), math.inf)
        else:
            nums = _stage_numbers(c, cfg, control)
            if (stage == "color"
                    and not cfg["mapping"]["fix_color_decoder"]
                    and not _colour_trained(nums.pop("moved"))):
                nums["change"] = math.inf
            nums.pop("moved", None)
            if any(call["stage"] != stage for call in c["calls"]):
                nums = dict.fromkeys(nums, math.inf)
        out.update({k + suffix: v for k, v in nums.items()})
    return out


def _colour_trained(moved):
    return "col" in moved and any(k.startswith("decoders.color_decoder.")
                                  for k in moved)


def _stage_numbers(cap, cfg, control):
    calls = cap["calls"]
    ref_losses, ref_g1, ref_final = map_ref.train_steps(
        cfg, cap["state"], calls, Precision(False))
    if control:
        losses, g1, final = map_ref.train_steps(cfg, cap["state"], calls,
                                                Precision(True))
    else:
        losses = [_total(l, c) for l, c in zip(cap["losses"], calls)]
        g1, final = cap["grad1"], cap["final"]
    start = {f"decoders.{k}": v for k, v in cap["state"]["decoders"].items()}
    start["geo"], start["col"] = cap["state"]["geo"], cap["state"]["col"]
    out = {"loss": max(
        abs(a - b) / abs(b) if b != 0 else (0.0 if a == b else math.inf)
        for a, b in zip(losses, ref_losses))}
    if len(losses) != len(ref_losses):
        out["loss"] = math.inf

    rg = _norms(ref_g1)
    pg = _norms(g1)
    med_g = _median([v for v in rg.values() if v > 0])
    gaps = {k: abs(pg[k] - rg[k]) / max(rg[k], med_g) for k in rg}
    out["grad"] = max(gaps.values())

    moved = [k for k in rg if rg[k] >= 1e-3 * med_g]
    rc = {k: float(torch.linalg.vector_norm(ref_final[k].float()
                                            - start[k].float()))
          for k in moved}
    pc = {k: float(torch.linalg.vector_norm(final[k].float()
                                            - start[k].float()))
          for k in moved}
    med_c = _median([v for v in rc.values() if v > 0])
    cgaps = {k: abs(pc[k] - rc[k]) / max(rc[k], med_c) for k in moved}
    out["change"] = max(cgaps.values(), default=math.inf)
    for name, g, nr, med in (("grad", gaps, rg, med_g),
                             ("change", cgaps, rc, med_c)):
        if g:
            k = max(g, key=g.get)
            print(f"[{cap['calls'][0]['stage']}{' control' if control else ''}]"
                  f" {name}: worst leaf {k} (reference norm {nr[k]!r}, "
                  f"median leaf {med!r})", file=sys.stderr)
    out = {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}
    out["moved"] = moved
    return out


def _total(loss, call):
    """The loss a step backpropagated, from its parts."""
    w_geo, w_color, w_warp = call["w_losses"]
    total = w_geo * loss["geo_loss"]
    if call["stage"] == "color":
        total += w_color * loss["color_loss"]
    if call["pix_warp"]:
        total += w_warp * loss["warp_loss"]
    return total


def judge(numbers, limits):
    """(correct, [(name, value, limit)]) against ``limits`` {name: limit}:
    every limited number present, finite and within its limit."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        rows.append((name, v, limit))
    return ok, rows
