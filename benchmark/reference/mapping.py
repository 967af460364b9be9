"""Plain reference of the mapper's train step (render -> losses -> gradients
-> Adam), after ``glorie_slam_tpu_torch/mapping/mapper.py``'s
``_map_train_step``: the renderer, kNN and decoders are the frozen copies
beside this file, and Adam is written out (betas 0.9 / 0.999, eps 1e-8,
bias-corrected, one learning rate per group: decoders, geometry features,
colour features).

``train_steps`` follows the program's steps from the state before the
first (decoder weights, features, cloud, and Adam's moments and step count
where the optimizer has made steps before) on the ray batches that those
steps received.
"""

import torch

from .decoders import PointDecoders
from .renderer import RenderConfig, render_rays

_X_FLIP = (-1.0, 1.0, 1.0)
BETAS = (0.9, 0.999)
EPS = 1e-8


def smooth_l1(x, beta=0.1):
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def pix_warping_loss(rays_o, rays_d, depth, gt_color, ray_frame_slot,
                     frame_valid, c2ws, img_colors, intr, Wi, Hi):
    fx, fy, cx, cy = intr
    F = c2ws.shape[0]
    pts = rays_o + rays_d * depth[:, None]
    w2cs = torch.linalg.inv(c2ws)
    cam = (torch.einsum("fij,rj->fri", w2cs[:, :3, :3], pts)
           + w2cs[:, None, :3, 3])
    cam = cam * cam.new_tensor(_X_FLIP)
    z = cam[..., 2]
    u = fx * cam[..., 0] / (z + 1e-6) + cx
    v = fy * cam[..., 1] / (z + 1e-6) + cy
    edge = 5
    ok = (u > edge) & (u < Wi - edge) & (v > edge) & (v < Hi - edge) & (z < 0)
    ok = ok & frame_valid[:, None]
    frames = torch.arange(F, device=depth.device)
    ok = ok & (ray_frame_slot < F)[None, :]
    ok = ok & (ray_frame_slot[None, :] != frames[:, None])
    ok = ok & (torch.sum(ok, dim=0) >= 4)[None, :]
    uu = (u - 0.5).clamp(0.0, Wi - 1.0)
    vv = (v - 0.5).clamp(0.0, Hi - 1.0)
    u0 = torch.floor(uu).long().clamp(0, Wi - 1)
    v0 = torch.floor(vv).long().clamp(0, Hi - 1)
    u1 = (u0 + 1).clamp(max=Wi - 1)
    v1 = (v0 + 1).clamp(max=Hi - 1)
    du = (uu - u0)[..., None]
    dv = (vv - v0)[..., None]
    f = frames[:, None]
    warped = ((1 - dv) * ((1 - du) * img_colors[f, v0, u0]
                          + du * img_colors[f, v0, u1])
              + dv * ((1 - du) * img_colors[f, v1, u0]
                      + du * img_colors[f, v1, u1]))
    per = torch.mean(smooth_l1(warped - gt_color[None], beta=0.1), dim=-1)
    cnt = torch.sum(ok).clamp(min=1)
    return torch.sum(torch.where(ok, per, torch.zeros_like(per))) / cnt


def decoders_module(cfg, device):
    """A float32 ``PointDecoders`` of the configuration's widths, built on
    the meta device (its weights come from ``train_steps``' state)."""
    m, pc = cfg["model"], cfg["pointcloud"]
    with torch.device("meta"):
        dec = PointDecoders(
            c_dim=m["c_dim"], use_view_direction=m["use_view_direction"],
            encode_viewd=m["encode_viewd"],
            encode_rel_pos=m["encode_rel_pos_in_col"],
            weighting=pc["nn_weighting"], min_nn_num=pc["min_nn_num"])
    return dec.to_empty(device=device)


def step_loss(dec, call, geo, col):
    """The loss of one captured step -> (loss, (geo, color, warp))."""
    rcfg = RenderConfig(*call["rcfg"])
    w_geo, w_color, w_warp = call["w_losses"]
    render_depth = call["render_depth"]
    depth, _, color, _, _ = render_rays(
        rcfg, dec, call["rays_o"], call["rays_d"], render_depth,
        call["cloud_pos"], call["count"], geo, col, call["r_query"],
        call["stage"])
    depth_mask = (render_depth > 0) & torch.isfinite(depth) & \
        call["inside_mask"]
    geo_loss = torch.sum(torch.where(depth_mask, (render_depth - depth).abs(),
                                     torch.zeros_like(depth)))
    loss = w_geo * geo_loss
    color_err = (call["gt_color"] - color).abs()
    color_loss = torch.sum(torch.where(depth_mask[:, None], color_err,
                                       torch.zeros_like(color_err)))
    if call["stage"] == "color":
        loss = loss + w_color * color_loss
    warp_loss = torch.zeros((), device=depth.device)
    if call["pix_warp"]:
        warp_loss = pix_warping_loss(
            call["rays_o"], call["rays_d"], depth, call["gt_color"],
            call["ray_frame_slot"], call["frame_valid"], call["c2ws"],
            call["img_colors"], call["intr"], call["Wi"], call["Hi"])
        loss = loss + w_warp * warp_loss
    return loss, (geo_loss, color_loss, warp_loss)


def train_steps(cfg, state, calls, prec):
    """Run ``calls`` (captured step arguments) from ``state`` ({"decoders":
    {name: tensor}, "buffers", "geo", "col", "adam": None or {"m", "v":
    {leaf: tensor}, "t": steps made}}). Returns (losses [float], first
    gradients {leaf: tensor} as Adam received them, final leaves {leaf:
    tensor})."""
    dev = state["geo"].device
    dec = decoders_module(cfg, dev)
    dec.load_state_dict(state["buffers"], strict=False)
    params = {f"decoders.{k}": v.detach().clone().float()
              for k, v in state["decoders"].items()}
    params["geo"] = state["geo"].detach().clone().float()
    params["col"] = state["col"].detach().clone().float()
    group = {k: (0 if k.startswith("decoders.") else 1 if k == "geo" else 2)
             for k in params}
    adam = state.get("adam")
    if adam is None:
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        v2 = {k: torch.zeros_like(v) for k, v in params.items()}
        t0 = 0
    else:
        m = {k: adam["m"][k].detach().clone().float() for k in params}
        v2 = {k: adam["v"][k].detach().clone().float() for k in params}
        t0 = adam["t"]
    losses, first_grads = [], None
    for t, call in enumerate(calls, start=t0 + 1):
        leaves = {k: p.clone().requires_grad_(True) for k, p in
                  params.items()}
        for name, p in leaves.items():
            if name.startswith("decoders."):
                _set(dec, name[len("decoders."):], p)
        with prec.products():
            loss, _ = step_loss(dec, call, leaves["geo"], leaves["col"])
            grads = torch.autograd.grad(
                loss, list(leaves.values()), allow_unused=True)
        losses.append(float(loss.detach()))
        grads = {k: (torch.zeros_like(leaves[k]) if g is None else g.detach())
                 for k, g in zip(leaves, grads)}
        fmask = call["feat_mask"]
        grads["geo"] = grads["geo"] * fmask
        grads["col"] = grads["col"] * fmask
        for k in grads:
            if k.startswith("decoders."):
                grads[k] = grads[k] * call["dec_mask"][k.split(".")[1]]
        if first_grads is None:
            first_grads = grads
        b1, b2 = BETAS
        for k, g in grads.items():
            m[k] = b1 * m[k] + (1 - b1) * g
            v2[k] = b2 * v2[k] + (1 - b2) * g * g
            mh = m[k] / (1 - b1 ** t)
            vh = v2[k] / (1 - b2 ** t)
            lr = call["lrs"][group[k]]
            params[k] = params[k] - lr * mh / (vh.sqrt() + EPS)
    return losses, first_grads, params


def _set(module, dotted, tensor):
    """Put ``tensor`` in the place of the parameter ``dotted``."""
    *path, leaf = dotted.split(".")
    for p in path:
        module = getattr(module, p)
    module._parameters[leaf] = tensor
