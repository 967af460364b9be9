"""Render evaluation: PSNR, MS-SSIM and LPIPS of re-rendered frames.

Counterpart of ``glorie_slam_tpu/utils/eval_render.py`` (reference
src/utils/eval_render.py:18-247): every mapped keyframe (``eval_kf_imgs``)
and every ``mapping.every_frame``-th frame of the full trajectory
(``eval_imgs``) is rendered at its proxy depth. The file names, dumps and
metric keys are the JAX package's: ``logs/metrics_render_kf.txt`` (with
``lpips_variant``), ``logs/metrics_render_full.txt``, masked depth and
colour ``.npy`` dumps in ``rendered_every_keyframe/`` (the meshing input)
and ``rendered_every_frame/``, and PNGs in ``rerendered_keyframe_image/``
when ``cv2`` is importable (the one step skipped without it, as in the JAX
package). An evaluation that fails raises: the JAX package's best-effort
``try`` blocks are not copied.
"""

import os
import shutil

import numpy as np
import torch

from ..geom import lie
from ..mapping.renderer import render_img
from . import image_metrics


def _write_png(path, color):
    try:
        import cv2
    except ImportError:
        return
    cv2.imwrite(path, (np.clip(color, 0, 1) * 255).astype(np.uint8)[..., ::-1])


def eval_kf_imgs(mapper, suffix=""):
    """Re-render every mapped keyframe and score it (reference
    eval_render.py:18-125). Returns the number of frames scored."""
    printer, out = mapper.printer, mapper.output
    printer.print("Starting re-rendering keyframes...", subsystem="eval")
    render_dir = f"{out}/rendered_every_keyframe{suffix}"
    if os.path.exists(render_dir):
        shutil.rmtree(render_dir)
    os.makedirs(render_dir, exist_ok=True)
    os.makedirs(f"{out}/rerendered_keyframe_image", exist_ok=True)
    lpips = image_metrics.LPIPS().to(mapper.device)

    def metrics(gt, color):
        return (image_metrics.psnr(gt, color),
                image_metrics.ms_ssim(gt, color), float(lpips(gt, color)))

    sums = dict(psnr=0.0, ssim=0.0, lpips=0.0,
                m_psnr=0.0, m_ssim=0.0, m_lpips=0.0)
    cnt = 0
    for kf in mapper.keyframe_dict:
        idx, video_idx = kf["idx"], kf["video_idx"]
        _, gt_color, gt_depth, _ = mapper.frame_reader[idx]
        ret = mapper.render_keyframe_img(video_idx, idx,
                                         mono_depth=kf.get("mono_depth"))
        if ret is None:
            continue
        depth, color, render_depth = ret
        gt_color = np.asarray(gt_color)
        color = np.clip(color, 0, 1)
        _write_png(f"{out}/rerendered_keyframe_image/frame_{idx:05d}.png",
                   color)
        p, s, lp = metrics(gt_color, color)
        sums["psnr"] += p
        sums["ssim"] += s
        sums["lpips"] += lp

        mask = render_depth > 0
        if gt_depth is not None:
            mask = mask & (np.asarray(gt_depth) > 0)
        depth_m = np.where(mask, depth, 0.0)
        gt_m = np.where(mask[..., None], gt_color, 0.0)
        col_m = np.where(mask[..., None], color, 0.0)
        np.save(f"{render_dir}/depth_{idx:05d}", depth_m)
        np.save(f"{render_dir}/color_{idx:05d}", col_m)
        mp, ms, ml = metrics(gt_m, col_m)
        sums["m_psnr"] += mp
        sums["m_ssim"] += ms
        sums["m_lpips"] += ml
        cnt += 1

    if cnt == 0:
        printer.print("No keyframes to render.", subsystem="eval")
        return 0
    # 'untrained' LPIPS numbers are not comparable to the reference's
    # published LPIPS (reference eval_render.py:27-28 loads trained weights)
    lines = [f"lpips_variant: {lpips.variant}"]
    for key, label in [("m_ssim", "avg_masked_ssim"),
                       ("m_psnr", "avg_masked_psnr"),
                       ("m_lpips", "avg_masked_lpips"),
                       ("ssim", "avg_ssim"), ("psnr", "avg_psnr"),
                       ("lpips", "avg_lpips")]:
        lines.append(f"{label}: {sums[key] / cnt}")
        printer.print(f"{label}: {sums[key] / cnt:.4f}", subsystem="eval")
    with open(f"{out}/logs/metrics_render_kf{suffix}.txt", "w+") as fp:
        fp.write("\n".join(lines) + "\n")
    printer.print(f"Finished rendering {cnt} frames.", subsystem="eval")
    return cnt


def eval_imgs(mapper, every_n=None):
    """Re-render every ``every_n``-th frame (``mapping.every_frame``) along
    the full trajectory (reference eval_render.py:126-247), at the poses
    the trajectory filler stored in ``traj/full_traj_w2c.npy``, with the
    frame's cached mono prior completing the proxy depth. Returns the
    number of frames scored."""
    printer, out = mapper.printer, mapper.output
    every_n = every_n or mapper.cfg["mapping"]["every_frame"]
    full_poses_path = f"{out}/traj/full_traj_w2c.npy"
    if not os.path.exists(full_poses_path):
        printer.print("Full trajectory unavailable; skipping eval_imgs.",
                      subsystem="eval")
        return 0
    w2c = torch.as_tensor(np.load(full_poses_path), dtype=torch.float32)
    c2ws = lie.to_matrix(lie.inv(w2c)).numpy()
    render_dir = f"{out}/rendered_every_frame"
    if os.path.exists(render_dir):
        shutil.rmtree(render_dir)
    os.makedirs(render_dir, exist_ok=True)

    npc = mapper.npc
    zeros = torch.zeros((mapper.H, mapper.W), device=mapper.device)
    sums = dict(psnr=0.0, ssim=0.0)
    cnt = 0
    for idx in range(0, len(mapper.frame_reader), every_n):
        _, gt_color, _, _ = mapper.frame_reader[idx]
        c2w = c2ws[idx].copy()
        c2w[:3, 1:3] *= -1
        c2w = mapper._t(c2w)
        mono = mapper._load_mono(idx)
        proxy = npc.get_proxy_render_depth(
            c2w, zeros, mapper._t(mono) if mono is not None else None,
            use_mono_to_complete=mapper.use_mono_to_complete)
        depth, _, color, _, _ = render_img(
            mapper.rcfg, mapper.decoders, c2w, mapper.H, mapper.W,
            mapper.fx, mapper.fy, mapper.cx, mapper.cy, proxy,
            npc.cloud_pos, npc.count, npc.geo_feats, npc.col_feats, None,
            stage="color")
        gt_color = np.asarray(gt_color)
        color = np.clip(color, 0, 1)
        sums["psnr"] += image_metrics.psnr(gt_color, color)
        sums["ssim"] += image_metrics.ms_ssim(gt_color, color)
        np.save(f"{render_dir}/depth_{idx:05d}", depth)
        np.save(f"{render_dir}/color_{idx:05d}", color)
        cnt += 1
    if cnt:
        with open(f"{out}/logs/metrics_render_full.txt", "w+") as fp:
            fp.write(f"avg_psnr: {sums['psnr'] / cnt}\n")
            fp.write(f"avg_ssim: {sums['ssim'] / cnt}\n")
        printer.print(f"full-traj render: avg_psnr {sums['psnr'] / cnt:.3f} "
                      f"({cnt} frames)", subsystem="eval")
    return cnt
