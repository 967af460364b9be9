"""Loader of the omnidata DPT checkpoint (``omnidata_dpt_depth_v2.ckpt``).

Counterpart of ``glorie_slam_tpu/mapping/import_dpt.py``. The port's
``DPTDepthModel`` keeps the checkpoint's names, so loading strips the
leading ``model.`` from every ``state_dict`` key (reference
mono_estimators.py:17-31), resizes ``pos_embed`` from the checkpoint's
24x24 grid to the inference grid (bilinear, ``align_corners=False``, no
antialias: vit.py:102-116) and raises on any tensor the model lacks, any
tensor of the model the checkpoint lacks, and any shape mismatch.

``flax_path`` maps a checkpoint key to the JAX package's flax parameter path
(a copy of that package's ``_map_key``); ``nets/import_flax`` carries JAX
DPT params into this port's ``state_dict`` through it.
"""

import re

import torch
import torch.nn.functional as F


def resize_pos_embed(pos, grid):
    """(1, 1 + s*s, D) -> (1, 1 + gh*gw, D): the class token kept, the
    square token grid resized bilinearly (``align_corners=False``, no
    antialias)."""
    cls, tokens = pos[:, :1], pos[:, 1:]
    n, dim = tokens.shape[1], tokens.shape[2]
    side = int(round(n ** 0.5))
    if side * side != n:
        raise ValueError(f"pos_embed of {n} tokens is not a square grid")
    g = tokens.reshape(1, side, side, dim).permute(0, 3, 1, 2)
    g = F.interpolate(g, size=tuple(grid), mode="bilinear",
                      align_corners=False, antialias=False)
    return torch.cat([cls, g.permute(0, 2, 3, 1).reshape(1, -1, dim)], 1)


def load_omnidata_checkpoint(path, model):
    """Load ``path`` (a Lightning checkpoint with ``state_dict``, or a plain
    state dict) into ``model`` (a ``DPTDepthModel`` built at its inference
    size). Raises on any unmapped or mismatched tensor."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in raw:
        raw = {k[6:] if k.startswith("model.") else k: v
               for k, v in raw["state_dict"].items()}
    target = model.state_dict()
    state, unmapped, mismatched = {}, [], []
    for k, v in raw.items():
        v = torch.as_tensor(v)
        if k not in target:
            unmapped.append(k)
            continue
        if k.endswith("pos_embed") and v.shape != target[k].shape:
            v = resize_pos_embed(v, model.grid)
        if v.shape != target[k].shape:
            mismatched.append((k, tuple(target[k].shape), tuple(v.shape)))
            continue
        state[k] = v.float()
    missing = sorted(set(target) - set(state) - {m[0] for m in mismatched})
    if unmapped or mismatched or missing:
        raise ValueError(f"DPT import failed: unmapped={unmapped[:8]} "
                         f"mismatched={mismatched[:8]} missing={missing[:8]}")
    model.load_state_dict(state)
    print(f"[dpt-import] loaded {len(state)} tensors")
    return model


_HEAD = {"0": "head_conv1", "2": "head_conv2", "4": "head_conv3"}


def _leaf(name):
    return "kernel" if name == "weight" else "bias"


def _norm_leaf(name):
    return "scale" if name == "weight" else "bias"


def flax_path(k):
    """Checkpoint key -> (flax param path, kind), kind one of "conv" (OIHW
    <-> HWIO), "linear" (transposed), "raw"; (None, None) for a key the JAX
    model has no parameter for."""
    p = k.split(".")
    if p[0] == "pretrained" and p[1] == "model":
        r = p[2:]
        if r[0] == "patch_embed" and r[1] == "proj":
            return ("patch_embed", _leaf(r[2])), (
                "conv" if r[2] == "weight" else "raw")
        if r[0] == "patch_embed" and r[1] == "backbone":
            b = r[2:]
            if b[0] == "stem" and b[1] == "conv":
                return ("backbone", "stem_conv", "kernel_raw"), "conv"
            if b[0] == "stem" and b[1] == "norm":
                return ("backbone", "stem_norm", "gn", _norm_leaf(b[2])), "raw"
            if b[0] == "stages":
                mod = ("backbone", f"stage{b[1]}_{b[3]}")
                leaf = b[4]
                if leaf in ("conv1", "conv2", "conv3"):
                    return mod + (leaf, "kernel_raw"), "conv"
                if leaf in ("norm1", "norm2"):
                    return mod + (leaf, "gn", _norm_leaf(b[5])), "raw"
                if leaf == "norm3":
                    return mod + ("norm3", _norm_leaf(b[5])), "raw"
                if leaf == "downsample" and b[5] == "conv":
                    return mod + ("downsample_conv", "kernel_raw"), "conv"
                if leaf == "downsample" and b[5] == "norm":
                    return mod + ("downsample_norm", _norm_leaf(b[6])), "raw"
            return None, None
        if r[0] in ("cls_token", "pos_embed"):
            return (r[0],), "raw"
        if r[0] == "blocks":
            base, sub = (f"block_{r[1]}",), r[2:]
            if sub[0] in ("norm1", "norm2"):
                return base + (sub[0], _norm_leaf(sub[1])), "raw"
            if sub[0] == "attn":
                return base + ("attn", sub[1], _leaf(sub[2])), (
                    "linear" if sub[2] == "weight" else "raw")
            if sub[0] == "mlp":
                return base + (f"mlp_{sub[1]}", _leaf(sub[2])), (
                    "linear" if sub[2] == "weight" else "raw")
            return None, None
        if r[0] == "norm":
            return ("norm", _norm_leaf(r[1])), "raw"
        return None, None
    if p[0] == "pretrained":
        m = re.match(r"act_postprocess([34])$", p[1])
        if m:
            lvl, idx, leaf = m.group(1), p[2], _leaf(p[-1])
            name = {"0": f"reassemble{lvl}_readout",
                    "3": f"reassemble{lvl}_proj",
                    "4": "reassemble4_down"}.get(idx)
            if name is not None and not (idx == "4" and lvl == "3"):
                kind = "linear" if idx == "0" else "conv"
                return (name, leaf), kind if leaf == "kernel" else "raw"
        return None, None
    if p[0] == "scratch":
        leaf = _leaf(p[-1])
        kind = "conv" if leaf == "kernel" else "raw"
        if re.match(r"layer[1-4]_rn$", p[1]):
            return (p[1], "kernel"), "conv"
        if re.match(r"refinenet[1-4]$", p[1]):
            if p[2] == "out_conv":
                return (p[1], "out_conv", leaf), kind
            m = re.match(r"resConfUnit([12])$", p[2])
            if m:
                return (p[1], f"rcu{m.group(1)}", p[3], leaf), kind
        if p[1] == "output_conv" and p[2] in _HEAD:
            return (_HEAD[p[2]], leaf), kind
    return None, None
