"""Convex upsampling of 1/8-resolution fields.

Counterpart of ``glorie_slam_tpu/ops/upsample.py``: each output pixel of an
8x8 block is a softmax-weighted convex combination of the 3x3 low-res
neighbourhood (zero-padded, row-major (dy, dx) order as ``F.unfold``).
"""

import torch
import torch.nn.functional as F


def cvx_upsample(data, mask):
    """data (B, ht, wd, D), mask (B, 576, ht, wd) -> (B, 8ht, 8wd, D)."""
    B, ht, wd, D = data.shape
    mask = torch.softmax(mask.reshape(B, 9, 8, 8, ht, wd), dim=1)
    patches = F.unfold(data.permute(0, 3, 1, 2), 3, padding=1)
    patches = patches.reshape(B, D, 9, ht, wd)
    # up[b, d, y, x, h, w] = sum_n mask[b,n,y,x,h,w] * patches[b,d,n,h,w],
    # summed elementwise in n order: a batched product's rounding on the
    # card depends on the batch size, and edge-sharded ranks upsample
    # different frame counts
    up = mask[:, None, 0] * patches[:, :, 0, None, None]
    for n in range(1, 9):
        up = up + mask[:, None, n] * patches[:, :, n, None, None]
    return up.permute(0, 4, 2, 5, 3, 1).reshape(B, 8 * ht, 8 * wd, D)


def upsample_disp(disp, mask):
    """disp (B, ht, wd), mask (B, 576, ht, wd) -> (B, 8ht, 8wd)."""
    return cvx_upsample(disp[..., None], mask)[..., 0]
