"""Helpers for the port's parity tests: move numpy inputs into both
packages and results back to numpy."""

import numpy as np
import torch


def t(x, dtype=torch.float32):
    """numpy -> CPU torch tensor."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def n(x):
    """JAX array or torch tensor -> float64-free numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def random_poses(rng, N, scale=0.1):
    """(N, 6) twists for lie.exp on both sides."""
    return (rng.normal(size=(N, 6)) * scale).astype(np.float32)
