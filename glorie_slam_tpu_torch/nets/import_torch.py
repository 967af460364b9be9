"""Load the pretrained DROID tracker checkpoint (``droid.pth``).

Counterpart of ``glorie_slam_tpu/nets/import_torch.load_droid_checkpoint``.
The file is a plain PyTorch state_dict saved from a DataParallel model, so
its keys carry a ``module.`` prefix; the update module's ``weight.2`` and
``delta.2`` heads have 3 output rows, of which the tracker uses the first 2
(reference slam.py:70-81). The port's ``DroidNet`` keeps the checkpoint's
names and layouts, so nothing else changes.
"""

from typing import Dict

import torch

HEADS = ("update.weight.2", "update.delta.2")


def droid_state_dict(raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Strip ``module.`` and slice the two heads to 2 output rows."""
    state = {k.replace("module.", ""): v for k, v in raw.items()}
    for head in HEADS:
        for part in ("weight", "bias"):
            key = f"{head}.{part}"
            if key in state and state[key].shape[0] > 2:
                state[key] = state[key][:2].contiguous()
    return state


def load_droid_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """``droid.pth`` -> a state_dict for ``DroidNet`` (on the CPU)."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    return droid_state_dict(raw)
