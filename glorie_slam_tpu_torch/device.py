"""Device selection and numeric settings shared by the entry points.

Entry points default to ``cuda`` and raise when no card is present; the CPU
is used only when the caller asks for it (the tests do).

Float32 settings, stated once here and applied by ``resolve_device``:
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``. The bundle adjustment's
Hessian/Schur products, the geometry and the mapper's kNN need full float32
(the JAX package runs them at ``precision=HIGHEST``; ``ops/knn.py`` refuses
to run with TF32 on); the tracker net runs in bf16 on the
card, where TF32 does not apply either way.
"""

import torch


def set_float32_precision():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"`` -> the card (raises without one); ``"cpu"`` -> CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "glorie_slam_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    set_float32_precision()
    return dev
