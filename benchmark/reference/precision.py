"""Precision of the plain reference, and of its control.

The reference computes every stage in float32 with TF32 off. The control is
the same reference put in the program's place one precision step below what
the configuration states for each stage:

* float32 matrix products and convolutions (the DPT, the BA's products, the
  mapper's decoders and kNN) run with TF32 on;
* the bf16 stages (the DROID net's convolutions, the correlation lookup of
  bf16 feature stores) take their inputs and weights rounded to fp8 e4m3,
  each tensor scaled so that its largest magnitude maps to e4m3's largest;
* float32 stages without products (the depth filter's reprojection, the
  DSPO scale/shift solve) take their floating inputs rounded to bf16, and
  so does the DBA solve besides its TF32 products (measured on the card:
  TF32 alone moved its result no more than two float32 summation orders).
"""

import contextlib

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def float32_products(tf32):
    """TF32 on (the control) or off (the reference) for matmuls and cuDNN
    convolutions; the previous settings come back on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(x):
    """x rounded to scaled fp8 e4m3 and back to float32."""
    x = x.float()
    amax = x.abs().max()
    if not torch.isfinite(amax) or amax == 0:
        return x
    s = FP8_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).float() / s


def bf16_round(x):
    return x.to(torch.bfloat16).float() if x.is_floating_point() else x


class Precision:
    """``control=False``: the reference; ``control=True``: its control."""

    def __init__(self, control=False):
        self.control = control

    def products(self):
        return float32_products(self.control)

    def low(self, x):
        """A bf16 stage's input: float32, or fp8-rounded in the control."""
        return fp8_round(x) if self.control else x.float()

    def plain(self, x):
        """A product-free float32 stage's input (bf16-rounded in the
        control)."""
        if not torch.is_tensor(x) or not x.is_floating_point():
            return x
        return bf16_round(x) if self.control else x.float()

    @contextlib.contextmanager
    def low_convs(self, module):
        """Round every conv's input and weight to fp8 while ``module`` runs
        (the control of a bf16 net); nothing in the reference."""
        if not self.control:
            yield
            return
        saved = {}
        hooks = []
        with torch.no_grad():
            for m in module.modules():
                if isinstance(m, torch.nn.Conv2d):
                    saved[m] = m.weight.detach().clone()
                    m.weight.copy_(fp8_round(m.weight))
                    hooks.append(m.register_forward_pre_hook(
                        lambda _m, a: (fp8_round(a[0]),) + tuple(a[1:])))
        try:
            yield
        finally:
            for h in hooks:
                h.remove()
            with torch.no_grad():
                for m, w in saved.items():
                    m.weight.copy_(w)
