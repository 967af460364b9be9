"""Size ladders that shape the solver windows.

The JAX package pads edge counts and frame windows to a ladder so XLA
compiles a handful of programs. Most of that padding does not change any
result and the port does not pad. Where a padded size DOES change the
result -- the frame window of the DSPO scale/shift solve and of the 1/8-res
validity refresh (frames inside the window but without edges still get the
mono-prior pull), and the pose/depth windows whose clamping against the
buffer end moves ``kbase`` -- the port computes the same size from the same
ladder, so the two packages solve the same problem.
"""

_LADDER = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024,
           1536, 2048, 3072, 4096, 8192, 16384, 32768, 65536, 131072,
           262144, 524288)


def bucket(n: int) -> int:
    """Round n up to the next ladder size."""
    if n <= 0:
        return _LADDER[0]
    for b in _LADDER:
        if n <= b:
            return b
    raise ValueError(f"size {n} exceeds the largest bucket {_LADDER[-1]}")
