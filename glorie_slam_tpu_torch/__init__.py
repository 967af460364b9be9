"""GlORIE-SLAM tracking and mapping in PyTorch and CUDA, for NVIDIA Hopper
(H100).

The port of ``glorie_slam_tpu`` (JAX/Pallas, written for TPU). Module
layout and names mirror that package, so each module's counterpart is easy
to find (``geom/lie.py``, ``ops/corr.py``, ``core/factor_graph.py``, ...).
The TPU's Pallas kernels on the tracking path are rewritten by hand in CUDA
C++ under ``csrc/`` and bound through ``ctypes`` (``ops/cuda_kernels.py``).

This package imports ``torch`` and never JAX, flax or PyYAML, and nothing of
``glorie_slam_tpu``. Entry points (``SLAM``, ``Tracker``, ``DepthVideo``,
``TrackerNet``) run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
