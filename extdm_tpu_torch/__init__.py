"""PyTorch + CUDA port of ExtDM-TPU's DDIM sampling path.

Mirrors the layout of ``extdm_tpu`` (``ops/``, ``nn/``, ``models/lfae/``,
``models/dm/``, ``config.py``) and imports nothing from it. Public functions
keep the JAX package's channels-last layouts: (B, T, H, W, C) for video and
(B, H, W, C) for images. The four hand-written Hopper kernels live in
``csrc/`` and are reached through ``ops/fused_*.py``.
"""
