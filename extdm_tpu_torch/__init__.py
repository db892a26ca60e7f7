"""PyTorch + CUDA port of ExtDM-TPU's DDIM sampling path and DM train step.

Mirrors the layout of ``extdm_tpu`` (``ops/``, ``nn/``, ``models/lfae/``,
``models/dm/``, ``train/``, ``config.py``) and imports nothing from it.
Public functions keep the JAX package's channels-last layouts: (B, T, H, W, C)
for video and (B, H, W, C) for images. The hand-written Hopper kernels (four
forward, three backward) live in ``csrc/`` and are reached through
``ops/fused_*.py``.
"""
