"""PyTorch + CUDA port of ExtDM-TPU's DDIM sampling path, DM train step and
stage-1 (LFAE) train step.

Mirrors the layout of ``extdm_tpu`` (``ops/``, ``nn/``, ``models/lfae/``,
``models/dm/``, ``train/``, ``parallel/``, ``config.py``) and imports
nothing from it.
Public functions keep the JAX package's channels-last layouts: (B, T, H, W, C)
for video and (B, H, W, C) for images. The hand-written Hopper kernels (four
forward, four backward) live in ``csrc/`` and are reached through
``ops/fused_*.py``.
"""
