"""PyTorch + CUDA port of ``repro`` for NVIDIA Hopper.

Mirrors the JAX package's module paths and names.  Imports ``torch``,
numpy and the standard library only -- never JAX, never ``repro``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
