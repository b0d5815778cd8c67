"""PyTorch / CUDA port of the butterfly-patterned sampling system.

The JAX package ``repro`` stays the reference; every module here has a
twin there of the same path.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``, and a CUDA tensor goes through the
hand-written Hopper kernels (``kernels/*/csrc``), never a silent fallback.
"""
