"""FedShuffle in PyTorch: the port of the JAX package ``repro`` to CUDA.

Same subpackage layout and module names as ``repro``; every module keeps its
own copy of what it needs and imports neither JAX nor ``repro``.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
