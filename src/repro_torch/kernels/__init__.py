"""Hand-written Hopper kernels: per kernel a ``ref`` (plain torch, any
device), a ``kernel`` (CUDA wrapper) and an ``ops`` dispatch by device."""
