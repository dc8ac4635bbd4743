"""One card's part of ``repro.launch.mesh``: the clients a setup runs and
the peaks the roofline divides by.

The JAX package lays its dry run out on TPU meshes (``make_production_mesh``,
16 x 16 chips or 2 x 16 x 16; ``make_host_mesh`` for tests) and reads the
client count from the mesh's data axes (``dp_axes``, ``dp_size``).  The
port runs on one NVIDIA H100, where a setup names its clients itself:
:func:`dp_size` is that count.  The mesh functions and ``dist/sharding.py``
lay out several devices and have nothing to run on one card; they are
still to port.

The peaks are the H100 SXM's (NVIDIA H100 Tensor Core GPU data sheet; the
Hopper architecture white paper for the SM counts), per card:

- ``BF16_FLOP_PER_S``: dense bf16 on the tensor cores, 989e12 FLOP/s;
- ``HBM_BYTES_PER_S``: HBM3, 3.35e12 B/s;
- ``INT32_OPS_PER_S``: 64 INT32 lanes an SM x 132 SMs x 1.98 GHz;
- ``INSTR_OPS_PER_S``: 4 schedulers x 32 lanes a clock, 132 SMs at
  1.98 GHz: the fp32 rate of 67 TFLOP/s counts an FMA as two, so 33.4e12
  fp32 instructions a second, which is also the most instructions of any
  mix the SMs dispatch.

A card whose power limit is set under 700 W runs below them under load.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12        # dense bf16 tensor-core rate
INT32_OPS_PER_S = 132 * 64 * 1.98e9
INSTR_OPS_PER_S = 132 * 128 * 1.98e9
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"   # as nvidia-smi names the card the peaks are for


def dp_size(clients: int = 1) -> int:
    """The clients one card's setup runs in parallel (the JAX package's
    product of the mesh's data axes): ``clients``, at least 1."""
    if clients < 1:
        raise ValueError(f"a setup runs at least one client, got {clients}")
    return int(clients)
