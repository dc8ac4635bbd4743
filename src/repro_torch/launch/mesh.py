"""The mesh builders, the clients a setup runs, and the peaks the roofline
divides by (the port of ``repro.launch.mesh``).

The JAX package lays its dry run out on TPU meshes of 16 x 16 chips, or
2 x 16 x 16 with two pods.  The port lays the same axes out on H100 cards
as a ``torch.distributed`` ``DeviceMesh``:

- :func:`make_production_mesh`: (16, 16) ``("data", "model")``, or (2,
  16, 16) ``("pod", "data", "model")``, over a fake process group of 512
  ranks in this one process (``torch.testing``'s ``FakeStore``): it runs
  nothing across ranks and exists for the dry run's count of one rank's
  share on the ``meta`` device.  Its device type is ``cpu`` (DTensor makes
  fake tensors of a mesh's device type to propagate shapes, and a build
  of PyTorch without CUDA makes no ``cuda`` ones), so DTensor moves a
  shard from one dim to another as over gloo, which has no all-to-all:
  by an all-gather and a local chunk.  The dry run counts that move as
  the all-to-all NCCL would run (``dryrun.py:LocalCount``).
- :func:`make_host_mesh`: ``(data, model)`` over the ranks of the process
  group the caller opened (gloo on the CPU; NCCL on the cards, one rank a
  card).
- :func:`dp_axes`, :func:`dp_size`: the batch and client axes of a mesh,
  and their product; :func:`dp_size` also takes a one-card setup's client
  count.

They are functions, so importing this module touches no process group.

The peaks are the H100 SXM's (NVIDIA H100 Tensor Core GPU data sheet; the
Hopper architecture white paper for the SM counts), per card:

- ``BF16_FLOP_PER_S``: dense bf16 on the tensor cores, 989e12 FLOP/s;
- ``FP32_FLOP_PER_S``: float32 outside the tensor cores, 67e12 FLOP/s;
- ``HBM_BYTES_PER_S``: HBM3, 3.35e12 B/s;
- ``INT32_OPS_PER_S``: 64 INT32 lanes an SM x 132 SMs x 1.98 GHz;
- ``INSTR_OPS_PER_S``: 4 schedulers x 32 lanes a clock, 132 SMs at
  1.98 GHz: the fp32 rate of 67 TFLOP/s counts an FMA as two, so 33.4e12
  fp32 instructions a second, which is also the most instructions of any
  mix the SMs dispatch;
- ``NVLINK_BYTES_PER_S``: NVLink 4, 450e9 B/s each way (900 GB/s in all),
  what the roofline's collective term divides a rank's collective bytes
  by.  It is a floor: a 16 x 16 mesh spans 32 nodes of eight cards, and
  the links between nodes are slower than NVLink.

A card whose power limit is set under 700 W runs below them under load.
"""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12        # dense bf16 tensor-core rate
FP32_FLOP_PER_S = 67e12         # float32 outside the tensor cores
INT32_OPS_PER_S = 132 * 64 * 1.98e9
INSTR_OPS_PER_S = 132 * 128 * 1.98e9
NVLINK_BYTES_PER_S = 450e9     # NVLink 4, each way
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"   # as nvidia-smi names the card the peaks are for

PRODUCTION_MESHES = {"16x16": ((16, 16), ("data", "model")),
                     "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is up: the production mesh needs a fake "
                               "one of 256 or 512 ranks in a process of its own")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def make_production_mesh(*, multi_pod: bool = False):
    """The JAX package's production mesh as a ``DeviceMesh`` over a fake
    process group of 512 ranks: (16, 16) ``("data", "model")`` over its
    first 256, or with ``multi_pod`` (2, 16, 16) ``("pod", "data",
    "model")`` over all.  For counting on ``meta``; this process is rank 0
    of both."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = PRODUCTION_MESHES["2x16x16" if multi_pod else "16x16"]
    _fake_group(math.prod(PRODUCTION_MESHES["2x16x16"][0]))
    return DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(shape), mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1):
    """A ``(data, model)`` mesh over the first data x model ranks of the
    process group the caller opened: gloo ranks on the CPU, NCCL ranks on
    the cards."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    assert data * model <= n, (data, model, n)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(data * model).reshape(data, model),
                      mesh_dim_names=("data", "model"))


def dp_axes(mesh) -> tuple:
    """The batch and client axes of a mesh: ('pod', 'data') or ('data',)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def dp_size(mesh_or_clients=1) -> int:
    """The clients a setup runs in parallel: the product of a mesh's data
    axes (the JAX package's ``dp_size``), or on one card, where a setup
    names its clients itself, that count, at least 1."""
    if not isinstance(mesh_or_clients, int):
        from ..dist.sharding import axis_sizes

        sizes = axis_sizes(mesh_or_clients)
        return math.prod(sizes[a] for a in dp_axes(mesh_or_clients))
    if mesh_or_clients < 1:
        raise ValueError(f"a setup runs at least one client, got {mesh_or_clients}")
    return int(mesh_or_clients)
