"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda``.

    Without a card, None raises instead of quietly running on the CPU:
    callers that want the CPU ask for it with ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")
