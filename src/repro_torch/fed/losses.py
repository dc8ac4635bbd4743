"""Loss functions binding a model to the FL round step.

``loss_fn(params, microbatch) -> (scalar, metrics)`` where microbatch leaves
are [B, ...] (one local step's batch).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models.model import Model


def make_loss(model: Model) -> Callable:
    def loss_fn(params, microbatch):
        return model.loss(params, microbatch)

    return loss_fn


def make_quadratic_loss(dim: int) -> Callable:
    """The paper's quadratic objective: params {"x": [d]}, batch {"e": [B, d]}."""

    def loss_fn(params, mb):
        d = params["x"][None, :] - mb["e"]
        return torch.mean(torch.sum(d * d, dim=-1)), {}

    return loss_fn
