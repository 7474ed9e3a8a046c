"""Normalization helpers (counterpart of itrx/ops/norms.py)."""

from __future__ import annotations

import torch

EPS = 1e-8


def safe_sqrt(x: torch.Tensor, tiny: float = 1e-16) -> torch.Tensor:
    """sqrt with the operand clamped at `tiny`: values are unchanged for any
    real input, and masked (all-zero) positions get no infinite gradient."""
    return torch.sqrt(torch.clamp(x, min=tiny))


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = EPS) -> torch.Tensor:
    return x / (safe_sqrt(torch.sum(x * x, dim=dim, keepdim=True)) + eps)
