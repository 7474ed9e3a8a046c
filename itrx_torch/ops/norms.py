"""Normalization helpers (counterpart of itrx/ops/norms.py)."""

from __future__ import annotations

import torch

EPS = 1e-8


def safe_sqrt(x: torch.Tensor, tiny: float = 1e-16) -> torch.Tensor:
    """sqrt with the operand clamped at `tiny`: values are unchanged for any
    real input, and masked (all-zero) positions get no infinite gradient."""
    return torch.sqrt(torch.clamp(x, min=tiny))


def l1norm(x: torch.Tensor, dim: int = -1, eps: float = EPS) -> torch.Tensor:
    return x / (torch.sum(torch.abs(x), dim=dim, keepdim=True) + eps)


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = EPS) -> torch.Tensor:
    return x / (safe_sqrt(torch.sum(x * x, dim=dim, keepdim=True)) + eps)


def f_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch.nn.functional.normalize semantics, x / max(|x|, eps), with the
    norm's operand floored at eps^2 as `safe_sqrt` floors it."""
    n = safe_sqrt(torch.sum(x * x, dim=dim, keepdim=True), tiny=eps * eps)
    return x / torch.clamp(n, min=eps)
