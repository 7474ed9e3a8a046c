"""Global similarity measures between image and caption embedding sets
(counterpart of itrx/ops/sim.py: `cosine_sim`, `order_sim`).  Both take
(Ni, D) and (Nc, D) and return the (Ni, Nc) grid in fp32."""

from __future__ import annotations

import torch


def cosine_sim(im, s):
    """Inner product of every image with every sentence.  bf16 inputs are
    multiplied in fp32 on their values (the JAX package's fp32
    accumulation)."""
    return torch.matmul(im.float(), s.float().t())


def order_sim(im, s):
    """Order-embedding penalty -||max(0, s - im)||_2, as (Ni, Nc)."""
    diff = torch.clamp(s.float()[:, None, :] - im.float()[None, :, :], min=0.0)
    return -torch.sqrt((diff * diff).sum(dim=-1)).t()
