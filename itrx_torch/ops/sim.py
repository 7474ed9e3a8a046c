"""Global similarity measures between image and caption embedding sets
(counterpart of itrx/ops/sim.py: `cosine_sim`, `order_sim`, SAEM's `pdist`
and `pdist_cos`, and CAMERA's `multi_view_matching`).  Each returns the
(Ni, Nc) grid in fp32."""

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


def pdist(x1, x2, eps: float = 1e-4):
    """Pairwise euclidean distance sqrt(|x1|^2 - 2 x1 . x2 + |x2|^2 + eps),
    (Ni, D) x (Nc, D) -> (Ni, Nc), computed in fp32 (SAEM's order
    measure)."""
    x1, x2 = x1.float(), x2.float()
    sq1 = (x1 * x1).sum(dim=1)[:, None]
    sq2 = (x2 * x2).sum(dim=1)[None, :]
    return torch.sqrt(sq1 - 2.0 * torch.matmul(x1, x2.t()) + sq2 + eps)


def pdist_cos(x1, x2):
    """Pairwise cosine similarity in fp32, NaN (a zero row) turned into 0
    (SAEM's cosine measure)."""
    x1, x2 = x1.float(), x2.float()
    n1 = x1 / x1.norm(dim=1, keepdim=True)
    n2 = x2 / x2.norm(dim=1, keepdim=True)
    return torch.nan_to_num(torch.matmul(n1, n2.t()), nan=0.0)


def multi_view_matching(imgs, caps):
    """CAMERA: the max over the K views of view . cap, (Ni, K, D) x (Nc, D)
    -> (Ni, Nc).  bf16 inputs are multiplied in fp32 on their values, so the
    (Ni, K, Nc) scores are not rounded to bf16 before the max (the JAX
    package's fp32 accumulation)."""
    scores = torch.einsum("ikd,cd->ikc", imgs.float(), caps.float())
    return scores.amax(dim=1)
