"""Global similarity measures between image and caption embedding sets
(counterpart of itrx/ops/sim.py: `cosine_sim`, `order_sim` and CAMERA's
`multi_view_matching`).  Each returns the (Ni, Nc) grid in fp32."""

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


def multi_view_matching(imgs, caps):
    """CAMERA: the max over the K views of view . cap, (Ni, K, D) x (Nc, D)
    -> (Ni, Nc).  bf16 inputs are multiplied in fp32 on their values, so the
    (Ni, K, Nc) scores are not rounded to bf16 before the max (the JAX
    package's fp32 accumulation)."""
    scores = torch.einsum("ikd,cd->ikc", imgs.float(), caps.float())
    return scores.amax(dim=1)
