"""SCAN t2i stacked cross-attention score grid (counterpart of the t2i path
of itrx/ops/attention.py).

For the pair (image i, caption c) and word l,

    row_sim_l = cos(cap_cl, sum_r attn_lr * img_ir)

and both the numerator sum_r attn_lr * (img_ir . cap_cl) and the context norm
|sum_r attn_lr img_ir|^2 = attn^T G_i attn (G_i the R x R region Gram) are
functions of the raw dot tensor A[i, c, r, l] and the tiny per-image Grams,
so no per-pair context vector is ever materialized (the Gram trick).

This is the plain path: every `raw_feature_norm` and aggregation.  The
CUDA kernel for the published SCAN variants is itrx_torch.ops.kernels.xattn.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .norms import safe_sqrt

EPS = 1e-8
NEG_INF = -1e18


def _normalize_raw_attn(attn, norm: str, dim: int, mask=None):
    """Apply `raw_feature_norm` over `dim`; `mask` (1 = valid, broadcastable)
    zeroes invalid positions so they do not leak into the norm."""
    if mask is not None:
        attn = attn * mask
    if norm == "softmax":
        if mask is not None:
            attn = torch.where(mask > 0, attn, torch.full_like(attn, NEG_INF))
        attn = torch.softmax(attn, dim=dim)
        if mask is not None:
            attn = attn * mask
    elif norm == "l2norm":
        attn = attn / (safe_sqrt(torch.sum(attn * attn, dim=dim, keepdim=True)) + EPS)
    elif norm == "clipped_l2norm":
        attn = F.leaky_relu(attn, negative_slope=0.1)
        if mask is not None:
            attn = attn * mask
        attn = attn / (safe_sqrt(torch.sum(attn * attn, dim=dim, keepdim=True)) + EPS)
    elif norm == "l1norm":
        attn = attn / (torch.sum(torch.abs(attn), dim=dim, keepdim=True) + EPS)
    elif norm == "clipped_l1norm":
        attn = F.leaky_relu(attn, negative_slope=0.1)
        if mask is not None:
            attn = attn * mask
        attn = attn / (torch.sum(torch.abs(attn), dim=dim, keepdim=True) + EPS)
    elif norm == "clipped":
        attn = F.leaky_relu(attn, negative_slope=0.1)
        if mask is not None:
            attn = attn * mask
    elif norm != "no_norm":
        raise ValueError(f"unknown first norm type: {norm}")
    return attn


def _aggregate(row_sim, agg_func: str, lambda_lse: float, mask, dim: int):
    """Aggregate per-word similarities over `dim` with validity `mask`."""
    if agg_func == "LogSumExp":
        e = torch.exp(row_sim * lambda_lse) * mask
        return torch.log(torch.sum(e, dim=dim)) / lambda_lse
    if agg_func == "Max":
        return torch.amax(
            torch.where(mask > 0, row_sim, torch.full_like(row_sim, NEG_INF)),
            dim=dim,
        )
    if agg_func == "Sum":
        return torch.sum(row_sim * mask, dim=dim)
    if agg_func == "Mean":
        return torch.sum(row_sim * mask, dim=dim) / torch.clamp(
            torch.sum(mask, dim=dim), min=1.0
        )
    raise ValueError(f"unknown aggfunc: {agg_func}")


def xattn_score_t2i(
    images,
    captions,
    cap_mask,
    *,
    raw_feature_norm: str = "clipped_l2norm",
    agg_func: str = "LogSumExp",
    lambda_lse: float = 6.0,
    lambda_softmax: float = 9.0,
):
    """images (Ni, R, D); captions (Nc, L, D); cap_mask (Nc, L), 1 = valid.

    Returns the (Ni, Nc) fp32 score grid.  Products accumulate in fp32 (the
    operands are upcast, which is exact for bf16 values); the elementwise
    chain runs in the input dtype, as in the JAX package.
    """
    wd = images.dtype
    qmask = cap_mask.float()  # (Nc, L)
    im32 = images.float()
    # raw dots A[i, c, r, l] = img_ir . cap_cl
    a = torch.einsum("ird,cld->icrl", im32, captions.float())
    work = a.to(wd)
    # func_attention: raw_feature_norm over the word axis, masked
    attn = _normalize_raw_attn(
        work, raw_feature_norm, dim=3, mask=qmask[None, :, None, :].to(wd)
    )
    # temperature softmax over the regions
    attn = torch.softmax(attn * lambda_softmax, dim=2)  # (Ni, Nc, R, L)

    num = torch.sum((attn * work).float(), dim=2)  # (Ni, Nc, L)
    gram = torch.einsum("ird,isd->irs", im32, im32)  # (Ni, R, R) fp32
    gattn = torch.einsum("irs,icsl->icrl", gram.to(wd).float(), attn.float())
    ctx_sq = torch.sum(attn.float() * gattn, dim=2)  # (Ni, Nc, L)
    cap_norm = safe_sqrt(torch.sum((captions * captions).float(), dim=-1))
    denom = torch.clamp(safe_sqrt(ctx_sq) * cap_norm[None], min=EPS)
    row_sim = num / denom
    return _aggregate(row_sim, agg_func, lambda_lse, qmask[None], dim=2)
