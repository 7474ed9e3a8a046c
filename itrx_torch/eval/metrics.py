"""Recall@K ranking metrics (counterpart of itrx/eval/metrics.py).

Ranks are computed by counting, with no sort:

    rank(gt) = #{scores strictly greater} + #{exact ties at a higher index}

The tie term reproduces the reference's reversed-argsort order, which
matters for bf16 sims where exact ties are likely.  `sims[i, c]` scores
image i against caption c; captions cap_ratio*i .. cap_ratio*i+cap_ratio-1
belong to image i.
"""

from __future__ import annotations

import numpy as np
import torch


def _stats_from_ranks(ranks: torch.Tensor) -> tuple[float, ...]:
    """(r1, r5, r10, medr, meanr) in float64, as the reference computes them
    with numpy (np.floor(np.median(ranks)) + 1 averages the two middle
    ranks of an even count).  The JAX package computes them in fp32, where
    XLA's CPU division is not always correctly rounded (300/9 gives
    33.333336), so the two agree to an fp32 rounding."""
    r = ranks.cpu().numpy()
    n = len(r)
    return (
        float(100.0 * np.sum(r < 1) / n),
        float(100.0 * np.sum(r < 5) / n),
        float(100.0 * np.sum(r < 10) / n),
        float(np.floor(np.median(r)) + 1),
        float(r.mean() + 1),
    )


def i2t_ranks(sims: torch.Tensor, cap_ratio: int = 5) -> torch.Tensor:
    """Per-image best rank over its cap_ratio ground-truth captions."""
    n, n_cap = sims.shape
    dev = sims.device
    gt_cols = (torch.arange(n, device=dev)[:, None] * cap_ratio
               + torch.arange(cap_ratio, device=dev)[None, :])  # (N, cap_ratio)
    gt = torch.gather(sims, 1, gt_cols)
    cmp = sims[:, None, :]  # (N, 1, n_cap)
    greater = torch.sum(cmp > gt[:, :, None], dim=-1)
    ties_after = torch.sum(
        (cmp == gt[:, :, None])
        & (torch.arange(n_cap, device=dev)[None, None, :] > gt_cols[:, :, None]),
        dim=-1,
    )
    return torch.min(greater + ties_after, dim=1).values


def t2i_ranks(sims: torch.Tensor, cap_ratio: int = 5) -> torch.Tensor:
    """Per-caption rank of its ground-truth image."""
    n, n_cap = sims.shape
    dev = sims.device
    cols = torch.arange(n_cap, device=dev)
    img_of_cap = cols // cap_ratio
    gt = sims[img_of_cap, cols]
    greater = torch.sum(sims > gt[None, :], dim=0)
    ties_after = torch.sum(
        (sims == gt[None, :])
        & (torch.arange(n, device=dev)[:, None] > img_of_cap[None, :]),
        dim=0,
    )
    return greater + ties_after


def cal_recall(sims: torch.Tensor, cap_ratio: int = 5, verbose: bool = True) -> dict:
    """Both directions and rsum, with the keys of itrx.eval.metrics.cal_recall."""
    ranks_i2t = i2t_ranks(sims, cap_ratio)
    ranks_t2i = t2i_ranks(sims, cap_ratio)
    r = _stats_from_ranks(ranks_i2t)
    ri = _stats_from_ranks(ranks_t2i)
    ar = (r[0] + r[1] + r[2]) / 3
    ari = (ri[0] + ri[1] + ri[2]) / 3
    rsum = r[0] + r[1] + r[2] + ri[0] + ri[1] + ri[2]
    if verbose:
        print("rsum: %.1f" % rsum)
        print("Average i2t Recall: %.1f" % ar)
        print("Image to text: r1 %.1f; r5 %.1f; r10 %.1f; medr %.1f; meanr %.1f" % r)
        print("Average t2i Recall: %.1f" % ari)
        print("Text to image: r1 %.1f; r5 %.1f; r10 %.1f; medr %.1f; meanr %.1f" % ri)
    return {
        "result": [list(r) + list(ri) + [ar, ari, rsum]],
        "rsum": rsum,
        "i2t_ave_r": ar,
        "i2t_r1": r[0],
        "i2t_r5": r[1],
        "i2t_r10": r[2],
        "i2t_medr": r[3],
        "i2t_meanr": r[4],
        "i2t_ranks": ranks_i2t.cpu().numpy(),
        "t2i_ave_r": ari,
        "t2i_r1": ri[0],
        "t2i_r5": ri[1],
        "t2i_r10": ri[2],
        "t2i_medr": ri[3],
        "t2i_meanr": ri[4],
        "t2i_ranks": ranks_t2i.cpu().numpy(),
    }
