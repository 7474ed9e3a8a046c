"""Training objectives (counterpart of itrx/ops/losses.py, the hinge SCAN
trains with)."""

from __future__ import annotations

import torch


def contrastive_hinge(scores, margin: float = 0.2, max_violation: bool = False):
    """Bidirectional hinge ranking loss on an (N, N) score matrix whose
    diagonal holds the matching pairs.

    Each off-diagonal score is compared with the diagonal of its row
    (caption retrieval) and of its column (image retrieval); the loss sums
    the violations, or with `max_violation` only the hardest negative per
    query.  Computed in fp32 whatever the input dtype.
    """
    scores = scores.float()
    n = scores.shape[0]
    diag = torch.diagonal(scores)
    eye = torch.eye(n, dtype=torch.bool, device=scores.device)
    cost_s = torch.clamp(margin + scores - diag[:, None], min=0.0).masked_fill(eye, 0.0)
    cost_im = torch.clamp(margin + scores - diag[None, :], min=0.0).masked_fill(eye, 0.0)
    if max_violation:
        cost_s = cost_s.amax(dim=1)
        cost_im = cost_im.amax(dim=0)
    return cost_s.sum() + cost_im.sum()
