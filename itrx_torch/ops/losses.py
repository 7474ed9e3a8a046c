"""Training objectives (counterpart of itrx/ops/losses.py: the hinge every
method trains with, and VSRN's caption-decoder loss)."""

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


def language_model_loss(logprobs, targets, mask):
    """Masked NLL over decoder log-probs, summed and divided by the batch.

    logprobs (B, T, V) log-softmax outputs; targets (B, >= T) int ids; mask
    (B, >= T).  Targets and mask are cut to the T steps of the logits; the
    sum runs in fp32 whatever the input dtype."""
    t = logprobs.shape[1]
    targets = targets[:, :t].long()
    mask = mask[:, :t].float()
    nll = -torch.gather(logprobs, 2, targets[..., None])[..., 0].float()
    return (nll * mask).sum() / logprobs.shape[0]
