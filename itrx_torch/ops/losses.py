"""Training objectives (counterpart of itrx/ops/losses.py: the hinge every
method trains with, CAMERA's diversity regularizer, VSRN's caption-decoder
loss, and SAEM's angular loss with its n-pair sibling)."""

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


# CAMERA's TripletLoss is the same computation on precomputed scores
triplet_loss = contrastive_hinge


def diversity_regularization(smry_mat):
    """CAMERA's diversity term: || n^T n - I ||_F^2 summed over the batch,
    where n is smry_mat (B, R, K) normalized along the region axis (each
    column's norm clamped at 1e-12, so an all-zero view gives zeros)."""
    n = smry_mat / smry_mat.norm(dim=1, keepdim=True).clamp_min(1e-12)
    g = torch.einsum("brk,brl->bkl", n, n)
    d = g - torch.eye(smry_mat.shape[-1], dtype=g.dtype, device=g.device)
    return (d * d).sum()


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


# the excluded diagonal of a max over negatives (itrx's NEG_INF)
NEG_INF = -1e18


def npair_loss(im, s, max_violation: bool = True):
    """N-pair loss, the negatives of a row every other row, both directions
    (itrx/ops/losses.py::npair_loss): x[i, j] = a_i . (p_j - p_i), then the
    sum of log(1 + the hardest x) with `max_violation`, else the mean of
    log(1 + sum_j exp x[i, j])."""

    def one_direction(anchors, positives):
        ap = torch.matmul(anchors, positives.t())
        x = ap - torch.diagonal(ap)[:, None]
        eye = torch.eye(x.shape[0], dtype=torch.bool, device=x.device)
        if max_violation:
            return torch.log(1.0 + x.masked_fill(eye, NEG_INF).amax(dim=1)).sum()
        e = torch.exp(x).masked_fill(eye, 0.0).sum(dim=1)
        return torch.log(1.0 + e).mean()

    return one_direction(im, s) + one_direction(s, im)


def angular_loss(im, s, angle_bound: float = 1.0, max_violation: bool = True):
    """Angular loss (Wang et al., ICCV'17), the negatives of a row every
    other row, both directions (itrx/ops/losses.py::angular_loss):
    x[i, j] = 4 tan^2(a) (a_i + p_i) . p_j - 2 (1 + tan^2(a)) a_i . p_i, with
    `angle_bound` = tan^2(a); then the sum of softplus(the hardest x) with
    `max_violation`, else the mean of log(1 + sum_j exp x[i, j]) as a
    log-sum-exp shifted by the row's largest negative."""

    def one_direction(anchors, positives):
        eye = torch.eye(anchors.shape[0], dtype=torch.bool, device=anchors.device)
        m = 4.0 * angle_bound * torch.matmul(anchors + positives, positives.t())
        d = 2.0 * (1.0 + angle_bound) * (anchors * positives).sum(dim=1)
        x = m - d[:, None]
        if max_violation:
            cost = x.masked_fill(eye, NEG_INF).amax(dim=1)
            return torch.log1p(torch.exp(cost)).sum()
        t = x.masked_fill(eye, NEG_INF).amax(dim=1, keepdim=True)
        e = torch.exp(x - t).masked_fill(eye, 0.0).sum(dim=1)
        return (t[:, 0] + torch.log(torch.exp(-t[:, 0]) + e)).mean()

    return one_direction(im, s) + one_direction(s, im)
