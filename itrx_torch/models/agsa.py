"""CAMERA's building blocks (counterpart of itrx/models/agsa.py): the AGSA
gated self-attention with its BatchNorm residuals, the multi-view
summarization and the box position encoding.

Reference: itr/modalmodule/camera_.py (AGSA :14-89, Summarization :93-114,
PositionEncoder :118-148); the module and parameter names are its
state-dict keys (`att_layers.{i}.linears.{0,1,2}`, `fc_q`, `fc_k`, `fc_g`,
`bns.{i}`, `convs_dilate.{i}`, `convs_fc`, `proj`).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.kernels.agsa_attn import MAX_DK, agsa_attention_fused
from .layers import DropoutRNG, SeededDropout, TorchBatchNorm, torch_conv1d, torch_linear


def kernel_route(drop: float, training: bool, d_k: int) -> bool:
    """Whether GatedQueryAttLayer sends its attention to the kernel's
    wrapper: where `itrx` sends it to its Pallas kernel (no attention
    dropout in effect, d_k % 8 == 0 and d_k <= 128; CAMERA passes no mask),
    whatever the dtype and the number of positions.  The wrapper runs the
    plain version for a CPU tensor and the kernel for a CUDA one, and raises
    for a CUDA call outside the kernel's limits (N > 64)."""
    return (drop == 0.0 or not training) and d_k % 8 == 0 and d_k <= MAX_DK


class GatedQueryAttLayer(nn.Module):
    """Multi-head self-attention with element-gated q and k (ref :14-54):
    the q, k, v projections `linears.{0,1,2}`, then per head
    m = sigmoid(fc_g(fc_q(q) * fc_k(k))) gates q and k before the scaled
    scores, the softmax and the value product."""

    def __init__(self, embed_size: int, h: int, drop: float = 0.0,
                 rng: DropoutRNG | None = None, generator: torch.Generator | None = None):
        super().__init__()
        if embed_size % h:
            raise ValueError(f"embed_size {embed_size} is not a multiple of {h} heads")
        self.h = h
        self.d_k = embed_size // h
        self.drop = drop
        self.linears = nn.ModuleList(torch_linear(embed_size, embed_size, generator=generator)
                                     for _ in range(3))
        self.fc_q = torch_linear(self.d_k, self.d_k, generator=generator)
        self.fc_k = torch_linear(self.d_k, self.d_k, generator=generator)
        self.fc_g = torch_linear(self.d_k, 2 * self.d_k, generator=generator)
        self.dropout = SeededDropout(drop, rng)

    def forward(self, inp):
        q, k, v = (lin(inp) for lin in self.linears)
        dk = self.d_k
        wg, bg = self.fc_g.weight, self.fc_g.bias
        if kernel_route(self.drop, self.training, dk):
            return agsa_attention_fused(q, k, v, self.fc_q.weight, self.fc_q.bias,
                                        self.fc_k.weight, self.fc_k.bias, wg[:dk], bg[:dk],
                                        wg[dk:], bg[dk:], self.h)
        return self._attend(q, k, v)

    def _attend(self, q, k, v):
        """`itrx`'s XLA path: the same chain in the activation dtype, with
        the attention dropout (d_k off the kernel route's gate, or training
        with dropout)."""
        b, n, d = q.shape
        dk, dt = self.d_k, q.dtype
        q, k, v = (x.reshape(b, n, self.h, dk).transpose(1, 2) for x in (q, k, v))

        def lin(x, fc):
            return x @ fc.weight.to(dt).t() + fc.bias.to(dt)

        m = torch.sigmoid(lin(lin(q, self.fc_q) * lin(k, self.fc_k), self.fc_g))
        q, k = q * m[..., :dk], k * m[..., dk:]
        scores = q @ k.transpose(-1, -2) / math.sqrt(dk)
        p = self.dropout(torch.softmax(scores, dim=-1))
        return (p @ v).transpose(1, 2).reshape(b, n, d)


class AGSA(nn.Module):
    """Adaptive gating self-attention stack with BatchNorm residuals (ref
    :57-89).  The BatchNorm normalizes the flattened (B x N, D) rows; the
    dropouts draw from `rng` and are the identity in eval."""

    def __init__(self, num_layers: int, embed_size: int, h: int = 1, drop: float = 0.0,
                 rng: DropoutRNG | None = None, generator: torch.Generator | None = None):
        super().__init__()
        self.att_layers = nn.ModuleList(
            GatedQueryAttLayer(embed_size, h, drop, rng, generator) for _ in range(num_layers))
        self.bns = nn.ModuleList(TorchBatchNorm(embed_size) for _ in range(num_layers))
        self.dropout = SeededDropout(drop, rng)

    def forward(self, rgn_emb, pos_emb=None):
        b, n, d = rgn_emb.shape
        # the gate comes from fp32 geometry: cast it to the activation dtype
        # so that it cannot promote a bf16 chain back to fp32
        x = rgn_emb if pos_emb is None else rgn_emb * pos_emb.to(rgn_emb.dtype)

        def block(i, x_in):
            y = self.att_layers[i](x_in)
            y = self.bns[i](y.reshape(b * n, d)).reshape(b, n, d)
            return self.dropout(y)

        agsa_emb = rgn_emb + block(0, x)
        for i in range(1, len(self.att_layers)):
            agsa_emb = agsa_emb + block(i, agsa_emb)
        return agsa_emb


# (out channels, kernel size, dilation) of the summarization's seven banks
SUMMARY_BANKS = ((256, 1, 1), (128, 3, 1), (128, 3, 2), (128, 3, 3), (128, 5, 1),
                 (128, 5, 2), (128, 5, 3))


class Summarization(nn.Module):
    """Multi-view summarization (ref :93-114): seven dilated Conv1d banks
    over the region axis ("same" padding), ReLU, their 1024 channels
    concatenated, then `convs_fc` to smry_k views: (B, R, D) -> (B, R,
    smry_k)."""

    def __init__(self, embed_size: int, smry_k: int, generator: torch.Generator | None = None):
        super().__init__()
        self.convs_dilate = nn.ModuleList(
            torch_conv1d(embed_size, c, k, dilation=dil, padding=dil * (k - 1) // 2,
                         generator=generator)
            for c, k, dil in SUMMARY_BANKS)
        channels = sum(c for c, _, _ in SUMMARY_BANKS)
        self.convs_fc = torch_linear(channels, smry_k, generator=generator)

    def forward(self, rgn_emb):
        x = rgn_emb.transpose(1, 2)  # (B, D, R)
        feats = torch.cat([torch.relu(conv(x)) for conv in self.convs_dilate], dim=1)
        return self.convs_fc(feats.transpose(1, 2))


def absolute_encode(boxes, imgs_wh):
    """Normalized box geometry (ref camera_.py:118-128), in fp32 whatever the
    inputs' dtype.  boxes (B, R, 4) xyxy, imgs_wh (B, 2) -> (B, R, 6):
    x, y, w, h over the image size, w / h and the area ratio.  A height
    under 1e-6 in magnitude is clamped to +-1e-6, its sign kept, so that a
    degenerate box gives no inf."""
    boxes, imgs_wh = boxes.float(), imgs_wh.float()
    x, y = boxes[:, :, 0], boxes[:, :, 1]
    w = boxes[:, :, 2] - boxes[:, :, 0]
    h = boxes[:, :, 3] - boxes[:, :, 1]
    expand_wh = torch.cat([imgs_wh, imgs_wh], dim=1)[:, None, :]
    tiny = torch.where(h < 0, torch.full_like(h, -1e-6), torch.full_like(h, 1e-6))
    h_safe = torch.where(h.abs() < 1e-6, tiny, h)
    ratio_wh = (w / h_safe)[..., None]
    ratio_area = (w * h / (imgs_wh[:, 0] * imgs_wh[:, 1])[:, None])[..., None]
    xywh = torch.stack([x, y, w, h], dim=2) / expand_wh
    return torch.cat([xywh, ratio_wh, ratio_area], dim=-1)


class PositionEncoder(nn.Module):
    """Box geometry -> a sigmoid gate (ref camera_.py:131-148), fp32.  `proj`
    runs in fp32 on its weights' values whatever their dtype (a bf16 encode
    casts them), as `itrx`'s fp32 x bf16 product promotes to fp32."""

    def __init__(self, embed_dim: int, generator: torch.Generator | None = None):
        super().__init__()
        self.proj = torch_linear(6, embed_dim, generator=generator)

    def forward(self, boxes, imgs_wh):
        posi = absolute_encode(boxes, imgs_wh)
        return torch.sigmoid(nn.functional.linear(posi, self.proj.weight.float(),
                                                  self.proj.bias.float()))
