"""Masked GRU recurrence (counterpart of itrx/ops/rnn.py).

Static shapes with masks instead of packed sequences: the carry freezes once
a sequence's mask runs out, outputs are zero at padded steps, and
`reverse=True` runs right to left so that positions past a length keep the
zero carry (packed-bidirectional semantics on unsorted batches).  Parameter
names and layouts are those of `torch.nn.GRU` (gate order [r|z|n]).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def gru_scan(x, mask, w_ih, w_hh, b_ih, b_hh, reverse: bool = False,
             dot_dtype: torch.dtype = torch.float32):
    """Plain masked GRU over x (B, L, D) with mask (B, L).

    Returns (outputs (B, L, H) in x's dtype, zero at pads; final (B, H), the
    carry at each sequence's last valid step).  The input projection runs in
    the input dtype; the recurrence carries fp32.  The recurrent product
    h . W_hh^T rounds h and W_hh to `dot_dtype` and accumulates in fp32:
    `torch.bfloat16` is the arithmetic of the kernel with bf16 W_hh (and of
    itrx/ops/pallas/gru.py at dot_dtype="bfloat16").
    """
    B, L, _ = x.shape
    H = w_hh.shape[1]
    gates_x = (torch.matmul(x, w_ih.t()) + b_ih).float()  # (B, L, 3H)
    w_hh_t = w_hh.to(dot_dtype).float().t()
    b_hh = b_hh.float()
    m = mask.float()
    h = torch.zeros(B, H, dtype=torch.float32, device=x.device)
    outs = [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        gx = gates_x[:, t]
        gh = torch.matmul(h.to(dot_dtype).float(), w_hh_t) + b_hh
        xr, xz, xn = gx.chunk(3, dim=-1)
        hr, hz, hn = gh.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * h
        mt = m[:, t, None]
        h = mt * h_new + (1.0 - mt) * h
        outs[t] = mt * h_new
    out = torch.stack(outs, dim=1) if L else x.new_zeros(B, 0, H)
    return out.to(x.dtype), h.to(x.dtype)


class MaskedGRU(nn.Module):
    """Single-layer masked GRU, optionally bidirectional.

    `forward(x, mask)` returns (outputs, final): (B, L, H) and (B, H), or for
    a bidirectional GRU (B, L, 2H) = [fwd | bwd] and (B, 2H).  On a CUDA
    tensor the recurrence runs in the hand-written kernel
    (itrx_torch.ops.kernels.gru); on a CPU tensor in `gru_scan`.
    """

    def __init__(self, input_size: int, hidden_size: int,
                 bidirectional: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.bidirectional = bidirectional
        k = 1.0 / math.sqrt(hidden_size)
        h3 = 3 * hidden_size

        def u(*shape):
            return nn.Parameter(
                torch.empty(*shape).uniform_(-k, k, generator=generator)
            )

        for suf in ("", "_reverse") if bidirectional else ("",):
            setattr(self, f"weight_ih_l0{suf}", u(h3, input_size))
            setattr(self, f"weight_hh_l0{suf}", u(h3, hidden_size))
            setattr(self, f"bias_ih_l0{suf}", u(h3))
            setattr(self, f"bias_hh_l0{suf}", u(h3))

    def _direction(self, x, mask, suf: str, reverse: bool):
        from .kernels.gru import gru_scan_fused

        return gru_scan_fused(
            x, mask,
            getattr(self, f"weight_ih_l0{suf}"),
            getattr(self, f"weight_hh_l0{suf}"),
            getattr(self, f"bias_ih_l0{suf}"),
            getattr(self, f"bias_hh_l0{suf}"),
            reverse=reverse,
        )

    def forward(self, x, mask):
        out_f, h_f = self._direction(x, mask, "", reverse=False)
        if not self.bidirectional:
            return out_f, h_f
        out_b, h_b = self._direction(x, mask, "_reverse", reverse=True)
        return torch.cat([out_f, out_b], dim=-1), torch.cat([h_f, h_b], dim=-1)
