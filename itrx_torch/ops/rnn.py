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


def gru_fwd_plain(gates_x, mask, w_hh, b_hh, reverse: bool = False,
                  dot_dtype: torch.dtype | None = None):
    """Plain masked GRU recurrence over precomputed input gates.

    gates_x (B, L, 3H) = x . W_ih^T + b_ih (fp32 in the port); mask (B, L).
    Returns (outs (B, L, H), final (B, H), hall (B, L, H), ghall
    (B, L, 3H)), in gates_x's dtype: hall[:, t] is h_{t-1}, the carry
    entering step t, and ghall[:, t] = h_{t-1} . W_hh^T + b_hh, the
    residuals that itrx/ops/pallas/gru.py::_fwd_kernel saves for the
    backward.  The recurrent product rounds h and W_hh to `dot_dtype` (None:
    no rounding) and accumulates in gates_x's dtype.  Differentiable by
    autograd.
    """
    B, L, _ = gates_x.shape
    H = w_hh.shape[1]
    ct = gates_x.dtype
    dt = dot_dtype or ct
    w_hh_t = w_hh.to(dt).to(ct).t()
    b_hh = b_hh.to(ct)
    m = mask.to(ct)
    h = gates_x.new_zeros(B, H)
    outs, hall, ghall = [None] * L, [None] * L, [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        gh = torch.matmul(h.to(dt).to(ct), w_hh_t) + b_hh
        hall[t], ghall[t] = h, gh
        xr, xz, xn = gates_x[:, t].chunk(3, dim=-1)
        hr, hz, hn = gh.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * h
        mt = m[:, t, None]
        h = mt * h_new + (1.0 - mt) * h
        outs[t] = mt * h_new
    if not L:
        return (gates_x.new_zeros(B, 0, H), h, gates_x.new_zeros(B, 0, H),
                gates_x.new_zeros(B, 0, 3 * H))
    return (torch.stack(outs, dim=1), h, torch.stack(hall, dim=1),
            torch.stack(ghall, dim=1))


def gru_bwd_plain(gates_x, mask, hall, ghall, g_outs, g_final, w_hh,
                  reverse: bool = False, dot_dtype: torch.dtype | None = None):
    """Plain GRU adjoint of `gru_fwd_plain`, the computation of
    itrx/ops/pallas/gru.py::_bwd_kernel, in gates_x's dtype.

    From the residuals and the cotangents g_outs (B, L, H) and g_final
    (B, H) (either may be None: zero), walks the steps in the opposite order
    of the forward and returns (ggx (B, L, 3H) = [g_prer | g_prez | g_pren],
    the gradient of gates_x; ghn (B, L, H) = g_pren * r; g_h0 (B, H), the
    carry gradient it ends with, i.e. that of the zero initial state).

    `dot_dtype` None: no rounding.  `torch.bfloat16`: the TPU kernel's
    arithmetic at dot_dtype="bfloat16" (and the CUDA adjoint's with bf16
    W_hh): gates_x and ghall enter as bf16 values, W_hh is rounded to bf16,
    the carry gradient stays in gates_x's dtype, g_gh = [g_prer | g_prez |
    ghn] is rounded to bf16 before its product with W_hh (accumulated in
    gates_x's dtype), and ggx and ghn leave as bf16 values.
    """
    B, L, _ = gates_x.shape
    H = w_hh.shape[1]
    ct = gates_x.dtype

    def rnd(t):
        return t if dot_dtype is None else t.to(dot_dtype).to(ct)

    gates_x, ghall = rnd(gates_x), rnd(ghall.to(ct))
    w = rnd(w_hh.to(ct))
    m = mask.to(ct)
    g_carry = g_final.to(ct) if g_final is not None else gates_x.new_zeros(B, H)
    ggx, ghn = [None] * L, [None] * L
    for t in (range(L) if reverse else range(L - 1, -1, -1)):
        h = hall[:, t]
        xr, xz, xn = gates_x[:, t].chunk(3, dim=-1)
        hr, hz, hn = ghall[:, t].chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        mt = m[:, t, None]
        g_out = g_outs[:, t] if g_outs is not None else 0.0
        g_hnew = mt * (g_carry + g_out)
        g_pren = g_hnew * (1.0 - z) * (1.0 - n * n)
        g_hn = g_pren * r
        g_prer = g_pren * hn * r * (1.0 - r)
        g_prez = g_hnew * (h - n) * z * (1.0 - z)
        ggx[t] = rnd(torch.cat([g_prer, g_prez, g_pren], dim=-1))
        ghn[t] = rnd(g_hn)
        g_gh = rnd(torch.cat([g_prer, g_prez, g_hn], dim=-1))
        g_carry = (1.0 - mt) * g_carry + g_hnew * z + torch.matmul(g_gh, w)
    if not L:
        return gates_x.new_zeros(B, 0, 3 * H), gates_x.new_zeros(B, 0, H), g_carry
    return torch.stack(ggx, dim=1), torch.stack(ghn, dim=1), g_carry


def gru_scan(x, mask, w_ih, w_hh, b_ih, b_hh, reverse: bool = False,
             dot_dtype: torch.dtype = torch.float32):
    """Plain masked GRU over x (B, L, D) with mask (B, L).

    Returns (outputs (B, L, H) in x's dtype, zero at pads; final (B, H), the
    carry at each sequence's last valid step).  The input projection runs in
    the input dtype; the recurrence carries fp32 (`gru_fwd_plain`).  The
    recurrent product h . W_hh^T rounds h and W_hh to `dot_dtype` and
    accumulates in fp32: `torch.bfloat16` is the arithmetic of the kernel
    with bf16 W_hh (and of itrx/ops/pallas/gru.py at dot_dtype="bfloat16").
    """
    gates_x = (torch.matmul(x, w_ih.t()) + b_ih).float()  # (B, L, 3H)
    out, h, _, _ = gru_fwd_plain(gates_x, mask, w_hh, b_hh, reverse, dot_dtype)
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
