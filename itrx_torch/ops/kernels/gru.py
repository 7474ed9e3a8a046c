"""Masked GRU recurrence and its adjoint on the card: wrappers of
csrc/gru.cu and csrc/gru_bwd.cu.

Replaces the TPU kernels itrx/ops/pallas/gru.py::_fwd_kernel and
::_bwd_kernel (entry `gru_scan_fused`, custom VJP `_gru_seq`).  What bounds
them on an H100: L sequential steps, each a (B, H) x (H, 3H) product (the
backward: (B, 3H) x (3H, H)) whose (3H, H) weight (12 MB fp32 / 6 MB bf16
at H = 1024) cannot sit in one SM's shared memory as it sat in the TPU's
VMEM.  Both kernels therefore launch once per step, split the hidden units
over blocks (so the gate math needs no exchange between blocks inside a
launch) and leave the weight to the 50 MB L2 between launches.  See the
headers of the two sources.

`gru_scan_fused` is differentiable: with grad enabled it runs `_GRUSeq`, a
torch.autograd.Function whose forward also writes the residuals (h_{t-1}
and gh per step) and whose backward is the adjoint kernel, followed by the
weight-gradient matmuls outside it, as in the JAX package.  The input
projection x @ W_ih^T + b_ih is one torch.matmul outside the kernels, so
dx, dW_ih and db_ih come from autograd through it.  The plain versions are
`itrx_torch.ops.rnn.gru_fwd_plain` / `gru_bwd_plain`; they run only for CPU
tensors, inside the same Function.
"""

from __future__ import annotations

import ctypes

import torch

from ..rnn import gru_bwd_plain, gru_fwd_plain
from . import check, current_stream, load, ptr

SOURCE = "gru.cu"
BWD_SOURCE = "gru_bwd.cu"


def _opt_ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None) if t is None else ptr(t)


def _launch(gates_x, m, w_hh, b_hh, reverse: bool, residuals: bool):
    """gates_x (B, L, 3H) fp32; m (B, L) fp32; w_hh (3H, H) fp32 or bf16;
    b_hh (3H) fp32, all contiguous on one CUDA device.  Returns
    (outs (B, L, H), final (B, H), hall (B, L, H), ghall (B, L, 3H)), fp32;
    hall and ghall are None unless `residuals`."""
    B, L, H3 = gates_x.shape
    H = H3 // 3
    lib = load("gru")
    fn = lib.itrx_gru_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = gates_x.device
    outs = torch.empty(B, L, H, dtype=torch.float32, device=dev)
    hbuf = torch.empty(2, B, H, dtype=torch.float32, device=dev)
    hall = ghall = None
    if residuals:
        hall = torch.empty(B, L, H, dtype=torch.float32, device=dev)
        ghall = torch.empty(B, L, H3, dtype=torch.float32, device=dev)
    code = fn(
        ptr(gates_x), ptr(m), ptr(w_hh), int(w_hh.dtype == torch.bfloat16),
        ptr(b_hh), ptr(hbuf), ptr(outs), _opt_ptr(hall), _opt_ptr(ghall),
        B, L, H, int(reverse), dev.index, current_stream(dev),
    )
    check(lib, "gru_step_kernel", code)
    gru_scan_fused.launches += L
    return outs, hbuf[(L - 1) % 2], hall, ghall


def gru_bwd_fused(gates_x, mask, hall, ghall, g_outs, g_final, w_hh,
                  reverse: bool = False):
    """The GRU adjoint from the forward's residuals: (ggx (B, L, 3H),
    ghn (B, L, H), g_h0 (B, H)), as `itrx_torch.ops.rnn.gru_bwd_plain`
    returns them.  g_outs / g_final may be None (zero).  A CPU tensor takes
    `gru_bwd_plain`; a CUDA tensor launches the kernel (all fp32, contiguous;
    L + 1 launches); any other device raises."""
    if gates_x.device.type == "cpu":
        return gru_bwd_plain(gates_x, mask, hall, ghall, g_outs, g_final, w_hh,
                             reverse=reverse)
    if gates_x.device.type != "cuda":
        raise ValueError(f"gru_bwd_fused: no kernel for device {gates_x.device}")
    B, L, H3 = gates_x.shape
    H = H3 // 3
    if w_hh.dtype != torch.float32:
        raise TypeError(
            f"gru_bwd_fused: W_hh dtype {w_hh.dtype}: the backward kernel takes "
            "fp32 only (bf16 training is ROADMAP queue 1 item 7, train_bf16)"
        )
    shapes = {"mask": (mask, (B, L)), "hall": (hall, (B, L, H)),
              "ghall": (ghall, (B, L, H3)), "w_hh": (w_hh, (H3, H))}
    if g_outs is not None:
        shapes["g_outs"] = (g_outs, (B, L, H))
    if g_final is not None:
        shapes["g_final"] = (g_final, (B, H))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"gru_bwd_fused: {name} {tuple(t.shape)} != {shape}")
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != gates_x.device:
            raise ValueError(f"gru_bwd_fused: {name} must be contiguous fp32 on "
                             f"{gates_x.device}")
    if gates_x.dtype != torch.float32 or not gates_x.is_contiguous():
        raise ValueError("gru_bwd_fused: gates_x must be contiguous fp32")
    lib = load("gru_bwd")
    fn = lib.itrx_gru_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = gates_x.device
    ggx = torch.empty(B, L, H3, dtype=torch.float32, device=dev)
    ghn = torch.empty(B, L, H, dtype=torch.float32, device=dev)
    gloc = torch.empty(B, H, dtype=torch.float32, device=dev)
    g_h0 = torch.empty(B, H, dtype=torch.float32, device=dev)
    code = fn(
        ptr(gates_x), ptr(mask), ptr(hall), ptr(ghall), _opt_ptr(g_outs),
        _opt_ptr(g_final), ptr(w_hh), ptr(ggx), ptr(ghn), ptr(gloc), ptr(g_h0),
        B, L, H, int(reverse), dev.index, current_stream(dev),
    )
    check(lib, "gru_bwd_step_kernel", code)
    gru_bwd_fused.launches += L + 1
    return ggx, ghn, g_h0


def gru_weight_grads(ggx, ghn, hall):
    """(dW_hh (3H, H), db_hh (3H)) from the adjoint's gate gradients, as
    large matmuls outside the sequential kernel (itrx/ops/pallas/gru.py:
    243-253): g_gh = [ggx_r | ggx_z | ghn], dW_hh = sum_{b,t} g_gh^T h_{t-1}."""
    H = hall.shape[-1]
    g_gh = torch.cat([ggx[..., :2 * H], ghn], dim=-1).reshape(-1, 3 * H)
    return torch.matmul(g_gh.t(), hall.reshape(-1, H)), g_gh.sum(dim=0)


def _seq_fwd(gates_x, mask, w_hh, b_hh, reverse: bool, residuals: bool):
    """The forward on either device: (outs, final, hall, ghall), fp32."""
    if gates_x.device.type == "cpu":
        return gru_fwd_plain(gates_x, mask, w_hh, b_hh, reverse)
    return _launch(gates_x, mask, w_hh, b_hh, reverse, residuals)


class _GRUSeq(torch.autograd.Function):
    """The custom VJP of itrx/ops/pallas/gru.py::_gru_seq: (gates_x, mask,
    w_hh, b_hh) -> (outs, final).  Gradients flow to gates_x, w_hh and b_hh;
    the mask gets none."""

    @staticmethod
    def forward(ctx, gates_x, mask, w_hh, b_hh, reverse):
        outs, final, hall, ghall = _seq_fwd(gates_x, mask, w_hh, b_hh, reverse,
                                            residuals=True)
        ctx.set_materialize_grads(False)
        ctx.reverse = reverse
        ctx.save_for_backward(gates_x, mask, hall, ghall, w_hh)
        return outs, final

    @staticmethod
    def backward(ctx, g_outs, g_final):
        gates_x, mask, hall, ghall, w_hh = ctx.saved_tensors
        if g_outs is not None:
            g_outs = g_outs.to(gates_x.dtype).contiguous()
        if g_final is not None:
            g_final = g_final.to(gates_x.dtype).contiguous()
        ggx, ghn, _ = gru_bwd_fused(gates_x, mask, hall, ghall, g_outs, g_final,
                                    w_hh, reverse=ctx.reverse)
        d_whh, d_bhh = gru_weight_grads(ggx, ghn, hall)
        return ggx, None, d_whh, d_bhh, None


def gru_scan_fused(x, mask, w_ih, w_hh, b_ih, b_hh, reverse: bool = False):
    """Masked GRU over x (B, L, D) with mask (B, L); weights in
    torch.nn.GRU layout.  Returns (outputs (B, L, H) in x's dtype, zero at
    pads; final (B, H)).  A CPU tensor takes the plain recurrence; a CUDA
    tensor launches the kernels (fp32 or bf16 W_hh without grad, fp32 with
    grad; fp32 carry); any other device raises.  Differentiable with
    respect to x and all four weights."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gru_scan_fused: no kernel for device {x.device}")
    B, L, D = x.shape
    H = w_hh.shape[1]
    if L < 1 or B < 1:
        raise ValueError(f"gru_scan_fused: empty input {tuple(x.shape)}")
    if tuple(w_ih.shape) != (3 * H, D) or tuple(w_hh.shape) != (3 * H, H):
        raise ValueError("gru_scan_fused: weights must be (3H, D) and (3H, H)")
    if tuple(mask.shape) != (B, L):
        raise ValueError(f"gru_scan_fused: mask {tuple(mask.shape)} != {(B, L)}")
    if w_hh.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gru_scan_fused: W_hh dtype {w_hh.dtype} unsupported")
    for t in (mask, w_ih, w_hh, b_ih, b_hh):
        if t.device != x.device:
            raise ValueError("gru_scan_fused: all tensors must be on one device")
    gates_x = (torch.matmul(x, w_ih.t()) + b_ih).float().contiguous()
    m = mask.float().contiguous()
    b = b_hh.float().contiguous()
    w = w_hh.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (gates_x, w, b)):
        outs, final = _GRUSeq.apply(gates_x, m, w, b, reverse)
    else:
        outs, final, _, _ = _seq_fwd(gates_x, m, w, b, reverse, residuals=False)
    return outs.to(x.dtype), final.to(x.dtype)


# kernel launches (one per timestep) since the last reset
gru_scan_fused.launches = 0
# adjoint kernel launches (L + 1 per call) since the last reset
gru_bwd_fused.launches = 0
