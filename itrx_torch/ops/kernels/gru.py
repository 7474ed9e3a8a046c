"""Masked GRU recurrence and its adjoint on the card: wrappers of
csrc/gru.cu and csrc/gru_bwd.cu.

Replaces the TPU kernels itrx/ops/pallas/gru.py::_fwd_kernel and
::_bwd_kernel (entry `gru_scan_fused`, custom VJP `_gru_seq`).  What bounds
them on an H100: L sequential steps, each a (B, H) x (H, 3H) product (the
adjoint: (B, 3H) x (3H, H)) whose (3H, H) weight (12.6 MB fp32 / 6.3 MB
bf16 at H 1024) one SM's shared memory cannot hold, though the TPU kept it
in VMEM for all L steps.  Design: one persistent cooperative launch per call
(per `ROWS`-row batch chunk), one block per SM, each block holding its
hidden units' slice of W_hh in shared memory for the whole sequence (the
card's 132 SMs hold ~30 MB together) and meeting the others at one grid
barrier a step; the carry (forward) or the gate gradients (adjoint) cross
blocks through a double-buffered exchange in global memory, read at L2,
which with the barrier sets the pace.  `plan` chooses the units a block,
the blocks, the resident or streamed route (an fp32 slice too large for
shared memory streams through a cp.async ring each step), the batch chunks
and the shared-memory bytes; it is pure Python, so the CPU tests hold it.
See the headers of the two sources and of csrc/gru_persistent.cuh.

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
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..rnn import gru_bwd_plain, gru_fwd_plain
from . import check, current_stream, load, ptr

SOURCE = "gru.cu"
BWD_SOURCE = "gru_bwd.cu"
# the kernels' constants (csrc/gru_persistent.cuh)
ROWS = 128  # batch rows a launch: 8 warps of 16
K_ALIGN = 64  # the product's K is padded to this
STAGES = 4  # ring depth of the streamed route
PAD_F32, PAD_BF16 = 4, 32  # shared-memory row pads, elements
UNITS = (8, 16)  # hidden units a block (compiled variants)
MAX_SMEM = 232_448  # dynamic shared memory one block may take on an H100
H100_SMS = 132


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class Plan:
    """How one call runs: `blocks` blocks of `units` hidden units (block i
    owns units [i units, (i + 1) units) of H), the `route` of the weight
    slice ("resident" in shared memory for the whole sequence, or
    "streamed" through a ring each step), `smem` bytes of dynamic shared
    memory a block, one launch per batch chunk [b0, b1) of `chunks`, and
    `k_padded`, the row length (elements) of the exchange."""

    units: int
    blocks: int
    route: str
    smem: int
    chunks: tuple
    k_padded: int


def plan(batch: int, hidden: int, dtype: torch.dtype, *, backward: bool = False,
         sms: int = H100_SMS) -> Plan:
    """The launch plan of the forward or the adjoint (`backward`), W_hh in
    `dtype` (fp32 or bf16), over `batch` rows at hidden width `hidden` on a
    card of `sms` SMs.  A bf16 slice is always resident (the adjoint's at H
    2048: 16 units x (6144 + 32) x 2 = 197,632 B).  Raises ValueError for a
    request no variant takes."""
    if batch < 1 or hidden < 1:
        raise ValueError(f"GRU plan: empty batch {batch} or width {hidden}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"GRU plan: W_hh dtype {dtype} unsupported")
    units = next((u for u in UNITS if hidden <= u * sms), None)
    if units is None:
        raise ValueError(f"GRU plan: H {hidden} needs more than {UNITS[-1]} units on each of "
                         f"{sms} SMs")
    kp = _round_up(3 * hidden if backward else hidden, K_ALIGN)
    rows = units if backward else 3 * units  # weight rows a block holds
    if dtype == torch.bfloat16:
        resident = rows * (kp + PAD_BF16) * 2
    else:
        resident = rows * (kp + PAD_F32) * 4
    if resident <= MAX_SMEM:
        route, smem = "resident", resident
    elif dtype == torch.float32 and units == UNITS[-1]:
        route, smem = "streamed", STAGES * rows * (K_ALIGN + PAD_F32) * 4
    else:  # not reached on an H100; the kernels compile no such variant
        raise ValueError(f"GRU plan: H {hidden} {dtype} fits no compiled variant")
    chunks = tuple((b0, min(b0 + ROWS, batch)) for b0 in range(0, batch, ROWS))
    return Plan(units, -(-hidden // units), route, smem, chunks, kp)


@functools.cache
def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _aligned_rows(w: torch.Tensor) -> torch.Tensor:
    """w with its rows padded with zeros to a multiple of 4 elements (16
    bytes in fp32), the streamed ring's cp.async granule."""
    pad = -w.shape[1] % 4
    return F.pad(w, (0, pad)) if pad else w


def _opt_ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None) if t is None else ptr(t)


@functools.cache
def _entry(name: str):
    """The C entry of csrc/<name>.cu with its argument types: itrx_gru_fwd
    (3 pointers, 2 ints, 7 pointers, 9 ints, the stream) or itrx_gru_bwd (7
    pointers, 2 ints, 5 pointers, 9 ints, the stream)."""
    lib = load(name)
    V, I = ctypes.c_void_p, ctypes.c_int
    if name == "gru":
        fn, types = lib.itrx_gru_fwd, [V] * 3 + [I] * 2 + [V] * 7 + [I] * 9 + [V]
    else:
        fn, types = lib.itrx_gru_bwd, [V] * 7 + [I] * 2 + [V] * 5 + [I] * 9 + [V]
    fn.argtypes, fn.restype = types, I
    return lib, fn


def _launch(gates_x, m, w_hh, b_hh, reverse: bool, residuals: bool, the_plan: Plan = None):
    """gates_x (B, L, 3H) fp32; m (B, L) fp32; w_hh (3H, H) fp32 or bf16;
    b_hh (3H) fp32, all contiguous on one CUDA device.  Returns
    (outs (B, L, H), final (B, H), hall (B, L, H), ghall (B, L, 3H)), fp32;
    hall and ghall are None unless `residuals`.  One launch per batch chunk
    of `the_plan` (default: `plan` for this card)."""
    B, L, H3 = gates_x.shape
    H = H3 // 3
    dev = gates_x.device
    p = the_plan or plan(B, H, w_hh.dtype, sms=_sms(dev))
    lib, fn = _entry("gru")
    outs = torch.empty(B, L, H, dtype=torch.float32, device=dev)
    final = torch.empty(B, H, dtype=torch.float32, device=dev)
    hall = ghall = None
    if residuals:
        hall = torch.empty(B, L, H, dtype=torch.float32, device=dev)
        ghall = torch.empty(B, L, H3, dtype=torch.float32, device=dev)
    w = _aligned_rows(w_hh) if p.route == "streamed" else w_hh
    xbuf = torch.empty(2, min(B, ROWS), p.k_padded, dtype=w_hh.dtype, device=dev)
    bar = torch.empty(2, dtype=torch.int32, device=dev)
    for b0, b1 in p.chunks:
        code = fn(
            ptr(gates_x[b0:b1]), ptr(m[b0:b1]), ptr(w), w.shape[1],
            int(w_hh.dtype == torch.bfloat16), ptr(b_hh), ptr(xbuf), ptr(bar),
            ptr(outs[b0:b1]), ptr(final[b0:b1]),
            _opt_ptr(None if hall is None else hall[b0:b1]),
            _opt_ptr(None if ghall is None else ghall[b0:b1]),
            b1 - b0, L, H, p.units, p.blocks, int(p.route == "streamed"), p.smem,
            int(reverse), dev.index, current_stream(dev),
        )
        check(lib, "gru_fwd_kernel", code)
        gru_scan_fused.launches += 1
    return outs, final, hall, ghall


def gru_bwd_fused(gates_x, mask, hall, ghall, g_outs, g_final, w_hh,
                  reverse: bool = False):
    """The GRU adjoint from the forward's residuals: (ggx (B, L, 3H),
    ghn (B, L, H), g_h0 (B, H)), as `itrx_torch.ops.rnn.gru_bwd_plain`
    returns them.  g_outs / g_final may be None (zero).  A CPU tensor takes
    `gru_bwd_plain` without rounding, as the forward's CPU route computes
    (the JAX package's scan); a CUDA tensor launches the kernel (all fp32
    but W_hh, contiguous; one launch per batch chunk of `plan`): fp32 W_hh
    the fp32 adjoint, bf16 W_hh the bf16 mode, which is `gru_bwd_plain(...,
    dot_dtype=torch.bfloat16)`; any other device or W_hh dtype raises."""
    if gates_x.device.type == "cpu":
        return gru_bwd_plain(gates_x, mask, hall, ghall, g_outs, g_final, w_hh,
                             reverse=reverse)
    if gates_x.device.type != "cuda":
        raise ValueError(f"gru_bwd_fused: no kernel for device {gates_x.device}")
    B, L, H3 = gates_x.shape
    H = H3 // 3
    if w_hh.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gru_bwd_fused: W_hh dtype {w_hh.dtype}: the backward kernel "
                        "takes fp32 or bf16")
    shapes = {"mask": (mask, (B, L)), "hall": (hall, (B, L, H)),
              "ghall": (ghall, (B, L, H3)), "w_hh": (w_hh, (H3, H))}
    if g_outs is not None:
        shapes["g_outs"] = (g_outs, (B, L, H))
    if g_final is not None:
        shapes["g_final"] = (g_final, (B, H))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"gru_bwd_fused: {name} {tuple(t.shape)} != {shape}")
        want = w_hh.dtype if name == "w_hh" else torch.float32
        if t.dtype != want or not t.is_contiguous() or t.device != gates_x.device:
            raise ValueError(f"gru_bwd_fused: {name} must be contiguous {want} on "
                             f"{gates_x.device}")
    if gates_x.dtype != torch.float32 or not gates_x.is_contiguous():
        raise ValueError("gru_bwd_fused: gates_x must be contiguous fp32")
    dev = gates_x.device
    bf16 = w_hh.dtype == torch.bfloat16
    p = plan(B, H, w_hh.dtype, backward=True, sms=_sms(dev))
    lib, fn = _entry("gru_bwd")
    wt = _aligned_rows(w_hh.t().contiguous())  # columns of W_hh as rows
    ggx = torch.empty(B, L, H3, dtype=torch.float32, device=dev)
    ghn = torch.empty(B, L, H, dtype=torch.float32, device=dev)
    g_h0 = torch.empty(B, H, dtype=torch.float32, device=dev)
    ebuf = torch.empty(2, min(B, ROWS), p.k_padded, dtype=w_hh.dtype, device=dev)
    bar = torch.empty(2, dtype=torch.int32, device=dev)

    def rows(t, b0, b1):
        return _opt_ptr(None if t is None else t[b0:b1])

    for b0, b1 in p.chunks:
        code = fn(
            ptr(gates_x[b0:b1]), ptr(mask[b0:b1]), ptr(hall[b0:b1]), ptr(ghall[b0:b1]),
            rows(g_outs, b0, b1), rows(g_final, b0, b1), ptr(wt), wt.shape[1],
            int(bf16), ptr(ebuf),
            ptr(bar), ptr(ggx[b0:b1]), ptr(ghn[b0:b1]), ptr(g_h0[b0:b1]),
            b1 - b0, L, H, p.units, p.blocks, int(p.route == "streamed"), p.smem,
            int(reverse), dev.index, current_stream(dev),
        )
        check(lib, "gru_bwd_kernel", code)
        gru_bwd_fused.launches += 1
        gru_bwd_fused.bf16_launches += bf16
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
    tensor launches the kernels (fp32 or bf16 W_hh, with grad or without;
    fp32 carry); any other device raises.  Differentiable with
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


# kernel launches since the last reset: one per call and batch chunk of
# `plan` (one persistent launch runs all L steps)
gru_scan_fused.launches = 0
# adjoint kernel launches, counted the same way; those of the bf16 W_hh mode
# also on their own
gru_bwd_fused.launches = 0
gru_bwd_fused.bf16_launches = 0
