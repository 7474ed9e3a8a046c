"""SGRAF-SGR graph reasoning in training, on the card: the wrappers of
csrc/sgr.cu (forward) and csrc/sgr_bwd.cu (backward).

They replace the TPU kernels itrx/ops/pallas/sgr.py::_fwd_kernel and
::_bwd_kernel (the custom VJP `sgr_reason`).  For nodes s (B, N, S) with a
node mask (B, N) and `steps` GraphReasoning steps, each with the q/k fold
M = Wq^T Wk, v = Wk^T bq (`fold_sgr_qk`; bk drops out of the softmax):

    e   = (s M) s^T + (s v)_keys          masked to the valid keys at -1e18
    a   = softmax_keys(e)
    s  <- relu(a s Wg^T + bg) * mask      (zero at masked nodes)

The nodes of masked (query) nodes are written as zeros and their cotangents
are ignored: masked keys take softmax weight 0, so a masked node's value
never reaches a valid one, and the caller keeps node 0, which is valid.
`itrx`'s kernel writes relu values there that nothing reads; the plain pair
does as the kernels do, so kernels, plain pair and `itrx` agree on valid
nodes.

The backward is the exact derivative of the plain forward in the folded
form; the wrapper turns the folded cotangents into the layers' (as
itrx/ops/pallas/sgr.py:318-333 does): dWq = Wk dM^T, dWk = Wq dM + bq dv^T,
dbq = Wk dv, and dbk = 0 exactly (bk moves each query's logits by a
constant).

What bounds them on an H100: the S x S products (X M and ctx Wg^T in the
forward, five of them in the backward) over the valid nodes, then the
n x n x S edges and contexts of each pair; at the training chunk the
forward's bound is the bytes of its saves.  Both run their products on the
tensor cores as split-bf16 products (three bf16 passes, a_hi b_lo + a_lo
b_hi + a_hi b_hi, fp32 accumulation; two where the operand is bf16 nodes),
on weights split once a call here (`fwd_weights`, `bwd_weights`), over a
list of the valid rows and the edge passes' pair ranges formed on the card
by two small kernels (csrc/sgr_rows.cuh::plan_kernel and plan_rows_kernel,
once a call; `row_list` and `edge_bounds` are their plain version): nothing
is read back.  Both keep the chain's
other arithmetic in fp32 whatever the nodes' dtype; the saves are fp32,
and the forward's kernels write every row of them (zeros at masked nodes),
so they are allocated without a memset.

Arguments are the port's layouts: the stacked steps' Linears as torch stores
them, wq, wk, wg (steps, S, S) (out, in) and bq, bk, bg (steps, S).  A CPU
tensor takes the plain pair; a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import check, current_stream, load, ptr
from .sgraf_eval import fold_sgr_qk, split_weight

SOURCE = "sgr.cu"
BWD_SOURCE = "sgr_bwd.cu"
MAX_NODES = 129  # 128 words + the global node (sgraf_align.MAX_WORDS + 1)
MAX_SIM_DIM = 256
NEG_INF = -1e18
# the backward's weight sums over the rows: split into this many fixed parts
# (at S 256, 2 x 2 x 32 blocks of 128 x 256 on 132 SMs), summed in order (no
# atomics, so two calls give identical gradients)
W_SPLITS = 32
# the edge passes: a persistent grid of this many blocks an SM (the
# edge_kernel of csrc/sgr.cu and of csrc/sgr_bwd.cu, 110 KB of shared memory
# a block)
EDGE_BLOCKS_PER_SM = 2


def _work(t: torch.Tensor) -> torch.dtype:
    """The plain pair's arithmetic type: fp32, or float64 for float64 inputs
    (gradcheck)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _softmax(x, sm, v, keys):
    """One step's edge softmax in the folded form: e = sm x^T + (x v)_keys,
    masked to the keys."""
    e = sm @ x.transpose(1, 2) + (x @ v)[:, None, :]
    return torch.softmax(e.masked_fill(~keys, NEG_INF), dim=-1)


def sgr_reason_plain(s0, mask, wq, bq, wk, bk, wg, bg):
    """The forward in plain PyTorch, fp32 on the input values (float64 for
    float64 inputs), differentiable.  s0 (B, N, S), mask (B, N) -> (the
    final nodes (B, N, S) in s0's dtype, every step's output (steps, B, N,
    S) in the arithmetic's type), zero at masked nodes.  bk drops out."""
    wd = _work(s0)
    x, m = s0.to(wd), mask.to(wd)
    keys, qm = m[:, None, :] > 0, m[..., None]
    mm, vv = fold_sgr_qk(wq, bq, wk, wd)
    outs = []
    for i in range(mm.shape[0]):
        a = _softmax(x, x @ mm[i], vv[i], keys)
        x = torch.relu(F.linear(a @ x, wg[i].to(wd), bg[i].to(wd))) * qm
        outs.append(x)
    return x.to(s0.dtype), torch.stack(outs)


def _unfold(dmm, dvv, wq, bq, wk):
    """(dWq, dbq, dWk) from the folded cotangents dM (steps, S, S) and dv
    (steps, S), in their type: M = Wq^T Wk and v = Wk^T bq give dWq = Wk dM^T,
    dWk = Wq dM + bq dv^T and dbq = Wk dv."""
    wq, bq, wk = (t.detach().to(dmm.dtype) for t in (wq, bq, wk))
    dwq = wk @ dmm.transpose(1, 2)
    dwk = wq @ dmm + bq[:, :, None] * dvv[:, None, :]
    dbq = (wk @ dvv[..., None])[..., 0]
    return dwq, dbq, dwk


@torch.no_grad()
def sgr_reason_bwd_plain(s0, mask, wq, bq, wk, bk, wg, bg, outs, g):
    """The backward in plain PyTorch: the exact derivative of
    `sgr_reason_plain` for the final nodes' cotangent g (B, N, S), from the
    forward's input s0 and its step outputs `outs` (steps, B, N, S), each
    step's softmax recomputed.  g is read at valid nodes only.  Returns
    (g_s0 in s0's dtype, zero at masked nodes; dWq, dbq, dWk, dbk (zeros),
    dWg, dbg in fp32, float64 for float64 inputs)."""
    wd = _work(s0)
    m = mask.to(wd)
    keys, qm = m[:, None, :] > 0, m[..., None]
    mm, vv = fold_sgr_qk(wq, bq, wk, wd)
    wgw, outs = wg.detach().to(wd), outs.to(wd)
    dmm, dwg = torch.zeros_like(mm), torch.zeros_like(mm)
    dvv, dbg = torch.zeros_like(vv), torch.zeros_like(vv)
    g = g.to(wd) * qm
    for i in reversed(range(mm.shape[0])):
        x = outs[i - 1] if i else s0.to(wd)
        sm = x @ mm[i]
        a = _softmax(x, sm, vv[i], keys)
        gp = g * (outs[i] > 0)
        dwg[i] = torch.einsum("bno,bni->oi", gp, a @ x)
        dbg[i] = gp.sum(dim=(0, 1))
        gc = gp @ wgw[i]
        ga = gc @ x.transpose(1, 2)
        ge = a * (ga - (ga * a).sum(-1, keepdim=True))
        gsm = ge @ x
        col = ge.sum(dim=1)
        dmm[i] = torch.einsum("bna,bnc->ac", x, gsm)
        dvv[i] = torch.einsum("bn,bna->a", col, x)
        gx = a.transpose(1, 2) @ gc + ge.transpose(1, 2) @ sm + col[..., None] * vv[i] \
            + gsm @ mm[i].transpose(0, 1)
        g = gx * qm
    dwq, dbq, dwk = _unfold(dmm, dvv, wq, bq, wk)
    return g.to(s0.dtype), dwq, dbq, dwk, torch.zeros_like(dbq), dwg, dbg


def _guard(name, s0, mask, wq, bq, wk, bk, wg, bg, outs=None, g=None) -> str:
    """"cpu" or "cuda" for the wrapper `name`: any device other than the two
    raises; on a CUDA device every shape, type and alignment the kernels do
    not take raises."""
    if s0.device.type == "cpu":
        return "cpu"
    if s0.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {s0.device}")
    b, n, s = s0.shape
    steps = wq.shape[0]
    if tuple(mask.shape) != (b, n) or steps < 1 \
            or any(tuple(t.shape) != (steps, s, s) for t in (wq, wk, wg)) \
            or any(tuple(t.shape) != (steps, s) for t in (bq, bk, bg)):
        raise ValueError(f"{name}: shapes of the inputs disagree (nodes (B, N, S), mask "
                         "(B, N), weights (steps >= 1, S, S) and (steps, S))")
    if outs is not None and (tuple(outs.shape) != (steps, b, n, s)
                             or outs.dtype != torch.float32):
        raise ValueError(f"{name}: the saves must be fp32 (steps, B, N, S)")
    if g is not None and tuple(g.shape) != (b, n, s):
        raise ValueError(f"{name}: the cotangent must be (B, N, S) = {(b, n, s)}")
    if not 1 <= n <= MAX_NODES:
        raise ValueError(f"{name}: {n} nodes not in [1, {MAX_NODES}]")
    if s > MAX_SIM_DIM or s % 4 or s < 4:
        raise ValueError(f"{name}: sim_dim {s} must be a multiple of 4 in [4, {MAX_SIM_DIM}]")
    if s0.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: nodes must be fp32 or bf16, got {s0.dtype}")
    others = (mask, wq, bq, wk, bk, wg, bg) + tuple(t for t in (outs, g) if t is not None)
    if any(t.device != s0.device for t in others):
        raise ValueError(f"{name}: all tensors must be on one device")
    return "cuda"


def _f32(t):
    return t.detach().float().contiguous()


def _nodes(name, s0):
    s0 = s0.detach().contiguous()
    if s0.data_ptr() % 16:
        raise ValueError(f"{name}: the nodes must be 16-byte aligned")
    return s0


def row_list(mask):
    """The plain version of the plan kernels' row list (`card_plan`): the
    kernels' valid rows p * N + j of the (B, N) mask, formed without a host
    read: (rows (B N,) int32, the valid rows in order, then the masked
    rows; pstart (B + 1,) int32, each pair's first row in that list, then
    the number of valid rows).  A permutation, so every entry is written
    once."""
    valid = mask > 0
    v = valid.reshape(-1).to(torch.int32)
    pos = torch.cumsum(v, 0, dtype=torch.int32) - v
    ends = torch.cumsum(valid.sum(dim=1, dtype=torch.int32), 0, dtype=torch.int32)
    pstart = torch.cat([ends.new_zeros(1), ends])
    idx = torch.arange(v.numel(), dtype=torch.int32, device=mask.device)
    dest = torch.where(v > 0, pos, pstart[-1:] + idx - pos)
    return torch.empty_like(idx).scatter_(0, dest.long(), idx), pstart


def edge_bounds(pstart, blocks: int):
    """The plain version of the plan kernels' pair ranges (`card_plan`): edge
    block b takes pairs bounds[b] .. bounds[b + 1] - 1, cut so that each
    range's sum of n (n + 4) over its pairs' n valid nodes (the edges ~ n^2,
    the staging ~ n) is about equal; from pstart (B + 1,) without a host
    read.  (blocks + 1,) int32."""
    n = (pstart[1:] - pstart[:-1]).to(torch.int64)
    cost = torch.cumsum(n * (n + 4), 0)
    prefix = torch.cat([cost.new_zeros(1), cost])
    steps = torch.arange(blocks, dtype=torch.int64, device=pstart.device)
    # (the last bound by a fill on the device: setting an entry from the
    # host would copy, and wait)
    last = torch.full((1,), n.numel(), dtype=torch.int64, device=pstart.device)
    return torch.cat([torch.searchsorted(prefix, steps * prefix[-1:] // blocks),
                      last]).to(torch.int32)


def edge_blocks(b: int, dev) -> int:
    """The edge passes' persistent grid: EDGE_BLOCKS_PER_SM blocks an SM, at
    most one a pair, at least one."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(b, EDGE_BLOCKS_PER_SM * sms))


def fwd_weights(mm, wg):
    """The forward's two S x S products' weights, per step, split once a
    call for the tensor cores (`split_weight`, output column first, both in
    one split): M^T for q = X M + v, and sim_graph_w Wg (steps, S, S) as
    torch stores it, (out, in), for ctx Wg^T.  Two views of one tensor."""
    both = split_weight(torch.cat([mm.transpose(1, 2), wg.float()]))
    return both[:mm.shape[0]], both[mm.shape[0]:]


def bwd_weights(mm, wg):
    """The backward's three S x S products' weights, per step, split once a
    call for the tensor cores (`split_weight`, output column first): M^T
    for sm = X M, M for g_sm M^T, and Wg^T for g_ctx = g_pre Wg, from M
    (steps, S, S) and sim_graph_w Wg (steps, S, S) (out, in)."""
    return (split_weight(mm.transpose(1, 2)), split_weight(mm),
            split_weight(wg.transpose(1, 2)))


def plan_size(b: int, n: int, blocks: int) -> int:
    """int32 entries of a plan workspace (csrc/sgr_rows.cuh,
    `plan_of`): the edge costs' prefix (B + 1 int64), the row list, each
    pair's first row and the edge ranges."""
    return 2 * (b + 1) + b * n + (b + 1) + (blocks + 1)


def card_plan(mask, blocks: int):
    """(rows, pstart, bounds) as the plan kernels form them on the card for
    a CUDA mask (B, N) and `blocks` edge blocks (the backward's plan; the
    forward forms its own in its first launches): `row_list` and
    `edge_bounds` (their plain versions) of one call."""
    b, n = mask.shape
    plan = torch.empty(plan_size(b, n, blocks), dtype=torch.int32, device=mask.device)
    lib = load("sgr")
    fn = lib.itrx_sgr_plan
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    maskf = _f32(mask)
    check(lib, "sgr_plan_kernels", fn(ptr(maskf), ptr(plan), b, n, blocks, mask.device.index,
                                     current_stream(mask.device)))
    return plan[2 * (b + 1):].split([b * n, b + 1, blocks + 1])


def _launch_fwd(s0, mask, wq, bq, wk, bk, wg, bg):
    """(final nodes in s0's dtype, fp32 saves (steps, B, N, S))."""
    name = "sgr_reason_fused"
    s0 = _nodes(name, s0)
    b, n, s = s0.shape
    steps = wq.shape[0]
    dev = s0.device
    # every row of every step is written by the kernels: no memset
    outs = torch.empty(steps, b, n, s, dtype=torch.float32, device=dev)
    blocks = edge_blocks(b, dev)
    plan = torch.empty(plan_size(b, n, blocks), dtype=torch.int32, device=dev)
    lib = load("sgr")
    fn = lib.itrx_sgr_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # every temporary is held by a name until the launches have been queued
    maskf = _f32(mask)
    mm, vv = (t.contiguous() for t in fold_sgr_qk(wq.detach(), bq.detach(), wk.detach()))
    mts, gws = fwd_weights(mm, wg.detach())
    bgf = _f32(bg)
    code = fn(ptr(s0), ptr(maskf), ptr(plan), ptr(mts), ptr(vv), ptr(gws), ptr(bgf), ptr(outs),
              b, n, s, steps, blocks, int(s0.dtype == torch.bfloat16), dev.index,
              current_stream(dev))
    check(lib, "sgr_fwd_kernels", code)
    sgr_reason_fused.launches += 1
    return outs[-1].to(s0.dtype), outs


def _launch_bwd(s0, mask, wq, bq, wk, bk, wg, bg, outs, g):
    name = "sgr_reason_bwd_fused"
    s0 = _nodes(name, s0)
    b, n, s = s0.shape
    steps = wq.shape[0]
    dev = s0.device
    f32 = dict(dtype=torch.float32, device=dev)
    # the cotangent of s0, zero at masked nodes: the kernels write it at the
    # valid nodes, step by step the cotangent of each step's input
    g_in = g.detach().float().contiguous()
    gx = torch.zeros(b, n, s, **f32)
    dmm, dwg = torch.empty(steps, s, s, **f32), torch.empty(steps, s, s, **f32)
    dvv, dbg = torch.empty(steps, s, **f32), torch.empty(steps, s, **f32)
    # sized from the shapes (the row count stays on the card): sm, ctx,
    # g_ctx, g_sm, gx, g_pre per row, col, and the weight sums' partials per
    # split
    ws = [torch.empty(b * n, s, **f32) for _ in range(6)]
    ws += [torch.empty(b * n, **f32), torch.empty(2, W_SPLITS, s, s, **f32),
           torch.empty(2, W_SPLITS, s, **f32)]
    lib = load("sgr_bwd")
    fn = lib.itrx_sgr_bwd
    fn.argtypes = [ctypes.c_void_p] * 25 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # every temporary is held by a name until the launches have been queued
    maskf, saves = _f32(mask), outs.detach().contiguous()
    rows, pstart, bounds = card_plan(mask, edge_blocks(b, dev))
    blocks = bounds.numel() - 1
    mm, vv = (t.contiguous() for t in fold_sgr_qk(wq.detach(), bq.detach(), wk.detach()))
    mts, ms, gs = bwd_weights(mm, wg.detach())
    code = fn(ptr(s0), ptr(saves), ptr(maskf), ptr(rows), ptr(pstart), ptr(bounds), ptr(mts),
              ptr(ms), ptr(vv), ptr(gs), ptr(g_in), ptr(gx), ptr(dmm), ptr(dvv), ptr(dwg),
              ptr(dbg), *(ptr(t) for t in ws), b, n, s, steps, W_SPLITS, blocks,
              int(s0.dtype == torch.bfloat16), dev.index, current_stream(dev))
    check(lib, "sgr_bwd_kernels", code)
    sgr_reason_bwd_fused.launches += 1
    dwq, dbq, dwk = _unfold(dmm, dvv, wq, bq, wk)
    return gx.to(s0.dtype), dwq, dbq, dwk, torch.zeros_like(dbq), dwg, dbg


def _fwd(dev: str, args) -> tuple:
    """The forward on the device `_guard` named, without a gradient."""
    with torch.no_grad():
        return sgr_reason_plain(*args) if dev == "cpu" else _launch_fwd(*args)


def sgr_reason_fwd_fused(s0, mask, wq, bq, wk, bk, wg, bg):
    """The forward with the saves the backward reads: (the final nodes in
    s0's dtype, every step's fp32 output (steps, B, N, S)), zero at masked
    nodes, without a gradient.  A CPU tensor takes `sgr_reason_plain`; a
    CUDA tensor launches the forward kernels (counted on `sgr_reason_fused`,
    once a call); any other device raises."""
    args = (s0, mask, wq, bq, wk, bk, wg, bg)
    return _fwd(_guard("sgr_reason_fwd_fused", *args), args)


def sgr_reason_bwd_fused(s0, mask, wq, bq, wk, bk, wg, bg, outs, g):
    """The backward: (g_s0, dWq, dbq, dWk, dbk = 0, dWg, dbg) for the final
    nodes' cotangent g, from the forward's input and fp32 saves.  A CPU
    tensor takes `sgr_reason_bwd_plain`; a CUDA tensor launches the backward
    kernels (one count per call) on the plan of this mask that `card_plan`
    forms; any other device raises."""
    args = (s0, mask, wq, bq, wk, bk, wg, bg, outs, g)
    if _guard("sgr_reason_bwd_fused", *args) == "cpu":
        return sgr_reason_bwd_plain(*args)
    return _launch_bwd(*args)


class _SGRReason(torch.autograd.Function):
    """The reasoning chain under autograd.  It saves its inputs and every
    step's output in fp32, as `itrx`'s custom VJP saves its steps
    (itrx/ops/pallas/sgr.py:244-248); the backward recomputes each step's
    softmax from them."""

    @staticmethod
    def forward(ctx, s0, mask, wq, bq, wk, bk, wg, bg):
        args = (s0, mask, wq, bq, wk, bk, wg, bg)
        out, outs = sgr_reason_plain(*args) if s0.device.type == "cpu" else _launch_fwd(*args)
        ctx.save_for_backward(s0, mask, wq, bq, wk, bk, wg, bg, outs)
        return out

    @staticmethod
    def backward(ctx, g):
        s0, mask, wq, bq, wk, bk, wg, bg, outs = ctx.saved_tensors
        gs, dwq, dbq, dwk, dbk, dwg, dbg = sgr_reason_bwd_fused(s0, mask, wq, bq, wk, bk, wg,
                                                                bg, outs, g)
        return (gs, None, dwq.to(wq.dtype), dbq.to(bq.dtype), dwk.to(wk.dtype),
                dbk.to(bk.dtype), dwg.to(wg.dtype), dbg.to(bg.dtype))


def sgr_reason_fused(s0, mask, wq, bq, wk, bk, wg, bg):
    """`steps = wq.shape[0]` SGR reasoning steps: the final nodes (B, N, S)
    in s0's dtype, zero at masked nodes; differentiable in s0 and the six
    weights (bk's gradient is exactly 0).

    s0 (B, N, S) fp32 or bf16 nodes, mask (B, N); wq, wk, wg (steps, S, S)
    and bq, bk, bg (steps, S): graph_query_w, graph_key_w and sim_graph_w of
    the steps, stacked.  A CPU tensor takes `sgr_reason_plain` (and
    `sgr_reason_bwd_plain` in the backward); a CUDA tensor launches the
    forward kernels (and the backward kernels) or raises; any other device
    raises."""
    args = (s0, mask, wq, bq, wk, bk, wg, bg)
    dev = _guard("sgr_reason_fused", *args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _SGRReason.apply(*args)
    return _fwd(dev, args)[0]


# kernel launches since the last reset (each wrapper counts once per call)
sgr_reason_fused.launches = 0
sgr_reason_bwd_fused.launches = 0
