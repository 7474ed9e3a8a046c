"""CAMERA's gated attention on the card: the wrappers of csrc/agsa_attn.cu
(forward) and csrc/agsa_attn_bwd.cu (backward).

They replace the TPU kernels itrx/ops/pallas/agsa_attn.py::_fwd_kernel and
::_bwd_kernel (the custom VJP `agsa_attention`).  Per (batch row, head), on
the head's q, k and v rows (N, d_k) after the q/k/v projections:

    gq = q Wq^T + bq,  gk = k Wk^T + bk              (fp32 accumulation)
    gg = cast(gq * gk)
    m1 = sigmoid(gg Wg1^T + bg1),  m2 = sigmoid(gg Wg2^T + bg2)
    qm = cast(q * m1 / sqrt(d_k)),  km = cast(k * m2)
    p  = softmax over keys of qm km^T                (fp32)
    out = cast(cast(p) v)                            (fp32 accumulation)

`cast` rounds to the inputs' dtype (the identity in fp32): the TPU kernel's
rounding points.  Weights are read in the activation dtype and biases in
fp32, as `_fwd_call` passes them.  Wq, Wk are fc_q's and fc_k's weights and
Wg1, Wg2 the two halves of fc_g's (2 d_k, d_k) weight, all in torch's
(out, in) layout.

The backward recomputes the gates, scores and softmax from q, k and v (the
forward saves nothing but its inputs, as `itrx`'s VJP) and returns dq, dk,
dv in q's dtype and the eight weight and bias cotangents in fp32, rounding
where `_bwd_kernel` rounds (:115-156).

q, k and v come in the projections' own (B, N, h d_k) layout, head j at
columns [j d_k, (j + 1) d_k), and the output and dq, dk, dv go out in it:
the kernels read each head's columns where they are, so neither side pays
the (B, N, h, d_k) <-> (B, h, N, d_k) transposes `itrx` makes around its
kernel.

A CPU tensor takes the plain pair; a CUDA tensor (fp32 or bf16) launches
the kernels or raises.  `itrx` sends only bf16 to its kernel; the port
sends every CUDA call to it, fp32 too.  The forward (both dtypes) runs fp32
FMAs in the plain version's order of operations, element by element, and
agrees with agsa_attention_plain bit for bit: a persistent grid over units
of heads, rows staged by cp.async, register tiles (`fwd_plan`;
csrc/agsa_attn.cu says why the order is kept).  The bf16 backward keeps
its first FMA design; the fp32 backward (every CAMERA training step) runs every
product on the tensor cores as three TF32 passes, one pass over the heads
and an ordered reduction.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import check, current_stream, load, ptr

SOURCE = "agsa_attn.cu"
BWD_SOURCE = "agsa_attn_bwd.cu"
MAX_N = 64
MAX_DK = 128
# the most blocks of the bf16 backward's gate pass an SM holds: 2048 threads
# over its 256-thread blocks
SLOTS_PER_SM = 8


def within_limits(n: int, d_k: int) -> bool:
    """True for the shapes both kernels take: N <= 64, d_k <= 128 and a
    multiple of 8 (it covers itrx's gate, d_k % 8 == 0 and d_k <= 128)."""
    return 1 <= n <= MAX_N and 8 <= d_k <= MAX_DK and d_k % 8 == 0


def _work(dt: torch.dtype) -> torch.dtype:
    """The plain pair's arithmetic type: fp32, or float64 for float64 inputs
    (gradcheck)."""
    return torch.float64 if dt == torch.float64 else torch.float32


def _chain(q, k, v, wq, bq, wk, bk, wg1, bg1, wg2, bg2, heads: int) -> dict:
    """The forward chain per head, (B, h, N, d_k), in the arithmetic type on
    the activation dtype's values, with the kernels' rounding points."""
    dt = q.dtype
    wd = _work(dt)
    b, n, d = q.shape
    d_k = d // heads

    def heads_of(x):  # (B, h, N, d_k)
        return x.reshape(b, n, heads, d_k).transpose(1, 2).to(wd)

    def weight(w):  # the activation dtype's values
        return w.to(dt).to(wd)

    def cast(x):
        return x.to(dt).to(wd)

    c = dict(cast=cast, inv=1.0 / math.sqrt(d_k), d_k=d_k,
             qh=heads_of(q), kh=heads_of(k), vh=heads_of(v),
             wq=weight(wq), wk=weight(wk), wg1=weight(wg1), wg2=weight(wg2))
    c["gq"] = c["qh"] @ c["wq"].t() + bq.to(wd)
    c["gk"] = c["kh"] @ c["wk"].t() + bk.to(wd)
    c["ggc"] = cast(c["gq"] * c["gk"])
    c["m1"] = torch.sigmoid(c["ggc"] @ c["wg1"].t() + bg1.to(wd))
    c["m2"] = torch.sigmoid(c["ggc"] @ c["wg2"].t() + bg2.to(wd))
    c["qm"] = cast(c["qh"] * c["m1"] * c["inv"])
    c["km"] = cast(c["kh"] * c["m2"])
    c["p"] = torch.softmax(c["qm"] @ c["km"].transpose(-1, -2), dim=-1)
    return c


def _merge_heads(x, dt):
    """(B, h, N, d_k) -> (B, N, h d_k) in `dt`."""
    b, h, n, d_k = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d_k).to(dt)


def agsa_attention_plain(q, k, v, wq, bq, wk, bk, wg1, bg1, wg2, bg2, heads: int):
    """The gated attention in plain PyTorch with the kernel's rounding points:
    (B, N, h d_k) q, k, v -> (B, N, h d_k) in q's dtype.  The arithmetic is
    fp32 on the input values (float64 for float64 inputs); differentiable."""
    c = _chain(q, k, v, wq, bq, wk, bk, wg1, bg1, wg2, bg2, heads)
    cast = c["cast"]
    return _merge_heads(cast(cast(c["p"]) @ c["vh"]), q.dtype)


def agsa_attention_bwd_plain(q, k, v, wq, bq, wk, bk, wg1, bg1, wg2, bg2, g_out, heads: int):
    """The backward of `agsa_attention_plain` written out, as `_bwd_kernel`
    computes it: recompute the chain, then the attention adjoints, the gate
    adjoints and the weight sums, rounding to the activation dtype at its
    points (p, g_s, gg, g_z1, g_z2, g_gq, g_gk and the outputs) with every
    sum in fp32 (float64 for float64 inputs).  The bias cotangents sum the
    unrounded adjoints, as `itrx`'s do.  Returns (dq, dk, dv) (B, N, h d_k)
    in q's dtype and (dWq, dbq, dWk, dbk, dWg1, dbg1, dWg2, dbg2) in torch's
    (out, in) layout in the arithmetic type."""
    c = _chain(q, k, v, wq, bq, wk, bk, wg1, bg1, wg2, bg2, heads)
    cast, inv, d_k, p = c["cast"], c["inv"], c["d_k"], c["p"]
    b, n, d = q.shape
    go = g_out.reshape(b, n, heads, d_k).transpose(1, 2).to(p.dtype)
    # attention adjoints
    g_v = cast(p).transpose(-1, -2) @ go
    g_p = go @ c["vh"].transpose(-1, -2)
    g_s = p * (g_p - (g_p * p).sum(-1, keepdim=True))
    gsb = cast(g_s)
    g_qm = gsb @ c["km"]
    g_km = gsb.transpose(-1, -2) @ c["qm"]
    # gate adjoints
    g_m1 = g_qm * c["qh"] * inv
    g_q = g_qm * c["m1"] * inv
    g_m2 = g_km * c["kh"]
    g_k = g_km * c["m2"]
    g_z1 = g_m1 * c["m1"] * (1.0 - c["m1"])
    g_z2 = g_m2 * c["m2"] * (1.0 - c["m2"])
    gz1c, gz2c = cast(g_z1), cast(g_z2)
    g_gg = gz1c @ c["wg1"] + gz2c @ c["wg2"]
    g_gq = g_gg * c["gk"]
    g_gk = g_gg * c["gq"]
    ggq_c, ggk_c = cast(g_gq), cast(g_gk)
    g_q = g_q + ggq_c @ c["wq"]
    g_k = g_k + ggk_c @ c["wk"]

    def rows(x):  # (B h N, d_k)
        return x.reshape(-1, d_k)

    def wgrad(g, x):  # sum over rows of g^T x, (out, in)
        return rows(g).t() @ rows(x)

    dt = q.dtype
    return (_merge_heads(g_q, dt), _merge_heads(g_k, dt), _merge_heads(g_v, dt),
            wgrad(ggq_c, c["qh"]), rows(g_gq).sum(0), wgrad(ggk_c, c["kh"]),
            rows(g_gk).sum(0), wgrad(gz1c, c["ggc"]), rows(g_z1).sum(0),
            wgrad(gz2c, c["ggc"]), rows(g_z2).sum(0))


def _guard(name, q, k, v, weights, heads: int, g_out=None) -> str:
    """"cpu" or "cuda": any other device raises; on a CUDA device every
    shape and type the kernels do not take raises (both kernels take the
    same shapes, so a call that needs a gradient is refused here, before
    its forward launches)."""
    if q.device.type == "cpu":
        return "cpu"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    b, n, d = q.shape
    if d % heads:
        raise ValueError(f"{name}: width {d} is not a multiple of {heads} heads")
    d_k = d // heads
    if not within_limits(n, d_k):
        raise ValueError(f"{name}: N {n}, d_k {d_k} outside the kernels' limits "
                         f"(N <= {MAX_N}, d_k <= {MAX_DK}, d_k % 8 == 0)")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: fp32 or bf16 inputs, got {q.dtype}")
    acts = (k, v) if g_out is None else (k, v, g_out)
    for t in (*acts, *weights):
        if t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on one device")
    if any(t.shape != q.shape or t.dtype != q.dtype for t in acts):
        raise ValueError(f"{name}: q, k, v (and g_out) must agree in shape and dtype")
    for w in weights[0::2]:
        if tuple(w.shape) != (d_k, d_k):
            raise ValueError(f"{name}: weight {tuple(w.shape)} != {(d_k, d_k)}")
    for bias in weights[1::2]:
        if tuple(bias.shape) != (d_k,):
            raise ValueError(f"{name}: bias {tuple(bias.shape)} != {(d_k,)}")
    return "cuda"


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data does not start on 16 bytes (the
    kernels stage rows with 16-byte copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_weights(weights, dt):
    """Weights in the activation dtype, biases fp32, as the TPU wrapper passes
    them."""
    return [_aligned(w.detach().to(dt).contiguous() if i % 2 == 0
                     else w.detach().float().contiguous()) for i, w in enumerate(weights)]


@functools.cache
def plan(b: int, n: int, heads: int, d_k: int, device: int, defines: tuple = ()) -> dict:
    """The launch the fp32 backward's head pass makes for these sizes, as
    the kernel plans it: the persistent grid (also the number of slots of
    weight-sum partials it writes), the staging ring's stages (1 or 2), the
    blocks an SM holds and the shared bytes a block uses."""
    lib = load("agsa_attn_bwd", defines)
    fn = lib.itrx_agsa_bwd_plan
    out = (ctypes.c_int * 4)()
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check(lib, "agsa_attn_bwd plan", fn(b, n, heads, d_k, 1 << 30, device, out))
    return dict(zip(("grid", "stages", "blocks_per_sm", "smem_bytes"), out))


@functools.cache
def fwd_plan(b: int, n: int, heads: int, d_k: int, bf16: bool, device: int) -> dict:
    """The launch the forward makes for these sizes, as the kernel plans it:
    the persistent grid, G (heads a unit), the staging ring's stages (1 or
    2), the blocks an SM holds, the shared bytes and the warps a block
    uses."""
    lib = load("agsa_attn")
    fn = lib.itrx_agsa_fwd_plan
    out = (ctypes.c_int * 6)()
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check(lib, "agsa_attn plan", fn(b, n, heads, d_k, int(bf16), device, out))
    return dict(zip(("grid", "G", "stages", "blocks_per_sm", "smem_bytes", "warps"), out))


def _launch_fwd(q, k, v, weights, heads: int, lib=None):
    """One launch of the forward kernel (`lib`: csrc/agsa_attn.cu's library
    as the port builds it, or a build of the same C entry that a tool
    passes)."""
    b, n, d = q.shape
    dt, dev = q.dtype, q.device
    # every temporary is held by a name until the launch is queued; the
    # kernel stages rows with 16-byte copies
    ins = [_aligned(t.detach().contiguous()) for t in (q, k, v)]
    ws = _kernel_weights(weights, dt)
    out = torch.empty(b, n, d, dtype=dt, device=dev)
    if lib is None:
        lib = load("agsa_attn")
    fn = lib.itrx_agsa_fwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(*(ptr(t) for t in ins), *(ptr(w) for w in ws), ptr(out), b, n, heads,
              d // heads, int(dt == torch.bfloat16), dev.index, current_stream(dev))
    check(lib, "agsa_attn kernel", code)
    agsa_attention_fused.launches += 1
    return out


def _launch_bwd(q, k, v, weights, g_out, heads: int, defines: tuple = ()):
    b, n, d = q.shape
    d_k = d // heads
    dt, dev = q.dtype, q.device
    bf16 = dt == torch.bfloat16
    lib = load("agsa_attn_bwd", defines)
    # every temporary is held by a name until the launches are queued
    ins = [_aligned(t.detach().contiguous()) for t in (q, k, v, g_out)]
    ws = _kernel_weights(weights, dt)
    grads = [torch.empty(b, n, d, dtype=dt, device=dev) for _ in range(3)]
    f32 = dict(dtype=torch.float32, device=dev)
    # dWq, dWk, dWg1, dWg2 (d_k, d_k) then dbq, dbk, dbg1, dbg2 (d_k), fp32;
    # one slot of their partial sums per block, summed in order by the last
    # launch.  fp32: a slot per block of the head pass.  bf16 (the PR 12
    # design): g_qm and g_km (B, N, h d_k) fp32 between its passes, and slots
    # for the most gate-pass blocks the SMs hold
    dw = torch.empty(4 * d_k * d_k + 4 * d_k, **f32)
    if bf16:
        work = torch.empty(2, b, n, d, **f32)
        slots = torch.cuda.get_device_properties(dev).multi_processor_count * SLOTS_PER_SM
        gqm, gkm = ptr(work[0]), ptr(work[1])
    else:
        slots = plan(b, n, heads, d_k, dev.index, defines)["grid"]
        gqm = gkm = ctypes.c_void_p(None)
    part = torch.empty(slots, dw.numel(), **f32)
    fn = lib.itrx_agsa_bwd
    fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(*(ptr(t) for t in ins), *(ptr(w) for w in ws), *(ptr(t) for t in grads),
              ptr(dw), ptr(part), gqm, gkm, b, n, heads, d_k, slots, int(bf16), dev.index,
              current_stream(dev))
    check(lib, "agsa_attn_bwd kernels", code)
    agsa_attention_bwd_fused.launches += 1
    sq = d_k * d_k
    dwq, dwk, dwg1, dwg2 = (dw[i * sq:(i + 1) * sq].view(d_k, d_k) for i in range(4))
    dbq, dbk, dbg1, dbg2 = (dw[4 * sq + i * d_k:4 * sq + (i + 1) * d_k] for i in range(4))
    return (*grads, dwq, dbq, dwk, dbk, dwg1, dbg1, dwg2, dbg2)


def agsa_attention_bwd_fused(q, k, v, wq, bq, wk, bk, wg1, bg1, wg2, bg2, g_out, heads: int):
    """The backward for the output's cotangent g_out (B, N, h d_k): (dq,
    dk, dv) in q's dtype and (dWq, dbq, dWk, dbk, dWg1, dbg1, dWg2, dbg2)
    fp32.  A CPU tensor takes `agsa_attention_bwd_plain`; a CUDA tensor
    launches the backward kernels (one count per call) or raises; any other
    device raises."""
    weights = (wq, bq, wk, bk, wg1, bg1, wg2, bg2)
    g_out = g_out.to(q.dtype)  # as `_agsa_bwd` casts it
    if _guard("agsa_attention_bwd_fused", q, k, v, weights, heads, g_out) == "cpu":
        return agsa_attention_bwd_plain(q, k, v, *weights, g_out, heads)
    return _launch_bwd(q, k, v, weights, g_out, heads)


class _AGSAAttention(torch.autograd.Function):
    """The gated attention under autograd.  It saves only its inputs; the
    backward recomputes the chain from them, as `itrx`'s custom VJP does
    (itrx/ops/pallas/agsa_attn.py:251-299)."""

    @staticmethod
    def forward(ctx, q, k, v, wq, bq, wk, bk, wg1, bg1, wg2, bg2, heads):
        weights = (wq, bq, wk, bk, wg1, bg1, wg2, bg2)
        ctx.heads = heads
        ctx.save_for_backward(q, k, v, *weights)
        if q.device.type == "cpu":
            return agsa_attention_plain(q, k, v, *weights, heads)
        return _launch_fwd(q, k, v, weights, heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, *weights = ctx.saved_tensors
        out = agsa_attention_bwd_fused(q, k, v, *weights, g, ctx.heads)
        grads = [t.to(x.dtype) for t, x in zip(out, (q, k, v, *weights))]
        return (*grads, None)


def agsa_attention_fused(q, k, v, wq, bq, wk, bk, wg1, bg1, wg2, bg2, heads: int):
    """(B, N, h d_k) q, k, v and the gate's weights and biases -> (B, N,
    h d_k) in q's dtype, differentiable in all eleven.  A CPU tensor takes
    `agsa_attention_plain` (and `agsa_attention_bwd_plain` in the
    backward); a CUDA tensor launches the forward kernel (one count per
    call; the backward kernels in the backward) or raises; any other device
    raises."""
    weights = (wq, bq, wk, bk, wg1, bg1, wg2, bg2)
    dev = _guard("agsa_attention_fused", q, k, v, weights, heads)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, *weights)):
        return _AGSAAttention.apply(q, k, v, *weights, heads)
    with torch.no_grad():
        if dev == "cpu":
            return agsa_attention_plain(q, k, v, *weights, heads)
        return _launch_fwd(q, k, v, weights, heads)


# kernel launches since the last reset (each wrapper counts once per call)
agsa_attention_fused.launches = 0
agsa_attention_bwd_fused.launches = 0
