"""CAMERA's gated attention on the card: the wrapper of csrc/agsa_attn.cu.

It replaces the TPU kernel itrx/ops/pallas/agsa_attn.py::_fwd_kernel (the
forward of `agsa_attention`).  Per (batch row, head), on the head's q, k
and v rows (N, d_k) after the q/k/v projections:

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

q, k and v come in the projections' own (B, N, h d_k) layout, head j at
columns [j d_k, (j + 1) d_k), and the output goes out in it: the kernel
reads each head's columns where they are, so neither side pays the
(B, N, h, d_k) <-> (B, h, N, d_k) transposes `itrx` makes around its kernel.

A CPU tensor takes `agsa_attention_plain`; a CUDA tensor (fp32 or bf16)
launches the kernel or raises.  The kernel has no backward yet (ROADMAP
queue 1 item 11b): a CUDA call that needs a gradient raises.  `itrx` sends
only bf16 to its kernel; the port sends every CUDA call to it, fp32 too.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import check, current_stream, load, ptr

SOURCE = "agsa_attn.cu"
MAX_N = 64
MAX_DK = 128
_BACKWARD = "ROADMAP queue 1 item 11b (the AGSA backward kernel)"


def within_limits(n: int, d_k: int) -> bool:
    """True for the shapes the kernel takes: N <= 64, d_k <= 128 and a
    multiple of 8 (it covers itrx's gate, d_k % 8 == 0 and d_k <= 128)."""
    return 1 <= n <= MAX_N and 8 <= d_k <= MAX_DK and d_k % 8 == 0


def agsa_attention_plain(q, k, v, wq, bq, wk, bk, wg1, bg1, wg2, bg2, heads: int):
    """The gated attention in plain PyTorch with the kernel's rounding points:
    (B, N, h d_k) q, k, v -> (B, N, h d_k) in q's dtype.  The arithmetic is
    fp32 on the input values (float64 for float64 inputs); differentiable."""
    dt = q.dtype
    wd = torch.float64 if dt == torch.float64 else torch.float32
    b, n, d = q.shape
    d_k = d // heads

    def heads_of(x):  # (B, h, N, d_k)
        return x.reshape(b, n, heads, d_k).transpose(1, 2).to(wd)

    def weight(w):  # the activation dtype's values
        return w.to(dt).to(wd)

    def cast(x):
        return x.to(dt).to(wd)

    qh, kh, vh = heads_of(q), heads_of(k), heads_of(v)
    gq = qh @ weight(wq).t() + bq.to(wd)
    gk = kh @ weight(wk).t() + bk.to(wd)
    gg = cast(gq * gk)
    m1 = torch.sigmoid(gg @ weight(wg1).t() + bg1.to(wd))
    m2 = torch.sigmoid(gg @ weight(wg2).t() + bg2.to(wd))
    qm = cast(qh * m1 * (1.0 / math.sqrt(d_k)))
    km = cast(kh * m2)
    p = torch.softmax(qm @ km.transpose(-1, -2), dim=-1)
    out = cast(cast(p) @ vh)
    return out.transpose(1, 2).reshape(b, n, d).to(dt)


def _guard(q, k, v, weights, heads: int) -> str:
    """"cpu" or "cuda": any other device raises; on a CUDA device a call that
    needs a gradient, and every shape and type the kernel does not take,
    raise."""
    if q.device.type == "cpu":
        return "cpu"
    if q.device.type != "cuda":
        raise ValueError(f"agsa_attention_fused: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, *weights)):
        raise NotImplementedError(
            "agsa_attention_fused: the kernel is forward-only; its backward is "
            + _BACKWARD)
    b, n, d = q.shape
    if d % heads:
        raise ValueError(f"agsa_attention_fused: width {d} is not a multiple of {heads} heads")
    d_k = d // heads
    if not within_limits(n, d_k):
        raise ValueError(f"agsa_attention_fused: N {n}, d_k {d_k} outside the kernel's "
                         f"limits (N <= {MAX_N}, d_k <= {MAX_DK}, d_k % 8 == 0)")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"agsa_attention_fused: fp32 or bf16 inputs, got {q.dtype}")
    for t in (k, v, *weights):
        if t.device != q.device:
            raise ValueError("agsa_attention_fused: all tensors must be on one device")
    if k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("agsa_attention_fused: q, k and v must agree in shape and dtype")
    for w in weights[0::2]:
        if tuple(w.shape) != (d_k, d_k):
            raise ValueError(f"agsa_attention_fused: weight {tuple(w.shape)} != {(d_k, d_k)}")
    for bias in weights[1::2]:
        if tuple(bias.shape) != (d_k,):
            raise ValueError(f"agsa_attention_fused: bias {tuple(bias.shape)} != {(d_k,)}")
    return "cuda"


def agsa_attention_fused(q, k, v, wq, bq, wk, bk, wg1, bg1, wg2, bg2, heads: int):
    """(B, N, h d_k) q, k, v and the gate's weights and biases -> (B, N,
    h d_k) in q's dtype.  A CPU tensor takes `agsa_attention_plain`; a CUDA
    tensor launches the kernel (one count per call) or raises; any other
    device raises."""
    weights = (wq, bq, wk, bk, wg1, bg1, wg2, bg2)
    if _guard(q, k, v, weights, heads) == "cpu":
        return agsa_attention_plain(q, k, v, *weights, heads)
    b, n, d = q.shape
    dt, dev = q.dtype, q.device
    ins = [t.detach().contiguous() for t in (q, k, v)]
    # weights in the activation dtype, biases fp32, as the TPU wrapper passes
    # them; every temporary is held by a name until the launch is queued
    ws = [w.detach().to(dt).contiguous() if i % 2 == 0 else w.detach().float().contiguous()
          for i, w in enumerate(weights)]
    out = torch.empty(b, n, d, dtype=dt, device=dev)
    lib = load("agsa_attn")
    fn = lib.itrx_agsa_fwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(*(ptr(t) for t in ins), *(ptr(w) for w in ws), ptr(out), b, n, heads,
              d // heads, int(dt == torch.bfloat16), dev.index, current_stream(dev))
    check(lib, "agsa_attn kernel", code)
    agsa_attention_fused.launches += 1
    return out


# kernel launches since the last reset
agsa_attention_fused.launches = 0
