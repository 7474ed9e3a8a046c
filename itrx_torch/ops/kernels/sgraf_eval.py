"""SGRAF-SAF evaluation scores on the card: the wrapper of
csrc/sgraf_eval_saf.cu.

Replaces the TPU kernel itrx/ops/pallas/sgraf_eval.py::_eval_saf_kernel
(wrapper `sgraf_eval_saf_score`): for every (caption, image) pair the whole
SGRAF-SAF eval chain -- SCAN attention at lambda 9, the word nodes
l2norm(sim_tranloc_w((l2norm(context) - word)^2)), the global node
l2norm(sim_tranglo_w((img_glo - cap_glo)^2)), SAF pooling with the eval-mode
BatchNorm folded into its gate (`fold_saf_bn`) and the sim_eval_w + sigmoid
epilogue -- with one fp32 score per pair written to device memory.  What
bounds it on an H100: the word nodes' projection, D x S multiply-adds per
valid word (about 78% of the operations at D 1024, S 256), then the A and
context products (36 x D each per word) and the global node (D x S per
pair).  The kernel reads its inputs as they are (bf16 or fp32) and keeps the
chain in fp32; the TPU kernel rounds the softmax weights, the squared
differences and the nodes to bf16 as MXU operands, the port does not.

Arguments mirror `sgraf_eval_saf_score` in the port's layouts: Linear
weights as torch stores them, (out, in).  The plain version
`sgraf_eval_saf_plain` runs only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..norms import l1norm, l2norm
from . import check, current_stream, load, ptr

SOURCE = "sgraf_eval_saf.cu"
N_REGIONS = 36
MAX_WORDS = 128
MAX_SIM_DIM = 256
BN_EPS = 1e-5
LAMBDA_SOFTMAX = 9.0
# plain version: budget of one caption chunk's (C, Ni, L, D) fp32 context
PLAIN_CHUNK_BYTES = 1 << 30


def fold_saf_bn(attn_w, attn_b, bn_weight, bn_bias, running_mean, running_var):
    """The eval-mode BatchNorm1d(1) after SAF's gate Linear, folded into it
    in fp32 (itrx/models/sgraf.py:361-375): BN(x) = x a' + b' with
    a' = weight / sqrt(var + eps) and b' = bias - mean a'.  attn_w (1, S),
    attn_b (1,) -> (awf (S,), abf (1,))."""
    f = lambda t: t.detach().float()  # noqa: E731
    aprime = f(bn_weight)[0] * torch.rsqrt(f(running_var)[0] + BN_EPS)
    bprime = f(bn_bias)[0] - f(running_mean)[0] * aprime
    return f(attn_w)[0] * aprime, (f(attn_b) * aprime + bprime).reshape(1)


def sgraf_eval_saf_plain(cap, mask, img, w, b, gloc, imgglo, gw, gb, awf, abf, ew, eb):
    """The same function in plain PyTorch: the fp32 chain on the input
    values, over chunks of captions.  Returns (Nc, Ni) fp32."""
    cap, img, gloc, imgglo = (t.float() for t in (cap, img, gloc, imgglo))
    mask = mask.float()
    w, b, gw, gb, awf, abf, ew, eb = (t.detach().float() for t in (w, b, gw, gb, awf, abf, ew, eb))
    nc, l, d = cap.shape
    ni = img.shape[0]
    chunk = max(1, PLAIN_CHUNK_BYTES // (ni * l * d * 4))
    out = []
    for c0 in range(0, nc, chunk):
        cp, m, gc = cap[c0:c0 + chunk], mask[c0:c0 + chunk], gloc[c0:c0 + chunk]
        a = F.leaky_relu(torch.einsum("cld,ird->cilr", cp, img), 0.1) * m[:, None, :, None]
        s = torch.softmax(l2norm(a, dim=2) * LAMBDA_SOFTMAX, dim=3)  # (C, Ni, L, R)
        ctx = l2norm(torch.einsum("cilr,ird->cild", s, img))
        loc = l2norm(F.linear((ctx - cp[:, None]) ** 2, w, b))  # (C, Ni, L, S)
        glo = l2norm(F.linear((imgglo[None] - gc[:, None]) ** 2, gw, gb))  # (C, Ni, S)
        nodes = torch.cat([glo[:, :, None], loc], dim=2)  # (C, Ni, L + 1, S)
        nmask = torch.cat([torch.ones_like(m[:, :1]), m], dim=1)[:, None]  # (C, 1, L + 1)
        gate = l1norm(torch.sigmoid(nodes @ awf + abf) * nmask)
        saf = l2norm(torch.einsum("cin,cins->cis", gate, nodes))
        out.append(torch.sigmoid(F.linear(saf, ew, eb))[..., 0])
        del a, s, ctx, loc  # free this chunk's tensors before the next is formed
    return torch.cat(out, dim=0).reshape(nc, ni)


def _guard(cap, mask, img, w, gloc, imgglo, gw) -> str:
    """"cpu" or "cuda": the kernel is forward-only, so with grad enabled and
    an input that requires grad it raises on every device; any device other
    than the two raises; on a CUDA device every shape, type and alignment the
    kernel does not take raises."""
    name = "sgraf_eval_saf_fused"
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (cap, img, w, gloc, imgglo, gw)
    ):
        raise RuntimeError(
            f"{name}: the kernel is forward-only (it has no backward); SGRAF training "
            "is not ported yet (ROADMAP queue 1 item 8c)")
    if img.device.type == "cpu":
        return "cpu"
    if img.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {img.device}")
    ni, r, d = img.shape
    nc, l, d2 = cap.shape
    s = w.shape[0]
    if r != N_REGIONS:
        raise ValueError(f"{name}: the kernel takes {N_REGIONS} regions, got {r}")
    if d2 != d or tuple(mask.shape) != (nc, l) or tuple(gloc.shape) != (nc, d) \
            or tuple(imgglo.shape) != (ni, d) or tuple(w.shape) != (s, d) \
            or tuple(gw.shape) != (s, d):
        raise ValueError(f"{name}: shapes of the inputs disagree")
    if not 1 <= l <= MAX_WORDS:
        raise ValueError(f"{name}: caption length {l} not in [1, {MAX_WORDS}]")
    if s > MAX_SIM_DIM or s % 4:
        raise ValueError(f"{name}: sim_dim {s} must be a multiple of 4, at most {MAX_SIM_DIM}")
    if img.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != img.dtype for t in (cap, gloc, imgglo)):
        raise TypeError(f"{name}: embeddings must be all fp32 or all bf16")
    if img.dtype == torch.bfloat16 and d % 8:
        raise ValueError(f"{name}: bf16 inputs need D % 8 == 0, got {d}")
    if any(t.device != img.device for t in (cap, mask, w, gloc, imgglo, gw)):
        raise ValueError(f"{name}: all tensors must be on one device")
    return "cuda"


def sgraf_eval_saf_fused(cap, mask, img, w, b, gloc, imgglo, gw, gb, awf, abf, ew, eb):
    """SGRAF-SAF eval scores, (Nc, Ni) fp32.

    cap (Nc, L, D), mask (Nc, L), img (Ni, 36, D); w (S, D) / b (S,) --
    sim_tranloc_w; gloc (Nc, D) / imgglo (Ni, D) -- the global embeddings;
    gw (S, D) / gb (S,) -- sim_tranglo_w; awf (S,) / abf (1,) -- SAF's gate
    with the BatchNorm folded in (`fold_saf_bn`); ew (1, S) / eb (1,) --
    sim_eval_w.  A CPU tensor takes `sgraf_eval_saf_plain`; a CUDA tensor
    launches the kernel (embeddings fp32 or bf16, fp32 arithmetic); any
    other device raises.  Forward-only: with grad enabled and an input that
    requires grad it raises on every device."""
    args = (cap, mask, img, w, b, gloc, imgglo, gw, gb, awf, abf, ew, eb)
    if _guard(cap, mask, img, w, gloc, imgglo, gw) == "cpu":
        return sgraf_eval_saf_plain(*args)
    ni, _, d = img.shape
    nc, l, _ = cap.shape
    s = w.shape[0]
    f32 = lambda t: t.detach().float().contiguous()  # noqa: E731
    img, cap, gloc, imgglo = (t.contiguous() for t in (img, cap, gloc, imgglo))
    if img.data_ptr() % 16 or cap.data_ptr() % 16:
        raise ValueError("sgraf_eval_saf_fused: inputs must be 16-byte aligned")
    im32 = img.float()
    gram = torch.matmul(im32, im32.transpose(1, 2)).contiguous()  # (Ni, 36, 36) fp32
    out = torch.empty(nc, ni, dtype=torch.float32, device=img.device)
    lib = load("sgraf_eval_saf")
    fn = lib.itrx_sgraf_eval_saf
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # every temporary is held by a name until the launch has been queued
    mask32 = f32(mask)
    wt, gwt = f32(w).t().contiguous(), f32(gw).t().contiguous()  # (D, S)
    weights = [wt, f32(b), gwt, f32(gb), f32(awf), f32(abf), f32(ew), f32(eb)]
    code = fn(
        ptr(cap), ptr(mask32), ptr(img), ptr(gram), ptr(gloc), ptr(imgglo),
        *(ptr(t) for t in weights), ptr(out),
        ni, nc, l, d, s, int(img.dtype == torch.bfloat16),
        img.device.index, current_stream(img.device),
    )
    check(lib, "sgraf_eval_saf_kernel", code)
    sgraf_eval_saf_fused.launches += 1
    return out


# kernel launches since the last reset
sgraf_eval_saf_fused.launches = 0
