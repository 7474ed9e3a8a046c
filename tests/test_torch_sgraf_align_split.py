"""The split products of the SGRAF alignment backward, on the CPU.

The backward kernels (csrc/sgraf_align_bwd.cu) run every D x S and 36 x D
product on the tensor cores as split-bf16 products: three bf16 passes,
a_hi b_lo + a_lo b_hi + a_hi b_hi with x = hi + lo both bf16 rounded to
nearest even (an operand that is a bf16 embedding is exact in one part, so
its products take two passes), fp32 accumulation.  Their design also
rearranges the chain: the context-norm backward is never formed as a
(rows, D) tensor; the region pass takes ge, the row's inverse context norm
ci and cb = ci (s . GS) / |ctx| with GS = ge . img_r, and forms

    gs_r   = ci (GS_r - cb (G s)_r)                      (G the region Gram)
    dimg_r = sum_rows s_r ci ge + gA^T cap - (sum_rows s_r cb ci s_r') img_r'
    dcap   = gA^T img - ge                                (per row, then over images)

Here a plain emulation of exactly those products (the rounding written on
the uint32 view) in exactly that chain is held to `sgraf_align_bwd_plain`
within the limits the kernels are held to on the card (`chip_smoke.py`'s
ALIGN_BWD_REL and ALIGN_BWD_BF16_REL), at the real widths: D 1024, S 256,
36 regions, ragged captions with a one-word caption.  One bf16 pass of the
same products is reported beside it.  The wrapper's split of the weight in
its second orientation (for ge = 2 e (gy W)) is checked too.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from itrx_torch.ops.kernels.sgraf_align import (LAMBDA_SOFTMAX, WT_CHUNK, _l2norm_bwd,
                                                sgraf_align_bwd_plain, split_weight_t)
from itrx_torch.ops.kernels.sgraf_eval import SPLIT_DEPTH, bf16_split
from itrx_torch.ops.norms import l2norm

ALIGN_BWD_REL = 1e-3  # chip_smoke.py: the fp32 gradients, and gw, gb in both modes
ALIGN_BWD_BF16_REL = 2.0 ** -8  # chip_smoke.py: gcap and gimg in bf16
D, S, R = 1024, 256, 36
EPS = 1e-8


def _bf16(x: np.ndarray) -> np.ndarray:
    """fp32 x rounded to bf16 (8 significant bits), to nearest even, written
    on the uint32 view independently of torch's."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _split(x: torch.Tensor):
    x = x.float().contiguous()
    hi = torch.from_numpy(_bf16(x.numpy()))
    return hi, torch.from_numpy(_bf16((x - hi).numpy()))


def split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels form it: three split products accumulated in
    fp32 (the lo terms first); a bf16-exact operand has lo = 0."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return (ah @ bl + al @ bh) + ah @ bh


def one_pass_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one bf16 pass would form it."""
    return _split(a)[0] @ _split(b)[0]


def _inputs(seed: int, nc: int, ni: int, l: int, bf16: bool):
    """chip_smoke.py's alignment inputs from a numpy seed: unit regions,
    tanh captions with ragged lengths (caption 0 a one-word caption),
    sim_tranloc_w at the reference's init scale with a small bias, and a
    cotangent that is zero at masked words; embeddings rounded to bf16
    values when `bf16` (the kernel's bf16 mode reads those)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))  # noqa: E731
    img = rng.standard_normal((ni, R, D))
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    lengths = rng.integers(2, l + 1, nc)
    lengths[0] = 1
    mask = (np.arange(l)[None] < lengths[:, None]).astype(np.float32)
    cap = np.tanh(rng.standard_normal((nc, l, D)) * 0.5) * mask[..., None]
    r = np.sqrt(6.0 / (D + S))
    x = {"cap": t(cap), "mask": t(mask), "img": t(img), "w": t(rng.uniform(-r, r, (S, D))),
         "b": t(rng.uniform(-0.05, 0.05, S))}
    if bf16:
        x["cap"], x["img"] = x["cap"].bfloat16(), x["img"].bfloat16()
    g = t(rng.standard_normal((nc, ni, l, S))) * x["mask"][:, None, :, None]
    return x, g.to(x["cap"].dtype)


def split_bwd(cap, mask, img, w, b, g, mm=split_mm):
    """The backward as the kernels compute it, every product through `mm`:
    the rows pass (context, projection, gy), the weight sums, ge, and the
    region pass with its Gram form of the context-norm backward.  Returns
    (gcap, gimg, gw, gb) in the plain pair's dtypes."""
    wd = torch.float64 if cap.dtype == torch.float64 else torch.float32
    c, m, im, wf, g = (t.to(wd) for t in (cap, mask, img, w, g))
    mm4 = m[:, None, :, None]
    # rows pass: A and the softmax as the forward has them, the context on
    # the tensor cores, its norm from the Gram
    a = torch.einsum("cld,ird->cilr", c, im)
    h = F.leaky_relu(a, 0.1) * mm4
    s = torch.softmax(l2norm(h, dim=2) * LAMBDA_SOFTMAX, dim=3)
    gram = im @ im.transpose(1, 2)
    gs_vec = torch.einsum("irq,cilq->cilr", gram, s)  # (G s)_r
    ci = 1.0 / (torch.sqrt((s * gs_vec).sum(-1).clamp_min(1e-16)) + EPS)
    e = mm(s, im[None]) * ci[..., None] - c[:, None]
    y = mm(e * e, wf.t()) + b
    gy = _l2norm_bwd(y, g * mm4, -1) * mm4
    # weight sums over the rows, and ge
    valid = (m[:, None, :] > 0).expand(-1, im.shape[0], -1)
    rows_gy, rows_e2 = gy[valid], (e * e)[valid]
    gw = mm(rows_gy.t(), rows_e2)
    gb = rows_gy.sum(0)
    ge = 2.0 * e * mm(gy, wf) * mm4
    # region pass: gs from GS = ge . img_r and the Gram, the softmax and
    # word-norm backward to gA
    big = mm(ge, im.transpose(1, 2)[None])  # (C, Ni, L, R)
    n = 1.0 / ci - EPS
    cb = torch.where(n > 1.0001e-8, ci * (s * big).sum(-1) / n, torch.zeros_like(n)) * (mm4[..., 0])
    gs = ci[..., None] * (big - cb[..., None] * gs_vec)
    gz = s * (gs - (gs * s).sum(-1, keepdim=True))
    gh = _l2norm_bwd(h, gz * LAMBDA_SOFTMAX, 2) * mm4
    ga = torch.where(a > 0, gh, 0.1 * gh)
    dcap = mm(ga, im[None]) - ge  # (C, Ni, L, D): per row
    gcap = dcap.sum(1)
    wgt = s * (ci * mm4[..., 0])[..., None]  # s_r ci on valid rows
    cross = torch.einsum("cilr,cil,cilq->irq", s, cb * ci, s)
    gimg = (mm(wgt.permute(1, 3, 0, 2).reshape(im.shape[0], R, -1),
               ge.permute(1, 0, 2, 3).reshape(im.shape[0], -1, im.shape[-1]))
            + mm(ga.permute(1, 3, 0, 2).reshape(im.shape[0], R, -1),
                 c[None].expand(im.shape[0], -1, -1, -1).reshape(im.shape[0], -1, im.shape[-1]))
            - mm(cross, im))
    return gcap.to(cap.dtype), gimg.to(img.dtype), gw, gb


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


NAMES = ("gcap", "gimg", "gw", "gb")


@pytest.mark.parametrize("bf16", [False, True])
def test_split_backward_within_the_kernel_limits(bf16):
    x, g = _inputs(0, 4, 3, 9, bf16)
    want = sgraf_align_bwd_plain(**x, g=g)
    got = split_bwd(**x, g=g)
    one = split_bwd(**x, g=g, mm=one_pass_mm)
    for name, a, w_, o in zip(NAMES, got, want, one):
        assert a.shape == w_.shape and a.dtype == w_.dtype, name
        lim = ALIGN_BWD_BF16_REL if a.dtype == torch.bfloat16 else ALIGN_BWD_REL
        err, err_one = _rel(a, w_), _rel(o, w_)
        print(f"{name} {'bf16' if bf16 else 'fp32'}: split {err:.2e}, one bf16 pass "
              f"{err_one:.2e} (limit {lim:g})")
        # bf16 outputs are rounded on both sides: one bf16 step at most
        assert err <= (lim if a.dtype == torch.bfloat16 else lim / 10), (name, err)
        if not bf16 and name != "gb":
            # the limit separates: one bf16 pass of the same products misses it
            assert err_one > lim, (name, err_one)


def test_the_gram_form_is_the_chain():
    """In float64 the rearranged chain is the plain backward: the region
    pass's Gram form of gs, dimg's three terms and the per-row dcap lose
    nothing."""
    x, g = _inputs(1, 3, 2, 7, False)
    x64 = {k: v.double() for k, v in x.items()}
    exact = lambda a, b: a @ b  # noqa: E731
    want = sgraf_align_bwd_plain(**x64, g=g.double())
    got = split_bwd(**x64, g=g.double(), mm=exact)
    for name, a, w_ in zip(NAMES, got, want):
        assert _rel(a.double(), w_.double()) <= 1e-10, name


@pytest.mark.parametrize("shape", [(S, D), (S, 300), (12, 37)])
def test_split_weight_t_layout(shape):
    """W (S, D) in its second orientation, W^T (D, S), padded to whole
    chunks of WT_CHUNK rows of D and split chunk by chunk in the layout of
    `split_weight`: per chunk, slab of 32 k (of S), k16 step and part, core
    matrices [d // 8][k // 8][d % 8][k % 8]; padding zero."""
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(shape).astype(np.float32))
    s, d = shape
    out = split_weight_t(w)
    chunks, k32 = -(-d // WT_CHUNK), -(-s // SPLIT_DEPTH) * SPLIT_DEPTH
    assert out.shape == (chunks, k32 // 32, 2, 2, WT_CHUNK // 8, 2, 8, 8)
    assert out.dtype == torch.bfloat16
    for p, part in enumerate(bf16_split(w.t())):
        full = F.pad(part.float(), (0, k32 - s, 0, chunks * WT_CHUNK - d))
        for j, slab, st, nb, kg in ((0, 0, 0, 0, 0), (chunks - 1, k32 // 32 - 1, 1, 31, 1),
                                    (0, 0, 1, 5, 0)):
            k0 = 32 * slab + 16 * st + 8 * kg
            rows = WT_CHUNK * j + 8 * nb
            assert torch.equal(out[j, slab, st, p, nb, kg].float(),
                               full[rows:rows + 8, k0:k0 + 8])
    # each chunk is contiguous: a chunk's slab is one copy
    assert out.is_contiguous()
