"""The split products of the SGRAF alignment forward, on the CPU.

The forward kernel (csrc/sgraf_align.cu) forms each valid word's node from
the region softmax s and the inverse context norm ci = 1 / (sqrt(s G s^T) +
1e-8) (G the region Gram) with two products on the tensor cores, both
split-bf16 (x = hi + lo, both bf16 rounded to nearest even; fp32
accumulation):

    ctx = s . img          mma.sync: s_hi img_lo + s_lo img_hi + s_hi img_hi
                           (two passes for bf16 images, which are exact)
    y   = (ctx ci - cap)^2 . W^T + b
                           wgmma: the operand split as it is formed, W split
                           once a call by `split_weight`, three passes
    node = y / (sqrt(max(|y|^2, 1e-16)) + 1e-8), zero at masked words

Here a plain emulation of exactly those products (the rounding written on
the uint32 view; the weight's parts read back out of `split_weight`'s
layout) is held to `sgraf_align_plain` within the limits the kernel is held
to on the card (`chip_smoke.py`'s ALIGN_FP32_ATOL and ALIGN_BF16_ATOL), at
the real widths: D 1024, S 256, 36 regions, ragged captions with a one-word
caption.  One bf16 pass of the same products is reported beside it and
misses the fp32 limit, so the limit separates the designs.
"""

from __future__ import annotations

import pytest
import torch

from itrx_torch.ops.kernels.sgraf_align import LAMBDA_SOFTMAX, sgraf_align_plain
from itrx_torch.ops.kernels.sgraf_eval import split_weight
from itrx_torch.ops.norms import l2norm
from tests.test_torch_sgraf_align_split import _inputs, _split, one_pass_mm, split_mm

ALIGN_FP32_ATOL = 1e-5  # chip_smoke.py: the forward's nodes, fp32
ALIGN_BF16_ATOL = 2e-3  # chip_smoke.py: bf16 nodes, one bf16 step of ~0.3
EPS = 1e-8
SHAPES = ((4, 3, 9), (3, 2, 24))  # (Nc, Ni, L); caption 0 has one word


def weight_parts(w: torch.Tensor):
    """W's (hi, lo) read back out of `split_weight`'s slab layout
    (slab, k16 step, part, n // 8, k // 8 within the step, n % 8, k % 8),
    cut to (S, D): the weight exactly as the kernel's wgmma reads it."""
    s, d = w.shape
    sw = split_weight(w)
    slabs, n8 = sw.shape[0], sw.shape[3] * 8
    parts = []
    for p in range(2):
        part = sw[:, :, p]  # (slab, st, nb, kg, r, e)
        part = part.permute(2, 4, 0, 1, 3, 5).reshape(n8, slabs * 32)
        parts.append(part[:s, :d].float())
    return parts


def split_fwd(cap, mask, img, w, b, mm=split_mm, w_parts=None):
    """The forward as the kernel computes it: A and the region softmax in
    fp32, the context norm from the Gram, the context and the projection
    through `mm` (the projection's weight as `split_weight` splits it when
    mm is split_mm), the row norm, zero rows at masked words; in cap's
    dtype."""
    c, m, im = cap.float(), mask.float(), img.float()
    mm4 = m[:, None, :, None]
    a = torch.einsum("cld,ird->cilr", c, im)
    h = torch.nn.functional.leaky_relu(a, 0.1) * mm4
    s = torch.softmax(l2norm(h, dim=2) * LAMBDA_SOFTMAX, dim=3)
    gram = im @ im.transpose(1, 2)
    ctx_sq = torch.einsum("cilr,irq,cilq->cil", s, gram, s)
    ci = 1.0 / (torch.sqrt(ctx_sq.clamp_min(1e-16)) + EPS)
    e = mm(s, im[None]) * ci[..., None] - c[:, None]
    if w_parts is None:
        y = mm(e * e, w.float().t())
    else:
        wh, wl = w_parts
        eh, el = _split(e * e)
        y = (eh @ wl.t() + el @ wh.t()) + eh @ wh.t()
    y = y + b.float()
    yinv = 1.0 / (torch.sqrt((y * y).sum(-1, keepdim=True).clamp_min(1e-16)) + EPS)
    return (y * yinv * mm4).to(cap.dtype)


def _err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def test_weight_parts_are_the_split():
    """The weight's parts as the kernel reads them out of `split_weight` are
    the split the emulation rounds on the uint32 view (hi, then x - hi)."""
    x, _ = _inputs(2, 2, 2, 3, False)
    hi, lo = weight_parts(x["w"])
    want_hi, want_lo = _split(x["w"])
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bf16", [False, True])
def test_split_forward_within_the_kernel_limits(bf16, shape):
    nc, ni, l = shape
    x, _ = _inputs(10 + l, nc, ni, l, bf16)
    want = sgraf_align_plain(**x)
    got = split_fwd(**x, w_parts=weight_parts(x["w"]))
    one = split_fwd(**x, mm=one_pass_mm)
    assert got.shape == want.shape == (nc, ni, l, 256) and got.dtype == want.dtype
    masked = x["mask"] <= 0
    assert masked.any() and (x["mask"].sum(1) == 1).any()
    # zero rows at masked words, in the emulation and in the plain forward
    assert torch.all(got.permute(0, 2, 1, 3)[masked] == 0)
    assert torch.all(want.permute(0, 2, 1, 3)[masked] == 0)
    lim = ALIGN_BF16_ATOL if bf16 else ALIGN_FP32_ATOL
    err, err_one = _err(got, want), _err(one, want)
    print(f"{'bf16' if bf16 else 'fp32'} {shape}: split {err:.2e}, one bf16 pass "
          f"{err_one:.2e} (limit {lim:g})")
    # bf16 nodes are rounded on both sides: one bf16 step at most; fp32
    # nodes land well inside the limit (the split keeps ~16 bits of each
    # operand: ~1e-6 of nodes up to ~0.3)
    assert err <= (lim if bf16 else lim / 4), err
    if not bf16:
        # the limit separates: one bf16 pass of the same products misses it
        assert err_one > lim, err_one
