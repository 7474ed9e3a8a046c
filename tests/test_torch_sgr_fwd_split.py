"""The split products of the SGR reasoning forward, on the CPU.

The forward kernels (csrc/sgr.cu) run each step's two S x S products on the
tensor cores as split-bf16 products: three bf16 passes, a_hi b_lo + a_lo
b_hi + a_hi b_hi with x = hi + lo both bf16 rounded to nearest even (step
0's bf16 nodes are exact in one part, so their product takes two passes),
fp32 accumulation, on weights split once a call by `fwd_weights`.  For step
i with input X, over the list of valid rows:

    q   = X M + v                  (M^T split by `split_weight`; v added after)
    e   = q X^T over the pair's valid keys, a = softmax(e), ctx = a X   (fp32)
    Y   = relu(ctx Wg^T + bg)      (Wg split as torch stores it), 0 at masked rows

Here a plain emulation of exactly those products (the rounding written on
the uint32 view, the weights' parts read back out of `split_weight`'s slab
layout) in exactly that chain, through three steps, is held to
`sgr_reason_plain` within the limits the kernels are held to on the card
(`chip_smoke.py`'s SGR_FWD_REL for every fp32 save and the fp32 final
nodes, SGR_BF16_REL for bf16 final nodes), at the training path's width: S
256, sgr_step 3, ragged 1-24 words with a one-word caption.  One bf16 pass
of the same products is printed beside it and misses the limit.
"""

from __future__ import annotations

import pytest
import torch

from itrx_torch.ops.kernels import sgr as ks
from itrx_torch.ops.kernels.sgraf_eval import fold_sgr_qk, split_weight
from tests.test_torch_sgr_split import STEPS, _inputs, _split, one_pass_mm
from tests.test_torch_sgraf_align_fwd_split import weight_parts

SGR_FWD_REL = 1e-5  # chip_smoke.py: max |kernel - plain| / max |plain|
SGR_BF16_REL = 2.0 ** -8  # chip_smoke.py: bf16 final nodes


def split_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w^T as the kernels form it from `split_weight(w)` ((out, in)
    layout): the weight's hi and lo read back out of the slab layout, x
    split as its operand is formed, three products accumulated in fp32 (the
    lo terms first); a bf16-exact x has lo = 0 (two passes)."""
    wh, wl = weight_parts(w)
    xh, xl = _split(x)
    return (xh @ wl.t() + xl @ wh.t()) + xh @ wh.t()


def one_pass_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w^T as one bf16 pass would form it."""
    return one_pass_mm(x, w.t())


def split_fwd(s0, mask, wq, bq, wk, bk, wg, bg, linear=split_linear):
    """The forward as the kernels compute it: each step's two S x S products
    through `linear` over the listed valid rows, the edges in fp32, zero
    rows at masked nodes.  Returns (the final nodes in s0's dtype, the fp32
    saves (steps, B, N, S)), as `sgr_reason_plain` does."""
    valid = mask > 0
    keys = valid[:, None, :]
    mm, vv = fold_sgr_qk(wq, bq, wk)
    x = s0.float()
    outs = []
    for i in range(mm.shape[0]):
        q = torch.zeros_like(x)
        q[valid] = linear(x[valid], mm[i].t()) + vv[i]
        e = (q @ x.transpose(1, 2)).masked_fill(~keys, ks.NEG_INF)
        ctx = torch.softmax(e, dim=-1) @ x
        y = torch.zeros_like(x)
        y[valid] = torch.relu(linear(ctx[valid], wg[i]) + bg[i])
        outs.append(y)
        x = y
    return x.to(s0.dtype), torch.stack(outs)


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("bf16", [False, True])
def test_split_forward_within_the_kernel_limits(bf16):
    x, _ = _inputs(3, 300, bf16)
    want, want_outs = ks.sgr_reason_plain(**x)
    got, outs = split_fwd(**x)
    _, one_outs = split_fwd(**x, linear=one_pass_linear)
    assert got.dtype == want.dtype and outs.shape == want_outs.shape == (STEPS, 300, 25, 256)
    masked = ~(x["mask"] > 0)
    assert bool((outs[:, masked] == 0).all())
    lim = SGR_BF16_REL if bf16 else SGR_FWD_REL
    err, err_saves, err_one = _rel(got, want), _rel(outs, want_outs), _rel(one_outs, want_outs)
    print(f"{'bf16' if bf16 else 'fp32'} nodes: final {err:.2e} (limit {lim:g}), saves split "
          f"{err_saves:.2e}, one bf16 pass {err_one:.2e} (limit {SGR_FWD_REL:g})")
    assert torch.isfinite(outs).all() and err <= lim and err_saves <= SGR_FWD_REL
    # the limit separates: one bf16 pass of the same products misses it
    assert err_one > SGR_FWD_REL


@pytest.mark.parametrize("s", [256, 36])
def test_fwd_weights_split_the_products_weights(s):
    """M^T split for q = X M + v, exactly the backward's split of it, and
    Wg split as torch stores it ((out, in)) for ctx Wg^T: its hi and lo, read
    back out of the slab layout, are Wg's split and reconstruct Wg to
    within bf16's rounding of the remainder."""
    gen = torch.Generator().manual_seed(s)
    wq, wk, wg = (torch.rand(2, s, s, generator=gen) * 0.2 - 0.1 for _ in range(3))
    mm, _ = fold_sgr_qk(wq, wq[:, 0], wk)
    mts, gws = ks.fwd_weights(mm, wg)
    assert torch.equal(mts, ks.bwd_weights(mm, wg)[0])
    assert torch.equal(gws, split_weight(wg))
    for i in range(2):
        hi, lo = weight_parts(wg[i])
        want_hi, want_lo = _split(wg[i])
        assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
        assert float((hi + lo - wg[i]).abs().max()) <= 2.0 ** -16 * float(wg[i].abs().max())
