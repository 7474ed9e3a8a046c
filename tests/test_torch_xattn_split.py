"""The fp32 product of the SCAN score-grid kernels, and their word padding, on
the CPU.

For fp32 inputs the two kernels (csrc/xattn.cu, csrc/xattn_i2t.cu) form
A = img . cap^T on the tensor cores in fp64 (mma.sync m8n8k4 on fp64 copies
of the embeddings, csrc/xattn_wgmma.cuh): the products of fp32 values are
exact and the sums fp64, so A is the exact dot product rounded once to
fp32.  Here that A (float64 einsum, rounded once) replaces A inside the
plain t2i and i2t chains, and the grids are held to the fp32 plain grids
within the fp32 kernels' limit on the card (`chip_smoke.py`'s
XATTN_FP32_ATOL, 1e-6), at the real width D 1024 with ragged captions (one
of a single word), at L 24 and L 128, both aggregations; one TF32 pass
(what a tensor-core product of fp32 operands reads by default) is shown to
miss that limit.  The wrapper pads the word axis to a multiple of 8 with
masked zero words; the plain grids are shown unchanged by that pad.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from itrx_torch.ops import attention
from itrx_torch.ops.kernels import xattn

ATOL = 1e-6  # chip_smoke.py: XATTN_FP32_ATOL
D, R = 1024, 36
KW = {"t2i": dict(lambda_lse=6.0, lambda_softmax=9.0),
      "i2t": dict(lambda_lse=5.0, lambda_softmax=4.0)}  # SCAN's published i-t settings
A_SPEC = {"t2i": "ird,cld->icrl", "i2t": "cld,ird->iclr"}
EINSUM = torch.einsum


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 x with its low 13 mantissa bits cleared (one TF32 operand), on
    the uint32 view."""
    u = np.ascontiguousarray(x.float().numpy()).view(np.uint32)
    return torch.from_numpy((u & np.uint32(0xFFFFE000)).view(np.float32))


def _exact(spec: str):
    """einsum `spec` of two fp32 operands as the kernels form it: exact
    products, fp64 sums, rounded once to fp32."""
    return lambda x, y: EINSUM(spec, x.double(), y.double()).float()


def _one_tf32_pass(spec: str):
    return lambda x, y: EINSUM(spec, _tf32(x).double(), _tf32(y).double()).float()


def _inputs(seed: int, ni: int, nc: int, l: int):
    """chip_smoke.py::_xattn_inputs from a numpy seed: unit regions, tanh
    captions of 2..l words, the first of one word."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((ni, R, D)).astype(np.float32)
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    lengths = rng.integers(2, l + 1, nc)
    lengths[0] = 1
    mask = (np.arange(l)[None] < lengths[:, None]).astype(np.float32)
    cap = (np.tanh(rng.standard_normal((nc, l, D)) * 0.5) * mask[..., None]).astype(np.float32)
    return torch.from_numpy(img), torch.from_numpy(cap), torch.from_numpy(mask)


def _grids(direction: str, img, cap, mask, product=None) -> dict:
    """Both aggregations of the plain fp32 grid; with `product`, A (and only
    A) formed by it."""
    plain = attention.xattn_score_t2i if direction == "t2i" else attention.xattn_score_i2t

    def patched(spec, *ops):
        if product is not None and spec == A_SPEC[direction]:
            return product(*ops)
        return EINSUM(spec, *ops)

    torch.einsum = patched
    try:
        return {agg: plain(img, cap, mask, raw_feature_norm="clipped_l2norm", agg_func=agg,
                           **KW[direction]) for agg in ("LogSumExp", "Mean")}
    finally:
        torch.einsum = EINSUM


@pytest.mark.parametrize("direction", ["t2i", "i2t"])
@pytest.mark.parametrize("ni,nc,l", [(16, 64, 24), (6, 24, 128)])
def test_exact_fp32_product_holds_the_fp32_grid(direction, ni, nc, l):
    """The kernels' fp32 A inside the plain chains: both aggregations within
    1e-6 of the fp32 plain grid, while one TF32 pass misses it."""
    img, cap, mask = _inputs(ni + l, ni, nc, l)
    want = _grids(direction, img, cap, mask)
    got = _grids(direction, img, cap, mask, _exact(A_SPEC[direction]))
    one = _grids(direction, img, cap, mask, _one_tf32_pass(A_SPEC[direction]))
    for agg in want:
        err = float((got[agg] - want[agg]).abs().max())
        err_one = float((one[agg] - want[agg]).abs().max())
        print(f"{direction} {ni}x{nc}x{l} {agg}: exact {err:.2e}, one TF32 pass {err_one:.2e}")
        assert err <= ATOL, (agg, err)
        assert err_one > ATOL, (agg, err_one)


@pytest.mark.parametrize("direction", ["t2i", "i2t"])
@pytest.mark.parametrize("agg", ["LogSumExp", "Mean"])
def test_padding_words_to_a_multiple_of_8_changes_no_score(direction, agg):
    """The wrapper's operands (`t2i_operands` / `i2t_operands`: captions
    zeroed past their words and padded with masked zero words to a multiple
    of 8) give the plain grid of the unpadded inputs, in both directions and
    both aggregations."""
    rng = np.random.default_rng(7)
    img, cap, mask = _inputs(3, 5, 9, 21)
    cap = cap + torch.from_numpy(rng.standard_normal(cap.shape).astype(np.float32)) * (1 - mask)[
        ..., None]  # garbage past each caption's words, which the mask must drop
    plain = attention.xattn_score_t2i if direction == "t2i" else attention.xattn_score_i2t
    operands = xattn.t2i_operands if direction == "t2i" else xattn.i2t_operands
    _, capz, _, mask8, _ = operands(img, cap, mask)
    assert capz.shape == (9, 24, D) and mask8.shape == (9, 24)
    assert not capz[:, 21:].any() and not mask8[:, 21:].any()
    kw = dict(raw_feature_norm="clipped_l2norm", agg_func=agg, **KW[direction])
    want = plain(img, cap * mask[..., None], mask, **kw)
    got = plain(img, capz, mask8, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-7)
