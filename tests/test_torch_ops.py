"""Port ops vs the JAX package on the CPU: the masked GRU and the SCAN t2i
score grid, against both the XLA path and the interpret-mode Pallas
kernels.  Tolerances are those of tests/test_pallas_{gru,xattn}.py (fp32
throughout; the two frameworks sum in different orders)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itrx.ops import attention as jattn
from itrx.ops import rnn as jrnn
from itrx.ops.pallas.gru import gru_scan_fused as jgru_fused
from itrx.ops.pallas.xattn import xattn_t2i_fused as jxattn_fused
from itrx_torch.ops import attention, norms, rnn
from itrx_torch.ops.kernels.gru import gru_scan_fused
from itrx_torch.ops.kernels.xattn import xattn_t2i_fused

torch.set_num_threads(1)

ATOL = 2e-5
# bf16 recurrent product: both sides round the same fp32 carry to bf16, so
# they differ by ~1e-7 except where a carry lies within a summation error of
# a bf16 rounding boundary (one such flip measured 1.4e-5 at H=128); the
# bf16 product itself moves the outputs by ~3e-4 from the fp32 recurrence
BF16_DOT_ATOL = 5e-5


def _gru_inputs(rng, b, l, d=32, h=128, full_and_one=True):
    k = 1.0 / np.sqrt(h)
    w = [rng.uniform(-k, k, s).astype(np.float32)
         for s in ((3 * h, d), (3 * h, h), (3 * h,), (3 * h,))]
    x = rng.standard_normal((b, l, d)).astype(np.float32)
    lengths = rng.integers(1, l + 1, b)
    if full_and_one:
        lengths[0], lengths[-1] = 1, l
    mask = (np.arange(l)[None] < lengths[:, None]).astype(np.float32)
    return x, mask, w


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,l", [(16, 12), (13, 9), (5, 1)])
def test_gru_scan_matches_jax(rng, reverse, b, l):
    x, mask, w = _gru_inputs(rng, b, l)
    got_o, got_h = gru_scan_fused(_t(x), _t(mask), *map(_t, w), reverse=reverse)
    jx, jm, jw = jnp.asarray(x), jnp.asarray(mask), [jnp.asarray(a) for a in w]
    want_o, want_h = jrnn.gru_scan(jx, jm, *jw, reverse=reverse)
    pal_o, pal_h = jgru_fused(jx, jm, *jw, reverse=reverse, interpret=True,
                              dot_dtype="float32")
    for ref_o, ref_h in ((want_o, want_h), (pal_o, pal_h)):
        np.testing.assert_allclose(got_o.numpy(), np.asarray(ref_o), atol=ATOL, rtol=1e-5)
        np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), atol=ATOL, rtol=1e-5)
    # zero outputs at pads
    assert np.all(got_o.numpy()[mask == 0] == 0)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_bf16_dot_matches_pallas_kernel(rng, reverse):
    """dot_dtype=bf16 is the Pallas kernel's production arithmetic: h and
    W_hh rounded to bf16, the product accumulated in fp32."""
    x, mask, w = _gru_inputs(rng, 13, 9)
    got_o, got_h = rnn.gru_scan(_t(x), _t(mask), *map(_t, w), reverse=reverse,
                                dot_dtype=torch.bfloat16)
    jx, jm, jw = jnp.asarray(x), jnp.asarray(mask), [jnp.asarray(a) for a in w]
    want_o, want_h = jgru_fused(jx, jm, *jw, reverse=reverse, interpret=True,
                                dot_dtype="bfloat16")
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=BF16_DOT_ATOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=BF16_DOT_ATOL)
    # and it is not the fp32 recurrence
    fp32_o, _ = rnn.gru_scan(_t(x), _t(mask), *map(_t, w), reverse=reverse)
    assert float((fp32_o - got_o).abs().max()) > 2 * BF16_DOT_ATOL


@pytest.mark.parametrize("bidirectional", [False, True])
def test_masked_gru_module(rng, bidirectional):
    x, mask, _ = _gru_inputs(rng, 6, 7)
    gru = rnn.MaskedGRU(32, 128, bidirectional=bidirectional,
                        generator=torch.Generator().manual_seed(0))
    out, final = gru(_t(x), _t(mask))
    h = 128
    names = ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")
    for half, suf in enumerate(("", "_reverse") if bidirectional else ("",)):
        ws = [jnp.asarray(getattr(gru, n + suf).detach().numpy()) for n in names]
        want_o, want_h = jrnn.gru_scan(jnp.asarray(x), jnp.asarray(mask), *ws,
                                       reverse=bool(half))
        sl = slice(half * h, (half + 1) * h)
        np.testing.assert_allclose(out[..., sl].detach().numpy(), np.asarray(want_o), atol=ATOL)
        np.testing.assert_allclose(final[:, sl].detach().numpy(), np.asarray(want_h), atol=ATOL)


def test_l2norm_matches_jax(rng):
    from itrx.ops.norms import l2norm as jl2norm

    x = rng.standard_normal((4, 5, 16)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero vector stays finite
    for dim in (-1, 1):
        got = norms.l2norm(_t(x), dim=dim).numpy()
        np.testing.assert_allclose(got, np.asarray(jl2norm(jnp.asarray(x), axis=dim)),
                                   atol=1e-6)
        assert np.all(np.isfinite(got))


def _xattn_inputs(rng, ni, nc, r=36, l=20, d=48, single_word=True):
    img = rng.standard_normal((ni, r, d)).astype(np.float32)
    lengths = rng.integers(2, l + 1, nc)
    if single_word:
        lengths[0] = 1
    mask = (np.arange(l)[None] < lengths[:, None]).astype(np.float32)
    cap = (rng.standard_normal((nc, l, d)) * mask[:, :, None]).astype(np.float32)
    return img, cap, mask


NORMS = ("softmax", "l2norm", "clipped_l2norm", "l1norm", "clipped_l1norm",
         "clipped", "no_norm")
AGGS = ("LogSumExp", "Max", "Sum", "Mean")


@pytest.mark.parametrize("norm,agg", list(itertools.product(NORMS, AGGS)))
def test_xattn_score_t2i_matches_jax(rng, norm, agg):
    img, cap, mask = _xattn_inputs(rng, ni=5, nc=7, l=9, d=16)
    if agg == "LogSumExp" and norm in ("clipped", "no_norm", "l1norm", "clipped_l1norm"):
        # keep exp(lambda_lse * row_sim) well inside fp32 for unnormalized chains
        img, cap = img * 0.3, cap * 0.3
    kw = dict(raw_feature_norm=norm, agg_func=agg)
    got = attention.xattn_score_t2i(_t(img), _t(cap), _t(mask), **kw).numpy()
    want = np.asarray(jattn.xattn_score_t2i(
        jnp.asarray(img), jnp.asarray(cap), jnp.asarray(mask), **kw))
    assert got.shape == (5, 7)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("agg", ["LogSumExp", "Mean"])
@pytest.mark.parametrize("ni,nc", [(8, 12), (7, 11)])
def test_xattn_plain_matches_pallas_kernel(rng, agg, ni, nc):
    img, cap, mask = _xattn_inputs(rng, ni, nc)
    got = xattn_t2i_fused(_t(img), _t(cap), _t(mask), agg_func=agg).numpy()
    want = np.asarray(jxattn_fused(jnp.asarray(img), jnp.asarray(cap),
                                   jnp.asarray(mask), agg_func=agg, interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)
    assert np.all(np.isfinite(got))
