"""The port's SGRAF alignment chain (the plain pair of the training
kernels csrc/sgraf_align.cu and csrc/sgraf_align_bwd.cu) vs the JAX
package's interpret-mode Pallas kernel `itrx.ops.pallas.sgraf_align` and its
custom VJP, on the CPU at small widths (D 128, S 128, 36 regions): the
forward on valid words, the backward against jax.vjp and against autograd
through the plain forward, a float64 gradcheck of the autograd Function,
and the wrapper's CPU route.  Inputs come from numpy with a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itrx.ops.pallas.sgraf_align import sgraf_align
from itrx_torch.ops.kernels import sgraf_align as ka

torch.set_num_threads(1)

D, S, R = 128, 128, 36
# forward vs the interpret-mode kernel (fp32 operands at HIGHEST there), as
# tests/test_sgraf_align.py holds the kernel to its chain
FWD_ATOL = 3e-5
# backward vs jax.vjp: tests/test_sgraf_align.py:88's limit; `itrx`'s VJP
# drops the l2norms' O(eps / |y|) term, the port keeps it
VJP_ATOL = 2e-3
# backward vs autograd through the plain forward: the same function summed
# in another order, fp32
AUTOGRAD_REL = 1e-5


def _inputs(rng, nc, ni, l, single_word=True):
    lengths = rng.integers(min(2, l), l + 1, nc)
    if single_word:
        lengths[0] = 1
    lengths[-1] = l
    mask = (np.arange(l)[None] < lengths[:, None]).astype(np.float32)
    cap = rng.standard_normal((nc, l, D)).astype(np.float32)
    cap = cap / np.linalg.norm(cap, axis=-1, keepdims=True) * mask[..., None]
    img = rng.standard_normal((ni, R, D)).astype(np.float32)
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    r = np.sqrt(6.0 / (D + S))
    w = rng.uniform(-r, r, (S, D)).astype(np.float32)  # torch's (out, in)
    b = (rng.standard_normal(S) * 0.05).astype(np.float32)
    return cap, mask, img, w, b


def _jax_padded(cap, mask):
    """Captions padded to L % 8 == 0, as `itrx`'s kernel takes them."""
    l = cap.shape[1]
    lp = -(-l // 8) * 8
    return (np.pad(cap, ((0, 0), (0, lp - l), (0, 0))), np.pad(mask, ((0, 0), (0, lp - l))))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


SHAPES = [
    (5, 3, 8, 4),    # Nc not a multiple of the caption block, a one-word caption
    (7, 2, 11, 3),   # ragged L (padded to 16 on the JAX side only), a one-word caption
    (4, 5, 1, 8),    # one-word captions only
]
# The gradients take the first two.  With one word, the word-group l2norm
# is a sign, h / (|h| + eps), whose derivative eps / (|h| + eps)^2 is the
# O(eps) term alone: `itrx`'s VJP doubles it (measured: 0.16 apart at a
# |h| of 1e-4), and in fp32 it cancels two terms of size g / |h| (5e-5 of
# gcap's scale against float64).
GRAD_SHAPES = SHAPES[:2]


@pytest.mark.parametrize("nc,ni,l,block_c", SHAPES)
def test_sgraf_align_plain_matches_pallas_kernel(rng, nc, ni, l, block_c):
    """sgraf_align_plain vs `itrx`'s kernel in interpret mode on the valid
    words (the port writes zero nodes at masked words; `itrx` computed
    ones, which nothing downstream reads)."""
    cap, mask, img, w, b = _inputs(rng, nc, ni, l, single_word=l > 1)
    capp, maskp = _jax_padded(cap, mask)
    want = np.asarray(sgraf_align(jnp.asarray(capp), jnp.asarray(maskp), jnp.asarray(img),
                                  jnp.asarray(w.T), jnp.asarray(b), block_c, True))[:, :, :l]
    got = ka.sgraf_align_plain(*_t(cap, mask, img, w, b))
    assert got.shape == (nc, ni, l, S) and got.dtype == torch.float32
    valid = mask[:, None, :, None] > 0
    np.testing.assert_allclose(np.where(valid, got.numpy(), 0.0), np.where(valid, want, 0.0),
                               atol=FWD_ATOL)
    assert np.all(got.numpy()[~np.broadcast_to(valid, got.shape)] == 0.0)


@pytest.mark.parametrize("nc,ni,l,block_c", GRAD_SHAPES)
def test_sgraf_align_bwd_plain_matches_jax_vjp(rng, nc, ni, l, block_c):
    """sgraf_align_bwd_plain vs jax.vjp of `itrx`'s kernel (interpret
    mode) for a cotangent that is zero at masked words (SAF's)."""
    cap, mask, img, w, b = _inputs(rng, nc, ni, l, single_word=l > 1)
    g = rng.standard_normal((nc, ni, l, S)).astype(np.float32) * mask[:, None, :, None]
    capp, maskp = _jax_padded(cap, mask)
    gp = np.pad(g, ((0, 0), (0, 0), (0, capp.shape[1] - l), (0, 0)))
    _, vjp = jax.vjp(lambda c, i, w_, b_: sgraf_align(c, jnp.asarray(maskp), i, w_, b_,
                                                      block_c, True),
                     jnp.asarray(capp), jnp.asarray(img), jnp.asarray(w.T), jnp.asarray(b))
    jcap, jimg, jw, jb = (np.asarray(t) for t in vjp(jnp.asarray(gp)))
    gcap, gimg, gw, gb = ka.sgraf_align_bwd_plain(*_t(cap, mask, img, w, b, g))
    assert gcap.dtype == torch.float32 and gw.shape == (S, D) and gb.shape == (S,)
    np.testing.assert_allclose(gcap.numpy(), jcap[:, :l], atol=VJP_ATOL)
    np.testing.assert_allclose(gimg.numpy(), jimg, atol=VJP_ATOL)
    np.testing.assert_allclose(gw.numpy(), jw.T, atol=VJP_ATOL)
    np.testing.assert_allclose(gb.numpy(), jb, atol=VJP_ATOL)


@pytest.mark.parametrize("nc,ni,l,block_c", GRAD_SHAPES)
def test_sgraf_align_bwd_plain_is_the_derivative_of_the_plain_forward(rng, nc, ni, l,
                                                                       block_c):
    """The explicit backward vs autograd through sgraf_align_plain, every
    gradient within 1e-5 of its largest entry, for a cotangent that is
    nonzero at masked words too (which the forward's mask drops)."""
    cap, mask, img, w, b = _inputs(rng, nc, ni, l, single_word=l > 1)
    g = rng.standard_normal((nc, ni, l, S)).astype(np.float32)
    ps = [t.requires_grad_() for t in _t(cap, img, w, b)]
    out = ka.sgraf_align_plain(ps[0], torch.from_numpy(mask), *ps[1:])
    want = torch.autograd.grad((out * torch.from_numpy(g)).sum(), ps)
    got = ka.sgraf_align_bwd_plain(*_t(cap, mask, img, w, b, g))
    for name, a, e in zip(("gcap", "gimg", "gw", "gb"), got, want):
        err = float((a - e).abs().max() / e.abs().max())
        assert err <= AUTOGRAD_REL, (name, err)


def test_sgraf_align_function_gradcheck_float64(rng):
    """gradcheck of the autograd Function on the CPU in float64 (its
    forward the plain forward, its backward the explicit plain backward),
    a masked word included."""
    nc, ni, l, d, s, r = 2, 2, 3, 6, 4, 5
    mask = torch.tensor([[1.0, 1.0, 0.0], [1.0, 1.0, 1.0]], dtype=torch.float64)
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh)).requires_grad_()  # noqa: E731
    cap, img, w, b = f(nc, l, d), f(ni, r, d), f(s, d), f(s)
    assert torch.autograd.gradcheck(
        lambda c, i, w_, b_: ka._SGRAFAlign.apply(c, mask, i, w_, b_), (cap, img, w, b),
        eps=1e-6, atol=1e-6, rtol=1e-5)


def test_sgraf_align_fused_takes_the_plain_pair_on_the_cpu(rng):
    """On CPU tensors the wrapper is the plain forward (no grad) or the
    autograd Function, whose gradients are the plain backward's (within
    1e-5 of scale in fp32, a bf16 rounding in bf16); nothing is counted.  bf16 embeddings give bf16 nodes and bf16 gcap / gimg, fp32
    gw / gb."""
    cap, mask, img, w, b = _t(*_inputs(rng, 3, 2, 5))
    before = (ka.sgraf_align_fused.launches, ka.sgraf_align_bwd_fused.launches)
    with torch.no_grad():
        torch.testing.assert_close(ka.sgraf_align_fused(cap, mask, img, w, b),
                                   ka.sgraf_align_plain(cap, mask, img, w, b), rtol=0, atol=0)
    g = torch.from_numpy(rng.standard_normal((3, 2, 5, S)).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        ps = [cap.to(dt).requires_grad_(), img.to(dt).requires_grad_(),
              w.clone().requires_grad_(), b.clone().requires_grad_()]
        out = ka.sgraf_align_fused(ps[0], mask, ps[1], ps[2], ps[3])
        assert out.dtype == dt and out.grad_fn is not None
        got = torch.autograd.grad((out.float() * g).sum(), ps)
        # the Function's cotangent is the nodes' own dtype
        want = ka.sgraf_align_bwd_plain(ps[0].detach(), mask, ps[1].detach(), w, b, g.to(dt))
        assert [t.dtype for t in got] == [dt, dt, torch.float32, torch.float32]
        # the same function; the one-word caption's cancellation amplifies
        # a change of summation order (fp32), and bf16 gradients round
        lim = AUTOGRAD_REL if dt == torch.float32 else 2.0 ** -8
        for a, e in zip(got, want):
            assert float((a.float() - e.float()).abs().max() / e.float().abs().max()) <= lim
    assert (ka.sgraf_align_fused.launches, ka.sgraf_align_bwd_fused.launches) == before


def test_row_layout_ranks_valid_words(rng):
    """The backward's compact rows: each valid word's rank in its caption
    and each caption's first word, then the number of valid words (no
    count is returned to the host), for a mask with a hole."""
    mask = torch.tensor([[1.0, 1.0, 0.0, 0.0], [1.0, 0.0, 1.0, 1.0], [1.0, 1.0, 1.0, 1.0]])
    pos, cstart = ka.row_layout(mask)
    assert cstart.dtype == pos.dtype == torch.int32
    assert cstart.tolist() == [0, 2, 5, 9]
    assert pos.tolist() == [[0, 1, 2, 2], [0, 1, 1, 2], [0, 1, 2, 3]]
