"""The port's VSRN caption-decoder loop (the plain pair of the kernels
csrc/vsrn_dec.cu and csrc/vsrn_dec_bwd.cu) vs the JAX package's
interpret-mode Pallas kernel `itrx.ops.pallas.vsrn_dec.decoder_seq` (fp32
dots) and its XLA scan, on the CPU at small widths (T <= 8, a handful of
regions, H 16 and 24, with and without a context-dropout mask): the forward,
the explicit backward against jax.vjp and against autograd through the plain
forward, the autograd Function's gradients, a float64 gradcheck, and the
wrapper's routes.  Inputs come from numpy with a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itrx.ops.pallas.vsrn_dec import decoder_seq
from itrx_torch.ops.kernels import vsrn_dec as kv
from tests.test_pallas_vsrn_dec import _scan_ref

torch.set_num_threads(1)

# forward vs the interpret-mode kernel and the XLA scan, as
# tests/test_pallas_vsrn_dec.py holds the kernel to the scan
FWD_ATOL, FWD_RTOL = 2e-5, 1e-4
# gradients vs jax.vjp, as that file holds the kernel's to the scan's
VJP_ATOL, VJP_RTOL = 3e-4, 2e-3
# the explicit backward vs autograd through the plain forward (the same
# function in fp32, another summation order): max abs error over the
# tensor's largest entry
AUTOGRAD_REL = 1e-5
NAMES = ("gxw", "cmask", "enc_out", "enc_att", "h0", "watt", "w2", "wctx", "whh", "bhh")
# (T, B, R, H, dropout keep): no dropout, then a context-dropout mask
SHAPES = [(7, 6, 5, 16, 1.0), (5, 3, 4, 24, 0.75)]


def _data(rng, t, b, r, h, keep):
    """`itrx`'s arguments (tests/test_pallas_vsrn_dec.py::_data's scales):
    gxw, the pre-scaled mask, enc_out, enc_att, h0, watt (in, out), att_w2
    (H, 1), w_ctx, w_hh (3H, H), b_hh, as numpy."""
    f = lambda *s: (rng.standard_normal(s) * 0.4).astype(np.float32)  # noqa: E731
    cm = np.ones((t, b, h), np.float32)
    if keep < 1.0:
        cm = (rng.random((t, b, h)) < keep).astype(np.float32) / keep
    return (f(t, b, 3 * h), cm, f(b, r, h), f(b, r, h), f(b, h), f(h, h), f(h, 1),
            f(3 * h, h), f(3 * h, h), f(3 * h))


def _port(args, dtype=torch.float32):
    """The port's arguments: watt in (out, in), w2 as linear2.weight (1, H)."""
    gxw, cm, enco, enca, h0, watt, w2, wctx, whh, bhh = args
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
            for a in (gxw, cm, enco, enca, h0, watt.T, w2.T, wctx, whh, bhh)]


def _to_itrx(grads):
    """The port's cotangents in `itrx`'s layouts (watt (in, out), w2 (H, 1))."""
    g = [x.detach().numpy() for x in grads]
    g[5], g[6] = g[5].T, g[6].T
    return g


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_pallas_and_scan(rng, shape):
    args = _data(rng, *shape)
    jargs = [jnp.asarray(a) for a in args]
    got, hall, ghall = kv.vsrn_dec_plain(*_port(args))
    for want in (decoder_seq(*jargs, interpret=True, dot_dtype="float32"), _scan_ref(*jargs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL, rtol=FWD_RTOL)
    # the residuals: h_{t-1} and its recurrent gates
    np.testing.assert_array_equal(hall[0].numpy(), args[4])
    np.testing.assert_array_equal(hall[1:].numpy(), got[:-1].numpy())
    want_gh = hall.numpy() @ args[8].T + args[9]
    np.testing.assert_allclose(ghall.numpy(), want_gh, atol=1e-5)


def _vjp(args, g):
    jargs = [jnp.asarray(a) for a in args]
    _, pull = jax.vjp(lambda *a: decoder_seq(*a, interpret=True, dot_dtype="float32"), *jargs)
    return [np.asarray(x) for x in pull(jnp.asarray(g))]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_vjp(rng, shape):
    """vsrn_dec_bwd_plain, from the plain forward's residuals, vs jax.vjp of
    the interpret-mode kernel: every cotangent (the mask's is zero in both)."""
    args = _data(rng, *shape)
    g = (rng.standard_normal((shape[0], shape[1], shape[3])) * 0.5).astype(np.float32)
    p = _port(args)
    _, hall, ghall = kv.vsrn_dec_plain(*p)
    got = _to_itrx(kv.vsrn_dec_bwd_plain(*p, hall, ghall, torch.from_numpy(g)))
    want = _vjp(args, g)
    for name, a, w in zip(NAMES, got, want):
        np.testing.assert_allclose(a, w, atol=VJP_ATOL, rtol=VJP_RTOL, err_msg=name)
    assert not got[1].any()


@pytest.mark.parametrize("shape", SHAPES)
def test_function_gradients_match_jax_and_autograd(rng, shape):
    """vsrn_dec_fused on CPU tensors under autograd (the Function with the
    plain pair) vs jax.vjp, and the explicit backward vs autograd through
    the differentiable plain forward."""
    args = _data(rng, *shape)
    g = torch.from_numpy((rng.standard_normal((shape[0], shape[1], shape[3])) * 0.5)
                         .astype(np.float32))
    leaves = [a.requires_grad_(i != 1) for i, a in enumerate(_port(args))]
    hs = kv.vsrn_dec_fused(*leaves)
    diff = [a for i, a in enumerate(leaves) if i != 1]
    got = list(torch.autograd.grad(hs, diff, g))
    got.insert(1, torch.zeros_like(leaves[1]))
    want = _vjp(args, g.numpy())
    for name, a, w in zip(NAMES, _to_itrx(got), want):
        np.testing.assert_allclose(a, w, atol=VJP_ATOL, rtol=VJP_RTOL, err_msg=name)
    plain = torch.autograd.grad(kv.vsrn_dec_plain(*leaves)[0], diff, g)
    for name, a, w in zip([n for n in NAMES if n != "cmask"], [x for i, x in enumerate(got)
                                                               if i != 1], plain):
        rel = float((a - w).abs().max() / w.abs().max())
        assert rel <= AUTOGRAD_REL, (name, rel)


def test_gradcheck_float64(rng):
    """The autograd Function's backward (the explicit reverse loop) is the
    derivative of its forward, in float64, with a context-dropout mask."""
    args = _port(_data(rng, 3, 2, 3, 4, 0.5), torch.float64)
    leaves = [a.requires_grad_(i != 1) for i, a in enumerate(args)]
    assert torch.autograd.gradcheck(lambda *a: kv._VSRNDecode.apply(None, *a), leaves, eps=1e-6,
                                    atol=1e-7)


def test_cpu_route_runs_the_plain_pair_without_counting(rng):
    """A CPU tensor takes the plain pair (no grad: the forward alone; with
    grad: the Function), and neither kernel counter moves."""
    p = _port(_data(rng, 4, 3, 2, 8, 0.75))
    before = kv.vsrn_dec_fused.launches, kv.vsrn_dec_bwd_fused.launches
    with torch.no_grad():
        got = kv.vsrn_dec_fused(*p)
    torch.testing.assert_close(got, kv.vsrn_dec_plain(*p)[0], rtol=0, atol=0)
    leaves = [a.requires_grad_(i != 1) for i, a in enumerate(p)]
    kv.vsrn_dec_fused(*leaves).sum().backward()
    assert all(a.grad is not None for i, a in enumerate(leaves) if i != 1)
    assert (kv.vsrn_dec_fused.launches, kv.vsrn_dec_bwd_fused.launches) == before
