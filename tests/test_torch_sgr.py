"""The port's SGR reasoning chain in training (the plain pair of the kernels
csrc/sgr.cu and csrc/sgr_bwd.cu) vs the JAX package's interpret-mode Pallas
kernel `itrx.ops.pallas.sgr.sgr_reason` and its custom VJP, on the CPU at a
small width (S 128, ragged node masks, sgr_step 1 and 3): the forward on
valid nodes, the backward against jax.vjp and against autograd through the
plain forward, a float64 gradcheck of the autograd Function, and the
wrapper's CPU route.  Inputs come from numpy with a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itrx.ops.pallas.sgr import sgr_reason
from itrx_torch.ops.kernels import sgr as ks

torch.set_num_threads(1)

S = 128
# forward vs the interpret-mode kernel (fp32 operands at HIGHEST there), as
# tests/test_pallas_sgr.py holds the kernel to the XLA chain
FWD_ATOL, FWD_RTOL = 3e-5, 1e-4
# backward vs jax.vjp: the same derivative in the folded form, summed in
# another order; per gradient, max abs error over the tensor's largest entry
VJP_REL = 2e-4
# backward vs autograd through the plain forward: the same function, fp32
AUTOGRAD_REL = 1e-5
NAMES = ("g_s0", "dWq", "dbq", "dWk", "dbk", "dWg", "dbg")


def _inputs(rng, b, n, steps):
    """Unit-norm nodes (B, N, S) with a ragged node mask (node 0 always
    valid, one row with it alone, one with every node), the steps' Linears
    at the reference's init scale in torch's (out, in) layout with random
    biases."""
    s0 = rng.standard_normal((b, n, S)).astype(np.float32)
    s0 /= np.linalg.norm(s0, axis=-1, keepdims=True)
    mask = (rng.uniform(size=(b, n)) < 0.6).astype(np.float32)
    mask[:, 0] = 1.0
    mask[1, 1:] = 0.0
    mask[2] = 1.0
    r = np.sqrt(6.0 / (2 * S))
    w = [rng.uniform(-r, r, (steps, S, S)).astype(np.float32) for _ in range(3)]
    bias = [(rng.standard_normal((steps, S)) * 0.1).astype(np.float32) for _ in range(3)]
    return s0, mask, w[0], bias[0], w[1], bias[1], w[2], bias[2]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax_args(s0, mask, wq, bq, wk, bk, wg, bg):
    """`itrx`'s arguments: the weights in flax's (in, out) layout."""
    tr = lambda w: jnp.asarray(np.swapaxes(w, 1, 2))  # noqa: E731
    return (jnp.asarray(s0), jnp.asarray(mask), tr(wq), jnp.asarray(bq), tr(wk),
            jnp.asarray(bk), tr(wg), jnp.asarray(bg))


SHAPES = [(24, 13, 1), (24, 13, 3), (7, 5, 2)]


@pytest.mark.parametrize("b,n,steps", SHAPES)
def test_sgr_reason_plain_matches_pallas_kernel(rng, b, n, steps):
    """sgr_reason_plain vs `itrx`'s kernel in interpret mode on the valid
    nodes (the port writes zero nodes at masked nodes; `itrx` computes relu
    values there, which nothing reads)."""
    x = _inputs(rng, b, n, steps)
    want = np.asarray(sgr_reason(*_jax_args(*x), True))
    got, outs = ks.sgr_reason_plain(*_t(*x))
    assert got.shape == (b, n, S) and got.dtype == torch.float32
    assert outs.shape == (steps, b, n, S) and torch.equal(outs[-1], got)
    valid = x[1][..., None] > 0
    np.testing.assert_allclose(np.where(valid, got.numpy(), 0.0), np.where(valid, want, 0.0),
                               atol=FWD_ATOL, rtol=FWD_RTOL)
    assert np.all(outs.numpy()[:, ~np.broadcast_to(valid, got.shape)] == 0.0)


@pytest.mark.parametrize("b,n,steps", SHAPES[1:])
def test_sgr_reason_bwd_plain_matches_jax_vjp(rng, b, n, steps):
    """sgr_reason_bwd_plain vs jax.vjp of `itrx`'s kernel (interpret mode)
    for a cotangent that is zero at masked nodes: g_s0 on valid nodes and
    every weight gradient within 2e-4 of its largest entry; the port's dbk
    is exactly 0 (`itrx`'s too)."""
    x = _inputs(rng, b, n, steps)
    g = rng.standard_normal((b, n, S)).astype(np.float32) * x[1][..., None]
    jargs = _jax_args(*x)
    _, vjp = jax.vjp(lambda s0, *w: sgr_reason(s0, jargs[1], *w, True), jargs[0], *jargs[2:])
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    # flax's (in, out) kernels back to torch's layout
    want = [want[0], want[1].swapaxes(1, 2), want[2], want[3].swapaxes(1, 2), want[4],
            want[5].swapaxes(1, 2), want[6]]
    _, outs = ks.sgr_reason_plain(*_t(*x))
    got = ks.sgr_reason_bwd_plain(*_t(*x), outs, torch.from_numpy(g))
    assert torch.equal(got[4], torch.zeros(steps, S)) and np.all(want[4] == 0.0)
    valid = x[1][..., None] > 0
    want[0] = np.where(valid, want[0], 0.0)
    assert np.all(got[0].numpy()[~np.broadcast_to(valid, got[0].shape)] == 0.0)
    for name, a, e in zip(NAMES, got, want):
        if name == "dbk":
            continue
        err = float(np.abs(a.numpy() - e).max() / np.abs(e).max())
        assert err <= VJP_REL, (name, err)


@pytest.mark.parametrize("b,n,steps", SHAPES[1:])
def test_sgr_reason_bwd_plain_is_the_derivative_of_the_plain_forward(rng, b, n, steps):
    """The explicit backward vs autograd through sgr_reason_plain, every
    gradient within 1e-5 of its largest entry, for a cotangent that is
    nonzero at masked nodes too (which the forward's mask drops); bk does
    not enter the folded forward, and its gradient is exactly 0."""
    x = _inputs(rng, b, n, steps)
    g = torch.from_numpy(rng.standard_normal((b, n, S)).astype(np.float32))
    ts = _t(*x)
    ps = [t.requires_grad_() for t in ts[:1] + ts[2:]]
    out, outs = ks.sgr_reason_plain(ps[0], ts[1], *ps[1:])
    want = torch.autograd.grad((out * g).sum(), ps, allow_unused=True, materialize_grads=True)
    got = ks.sgr_reason_bwd_plain(*(t.detach() for t in ts), outs.detach(), g)
    for name, a, e in zip(NAMES, got, want):
        if name == "dbk":
            assert torch.equal(a, torch.zeros_like(a)) and torch.equal(e, torch.zeros_like(e))
            continue
        err = float((a - e).abs().max() / e.abs().max())
        assert err <= AUTOGRAD_REL, (name, err)


def test_sgr_function_gradcheck_float64(rng):
    """gradcheck of the autograd Function on the CPU in float64 (its forward
    the plain forward, its backward the explicit plain backward), two steps
    and a masked node included."""
    b, n, s, steps = 2, 4, 4, 2
    mask = torch.tensor([[1.0, 1.0, 0.0, 1.0], [1.0, 0.0, 0.0, 0.0]], dtype=torch.float64)
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh) * 0.5).requires_grad_()  # noqa: E731
    s0 = f(b, n, s)
    ws = [f(steps, s, s) if i % 2 == 0 else f(steps, s) for i in range(6)]
    assert torch.autograd.gradcheck(
        lambda x, *w: ks._SGRReason.apply(x, mask, *w), (s0, *ws), eps=1e-6, atol=1e-6,
        rtol=1e-5)


def test_sgr_reason_fused_takes_the_plain_pair_on_the_cpu(rng):
    """On CPU tensors the wrapper is the plain forward (no grad) or the
    autograd Function, whose gradients are the plain backward's; bk gets an
    explicit zero gradient; bf16 nodes give bf16 nodes and a bf16 g_s0;
    nothing is counted."""
    x = _t(*_inputs(rng, 6, 7, 3))
    before = (ks.sgr_reason_fused.launches, ks.sgr_reason_bwd_fused.launches)
    with torch.no_grad():
        torch.testing.assert_close(ks.sgr_reason_fused(*x), ks.sgr_reason_plain(*x)[0],
                                   rtol=0, atol=0)
    g = torch.from_numpy(rng.standard_normal((6, 7, S)).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        ps = [x[0].to(dt).requires_grad_()] + [t.clone().requires_grad_() for t in x[2:]]
        out = ks.sgr_reason_fused(ps[0], x[1], *ps[1:])
        assert out.dtype == dt and out.grad_fn is not None
        got = torch.autograd.grad((out.float() * g).sum(), ps)
        _, outs = ks.sgr_reason_plain(ps[0].detach(), x[1], *x[2:])
        want = ks.sgr_reason_bwd_plain(ps[0].detach(), x[1], *x[2:], outs, g.to(dt))
        assert [t.dtype for t in got] == [dt] + [torch.float32] * 6
        assert torch.equal(got[4], torch.zeros_like(got[4]))
        for a, e in zip(got, want):
            torch.testing.assert_close(a, e.to(a.dtype), rtol=0, atol=0)
    assert (ks.sgr_reason_fused.launches, ks.sgr_reason_bwd_fused.launches) == before
