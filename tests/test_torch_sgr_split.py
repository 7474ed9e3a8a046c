"""The split products of the SGR reasoning backward, on the CPU.

The backward kernels (csrc/sgr_bwd.cu) run each step's five S x S products
on the tensor cores as split-bf16 products: three bf16 passes, a_hi b_lo +
a_lo b_hi + a_hi b_hi with x = hi + lo both bf16 rounded to nearest even
(step 0's bf16 nodes are exact in one part, so their products take two
passes), fp32 accumulation.  For step i with input X and output Y, over the
list of valid rows:

    g_ctx = g_pre Wg,  sm = X M                   (g_pre = g where Y > 0)
    the edges in fp32: a, ctx = a X, g_e, g_sm = g_e X, col, gx
    dWg = g_pre^T ctx,  dbg = sum g_pre,  dM = X^T g_sm,  dv = X^T col
    g = gx + g_sm M^T

Here a plain emulation of exactly those products (the rounding written on
the uint32 view) in exactly that chain, through three steps, is held to
`sgr_reason_bwd_plain` within the limits the kernels are held to on the
card (`chip_smoke.py`'s SGR_BWD_REL over SGR_FLOOR of the largest
cotangent, SGR_BF16_REL for bf16 g_s0), at the training path's width: S
256, sgr_step 3, ragged 1-24 words with a one-word caption.  One bf16 pass
of the same products is reported beside it.  The wrapper's row list, formed
without reading anything back, and its split weights are checked too.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from itrx_torch.ops.kernels import sgr as ks
from itrx_torch.ops.kernels.sgraf_eval import fold_sgr_qk, split_weight

SGR_BWD_REL = 1e-4  # chip_smoke.py: every cotangent over SGR_FLOOR of the largest
SGR_FLOOR = 1e-3
SGR_BF16_REL = 2.0 ** -8  # chip_smoke.py: bf16 g_s0
S, STEPS, WORDS = 256, 3, 24
NAMES = ("g_s0", "dWq", "dbq", "dWk", "dbk", "dWg", "dbg")


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
    fp32 (the lo terms first); a bf16-exact operand has lo = 0 (two
    passes)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return (ah @ bl + al @ bh) + ah @ bh


def one_pass_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one bf16 pass would form it."""
    return _split(a)[0] @ _split(b)[0]


def _inputs(seed: int, pairs: int, bf16: bool):
    """chip_smoke.py's reasoning inputs from a numpy seed: per pair a global
    node and one node per word of a ragged caption (1-24 words, pair 0 a
    one-word caption, the last pair 24), unit rows, zero at masked nodes;
    the steps' Linears at the reference's init scale with small biases; a
    cotangent random at valid nodes and zero elsewhere."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))  # noqa: E731
    lengths = rng.integers(1, WORDS + 1, pairs)
    lengths[0], lengths[-1] = 1, WORDS
    mask = np.concatenate([np.ones((pairs, 1)), np.arange(WORDS)[None] < lengths[:, None]],
                          axis=1).astype(np.float32)
    s0 = rng.standard_normal((pairs, WORDS + 1, S))
    s0 = s0 / np.linalg.norm(s0, axis=-1, keepdims=True) * mask[..., None]
    r = np.sqrt(6.0 / (2 * S))
    x = {"s0": t(s0), "mask": t(mask)}
    for k in ("q", "k", "g"):
        x[f"w{k}"] = t(rng.uniform(-r, r, (STEPS, S, S)))
        x[f"b{k}"] = t(rng.uniform(-0.05, 0.05, (STEPS, S)))
    if bf16:
        x["s0"] = x["s0"].bfloat16()
    g = t(rng.standard_normal((pairs, WORDS + 1, S))) * x["mask"][..., None]
    return x, g


def split_bwd(s0, mask, wq, bq, wk, bk, wg, bg, outs, g, mm=split_mm):
    """The backward as the kernels compute it: each step's five S x S
    products through `mm` over the listed valid rows, the edges in fp32.
    Returns the plain pair's seven cotangents."""
    valid = mask > 0
    keys, qm = valid[:, None, :], mask[..., None]
    mmf, vv = fold_sgr_qk(wq, bq, wk)
    dmm, dwg = torch.zeros_like(mmf), torch.zeros_like(mmf)
    dvv, dbg = torch.zeros_like(vv), torch.zeros_like(vv)
    g = g.float() * qm
    rows = lambda t: t[valid]  # noqa: E731  (the list: valid rows in order)

    def scatter(r):
        out = torch.zeros(*mask.shape, S)
        out[valid] = r
        return out

    for i in reversed(range(STEPS)):
        x = outs[i - 1] if i else s0.float()
        gp = rows(g * (outs[i] > 0))
        xr = rows(x)
        gctx = scatter(mm(gp, wg[i]))
        sm = scatter(mm(xr, mmf[i]))
        a = ks._softmax(x, sm, vv[i], keys)
        ctx = a @ x
        ga = gctx @ x.transpose(1, 2)
        ge = a * (ga - (ga * a).sum(-1, keepdim=True))
        gsm = ge @ x
        col = ge.sum(dim=1)
        gx = a.transpose(1, 2) @ gctx + ge.transpose(1, 2) @ sm + col[..., None] * vv[i]
        dwg[i] = mm(gp.t(), rows(ctx))
        dbg[i] = gp.sum(0)
        dmm[i] = mm(xr.t(), rows(gsm))
        dvv[i] = xr.t() @ rows(col)
        g = scatter(rows(gx) + mm(rows(gsm), mmf[i].t()))
    dwq, dbq, dwk = ks._unfold(dmm, dvv, wq, bq, wk)
    return g.to(s0.dtype), dwq, dbq, dwk, torch.zeros_like(dbq), dwg, dbg


def _rel(got, want, scale: float) -> float:
    """chip_smoke.py's reading: max |got - want| over the larger of the
    tensor's largest entry and SGR_FLOOR of the largest cotangent's."""
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), SGR_FLOOR * scale)


@pytest.mark.parametrize("bf16", [False, True])
def test_split_backward_within_the_kernel_limits(bf16):
    x, g = _inputs(0, 300, bf16)
    _, outs = ks.sgr_reason_plain(**x)
    want = ks.sgr_reason_bwd_plain(**x, outs=outs, g=g)
    got = split_bwd(**x, outs=outs, g=g)
    one = split_bwd(**x, outs=outs, g=g, mm=one_pass_mm)
    scale = max(float(t.float().abs().max()) for t in want)
    assert torch.equal(got[4], torch.zeros_like(got[4]))
    for name, a, w_, o in zip(NAMES, got, want, one):
        if name == "dbk":
            continue
        assert a.shape == w_.shape and a.dtype == w_.dtype, name
        lim = SGR_BF16_REL if a.dtype == torch.bfloat16 else SGR_BWD_REL
        err, err_one = _rel(a, w_, scale), _rel(o, w_, scale)
        print(f"{name} {'bf16' if bf16 else 'fp32'} nodes: split {err:.2e}, one bf16 pass "
              f"{err_one:.2e} (limit {lim:g})")
        assert torch.isfinite(a).all() and err <= lim, (name, err)
        if a.dtype != torch.bfloat16:
            # the limit separates: one bf16 pass of the same products misses it
            assert err_one > lim, (name, err_one)


@pytest.mark.parametrize("shape", [(7, 5), (64, 25), (3, 129)])
def test_row_list_is_nonzero(shape):
    """The row list formed on the device (cumsum ranks, a permutation
    scattered once) equals torch.nonzero's valid rows, in order, and then
    holds every masked row once; pstart holds each pair's first row in it,
    then the count."""
    rng = np.random.default_rng(sum(shape))
    mask = torch.from_numpy((rng.uniform(size=shape) < 0.5).astype(np.float32))
    mask[:, 0] = 1.0
    mask[1, 1:] = 0.0
    rows, pstart = ks.row_list(mask)
    want = torch.nonzero(mask.reshape(-1) > 0).reshape(-1)
    assert rows.dtype == pstart.dtype == torch.int32 and pstart.shape == (shape[0] + 1,)
    assert int(pstart[-1]) == want.numel()
    assert torch.equal(rows[:want.numel()].long(), want)
    assert torch.equal(torch.sort(rows).values, torch.arange(mask.numel(), dtype=torch.int32))
    assert bool((mask.reshape(-1)[rows[want.numel():].long()] == 0).all())
    for p in range(shape[0]):
        # pair p's valid rows are the list's rows pstart[p] .. pstart[p + 1] - 1
        got = rows[int(pstart[p]):int(pstart[p + 1])].long()
        assert torch.equal(got, p * shape[1] + torch.nonzero(mask[p] > 0).reshape(-1))


@pytest.mark.parametrize("pairs,blocks", [(300, 264), (4096, 264), (5, 8), (1, 1)])
def test_edge_bounds_balance_the_pairs(pairs, blocks):
    """The edge pass's pair ranges, cut on the device from pstart: they
    start at 0, end at B, never go back, and each range's n (n + 4) is
    within one pair's of an equal share."""
    x, _ = _inputs(1, pairs, False)
    _, pstart = ks.row_list(x["mask"])
    bounds = ks.edge_bounds(pstart, blocks)
    assert bounds.dtype == torch.int32 and bounds.shape == (blocks + 1,)
    assert int(bounds[0]) == 0 and int(bounds[-1]) == pairs
    assert bool((bounds[1:] >= bounds[:-1]).all())
    n = (pstart[1:] - pstart[:-1]).long()
    cost = n * (n + 4)
    share = float(cost.sum()) / blocks
    for b in range(blocks):
        got = int(cost[int(bounds[b]):int(bounds[b + 1])].sum())
        assert got <= share + int(cost.max()), (b, got, share)


@pytest.mark.parametrize("s", [256, 36])
def test_bwd_weights_are_split_weight(s):
    """The three products' weights, split once a call: M^T (sm = X M), M
    (g_sm M^T) and Wg^T (g_ctx = g_pre Wg), each in `split_weight`'s slab
    layout, per step; each one's product with the split operand is the
    matrix product it stands for."""
    rng = np.random.default_rng(s)
    w = [torch.from_numpy(rng.uniform(-0.1, 0.1, (2, s, s)).astype(np.float32))
         for _ in range(3)]
    mm, _ = fold_sgr_qk(w[0], w[0][:, 0], w[1])
    mts, ms, gs = ks.bwd_weights(mm, w[2])
    for got, want in ((mts, mm.transpose(1, 2)), (ms, mm), (gs, w[2].transpose(1, 2))):
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        assert torch.equal(got, split_weight(want))
        n8, k32 = -(-s // 8) * 8, -(-s // 32) * 32
        assert got.shape == (2, k32 // 32, 2, 2, n8 // 8, 2, 8, 8)
