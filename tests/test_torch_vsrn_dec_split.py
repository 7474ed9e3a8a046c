"""The arithmetic of VSRN's caption-decoder backward kernel, on the CPU.

The backward (csrc/vsrn_dec_bwd.cu) runs every product as a split-bf16
product on the tensor cores: three bf16 passes, a_hi b_lo + a_lo b_hi +
a_hi b_hi with x = hi + lo both bf16 rounded to nearest even, fp32
accumulation: the recomputed hq = hall Watt^T and gx = ctx Wctx^T + gxw,
the reverse loop's g_ctx = (g_gx Wctx) cmask and carry g = (g_ht z + g_gh
Whh) + g_hq Watt, and the weight sums [dWatt ; dWhh] = [g_hq | g_gh]^T hall
and dWctx = g_gx^T ctx.  The loop keeps only what feeds the carry (the cell,
those products, the attention's g_alpha, g_e and g_hq, fp32), saves g_ctx
and g_e of every step, and takes the attention's sums over t after it, in
order of t:

    g_enc_out[b]    = sum_t alpha_t[b]^T g_ctx_t[b]
    g_enc_att[b, r] = w2 * sum_t g_e_t[b, r] (1 - tanh(enc_att[b, r] + hq_t[b])^2)
    dw2             = sum_b sum_r sum_t g_e_t[b, r] tanh(...)

Here a plain emulation of exactly that (the rounding written on the uint32
view) is held within chip_smoke.py's VSRN_BWD_REL to `vsrn_dec_bwd_plain`
and to `jax.vjp` of `itrx`'s interpret-mode `decoder_seq(dot_dtype=
"float32")`, at small widths with context-dropout masks; the wrapper's
split of the weights (`split_rows`) and the loop's launch plan (`plan`) are
checked too.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from itrx.ops.pallas.vsrn_dec import decoder_seq
from itrx_torch.ops.kernels import vsrn_dec as kv
from itrx_torch.ops.kernels.sgraf_eval import SPLIT_DEPTH
from tests.test_torch_sgraf_align_split import _split, split_mm
from tests.test_torch_vsrn_dec import NAMES, _data, _port, _to_itrx

torch.set_num_threads(1)

VSRN_BWD_REL = 1e-4  # chip_smoke.py: each cotangent, max|kernel - plain| / max|plain|
# (T, B, R, H, keep): chip_smoke.py's ragged odd shape, then another with a
# context-dropout mask
SHAPES = [(7, 37, 5, 96, 0.5), (6, 9, 3, 40, 0.8)]
H100_SMS = 132
SMEM = 232_448


def _split_at(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T b over the rows as the weight sums form it (both operands split)."""
    return split_mm(a.t().contiguous(), b)


def emulated_bwd(gxw, cmask, enco, enca, h0, watt, w2, wctx, whh, bhh, hall, ghall, g_hs):
    """The kernels' backward in plain fp32 torch: the cotangents of the ten
    inputs, in their order."""
    t_n, b_n, h3 = gxw.shape
    h = h3 // 3
    r_n = enco.shape[1]
    w2v = w2.reshape(-1)
    rows = t_n * b_n
    hall2 = hall.reshape(rows, h)
    # 1. the recomputation: hq and gx split, the attention fp32
    hq = split_mm(hall2, watt.t()).reshape(t_n, b_n, h)
    o = torch.tanh(enca[None] + hq[:, :, None, :])                  # (T, B, R, H)
    alpha = torch.softmax(o @ w2v, dim=-1)                           # (T, B, R)
    ctx = torch.einsum("tbr,brh->tbh", alpha, enco) * cmask
    gx = split_mm(ctx.reshape(rows, h), wctx.t()).reshape(t_n, b_n, h3) + gxw
    # 2. the loop: only the carry's chain
    g = torch.zeros(b_n, h)
    g_gxw = torch.zeros_like(gxw)
    cat = torch.zeros(t_n, b_n, 4 * h)
    gctx = torch.zeros(t_n, b_n, h)
    ge = torch.zeros(t_n, b_n, r_n)
    for t in reversed(range(t_n)):
        x, gh, hp = gx[t], ghall[t], hall[t]
        r = torch.sigmoid(x[:, :h] + gh[:, :h])
        z = torch.sigmoid(x[:, h:2 * h] + gh[:, h:2 * h])
        n = torch.tanh(x[:, 2 * h:] + r * gh[:, 2 * h:])
        g_ht = g + g_hs[t]
        g_pren = g_ht * (1.0 - z) * (1.0 - n * n)
        g_prer = g_pren * gh[:, 2 * h:] * r * (1.0 - r)
        g_prez = g_ht * (hp - n) * z * (1.0 - z)
        g_gxw[t] = torch.cat([g_prer, g_prez, g_pren], dim=1)
        cat[t, :, h:] = torch.cat([g_prer, g_prez, g_pren * r], dim=1)
        # one read of the exchange: g_ctx and the carry's g_gh Whh (split)
        gctx[t] = split_mm(g_gxw[t], wctx) * cmask[t]
        gp = g_ht * z + split_mm(cat[t, :, h:], whh)
        g_alpha = torch.einsum("bh,brh->br", gctx[t], enco)
        ge[t] = alpha[t] * (g_alpha - (alpha[t] * g_alpha).sum(-1, keepdim=True))
        cat[t, :, :h] = (ge[t][:, :, None] * w2v * (1.0 - o[t] ** 2)).sum(1)
        g = gp + split_mm(cat[t, :, :h], watt)
    # 3. the attention's sums over t, in order of t
    g_enco = torch.zeros_like(enco)
    s_e = torch.zeros_like(enca)
    s_d = torch.zeros_like(enca)
    for t in range(t_n):
        g_enco += alpha[t][:, :, None] * gctx[t][:, None, :]
        s_e += ge[t][:, :, None] * (1.0 - o[t] ** 2)
        s_d += ge[t][:, :, None] * o[t]
    g_enca = w2v * s_e
    d_w2 = s_d.sum(dim=(0, 1)).reshape(w2.shape)
    # 4. the weight sums, split, over every row
    cat2 = cat.reshape(rows, 4 * h)
    dwcat = _split_at(cat2, hall2)
    d_wctx = _split_at(g_gxw.reshape(rows, h3), ctx.reshape(rows, h))
    d_bhh = cat2[:, h:].sum(0)
    return (g_gxw, torch.zeros_like(cmask), g_enco, g_enca, g, dwcat[:h], d_w2, d_wctx,
            dwcat[h:], d_bhh)


def _rel(a: torch.Tensor, w) -> float:
    w = torch.as_tensor(np.array(w), dtype=torch.float64)
    return float((a.double() - w).abs().max() / w.abs().max())


@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_backward_matches_plain_and_jax(rng, shape):
    t_n, b_n, r_n, h, keep = shape
    args = _data(rng, *shape)
    g = (rng.standard_normal((t_n, b_n, h)) * 0.5).astype(np.float32)
    p = _port(args)
    _, hall, ghall = kv.vsrn_dec_plain(*p)
    got = emulated_bwd(*p, hall, ghall, torch.from_numpy(g))
    plain = kv.vsrn_dec_bwd_plain(*p, hall, ghall, torch.from_numpy(g))
    jargs = [jnp.asarray(a) for a in args]
    _, pull = jax.vjp(lambda *a: decoder_seq(*a, interpret=True, dot_dtype="float32"), *jargs)
    want_jax = [np.asarray(x) for x in pull(jnp.asarray(g))]
    assert not got[1].any()
    for name, a, w, a_itrx, wj in zip(NAMES, got, plain, _to_itrx(got), want_jax):
        if name == "cmask":
            continue
        assert _rel(a, w) <= VSRN_BWD_REL, (name, "plain", _rel(a, w))
        assert _rel(torch.from_numpy(np.ascontiguousarray(a_itrx)), wj) <= VSRN_BWD_REL, (
            name, "jax", _rel(torch.from_numpy(np.ascontiguousarray(a_itrx)), wj))


def test_one_bf16_pass_is_not_enough(rng):
    """The limit separates the three-pass split from one bf16 pass: the same
    recomputed hq in one pass is off by more than VSRN_BWD_REL."""
    p = _port(_data(rng, *SHAPES[0]))
    _, hall, _ = kv.vsrn_dec_plain(*p)
    a = hall.reshape(-1, hall.shape[-1])
    exact = a.double() @ p[5].double().t()
    three = split_mm(a, p[5].t())
    one = _split(a)[0] @ _split(p[5].t())[0]
    assert _rel(three, exact) <= VSRN_BWD_REL / 10 < VSRN_BWD_REL < _rel(one, exact)


@pytest.mark.parametrize("n,k", [(96, 96), (288, 96), (512, 512), (1536, 512), (300, 40)])
def test_split_rows_layout(n, k):
    """`split_rows` cuts W (N, K) into chunks of S8 output rows (256 at most,
    N rounded up to 8 below that), each chunk contiguous in split_weight's
    slab layout: per slab of 32 k, k16 step and part (hi, lo), 8 x 8 core
    matrices [n // 8][k // 8][n % 8][k % 8]; hi + lo is W to 2^-16, zero
    past N and K."""
    w = torch.randn(n, k, generator=torch.Generator().manual_seed(n + k))
    s, s8 = kv.split_rows(w)
    assert s8 == min(256, -(-n // 8) * 8) and s.dtype == torch.bfloat16
    k32 = -(-k // SPLIT_DEPTH) * SPLIT_DEPTH
    chunks = -(-n // s8)
    assert s.shape == (chunks, k32 // 32, 2, 2, s8 // 8, 2, 8, 8)
    # [chunk][slab][st][part][nb][kg][r][e] -> W[chunk s8 + 8 nb + r][32 slab + 16 st + 8 kg + e]
    parts = s.float().permute(0, 4, 6, 1, 2, 5, 7, 3).reshape(chunks * s8, k32, 2)
    back = parts[..., 0] + parts[..., 1]
    assert torch.equal(back[n:], torch.zeros_like(back[n:]))
    assert torch.equal(back[:, k:], torch.zeros_like(back[:, k:]))
    assert float((back[:n, :k] - w).abs().max() / w.abs().max()) <= 2.0 ** -16
    assert torch.equal(parts[:n, :k, 0], w.bfloat16().float())


@pytest.mark.parametrize("hidden", [512, 1024, 96, 1, 1000, 1023, 528, 529, 775, 776])
@pytest.mark.parametrize("batch", [128, 37, 1, 300])
def test_loop_plan_covers_h_and_fits(batch, hidden):
    """The loop's plan on an H100: the blocks' slices of 8 units cover H once
    (each slice `halves` times, each of those blocks a share of the rows),
    the grid is no larger than the SM count, and the dynamic plus static
    shared memory fits one block's 227 KB: f1's fragments streamed where
    both products' do not fit resident."""
    p = kv.plan(batch, 36, hidden, sms=H100_SMS)
    groups = -(-hidden // kv.UNITS)
    assert p.halves in kv.HALVES
    assert p.blocks == p.halves * groups <= H100_SMS
    assert p.halves == (2 if 2 * groups <= H100_SMS else 1)
    assert p.smem + kv.LOOP_STATIC_SMEM <= SMEM
    assert p.k1 % 64 == 0 and p.k4 % 64 == 0 and p.k1 >= hidden and p.k4 >= 4 * hidden
    f3 = p.k1 // 16 * 512
    resident = f3 + p.k4 // 16 * 2 * 512
    assert p.route == ("resident" if resident + kv.LOOP_STATIC_SMEM <= SMEM else "streamed")
    if p.route == "streamed":
        assert p.halves == 1 and p.smem == f3 + 4 * 2 * 4 * 512
    else:
        assert p.smem == resident


def test_loop_plan_at_the_training_shapes():
    """VSRN's dim_hidden 512: 64 slices of 8 units, two blocks each (128
    blocks), both products' fragments resident (144 KB); H 1024: 128 blocks
    of one slice each, f1's fragments streamed."""
    frags = (512 // 16 + 2048 // 16 * 2) * 512
    assert kv.plan(128, 36, 512) == kv.LoopPlan(2, 128, "resident", frags, 512, 2048)
    p = kv.plan(128, 36, 1024)
    assert (p.halves, p.blocks, p.route) == (1, 128, "streamed")
    assert kv.plan(128, 36, 512, halves=1).blocks == 64


@pytest.mark.parametrize("h", [8, 40, 96, 12])
def test_loop_weights_fragment_layout(h):
    """`loop_weights`' fragments: per group of 8 units, k16 step, n8 tile
    and lane (g, t), the bf16 hi then lo of columns 4t .. 4t + 3 of the step
    of unit 8 group + g's weight row; tile 0 of f1 is Wctx^T over the
    exchange's g_gx columns (zero over its g_pren r), tile 1 Whh^T over
    [g_prer | g_prez | . | g_pren r]; f3 is Watt^T; hi + lo within 2^-16,
    zero past H and the depth.  So one exchange row against f1's tiles gives
    g_gx Wctx and g_gh Whh."""
    g = torch.Generator().manual_seed(h)
    watt, wctx, whh = (torch.randn(*sh, generator=g) for sh in ((h, h), (3 * h, h), (3 * h, h)))
    p = kv.plan(16, 4, h)
    groups = p.blocks // p.halves
    f1, f3 = kv.loop_weights(watt, wctx, whh, p.k1, p.k4, groups)
    assert groups == -(-h // 8)
    assert f1.shape == (groups, p.k4 // 16, 2, 8, 4, 2, 4) and f1.dtype == torch.bfloat16
    assert f3.shape == (groups, p.k1 // 16, 1, 8, 4, 2, 4)

    def rows(f, k):  # back to (tiles, units, depth) as hi + lo
        w = f.float().sum(dim=-2).permute(2, 0, 3, 1, 4, 5)  # tile, group, g, step, t, c
        return w.reshape(f.shape[2], groups * 8, k)

    r1, r3 = rows(f1, p.k4), rows(f3, p.k1)
    w1 = torch.zeros(2, groups * 8, p.k4)
    w1[0, :h, :3 * h] = wctx.t()
    w1[1, :h, :2 * h] = whh.t()[:, :2 * h]
    w1[1, :h, 3 * h:4 * h] = whh.t()[:, 2 * h:]
    w3 = torch.zeros(1, groups * 8, p.k1)
    w3[0, :h, :h] = watt.t()
    for got, want in ((r1, w1), (r3, w3)):
        assert torch.equal(got[want == 0], torch.zeros_like(got[want == 0]))
        assert float((got - want).abs().max() / want.abs().max()) <= 2.0 ** -16
    hi = w1.reshape(2, groups, 8, p.k4 // 16, 4, 4).permute(1, 3, 0, 2, 4, 5).bfloat16()
    assert torch.equal(f1[..., 0, :], hi)
    prer, prez, pren, pr = (torch.randn(5, h, generator=g, dtype=torch.float64) for _ in range(4))
    ex = F.pad(torch.cat([prer, prez, pren, pr], dim=1), (0, p.k4 - 4 * h))
    out = ex @ r1.double().transpose(1, 2)
    for got, want in ((out[0, :, :h], torch.cat([prer, prez, pren], 1) @ wctx.double()),
                      (out[1, :, :h], torch.cat([prer, prez, pr], 1) @ whh.double())):
        assert float((got - want).abs().max() / want.abs().max()) <= 2e-5


@pytest.mark.parametrize("batch,regions,hidden,sms,halves", [
    (128, 36, 1025, 132, None),   # H above MAX_HIDDEN
    (128, 129, 512, 132, None),   # R above MAX_REGIONS
    (128, 0, 512, 132, None),
    (0, 36, 512, 132, None),
    (128, 36, 1024, 132, 2),      # 2 x 128 blocks on 132 SMs
    (128, 36, 1024, 114, None),   # 128 slices on 114 SMs
    (128, 36, 512, 132, 4),       # no such variant
    (128, 36, 1000, 252, 2),      # two blocks a slice with f1 streamed
])
def test_loop_plan_refuses_what_the_kernels_do_not_take(batch, regions, hidden, sms, halves):
    with pytest.raises(ValueError, match="vsrn_dec plan"):
        kv.plan(batch, regions, hidden, sms=sms, halves=halves)
