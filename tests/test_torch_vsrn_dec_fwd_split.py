"""The arithmetic of VSRN's caption-decoder forward kernel, on the CPU.

The forward (csrc/vsrn_dec.cu) runs the decode loop with every product as a
split-bf16 product on the tensor cores: three bf16 passes, a_hi b_lo +
a_lo b_hi + a_hi b_hi with x = hi + lo both bf16 rounded to nearest even,
fp32 accumulation.  In step order: hq = h Watt^T and gh = h Whh^T + bhh from
one read of h_{t-1} (the split [Watt ; Whh]), the attention in fp32, gx =
ctx Wctx^T + gxw_t (the split Wctx), the GRU cell in fp32.  Here a plain
emulation of exactly that (the rounding written on the uint32 view) is held
within chip_smoke.py's VSRN_FWD_REL to `vsrn_dec_plain` and to `itrx`'s
interpret-mode `decoder_seq(dot_dtype="float32")`, one bf16 pass is shown
to miss that limit, and the wrapper's fragments (`fwd_weights`) and launch
plan (`fwd_plan`) are checked.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from itrx.ops.pallas.vsrn_dec import decoder_seq
from itrx_torch.ops.kernels import vsrn_dec as kv
from tests.test_torch_sgraf_align_split import one_pass_mm, split_mm
from tests.test_torch_vsrn_dec import SHAPES as JAX_SHAPES
from tests.test_torch_vsrn_dec import _data, _port

torch.set_num_threads(1)

VSRN_FWD_REL = 1e-5  # chip_smoke.py: states, hall, ghall, max|kernel - plain| / max|plain|
# (T, B, R, H, keep): the training path's width (H 512, 36 regions) over 12
# steps, then chip_smoke.py's ragged odd shape
SHAPES = [(12, 32, 36, 512, 0.8), (7, 37, 5, 96, 0.5)]
H100_SMS = 132
SMEM = 232_448


def _inputs(seed: int, t: int, b: int, r: int, h: int, keep: float) -> list:
    """chip_smoke.py's decode inputs at its scales, from a numpy seed, in the
    port's layouts: encoder outputs and h_0 in (-1, 1), enc_att through
    linear1's encoder half, the word gates, torch's init for the weights
    (linear1 over 2H), the context-dropout mask pre-scaled by 1 / keep."""
    rng = np.random.default_rng(seed)
    u = lambda lim, *s: rng.uniform(-lim, lim, s)  # noqa: E731
    k, k2 = 1.0 / np.sqrt(h), 1.0 / np.sqrt(2 * h)
    enc_out = np.tanh(rng.standard_normal((b, r, h)) * 0.5)
    w1, b1 = u(k2, h, 2 * h), u(k2, h)
    cmask = (rng.random((t, b, h)) < keep) / keep
    args = (rng.standard_normal((t, b, 3 * h)) * 0.3, cmask, enc_out,
            enc_out @ w1[:, :h].T + b1, np.tanh(rng.standard_normal((b, h)) * 0.5), w1[:, h:],
            u(k, 1, h), u(k, 3 * h, h), u(k, 3 * h, h), u(k, 3 * h))
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)) for a in args]


def emulated_fwd(gxw, cmask, enco, enca, h0, watt, w2, wctx, whh, bhh, mm=split_mm):
    """The kernel's forward in plain fp32 torch, every product through `mm`
    (the kernel's split product, or one bf16 pass): (hs, hall, ghall)."""
    hd = h0.shape[-1]
    w2v = w2.reshape(-1)
    wcat_t = torch.cat([watt, whh]).t()  # one read of h gives hq and gh
    wctx_t = wctx.t()
    h = h0
    hs, hall, ghall = [], [], []
    for t in range(gxw.shape[0]):
        p = mm(h, wcat_t)
        hq, gh = p[:, :hd], p[:, hd:] + bhh
        o = torch.tanh(enca + hq[:, None, :])
        alpha = torch.softmax(o @ w2v, dim=1)
        ctx = torch.einsum("br,brh->bh", alpha, enco) * cmask[t]
        gx = mm(ctx, wctx_t) + gxw[t]
        r = torch.sigmoid(gx[:, :hd] + gh[:, :hd])
        z = torch.sigmoid(gx[:, hd:2 * hd] + gh[:, hd:2 * hd])
        n = torch.tanh(gx[:, 2 * hd:] + r * gh[:, 2 * hd:])
        hall.append(h)
        ghall.append(gh)
        h = (1.0 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs), torch.stack(hall), torch.stack(ghall)


def _rel(a: torch.Tensor, w: torch.Tensor) -> float:
    return float((a.double() - w.double()).abs().max() / w.double().abs().max())


@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_forward_matches_plain(shape):
    args = _inputs(sum(shape[:4]), *shape)
    got = emulated_fwd(*args)
    want = kv.vsrn_dec_plain(*args)
    for name, a, w in zip(("hs", "hall", "ghall"), got, want):
        assert torch.isfinite(a).all()
        assert _rel(a, w) <= VSRN_FWD_REL, (name, _rel(a, w))


@pytest.mark.parametrize("shape", JAX_SHAPES)
def test_emulated_forward_matches_jax(rng, shape):
    """The states against the interpret-mode Pallas kernel; hall is h_0 then
    its states, ghall hall Whh^T + bhh (float64 from them)."""
    args = _data(rng, *shape)
    hs, hall, ghall = emulated_fwd(*_port(args))
    jhs = np.asarray(decoder_seq(*[jnp.asarray(a) for a in args], interpret=True,
                                 dot_dtype="float32"), dtype=np.float64)
    jhall = np.concatenate([args[4][None].astype(np.float64), jhs[:-1]])
    jghall = jhall @ args[8].T.astype(np.float64) + args[9]
    for name, a, w in (("hs", hs, jhs), ("hall", hall, jhall), ("ghall", ghall, jghall)):
        assert _rel(a, torch.from_numpy(w)) <= VSRN_FWD_REL, (name, _rel(a, torch.from_numpy(w)))


def test_one_bf16_pass_is_not_enough():
    """The limit separates the kernel's three-pass split from one bf16 pass:
    the same loop with one pass a product is off by more than VSRN_FWD_REL
    in every output."""
    args = _inputs(0, *SHAPES[0])
    want = kv.vsrn_dec_plain(*args)
    three = emulated_fwd(*args)
    one = emulated_fwd(*args, mm=one_pass_mm)
    for a3, a1, w in zip(three, one, want):
        assert _rel(a3, w) <= VSRN_FWD_REL < _rel(a1, w)


@pytest.mark.parametrize("h", [8, 40, 96, 12])
def test_fwd_weights_fragment_layout(h):
    """`fwd_weights`' fragments: per group of 8 units, k16 step, n8 tile and
    lane (g, t), the bf16 hi then lo of columns 4t .. 4t + 3 of the step of
    unit 8 group + g's weight row; fh's tiles Watt and Whh's r, z, n rows,
    fc's Wctx's; hi + lo within 2^-16, zero past H and the depth.  So one
    state row against fh gives hq and gh, one context row against fc gx."""
    g = torch.Generator().manual_seed(h)
    watt, wctx, whh = (torch.randn(*sh, generator=g) for sh in ((h, h), (3 * h, h), (3 * h, h)))
    p = kv.fwd_plan(16, 4, h)
    groups = p.blocks // p.halves
    fh, fc = kv.fwd_weights(watt, wctx, whh, p.k1, groups)
    assert groups == -(-h // 8)
    assert fh.shape == (groups, p.k1 // 16, 4, 8, 4, 2, 4) and fh.dtype == torch.bfloat16
    assert fc.shape == (groups, p.k1 // 16, 3, 8, 4, 2, 4) and fc.dtype == torch.bfloat16

    def rows(f):  # back to (tiles, units, depth) as hi + lo
        w = f.float().sum(dim=-2).permute(2, 0, 3, 1, 4, 5)  # tile, group, g, step, t, c
        return w.reshape(f.shape[2], groups * 8, p.k1)

    def padded(w, tiles):
        return F.pad(w.reshape(tiles, h, h), (0, p.k1 - h, 0, groups * 8 - h))

    rh, rc = rows(fh), rows(fc)
    for got, want in ((rh, padded(torch.cat([watt, whh]), 4)), (rc, padded(wctx, 3))):
        assert torch.equal(got[want == 0], torch.zeros_like(got[want == 0]))
        assert float((got - want).abs().max() / want.abs().max()) <= 2.0 ** -16
    hi = padded(wctx, 3).reshape(3, groups, 8, p.k1 // 16, 4, 4).permute(1, 3, 0, 2, 4, 5)
    assert torch.equal(fc[..., 0, :], hi.bfloat16())
    x = F.pad(torch.randn(5, h, generator=g, dtype=torch.float64), (0, p.k1 - h))
    out_h, out_c = (x @ r.double().transpose(1, 2) for r in (rh, rc))
    for got, want in ((out_h[0, :, :h], x[:, :h] @ watt.double().t()),
                      (out_h[1:, :, :h].permute(1, 0, 2).reshape(5, 3 * h),
                       x[:, :h] @ whh.double().t()),
                      (out_c[:, :, :h].permute(1, 0, 2).reshape(5, 3 * h),
                       x[:, :h] @ wctx.double().t())):
        assert float((got - want).abs().max() / want.abs().max()) <= 2e-5


@pytest.mark.parametrize("hidden", [512, 1024, 96, 1, 960, 961, 1023, 528, 529, 64])
@pytest.mark.parametrize("batch", [128, 37, 1, 300])
def test_fwd_plan_covers_h_and_fits(batch, hidden):
    """The forward loop's plan on an H100: the blocks' slices of 8 units cover
    H once (each slice `halves` times), the grid is no larger than the SM
    count, and the dynamic plus static shared memory fits one block's 227 KB:
    Wctx's fragments streamed where both products' do not fit resident."""
    p = kv.fwd_plan(batch, 36, hidden, sms=H100_SMS)
    groups = -(-hidden // kv.UNITS)
    assert p.halves in kv.HALVES
    assert p.blocks == p.halves * groups <= H100_SMS
    assert p.halves == (2 if 2 * groups <= H100_SMS else 1)
    assert p.smem + kv.FWD_STATIC_SMEM <= SMEM
    assert p.k1 % 64 == 0 and hidden <= p.k1 < hidden + 64
    fh, fc = (p.k1 // 16 * n * 512 for n in kv.FWD_TILES)
    assert p.route == ("resident" if fh + fc + kv.FWD_STATIC_SMEM <= SMEM else "streamed")
    if p.route == "streamed":
        assert p.halves == 1 and p.smem == fh + 4 * 3 * 4 * 512
    else:
        assert p.smem == fh + fc


def test_fwd_plan_at_the_training_shapes():
    """VSRN's dim_hidden 512: 64 slices of 8 units, two blocks each (128
    blocks), all seven tiles' fragments resident (112 KB); H up to 960
    resident; H 1024: 128 blocks of one slice each, Wctx's fragments
    streamed."""
    assert kv.fwd_plan(128, 36, 512) == kv.FwdPlan(2, 128, "resident", 7 * 32 * 512, 512)
    assert kv.fwd_plan(128, 36, 960).route == "resident"
    p = kv.fwd_plan(200, 128, 1024)
    assert (p.halves, p.blocks, p.route) == (1, 128, "streamed")
    assert kv.fwd_plan(128, 36, 512, halves=1).blocks == 64


@pytest.mark.parametrize("batch,regions,hidden,sms,halves", [
    (128, 36, 1025, 132, None),   # H above MAX_HIDDEN
    (128, 129, 512, 132, None),   # R above MAX_REGIONS
    (128, 0, 512, 132, None),
    (0, 36, 512, 132, None),
    (128, 36, 0, 132, None),
    (128, 36, 1024, 132, 2),      # 2 x 128 blocks on 132 SMs
    (128, 36, 1024, 114, None),   # 128 slices on 114 SMs
    (128, 36, 512, 132, 4),       # no such variant
    (128, 36, 1000, 252, 2),      # two blocks a slice with Wctx streamed
])
def test_fwd_plan_refuses_what_the_kernel_does_not_take(batch, regions, hidden, sms, halves):
    with pytest.raises(ValueError, match="vsrn_dec fwd_plan"):
        kv.fwd_plan(batch, regions, hidden, sms=sms, halves=halves)
