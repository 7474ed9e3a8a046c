"""The bf16 modes' plain versions against `itrx`'s interpret-mode Pallas
kernels at dot_dtype="bfloat16", on the CPU at small widths: the GRU adjoint
(`gru_bwd_plain(..., dot_dtype=bf16)` with the weight-gradient matmuls) vs
jax.vjp of itrx/ops/pallas/gru.py::_gru_seq, and VSRN's decoder pair
(`vsrn_dec_plain` / `vsrn_dec_bwd_plain` at bf16 dot) vs `decoder_seq` and
its VJP.  They are the arithmetic the CUDA kernels' bf16 modes are held to on
the card.  Both sides round at the same points, so they differ by fp32
summation order, and by one bf16 step where an operand near a rounding
boundary rounds apart; the same computations without the roundings lie
further away than `ROUNDING_REL`, so the limit holds the rounding points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itrx.ops.pallas import gru as jgru
from itrx.ops.pallas.vsrn_dec import decoder_seq
from itrx_torch.ops.kernels import vsrn_dec as kv
from itrx_torch.ops.kernels.gru import gru_weight_grads
from itrx_torch.ops.rnn import gru_bwd_plain, gru_fwd_plain
from tests.test_torch_train import _gru_inputs
from tests.test_torch_vsrn_dec import NAMES, SHAPES, _data, _port, _to_itrx

torch.set_num_threads(1)

BF16 = torch.bfloat16
# max abs error over the tensor's largest entry.  Read on the CPU: the GRU
# adjoint at most 6.2e-5 (dW_hh), the decoder pair at most 1.2e-5 (g_gxw);
# without the roundings 8.5e-4 to 5.6e-3
ROUNDING_REL = 2e-4


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16_values(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(BF16).float().numpy()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cotangents", ["outs+final", "outs", "final"])
def test_gru_bwd_plain_bf16_matches_pallas_vjp(rng, reverse, cotangents):
    """gru_fwd_plain and gru_bwd_plain at dot_dtype bf16, then the weight
    gradients, vs jax.vjp of `_gru_seq` at dot_dtype "bfloat16" (interpret
    mode): the states, the gates_x cotangent (bf16 values on both sides),
    dW_hh and db_hh, within ROUNDING_REL; the same adjoint without the
    roundings lies further away."""
    b, l, h = 8, 9, 128
    x, mask, w = _gru_inputs(rng, b, l)
    gx = (x @ w[0].T + w[2]).astype(np.float32)
    g_out = rng.standard_normal((b, l, h)).astype(np.float32)
    g_fin = rng.standard_normal((b, h)).astype(np.float32)
    if cotangents == "outs":
        g_fin = np.zeros_like(g_fin)
    if cotangents == "final":
        g_out = np.zeros_like(g_out)

    jgx = jnp.asarray(gx.transpose(1, 0, 2))
    jm = jnp.asarray(mask.T[:, :, None])
    (jouts, jfin), vjp = jax.vjp(
        lambda a, wh, bh: jgru._gru_seq(a, jm, wh, bh, reverse, True, "bfloat16"),
        jgx, jnp.asarray(w[1]), jnp.asarray(w[3]),
    )
    want = [np.asarray(a) for a in vjp((jnp.asarray(g_out.transpose(1, 0, 2)),
                                        jnp.asarray(g_fin)))]
    want[0] = want[0].transpose(1, 0, 2)

    t = torch.from_numpy
    outs, final, hall, ghall = gru_fwd_plain(t(gx), t(mask), t(w[1]), t(w[3]), reverse,
                                             dot_dtype=BF16)
    assert _rel(outs.numpy(), np.asarray(jouts).transpose(1, 0, 2)) <= 1e-5
    assert _rel(final.numpy(), np.asarray(jfin)) <= 1e-5
    go = None if cotangents == "final" else t(g_out)
    gf = None if cotangents == "outs" else t(g_fin)
    got = []
    for dot in (BF16, None):
        ggx, ghn, _ = gru_bwd_plain(t(gx), t(mask), hall, ghall, go, gf, t(w[1]), reverse,
                                    dot_dtype=dot)
        got.append([ggx.numpy(), *(a.numpy() for a in gru_weight_grads(ggx, ghn, hall))])
    assert np.array_equal(_bf16_values(got[0][0]), got[0][0])  # ggx leaves as bf16 values
    for name, a, wnt, unrounded in zip(("ggx", "dW_hh", "db_hh"), got[0], want, got[1]):
        assert _rel(a, wnt) <= ROUNDING_REL, (name, _rel(a, wnt))
        assert _rel(unrounded, wnt) > ROUNDING_REL, (name, _rel(unrounded, wnt))


def _bf16_data(rng, shape):
    """`itrx`'s decoder arguments with enc_out and the three weights bf16
    values (as the bf16 step hands them to both kernels)."""
    args = list(_data(rng, *shape))
    for i in (2, 5, 7, 8):  # enc_out, watt, w_ctx, w_hh
        args[i] = _bf16_values(args[i])
    return args


def _port_bf16(args):
    p = _port(args)
    for i in (2, 5, 7, 8):
        p[i] = p[i].to(BF16)
    return p


@pytest.mark.parametrize("shape", SHAPES)
def test_vsrn_dec_plain_bf16_matches_pallas(rng, shape):
    """vsrn_dec_plain at dot_dtype bf16 vs `decoder_seq(...,
    dot_dtype="bfloat16")` in interpret mode: the states within
    ROUNDING_REL (read: 1.3e-7 of scale; without the roundings 1.5e-3 to
    2.4e-3 apart)."""
    args = _bf16_data(rng, shape)
    want = np.asarray(decoder_seq(*[jnp.asarray(a) for a in args], interpret=True,
                                  dot_dtype="bfloat16"))
    got, hall, ghall = kv.vsrn_dec_plain(*_port_bf16(args), dot_dtype=BF16)
    assert _rel(got.numpy(), want) <= ROUNDING_REL
    assert _rel(kv.vsrn_dec_plain(*_port_bf16(args))[0].numpy(), want) > ROUNDING_REL
    np.testing.assert_array_equal(hall[0].numpy(), args[4])


@pytest.mark.parametrize("shape", SHAPES)
def test_vsrn_dec_bwd_plain_bf16_matches_pallas_vjp(rng, shape):
    """vsrn_dec_bwd_plain at dot_dtype bf16, from the plain forward's
    residuals, vs jax.vjp of the interpret-mode kernel at dot_dtype
    "bfloat16": every cotangent within ROUNDING_REL, the same backward
    without the roundings further away; and through the Function the
    wrapper runs for bf16 operands on a CPU tensor."""
    args = _bf16_data(rng, shape)
    g = (rng.standard_normal((shape[0], shape[1], shape[3])) * 0.5).astype(np.float32)
    jargs = [jnp.asarray(a) for a in args]
    _, pull = jax.vjp(lambda *a: decoder_seq(*a, interpret=True, dot_dtype="bfloat16"), *jargs)
    want = [np.asarray(x) for x in pull(jnp.asarray(g))]
    p = _port_bf16(args)
    _, hall, ghall = kv.vsrn_dec_plain(*p, dot_dtype=BF16)
    got, unrounded = (
        _to_itrx([x.float() for x in kv.vsrn_dec_bwd_plain(*p, hall, ghall,
                                                            torch.from_numpy(g),
                                                            dot_dtype=dot)])
        for dot in (BF16, None))
    assert np.array_equal(_bf16_values(got[0]), got[0])  # g_gxw leaves as bf16 values
    for name, a, w, u in zip(NAMES, got, want, unrounded):
        if name == "cmask":
            assert not a.any()
            continue
        assert _rel(a, w) <= ROUNDING_REL, (name, _rel(a, w))
        assert _rel(u, w) > ROUNDING_REL, (name, _rel(u, w))

    # the wrapper on bf16 operands: the bf16 mode's Function, hs in gxw's dtype
    leaves = [a.detach().clone().requires_grad_(i != 1) for i, a in enumerate(p)]
    hs = kv.vsrn_dec_fused(*leaves)
    assert hs.dtype == torch.float32
    hs.backward(torch.from_numpy(g))
    for i, (name, w) in enumerate(zip(NAMES, want)):
        if name == "cmask":
            continue
        assert leaves[i].grad.dtype == leaves[i].dtype, name
        a = _to_itrx([leaves[j].grad.float() if j == i else torch.zeros(1)
                      for j in range(len(leaves))])[i]
        # a bf16 operand's cotangent comes back in bf16, as `itrx`'s cast
        # transpose rounds it: one bf16 step of its largest entry
        limit = 2.0 ** -7 if leaves[i].dtype == BF16 else ROUNDING_REL
        assert _rel(a, w) <= limit, (name, _rel(a, w))


def test_vsrn_dec_fused_casts_bf16_operands_and_returns_their_dtype(rng):
    """Under train_bf16 the model hands the wrapper every operand in bf16:
    it runs the bf16 mode (the same states as the plain pair at bf16 dot on
    the fp32 values of the bf16 operands) and returns the states in bf16."""
    args = _bf16_data(rng, SHAPES[1])
    p = [a.to(BF16) for a in _port_bf16(args)]
    p[1] = p[1].float()  # the dropout mask stays fp32, as the model draws it
    with torch.no_grad():
        hs = kv.vsrn_dec_fused(*p)
    assert hs.dtype == BF16
    f32 = [a.float() if a.dtype == BF16 else a for a in p]
    for i in (2, 5, 7, 8):
        f32[i] = p[i]
    want = kv.vsrn_dec_plain(*f32, dot_dtype=BF16)[0]
    assert torch.equal(hs, want.to(BF16))


@pytest.mark.parametrize("hidden", [96, 512, 768, 960, 1024])
def test_vsrn_dec_bf16_plans_hold_half_the_fragment_bytes(hidden):
    """The decoder loops' plans in the bf16 mode: the fragments are the
    bf16 weights alone, half the split layout's bytes, so both loops keep
    them resident up to the kernels' H 1024 (the fp32 mode streams the
    backward's past H 768 and the forward's Wctx past H 960), within the
    227 KB an H100 block may take beside each loop's static shared memory;
    blocks and halves as the fp32 mode's."""
    for fn, static in ((kv.fwd_plan, kv.FWD_STATIC_SMEM), (kv.plan, kv.LOOP_STATIC_SMEM)):
        p32, p16 = fn(128, 36, hidden), fn(128, 36, hidden, bf16=True)
        assert p16.route == "resident" and p16.smem <= kv.MAX_SMEM - static
        assert (p16.blocks, p16.halves) == (p32.blocks, p32.halves)
        if p32.route == "resident":
            assert p16.smem * 2 == p32.smem
    assert kv.plan(128, 36, 1024).route == kv.fwd_plan(128, 36, 1024).route == "streamed"


def test_vsrn_dec_bf16_fragments_are_the_split_layouts_hi_half(rng):
    """fwd_weights and loop_weights in the bf16 mode: for bf16 weights, the
    hi half of the split layout (whose lo half is then zero), as 8 bytes a
    lane (fragment registers b0, b1)."""
    hd, groups = 24, 3
    w = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(BF16).float()
         for s in ((hd, hd), (3 * hd, hd), (3 * hd, hd))]
    k1, k4 = 64, 128
    for split, alone in ((kv.fwd_weights(*w, k1, groups), kv.fwd_weights(*w, k1, groups, True)),
                         (kv.loop_weights(*w, k1, k4, groups),
                          kv.loop_weights(*w, k1, k4, groups, True))):
        for s, a in zip(split, alone):
            assert a.shape == s.shape[:-2] + (1, 4) and a.dtype == BF16
            assert torch.equal(a[..., 0, :], s[..., 0, :])
            assert not s[..., 1, :].float().any()
