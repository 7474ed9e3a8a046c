"""The port's training pieces vs the JAX package on the CPU: GRU gradients
(the custom VJP with its plain bodies), the hinge loss, SCAN.loss and its
gradients, optimizer steps and the learning-rate schedule.  The same numpy
inputs go through both packages; each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itrx.models import get_model as jget_model
from itrx.ops import losses as jlosses
from itrx.ops import rnn as jrnn
from itrx.ops.pallas import gru as jgru
from itrx.train import loop as jloop
from itrx.train import state as jstate
from itrx_torch.models import get_model
from itrx_torch.ops.kernels.gru import _GRUSeq, gru_scan_fused, gru_weight_grads
from itrx_torch.ops.losses import contrastive_hinge
from itrx_torch.ops.rnn import gru_bwd_plain, gru_fwd_plain
from itrx_torch.train.loop import make_train_step
from itrx_torch.train.state import create_train_state, step_decay_schedule
from itrx_torch.utils.convert import from_itrx_variables

torch.set_num_threads(1)

VOCAB = 50
# GRU gradients: the tolerances of tests/test_pallas_gru.py (fp32; the
# frameworks sum the L-step adjoint in different orders)
GRU_GRAD_ATOL, GRU_GRAD_RTOL = 3e-4, 2e-4


def _gru_inputs(rng, b, l, d=32, h=128):
    k = 1.0 / np.sqrt(h)
    w = [rng.uniform(-k, k, s).astype(np.float32)
         for s in ((3 * h, d), (3 * h, h), (3 * h,), (3 * h,))]
    x = rng.standard_normal((b, l, d)).astype(np.float32)
    lengths = rng.integers(1, l + 1, b)
    lengths[0], lengths[-1] = 1, l
    mask = (np.arange(l)[None] < lengths[:, None]).astype(np.float32)
    return x, mask, w


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,l", [(8, 10), (5, 1)])
def test_gru_grads_match_jax(rng, reverse, b, l):
    """dx, dW_ih, dW_hh, db_ih, db_hh of the port's gru_scan_fused (the
    Function with its plain bodies) vs jax.grad through the interpret-mode
    Pallas VJP and through itrx.ops.rnn.gru_scan."""
    x, mask, w = _gru_inputs(rng, b, l)
    g_out = rng.standard_normal((b, l, 128)).astype(np.float32)
    g_fin = rng.standard_normal((b, 128)).astype(np.float32)

    ps = [torch.from_numpy(a).requires_grad_() for a in [x] + w]
    outs, final = gru_scan_fused(ps[0], torch.from_numpy(mask), *ps[1:], reverse=reverse)
    loss = (outs * torch.from_numpy(g_out)).sum() + (final * torch.from_numpy(g_fin)).sum()
    got = torch.autograd.grad(loss, ps)

    def jloss(fn, **kw):
        def f(*args):
            o, h = fn(args[0], jnp.asarray(mask), *args[1:], reverse=reverse, **kw)
            return jnp.sum(o * g_out) + jnp.sum(h * g_fin)
        return f

    args = [jnp.asarray(a) for a in [x] + w]
    for want in (
        jax.grad(jloss(jgru.gru_scan_fused, interpret=True, dot_dtype="float32"),
                 argnums=(0, 1, 2, 3, 4))(*args),
        jax.grad(jloss(jrnn.gru_scan), argnums=(0, 1, 2, 3, 4))(*args),
    ):
        for name, g, wnt in zip(("dx", "dW_ih", "dW_hh", "db_ih", "db_hh"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=GRU_GRAD_ATOL,
                                       rtol=GRU_GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cotangents", ["outs+final", "outs", "final"])
def test_gru_bwd_plain_matches_pallas_vjp(rng, reverse, cotangents):
    """gru_bwd_plain and the weight-gradient matmuls vs jax.vjp of
    itrx.ops.pallas.gru._gru_seq (interpret mode, fp32 dots) from the same
    cotangents; a missing cotangent is None on the port's side and zero on
    the JAX side.  Also: the residuals of gru_fwd_plain are the forward's."""
    b, l, h = 8, 9, 128
    x, mask, w = _gru_inputs(rng, b, l)
    gx = (x @ w[0].T + w[2]).astype(np.float32)  # (B, L, 3H)
    g_out = rng.standard_normal((b, l, h)).astype(np.float32)
    g_fin = rng.standard_normal((b, h)).astype(np.float32)
    if cotangents == "outs":
        g_fin = np.zeros_like(g_fin)
    if cotangents == "final":
        g_out = np.zeros_like(g_out)

    jgx = jnp.asarray(gx.transpose(1, 0, 2))
    jm = jnp.asarray(mask.T[:, :, None])
    (jouts, jfin), vjp = jax.vjp(
        lambda a, wh, bh: jgru._gru_seq(a, jm, wh, bh, reverse, True, "float32"),
        jgx, jnp.asarray(w[1]), jnp.asarray(w[3]),
    )
    want_dgx, want_dwhh, want_dbhh = vjp((jnp.asarray(g_out.transpose(1, 0, 2)),
                                          jnp.asarray(g_fin)))

    t = torch.from_numpy
    outs, final, hall, ghall = gru_fwd_plain(t(gx), t(mask), t(w[1]), t(w[3]), reverse)
    np.testing.assert_allclose(outs.numpy(), np.asarray(jouts).transpose(1, 0, 2), atol=2e-5)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfin), atol=2e-5)
    ggx, ghn, _ = gru_bwd_plain(
        t(gx), t(mask), hall, ghall,
        None if cotangents == "final" else t(g_out),
        None if cotangents == "outs" else t(g_fin), t(w[1]), reverse,
    )
    d_whh, d_bhh = gru_weight_grads(ggx, ghn, hall)
    kw = dict(atol=GRU_GRAD_ATOL, rtol=GRU_GRAD_RTOL)
    np.testing.assert_allclose(ggx.numpy(), np.asarray(want_dgx).transpose(1, 0, 2), **kw)
    np.testing.assert_allclose(d_whh.numpy(), np.asarray(want_dwhh), **kw)
    np.testing.assert_allclose(d_bhh.numpy(), np.asarray(want_dbhh), **kw)


def test_gru_bwd_plain_carry_gradient_is_the_initial_state_gradient(rng):
    """The carry gradient gru_bwd_plain ends with is d loss / d h0, checked
    against autograd through the same recurrence written out from a free h0
    (fp64, to 1e-10)."""
    b, l, h = 4, 5, 8
    gx = torch.from_numpy(rng.standard_normal((b, l, 3 * h)))
    w_hh = torch.from_numpy(rng.standard_normal((3 * h, h)) * 0.3)
    b_hh = torch.from_numpy(rng.standard_normal(3 * h) * 0.3)
    mask = torch.ones(b, l, dtype=torch.float64)
    mask[0, 3:] = 0
    g_out = torch.from_numpy(rng.standard_normal((b, l, h)))
    _, _, hall, ghall = gru_fwd_plain(gx, mask, w_hh, b_hh)
    _, _, g_h0 = gru_bwd_plain(gx, mask, hall, ghall, g_out, None, w_hh)

    def loss_from_h0(h0):
        hh = h0
        total = 0.0
        for t in range(l):
            gh = hh @ w_hh.t() + b_hh
            xr, xz, xn = gx[:, t].chunk(3, -1)
            hr, hz, hn = gh.chunk(3, -1)
            r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h_new = (1 - z) * n + z * hh
            m = mask[:, t, None]
            total = total + (m * h_new * g_out[:, t]).sum()
            hh = m * h_new + (1 - m) * hh
        return total

    h0 = torch.zeros(b, h, dtype=torch.float64, requires_grad=True)
    (want,) = torch.autograd.grad(loss_from_h0(h0), h0)
    np.testing.assert_allclose(g_h0.numpy(), want.numpy(), atol=1e-10)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_function_gradcheck_float64(reverse):
    g = torch.Generator().manual_seed(0)
    b, l, h = 4, 3, 5
    gx = torch.randn(b, l, 3 * h, generator=g, dtype=torch.float64, requires_grad=True)
    w_hh = (torch.randn(3 * h, h, generator=g, dtype=torch.float64) * 0.3).requires_grad_()
    b_hh = (torch.randn(3 * h, generator=g, dtype=torch.float64) * 0.3).requires_grad_()
    mask = (torch.arange(l)[None] < torch.tensor([1, 3, 2, 3])[:, None]).double()
    assert torch.autograd.gradcheck(
        lambda a, wh, bh: _GRUSeq.apply(a, mask, wh, bh, reverse), (gx, w_hh, b_hh))


@pytest.mark.parametrize("max_violation", [False, True])
def test_contrastive_hinge_matches_jax(rng, max_violation):
    """Values and gradients, fp32, atol 1e-5 (sums of ~100 terms)."""
    s = rng.standard_normal((7, 7)).astype(np.float32) * 0.3
    st = torch.from_numpy(s).requires_grad_()
    got = contrastive_hinge(st, 0.2, max_violation)
    (g,) = torch.autograd.grad(got, st)
    want, jg = jax.value_and_grad(
        lambda a: jlosses.contrastive_hinge(a, 0.2, max_violation))(jnp.asarray(s))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6)
    bf = contrastive_hinge(st.detach().to(torch.bfloat16), 0.2, max_violation)
    assert bf.dtype == torch.float32


def _cfg(bi_gru, **kw):
    cfg = dict(
        name="SCAN", vocab_size=VOCAB, img_dim=48, embed_size=128, word_dim=32,
        bi_gru=bi_gru, no_imgnorm=False, no_txtnorm=True,
        precomp_enc_type="basic", margin=0.2, max_violation=True,
        cross_attn="t2i", raw_feature_norm="clipped_l2norm",
        agg_func="LogSumExp", lambda_lse=6.0, lambda_softmax=9.0,
        learning_rate=1e-3, lr_update=1, grad_clip=2.0, seed=0,
    )
    cfg.update(kw)
    return cfg


def _batch(rng, b=6, r=36, l=10):
    lengths = rng.integers(1, l + 1, b)
    lengths[0] = l
    mask = (np.arange(l)[None] < lengths[:, None]).astype(np.float32)
    return {
        "images": rng.standard_normal((b, r, 48)).astype(np.float32),
        "cap_ids": (rng.integers(1, VOCAB, (b, l)) * mask).astype(np.int32),
        "cap_mask": mask,
    }


def _pair(rng, cfg):
    """(JAX model, JAX variables as numpy, port model with the same weights)."""
    jmodel = jget_model(cfg)
    jb = {k: jnp.asarray(v) for k, v in _batch(rng).items()}
    variables = jax.device_get(
        jmodel.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                    jb, train=False))
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in from_itrx_variables(variables).items()})
    return jmodel, variables, model


def _port_grads(model):
    return {k: p.grad.numpy() for k, p in model.named_parameters()}


@pytest.mark.parametrize("bi_gru", [False, True])
@pytest.mark.parametrize("max_violation", [False, True])
def test_scan_loss_and_grads_match_jax(rng, bi_gru, max_violation):
    """SCAN.loss (train=True: plain similarity, hinge) and every parameter's
    gradient from converted weights.  Loss rtol 1e-5; gradients within
    1e-4 of each tensor's largest entry (fp32 through the attention chain,
    whose softmax at lambda 9 and LogSumExp at lambda 6 amplify the two
    frameworks' summation-order differences: measured up to 1.7e-5)."""
    cfg = _cfg(bi_gru, max_violation=max_violation)
    jmodel, variables, model = _pair(rng, cfg)
    batch = _batch(rng)
    loss, aux = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert aux["Loss"] is loss

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, _), jg = jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, jb, train=True, method="loss"),
        has_aux=True)(variables["params"])
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = from_itrx_variables({"params": jax.device_get(jg)})
    got = _port_grads(model)
    assert set(got) == set(want)
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], atol=1e-4 * scale, err_msg=k)


# per number of updates: (well-conditioned gradient threshold, as a share
# of the tensor's largest entry in every step; tight limit, in units of lr)
STEP_LIMITS = {1: (1e-4, 1e-3), 3: (1e-2, 1e-2)}


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(rng, n_steps):
    """Weights after 1 and 3 updates of make_train_step vs
    itrx.train.loop.make_train_step from the same weights and batches
    (steps_per_epoch 2, lr_update 1: the third update runs at lr / 10).

    Adam's first update is lr * g / (|g| + eps): for |g| far above the two
    frameworks' gradient difference (~1e-5 of the tensor's largest entry)
    it is lr * sign(g) on both sides, but where |g| is near that difference
    two correct updates may differ by up to 2 lr per step.  So only entries
    whose gradient stayed above a share of its tensor's largest entry in
    every step are held to a tight limit (STEP_LIMITS; after 3 steps the
    loose entries of the first update have perturbed the later gradients,
    measured up to 3.7e-3 lr on the entries above 1e-2), and every entry to
    2 lr per step (measured: 0.18 lr after 3 steps).  The optimizer alone is
    held to optax without that slack in test_optimizer_matches_optax."""
    _check_train_steps(rng, _cfg(True), n_steps)


def test_i2t_train_step_matches_jax(rng):
    """One update of SCAN i-t AVG (cross_attn i2t, Mean, lambda_softmax 4;
    the plain i2t similarity under autograd) against the JAX package's
    make_train_step, at the limits of test_train_steps_match_jax."""
    _check_train_steps(rng, _cfg(True, cross_attn="i2t", agg_func="Mean",
                                 lambda_softmax=4.0), 1)


def _check_train_steps(rng, cfg, n_steps):
    lr = cfg["learning_rate"]
    thr, tight = STEP_LIMITS[n_steps]
    jmodel, variables, model = _pair(rng, cfg)
    batches = [_batch(rng) for _ in range(n_steps)]

    jst, tx = jstate.create_train_state(
        jmodel, cfg, {k: jnp.asarray(v) for k, v in batches[0].items()}, steps_per_epoch=2)
    jst = jst.replace(params=jax.tree.map(jnp.asarray, variables["params"]))
    jstep = jloop.make_train_step(jmodel, tx)
    rng_key = jax.random.PRNGKey(0)
    for b in batches:
        jst, _ = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()}, rng_key, 0)

    state = create_train_state(model, cfg, steps_per_epoch=2)
    step = make_train_step(state)
    well_conditioned = {k: True for k, _ in model.named_parameters()}
    for i, b in enumerate(batches):
        aux = step({k: torch.from_numpy(v) for k, v in b.items()}, log=True)
        assert set(aux) == {"Loss"} and np.isfinite(aux["Loss"])
        assert state.step == i + 1
        for k, g in _port_grads(model).items():
            well_conditioned[k] = well_conditioned[k] & (np.abs(g) > thr * np.abs(g).max())
    assert int(jst.step) == n_steps
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
        lr * (0.1 if n_steps == 3 else 1.0))

    want = from_itrx_variables({"params": jax.device_get(jst.params)})
    got = {k: p.detach().numpy() for k, p in model.named_parameters()}
    for k in want:
        diff = np.abs(got[k] - want[k])
        wc = well_conditioned[k]
        assert wc.any(), k
        assert diff[wc].max() <= tight * lr, (k, diff[wc].max() / lr)
        assert diff.max() <= 2 * lr * n_steps, (k, diff.max() / lr)


def test_optimizer_matches_optax(rng):
    """TrainState.apply_gradients (clip_grad_norm_, step-decay rate, Adam)
    vs itrx.train.state.make_optimizer on one gradient sequence: the clip
    active in some steps and not in others, exact zeros, entries near Adam's
    eps, and the rate decaying after the second update.  The two clips
    differ by a relative 1e-6 / norm (max_norm / (norm + 1e-6) against
    max_norm / norm), which Adam's scale invariance all but cancels; the
    weights agree to 1e-4 lr (1e-6 here: a few fp32 ulps of weights of
    magnitude 1-2, from the two frameworks' differently ordered update
    arithmetic; measured 1.8e-7)."""
    cfg = dict(learning_rate=1e-2, lr_update=1, grad_clip=2.0)
    w0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = []
    for scale in (3.0, 0.1, 5.0, 0.5):
        g = (rng.standard_normal((5, 7)) * scale).astype(np.float32)
        g[0, :3] = 0.0
        g[1, :3] = np.float32(3e-8) * np.sign(g[1, :3])
        grads.append(g)

    tx = jstate.make_optimizer(cfg, steps_per_epoch=2)
    jp = {"w": jnp.asarray(w0)}
    opt_state = tx.init(jp)
    for g in grads:
        updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state, jp)
        jp = {"w": jp["w"] + updates["w"]}

    model = torch.nn.Linear(7, 5, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(w0))
    state = create_train_state(model, cfg, steps_per_epoch=2)
    for g in grads:
        model.weight.grad = torch.from_numpy(g.copy())
        state.apply_gradients()
    assert state.step == len(grads)
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(cfg["learning_rate"] * 0.1)
    np.testing.assert_allclose(model.weight.detach().numpy(), np.asarray(jp["w"]),
                               atol=1e-4 * cfg["learning_rate"], rtol=0)


def test_step_decay_schedule_matches_jax():
    want = jstate.step_decay_schedule(2e-4, steps_per_epoch=100, lr_update=15)
    got = step_decay_schedule(2e-4, steps_per_epoch=100, lr_update=15)
    for count in (0, 1, 99, 100, 1499, 1500, 2999, 3000, 4600):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6), count
    assert step_decay_schedule(1.0, steps_per_epoch=0, lr_update=1)(3) == pytest.approx(1e-3)
