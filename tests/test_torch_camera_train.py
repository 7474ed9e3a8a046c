"""The port's CAMERA training vs the JAX package on the CPU at small widths
(tests/test_torch_camera.py's tiny BERT, embed 64, 4 heads so d_k 16,
smry_k 3, 12 regions, a batch of 6 with ragged caption masks), weights
carried JAX -> port with every BatchNorm moved off its init: the AGSA
backward's plain version against `itrx`'s interpret-mode Pallas VJP
(`_bwd_kernel`), the autograd Function's CPU route, the diversity term,
CAMERA.loss with every gradient, one and three make_train_step updates
(BERT frozen: no gradient, no Adam state, untouched), and a tiny `fit` with
resume, evalrank_single and a port checkpoint through the JAX
evalrank_single.  Inputs come from numpy with a seed."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itrx.eval.engine import evalrank_single as jevalrank_single
from itrx.models import get_model as jget_model
from itrx.ops import losses as jlosses
from itrx.ops.pallas.agsa_attn import agsa_attention as jagsa_attention
from itrx.train import loop as jloop
from itrx.train import state as jstate
from itrx.utils.ref_convert import convert_reference_checkpoint
from itrx_torch.configs import parse_cli
from itrx_torch.data import synthetic
from itrx_torch.eval.engine import evalrank_single
from itrx_torch.models import get_model
from itrx_torch.ops.kernels import agsa_attn
from itrx_torch.ops.losses import diversity_regularization
from itrx_torch.train.loop import fit, make_train_step
from itrx_torch.train.state import create_train_state
from itrx_torch.utils.checkpoint import load_checkpoint
from itrx_torch.utils.convert import from_itrx_variables
from tests.test_torch_camera import (BERT, IMG, R, _heads, _kernel_data, _np, _port_weights, _t,
                                     bert_config_file, camera_batch, camera_cfg, jax_variables,
                                     port_model)

torch.set_num_threads(1)

SMRY_K = 3
GRAD_NAMES = ("dq", "dk", "dv", "dWq", "dbq", "dWk", "dbk", "dWg1", "dbg1", "dWg2", "dbg2")
# the plain backward vs `itrx`'s interpret-mode VJP, fp32, per cotangent
# max|diff| over the larger of its largest entry and 1e-3 of the eleven's
# largest: the same arithmetic in another summation order (tighter than
# tests/test_pallas_agsa.py's 5e-5 / 1e-3 against the XLA chain)
BWD_REL = 1e-5
# bf16: both sides round q, k, v, the weights and g_out to bf16 and round at
# the kernel's points; an intermediate on a rounding boundary may round
# apart, and `itrx` returns the weight cotangents in the weights' bf16, so
# each cotangent may sit one bf16 step (2^-8 of its scale) apart
BWD_BF16_REL = 2.0 ** -8
# one step: the loss relative, and each gradient and running statistic
# within this share of its tensor's largest entry, as the other methods'
# steps are held
LOSS_REL = 1e-5
REL = 1e-4
# biases whose gradient is zero in exact arithmetic: the value projection's
# (softmax rows sum to 1, so it shifts every output row alike) and the text
# tower's fc2 (the same shift), each before a train-mode BatchNorm, whose
# batch mean takes it out; held to rounding noise, this share of the model's
# largest gradient entry, on both sides
ZERO_GRADS = ("img_enc.agsa.att_layers.0.linears.2.bias",
              "txt_enc.agsa.att_layers.0.linears.2.bias", "txt_enc.fc2.bias")
ZERO_REL = 1e-5
# three updates: the losses, as tests/test_torch_vsrn_train.py's
STEPS_LOSS_REL = 1e-3
# per number of updates: (well-conditioned gradient threshold, as a share of
# the tensor's largest entry in every step; tight limit in units of lr), as
# tests/test_torch_train.py::test_train_steps_match_jax explains
STEP_LIMITS = {1: (1e-4, 1e-3), 3: (1e-2, 1e-2)}
# every entry of a trained tensor, in lr per update: near Adam's eps an
# update turns with its gradient's last digits (measured at most 5.3e-2 lr
# after one update and 7.2e-2 after three, the summarization's conv weights,
# whose clipped gradients are ~1e-4; the rest <= 7e-3)
LOOSE = 0.1


def _cfg(bert_file: str, **kw) -> dict:
    return camera_cfg(bert_file, smry_k=SMRY_K, learning_rate=1e-4, grad_clip=2.0,
                      lr_update=1, seed=0, **kw)


@pytest.fixture(scope="module")
def camera_init(tmp_path_factory):
    """(cfg, `itrx`'s variables as numpy, BatchNorms perturbed)."""
    cfg = _cfg(bert_config_file(tmp_path_factory.mktemp("camera_train") / "bert.json"))
    return cfg, jax_variables(cfg, camera_batch(np.random.default_rng(21)), seed=4)


def _rel(got, want, floor=0.0) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), floor))


# -- the AGSA backward ---------------------------------------------------


def _jax_vjp(q, k, v, w, cot, h, dtype):
    """`itrx`'s agsa_attention VJP in interpret mode (its `_bwd_kernel`),
    cotangents in the port's layouts as fp32 numpy."""
    jq, jk, jv = (jnp.asarray(_heads(x, h), dtype) for x in (q, k, v))
    jw = [jnp.asarray(a, dtype) for a in w]
    _, vjp = jax.vjp(lambda *a: jagsa_attention(*a, True), jq, jk, jv, *jw)
    got = vjp(jnp.asarray(_heads(cot, h), dtype))
    b, _, n, dk = jq.shape
    out = [np.asarray(g, np.float32).transpose(0, 2, 1, 3).reshape(b, n, h * dk)
           for g in got[:3]]
    return out + [np.asarray(g, np.float32).T for g in got[3:]]


@pytest.mark.parametrize("n,dk", [(7, 8), (7, 16), (36, 16)])
def test_bwd_plain_matches_pallas_vjp(n, dk):
    """agsa_attention_bwd_plain vs jax.vjp of `itrx`'s agsa_attention in
    interpret mode (its `_bwd_kernel`): dq, dk, dv and the eight weight and
    bias cotangents (the port's (out, in) weights against `itrx`'s (in,
    out)), fp32, at a ragged N 7 and at 36 regions, d_k 8 and 16, B not a
    multiple of the Pallas backward's block."""
    b, h = 5, 3
    rng = np.random.default_rng(n * 10 + dk)
    (q, k, v), w = _kernel_data(rng, b, h, n, dk)
    cot = rng.standard_normal((b, n, h * dk)).astype(np.float32)
    want = _jax_vjp(q, k, v, w, cot, h, jnp.float32)
    got = agsa_attn.agsa_attention_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                             *_port_weights(w), torch.from_numpy(cot), h)
    floor = 1e-3 * max(np.abs(x).max() for x in want)
    for name, g, x in zip(GRAD_NAMES, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == x.shape, name
        assert _rel(g.numpy(), x, floor) <= BWD_REL, (name, _rel(g.numpy(), x, floor))


@pytest.mark.parametrize("n,dk", [(7, 8), (7, 16)])
def test_bwd_plain_bf16_matches_pallas_vjp(n, dk):
    """The same in bf16 (q, k, v, weights and g_out bf16 on both sides): dq,
    dk, dv in bf16, the weight cotangents in fp32, each within one bf16 step
    of its scale of `itrx`'s."""
    b, h = 5, 3
    rng = np.random.default_rng(n * 10 + dk + 1)
    (q, k, v), w = _kernel_data(rng, b, h, n, dk)
    cot = rng.standard_normal((b, n, h * dk)).astype(np.float32)
    want = _jax_vjp(q, k, v, w, cot, h, jnp.bfloat16)
    bf = torch.bfloat16
    got = agsa_attn.agsa_attention_bwd_plain(
        *(torch.from_numpy(x).to(bf) for x in (q, k, v)), *_port_weights(w, bf),
        torch.from_numpy(cot).to(bf), h)
    assert [g.dtype for g in got] == [bf] * 3 + [torch.float32] * 8
    for name, g, x in zip(GRAD_NAMES, got, want):
        assert _rel(g.float().numpy(), x) <= BWD_BF16_REL, (name, _rel(g.float().numpy(), x))


def test_function_cpu_route_matches_autograd_and_gradchecks():
    """agsa_attention_fused on CPU tensors that need a gradient goes through
    the autograd Function, whose plain bodies give autograd's gradients
    through agsa_attention_plain (all eleven, fp32), count no launch, and
    pass gradcheck in float64."""
    rng = np.random.default_rng(3)
    (q, k, v), w = _kernel_data(rng, 4, 2, 7, 8)
    fused = agsa_attn.agsa_attention_fused
    before = fused.launches, agsa_attn.agsa_attention_bwd_fused.launches
    args = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    args += [t.requires_grad_() for t in _port_weights(w)]
    cot = torch.from_numpy(rng.standard_normal((4, 7, 16)).astype(np.float32))
    out = fused(*args, 2)
    want_out = agsa_attn.agsa_attention_plain(*args, 2)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    got = torch.autograd.grad(out, args, cot)
    want = torch.autograd.grad(want_out, args, cot)
    for name, g, x in zip(GRAD_NAMES, got, want):
        torch.testing.assert_close(g, x, rtol=1e-5, atol=1e-6, msg=name)
    assert (fused.launches, agsa_attn.agsa_attention_bwd_fused.launches) == before
    d64 = [a.detach().double().requires_grad_() for a in args]
    d64 = [x[:2, :5, :] if i < 3 else x for i, x in enumerate(d64)]
    d64 = [x.detach().requires_grad_() for x in d64]
    assert torch.autograd.gradcheck(lambda *a: fused(*a, 2), d64)


def test_diversity_regularization_matches_itrx():
    """diversity_regularization vs `itrx`'s, fp32, with an all-zero view
    column (its clamped norm leaves the column zero, no NaN), and its
    gradient on a batch without one."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, R, SMRY_K)).astype(np.float32)
    x[1, :, 2] = 0.0
    got = float(diversity_regularization(torch.from_numpy(x)))
    want = float(jlosses.diversity_regularization(jnp.asarray(x)))
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-6)
    y = torch.from_numpy(rng.standard_normal((4, R, SMRY_K)).astype(np.float32))
    y.requires_grad_()
    diversity_regularization(y).backward()
    want_g = jax.grad(jlosses.diversity_regularization)(jnp.asarray(y.detach().numpy()))
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)


# -- CAMERA.loss and its updates -----------------------------------------


def _jax_step(cfg, variables, batch):
    """`itrx`'s train-mode loss, its aux values, and its gradients with the
    updated statistics as a port state dict of numpy arrays."""
    jmodel = jget_model(cfg)

    def f(params):
        out, mut = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                {k: jnp.asarray(v) for k, v in batch.items()}, train=True,
                                rngs={"dropout": jax.random.PRNGKey(5)},
                                mutable=["batch_stats"])
        return out[0], (out[1], mut)

    (loss, (aux, mut)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree.map(jnp.asarray, variables["params"]))
    grads = from_itrx_variables({"params": jax.device_get(grads),
                                 "batch_stats": jax.device_get(mut["batch_stats"])})
    return float(loss), {k: float(v) for k, v in aux.items()}, grads


def test_camera_loss_and_grads_match_jax(camera_init):
    """CAMERA.loss in train mode (the AGSA kernel's Function on the CPU, the
    train-mode BatchNorms, the triplet loss and smry_lamda x the diversity
    term): the loss and its two parts, every trained parameter's gradient
    and every running statistic after the step vs `itrx` (ZERO_GRADS held to
    noise); BERT's parameters take no gradient (`itrx`'s are exactly
    zero)."""
    cfg, variables = camera_init
    batch = camera_batch(np.random.default_rng(3))
    want_loss, want_aux, want = _jax_step(cfg, variables, batch)
    model = port_model(cfg, variables).train()
    loss, aux = model.loss(_t(batch))
    assert sorted(aux) == ["Div_loss", "Loss", "Rank_Loss"]
    loss.backward()
    loss = loss.item()
    assert abs(loss - want_loss) <= LOSS_REL * abs(want_loss), (loss, want_loss)
    for k in ("Rank_Loss", "Div_loss"):
        assert aux[k].item() == pytest.approx(want_aux[k], rel=LOSS_REL), k
    params = dict(model.named_parameters())
    scale = max(float(p.grad.abs().max()) for p in params.values() if p.grad is not None)
    errs, n_bert = {}, 0
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.startswith("txt_enc.bert."):
            if k in params:
                n_bert += 1
                assert params[k].grad is None and not params[k].requires_grad, k
                assert not np.asarray(want[k]).any(), k
            continue
        got = _np(params[k].grad) if k in params else _np(v)
        if k in ZERO_GRADS:
            assert max(np.abs(got).max(), np.abs(want[k]).max()) <= ZERO_REL * scale, k
            continue
        errs[k] = _rel(got, want[k])
    assert n_bert == len(list(model.txt_enc.bert.parameters())) > 0
    assert max(errs.values()) <= REL, sorted(errs.items(), key=lambda kv: kv[1])[-4:]
    # both gated attention layers' gate weights learn
    for tower in ("img_enc", "txt_enc"):
        fc_g = params[f"{tower}.agsa.att_layers.0.fc_g.weight"].grad
        assert float(fc_g.abs().max()) > 0.0


# Adam's eps (optax's and the port's).  The first update of an entry is
# lr g / (|g| + eps) for the clipped gradient g (the clip scales this model's
# by ~2e-2), which moves by lr eps d / (|g| + eps)^2 when g moves by d: for
# the packages' d ~ 1e-9 it stays under 1e-4 lr only where |g| > 100 eps
ADAM_EPS = 1e-8


@pytest.fixture(scope="module")
def camera_steps(camera_init):
    """Three updates of make_train_step (clip, Adam, steps_per_epoch 2 so the
    third runs at lr / 10) in both packages from the same weights,
    statistics and batches: {n: (the port's state dict, `itrx`'s as port
    names, the port's well-conditioned entries)} after n = 1 and 3 updates,
    the losses of both, BERT's weights before, and the port's state."""
    cfg, variables = camera_init
    rng = np.random.default_rng(40)
    batches = [camera_batch(rng) for _ in range(3)]
    jmodel = jget_model(cfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = jstate.make_optimizer(cfg, 2, params)
    jst = jstate.TrainState(params=params,
                            batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                            opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    jstep = jloop.make_train_step(jmodel, tx)
    model = port_model(cfg, variables)
    bert0 = {k: v.clone() for k, v in model.txt_enc.bert.state_dict().items()}
    state = create_train_state(model, cfg, steps_per_epoch=2)
    step = make_train_step(state, cfg["seed"])
    named = dict(model.named_parameters())
    thr = {1: STEP_LIMITS[1][0], 3: STEP_LIMITS[3][0]}
    well = {n: {k: True for k, p in named.items() if p.requires_grad and k not in ZERO_GRADS}
            for n in thr}
    out, losses = {}, ([], [])
    for i, b in enumerate(batches, 1):
        jst, aux = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()},
                         jax.random.PRNGKey(0), 0)
        losses[1].append(float(aux["Loss"]))
        losses[0].append(step(_t(b), log=True)["Loss"])
        for n in thr:
            for k in well[n]:
                # the clipped gradient that reached Adam (the clip scales .grad)
                g = np.abs(_np(named[k].grad))
                well[n][k] = well[n][k] & (g > thr[n] * g.max()) & (g > 100 * ADAM_EPS)
        if i in thr:
            want = from_itrx_variables({"params": jax.device_get(jst.params),
                                        "batch_stats": jax.device_get(jst.batch_stats)})
            sd = {k: _np(v).copy() for k, v in model.state_dict().items()}
            out[i] = (sd, want, {k: m.copy() for k, m in well[i].items()})
            assert state.step == i and int(jst.step) == i
    return out, losses, bert0, state


@pytest.mark.parametrize("n_steps", [1, 3])
def test_camera_train_steps_match_jax(camera_steps, n_steps):
    """Weights and BatchNorm statistics after 1 and 3 updates of
    make_train_step vs `itrx`'s make_train_step from the same weights,
    statistics and batches: the losses; each entry whose clipped gradient
    stayed above STEP_LIMITS' share of its tensor's largest entry and above
    100 x Adam's eps in every step within the tight limit, every entry within
    LOOSE lr a step (ZERO_GRADS' updates follow their noise's sign: 2 lr a
    step); BERT bit-identical after the updates and absent from the
    optimizer (no Adam state), as `itrx` masks it with set_to_zero."""
    out, (got_losses, want_losses), bert0, state = camera_steps
    sd, want, well = out[n_steps]
    lr = state.optimizer.defaults["lr"]
    tight = STEP_LIMITS[n_steps][1]
    np.testing.assert_allclose(got_losses, want_losses, rtol=STEPS_LOSS_REL)
    trained = [p for p in state.model.parameters() if p.requires_grad]
    assert state.optimizer.param_groups[0]["params"] == trained
    assert len(state.optimizer.state) == len(trained)
    assert not any(p.requires_grad for p in state.model.txt_enc.bert.parameters())
    for k, v in bert0.items():
        np.testing.assert_array_equal(sd[f"txt_enc.bert.{k}"], _np(v))
        np.testing.assert_array_equal(want[f"txt_enc.bert.{k}"], _np(v))
    for k, p in state.model.named_parameters():
        if not p.requires_grad:
            continue
        diff = np.abs(sd[k] - want[k])
        loose = 2.0 if k in ZERO_GRADS else LOOSE
        assert diff.max() <= loose * lr * n_steps, (k, diff.max() / lr)
        if k in well and well[k].any():
            assert diff[well[k]].max() <= tight * lr, (k, diff[well[k]].max() / lr)
    # the text tower's gate weights, which the AGSA backward feeds, are held
    # to the tight limit
    assert well["txt_enc.agsa.att_layers.0.fc_g.weight"].any()
    for k, v in sd.items():
        if k.endswith(("running_mean", "running_var")):
            assert _rel(v, want[k]) <= STEPS_LOSS_REL, k


# -- fit ------------------------------------------------------------------


def _fit(root, **kw):
    """A tiny CAMERA fit on the CPU (the AGSA Function's plain bodies): (cfg,
    its arguments, the state, best_rsum)."""
    synthetic.generate(str(root / "f30k_precomp"), n_images=12, img_dim=IMG, n_regions=R,
                       n_concepts_range=(1, 4))
    bert_config_file(root / "bert_config.json")
    synthetic.write_tiny_bert_vocab(str(root / "vocab.txt"))
    args = dict(data_path=str(root), data_name="f30k_precomp", bert_path=str(root),
                img_dim=IMG, embed_size=64, head=4, smry_k=SMRY_K, max_words=10,
                batch_size=12, num_epochs=2, val_step=3, log_step=5, seed=3,
                save_path=f"{root}/runs", **kw)
    cfg = parse_cli(["with", "CAMERA"] + [f"{k}={v}" for k, v in args.items()])
    state, best_rsum = fit(cfg, device="cpu")
    return cfg, args, state, best_rsum


def test_camera_fit_resume_and_evalrank(tmp_path):
    """A tiny CAMERA fit on the CPU (the tiny BERT from `bert_path`): every
    checkpoint holds the two parts with the BatchNorm statistics moved,
    evalrank_single on model_best reproduces best_rsum, the JAX
    evalrank_single ranks the converted checkpoint identically, BERT leaves
    the fit as the seed drew it, and a resume from the last epoch's
    checkpoint restores every weight, statistic and Adam moment bit for
    bit, with no Adam state for BERT."""
    cfg, args, state, best_rsum = _fit(tmp_path)
    assert state.step == 2 * 5
    assert state.model.txt_enc.bert.config.hidden_size == BERT["hidden_size"]
    best = os.path.join(cfg["save_dir"], "model_best.pth.tar")
    ck = load_checkpoint(best)
    assert len(ck["model"]) == 2 and ck["best_rsum"] == pytest.approx(best_rsum)
    assert not torch.equal(ck["model"][0]["agsa.bns.0.running_var"], torch.ones(64))
    assert not torch.equal(ck["model"][1]["bn.running_mean"], torch.zeros(64))
    res = evalrank_single(best, split="dev", device="cpu")
    assert res["rsum"] == pytest.approx(ck["best_rsum"], abs=1e-9)
    out = convert_reference_checkpoint(best, out_path=str(tmp_path / "camera.itrx"))
    want = jevalrank_single(out, split="dev")
    for k in ("i2t_ranks", "t2i_ranks"):
        np.testing.assert_array_equal(res[k], np.asarray(want[k]))

    fresh = parse_cli(["with", "CAMERA"] + [f"{k}={v}" for k, v in args.items()],
                      make_dirs=False)
    seeded = get_model(dict(fresh, vocab_size=cfg["vocab_size"]), device="cpu",
                       generator=torch.Generator().manual_seed(cfg["seed"]))
    for k, v in seeded.txt_enc.bert.state_dict().items():
        torch.testing.assert_close(state.model.txt_enc.bert.state_dict()[k], v, rtol=0, atol=0)

    last = os.path.join(cfg["save_dir"], "epo1_checkpoint.pth.tar")
    # the checkpoint's epoch is run again on resume, as in the JAX package,
    # so num_epochs 1 leaves nothing to train
    args2 = dict(args, resume=last, save_path=f"{tmp_path}/resumed", num_epochs=1)
    cfg2 = parse_cli(["with", "CAMERA"] + [f"{k}={v}" for k, v in args2.items()])
    state2, best2 = fit(cfg2, device="cpu")
    ck = load_checkpoint(last)
    assert state2.step == ck["Eiters"] == 10 and best2 == ck["best_rsum"]
    for name, sd in zip(("img_enc", "txt_enc"), ck["model"]):
        got = getattr(state2.model, name).state_dict()
        assert got.keys() == sd.keys()
        for k, v in sd.items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    opt = state2.optimizer.state_dict()["state"]
    trained = [p for p in state2.model.parameters() if p.requires_grad]
    assert len(opt) == len(ck["opt"]["state"]) == len(trained)
    assert len(trained) < len(list(state2.model.parameters()))
    for i, s in ck["opt"]["state"].items():
        for k, v in s.items():
            torch.testing.assert_close(opt[i][k], v, rtol=0, atol=0)
