"""The port's VSRN training vs the JAX package on the CPU at small widths
(embed 64, dim_hidden 32, 6 regions, max_len 8, a batch of 6 with ragged
label masks), weights carried JAX -> port with the RsGCN blocks moved off
the identity (tests/test_torch_vsrn.py::_perturb): one train-mode step
(loss, every gradient, every running statistic) and three steps of
make_train_step vs `itrx`'s, at input_dropout_p 0 (the two packages' random
streams differ); the new dropouts' rate, eval identity and seeding; and a
tiny `fit` with checkpoints (the caption model third), evalrank_single and
resume."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itrx.configs import parse_cli
from itrx.data import synthetic
from itrx.models import get_model as jget_model
from itrx.train import loop as jloop
from itrx.train import state as jstate
from itrx_torch.eval.engine import evalrank_single
from itrx_torch.models import get_model
from itrx_torch.models.layers import SeededDropout
from itrx_torch.train.loop import fit, make_train_step
from itrx_torch.train.state import create_train_state
from itrx_torch.utils.checkpoint import load_checkpoint
from itrx_torch.utils.convert import from_itrx_variables
from tests.test_torch_vsrn import HD, MAX_LEN, _batch, _cfg, _init, _port, _t

torch.set_num_threads(1)

# one step: the loss relative, and each gradient and running statistic within
# this share of its tensor's largest entry, as SCAN.loss's test holds them
# (measured: the loss equal, at most 1.1e-5, linear1's bias)
LOSS_REL = 1e-5
REL = 1e-4
# three steps: Adam's first update is lr * sign(g) for |g| far above the
# packages' difference, but up to 2 lr apart near it (see
# tests/test_torch_train.py::test_train_steps_match_jax)
STEPS_LOSS_REL = 1e-3
# each RsGCN block's W.0 bias feeds a train-mode BatchNorm, whose batch mean
# takes it out: zero gradient in exact arithmetic, held to rounding noise
# (this share of the model's largest gradient entry) on both sides
ZERO_GRADS = tuple(f"img_enc.Rs_GCN_{i}.W.0.bias" for i in range(1, 5))
ZERO_REL = 1e-5


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def vsrn_init():
    cfg = _cfg()
    return cfg, _init(cfg, _batch(np.random.default_rng(31)), seed=7)


def _jax_step(cfg, variables, batch):
    """`itrx`'s train-mode loss, its gradients and the updated statistics,
    as a port state dict of numpy arrays (gradients under the parameters'
    names)."""
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


def test_vsrn_step_matches_jax(vsrn_init):
    """One VSRN step at max_violation (hinge + the caption decoder's NLL):
    the loss and its two parts, every parameter's gradient (the RsGCN
    blocks', the decoder's; att_w1's encoder half and vid2hid see the
    kernel's g_enc_att and g_enc_out) and every running statistic after it
    vs `itrx`."""
    cfg, variables = vsrn_init
    batch = _batch(np.random.default_rng(3))
    want_loss, want_aux, want = _jax_step(cfg, variables, batch)
    model = _port(cfg, variables).train()
    loss, aux = model.loss(_t(batch))
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - want_loss) <= LOSS_REL * abs(want_loss), (loss, want_loss)
    for k in ("Loss_retrieval", "Loss_caption"):
        assert float(aux[k].detach()) == pytest.approx(want_aux[k], rel=LOSS_REL), k
    params = dict(model.named_parameters())
    scale = max(float(p.grad.abs().max()) for p in params.values())
    errs = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        got = _np(params[k].grad) if k in params else _np(v)
        if k in ZERO_GRADS:
            assert max(np.abs(got).max(), np.abs(want[k]).max()) <= ZERO_REL * scale, k
            continue
        errs[k] = float(np.abs(got - want[k]).max() / np.abs(want[k]).max())
    assert max(errs.values()) <= REL, sorted(errs.items(), key=lambda kv: kv[1])[-4:]
    # the RsGCN blocks are off the identity: their weights learn
    assert float(params["img_enc.Rs_GCN_1.theta.weight"].grad.abs().max()) > 1e-3 * scale
    # the encoder half of linear1 sees g_enc_att, vid2hid g_enc_att and g_enc_out
    w1 = params["caption_model.decoder.attention.linear1.weight"].grad
    assert float(w1[:, :HD].abs().max()) > 0.0
    assert float(params["caption_model.encoder.vid2hid.weight"].grad.abs().max()) > 0.0


def test_vsrn_train_steps_match_jax(vsrn_init):
    """Three updates of make_train_step (clip, Adam, steps_per_epoch 2 so
    the third runs at lr / 10) vs `itrx`'s from the same weights,
    statistics and batches: the three losses and the f30k BatchNorm's
    running variance."""
    cfg, variables = vsrn_init
    cfg = dict(cfg, learning_rate=2e-4, grad_clip=2.0, lr_update=1, seed=0)
    rng = np.random.default_rng(4)
    batches = [_batch(rng) for _ in range(3)]
    jmodel = jget_model(cfg)
    jst, tx = jstate.create_train_state(
        jmodel, cfg, {k: jnp.asarray(v) for k, v in batches[0].items()}, steps_per_epoch=2)
    jst = jst.replace(params=jax.tree.map(jnp.asarray, variables["params"]),
                      batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
    jstep = jloop.make_train_step(jmodel, tx)
    want = []
    for b in batches:
        jst, aux = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()},
                         jax.random.PRNGKey(0), 0)
        want.append(float(aux["Loss"]))
    model = _port(cfg, variables)
    state = create_train_state(model, cfg, steps_per_epoch=2)
    step = make_train_step(state, cfg["seed"])
    got = [step(_t(b), log=True)["Loss"] for b in batches]
    assert state.step == 3 and model.training
    np.testing.assert_allclose(got, want, rtol=STEPS_LOSS_REL)
    stats = from_itrx_variables({"params": jax.device_get(jst.params),
                                 "batch_stats": jax.device_get(jst.batch_stats)})
    k = "img_enc.bn.running_var"
    got_var = _np(model.state_dict()[k])
    assert np.abs(got_var - stats[k]).max() <= STEPS_LOSS_REL * np.abs(stats[k]).max()


def test_vsrn_dropouts_rate_eval_and_seed():
    """get_model's VSRN draws its three dropouts (the encoder's input, the
    decoder's words and its context masks) from one DropoutRNG seeded from
    config['seed'] at input_dropout_p: the context mask zeroes about that
    share and scales the rest by 1 / (1 - p), is all ones in eval mode, and
    the train-mode loss is the same for the same seed and moves with it."""
    cfg = _cfg(input_dropout_p=0.2, seed=5)
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    drops = [m for m in model.modules() if isinstance(m, SeededDropout)]
    assert len(drops) == 4  # the text encoder's (rate 0) and the three
    assert all(d.rng is model.dropout_rng for d in drops[1:]) and model.dropout_rng.seed == 5
    assert sorted(d.p for d in drops) == [0.0, 0.2, 0.2, 0.2]
    ctx = model.caption_model.decoder.context_dropout.train()
    m = ctx.mask((50, 40, 30), torch.device("cpu"))
    assert abs(float((m == 0).float().mean()) - 0.2) < 0.01
    assert torch.all((m == 0) | ((m - 1 / 0.8).abs() < 1e-6))
    assert torch.equal(ctx.eval().mask((3, 4, 5), torch.device("cpu")), torch.ones(3, 4, 5))
    batch = _t(_batch(np.random.default_rng(0)))
    model.train()
    losses = []
    for seed in (1, 1, 2):
        model.dropout_rng.manual_seed(seed)
        with torch.no_grad():
            losses.append(float(model.loss(batch)[0]))
    assert losses[0] == losses[1] != losses[2]


def test_vsrn_caption_sampling_names_its_roadmap_item(vsrn_init):
    """Greedy and multinomial caption sampling are not ported: the decoder
    raises naming the ROADMAP item; an unknown mode is a ValueError."""
    cfg, variables = vsrn_init
    cm = _port(cfg, variables).caption_model
    gcn = torch.zeros(2, 3, cfg["embed_size"])
    for mode in ("greedy", "multinomial"):
        with pytest.raises(NotImplementedError, match="item 16"):
            cm(gcn, None, mode=mode)
    with pytest.raises(ValueError, match="Unknown decode mode"):
        cm(gcn, torch.zeros(2, MAX_LEN + 1, dtype=torch.long), mode="beam")


def _fit(root, **kw):
    """A tiny VSRN fit on the CPU (the decoder wrapper's plain pair under
    autograd, dropout 0.2): (cfg, its arguments, the state, best_rsum)."""
    synthetic.generate(str(root / "f30k_precomp"), n_images=24, img_dim=48, n_regions=6,
                       n_concepts_range=(1, 4))
    args = dict(data_path=str(root), data_name="f30k_precomp", vocab_path=str(root / "vocab"),
                vocab_type="json", img_dim=48, embed_size=32, word_dim=16, dim_vid=32,
                dim_hidden=16, dim_word=16, max_len=8, batch_size=24, num_epochs=2,
                val_step=3, log_step=5, learning_rate=0.002, max_violation=True, seed=3,
                save_path=f"{root}/runs", **kw)
    cfg = parse_cli(["with", "VSRN"] + [f"{k}={v}" for k, v in args.items()])
    state, best_rsum = fit(cfg, device="cpu")
    return cfg, args, state, best_rsum


def test_vsrn_fit_checkpoints_resume_and_evalrank(tmp_path):
    """A tiny VSRN fit on the CPU: every loss finite, the checkpoints'
    three state dicts (the caption model third) with the RsGCN and f30k
    BatchNorm statistics moved by training, evalrank_single on model_best
    reproducing best_rsum, and a resume from the last epoch's checkpoint
    (nothing left to train) restoring every weight, statistic and Adam
    moment, the caption model's included, bit for bit."""
    cfg, args, state, best_rsum = _fit(tmp_path)
    assert state.step == 2 * 5
    best = os.path.join(cfg["save_dir"], "model_best.pth.tar")
    ck = load_checkpoint(best)
    assert len(ck["model"]) == 3 and ck["best_rsum"] == pytest.approx(best_rsum)
    img, cap_model = ck["model"][0], ck["model"][2]
    assert "decoder.attention.linear1.weight" in cap_model and "encoder.vid2hid.bias" in cap_model
    assert not torch.equal(img["Rs_GCN_2.W.1.running_var"], torch.ones(32))
    assert not torch.equal(img["bn.running_mean"], torch.zeros(32))
    res = evalrank_single(best, split="dev", device="cpu")
    assert res["rsum"] == pytest.approx(ck["best_rsum"], abs=1e-9)

    last = os.path.join(cfg["save_dir"], "epo1_checkpoint.pth.tar")
    # the checkpoint's epoch is run again on resume, as in the JAX package,
    # so num_epochs 1 leaves nothing to train
    args2 = dict(args, resume=last, save_path=f"{tmp_path}/resumed", num_epochs=1)
    cfg2 = parse_cli(["with", "VSRN"] + [f"{k}={v}" for k, v in args2.items()])
    state2, best2 = fit(cfg2, device="cpu")
    ck = load_checkpoint(last)
    assert state2.step == ck["Eiters"] == 10 and best2 == ck["best_rsum"]
    for name, sd in zip(("img_enc", "txt_enc", "caption_model"), ck["model"]):
        got = getattr(state2.model, name).state_dict()
        assert got.keys() == sd.keys()
        for k, v in sd.items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    opt = state2.optimizer.state_dict()["state"]
    assert len(opt) == len(ck["opt"]["state"]) == len(list(state2.model.parameters()))
    for i, s in ck["opt"]["state"].items():
        for k, v in s.items():
            torch.testing.assert_close(opt[i][k], v, rtol=0, atol=0)
