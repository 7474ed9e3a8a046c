"""The port's SGRAF-SAF training vs the JAX package on the CPU, at small
widths (embed 128, sim_dim 128, 36 regions, a batch of 6 with ragged
lengths, cap_chunk 4, so a chunk boundary splits the batch): the train-mode
self-attention heads and SAF (BatchNorm batch statistics and the running
update, SAF's per-caption statistics folded over two chunks) vs the flax
modules, one whole step (loss, every gradient, every running statistic)
and three steps of make_train_step vs `itrx`'s, with `sim_bf16` off (the
plain chain) and on (the alignment wrapper, whose CPU body is the plain
pair), the port's dropout, the train / eval mode switching of the loop, and
a tiny `fit` with checkpoint, resume and evalrank_single.  Dropout is 0
wherever the two packages are compared (their random streams differ).
Weights go JAX -> port through itrx_torch.utils.convert."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from itrx.configs import parse_cli
from itrx.data import synthetic
from itrx.models import get_model as jget_model
from itrx.models.sgraf import AttentionFiltration as JAttentionFiltration
from itrx.models.sgraf import TextSA as JTextSA
from itrx.models.sgraf import VisualSA as JVisualSA
from itrx.train import loop as jloop
from itrx.train import state as jstate
from itrx_torch.eval.engine import evalrank_single
from itrx_torch.models import get_model
from itrx_torch.models import sgraf
from itrx_torch.models.layers import DropoutRNG, SeededDropout
from itrx_torch.models.sgraf import NEG_INF
from itrx_torch.train import loop
from itrx_torch.train.loop import fit, make_train_step
from itrx_torch.train.state import create_train_state
from itrx_torch.utils.checkpoint import load_checkpoint
from itrx_torch.utils.convert import from_itrx_variables

from tests.test_torch_sgraf import E, S, _batch, _cfg, _perturb_stats, _sub
from tests.test_torch_sgraf_sgr import STEPS as SGR_STEPS
from tests.test_torch_sgraf_sgr import _perturb as _perturb_sgr

torch.set_num_threads(1)

# fp32: the same chain in another summation order.  Loss relative; each
# gradient and running statistic within this share of its tensor's largest
# entry (measured: 1.1e-5 at most, the GRU's and the heads' biases)
FP32_LOSS_REL = 1e-5
FP32_REL = 5e-5
# sim_bf16: `itrx` runs the whole chunk (word and global nodes, SAF and its
# BatchNorm, sim_eval_w) in bf16, the port fp32 on bf16-rounded values with
# bf16 word nodes from the alignment wrapper (a difference by design,
# ROADMAP queue 3).  Measured: the loss 1.7% apart, gradients and running
# statistics at most 8.5% of their tensor's largest entry (img_enc.fc.bias)
BF16_LOSS_REL = 3e-2
BF16_REL = 0.15
# three steps: Adam's first update is lr * sign(g) for |g| far above the
# packages' difference, but up to 2 lr apart near it (see
# tests/test_torch_train.py::test_train_steps_match_jax), so later losses
# carry that
STEPS_LOSS_REL = 1e-3


def _np(t):
    return t.detach().cpu().numpy()


# biases whose gradient is zero in exact arithmetic: before a per-feature
# BatchNorm (the batch mean takes them out) or a softmax (shift-invariant)
ZERO_GRADS = ("sim_enc.v_global_w.embedding_global.0.bias",
              "sim_enc.SAF_module.attn_sim_w.bias",
              "sim_enc.v_global_w.embedding_common.0.bias",
              "sim_enc.t_global_w.embedding_common.0.bias")


# SGRAF-SGR: the reasoning steps make a pair's nodes alike, so the later
# steps' edge softmax is near uniform and their q/k gradients are the small
# remainder of a cancellation (measured: 1e-6 of the model's largest gradient
# entry at step 1, 1e-9 at step 2), whose fp32 rounding is that of the
# cancelling terms.  Each tensor is held to its limit over the larger of its
# own largest entry and this share of the model's largest gradient entry.
SGR_FLOOR = 1e-3
# sim_bf16: the port's gradients against `itrx`'s fp32 step.  `itrx`'s bf16
# chain runs the reasoning in bf16, which moves its own sim_graph_w
# gradients of steps 1-2 by up to 61% of their scale from its fp32 step (the
# test checks that it moves farther than the port's).  Measured: the port at
# most 17% from it (the GRU weights and the embedding), the bf16 word nodes
# and their bf16 cotangents of the alignment route; the reasoning wrapper's
# own gradients equal the module loop's on those nodes to 1e-7
SGR_BF16_REL = 0.25
# SGRAF-SGR adds the steps' key biases: bk moves each query's edge logits by
# a constant, which the softmax drops
SGR_ZERO_GRADS = tuple(k for k in ZERO_GRADS if "SAF_module" not in k) + tuple(
    f"sim_enc.SGR_module.sgr{i}.graph_key_w.bias" for i in range(SGR_STEPS))


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def jax_init():
    """(cfg, JAX variables as numpy, every BatchNorm's running statistics
    moved off (0, 1))."""
    rng = np.random.default_rng(11)
    cfg = _cfg()
    jmodel = jget_model(cfg)
    jb = {k: jnp.asarray(v) for k, v in _batch(rng).items()}
    variables = jax.device_get(jax.jit(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, b, train=False))(jb))
    return cfg, _perturb_stats(jax.tree.map(np.array, variables), rng)


@pytest.fixture(scope="module")
def sgr_init():
    """(cfg with module_name SGR, JAX variables as numpy: the steps' biases
    and the visual BatchNorms' statistics moved off their init)."""
    rng = np.random.default_rng(12)
    cfg = _cfg(module_name="SGR", sgr_step=SGR_STEPS)
    jmodel = jget_model(cfg)
    jb = {k: jnp.asarray(v) for k, v in _batch(rng).items()}
    variables = jax.device_get(jax.jit(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, b, train=False))(jb))
    return cfg, _perturb_sgr(jax.tree.map(np.array, variables), rng)


def _port(cfg, variables):
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in from_itrx_variables(variables).items()},
        strict=True)
    return model


def test_saf_train_batchnorm_matches_flax_over_two_chunks(jax_init, rng):
    """AttentionFiltration in train mode, two chunks of captions (3, then
    2) in order: each chunk's output from per-caption statistics over its
    valid nodes, and the running mean and variance after both, vs flax with
    a mutable `batch_stats`."""
    cfg, variables = jax_init
    model = _port(cfg, variables)
    saf = model.sim_enc.SAF_module.train()
    jvars = _sub(variables, "sim_enc", "scorer", "SAF")
    for c in (3, 2):
        ni, n = 4, 9
        nodes = rng.standard_normal((c * ni, n, S)).astype(np.float32)
        nmask = np.ones((c * ni, n), np.float32)
        for i in range(c):  # ragged captions, the global node always valid
            nmask[i * ni:(i + 1) * ni, 1 + rng.integers(1, n - 1):] = 0.0
        want, mut = JAttentionFiltration(S, train=True, cap_rows=c).apply(
            jvars, jnp.asarray(nodes), jnp.asarray(nmask), mutable=["batch_stats"])
        jvars = {"params": jvars["params"], "batch_stats": mut["batch_stats"]}
        got = saf(torch.from_numpy(nodes), torch.from_numpy(nmask), cap_rows=c)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    stats = jvars["batch_stats"]["bn"]["BatchNorm_0"]
    np.testing.assert_allclose(_np(saf.bn.running_mean), stats["mean"], rtol=1e-6)
    np.testing.assert_allclose(_np(saf.bn.running_var), stats["var"], rtol=1e-6)
    assert float(saf.bn.running_var) != pytest.approx(2.1)  # the statistics moved


def test_self_attention_heads_train_match_flax(jax_init, rng):
    """VisualSA (two BatchNorms on batch statistics, running update) and
    TextSA in train mode at dropout 0 vs flax."""
    cfg, variables = jax_init
    model = _port(cfg, variables)
    sa = model.sim_enc.train()
    img = rng.standard_normal((5, 36, E)).astype(np.float32)
    cap = rng.standard_normal((6, 9, E)).astype(np.float32)
    mask = (np.arange(9)[None] < rng.integers(1, 10, 6)[:, None]).astype(np.float32)
    got_v = sa.v_global_w(torch.from_numpy(img), torch.from_numpy(img.mean(1)))
    got_t = sa.t_global_w(torch.from_numpy(cap), torch.from_numpy(cap.mean(1)),
                          torch.from_numpy(mask))
    want_v, mut = JVisualSA(E, dropout_rate=0.0).apply(
        _sub(variables, "sim_enc", "v_global_w"), jnp.asarray(img), jnp.asarray(img.mean(1)),
        train=True, mutable=["batch_stats"])
    want_t = JTextSA(E, dropout_rate=0.0).apply(
        _sub(variables, "sim_enc", "t_global_w"), jnp.asarray(cap), jnp.asarray(cap.mean(1)),
        jnp.asarray(mask), train=True)
    np.testing.assert_allclose(_np(got_v), np.asarray(want_v), atol=1e-5)
    np.testing.assert_allclose(_np(got_t), np.asarray(want_t), atol=1e-5)
    for idx, name in ((1, "local_bn"), (1, "global_bn")):
        part = "embedding_local" if name == "local_bn" else "embedding_global"
        bn = getattr(sa.v_global_w, part)[idx]
        want = mut["batch_stats"][name]["BatchNorm_0"]
        np.testing.assert_allclose(_np(bn.running_mean), want["mean"], atol=1e-6)
        np.testing.assert_allclose(_np(bn.running_var), want["var"], rtol=1e-5)


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
        return out[0], mut

    (loss, mut), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(variables["params"])
    grads = from_itrx_variables({"params": jax.device_get(grads),
                                 "batch_stats": jax.device_get(mut["batch_stats"])})
    return float(loss), grads


def _spread(variables):
    """The variables with sim_eval_w x 50: at the init scale the scores sit
    within ~1e-3 of 0.5, where bf16's step is 2^-9, and `itrx`'s hardest
    negatives would be near-ties that the two packages break differently."""
    variables = jax.tree.map(lambda a: a, variables)
    ev = variables["params"]["sim_enc"]["scorer"]["sim_eval_w"]
    ev["kernel"] = ev["kernel"] * np.float32(50.0)
    return variables


def _port_step(cfg, variables, batch):
    """The port's train-mode loss at max_violation, backward: (loss, each
    parameter's gradient and each running statistic as numpy, the largest
    gradient entry)."""
    model = _port(cfg, variables).train()
    loss, _ = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    params = dict(model.named_parameters())
    out = {k: _np(params[k].grad) if k in params else _np(v)
           for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    return float(loss.detach()), out, max(float(p.grad.abs().max()) for p in params.values())


def _errors(got, want, scale, zero_grads, zero, floor=0.0):
    """Each tensor's max abs error over the larger of its largest entry and
    `floor` x scale.  The biases in `zero_grads` (zero gradient in exact
    arithmetic) are held to rounding noise instead: both sides within
    `zero` x scale."""
    errs = {}
    for k, g in got.items():
        if k in zero_grads:
            assert max(np.abs(g).max(), np.abs(want[k]).max()) <= zero * scale, k
            continue
        errs[k] = float(np.abs(g - want[k]).max() / max(np.abs(want[k]).max(), floor * scale))
    return errs


def _step_errors(cfg, variables, sim_bf16, zero_grads):
    """One SGRAF step at max_violation, the port against `itrx` from the
    same weights, statistics and batch: (the loss's relative error, each
    gradient's and running statistic's error over its tensor's largest
    entry).  The biases in `zero_grads` are held to 2e-3 of the largest
    gradient entry with sim_bf16 (`itrx` normalizes in bf16), else 1e-4."""
    cfg = dict(cfg, sim_bf16=sim_bf16)
    variables = _spread(variables)
    batch = _batch(np.random.default_rng(3))
    want_loss, want = _jax_step(cfg, variables, batch)
    loss, got, scale = _port_step(cfg, variables, batch)
    errs = _errors(got, want, scale, zero_grads, 2e-3 if sim_bf16 else 1e-4)
    return abs(loss - want_loss) / abs(want_loss), errs


@pytest.mark.parametrize("sim_bf16", [False, True])
def test_sgraf_saf_step_matches_jax(jax_init, sim_bf16):
    """One SGRAF-SAF step at max_violation: the loss, every parameter's
    gradient and every running statistic after it (both visual BatchNorms
    and SAF's, which two chunks update) vs `itrx`."""
    cfg, variables = jax_init
    loss_err, errs = _step_errors(cfg, variables, sim_bf16, ZERO_GRADS)
    loss_rel, rel = (BF16_LOSS_REL, BF16_REL) if sim_bf16 else (FP32_LOSS_REL, FP32_REL)
    assert loss_err <= loss_rel, loss_err
    assert max(errs.values()) <= rel, sorted(errs.items(), key=lambda kv: kv[1])[-4:]


def _train_steps(cfg, variables):
    """Three updates of make_train_step (clip, Adam, steps_per_epoch 2 so
    the third runs at lr / 10), the port against `itrx`'s make_train_step
    from the same weights, statistics and batches: (the port's losses,
    `itrx`'s, the port's state dict, `itrx`'s as port names)."""
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
    got = [step({k: torch.from_numpy(v) for k, v in b.items()}, log=True)["Loss"]
           for b in batches]
    assert state.step == 3 and model.training
    stats = from_itrx_variables({"params": jax.device_get(jst.params),
                                 "batch_stats": jax.device_get(jst.batch_stats)})
    return got, want, model.state_dict(), stats


def test_sgraf_saf_train_steps_match_jax(jax_init):
    """Three updates of make_train_step vs `itrx`'s from the same weights,
    statistics and batches: the three losses and SAF's running variance."""
    got, want, sd, stats = _train_steps(*jax_init)
    np.testing.assert_allclose(got, want, rtol=STEPS_LOSS_REL)
    k = "sim_enc.SAF_module.bn.running_var"
    assert _rel(_np(sd[k]), stats[k]) <= STEPS_LOSS_REL


def test_seeded_dropout_rate_eval_and_seed():
    """The port's dropout: about the rate's share zeroed and the rest scaled
    by 1 / (1 - p) in train mode, identity in eval mode and at p 0, and the
    same mask from the same seed (another from another)."""
    x = torch.ones(200, 500)
    drop = SeededDropout(0.4, DropoutRNG(7)).train()
    y = drop(x)
    assert abs(float((y == 0).float().mean()) - 0.4) < 0.01
    assert torch.all((y == 0) | ((y - 1 / 0.6).abs() < 1e-6))
    drop.rng.manual_seed(7)
    torch.testing.assert_close(drop(x), y, rtol=0, atol=0)
    drop.rng.manual_seed(8)
    assert not torch.equal(drop(x), y)
    assert torch.equal(drop.eval()(x), x)
    assert torch.equal(SeededDropout(0.0).train()(x), x)
    with pytest.raises(ValueError, match="dropout rate"):
        SeededDropout(1.0)


def test_sgraf_dropouts_share_the_models_stream():
    """get_model's SGRAF draws every dropout (the word vectors and the four
    of the heads) from one DropoutRNG seeded from config['seed'], keeps the
    reference's state-dict keys, and its train-mode loss moves with the
    stream's seed."""
    cfg = _cfg(sgraf_dropout=0.4, seed=5)
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    drops = [m for m in model.modules() if isinstance(m, SeededDropout)]
    assert len(drops) == 5 and all(d.rng is model.dropout_rng for d in drops)
    assert model.dropout_rng.seed == 5 and all(d.p == 0.4 for d in drops)
    assert "sim_enc.v_global_w.embedding_local.1.running_mean" in model.state_dict()
    batch = {k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(0)).items()}
    model.train()
    losses = []
    for seed in (1, 1, 2):
        model.dropout_rng.manual_seed(seed)
        with torch.no_grad():
            losses.append(float(model.loss(batch)[0]))
    assert losses[0] == losses[1] != losses[2]


def test_loop_switches_modes_and_validation_keeps_statistics(jax_init, monkeypatch):
    """make_train_step puts the model in train mode; validate_step
    evaluates in eval mode (no statistic moves) and restores train mode.
    SGRAF.similarity refuses a `train` flag that disagrees with the mode."""
    cfg, variables = jax_init
    model = _port(cfg, variables)
    assert not model.training
    state = create_train_state(model, dict(cfg, learning_rate=2e-4, grad_clip=2.0,
                                           lr_update=1), steps_per_epoch=2)
    step = make_train_step(state, 0)
    assert model.training and all(m.training for m in model.modules())
    step({k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(1)).items()})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    seen = []

    def evaluate_split(m, *a, **kw):
        seen.append(all(not x.training for x in m.modules()))
        e = m.embed({k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(2)).items()})
        m.similarity(e["img"], e["cap"], e["cap_mask"])
        return {"rsum": 1.0, **{f"{d}_{k}": 0.0 for d in ("i2t", "t2i")
                                for k in ("r1", "r5", "r10", "medr", "meanr")}}

    monkeypatch.setattr(loop.engine, "evaluate_split", evaluate_split)
    writer = type("W", (), {"log_dict": lambda *a: None})()
    assert loop.validate_step(cfg, state, None, "cpu", writer) == (1.0, 0.0)
    assert seen == [True] and model.training
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    img, cap, mask = torch.zeros(2, 36, E), torch.zeros(3, 4, E), torch.ones(3, 4)
    with pytest.raises(ValueError, match="model.eval"):
        model.similarity(img, cap, mask, train=False)
    model.eval()
    with pytest.raises(ValueError, match="model.train"):
        model.similarity(img, cap, mask, train=True)


def _fit(root, module_name):
    """A tiny SGRAF fit on the CPU (sim_bf16: the alignment wrapper's plain
    pair under autograd, and for SGR the reasoning wrapper's): (cfg, its
    arguments, the state, best_rsum)."""
    d = synthetic.generate(str(root / "synthetic"), n_images=24, img_dim=48)
    args = dict(data_path=str(root), data_name="synthetic", vocab_path=f"{d}/vocab",
                vocab_type="json", img_dim=48, embed_size=32, word_dim=16, sim_dim=16,
                batch_size=24, num_epochs=2, val_step=3, log_step=5, cap_chunk=8,
                learning_rate=0.002, max_violation=True, sim_bf16=True, seed=3,
                save_path=f"{root}/runs")
    cfg = parse_cli(["with", "SGRAF", f"module_name={module_name}"]
                    + [f"{k}={v}" for k, v in args.items()])
    state, best_rsum = fit(cfg, device="cpu")
    return cfg, args, state, best_rsum


def _resume(cfg, args, root, module_name):
    """Resume from the last epoch's checkpoint (nothing left to train):
    (the resumed state, its best_rsum, the checkpoint)."""
    ckpt = os.path.join(cfg["save_dir"], "epo1_checkpoint.pth.tar")
    # the checkpoint's epoch is run again on resume, as in the JAX package,
    # so num_epochs 1 leaves nothing to train
    args2 = dict(args, resume=ckpt, save_path=f"{root}/resumed", num_epochs=1)
    cfg2 = parse_cli(["with", "SGRAF", f"module_name={module_name}"]
                     + [f"{k}={v}" for k, v in args2.items()])
    state2, best = fit(cfg2, device="cpu")
    return state2, best, load_checkpoint(ckpt)


def _same_state(model, ck):
    for name, sd in zip(("img_enc", "txt_enc", "sim_enc"), ck["model"]):
        got = getattr(model, name).state_dict()
        assert got.keys() == sd.keys()
        for k, v in sd.items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)


@pytest.fixture(scope="module")
def saf_fit(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_sgraf_fit")
    return (*_fit(root, "SAF"), root)


def test_sgraf_saf_fit_checkpoints_and_evalrank_reproduces_best(saf_fit):
    """A tiny SGRAF-SAF fit on the CPU (sim_bf16: the alignment wrapper's
    plain pair under autograd): every loss finite, the checkpoints' three
    state dicts with the SAF and visual BatchNorm statistics moved by
    training, and evalrank_single on model_best reproducing best_rsum."""
    cfg, _, state, best_rsum, _ = saf_fit
    assert state.step == 2 * 5
    best = os.path.join(cfg["save_dir"], "model_best.pth.tar")
    ck = load_checkpoint(best)
    assert len(ck["model"]) == 3 and ck["best_rsum"] == pytest.approx(best_rsum)
    sim = ck["model"][2]
    assert float(sim["SAF_module.bn.running_mean"]) != 0.0
    assert not torch.equal(sim["v_global_w.embedding_local.1.running_var"], torch.ones(36))
    res = evalrank_single(best, split="dev", device="cpu")
    assert res["rsum"] == pytest.approx(ck["best_rsum"], abs=1e-9)


def test_sgraf_saf_resume_restores_statistics(saf_fit):
    """Resuming from the last epoch's checkpoint (nothing left to train)
    restores the weights and every running statistic bit for bit: the
    validation that a resume runs is in eval mode and moves nothing."""
    cfg, args, _, _, root = saf_fit
    state2, best, ck = _resume(cfg, args, root, "SAF")
    assert state2.step == ck["Eiters"] == 10 and best == ck["best_rsum"]
    _same_state(state2.model, ck)


def test_train_step_masks_follow_seed_and_update_count(jax_init):
    """At dropout 0.4 two runs of make_train_step from the same weights
    and seed give the same losses (the stream is reseeded from the seed and
    the update count before each step), and another seed others."""
    cfg, variables = jax_init
    cfg = dict(cfg, sgraf_dropout=0.4, learning_rate=2e-4, grad_clip=2.0, lr_update=1)
    batches = [{k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(i)).items()}
               for i in range(2)]

    def losses(seed):
        state = create_train_state(_port(cfg, variables), cfg, steps_per_epoch=2)
        step = make_train_step(state, seed)
        return [step(b, log=True)["Loss"] for b in batches]

    first = losses(0)
    assert losses(0) == first
    assert losses(1) != first


def _module_loop(s, mask, wq, bq, wk, bk, wg, bg):
    """The GraphReasoning steps from their stacked Linears, unfolded: the
    chain the train tower runs without sim_bf16."""
    for i in range(wq.shape[0]):
        e = F.linear(s, wq[i], bq[i]) @ F.linear(s, wk[i], bk[i]).transpose(1, 2)
        a = torch.softmax(e.masked_fill(mask[:, None, :] <= 0, NEG_INF), dim=-1)
        s = torch.relu(F.linear(a @ s, wg[i], bg[i]))
    return s


@pytest.mark.parametrize("sim_bf16", [False, True])
def test_sgraf_sgr_step_matches_jax(sgr_init, sim_bf16, monkeypatch):
    """One SGRAF-SGR step at max_violation: the loss, every parameter's
    gradient (the reasoning steps' included; bk's is zero) and both visual
    BatchNorms' running statistics vs `itrx`.  Without sim_bf16 against
    `itrx`'s fp32 step.  With sim_bf16 the port's chunks go through the
    alignment and reasoning wrappers (their plain pairs on the CPU: fp32
    steps on bf16 word nodes): the loss against `itrx`'s bf16 step, the
    gradients and statistics against its fp32 step (its bf16 chain runs the
    reasoning in bf16, ROADMAP queue 3), and the reasoning wrapper's
    gradients against the unfolded module loop's on the same bf16 nodes."""
    cfg, variables = sgr_init
    variables = _spread(variables)
    batch = _batch(np.random.default_rng(3))
    want_loss, want = _jax_step(dict(cfg, sim_bf16=False), variables, batch)
    loss, got, scale = _port_step(dict(cfg, sim_bf16=sim_bf16), variables, batch)
    if sim_bf16:
        want_loss, want16 = _jax_step(dict(cfg, sim_bf16=True), variables, batch)
    loss_rel, rel = (BF16_LOSS_REL, SGR_BF16_REL) if sim_bf16 else (FP32_LOSS_REL, FP32_REL)
    assert abs(loss - want_loss) <= loss_rel * abs(want_loss), (loss, want_loss)
    errs = _errors(got, want, scale, SGR_ZERO_GRADS, 2e-3 if sim_bf16 else 1e-4, SGR_FLOOR)
    assert max(errs.values()) <= rel, sorted(errs.items(), key=lambda kv: kv[1])[-4:]
    if sim_bf16:
        # why the fp32 reference: `itrx`'s own bf16 step is farther from it
        ref = _errors(want16, want, scale, SGR_ZERO_GRADS, 2e-3, SGR_FLOOR)
        assert max(ref.values()) > max(errs.values()), (max(ref.values()), max(errs.values()))
        monkeypatch.setattr(sgraf, "sgr_reason_fused", _module_loop)
        _, loop, _ = _port_step(dict(cfg, sim_bf16=True), variables, batch)
        errs = _errors(got, loop, scale, SGR_ZERO_GRADS, 1e-4, SGR_FLOOR)
        assert max(errs.values()) <= FP32_REL, sorted(errs.items(), key=lambda kv: kv[1])[-4:]


def test_sgraf_sgr_train_steps_match_jax(sgr_init):
    """Three updates of make_train_step (sim_bf16 off) vs `itrx`'s from the
    same weights, statistics and batches: the three losses and a visual
    BatchNorm's running variance."""
    got, want, sd, stats = _train_steps(*sgr_init)
    np.testing.assert_allclose(got, want, rtol=STEPS_LOSS_REL)
    k = "sim_enc.v_global_w.embedding_local.1.running_var"
    assert _rel(_np(sd[k]), stats[k]) <= STEPS_LOSS_REL


def test_sgraf_sgr_fit_checkpoints_resume_and_evalrank(tmp_path):
    """A tiny SGRAF-SGR fit on the CPU with sim_bf16 (both training
    wrappers' plain pairs under autograd): every loss finite, the
    checkpoints' three state dicts with the reasoning steps and the visual
    BatchNorm statistics moved by training, evalrank_single on model_best
    reproducing best_rsum, and a resume from the last epoch restoring every
    weight and statistic bit for bit."""
    cfg, args, state, best_rsum = _fit(tmp_path, "SGR")
    assert state.step == 2 * 5
    best = os.path.join(cfg["save_dir"], "model_best.pth.tar")
    ck = load_checkpoint(best)
    assert len(ck["model"]) == 3 and ck["best_rsum"] == pytest.approx(best_rsum)
    sim = ck["model"][2]
    assert "SGR_module.sgr2.sim_graph_w.weight" in sim and "SAF_module.bn.running_var" not in sim
    assert not torch.equal(sim["v_global_w.embedding_local.1.running_var"], torch.ones(36))
    res = evalrank_single(best, split="dev", device="cpu")
    assert res["rsum"] == pytest.approx(ck["best_rsum"], abs=1e-9)
    state2, best2, last = _resume(cfg, args, tmp_path, "SGR")
    assert state2.step == last["Eiters"] == 10 and best2 == last["best_rsum"]
    _same_state(state2.model, last)
