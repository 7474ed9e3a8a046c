"""The port's SAEM vs the JAX package on the CPU at small widths: BERT with 2
layers, hidden 32, 4 heads, intermediate 64, a vocabulary of 64; final_dims
16, embed_size 24 (the `rnn` text head's width), a transformer block of
width 16 with 4 heads, 6 regions of 48 features.  The test configs set every
dropout to 0 (BERT's hidden_dropout_prob, which the text branch's dropout
reads, and the block's rates through a test trans_cfg), so the train-mode
loss is deterministic.  Covered: `pdist`, `pdist_cos`, `angular_loss` and
`npair_loss`; every `txt_stru` with the `trans` image branch and every
`img_stru` with the `cnn` text branch (embed, both grids, the loss with its
weight penalty and angular weight, every gradient); the penalty's names
against `itrx`'s leaves; one make_train_step update; the state-dict round
trip through `itrx.utils.ref_convert`; a tiny `fit` whose checkpoint
`evalrank_single` ranks as the JAX evalrank_single ranks it; the default
trans_cfg read from the port's own copy; bf16 encode; the seeded dropout of
the transformer block.  Weights go JAX -> port through
itrx_torch.utils.convert; inputs come from numpy with a seed."""

import builtins
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itrx.eval.engine import evalrank_ensemble as jevalrank_ensemble
from itrx.eval.engine import evalrank_single as jevalrank_single
from itrx.models import get_model as jget_model
from itrx.models.bert_methods import _default_trans_cfg as jdefault_trans_cfg
from itrx.ops import losses as jlosses
from itrx.ops import sim as jsim
from itrx.train import loop as jloop
from itrx.train import state as jstate
from itrx.utils.ref_convert import (convert_reference_checkpoint, convert_state_list,
                                    merge_into_variables)
from itrx_torch import configs
from itrx_torch.data import synthetic
from itrx_torch.eval.engine import evalrank_ensemble, evalrank_single
from itrx_torch.models import bert_methods, get_model
from itrx_torch.models.bert import BertConfig, BertLayer
from itrx_torch.models.layers import DropoutRNG
from itrx_torch.ops.losses import angular_loss, npair_loss
from itrx_torch.ops.sim import pdist, pdist_cos
from itrx_torch.train.loop import fit, make_train_step
from itrx_torch.train.state import create_train_state
from itrx_torch.utils.checkpoint import load_checkpoint
from itrx_torch.utils.convert import from_itrx_variables, to_itrx_flat

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, IMG, R, L, FINAL, EMBED = 64, 48, 6, 10, 16, 24
BERT = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=64, type_vocab_size=2,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
TRANS = dict(vocab_size=VOCAB, hidden_size=FINAL, num_hidden_layers=1, num_attention_heads=4,
             intermediate_size=32, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
# every txt_stru with the default `trans` image branch, every img_stru with
# the default `cnn` text branch
COMBOS = [(t, "trans") for t in ("cnn", "pooling", "rnn", "trans")] + [
    ("cnn", i) for i in ("fc", "cnn", "rnn")]
# fp32: the same chain in another summation order
FP32_ATOL = 1e-5
# the loss, relative; gradients within this share of each tensor's largest
# entry, as tests/test_torch_train.py holds SCAN's
LOSS_REL = 1e-5
GRAD_REL = 1e-4
# one update: entries whose gradient is above this share of its tensor's
# largest entry within TIGHT lr, the rest within 2 lr (Adam's first update
# is lr sign(g) away from g ~ 0: tests/test_torch_train.py's STEP_LIMITS[1])
WELL, TIGHT = 1e-4, 1e-3
# the transformer blocks' key biases: their gradient is zero in exact
# arithmetic (a key bias adds one constant to a query's scores, which the
# softmax takes out); held to rounding noise, this share of the model's
# largest gradient entry, on both sides
ZERO_GRADS = "attention.self.key.bias"
ZERO_REL = 1e-5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(a tiny bert_config.json, a trans_cfg.json at final_dims), dropouts
    0."""
    root = tmp_path_factory.mktemp("saem")
    bert, trans = root / "bert_config.json", root / "trans_cfg.json"
    bert.write_text(json.dumps(BERT))
    trans.write_text(json.dumps(TRANS))
    return str(bert), str(trans)


def _cfg(files, txt_stru="cnn", img_stru="trans", **kw) -> dict:
    cfg = dict(name="SAEM", vocab_size=VOCAB, img_dim=IMG, final_dims=FINAL,
               embed_size=EMBED, txt_stru=txt_stru, img_stru=img_stru, bi_gru=True,
               margin=0.2, max_violation=False, measure="cosine", bert_config_file=files[0],
               trans_cfg=files[1], learning_rate=1e-4, lr_update=10, grad_clip=2.0, seed=0)
    cfg.update(kw)
    return cfg


def _batch(rng, b=6):
    """A SAEM batch: regions, BERT ids with a ragged mask (the first caption
    full length)."""
    lengths = rng.integers(2, L + 1, b)
    lengths[0] = L
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    return {"images": rng.standard_normal((b, R, IMG)).astype(np.float32),
            "cap_ids": (rng.integers(1, VOCAB, (b, L)) * mask).astype(np.int32),
            "cap_mask": mask, "type_ids": np.zeros((b, L), np.int32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np(t):
    return t.detach().float().numpy()


def _pair(cfg, seed=0):
    """(JAX model, its variables as numpy, the port model holding them)."""
    jmodel = jget_model(cfg)
    variables = jax.device_get(jmodel.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)},
        _j(_batch(np.random.default_rng(seed))), train=False))
    variables = jax.tree.map(np.array, variables)
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in from_itrx_variables(variables).items()}, strict=True)
    return jmodel, variables, model


# -- the ops -------------------------------------------------------------------


def test_pdist_and_pdist_cos_match_jax(rng):
    """pdist (the order measure's distance, eps 1e-4) and pdist_cos (a zero
    row's NaN turned into 0) vs `itrx.ops.sim` within FP32_ATOL; bf16 inputs
    give fp32 grids."""
    x1 = rng.standard_normal((5, 8)).astype(np.float32)
    x2 = rng.standard_normal((7, 8)).astype(np.float32)
    x2[3] = 0.0
    got_cos = pdist_cos(torch.from_numpy(x1), torch.from_numpy(x2)).numpy()
    np.testing.assert_allclose(got_cos, np.asarray(jsim.pdist_cos(x1, x2)), atol=FP32_ATOL)
    assert not got_cos[:, 3].any() and np.isfinite(got_cos).all()
    np.testing.assert_allclose(pdist(torch.from_numpy(x1), torch.from_numpy(x2)).numpy(),
                               np.asarray(jsim.pdist(x1, x2)), atol=FP32_ATOL)
    b1, b2 = torch.from_numpy(x1).bfloat16(), torch.from_numpy(x2).bfloat16()
    assert pdist(b1, b2).dtype == pdist_cos(b1, b2).dtype == torch.float32


@pytest.mark.parametrize("name", ["angular", "npair"])
@pytest.mark.parametrize("max_violation", [False, True])
def test_angular_and_npair_losses_match_jax(rng, name, max_violation):
    """angular_loss (angle bound 1, the shifted log-sum-exp without
    max_violation) and npair_loss on unit rows vs `itrx.ops.losses`: the
    value and both inputs' gradients within FP32_ATOL."""
    im = rng.standard_normal((6, 8)).astype(np.float32)
    s = rng.standard_normal((6, 8)).astype(np.float32)
    im /= np.linalg.norm(im, axis=1, keepdims=True)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    ours = angular_loss if name == "angular" else npair_loss
    theirs = jlosses.angular_loss if name == "angular" else jlosses.npair_loss
    kw = {"angle_bound": 1.0} if name == "angular" else {}
    ti, ts = torch.tensor(im, requires_grad=True), torch.tensor(s, requires_grad=True)
    loss = ours(ti, ts, max_violation=max_violation, **kw)
    loss.backward()
    jl, (gi, gs) = jax.value_and_grad(
        lambda a, b: theirs(a, b, max_violation=max_violation, **kw), argnums=(0, 1))(im, s)
    np.testing.assert_allclose(loss.item(), float(jl), atol=FP32_ATOL, rtol=1e-6)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(gi), atol=FP32_ATOL)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(gs), atol=FP32_ATOL)


# -- SAEM -----------------------------------------------------------------------


@pytest.mark.parametrize("txt_stru,img_stru", COMBOS)
def test_saem_embed_and_similarity_match_jax(files, rng, txt_stru, img_stru):
    """SAEM embed (the frozen BERT, the text head, the image branch) and
    both grids (pdist_cos; -pdist with measure order) vs `itrx` within
    FP32_ATOL; the grid is one product, with no kernel."""
    cfg = _cfg(files, txt_stru, img_stru)
    jmodel, variables, model = _pair(cfg)
    assert not model.fused_eval_active(torch.device("cuda"))
    batch = _batch(rng)
    with torch.no_grad():
        e = model.embed(_t(batch))
    je = jmodel.apply(variables, _j(batch), method="embed")
    assert sorted(e) == ["cap", "img"] and e["img"].shape == e["cap"].shape == (6, FINAL)
    for k in ("img", "cap"):
        np.testing.assert_allclose(_np(e[k]), np.asarray(je[k]), atol=FP32_ATOL, err_msg=k)
    for measure in ("cosine", "order"):
        model.measure = measure
        jm = jmodel.clone(measure=measure)
        got = model.similarity(e["img"], e["cap"]).numpy()
        want = jm.apply(variables, je["img"], je["cap"], method="similarity")
        np.testing.assert_allclose(got, np.asarray(want), atol=FP32_ATOL, err_msg=measure)


def _jax_loss(jmodel, variables, batch, epoch):
    """`itrx`'s train-mode loss, its aux values and its gradients as a port
    state dict."""
    def f(params):
        return jmodel.apply({"params": params}, _j(batch), train=True, epoch=epoch,
                            method="loss", rngs={"dropout": jax.random.PRNGKey(5)})

    (loss, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree.map(jnp.asarray, variables["params"]))
    grads = from_itrx_variables({"params": jax.device_get(grads)})
    return float(loss), {k: float(v) for k, v in aux.items()}, grads


@pytest.mark.parametrize("txt_stru,img_stru,measure,max_violation",
                         [c + ("cosine", False) for c in COMBOS]
                         + [("rnn", "trans", "order", True)])
def test_saem_loss_and_grads_match_jax(files, rng, txt_stru, img_stru, measure,
                                       max_violation):
    """SAEM.loss in train mode (hinge + alpha x angular loss + the image
    branch's weight penalty, at epoch 0) and every trained parameter's
    gradient vs `itrx`: the loss and its two parts within LOSS_REL, each
    gradient within GRAD_REL of its tensor's largest entry (ZERO_GRADS held
    to noise); BERT takes no gradient (`itrx`'s is exactly zero)."""
    cfg = _cfg(files, txt_stru, img_stru, measure=measure, max_violation=max_violation)
    jmodel, variables, model = _pair(cfg)
    batch = _batch(rng)
    want_loss, want_aux, want = _jax_loss(jmodel, variables, batch, 0)
    loss, aux = model.train().loss(_t(batch), train=True, epoch=0)
    loss.backward()
    assert sorted(aux) == ["Loss", "Loss1", "Loss2"] and aux["Loss"] is loss
    assert loss.item() == pytest.approx(want_loss, rel=LOSS_REL)
    for k in ("Loss1", "Loss2"):
        assert aux[k].item() == pytest.approx(want_aux[k], rel=LOSS_REL), k
    n_bert = 0
    top = max(float(np.abs(want[k]).max()) for k in want)
    for k, p in model.named_parameters():
        if k.startswith("txt_enc.bert."):
            n_bert += 1
            assert p.grad is None and not p.requires_grad and not want[k].any(), k
            continue
        if k.endswith(ZERO_GRADS):
            assert max(np.abs(_np(p.grad)).max(), np.abs(want[k]).max()) <= ZERO_REL * top, k
            continue
        scale = float(np.abs(want[k]).max())
        assert scale > 0, k
        np.testing.assert_allclose(_np(p.grad), want[k], atol=GRAD_REL * scale, err_msg=k)
    assert n_bert == len(list(model.txt_enc.bert.parameters())) > 0


def test_saem_angular_weight_by_epoch(files, rng):
    """alpha = 0.5 x 0.1^(epoch // 5), 0 past epoch 20: the loss at epochs 0,
    5 and 21 vs `itrx`'s, and each equal to Loss1 + alpha Loss2 + the weight
    penalty."""
    cfg = _cfg(files)
    jmodel, variables, model = _pair(cfg)
    batch = _batch(rng)
    model.train()
    with torch.no_grad():
        reg = model.weight_reg().item()
    for epoch, alpha in ((0, 0.5), (5, 0.05), (21, 0.0)):
        assert model.alpha(epoch) == pytest.approx(alpha, rel=1e-12)
        with torch.no_grad():
            loss, aux = model.loss(_t(batch), train=True, epoch=epoch)
        want_loss, _, _ = _jax_loss(jmodel, variables, batch, epoch)
        assert loss.item() == pytest.approx(want_loss, rel=LOSS_REL), epoch
        assert loss.item() == pytest.approx(
            aux["Loss1"].item() + alpha * aux["Loss2"].item() + reg, rel=1e-6)


# the image branches' penalized parameters, as `itrx` names its leaves (the
# last name not bias, gamma, beta, b_ih or b_hh: a bidirectional GRU's
# reverse biases are in) and as the port names them
PENALIZED = {
    "trans": [
        (("mapping", "kernel"), "mapping.weight"),
        (("layer", "query", "kernel"), "layer.attention.self.query.weight"),
        (("layer", "key", "kernel"), "layer.attention.self.key.weight"),
        (("layer", "value", "kernel"), "layer.attention.self.value.weight"),
        (("layer", "attn_output", "kernel"), "layer.attention.output.dense.weight"),
        (("layer", "intermediate", "kernel"), "layer.intermediate.dense.weight"),
        (("layer", "output", "kernel"), "layer.output.dense.weight")],
    "fc": [(("fc1", "kernel"), "fc1.weight")],
    "cnn": [(("conv_0", "kernel"), "convs1.0.weight"), (("conv_1", "kernel"), "convs1.1.weight"),
            (("conv_2", "kernel"), "convs1.2.weight"), (("fc1", "kernel"), "fc1.weight")],
    "rnn": [(("rnn", "w_ih"), "rnn.weight_ih_l0"), (("rnn", "w_hh"), "rnn.weight_hh_l0"),
            (("rnn", "w_ih_reverse"), "rnn.weight_ih_l0_reverse"),
            (("rnn", "w_hh_reverse"), "rnn.weight_hh_l0_reverse"),
            (("rnn", "b_ih_reverse"), "rnn.bias_ih_l0_reverse"),
            (("rnn", "b_hh_reverse"), "rnn.bias_hh_l0_reverse")],
}


@pytest.mark.parametrize("img_stru", ["trans", "fc", "cnn", "rnn"])
def test_weight_penalty_names_match_jax_leaves(files, img_stru):
    """The image branch's weight penalty sums the same tensors in both
    packages: `itrx`'s included leaves and the port's `penalized()` names,
    listed side by side in PENALIZED, and the penalty's value within
    LOSS_REL."""
    jmodel, variables, model = _pair(_cfg(files, "cnn", img_stru))
    leaves = jax.tree_util.tree_flatten_with_path(variables["params"]["img_enc"])[0]
    jax_in = sorted(tuple(p.key for p in path) for path, _ in leaves
                    if path[-1].key not in ("bias", "gamma", "beta", "b_ih", "b_hh"))
    assert jax_in == sorted(j for j, _ in PENALIZED[img_stru])
    assert model.penalized() == [ours for _, ours in PENALIZED[img_stru]]
    want = jmodel.apply(variables, method=lambda m: m._weight_reg())
    assert model.weight_reg().item() == pytest.approx(float(want), rel=LOSS_REL)


def test_saem_train_step_matches_jax(files, rng):
    """One make_train_step update (clip, Adam) vs `itrx`'s make_train_step
    from the same weights and batch: the loss, every trained entry whose
    gradient is above WELL of its tensor's largest within TIGHT lr and every
    entry within 2 lr (ZERO_GRADS only there); BERT bit-identical and outside the optimizer (no Adam
    state), as `itrx` masks it."""
    cfg = _cfg(files, "rnn", "trans")
    jmodel, variables, model = _pair(cfg)
    batch = _batch(rng)
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = jstate.make_optimizer(cfg, 2, params)
    jst = jstate.TrainState(params=params, batch_stats={}, opt_state=tx.init(params),
                            step=jnp.zeros((), jnp.int32))
    jst, jaux = jloop.make_train_step(jmodel, tx)(jst, _j(batch), jax.random.PRNGKey(0), 0)
    bert0 = {k: v.clone() for k, v in model.txt_enc.bert.state_dict().items()}
    state = create_train_state(model, cfg, steps_per_epoch=2)
    aux = make_train_step(state, cfg["seed"])(_t(batch), log=True)
    assert aux["Loss"] == pytest.approx(float(jaux["Loss"]), rel=LOSS_REL)
    trained = [p for p in model.parameters() if p.requires_grad]
    assert state.optimizer.param_groups[0]["params"] == trained
    assert len(state.optimizer.state) == len(trained)
    want = from_itrx_variables({"params": jax.device_get(jst.params)})
    lr = cfg["learning_rate"]
    for k, p in model.named_parameters():
        if not p.requires_grad:
            np.testing.assert_array_equal(_np(p), _np(bert0[k[len("txt_enc.bert."):]]))
            np.testing.assert_array_equal(want[k], _np(p))
            continue
        diff = np.abs(_np(p) - want[k])
        assert diff.max() <= 2 * lr, (k, diff.max() / lr)
        if k.endswith(ZERO_GRADS):  # its update follows its noise's sign
            continue
        g = np.abs(_np(p.grad))
        well = g > WELL * g.max()
        assert well.any(), k
        assert diff[well].max() <= TIGHT * lr, (k, diff[well].max() / lr)


@pytest.mark.parametrize("txt_stru", ["cnn", "pooling", "rnn", "trans"])
def test_saem_state_dict_round_trip(files, txt_stru):
    """The port's SAEM state dict (the `trans` image branch, the only one the
    reference converter reads, with each text head) -> [img_enc, txt_enc]
    -> `itrx.utils.ref_convert` -> the same variables, exactly."""
    cfg = _cfg(files, txt_stru, "trans", bi_gru=txt_stru == "rnn")
    _, variables, model = _pair(cfg)
    parts = to_itrx_flat(model.state_dict())
    assert len(parts) == 2 and "mapping.weight" in parts[0]
    assert "layer.attention.self.query.weight" in parts[0]
    assert "bert.encoder.layer.1.output.dense.weight" in parts[1]
    flat = convert_state_list("SAEM", parts, cfg)
    assert len(flat) == len(jax.tree.leaves(variables))
    merged = merge_into_variables(variables, flat)
    for a, b in zip(jax.tree.leaves(merged), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_saem_keys_are_the_references(files):
    """Every head's state-dict keys: txt_enc.convs1.{i} Conv2d (512, 1, k,
    768-wide BERT), mapping_0, rnn, layer, mapping; img_enc.mapping /
    layer, fc1, convs1 (256 filters) + fc1, rnn (bidirectional, final_dims
    wide)."""
    h = BERT["hidden_size"]
    shapes = {}
    for txt_stru, img_stru in COMBOS:
        model = get_model(_cfg(files, txt_stru, img_stru), device="cpu")
        shapes.update({k: tuple(v.shape) for k, v in model.state_dict().items()
                       if ".bert." not in k})
    assert shapes["txt_enc.convs1.2.weight"] == (512, 1, 3, h)
    assert shapes["txt_enc.mapping_0.weight"] in ((h, h), (FINAL, h))
    assert shapes["txt_enc.rnn.weight_ih_l0_reverse"] == (3 * EMBED, h)
    assert shapes["txt_enc.layer.attention.self.query.weight"] == (FINAL, FINAL)
    assert shapes["img_enc.mapping.weight"] == (FINAL, IMG)
    assert shapes["img_enc.fc1.weight"] in ((FINAL, IMG), (FINAL, 3 * 256))
    assert shapes["img_enc.convs1.1.weight"] == (256, 1, 2, IMG)
    assert shapes["img_enc.rnn.weight_hh_l0_reverse"] == (3 * FINAL, FINAL)


# -- configuration -----------------------------------------------------------------


def test_default_trans_cfg_is_the_ports_own_copy(monkeypatch):
    """The base config's trans_cfg (the JAX package's file) resolves to
    itrx_torch/configs/trans_cfg.json, which holds the same block; another
    path is read as given, and an absent one gives `itrx`'s default block;
    get_model builds SAEM at the overlay without opening a file under
    itrx/."""
    cfg = configs.base_config()
    cfg.update(configs.SAEM(), vocab_size=VOCAB)
    assert cfg["trans_cfg"] == bert_methods.JAX_TRANS_CFG
    port_dir = os.path.dirname(os.path.abspath(configs.__file__))
    assert bert_methods.TRANS_CFG == os.path.join(port_dir, "trans_cfg.json")
    with open(bert_methods.TRANS_CFG) as f, \
            open(os.path.join(REPO, "itrx", "configs", "trans_cfg.json")) as g:
        assert json.load(f) == json.load(g)
    got = bert_methods.trans_config_from(cfg)
    assert got == BertConfig.from_json_file(bert_methods.TRANS_CFG)
    assert got.hidden_size == cfg["final_dims"] == 256 and got.hidden_dropout_prob == 0.1
    assert bert_methods.trans_config_from(dict(cfg, trans_cfg="./nowhere.json")) == \
        bert_methods.default_trans_cfg(cfg["final_dims"])
    want = jdefault_trans_cfg(cfg["final_dims"])
    assert {k: getattr(want, k) for k in BertConfig.__dataclass_fields__} == \
        vars(bert_methods.default_trans_cfg(cfg["final_dims"]))

    opened = []
    real_open = builtins.open

    def spy(path, *a, **kw):
        opened.append(os.path.abspath(str(path)))
        return real_open(path, *a, **kw)

    monkeypatch.setattr(builtins, "open", spy)
    cfg.update(bert_config_file="./nowhere.json", init_checkpoint="./nowhere.bin")
    with torch.device("meta"):
        model = get_model(cfg, device="meta")
    assert model.img_enc.layer.attention.self.heads == 4
    assert bert_methods.TRANS_CFG in opened
    assert not [p for p in opened if p.startswith(os.path.join(REPO, "itrx") + os.sep)]


def test_bert_layer_dropout_rate_eval_and_seed():
    """BertLayer's three dropouts in train mode: the rates of the config
    (attention probabilities and both residual branches), identity in eval
    mode, masks that follow the DropoutRNG's seed; the frozen BertModel
    stays in eval mode under a parent's train()."""
    cfg = BertConfig(vocab_size=VOCAB, hidden_size=16, num_attention_heads=4,
                     intermediate_size=32, hidden_dropout_prob=0.3,
                     attention_probs_dropout_prob=0.2)
    rng = DropoutRNG(7)
    layer = BertLayer(cfg, torch.Generator().manual_seed(0), rng)
    assert layer.attention.self.dropout.p == 0.2
    assert layer.attention.output.dropout.p == layer.output.dropout.p == 0.3
    x, bias = torch.randn(3, 5, 16), torch.zeros(3, 1, 1, 5)
    layer.eval()
    ref = layer(x, bias)
    torch.testing.assert_close(layer(x, bias), ref, rtol=0, atol=0)
    layer.train()
    rng.manual_seed(11)
    a = layer(x, bias)
    rng.manual_seed(11)
    torch.testing.assert_close(layer(x, bias), a, rtol=0, atol=0)
    rng.manual_seed(12)
    assert not torch.equal(layer(x, bias), a) and not torch.equal(a, ref)
    drop = layer.output.dropout
    kept = float((drop(torch.ones(200_000)) != 0).float().mean())
    assert kept == pytest.approx(0.7, abs=5e-3)
    saem_cfg = configs.base_config()
    saem_cfg.update(configs.SAEM(), vocab_size=VOCAB, bert_config_file="./nowhere.json",
                    init_checkpoint="./nowhere.bin", final_dims=16, trans_cfg="./nowhere.json")
    with torch.device("meta"):
        saem = get_model(saem_cfg, device="meta").train()
    assert saem.training and saem.img_enc.layer.training
    assert not any(m.training for m in saem.txt_enc.bert.modules())


@pytest.mark.parametrize("txt_stru,img_stru", [("cnn", "trans"), ("rnn", "rnn"),
                                               ("trans", "cnn"), ("pooling", "fc")])
def test_saem_bf16_encode(files, rng, txt_stru, img_stru):
    """The bf16 embed forward as encode_data runs it (parameters and images
    cast, masks fp32): no fp32 weight meets a bf16 activation, the
    embeddings are bf16 and within 3e-2 of the fp32 ones."""
    _, _, model = _pair(_cfg(files, txt_stru, img_stru))
    batch = _t(_batch(rng))
    params = {k: p.to(torch.bfloat16) for k, p in model.named_parameters()}
    b16 = dict(batch, images=batch["images"].bfloat16())
    with torch.no_grad():
        got = torch.func.functional_call(model, params, (b16,), strict=False)
        want = model(batch)
    for k in ("img", "cap"):
        assert got[k].dtype == torch.bfloat16, k
        assert float((got[k].float() - want[k]).abs().max()) <= 3e-2, k


# -- fit and evaluation ------------------------------------------------------------


def test_saem_fit_and_evalrank_match_jax(tmp_path):
    """A tiny SAEM fit on the CPU (the tiny BERT from bert_path, a trans_cfg
    at final_dims): BERT leaves the fit as the seed drew it, the checkpoint
    holds the two parts, evalrank_single on model_best reproduces best_rsum,
    and the JAX evalrank_single ranks the converted checkpoint identically
    (fp32), as the JAX evalrank_ensemble ranks the best and the first
    epoch's checkpoints as the port's does."""
    synthetic.generate(str(tmp_path / "f30k_precomp"), n_images=24, img_dim=IMG, n_regions=R,
                       n_concepts_range=(1, 4))
    (tmp_path / "bert_config.json").write_text(json.dumps(dict(BERT, hidden_dropout_prob=0.1)))
    synthetic.write_tiny_bert_vocab(str(tmp_path / "vocab.txt"))
    (tmp_path / "trans_cfg.json").write_text(json.dumps(dict(TRANS, hidden_dropout_prob=0.1)))
    args = dict(data_path=str(tmp_path), data_name="f30k_precomp", bert_path=str(tmp_path),
                trans_cfg=str(tmp_path / "trans_cfg.json"), img_dim=IMG, final_dims=FINAL,
                max_words=L, batch_size=24, num_epochs=2, val_step=3, log_step=5, seed=3,
                learning_rate=0.001, save_path=f"{tmp_path}/runs")
    cfg = configs.parse_cli(["with", "SAEM"] + [f"{k}={v}" for k, v in args.items()])
    state, best_rsum = fit(cfg, device="cpu")
    assert state.step == 2 * 5
    seeded = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(cfg["seed"]))
    for k, v in seeded.txt_enc.bert.state_dict().items():
        torch.testing.assert_close(state.model.txt_enc.bert.state_dict()[k], v, rtol=0, atol=0)
    best = os.path.join(cfg["save_dir"], "model_best.pth.tar")
    ck = load_checkpoint(best)
    assert len(ck["model"]) == 2 and ck["best_rsum"] == pytest.approx(best_rsum)
    res = evalrank_single(best, split="dev", device="cpu")
    assert res["rsum"] == pytest.approx(ck["best_rsum"], abs=1e-9)
    out = convert_reference_checkpoint(best, out_path=str(tmp_path / "saem.itrx"))
    want = jevalrank_single(out, split="dev")
    for k in ("i2t_ranks", "t2i_ranks"):
        np.testing.assert_array_equal(res[k], np.asarray(want[k]))
    # the best and the first epoch's checkpoints as an ensemble (averaged grids)
    first = os.path.join(cfg["save_dir"], "epo0_checkpoint.pth.tar")
    res = evalrank_ensemble(best, first, split="dev", device="cpu")
    out2 = convert_reference_checkpoint(first, out_path=str(tmp_path / "saem_epo0.itrx"))
    want = jevalrank_ensemble(out, out2, split="dev")
    for k in ("i2t_ranks", "t2i_ranks"):
        np.testing.assert_array_equal(res[k], np.asarray(want[k]))
