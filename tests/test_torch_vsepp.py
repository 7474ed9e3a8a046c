"""The port's VSE++ on precomputed features and the `weight_norm` image
encoder vs the JAX package on the CPU at small widths (img_dim 48, embed 32,
word_dim 16, a vocabulary of 50): WeightNormLinear, EncoderImagePrecomp
(`basic` and `weight_norm`, with and without `use_abs`, on flat and region
features), SCAN with `weight_norm`, VSE++ embed, the cosine and order grids,
the hinge loss with every gradient, one and three make_train_step updates,
the state-dict round trip through `itrx.utils.ref_convert`, the raw-image
refusal, and a tiny `fit` whose checkpoint `evalrank_single` ranks as the
JAX evalrank_single ranks it.  Weights go JAX -> port through
itrx_torch.utils.convert; inputs come from numpy with a seed."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itrx.eval.engine import evalrank_ensemble as jevalrank_ensemble
from itrx.eval.engine import evalrank_single as jevalrank_single
from itrx.models import get_model as jget_model
from itrx.models.img_encoders import EncoderImagePrecomp as JEncoderImagePrecomp
from itrx.models.layers import WeightNormLinear as JWeightNormLinear
from itrx.utils.ref_convert import (convert_reference_checkpoint, convert_state_list,
                                    merge_into_variables)
from itrx_torch.configs import parse_cli
from itrx_torch.data import synthetic
from itrx_torch.eval.engine import evalrank_ensemble, evalrank_single
from itrx_torch.models import get_model
from itrx_torch.models.img_encoders import EncoderImagePrecomp
from itrx_torch.models.layers import WeightNormLinear
from itrx_torch.train import loop
from itrx_torch.train.loop import fit
from itrx_torch.utils.checkpoint import load_checkpoint
from itrx_torch.utils.convert import from_itrx_variables, to_itrx_flat
from tests import test_torch_models, test_torch_train

torch.set_num_threads(1)

VOCAB, IMG, E, WORD = 50, 48, 32, 16
# fp32: the same chain in another summation order
FP32_ATOL = 1e-5
# gradients: within this share of each tensor's largest entry, as
# tests/test_torch_train.py holds SCAN's
GRAD_REL = 1e-4


def _cfg(**kw) -> dict:
    cfg = dict(name="VSE_PP", vocab_size=VOCAB, img_dim=IMG, embed_size=E, word_dim=WORD,
               measure="cosine", use_abs=False, no_imgnorm=False, no_txtnorm=True,
               margin=0.2, max_violation=False, data_name="f30k_precomp",
               img_encoder="vgg19", finetune=False, learning_rate=1e-3, lr_update=1,
               grad_clip=2.0, seed=0)
    cfg.update(kw)
    return cfg


def _batch(rng, b=6, l=10):
    """A VSE++ batch: one feature vector an image, ragged captions (the
    first full length)."""
    lengths = rng.integers(1, l + 1, b)
    lengths[0] = l
    mask = (np.arange(l)[None] < lengths[:, None]).astype(np.float32)
    return {"images": rng.standard_normal((b, IMG)).astype(np.float32),
            "cap_ids": (rng.integers(1, VOCAB, (b, l)) * mask).astype(np.int32),
            "cap_mask": mask}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# -- the image encoder ----------------------------------------------------


def test_weight_norm_linear_matches_jax(rng):
    """WeightNormLinear from `itrx`'s v (in, out), scalar g and bias, with g
    moved off ||v||_F: the output within FP32_ATOL; the keys are the
    reference's weight_v (out, in), weight_g () and bias."""
    x = rng.standard_normal((5, 7, IMG)).astype(np.float32)
    jlin = JWeightNormLinear(E)
    v = jax.device_get(jlin.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    v = {k: np.array(a) for k, a in v.items()}
    v["g"] = np.float32(0.7 * v["g"])
    lin = WeightNormLinear(IMG, E)
    assert [k for k, _ in lin.named_parameters()] == ["weight_v", "weight_g", "bias"]
    assert lin.weight_g.shape == () and lin.weight_v.shape == (E, IMG)
    torch.testing.assert_close(lin.weight_g, torch.linalg.vector_norm(lin.weight_v))
    lin.load_state_dict({"weight_v": torch.from_numpy(v["v"].T.copy()),
                         "weight_g": torch.tensor(v["g"]), "bias": torch.from_numpy(v["bias"])})
    with torch.no_grad():
        got = lin(torch.from_numpy(x)).numpy()
    want = np.asarray(jlin.apply({"params": v}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=FP32_ATOL)


@pytest.mark.parametrize("enc_type", ["basic", "weight_norm"])
@pytest.mark.parametrize("use_abs", [False, True])
@pytest.mark.parametrize("shape", [(6, IMG), (4, 9, IMG)])
def test_encoder_image_precomp_matches_jax(rng, enc_type, use_abs, shape):
    """EncoderImagePrecomp vs `itrx`'s on (B, D) and (B, R, D) features, each
    precomp_enc_type, with and without use_abs (after the l2norm)."""
    x = rng.standard_normal(shape).astype(np.float32)
    jenc = JEncoderImagePrecomp(E, precomp_enc_type=enc_type, use_abs=use_abs)
    v = jax.device_get(jenc.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    enc = EncoderImagePrecomp(IMG, E, precomp_enc_type=enc_type, use_abs=use_abs)
    sd = from_itrx_variables({"params": {"img_enc": v["params"],
                                         "txt_enc": {"embedding": np.zeros((1, 1)),
                                                     "MaskedGRU_0": {}}}})
    enc.load_state_dict({k[len("img_enc."):]: torch.from_numpy(a) for k, a in sd.items()
                         if k.startswith("img_enc.")}, strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    want = np.asarray(jenc.apply(v, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=FP32_ATOL)
    assert (got >= 0).all() if use_abs else (got < 0).any()


def test_encoder_image_precomp_refuses_an_unknown_type():
    with pytest.raises(ValueError, match="precomp_enc_type"):
        EncoderImagePrecomp(IMG, E, precomp_enc_type="other")


def test_scan_weight_norm_matches_jax(rng):
    """SCAN with precomp_enc_type weight_norm (built by get_model, its
    weights from `itrx`'s): embed and the t2i grid within FP32_ATOL, and the
    exact state-dict round trip through `itrx`'s reference converter."""
    cfg, jmodel, variables, model = test_torch_models._pair(
        rng, False, precomp_enc_type="weight_norm")
    assert isinstance(model.img_enc.fc, WeightNormLinear)
    batch = test_torch_models._batch(rng)
    with torch.no_grad():
        e = model.embed(_t(batch))
        sims = model.similarity(e["img"], e["cap"], e["cap_mask"])
    je = jmodel.apply(variables, _j(batch), method="embed")
    jsims = jmodel.apply(variables, je["img"], je["cap"], je["cap_mask"], method="similarity")
    np.testing.assert_allclose(e["img"].numpy(), np.asarray(je["img"]), atol=FP32_ATOL)
    np.testing.assert_allclose(sims.numpy(), np.asarray(jsims), atol=FP32_ATOL)
    _assert_round_trip(cfg, model, variables)


# -- VSE++ ------------------------------------------------------------------


def _pair(rng, **kw):
    """(cfg, JAX model, its variables as numpy, the port model with them)."""
    cfg = _cfg(**kw)
    jmodel, variables, model = test_torch_train._pair(rng, cfg, _batch)
    return cfg, jmodel, variables, model


def _assert_round_trip(cfg, model, variables):
    """The port's state dict -> the reference's list -> `itrx`'s converter ->
    the same variables, exactly."""
    flat = convert_state_list(cfg["name"], to_itrx_flat(model.state_dict()), cfg)
    merged = merge_into_variables(variables, flat)
    assert len(flat) == len(jax.tree.leaves(variables))
    for a, b in zip(jax.tree.leaves(merged), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("measure,use_abs,no_imgnorm", [
    ("cosine", False, False), ("order", True, False), ("cosine", True, True)])
def test_vsepp_embed_and_similarity_match_jax(rng, measure, use_abs, no_imgnorm):
    """VSE++ embed (the image Linear, the text GRU's last valid output,
    l2norm whatever no_txtnorm says, use_abs) and the cosine or order grid
    vs `itrx` within FP32_ATOL; the grid is one product, with no kernel."""
    cfg, jmodel, variables, model = _pair(rng, measure=measure, use_abs=use_abs,
                                          no_imgnorm=no_imgnorm)
    assert not model.fused_eval_active(torch.device("cuda"))
    batch = _batch(rng)
    with torch.no_grad():
        e = model.embed(_t(batch))
        sims = model.similarity(e["img"], e["cap"])
    je = jmodel.apply(variables, _j(batch), method="embed")
    jsims = jmodel.apply(variables, je["img"], je["cap"], method="similarity")
    assert sorted(e) == ["cap", "img"] and e["img"].shape == (6, E)
    for k in ("img", "cap"):
        np.testing.assert_allclose(e[k].numpy(), np.asarray(je[k]), atol=FP32_ATOL, err_msg=k)
    np.testing.assert_allclose(sims.numpy(), np.asarray(jsims), atol=FP32_ATOL)
    torch.testing.assert_close(e["cap"].norm(dim=1), torch.ones(6))


@pytest.mark.parametrize("measure,max_violation", [("cosine", False), ("cosine", True),
                                                   ("order", True)])
def test_vsepp_loss_and_grads_match_jax(rng, measure, max_violation):
    """VSE++.loss (the hinge on the in-batch grid) and every parameter's
    gradient vs `itrx`: loss rtol 1e-5, gradients within GRAD_REL of each
    tensor's largest entry."""
    cfg, jmodel, variables, model = _pair(rng, measure=measure, max_violation=max_violation)
    batch = _batch(rng)
    loss, aux = model.loss(_t(batch))
    loss.backward()
    assert sorted(aux) == ["Loss"]
    (jl, _), jg = jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, _j(batch), train=True, method="loss"),
        has_aux=True)(variables["params"])
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = from_itrx_variables({"params": jax.device_get(jg)})
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        scale = float(np.abs(want[k]).max())
        assert scale > 0, k
        np.testing.assert_allclose(got[k], want[k], atol=GRAD_REL * scale, err_msg=k)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_vsepp_train_steps_match_jax(rng, n_steps):
    """Weights after 1 and 3 make_train_step updates vs `itrx`'s
    make_train_step from the same weights and batches, at the limits (and
    for the reasons) of tests/test_torch_train.py::test_train_steps_match_jax."""
    test_torch_train._check_train_steps(rng, _cfg(max_violation=True), n_steps, _batch)


def test_vsepp_state_dict_round_trip_and_keys(rng):
    """The port's VSE++ state dict is the reference's ([img_enc, txt_enc]:
    fc, embed, rnn) and goes back through `itrx`'s converter exactly."""
    cfg, _, variables, model = _pair(rng)
    parts = to_itrx_flat(model.state_dict())
    assert [sorted(p) for p in parts] == [
        ["fc.bias", "fc.weight"],
        ["embed.weight", "rnn.bias_hh_l0", "rnn.bias_ih_l0", "rnn.weight_hh_l0",
         "rnn.weight_ih_l0"]]
    _assert_round_trip(cfg, model, variables)


@pytest.mark.parametrize("data_name", ["coco", "f8k", "f30k"])
def test_raw_image_vsepp_names_its_roadmap_item(data_name):
    """VSE++ on a raw-image dataset (the CNN towers) is refused by get_model
    and by training's check_supported, naming ROADMAP item 12; on a
    precomputed split it trains."""
    cfg = _cfg(data_name=data_name)
    with pytest.raises(NotImplementedError, match="item 12"):
        get_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        loop.check_supported(cfg)
    loop.check_supported(_cfg(name="VSE++"))


# -- fit and evaluation ------------------------------------------------------


def test_vsepp_fit_and_evalrank_match_jax(tmp_path):
    """A tiny VSE++ fit on the CPU over a flat split (one vector an image,
    the region mean, as tests/test_e2e.py makes it): the checkpoint holds
    the two parts, evalrank_single on model_best reproduces best_rsum, the
    JAX evalrank_single ranks the converted checkpoint identically (fp32),
    and the JAX evalrank_ensemble ranks the best and the first epoch's
    checkpoints as the port's does."""
    d = synthetic.generate(str(tmp_path / "f30k_precomp"), n_images=24, img_dim=IMG,
                           n_concepts_range=(1, 4))
    for split in ("train", "dev", "test"):
        path = os.path.join(d, f"{split}_ims.npy")
        np.save(path, np.load(path).mean(axis=1))
    args = dict(data_path=str(tmp_path), data_name="f30k_precomp",
                vocab_path=str(tmp_path / "vocab"), vocab_type="json", img_dim=IMG,
                embed_size=E, word_dim=WORD, batch_size=24, num_epochs=2, val_step=3,
                log_step=1, learning_rate=0.003, max_violation=True, seed=3,
                save_path=f"{tmp_path}/runs")
    cfg = parse_cli(["with", "VSE_PP"] + [f"{k}={v}" for k, v in args.items()])
    state, best_rsum = fit(cfg, device="cpu")
    assert state.step == 2 * 5
    best = os.path.join(cfg["save_dir"], "model_best.pth.tar")
    ck = load_checkpoint(best)
    assert len(ck["model"]) == 2 and ck["best_rsum"] == pytest.approx(best_rsum)
    assert ck["model"][0]["fc.weight"].shape == (E, IMG)
    res = evalrank_single(best, split="dev", device="cpu")
    assert res["rsum"] == pytest.approx(ck["best_rsum"], abs=1e-9)
    out = convert_reference_checkpoint(best, out_path=str(tmp_path / "vsepp.itrx"))
    want = jevalrank_single(out, split="dev")
    for k in ("i2t_ranks", "t2i_ranks"):
        np.testing.assert_array_equal(res[k], np.asarray(want[k]))
    # the best and the first epoch's checkpoints as an ensemble (averaged grids)
    first = os.path.join(cfg["save_dir"], "epo0_checkpoint.pth.tar")
    res = evalrank_ensemble(best, first, split="dev", device="cpu")
    out2 = convert_reference_checkpoint(first, out_path=str(tmp_path / "vsepp_epo0.itrx"))
    want = jevalrank_ensemble(out, out2, split="dev")
    for k in ("i2t_ranks", "t2i_ranks"):
        np.testing.assert_array_equal(res[k], np.asarray(want[k]))
