"""The port's SCAN vs the JAX package's SCAN from one weight set, on the
CPU.  Weights go JAX -> port through itrx_torch.utils.convert, and back
through the reference converter itrx.utils.ref_convert, exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itrx.models import get_model as jget_model
from itrx.models.txt_encoders import EncoderText as JEncoderText
from itrx.utils.ref_convert import convert_state_list, merge_into_variables
from itrx_torch.models import get_model
from itrx_torch.models.txt_encoders import EncoderText
from itrx_torch.utils.convert import from_itrx_variables, to_itrx_flat

torch.set_num_threads(1)

VOCAB = 50


def _cfg(bi_gru, **kw):
    cfg = dict(
        name="SCAN", vocab_size=VOCAB, img_dim=48, embed_size=128, word_dim=32,
        bi_gru=bi_gru, no_imgnorm=False, no_txtnorm=True,
        precomp_enc_type="basic", margin=0.2, max_violation=False,
        cross_attn="t2i", raw_feature_norm="clipped_l2norm",
        agg_func="LogSumExp", lambda_lse=6.0, lambda_softmax=9.0,
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


def _pair(rng, bi_gru, **kw):
    """(cfg, JAX model, JAX variables as numpy, port model with the same weights)."""
    cfg = _cfg(bi_gru, **kw)
    jmodel = jget_model(cfg)
    jb = {k: jnp.asarray(v) for k, v in _batch(rng).items()}
    variables = jax.device_get(
        jmodel.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                    jb, train=False)
    )
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    sd = {k: torch.from_numpy(v) for k, v in from_itrx_variables(variables).items()}
    model.load_state_dict(sd, strict=True)
    return cfg, jmodel, variables, model


@pytest.mark.parametrize("bi_gru", [False, True])
def test_scan_embed_and_similarity_match_jax(rng, bi_gru):
    cfg, jmodel, variables, model = _pair(rng, bi_gru)
    batch = _batch(rng)
    jout = jmodel.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()},
                        method="embed")
    with torch.no_grad():
        out = model.embed({k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("img", "cap"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), atol=1e-5)
    with torch.no_grad():
        s = model.similarity(out["img"], out["cap"], out["cap_mask"]).numpy()
    js = jmodel.apply(variables, jout["img"], jout["cap"], jout["cap_mask"],
                      method="similarity")
    np.testing.assert_allclose(s, np.asarray(js), atol=1e-5)


@pytest.mark.parametrize("bi_gru", [False, True])
def test_state_dict_round_trip_is_exact(rng, bi_gru):
    cfg, _, variables, model = _pair(rng, bi_gru)
    state_list = to_itrx_flat(model.state_dict())
    flat = convert_state_list("SCAN", state_list, cfg)
    merged = merge_into_variables(variables, flat)
    for leaf_a, leaf_b in zip(jax.tree_util.tree_leaves(merged),
                              jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(leaf_a), np.asarray(leaf_b))
    assert len(jax.tree_util.tree_leaves(variables)) == len(model.state_dict())


def test_bf16_embed_close_to_jax_bf16(rng):
    cfg, jmodel, variables, model = _pair(rng, True)
    batch = _batch(rng)
    bf = jnp.bfloat16
    jv = {"params": jax.tree.map(lambda x: jnp.asarray(x).astype(bf), variables["params"])}
    jb = {k: jnp.asarray(v).astype(bf) if v.dtype == np.float32 and k != "cap_mask"
          else jnp.asarray(v) for k, v in batch.items()}
    jout = jmodel.apply(jv, jb, method="embed")
    params = {k: p.to(torch.bfloat16) for k, p in model.named_parameters()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["images"] = tb["images"].to(torch.bfloat16)
    with torch.no_grad():
        out = torch.func.functional_call(model, params, (tb,))
    for k in ("img", "cap"):
        assert out[k].dtype == torch.bfloat16
        diff = np.abs(out[k].float().numpy() - np.asarray(jout[k], np.float32)).max()
        assert diff <= 2e-2, (k, diff)


def test_sentence_level_text_encoder_matches_jax(rng):
    batch = _batch(rng)
    jenc = JEncoderText(vocab_size=VOCAB, word_dim=32, embed_size=128,
                        use_bi_gru=True, sentence_level=True)
    ids, mask = jnp.asarray(batch["cap_ids"]), jnp.asarray(batch["cap_mask"])
    v = jax.device_get(jenc.init(jax.random.PRNGKey(0), ids, mask))
    enc = EncoderText(VOCAB, 32, 128, use_bi_gru=True, sentence_level=True)
    sd = from_itrx_variables({"params": {"img_enc": {"fc": {"kernel": np.zeros((1, 1)),
                                                             "bias": np.zeros(1)}},
                                         "txt_enc": v["params"]}})
    enc.load_state_dict({k[len("txt_enc."):]: torch.from_numpy(a)
                         for k, a in sd.items() if k.startswith("txt_enc.")})
    with torch.no_grad():
        got = enc(torch.from_numpy(batch["cap_ids"]), torch.from_numpy(batch["cap_mask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(jenc.apply(v, ids, mask)), atol=1e-5)


@pytest.mark.parametrize("name", ["VSE_PP", "VSRN", "SAEM", "CAMERA"])
def test_unported_methods_name_their_roadmap_item(name):
    """The two methods not ported yet (VSE++, SAEM) each name their item;
    VSRN, ported with its training, builds with the reference's parts and
    keys (SGRAF is ported with SGR and SAF); CAMERA, whose evaluation is
    ported, builds with its two parts, and its loss names the item that
    ports its training (11b)."""
    cfg = _cfg(False, name=name, module_name="SGR", sim_dim=16, data_name="f30k_precomp",
               measure="cosine", use_abs=False, max_len=7, dim_hidden=16, dim_vid=128,
               dim_word=8, input_dropout_p=0.2)
    if name == "CAMERA":
        with torch.device("meta"):
            model = get_model(dict(cfg, head=4, smry_k=3, smry_lamda=0.01, drop=0.0),
                              device="meta")
        assert [n for n, _ in model.named_children()] == ["img_enc", "txt_enc"]
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 11b"):
            model.loss({})
        return
    if name != "VSRN":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_model(cfg, device="cpu")
        return
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert not model.training and not model.fused_eval_active(torch.device("cuda"))
    sd = model.state_dict()
    assert sd["img_enc.Rs_GCN_1.g.weight"].shape == (128, 128, 1)
    assert sd["img_enc.bn.running_var"].shape == (128,)
    assert sd["img_enc.img_rnn.weight_hh_l0"].shape == (3 * 128, 128)
    assert sd["caption_model.decoder.rnn.weight_ih_l0"].shape == (3 * 16, 8 + 16)
    assert sd["caption_model.decoder.attention.linear1.weight"].shape == (16, 32)
    assert sd["caption_model.decoder.out.weight"].shape == (VOCAB, 16)
    # W.1 starts at zero: every RsGCN block starts as the identity
    assert not sd["img_enc.Rs_GCN_4.W.1.weight"].any()


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("agg,lambda_lse", [("Mean", 6.0), ("LogSumExp", 5.0)])
def test_scan_i2t_embed_and_similarity_match_jax(rng, agg, lambda_lse, train):
    """SCAN's published i-t variants (lambda_softmax 4): embed and the
    similarity grid, in training and in evaluation (both the plain path on
    the CPU), from converted JAX weights at 1e-5."""
    cfg, jmodel, variables, model = _pair(rng, True, cross_attn="i2t", agg_func=agg,
                                          lambda_softmax=4.0, lambda_lse=lambda_lse)
    assert model.cross_attn == "i2t"
    batch = _batch(rng)
    jout = jmodel.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()},
                        method="embed")
    with torch.no_grad():
        out = model.embed({k: torch.from_numpy(v) for k, v in batch.items()})
        s = model.similarity(out["img"], out["cap"], out["cap_mask"], train=train).numpy()
    for k in ("img", "cap"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), atol=1e-5)
    js = jmodel.apply(variables, jout["img"], jout["cap"], jout["cap_mask"], train=train,
                      method="similarity")
    np.testing.assert_allclose(s, np.asarray(js), atol=1e-5)
    # and it is not the t2i grid of the same embeddings
    t2i = jmodel.clone(cross_attn="t2i").apply(
        variables, jout["img"], jout["cap"], jout["cap_mask"], method="similarity")
    assert np.abs(np.asarray(t2i) - s).max() > 1e-3
