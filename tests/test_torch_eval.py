"""The port's ranking metrics and the whole SCAN t2i evaluation slice vs the
JAX package, on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itrx.data import precomp, synthetic
from itrx.eval import engine as jengine
from itrx.eval import metrics as jmetrics
from itrx.models import get_model as jget_model
from itrx_torch.eval import engine, metrics
from itrx_torch.models import get_model
from itrx_torch.utils.convert import from_itrx_variables

torch.set_num_threads(1)

STAT_KEYS = ("rsum", "i2t_ave_r", "i2t_r1", "i2t_r5", "i2t_r10", "i2t_medr",
             "i2t_meanr", "t2i_ave_r", "t2i_r1", "t2i_r5", "t2i_r10",
             "t2i_medr", "t2i_meanr")


def _assert_same_recall(got, want):
    """Identical ranks; stats equal up to the JAX package's fp32 rounding
    (the port computes them in float64, as the reference does with numpy)."""
    for k in STAT_KEYS:
        assert got[k] == pytest.approx(want[k], rel=1e-6), (k, got[k], want[k])
    assert got["result"][0] == pytest.approx(want["result"][0], rel=1e-6)
    for k in ("i2t_ranks", "t2i_ranks"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("n", [9, 10])
def test_cal_recall_matches_jax_with_ties(rng, n):
    sims = rng.standard_normal((n, 5 * n)).astype(np.float32)
    sims[np.arange(n), 5 * np.arange(n)] += 1.5  # some gt captions win
    # bf16 rounding plants exact ties; copy some gt scores onto other cells
    sims = np.array(jnp.asarray(sims).astype(jnp.bfloat16).astype(jnp.float32))
    sims[0, 7] = sims[0, 0]
    sims[3, 2] = sims[0, 2]
    sims[n - 1, 1] = sims[0, 1]
    got = metrics.cal_recall(torch.from_numpy(sims), verbose=False)
    want = jmetrics.cal_recall(jnp.asarray(sims), verbose=False)
    _assert_same_recall(got, want)


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_slice")
    d = synthetic.generate(str(root / "synthetic"), n_images=64, img_dim=64,
                           n_concepts_range=(1, 10))
    cfg = {
        "name": "SCAN", "data_path": os.path.dirname(d),
        "data_name": os.path.basename(d), "vocab_path": os.path.join(d, "vocab"),
        "vocab_type": "json", "text_encoder": "gru", "use_bbox": False,
        "pad_words": 96, "batch_size": 24, "embed_size": 128, "word_dim": 32,
        "img_dim": 64, "bi_gru": False, "no_imgnorm": False, "no_txtnorm": True,
        "precomp_enc_type": "basic", "margin": 0.2, "max_violation": False,
        "cross_attn": "t2i", "raw_feature_norm": "clipped_l2norm",
        "agg_func": "LogSumExp", "lambda_lse": 6.0, "lambda_softmax": 9.0,
    }
    ds = precomp.PrecompDataset(d, "test", cfg)
    cfg["vocab_size"] = ds.vocab_size
    jmodel = jget_model(cfg)
    batch = ds.gather(np.arange(cfg["batch_size"]))
    variables = jax.device_get(jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        {k: jnp.asarray(v) for k, v in batch.items()}, train=False,
    ))
    model = get_model(cfg)
    model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in from_itrx_variables(variables).items()}
    )
    return cfg, ds, jmodel, variables, model


def test_slice_matches_jax(slice_setup):
    """encode_data -> cal_sims (bucketed: 80 captions) -> cal_recall."""
    cfg, ds, jmodel, variables, model = slice_setup
    assert len(ds) == 80 and ds.im_div == 5

    jenc = jengine.encode_data(jmodel, variables, ds, cfg["batch_size"])
    jsims = jengine.cal_sims(jmodel, variables, jenc["img"][:: ds.im_div], jenc["cap"],
                             jenc["cap_mask"], verbose=False)
    want = jmetrics.cal_recall(jsims, verbose=False)

    enc = engine.encode_data(model, ds, cfg["batch_size"], device="cpu")
    assert len(engine.length_buckets(enc["cap_mask"], enc["cap"].shape[1])) > 1
    sims = engine.cal_sims(model, enc["img"][:: ds.im_div], enc["cap"], enc["cap_mask"],
                           verbose=False)
    got = metrics.cal_recall(sims, verbose=False)

    np.testing.assert_allclose(enc["cap"].numpy(), np.asarray(jenc["cap"]), atol=1e-5)
    np.testing.assert_allclose(sims.numpy(), np.asarray(jsims), atol=1e-4)
    _assert_same_recall(got, want)


def test_plain_tiling_does_not_change_sims(slice_setup, monkeypatch):
    """A tiny attention budget forces one-caption tiles on the plain path."""
    cfg, ds, _, _, model = slice_setup
    enc = engine.encode_data(model, ds, cfg["batch_size"], device="cpu")
    imgs = enc["img"][:: ds.im_div]
    whole = engine.cal_sims(model, imgs, enc["cap"], enc["cap_mask"], verbose=False)
    monkeypatch.setattr(engine, "PLAIN_ATTN_BYTES", 1)
    tiled = engine.cal_sims(model, imgs, enc["cap"], enc["cap_mask"], verbose=False)
    np.testing.assert_allclose(tiled.numpy(), whole.numpy(), atol=1e-6)


def test_evaluate_split_bf16_close_to_jax(slice_setup):
    """encode_bf16 + eval_bf16 through evaluate_split in both packages: the
    two bf16 chains round at different places, so recalls may move by a
    rank flip or two (one i2t flip = 6.25pp on 16 images)."""
    cfg, ds, jmodel, variables, model = slice_setup
    bcfg = dict(cfg, encode_bf16=True, eval_bf16=True)
    want = jengine.evaluate_split(jmodel, variables, ds, bcfg)
    got = engine.evaluate_split(model, ds, bcfg, device="cpu")
    assert got["data_name"] == want["data_name"]
    assert abs(got["rsum"] - want["rsum"]) <= 30.0, (got["rsum"], want["rsum"])
