"""The port's VSRN (image tower with RsGCN blocks and the region GRU,
sentence-level captions, the caption model, cosine and order grids) vs the
JAX package on the CPU at small widths (embed 64, dim_hidden 32, 6 regions,
max_len 8), weights carried JAX -> port through itrx_torch.utils.convert,
with every RsGCN block's W.1 scale and bias and every BatchNorm statistic
moved off its init (at init W.1 is zero: the blocks are the identity and
their g, theta, phi and W.0 get no gradient, so a fault there would not
show).  Also the exact state-dict round trip (caption model included), the
unbucketed 2-D grid of the engine, the whole slice through evaluate_split,
bf16 encode with the BatchNorms' statistics kept fp32, and a port VSRN
checkpoint into the JAX evalrank_single.  Inputs come from numpy with a
seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itrx.configs import parse_cli
from itrx.data import synthetic
from itrx.eval import engine as jengine
from itrx.eval.engine import evalrank_single as jevalrank_single
from itrx.models import get_model as jget_model
from itrx.models.img_encoders import EncoderImagePrecompAttn as JEncoderImagePrecompAttn
from itrx.models.vsrn_decoder import S2VTAttModel as JS2VTAttModel
from itrx.utils.ref_convert import (convert_reference_checkpoint, convert_state_list,
                                    merge_into_variables)
from itrx_torch.data import precomp
from itrx_torch.eval import engine
from itrx_torch.eval.engine import evalrank_single
from itrx_torch.models import get_model
from itrx_torch.models.img_encoders import EncoderImagePrecompAttn
from itrx_torch.train.state import create_train_state
from itrx_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from itrx_torch.utils.convert import from_itrx_variables, to_itrx_flat

torch.set_num_threads(1)

VOCAB = 40
IMG, E, R = 48, 64, 6
HD, W = 32, 16
MAX_LEN = 8
L = MAX_LEN + 1
# fp32: the same chain in another summation order
FP32_ATOL = 1e-5
# bf16 encode: both packages run the towers in bf16 (the port's BatchNorm
# normalizes as itrx's TorchBatchNormCore: fp32 statistics cast to bf16);
# summation order moves the bf16 roundings apart through the GRUs (measured
# 1.6e-2 on the image embeddings, 2.0e-3 on the captions; unit-norm)
BF16_ATOL = 3e-2


def _cfg(**kw):
    cfg = dict(name="VSRN", vocab_size=VOCAB, img_dim=IMG, embed_size=E, word_dim=W,
               data_name="f30k_precomp", measure="cosine", use_abs=False, no_imgnorm=False,
               no_txtnorm=False, margin=0.2, max_violation=True, max_len=MAX_LEN,
               dim_hidden=HD, dim_vid=E, dim_word=W, input_dropout_p=0.0)
    cfg.update(kw)
    return cfg


def _batch(rng, b=6, vocab=VOCAB):
    """Caption ids over all max_len + 1 slots with the all-ones `cap_mask`
    of VSRN's data, and the labels' ragged real-token mask."""
    lengths = rng.integers(3, L + 1, b)
    lengths[0] = L
    lmask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    ids = (rng.integers(1, vocab, (b, L)) * lmask).astype(np.int32)
    return {"images": rng.standard_normal((b, R, IMG)).astype(np.float32), "cap_ids": ids,
            "cap_mask": np.ones((b, L), np.float32), "label_ids": ids, "label_mask": lmask}


def _perturb(variables, rng):
    """Each RsGCN block's W.1 (flax W_bn) scale and bias, and every
    BatchNorm's running statistics (W.1's and the f30k `bn`'s), moved off
    their init."""
    p, st = variables["params"]["img_enc"], variables["batch_stats"]["img_enc"]
    for i in range(1, 5):
        bn = p[f"Rs_GCN_{i}"]["W_bn"]
        bn["scale"] = rng.uniform(0.5, 1.5, bn["scale"].shape).astype(np.float32)
        bn["bias"] = (rng.standard_normal(bn["bias"].shape) * 0.1).astype(np.float32)
    stats = [st[f"Rs_GCN_{i}"]["W_bn"] for i in range(1, 5)]
    if "bn" in st:
        stats.append(st["bn"]["BatchNorm_0"])
    for s in stats:
        s["mean"] = (rng.standard_normal(s["mean"].shape) * 0.1).astype(np.float32)
        s["var"] = rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)
    return variables


def _init(cfg, batch, seed=0):
    """`itrx`'s VSRN variables as numpy (the decoder traces only in train
    mode), perturbed."""
    jmodel = jget_model(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.device_get(jax.jit(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)}, b,
        train=True))(jb))
    return _perturb(jax.tree.map(np.array, variables), np.random.default_rng(seed + 5))


def _port(cfg, variables):
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in from_itrx_variables(variables).items()},
        strict=True)
    return model


def _np(t):
    return t.detach().cpu().numpy()


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def vsrn():
    """(cfg, a batch, `itrx`'s variables as numpy, the port model)."""
    cfg = _cfg()
    batch = _batch(np.random.default_rng(21))
    variables = _init(cfg, batch)
    return cfg, batch, variables, _port(cfg, variables)


def _img_sd(params, stats) -> dict:
    """A flax image tower's weights and statistics as the port's
    EncoderImagePrecompAttn state dict (numpy), through the model
    converter with an empty text tower beside it."""
    fake = {"params": {"img_enc": params,
                       "txt_enc": {"embedding": np.zeros((1, 1), np.float32),
                                   "MaskedGRU_0": {}}},
            "batch_stats": {"img_enc": stats}}
    return {k[len("img_enc."):]: v for k, v in from_itrx_variables(fake).items()
            if k.startswith("img_enc.")}


@pytest.mark.parametrize("data_name", ["f30k_precomp", "coco_precomp"])
@pytest.mark.parametrize("train", [False, True])
def test_image_tower_matches_flax(data_name, train):
    """EncoderImagePrecompAttn (fc, four RsGCN blocks, the region-axis
    l2norms, the region GRU, on f30k the `bn`) in eval mode (running
    statistics) and train mode (batch statistics pooled over B x regions,
    the running update) vs flax with a mutable batch_stats: the features,
    the GCN sequence and every statistic after the step."""
    rng = np.random.default_rng(3)
    images = rng.standard_normal((5, R, IMG)).astype(np.float32)
    jenc = JEncoderImagePrecompAttn(embed_size=E, data_name=data_name)
    variables = jax.tree.map(np.array, jenc.init(jax.random.PRNGKey(2), jnp.asarray(images),
                                                 train=True))
    variables = _perturb({"params": {"img_enc": variables["params"]},
                          "batch_stats": {"img_enc": variables["batch_stats"]}}, rng)
    params, stats = variables["params"]["img_enc"], variables["batch_stats"]["img_enc"]
    enc = EncoderImagePrecompAttn(IMG, E, data_name)
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in _img_sd(params, stats).items()})
    enc.train(train)
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    (want, want_gcn), mut = jenc.apply({"params": params, "batch_stats": stats},
                                       jnp.asarray(images), train=train,
                                       mutable=["batch_stats"])
    got, got_gcn = enc(torch.from_numpy(images))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=FP32_ATOL)
    np.testing.assert_allclose(_np(got_gcn), np.asarray(want_gcn), atol=FP32_ATOL)
    assert ("bn" in stats) == (data_name == "f30k_precomp")
    new = _img_sd(params, jax.tree.map(np.array, mut["batch_stats"]))
    for k, v in enc.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(_np(v), new[k], rtol=1e-5, atol=1e-6, err_msg=k)
            assert torch.equal(v, before[k]) != train, k  # moved in train mode only


def test_caption_model_logprobs_match_flax(vsrn):
    """S2VTAttModel in train mode at input_dropout_p 0 (the encoder GRU over
    the GCN sequence, the decode loop through vsrn_dec_fused's plain pair,
    the vocab projection): log-probs (B, max_len - 1, V) vs flax."""
    cfg, batch, variables, model = vsrn
    rng = np.random.default_rng(4)
    gcn = rng.standard_normal((6, R, E)).astype(np.float32) * 0.3
    want = JS2VTAttModel(vocab_size=VOCAB, max_len=MAX_LEN, dim_vid=E, dim_hidden=HD,
                         dim_word=W, input_dropout_p=0.0).apply(
        {"params": jax.tree.map(jnp.asarray, variables["params"]["caption_model"])},
        jnp.asarray(gcn),
        jnp.asarray(batch["label_ids"]), train=True)
    got = model.caption_model.train()(torch.from_numpy(gcn),
                                      torch.from_numpy(batch["label_ids"]))
    assert got.shape == (6, MAX_LEN - 1, VOCAB)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=FP32_ATOL)


@pytest.mark.parametrize("measure,use_abs", [("cosine", False), ("order", True)])
def test_vsrn_embed_and_similarity_match_jax(vsrn, measure, use_abs):
    """embed in eval mode (no GCN sequence kept) and the (Ni, Nc) grid,
    cosine and order (with use_abs), vs `itrx`."""
    cfg, batch, variables, _ = vsrn
    cfg = dict(cfg, measure=measure, use_abs=use_abs)
    jmodel = jget_model(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jv = jax.tree.map(jnp.asarray, variables)
    je = jmodel.apply(jv, jb, train=False, method="embed")
    want = jmodel.apply(jv, je["img"], je["cap"], method="similarity")
    model = _port(cfg, variables)
    with torch.no_grad():
        e = model.embed(_t(batch))
        got = model.similarity(e["img"], e["cap"])
    assert sorted(e) == ["cap", "img"]
    for k in ("img", "cap"):
        np.testing.assert_allclose(_np(e[k]), np.asarray(je[k]), atol=FP32_ATOL)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=FP32_ATOL)


def test_vsrn_state_dict_round_trip_is_exact(vsrn):
    """port -> [img_enc, txt_enc, caption_model] -> ref_convert -> the JAX
    tree, running statistics and the caption model included, bit for bit."""
    cfg, _, variables, model = vsrn
    state_list = to_itrx_flat(model.state_dict())
    assert len(state_list) == 3 and "decoder.attention.linear2.weight" in state_list[2]
    merged = merge_into_variables(variables, convert_state_list("VSRN", state_list, cfg))
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    for (path, want), got in zip(leaves, jax.tree_util.tree_leaves(merged)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=str(path))
    n_tracked = sum(k.endswith("num_batches_tracked") for k in model.state_dict())
    assert len(leaves) == len(model.state_dict()) - n_tracked
    assert n_tracked == 5


@pytest.mark.parametrize("measure", ["cosine", "order"])
def test_cal_sims_2d_tiles_match_one_product(vsrn, measure, monkeypatch):
    """Sentence-level embeddings go through the engine's tiled 2-D grid
    (no mask): with tiles of 4 images x 8 captions, the same grid as one
    similarity call, bit for bit, and bf16 stacks give an fp32 grid."""
    cfg, _, variables, _ = vsrn
    model = _port(dict(cfg, measure=measure), variables).eval()
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.standard_normal((11, E)).astype(np.float32))
    cap = torch.from_numpy(rng.standard_normal((21, E)).astype(np.float32))
    want = model.similarity(img, cap)
    monkeypatch.setattr(engine, "IMG_TILE", 4)
    monkeypatch.setattr(engine, "CAP_TILE", 8)
    got = engine.cal_sims(model, img, cap, None, verbose=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    half = engine.cal_sims(model, img, cap, compute_dtype=torch.bfloat16, verbose=False)
    assert half.dtype == torch.float32
    torch.testing.assert_close(half, model.similarity(img.bfloat16(), cap.bfloat16()),
                               rtol=0, atol=0)


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    """A tiny synthetic f30k-named split (16 test images x 80 captions, the
    shipped f30k vocabulary) and VSRN in both packages with the same
    perturbed weights."""
    root = tmp_path_factory.mktemp("torch_vsrn")
    d = synthetic.generate(str(root / "f30k_precomp"), n_images=64, img_dim=IMG, n_regions=R,
                           n_concepts_range=(1, 4))
    cfg = dict(_cfg(), data_path=str(root), vocab_path=str(root / "vocab"),
               vocab_type="json", text_encoder="gru", use_bbox=False, pad_words=96,
               batch_size=24)
    ds = precomp.PrecompDataset(d, "test", cfg)
    cfg["vocab_size"] = ds.vocab_size
    variables = _init(cfg, ds.gather(np.arange(6)), seed=3)
    return cfg, ds, jget_model(cfg), variables, _port(cfg, variables)


def _assert_same_ranks(got, want):
    for k in ("i2t_ranks", "t2i_ranks"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert got["rsum"] == pytest.approx(float(want["rsum"]), rel=1e-6)


def test_vsrn_slice_matches_jax(slice_setup):
    """encode_data -> cal_sims (the 2-D grid) -> cal_recall through
    evaluate_split in both packages, fp32: the grid at 1e-5 and identical
    ranks."""
    cfg, ds, jmodel, variables, model = slice_setup
    want = jengine.evaluate_split(jmodel, variables, ds, cfg)
    got = engine.evaluate_split(model, ds, cfg, device="cpu")
    _assert_same_ranks(got, want)
    jenc = jengine.encode_data(jmodel, variables, ds, cfg["batch_size"])
    enc = engine.encode_data(model, ds, cfg["batch_size"], device="cpu")
    assert sorted(enc) == ["cap", "img"] and enc["cap"].dim() == 2
    jsims = jengine.cal_sims(jmodel, variables, jenc["img"][:: ds.im_div], jenc["cap"],
                             verbose=False)
    sims = engine.cal_sims(model, enc["img"][:: ds.im_div], enc["cap"], verbose=False)
    np.testing.assert_allclose(sims.numpy(), np.asarray(jsims), atol=FP32_ATOL)


def test_vsrn_bf16_encode_matches_itrx_and_keeps_statistics(slice_setup):
    """encode_data with encode_dtype bf16 runs VSRN's BatchNorms (the RsGCN
    W.1 and the f30k `bn`) with bf16 weights on fp32 running statistics, as
    itrx's bf16 encode does (its TorchBatchNormCore: fp32 statistics cast to
    the input's dtype): the embeddings within a bf16 tolerance of itrx's,
    and every running statistic fp32 and bit-identical before and after."""
    cfg, ds, jmodel, variables, model = slice_setup
    model.eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    enc = engine.encode_data(model, ds, cfg["batch_size"], device="cpu",
                             compute_dtype=torch.bfloat16, encode_dtype=torch.bfloat16)
    jenc = jengine.encode_data(jmodel, variables, ds, cfg["batch_size"],
                               compute_dtype="bfloat16", encode_dtype="bfloat16")
    for k in ("img", "cap"):
        assert enc[k].dtype == torch.bfloat16
        np.testing.assert_allclose(enc[k].float().numpy(), np.asarray(jenc[k], np.float32),
                                   atol=BF16_ATOL, err_msg=k)
    for k, v in model.state_dict().items():
        assert v.dtype == before[k].dtype
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    assert model.img_enc.bn.running_var.dtype == torch.float32


def test_vsrn_checkpoint_converts_into_the_jax_package(slice_setup, tmp_path):
    """A port VSRN checkpoint ([img_enc, txt_enc, caption_model]) goes
    through convert_reference_checkpoint into the JAX evalrank_single with
    identical ranks, and the port's evalrank_single reads it back."""
    base, _, _, _, model = slice_setup
    cfg = parse_cli(["with", "VSRN", f"data_path={base['data_path']}",
                     "data_name=f30k_precomp", f"vocab_path={base['vocab_path']}",
                     "vocab_type=json", f"img_dim={IMG}", f"embed_size={E}",
                     f"word_dim={W}", f"dim_hidden={HD}", f"dim_vid={E}", f"dim_word={W}",
                     f"max_len={MAX_LEN}", "batch_size=24"], make_dirs=False)
    cfg["vocab_size"] = base["vocab_size"]
    port = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    port.load_state_dict(model.state_dict())
    path = str(tmp_path / "vsrn.pth.tar")
    save_checkpoint(create_train_state(port, cfg, 1), cfg, 0, 0.0, 0.0, path)
    assert [len(sd) for sd in load_checkpoint(path)["model"]] == [
        len(port.img_enc.state_dict()), len(port.txt_enc.state_dict()),
        len(port.caption_model.state_dict())]
    out = convert_reference_checkpoint(path, out_path=str(tmp_path / "vsrn.itrx"))
    want = jevalrank_single(out, split="test")
    got = evalrank_single(path, split="test", device="cpu")
    _assert_same_ranks(got, want)
