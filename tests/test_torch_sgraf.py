"""The port's SGRAF-SAF evaluation vs the JAX package, on the CPU, at small
widths (embed 128, sim_dim 128, 36 regions): l1norm, the self-attention
heads and SAF vs the flax modules, embed + similarity vs the XLA path, the
SAF eval kernel's plain version vs the interpret-mode Pallas kernel, the
whole evaluation slice, and checkpoints both ways through the reference
converter.  Weights go JAX -> port through itrx_torch.utils.convert, with
every BatchNorm's running statistics moved off (0, 1) so the eval-mode fold
has something to fold."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itrx.configs import parse_cli
from itrx.data import precomp, synthetic
from itrx.eval import engine as jengine
from itrx.eval.engine import evalrank_single as jevalrank_single
from itrx.models import get_model as jget_model
from itrx.models.sgraf import AttentionFiltration as JAttentionFiltration
from itrx.models.sgraf import TextSA as JTextSA
from itrx.models.sgraf import VisualSA as JVisualSA
from itrx.ops.norms import l1norm as jl1norm
from itrx.ops.pallas.sgraf_eval import sgraf_eval_saf_score
from itrx.utils.ref_convert import (convert_reference_checkpoint, convert_state_list,
                                    merge_into_variables)
from itrx_torch.eval import engine
from itrx_torch.eval.engine import evalrank_single
from itrx_torch.models import get_model
from itrx_torch.ops.kernels.sgraf_eval import fold_saf_bn, sgraf_eval_saf_plain
from itrx_torch.ops.norms import l1norm
from itrx_torch.train.state import create_train_state
from itrx_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from itrx_torch.utils.convert import from_itrx_variables, to_itrx_flat

torch.set_num_threads(1)

VOCAB = 50
E, S, R = 128, 128, 36
# fp32: the port and the XLA path compute the same chain in another order
FP32_ATOL = 1e-5
# the plain version against the interpret-mode Pallas kernel (fp32 operands
# at HIGHEST precision there), as tests/test_pallas_sgraf_eval.py holds it
KERNEL_ATOL = 2e-5
# bf16 embeddings: the JAX package runs the heads and the chain in bf16
# (XavierLinear casts its weight to the input's dtype), the port in fp32 on
# the bf16 values; scores are sigmoids near 0.5
BF16_ATOL = 1e-2


def _cfg(**kw):
    cfg = dict(name="SGRAF", vocab_size=VOCAB, img_dim=48, embed_size=E, word_dim=32,
               sim_dim=S, bi_gru=True, no_imgnorm=False, no_txtnorm=False,
               module_name="SAF", sgr_step=3, margin=0.2, max_violation=True,
               cap_chunk=4, sgraf_dropout=0.0)
    cfg.update(kw)
    return cfg


def _batch(rng, b=6, l=10):
    lengths = rng.integers(1, l + 1, b)
    lengths[0], lengths[1] = l, 1
    mask = (np.arange(l)[None] < lengths[:, None]).astype(np.float32)
    return {
        "images": rng.standard_normal((b, R, 48)).astype(np.float32),
        "cap_ids": (rng.integers(1, VOCAB, (b, l)) * mask).astype(np.int32),
        "cap_mask": mask,
    }


def _perturb_stats(variables, rng):
    """Every BatchNorm's running statistics off (0, 1): SAF's to mean 0.37,
    var 2.1 (as tests/test_pallas_sgraf_eval.py does), the visual head's at
    random."""
    stats = variables["batch_stats"]["sim_enc"]
    stats["scorer"]["SAF"]["bn"]["BatchNorm_0"] = {"mean": np.array([0.37], np.float32),
                                                   "var": np.array([2.1], np.float32)}
    for name in ("local_bn", "global_bn"):
        bn = stats["v_global_w"][name]["BatchNorm_0"]
        bn["mean"] = (rng.standard_normal(bn["mean"].shape) * 0.05).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return variables


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX model, JAX variables as numpy, port model with the same weights)."""
    rng = np.random.default_rng(7)
    cfg = _cfg()
    jmodel = jget_model(cfg)
    jb = {k: jnp.asarray(v) for k, v in _batch(rng).items()}
    init = jax.jit(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, b, train=False))
    variables = _perturb_stats(jax.tree.map(np.array, jax.device_get(init(jb))), rng)
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in from_itrx_variables(variables).items()},
        strict=True)
    return cfg, jmodel, variables, model


def _jsimilarity(jmodel):
    return jax.jit(lambda v, img, cap, mask: jmodel.apply(v, img, cap, mask,
                                                          method="similarity"))


def _sub(variables, *path):
    out = {}
    for col in ("params", "batch_stats"):
        tree = variables.get(col, {})
        for k in path:
            tree = tree.get(k, {})
        if tree:
            out[col] = tree
    return out


@pytest.mark.parametrize("shape,axis", [((4, 7), -1), ((3, 5, 6), 1)])
def test_l1norm_matches_jax(rng, shape, axis):
    x = rng.standard_normal(shape).astype(np.float32)
    x[0] = 0.0  # an all-zero row stays finite
    np.testing.assert_allclose(l1norm(torch.from_numpy(x), dim=axis).numpy(),
                               np.asarray(jl1norm(jnp.asarray(x), axis=axis)), atol=1e-7)


def _embeddings(rng, ni=5, nc=7, l=9):
    """l2-normalized region and word embeddings with ragged masks (a
    single-word caption among them)."""
    img = rng.standard_normal((ni, R, E)).astype(np.float32)
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    lengths = rng.integers(2, l + 1, nc)
    lengths[0] = 1
    mask = (np.arange(l)[None] < lengths[:, None]).astype(np.float32)
    cap = rng.standard_normal((nc, l, E)).astype(np.float32)
    cap = cap / np.linalg.norm(cap, axis=-1, keepdims=True) * mask[..., None]
    return img, cap, mask


def test_visual_and_text_sa_match_flax(pair, rng):
    _, _, variables, model = pair
    img, cap, mask = _embeddings(rng)
    sa = model.sim_enc
    with torch.no_grad():
        got_v = sa.v_global_w(torch.from_numpy(img), torch.from_numpy(img.mean(1)))
        got_t = sa.t_global_w(torch.from_numpy(cap), torch.from_numpy(cap.mean(1)),
                              torch.from_numpy(mask))
    want_v = JVisualSA(E).apply(_sub(variables, "sim_enc", "v_global_w"),
                                jnp.asarray(img), jnp.asarray(img.mean(1)))
    want_t = JTextSA(E).apply(_sub(variables, "sim_enc", "t_global_w"), jnp.asarray(cap),
                              jnp.asarray(cap.mean(1)), jnp.asarray(mask))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=FP32_ATOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=FP32_ATOL)


def test_attention_filtration_matches_flax(pair, rng):
    _, _, variables, model = pair
    nodes = rng.standard_normal((6, 11, S)).astype(np.float32)
    nmask = (rng.uniform(size=(6, 11)) < 0.7).astype(np.float32)
    nmask[:, 0] = 1.0
    with torch.no_grad():
        got = model.sim_enc.SAF_module(torch.from_numpy(nodes), torch.from_numpy(nmask))
    want = JAttentionFiltration(S).apply(_sub(variables, "sim_enc", "scorer", "SAF"),
                                         jnp.asarray(nodes), jnp.asarray(nmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL)


def test_sgraf_embed_and_similarity_match_jax(pair, rng):
    """embed, then the similarity grid on the plain chain and on the
    kernel route (the BatchNorm fold and the wrapper, whose CPU body is the
    plain version), against the JAX package's XLA path, fp32."""
    _, jmodel, variables, model = pair
    batch = _batch(rng, b=7)
    jout = jmodel.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()},
                        method="embed")
    with torch.no_grad():
        out = model.embed({k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("img", "cap"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), atol=FP32_ATOL)
    want = np.asarray(_jsimilarity(jmodel)(variables, jout["img"], jout["cap"],
                                           jout["cap_mask"]))
    assert want.shape == (7, 7)
    with torch.no_grad():
        plain = model.similarity(out["img"], out["cap"], out["cap_mask"])
        routed = model.sim_enc(out["img"], out["cap"], out["cap_mask"], kernel=True)
    np.testing.assert_allclose(plain.numpy(), want, atol=FP32_ATOL)
    np.testing.assert_allclose(routed.numpy(), want, atol=FP32_ATOL)
    assert np.abs(want - want.mean()).max() > 1e-3  # the grid is not flat


def test_sgraf_similarity_takes_bf16_embeddings(pair, rng):
    """bf16 embeddings (cal_sims under eval_bf16) against fp32 parameters:
    no dtype error, an fp32 grid equal to the port's fp32 grid on the same
    values up to the rounding of the global embeddings to bf16, and close to
    the JAX package's bf16 XLA path."""
    _, jmodel, variables, model = pair
    img, cap, mask = _embeddings(rng)
    img16, cap16 = (torch.from_numpy(a).to(torch.bfloat16) for a in (img, cap))
    tmask = torch.from_numpy(mask)
    with torch.no_grad():
        got = model.similarity(img16, cap16, tmask)
        on_values = model.similarity(img16.float(), cap16.float(), tmask)
    assert got.dtype == torch.float32 and got.shape == (5, 7)
    assert np.abs(got.numpy() - on_values.numpy()).max() <= 2e-3
    want = _jsimilarity(jmodel)(variables,
                                jnp.asarray(img16.float().numpy()).astype(jnp.bfloat16),
                                jnp.asarray(cap16.float().numpy()).astype(jnp.bfloat16),
                                jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=BF16_ATOL)


def _kernel_inputs(rng, ni, nc, l, d=E, s=S):
    img, cap, mask = _embeddings(rng, ni, nc, l)
    f = lambda *sh: (rng.standard_normal(sh) * 0.05).astype(np.float32)  # noqa: E731
    return dict(cap=cap, mask=mask, img=img, w=f(d, s), b=f(s), gloc=f(nc, d),
                imgglo=f(ni, d), gw=f(d, s), gb=f(s), awf=f(1, s), abf=np.full((1, s), 0.03,
                                                                             np.float32),
                ew=f(s, 1), eb=f(1))


@pytest.mark.parametrize("ni,nc,l,block_c,bf16_values", [
    (5, 8, 8, 4, False),    # fp32, L % 8 == 0
    (4, 7, 5, 3, False),    # ragged L, Nc not a multiple of the block
    (3, 9, 11, 4, True),    # bf16-valued inputs, upcast
])
def test_sgraf_eval_saf_plain_matches_pallas_kernel(rng, ni, nc, l, block_c, bf16_values):
    """sgraf_eval_saf_plain vs itrx's _eval_saf_kernel in interpret mode on
    the same fp32 values (captions padded to L % 8 == 0 on the JAX side only,
    as its whole-set path pads them), a single-word caption included."""
    x = _kernel_inputs(rng, ni, nc, l)
    if bf16_values:
        for k in ("cap", "img", "gloc", "imgglo"):
            x[k] = np.array(jnp.asarray(x[k]).astype(jnp.bfloat16).astype(jnp.float32))
    lp = -(-l // 8) * 8
    capp = np.pad(x["cap"], ((0, 0), (0, lp - l), (0, 0)))
    maskp = np.pad(x["mask"], ((0, 0), (0, lp - l)))
    j = {k: jnp.asarray(v) for k, v in x.items()}
    want = sgraf_eval_saf_score(jnp.asarray(capp), jnp.asarray(maskp), j["img"], j["w"], j["b"],
                                j["gloc"], j["imgglo"], j["gw"], j["gb"], j["awf"], j["abf"],
                                j["ew"], j["eb"], block_c=block_c, interpret=True)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    got = sgraf_eval_saf_plain(t["cap"], t["mask"], t["img"], t["w"].t(), t["b"], t["gloc"],
                               t["imgglo"], t["gw"].t(), t["gb"], t["awf"][0], t["abf"][0, :1],
                               t["ew"].t(), t["eb"])
    assert got.shape == (nc, ni) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_ATOL)


def test_fold_saf_bn_is_the_eval_batchnorm(pair, rng):
    """The folded gate equals Linear then the eval-mode BatchNorm1d(1)."""
    _, _, _, model = pair
    saf = model.sim_enc.SAF_module
    nodes = torch.from_numpy(rng.standard_normal((4, 9, S)).astype(np.float32))
    awf, abf = fold_saf_bn(saf.attn_sim_w.weight, saf.attn_sim_w.bias, saf.bn.weight,
                           saf.bn.bias, saf.bn.running_mean, saf.bn.running_var)
    with torch.no_grad():
        want = saf.bn(saf.attn_sim_w(nodes).transpose(1, 2))[:, 0]
    assert float(saf.bn.running_var) == pytest.approx(2.1)
    torch.testing.assert_close(nodes @ awf + abf, want, atol=1e-6, rtol=0)


def test_sgraf_state_dict_round_trip_is_exact(pair):
    """port -> [img_enc, txt_enc, sim_enc] -> ref_convert -> the JAX tree,
    running statistics included, bit for bit."""
    cfg, _, variables, model = pair
    state_list = to_itrx_flat(model.state_dict())
    assert len(state_list) == 3
    merged = merge_into_variables(variables, convert_state_list("SGRAF", state_list, cfg))
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    for (path, want), got in zip(leaves, jax.tree_util.tree_leaves(merged)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=str(path))
    n_tracked = sum(k.endswith("num_batches_tracked") for k in model.state_dict())
    assert len(leaves) == len(model.state_dict()) - n_tracked
    assert n_tracked == 3


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    """A tiny synthetic split (16 test images x 80 captions) and SGRAF-SAF
    in both packages with the same weights."""
    root = tmp_path_factory.mktemp("torch_sgraf")
    d = synthetic.generate(str(root / "synthetic"), n_images=64, img_dim=48,
                           n_concepts_range=(1, 10))
    cfg = dict(_cfg(cap_chunk=32), data_path=os.path.dirname(d), data_name=os.path.basename(d),
               vocab_path=os.path.join(d, "vocab"), vocab_type="json", text_encoder="gru",
               use_bbox=False, pad_words=96, batch_size=24)
    ds = precomp.PrecompDataset(d, "test", cfg)
    cfg["vocab_size"] = ds.vocab_size
    jmodel = jget_model(cfg)
    batch = ds.gather(np.arange(cfg["batch_size"]))
    variables = jax.device_get(jax.jit(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)}, b, train=False))(
        {k: jnp.asarray(v) for k, v in batch.items()}))
    variables = _perturb_stats(jax.tree.map(np.array, variables), np.random.default_rng(5))
    model = get_model(cfg, device="cpu")
    model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in from_itrx_variables(variables).items()})
    return cfg, ds, jmodel, variables, model


def _assert_same_ranks(got, want):
    for k in ("i2t_ranks", "t2i_ranks"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert got["rsum"] == pytest.approx(float(want["rsum"]), rel=1e-6)


def test_sgraf_slice_matches_jax(slice_setup):
    """encode_data -> cal_sims (length-bucketed, 80 captions) -> cal_recall
    through evaluate_split in both packages, fp32: grids at 1e-5 and
    identical ranks."""
    cfg, ds, jmodel, variables, model = slice_setup
    want = jengine.evaluate_split(jmodel, variables, ds, cfg)
    got = engine.evaluate_split(model, ds, cfg, device="cpu")
    assert got["data_name"] == want["data_name"]
    _assert_same_ranks(got, want)

    jenc = jengine.encode_data(jmodel, variables, ds, cfg["batch_size"])
    jsims = jengine.cal_sims(jmodel, variables, jenc["img"][:: ds.im_div], jenc["cap"],
                             jenc["cap_mask"], verbose=False)
    enc = engine.encode_data(model, ds, cfg["batch_size"], device="cpu")
    assert len(engine.length_buckets(enc["cap_mask"], enc["cap"].shape[1])) > 1
    sims = engine.cal_sims(model, enc["img"][:: ds.im_div], enc["cap"], enc["cap_mask"],
                           verbose=False)
    np.testing.assert_allclose(sims.numpy(), np.asarray(jsims), atol=FP32_ATOL)


def test_sgraf_evaluate_split_bf16_close_to_jax(slice_setup):
    """encode_bf16 + eval_bf16 in both packages: the JAX package's bf16 chain
    and the port's fp32 chain on bf16 values round at different places, so
    recalls may move by a rank flip or two (one i2t flip = 6.25pp on 16
    images)."""
    cfg, ds, jmodel, variables, model = slice_setup
    bcfg = dict(cfg, encode_bf16=True, eval_bf16=True)
    want = jengine.evaluate_split(jmodel, variables, ds, bcfg)
    got = engine.evaluate_split(model, ds, bcfg, device="cpu")
    assert abs(got["rsum"] - want["rsum"]) <= 30.0, (got["rsum"], want["rsum"])


def test_sgraf_checkpoint_converts_into_the_jax_package(slice_setup, tmp_path):
    """A port SGRAF checkpoint (three state dicts) goes through
    convert_reference_checkpoint into the JAX evalrank_single with identical
    ranks, and the port's evalrank_single reads it back."""
    base, _, _, _, model = slice_setup
    cfg = parse_cli(["with", "SGRAF", f"data_path={base['data_path']}",
                     f"data_name={base['data_name']}", f"vocab_path={base['vocab_path']}",
                     "vocab_type=json", "img_dim=48", f"embed_size={E}", f"sim_dim={S}",
                     "word_dim=32", "batch_size=24"], make_dirs=False)
    cfg["vocab_size"] = base["vocab_size"]
    port = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    port.load_state_dict(model.state_dict())
    path = str(tmp_path / "sgraf.pth.tar")
    save_checkpoint(create_train_state(port, cfg, 1), cfg, 0, 0.0, 0.0, path)
    assert [len(sd) for sd in load_checkpoint(path)["model"]] == [
        len(port.img_enc.state_dict()), len(port.txt_enc.state_dict()),
        len(port.sim_enc.state_dict())]
    out = convert_reference_checkpoint(path, out_path=str(tmp_path / "sgraf.itrx"))
    want = jevalrank_single(out, split="test")
    got = evalrank_single(path, split="test", device="cpu")
    _assert_same_ranks(got, want)
