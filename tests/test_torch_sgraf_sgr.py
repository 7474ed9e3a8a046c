"""The port's SGRAF-SGR evaluation and the SGR + SAF ensemble vs the JAX
package, on the CPU, at small widths (embed 128, sim_dim 128, 36 regions):
GraphReasoning vs the flax module, the q/k fold, embed + similarity vs the
XLA path, the SGR eval kernel's plain version vs the interpret-mode Pallas
kernel, the whole evaluation slice, the state dict both ways through the
reference converter, and checkpoints through the JAX package's
evalrank_single and evalrank_ensemble.  Weights go JAX -> port through
itrx_torch.utils.convert, with the reasoning steps' biases and the visual
head's BatchNorm statistics moved off their zero / (0, 1) init so the fold's
key-side term and the eval-mode BatchNorm have something to act on."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itrx.configs import parse_cli
from itrx.data import precomp, synthetic
from itrx.eval import engine as jengine
from itrx.eval.engine import evalrank_ensemble as jevalrank_ensemble
from itrx.eval.engine import evalrank_single as jevalrank_single
from itrx.models import get_model as jget_model
from itrx.models.sgraf import GraphReasoning as JGraphReasoning
from itrx.ops.pallas.sgraf_eval import sgraf_eval_score
from itrx.utils.ref_convert import (convert_reference_checkpoint, convert_state_list,
                                    merge_into_variables)
from itrx_torch.eval import engine
from itrx_torch.eval.engine import evalrank_ensemble, evalrank_single
from itrx_torch.models import get_model
from itrx_torch.models.sgraf import NEG_INF
from itrx_torch.ops.kernels.sgraf_eval import fold_sgr_qk, sgraf_eval_sgr_plain
from itrx_torch.train.state import create_train_state
from itrx_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from itrx_torch.utils.convert import from_itrx_variables, to_itrx_flat
from tests.test_torch_sgraf import (BF16_ATOL, FP32_ATOL, KERNEL_ATOL, E, S, _assert_same_ranks,
                                    _batch, _cfg, _embeddings, _jsimilarity, _sub)

torch.set_num_threads(1)

STEPS = 3
# the fold regroups the edge logits' sums (s M) s^T + s v against
# (s Wq^T + bq)(s Wk^T + bk)^T: fp32 rounding only
FOLD_ATOL = 1e-5


def _perturb(variables, rng):
    """The SGR steps' biases at random (zero at init, which would leave the
    fold's v = Wk^T bq at zero), the visual head's BatchNorm statistics off
    (0, 1)."""
    scorer = variables["params"]["sim_enc"]["scorer"]
    for i in range(STEPS):
        for lin in ("query_w", "key_w", "graph_w"):
            b = scorer[f"SGR_{i}"][lin]["bias"]
            scorer[f"SGR_{i}"][lin]["bias"] = (rng.standard_normal(b.shape) * 0.1).astype(
                np.float32)
    stats = variables["batch_stats"]["sim_enc"]
    for name in ("local_bn", "global_bn"):
        bn = stats["v_global_w"][name]["BatchNorm_0"]
        bn["mean"] = (rng.standard_normal(bn["mean"].shape) * 0.05).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return variables


def _port_of(cfg, variables):
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in from_itrx_variables(variables).items()},
        strict=True)
    return model


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX SGRAF-SGR model, its variables as numpy, the port model with
    the same weights)."""
    rng = np.random.default_rng(11)
    cfg = _cfg(module_name="SGR", sgr_step=STEPS)
    jmodel = jget_model(cfg)
    jb = {k: jnp.asarray(v) for k, v in _batch(rng).items()}
    init = jax.jit(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, b, train=False))
    variables = _perturb(jax.tree.map(np.array, jax.device_get(init(jb))), rng)
    return cfg, jmodel, variables, _port_of(cfg, variables)


def _nodes(rng, b=6, n=11):
    """Unit-norm nodes with a ragged node mask (node 0, the global node,
    always valid; one row with it alone)."""
    nodes = rng.standard_normal((b, n, S)).astype(np.float32)
    nodes /= np.linalg.norm(nodes, axis=-1, keepdims=True)
    nmask = (rng.uniform(size=(b, n)) < 0.6).astype(np.float32)
    nmask[:, 0] = 1.0
    nmask[1, 1:] = 0.0
    return nodes, nmask


def test_graph_reasoning_matches_flax(pair, rng):
    _, _, variables, model = pair
    nodes, nmask = _nodes(rng)
    with torch.no_grad():
        got = model.sim_enc.SGR_module["sgr1"](torch.from_numpy(nodes), torch.from_numpy(nmask))
    want = JGraphReasoning(S).apply(_sub(variables, "sim_enc", "scorer", "SGR_1"),
                                    jnp.asarray(nodes), jnp.asarray(nmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL)


def test_fold_sgr_qk_is_the_unfolded_step(pair, rng):
    """One step with the folded edge logits (s M) s^T + s v equals the
    module's step with q and k on every valid node."""
    _, _, _, model = pair
    step = model.sim_enc.SGR_module["sgr0"]
    nodes, nmask = (torch.from_numpy(a) for a in _nodes(rng))
    mm, vv = fold_sgr_qk(step.graph_query_w.weight, step.graph_query_w.bias,
                         step.graph_key_w.weight)
    assert float(vv.abs().max()) > 1e-3  # the key-side term is exercised
    with torch.no_grad():
        want = step(nodes, nmask)
        e = (nodes @ mm) @ nodes.transpose(1, 2) + (nodes @ vv)[:, None, :]
        a = torch.softmax(e.masked_fill(nmask[:, None, :] <= 0, NEG_INF), dim=-1)
        got = torch.relu(step.sim_graph_w(a @ nodes))
    valid = nmask > 0
    torch.testing.assert_close(got[valid], want[valid], atol=FOLD_ATOL, rtol=0)


def test_sgraf_sgr_embed_and_similarity_match_jax(pair, rng):
    """embed, then the similarity grid on the plain chain (unfolded q/k,
    every step on every node) and on the kernel route (stacked weights
    through the wrapper, whose CPU body is the folded plain version),
    against the JAX package's XLA path, fp32."""
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


def test_sgraf_sgr_similarity_takes_bf16_embeddings(pair, rng):
    """bf16 embeddings (cal_sims under eval_bf16): an fp32 grid equal to the
    port's fp32 grid on the same values up to the rounding of the global
    embeddings to bf16, and close to the JAX package's bf16 XLA path (which
    runs the heads, the nodes and every reasoning step in bf16)."""
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


def _sgr_inputs(rng, ni, nc, l, steps, d=E, s=S):
    img, cap, mask = _embeddings(rng, ni, nc, l)
    f = lambda *sh: (rng.standard_normal(sh) * 0.05).astype(np.float32)  # noqa: E731
    r = np.sqrt(6.0 / (2 * s))
    u = lambda *sh: rng.uniform(-r, r, sh).astype(np.float32)  # noqa: E731
    return dict(cap=cap, mask=mask, img=img, w=f(d, s), b=f(s), gloc=f(nc, d),
                imgglo=f(ni, d), gw=f(d, s), gb=f(s), wq=u(steps, s, s), bq=f(steps, s),
                wk=u(steps, s, s), bk=f(steps, s), wg=u(steps, s, s), bg=f(steps, s),
                ew=f(s, 1), eb=f(1))


@pytest.mark.parametrize("ni,nc,l,block_c,steps,bf16_values", [
    (5, 8, 8, 4, 3, False),    # L % 8 == 0, three steps
    (4, 7, 5, 3, 3, False),    # ragged L, Nc not a multiple of the block
    (3, 9, 11, 4, 1, True),    # sgr_step 1 (node 0 alone), bf16-valued inputs
    (4, 5, 6, 2, 1, False),    # sgr_step 1, ragged L, Nc not a multiple of the block
])
def test_sgraf_eval_sgr_plain_matches_pallas_kernel(rng, ni, nc, l, block_c, steps,
                                                    bf16_values):
    """sgraf_eval_sgr_plain vs itrx's _eval_kernel in interpret mode on the
    same fp32 values (captions padded to L % 8 == 0 on the JAX side only, as
    its whole-set path pads them), a single-word caption included.  Weights
    go in flax's (in, out) layout there and torch's (out, in) here."""
    x = _sgr_inputs(rng, ni, nc, l, steps)
    if bf16_values:
        for k in ("cap", "img", "gloc", "imgglo"):
            x[k] = np.array(jnp.asarray(x[k]).astype(jnp.bfloat16).astype(jnp.float32))
    lp = -(-l // 8) * 8
    capp = np.pad(x["cap"], ((0, 0), (0, lp - l), (0, 0)))
    maskp = np.pad(x["mask"], ((0, 0), (0, lp - l)))
    j = {k: jnp.asarray(v) for k, v in x.items()}
    want = sgraf_eval_score(jnp.asarray(capp), jnp.asarray(maskp), j["img"], j["w"], j["b"],
                            j["gloc"], j["imgglo"], j["gw"], j["gb"], j["wq"], j["bq"],
                            j["wk"], j["bk"], j["wg"], j["bg"], j["ew"], j["eb"],
                            block_c=block_c, interpret=True)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    tr = lambda a: a.transpose(-1, -2)  # noqa: E731
    got = sgraf_eval_sgr_plain(t["cap"], t["mask"], t["img"], tr(t["w"]), t["b"], t["gloc"],
                               t["imgglo"], tr(t["gw"]), t["gb"], tr(t["wq"]), t["bq"],
                               tr(t["wk"]), t["bk"], tr(t["wg"]), t["bg"], tr(t["ew"]), t["eb"])
    assert got.shape == (nc, ni) and got.dtype == torch.float32
    assert np.asarray(want).std() > 1e-4  # the scores are not flat
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_ATOL)


def test_sgraf_sgr_state_dict_round_trip_is_exact(pair):
    """port -> [img_enc, txt_enc, sim_enc] -> ref_convert (module_name SGR)
    -> the JAX tree, bit for bit: the SGR_module.sgr{i} Linears land on
    scorer/SGR_{i}, and the only BatchNorms are the visual head's two."""
    cfg, _, variables, model = pair
    state_list = to_itrx_flat(model.state_dict())
    assert len(state_list) == 3
    assert "SGR_module.sgr2.sim_graph_w.bias" in state_list[2]
    merged = merge_into_variables(
        variables, convert_state_list("SGRAF", state_list, {"module_name": "SGR"}))
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    for (path, want), got in zip(leaves, jax.tree_util.tree_leaves(merged)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=str(path))
    n_tracked = sum(k.endswith("num_batches_tracked") for k in model.state_dict())
    assert len(leaves) == len(model.state_dict()) - n_tracked
    assert n_tracked == 2


def test_get_model_builds_sgraf_sgr_at_the_overlay_widths():
    """`with SGRAF module_name=SGR`: sgr_step 3, embed 1024, sim_dim 256, a
    bi-GRU, 2048-d regions."""
    cfg = parse_cli(["with", "SGRAF", "module_name=SGR"], make_dirs=False)
    cfg["vocab_size"] = 20
    model = get_model(cfg, device="cpu")
    sim = model.sim_enc
    assert (cfg["sgr_step"], cfg["embed_size"], cfg["sim_dim"]) == (3, 1024, 256)
    assert list(sim.SGR_module) == ["sgr0", "sgr1", "sgr2"]
    assert not hasattr(sim, "SAF_module")
    assert sim.SGR_module["sgr2"].sim_graph_w.weight.shape == (256, 256)
    assert sim.sim_tranloc_w.weight.shape == (256, 1024)
    assert model.img_enc.fc.weight.shape == (1024, 2048)
    assert model.txt_enc.rnn.bidirectional


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    """A tiny synthetic split (16 test images x 80 captions) and SGRAF-SGR in
    both packages with the same weights."""
    root = tmp_path_factory.mktemp("torch_sgraf_sgr")
    d = synthetic.generate(str(root / "synthetic"), n_images=64, img_dim=48,
                           n_concepts_range=(1, 10))
    cfg = dict(_cfg(cap_chunk=32, module_name="SGR", sgr_step=STEPS),
               data_path=os.path.dirname(d), data_name=os.path.basename(d),
               vocab_path=os.path.join(d, "vocab"), vocab_type="json", text_encoder="gru",
               use_bbox=False, pad_words=96, batch_size=24)
    ds = precomp.PrecompDataset(d, "test", cfg)
    cfg["vocab_size"] = ds.vocab_size
    jmodel = jget_model(cfg)
    batch = ds.gather(np.arange(cfg["batch_size"]))
    variables = jax.device_get(jax.jit(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)}, b, train=False))(
        {k: jnp.asarray(v) for k, v in batch.items()}))
    variables = _perturb(jax.tree.map(np.array, variables), np.random.default_rng(5))
    return cfg, ds, jmodel, variables, _port_of(cfg, variables)


def test_sgraf_sgr_slice_matches_jax(slice_setup):
    """encode_data -> cal_sims (length-bucketed, 80 captions) -> cal_recall
    through evaluate_split in both packages, fp32: grids at 1e-5 and
    identical ranks."""
    cfg, ds, jmodel, variables, model = slice_setup
    want = jengine.evaluate_split(jmodel, variables, ds, cfg)
    got = engine.evaluate_split(model, ds, cfg, device="cpu")
    _assert_same_ranks(got, want)

    jenc = jengine.encode_data(jmodel, variables, ds, cfg["batch_size"])
    jsims = jengine.cal_sims(jmodel, variables, jenc["img"][:: ds.im_div], jenc["cap"],
                             jenc["cap_mask"], verbose=False)
    enc = engine.encode_data(model, ds, cfg["batch_size"], device="cpu")
    assert len(engine.length_buckets(enc["cap_mask"], enc["cap"].shape[1])) > 1
    sims = engine.cal_sims(model, enc["img"][:: ds.im_div], enc["cap"], enc["cap_mask"],
                           verbose=False)
    np.testing.assert_allclose(sims.numpy(), np.asarray(jsims), atol=FP32_ATOL)


def test_sgraf_sgr_evaluate_split_bf16_close_to_jax(slice_setup):
    """encode_bf16 + eval_bf16 in both packages: the JAX package's bf16 chain
    and the port's fp32 chain on bf16 values round at different places, so
    recalls may move by a rank flip or two (one i2t flip = 6.25pp on 16
    images)."""
    cfg, ds, jmodel, variables, model = slice_setup
    bcfg = dict(cfg, encode_bf16=True, eval_bf16=True)
    want = jengine.evaluate_split(jmodel, variables, ds, bcfg)
    got = engine.evaluate_split(model, ds, bcfg, device="cpu")
    assert abs(got["rsum"] - want["rsum"]) <= 30.0, (got["rsum"], want["rsum"])


def _checkpoint(base, model, module_name, path, seed):
    """A port checkpoint of an SGRAF model under `base`'s split and widths:
    `model`'s weights, or (model None) random weights from `seed` with
    random biases."""
    cfg = parse_cli(["with", "SGRAF", f"data_path={base['data_path']}",
                     f"data_name={base['data_name']}", f"vocab_path={base['vocab_path']}",
                     "vocab_type=json", "img_dim=48", f"embed_size={E}", f"sim_dim={S}",
                     "word_dim=32", "batch_size=24", f"module_name={module_name}",
                     f"sgr_step={STEPS}"], make_dirs=False)
    cfg["vocab_size"] = base["vocab_size"]
    port = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    if model is not None:
        port.load_state_dict(model.state_dict())
    else:
        g = torch.Generator().manual_seed(seed + 100)
        with torch.no_grad():
            for name, p in port.sim_enc.named_parameters():
                if name.endswith("bias"):
                    p.uniform_(-0.1, 0.1, generator=g)
    save_checkpoint(create_train_state(port, cfg, 1), cfg, 0, 0.0, 0.0, path)
    return path


@pytest.fixture(scope="module")
def checkpoints(slice_setup, tmp_path_factory):
    """(port SGR checkpoint with the slice's weights, port SAF checkpoint
    with random weights, and the two converted into the JAX package)."""
    base, _, _, _, model = slice_setup
    root = tmp_path_factory.mktemp("sgraf_ckpt")
    ck_sgr = _checkpoint(base, model, "SGR", str(root / "sgr.pth.tar"), 2)
    ck_saf = _checkpoint(base, None, "SAF", str(root / "saf.pth.tar"), 6)
    return ck_sgr, ck_saf, *(convert_reference_checkpoint(p, out_path=p[:-len(".pth.tar")]
                                                          + ".itrx") for p in (ck_sgr, ck_saf))


def test_sgraf_sgr_checkpoint_converts_into_the_jax_package(slice_setup, checkpoints):
    """A port SGRAF-SGR checkpoint (three state dicts) goes through
    convert_reference_checkpoint into the JAX evalrank_single with identical
    ranks, and the port's evalrank_single reads it back."""
    model = slice_setup[-1]
    ck_sgr, _, j_sgr, _ = checkpoints
    assert [len(sd) for sd in load_checkpoint(ck_sgr)["model"]] == [
        len(model.img_enc.state_dict()), len(model.txt_enc.state_dict()),
        len(model.sim_enc.state_dict())]
    want = jevalrank_single(j_sgr, split="test")
    got = evalrank_single(ck_sgr, split="test", device="cpu")
    _assert_same_ranks(got, want)


def test_sgraf_sgr_saf_ensemble_matches_jax(checkpoints):
    """The published SGRAF protocol: an SGR and a SAF checkpoint through the
    port's evalrank_ensemble rank exactly as the JAX package's on the
    converted checkpoints, and the ensemble is neither member alone."""
    ck_sgr, ck_saf, j_sgr, j_saf = checkpoints
    want = jevalrank_ensemble(j_sgr, j_saf, split="test")
    got = evalrank_ensemble(ck_sgr, ck_saf, split="test", device="cpu")
    _assert_same_ranks(got, want)
    assert (got["modal_path_1"], got["modal_path_2"]) == (ck_sgr, ck_saf)
    alone = [evalrank_single(p, split="test", device="cpu")["t2i_ranks"]
             for p in (ck_sgr, ck_saf)]
    assert all(not np.array_equal(got["t2i_ranks"], r) for r in alone)
