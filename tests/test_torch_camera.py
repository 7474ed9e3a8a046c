"""The port's CAMERA (the hand-written BERT, the AGSA gated attention and its
kernel's plain version, the summarization, the position encoder, both
towers) vs the JAX package on the CPU at small widths: BERT with 2 layers,
hidden 32, 4 heads, intermediate 64, a vocabulary of 64; CAMERA embed 64, 4
heads (d_k 16, so `itrx`'s kernel gate holds), smry_k 5, 12 regions.
Weights go JAX -> port through itrx_torch.utils.convert, with every
BatchNorm's scale, bias and running statistics moved off their init (at
(0, 1) an eval-mode BatchNorm is nearly the identity, so a fault in it
would not show).  Also the exact two-part state-dict round trip, a BERT
`init_checkpoint` read by both packages, and `get_model` at the CAMERA()
overlay's widths.  Inputs come from numpy with a seed."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itrx.models import get_model as jget_model
from itrx.models.agsa import AGSA as JAGSA
from itrx.models.agsa import GatedQueryAttLayer as JGatedQueryAttLayer
from itrx.models.agsa import PositionEncoder as JPositionEncoder
from itrx.models.agsa import Summarization as JSummarization
from itrx.models.bert import BertConfig as JBertConfig
from itrx.models.bert import BertModel as JBertModel
from itrx.models.bert import load_torch_bert as jload_torch_bert
from itrx.ops.pallas.agsa_attn import agsa_attention as jagsa_attention
from itrx.utils.ref_convert import convert_state_list, merge_into_variables
from itrx_torch.configs import CAMERA as CAMERA_OVERLAY
from itrx_torch.configs import base_config
from itrx_torch.models import get_model
from itrx_torch.models.bert import BertConfig, BertModel, load_torch_bert
from itrx_torch.ops.kernels.agsa_attn import agsa_attention_plain
from itrx_torch.utils.convert import from_itrx_variables, to_itrx_flat

torch.set_num_threads(1)

VOCAB = 64
IMG, E, HEADS, SMRY_K, R, L = 48, 64, 4, 5, 12, 10
BERT = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=64, type_vocab_size=2)
# fp32: the same chain in another summation order
FP32_ATOL = 1e-5
# the plain kernel vs the interpret-mode Pallas kernel, as
# tests/test_pallas_agsa.py holds the kernel to the XLA chain
KERNEL_ATOL, KERNEL_RTOL = 3e-5, 1e-4


def bert_config_file(path) -> str:
    path.write_text(json.dumps(BERT))
    return str(path)


def camera_cfg(bert_file: str, **kw) -> dict:
    cfg = dict(name="CAMERA", vocab_size=VOCAB, img_dim=IMG, embed_size=E, head=HEADS,
               smry_k=SMRY_K, smry_lamda=0.01, drop=0.0, margin=0.2, max_violation=False,
               bert_config_file=bert_file)
    cfg.update(kw)
    return cfg


def camera_batch(rng, b=6, r=R, l=L, vocab=VOCAB) -> dict:
    """A CAMERA batch: regions, xyxy boxes inside a 320 x 320 image, BERT
    ids with a ragged mask (first caption full length)."""
    xy = rng.uniform(0, 200, (b, r, 2))
    wh = rng.uniform(5, 100, (b, r, 2))
    lengths = rng.integers(3, l + 1, b)
    lengths[0] = l
    mask = (np.arange(l)[None] < lengths[:, None]).astype(np.float32)
    return {"images": rng.standard_normal((b, r, IMG)).astype(np.float32),
            "cap_ids": (rng.integers(1, vocab, (b, l)) * mask).astype(np.int32),
            "cap_mask": mask, "type_ids": np.zeros((b, l), np.int32),
            "boxes": np.concatenate([xy, xy + wh], axis=2).astype(np.float32),
            "imgs_wh": np.full((b, 2), 320.0, np.float32)}


def perturb_batchnorms(variables, rng):
    """Every BatchNorm's scale and bias and its running statistics moved off
    their init (both AGSA `bn_0`s and the text tower's `bn`)."""
    p, st = variables["params"], variables["batch_stats"]
    paths = [("img_enc", "agsa", "bn_0"), ("txt_enc", "agsa", "bn_0"), ("txt_enc", "bn")]
    for path in paths:
        bp, bs = p, st
        for k in path:
            bp, bs = bp[k], bs[k]
        bp, bs = bp["BatchNorm_0"], bs["BatchNorm_0"]
        bp["scale"] = rng.uniform(0.5, 1.5, bp["scale"].shape).astype(np.float32)
        bp["bias"] = (rng.standard_normal(bp["bias"].shape) * 0.1).astype(np.float32)
        bs["mean"] = (rng.standard_normal(bs["mean"].shape) * 0.1).astype(np.float32)
        bs["var"] = rng.uniform(0.5, 2.0, bs["var"].shape).astype(np.float32)
    return variables


def jax_variables(cfg, batch, seed=0):
    """`itrx`'s CAMERA variables as numpy (the diversity head traces only in
    train mode), BatchNorms perturbed."""
    jmodel = jget_model(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.device_get(jax.jit(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)}, b,
        train=True))(jb))
    return perturb_batchnorms(jax.tree.map(np.array, variables),
                              np.random.default_rng(seed + 5))


def port_model(cfg, variables):
    """The port's CAMERA on the CPU holding `itrx`'s weights."""
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    sd = {k: torch.from_numpy(v) for k, v in from_itrx_variables(variables).items()}
    sd.update({k: v for k, v in model.state_dict().items() if k.endswith("num_batches_tracked")})
    model.load_state_dict(sd, strict=True)
    return model


def _np(t):
    return t.detach().float().numpy()


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def camera(tmp_path_factory):
    """(cfg, a batch, `itrx`'s variables as numpy, the port model)."""
    cfg = camera_cfg(bert_config_file(tmp_path_factory.mktemp("camera") / "bert_config.json"))
    batch = camera_batch(np.random.default_rng(21))
    variables = jax_variables(cfg, batch)
    return cfg, batch, variables, port_model(cfg, variables)


# -- the kernel's plain version ------------------------------------------


def _xla_chain(q, k, v, wq, bq, wk, bk, wg1, bg1, wg2, bg2):
    """tests/test_pallas_agsa.py's XLA chain, (B, h, N, d_k), flax layouts."""
    dk = q.shape[-1]
    g = (q @ wq + bq) * (k @ wk + bk)
    m1 = jax.nn.sigmoid(g @ wg1 + bg1)
    m2 = jax.nn.sigmoid(g @ wg2 + bg2)
    scores = jnp.einsum("bhqd,bhkd->bhqk", q * m1, k * m2) / math.sqrt(dk)
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(scores, axis=-1), v)


def _kernel_data(rng, b, h, n, dk):
    """(q, k, v) in the port's (B, N, h d_k) layout and the flax-layout
    (in, out) weights and biases, fp32 numpy."""
    t = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)  # noqa: E731
    qkv = [t(b, n, h * dk) for _ in range(3)]
    w = [t(dk, dk), t(dk), t(dk, dk), t(dk), t(dk, dk), t(dk), t(dk, dk), t(dk)]
    return qkv, w


def _heads(x, h):  # (B, N, h d_k) -> (B, h, N, d_k)
    b, n, d = x.shape
    return x.reshape(b, n, h, d // h).transpose(0, 2, 1, 3)


def _port_weights(w, dtype=torch.float32):
    """flax (in, out) kernels -> torch (out, in) weights; biases as they are."""
    return [torch.from_numpy(a.T.copy() if a.ndim == 2 else a).to(dtype) for a in w]


@pytest.mark.parametrize("b,h,n,dk", [(6, 4, 9, 16), (7, 4, 36, 16), (5, 64, 32, 8),
                                      (3, 2, 36, 32)])
def test_plain_kernel_matches_pallas_kernel_and_xla_chain(b, h, n, dk):
    """agsa_attention_plain vs `itrx`'s agsa_attention in interpret mode and
    its XLA chain, fp32: N 9, 36 (regions) and 32 (BERT slots), B not a
    multiple of the Pallas batch block (256 // h rows)."""
    rng = np.random.default_rng(b * 100 + n)
    (q, k, v), w = _kernel_data(rng, b, h, n, dk)
    jq, jk, jv = (jnp.asarray(_heads(x, h)) for x in (q, k, v))
    jw = [jnp.asarray(a) for a in w]
    pallas = np.asarray(jagsa_attention(jq, jk, jv, *jw, True))
    xla = np.asarray(_xla_chain(jq, jk, jv, *jw))
    got = agsa_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), *_port_weights(w), h)
    assert got.dtype == torch.float32 and got.shape == (b, n, h * dk)
    got = _heads(got.numpy(), h)
    np.testing.assert_allclose(got, pallas, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    np.testing.assert_allclose(got, xla, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)


@pytest.mark.parametrize("n", [36, 32])
def test_plain_kernel_bf16_matches_pallas_kernel(n):
    """bf16 q, k, v and weights: both sides round at the kernel's points (the
    gate product, the gated rows, p and out), so they agree within one bf16
    step (2^-8) of the output's scale."""
    b, h, dk = 7, 4, 16
    rng = np.random.default_rng(n)
    (q, k, v), w = _kernel_data(rng, b, h, n, dk)
    bf = jnp.bfloat16
    jq, jk, jv = (jnp.asarray(_heads(x, h), bf) for x in (q, k, v))
    jw = [jnp.asarray(a, bf) for a in w]
    want = np.asarray(jagsa_attention(jq, jk, jv, *jw, True), np.float32)
    got = agsa_attention_plain(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                               *_port_weights(w, torch.bfloat16), h)
    assert got.dtype == torch.bfloat16
    got = _heads(got.float().numpy(), h)
    np.testing.assert_allclose(got, want, atol=2.0 ** -8 * np.abs(want).max())


# -- BERT -----------------------------------------------------------------


def _bert_inputs(rng, b=4, l=12):
    ids = rng.integers(0, VOCAB, (b, l)).astype(np.int64)
    mask = np.ones((b, l), np.float32)
    mask[1, 7:] = 0
    mask[2, 4:] = 0
    return ids, np.zeros((b, l), np.int64), mask


def _assert_bert_equal(model, params, ids, types, mask):
    layers, pooled = JBertModel(JBertConfig(**BERT)).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(types), jnp.asarray(mask))
    with torch.no_grad():
        got_layers, got_pooled = model(torch.from_numpy(ids), torch.from_numpy(types),
                                       torch.from_numpy(mask))
    assert len(got_layers) == len(layers) == BERT["num_hidden_layers"]
    for got, want in zip(got_layers, layers):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=FP32_ATOL)
    np.testing.assert_allclose(_np(got_pooled), np.asarray(pooled), atol=FP32_ATOL)


def test_bert_matches_flax_every_layer(camera):
    """The hand-written BertModel (TF LayerNorm, erf-GELU, the -10000 mask)
    vs `itrx`'s with the same weights: every layer's output with a padded
    mask, and the pooled output."""
    _, _, variables, model = camera
    ids, types, mask = _bert_inputs(np.random.default_rng(8))
    _assert_bert_equal(model.txt_enc.bert, variables["params"]["txt_enc"]["bert"], ids, types,
                       mask)


@pytest.mark.parametrize("prefix,norm", [("bert.", ("gamma", "beta")), ("", ("weight", "bias"))])
def test_bert_init_checkpoint_loads_in_both_packages(camera, tmp_path, prefix, norm):
    """A random BERT state dict in the reference layout, saved as a
    `pytorch_model.bin`, loads into both packages with the same outputs;
    get_model loads it into CAMERA's tower when `init_checkpoint` exists
    (and ignores a path that does not)."""
    cfg, _, _, _ = camera
    g = torch.Generator().manual_seed(11)
    sd = {}
    for k, v in BertModel(BertConfig(**BERT)).state_dict().items():
        k = k.replace(".gamma", f".{norm[0]}").replace(".beta", f".{norm[1]}")
        sd[prefix + k] = (torch.randn(v.shape, generator=g) * 0.1
                          + ("LayerNorm" in k and k.endswith(norm[0])))
    path = tmp_path / "pytorch_model.bin"
    torch.save(sd, str(path))
    bert = BertModel(BertConfig(**BERT))
    load_torch_bert(str(path), bert)
    params = jload_torch_bert(str(path), JBertConfig(**BERT))
    _assert_bert_equal(bert, params, *_bert_inputs(np.random.default_rng(9)))
    model = get_model(dict(cfg, init_checkpoint=str(path)), device="cpu")
    for k, v in bert.state_dict().items():
        torch.testing.assert_close(model.txt_enc.bert.state_dict()[k], v, rtol=0, atol=0)
    fresh = get_model(dict(cfg, init_checkpoint=str(tmp_path / "missing.bin")), device="cpu",
                      generator=torch.Generator().manual_seed(1))
    assert not torch.equal(fresh.txt_enc.bert.pooler.dense.weight, bert.pooler.dense.weight)


# -- the CAMERA blocks ----------------------------------------------------


def test_gated_query_att_layer_matches_flax(camera):
    """GatedQueryAttLayer (eval, no mask: the kernel route, which takes the
    plain version for CPU tensors) vs flax's XLA path, fp32."""
    _, _, variables, model = camera
    x = np.random.default_rng(2).standard_normal((5, R, E)).astype(np.float32)
    params = variables["params"]["img_enc"]["agsa"]["att_0"]
    want = JGatedQueryAttLayer(E, HEADS).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = model.img_enc.agsa.att_layers[0](torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=FP32_ATOL)


@pytest.mark.parametrize("tower", ["img_enc", "txt_enc"])
def test_agsa_matches_flax(camera, tower):
    """AGSA (the gated layer, the BatchNorm over the flattened (B x N, D)
    rows with its statistics off (0, 1), the residual) vs flax in eval mode,
    with the image tower's position gate and without it (the text tower)."""
    _, _, variables, model = camera
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, R, E)).astype(np.float32)
    pos = rng.uniform(0, 1, (5, R, E)).astype(np.float32) if tower == "img_enc" else None
    want = JAGSA(1, E, h=HEADS).apply(
        {"params": variables["params"][tower]["agsa"],
         "batch_stats": variables["batch_stats"][tower]["agsa"]},
        jnp.asarray(x), None if pos is None else jnp.asarray(pos), train=False)
    with torch.no_grad():
        got = getattr(model, tower).agsa(torch.from_numpy(x),
                                         None if pos is None else torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=FP32_ATOL)


def test_summarization_and_position_encoder_match_flax(camera):
    """The seven dilated conv banks + convs_fc (flax's (k, in, out) conv
    kernels as torch's (out, in, k)), and the box geometry gate with a
    degenerate box (height 0) and a negative one, vs flax."""
    _, _, variables, model = camera
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, R, E)).astype(np.float32)
    img = variables["params"]["img_enc"]
    want = JSummarization(E, SMRY_K).apply({"params": img["mvs"]}, jnp.asarray(x))
    with torch.no_grad():
        got = model.img_enc.mvs(torch.from_numpy(x))
    assert got.shape == (5, R, SMRY_K)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=FP32_ATOL)
    boxes = camera_batch(rng, b=5)["boxes"]
    boxes[0, 0, 3] = boxes[0, 0, 1]
    boxes[1, 2, 3] = boxes[1, 2, 1] - 3.0
    wh = np.full((5, 2), 320.0, np.float32)
    want = JPositionEncoder(E).apply({"params": img["position_enc"]}, jnp.asarray(boxes),
                                     jnp.asarray(wh))
    with torch.no_grad():
        got = model.img_enc.position_enc(torch.from_numpy(boxes), torch.from_numpy(wh))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=FP32_ATOL)


def test_camera_embed_and_similarity_match_jax(camera):
    """embed in eval mode (both towers: the (B, smry_k, D) views and the
    (B, D) captions, no smry_mat kept) and the multi-view grid vs `itrx`'s
    XLA path, fp32."""
    cfg, batch, variables, model = camera
    jmodel = jget_model(cfg)
    jv = jax.tree.map(jnp.asarray, variables)
    je = jax.jit(lambda v, b: jmodel.apply(v, b, train=False, method="embed"))(
        jv, {k: jnp.asarray(v) for k, v in batch.items()})
    want = jmodel.apply(jv, je["img"], je["cap"], None, method="similarity")
    with torch.no_grad():
        e = model.embed(_t(batch))
        got = model.similarity(e["img"], e["cap"])
    assert sorted(e) == ["cap", "img"]
    assert e["img"].shape == (6, SMRY_K, E) and e["cap"].shape == (6, E)
    for k in ("img", "cap"):
        np.testing.assert_allclose(_np(e[k]), np.asarray(je[k]), atol=FP32_ATOL, err_msg=k)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=FP32_ATOL)
    bf = model.similarity(e["img"].bfloat16(), e["cap"].bfloat16())
    assert bf.dtype == torch.float32
    torch.testing.assert_close(bf, torch.einsum("ikd,cd->ikc", e["img"].bfloat16().float(),
                                                e["cap"].bfloat16().float()).amax(1),
                               rtol=0, atol=0)


def test_camera_state_dict_round_trip_is_exact(camera):
    """port -> [img_enc, txt_enc] -> ref_convert.convert_state_list("CAMERA")
    -> merge_into_variables: the JAX tree bit for bit, BERT tower and
    running statistics included."""
    cfg, _, variables, model = camera
    state_list = to_itrx_flat(model.state_dict())
    assert len(state_list) == 2
    assert "agsa.att_layers.0.fc_g.weight" in state_list[0]
    assert "bert.encoder.layer.1.output.LayerNorm.gamma" in state_list[1]
    merged = merge_into_variables(variables, convert_state_list("CAMERA", state_list, cfg))
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    for (path, want), got in zip(leaves, jax.tree_util.tree_leaves(merged)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=str(path))
    n_tracked = sum(k.endswith("num_batches_tracked") for k in model.state_dict())
    assert n_tracked == 3 and len(leaves) == len(model.state_dict()) - n_tracked


def test_get_model_builds_camera_at_the_overlays_widths():
    """The CAMERA() overlay's widths on the meta device: embed 2048, 64
    heads (d_k 32), smry_k 12, BERT-base (768, 12 layers, 12 heads, 3072)
    with the config's vocab_size when no bert_config_file exists, and the
    reference's two checkpoint parts."""
    cfg = base_config()
    cfg.update(CAMERA_OVERLAY())
    cfg.update(vocab_size=30522, bert_config_file="/nonexistent/bert_config.json",
               init_checkpoint="/nonexistent/pytorch_model.bin")
    with torch.device("meta"):
        model = get_model(cfg, device="meta", generator=torch.Generator().manual_seed(0))
    assert not model.training and not model.fused_eval_active(torch.device("cuda"))
    att = model.img_enc.agsa.att_layers[0]
    assert (att.h, att.d_k) == (64, 32) and att.fc_g.weight.shape == (64, 32)
    assert model.img_enc.fc.weight.shape == (2048, 2048)
    assert model.img_enc.mvs.convs_fc.weight.shape == (12, 1024)
    bert = model.txt_enc.bert.config
    assert (bert.vocab_size, bert.hidden_size, bert.num_hidden_layers,
            bert.num_attention_heads, bert.intermediate_size) == (30522, 768, 12, 12, 3072)
    assert len(model.txt_enc.bert.encoder.layer) == 12
    assert model.txt_enc.mapping.weight.shape == (2048, 768)
    assert [name for name, _ in model.named_children()] == ["img_enc", "txt_enc"]
