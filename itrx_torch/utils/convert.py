"""Weights between the JAX package and the port, numpy only (counterpart of
itrx/utils/ref_convert.py for SCAN, VSRN with its caption model, SGRAF
with SGR or SAF, and CAMERA with its BERT tower).

The port keeps the reference PyTorch names and layouts: Linear `weight
(out, in)`, Conv1d `weight (out, in, k)`, `torch.nn.GRU`'s `weight_ih_l0`
... (+ `_reverse`), `embed.weight`, BatchNorm `weight`, `bias`,
`running_mean`, `running_var`, and BERT's LayerNorm `gamma`, `beta`.  The
JAX package keeps flax's: Dense `kernel (in, out)`, Conv `kernel (k, in,
out)`, MaskedGRU `w_ih` ..., `embedding`, and BatchNorm `scale`, `bias`
with `mean`, `var` in the `batch_stats` collection.
"""

from __future__ import annotations

import numpy as np

_GRU = (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh"),
        ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh"))
# SGRAF's similarity tower: port module -> path under the JAX package's
# sim_enc (itrx/utils/ref_convert.py::convert_sgraf_sim); the reasoning
# module's own Linears and BatchNorm follow
_SGRAF_LINEARS = (
    ("v_global_w.embedding_local.0", ("v_global_w", "local_fc")),
    ("v_global_w.embedding_global.0", ("v_global_w", "global_fc")),
    ("v_global_w.embedding_common.0", ("v_global_w", "common_fc")),
    ("t_global_w.embedding_local.0", ("t_global_w", "local_fc")),
    ("t_global_w.embedding_global.0", ("t_global_w", "global_fc")),
    ("t_global_w.embedding_common.0", ("t_global_w", "common_fc")),
    ("sim_tranloc_w", ("scorer", "sim_tranloc_w")),
    ("sim_tranglo_w", ("scorer", "sim_tranglo_w")),
    ("sim_eval_w", ("scorer", "sim_eval_w")),
)
_SGRAF_BNS = (
    ("v_global_w.embedding_local.1", ("v_global_w", "local_bn", "BatchNorm_0")),
    ("v_global_w.embedding_global.1", ("v_global_w", "global_bn", "BatchNorm_0")),
)
_SAF_LINEARS = (("SAF_module.attn_sim_w", ("scorer", "SAF", "attn_w")),)
_SAF_BNS = (("SAF_module.bn", ("scorer", "SAF", "bn", "BatchNorm_0")),)
# one GraphReasoning step: port Linear -> JAX Dense under scorer/SGR_{i}
_SGR_STEP = (("graph_query_w", "query_w"), ("graph_key_w", "key_w"),
             ("sim_graph_w", "graph_w"))


def _sgraf_modules(scorer) -> tuple:
    """(Linears, BatchNorms) of the reasoning module in a JAX SGRAF scorer
    tree: SGR's steps SGR_0, SGR_1, ... or SAF's gate and BatchNorm."""
    if "SAF" in scorer:
        return _SAF_LINEARS, _SAF_BNS
    n = 0
    while f"SGR_{n}" in scorer:
        n += 1
    return tuple((f"SGR_module.sgr{i}.{ours}", ("scorer", f"SGR_{i}", theirs))
                 for i in range(n) for ours, theirs in _SGR_STEP), ()


# VSRN's caption model: port Linear -> (JAX path, the kernel's name); the
# decoder keeps its weights as raw (in, out) arrays
_CAPTION_LINEARS = (
    ("encoder.vid2hid", ("encoder", "vid2hid"), "kernel", "bias"),
    ("decoder.attention.linear1", ("decoder",), "att_w1", "att_b1"),
    ("decoder.attention.linear2", ("decoder",), "att_w2", None),
    ("decoder.out", ("decoder",), "out_w", "out_b"),
)


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):  # a torch tensor
        v = v.detach().cpu().numpy()
    return np.array(v)  # a writable, contiguous copy


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _bn(sd: dict, key: str, params, stats) -> None:
    """A flax TorchBatchNormCore's scale, bias and statistics -> the port's
    BatchNorm1d keys under `key`."""
    sd[f"{key}.weight"] = _np(params["scale"])
    sd[f"{key}.bias"] = _np(params["bias"])
    sd[f"{key}.running_mean"] = _np(stats["mean"])
    sd[f"{key}.running_var"] = _np(stats["var"])
    sd[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)


def _vsrn_image(sd: dict, img, stats) -> None:
    """VSRN's EncoderImagePrecompAttn: the RsGCN blocks' 1x1 convs (out, in,
    1) and W.1 BatchNorms, the region GRU and the f30k BatchNorm `bn`."""
    for i in range(1, 5):
        g = f"Rs_GCN_{i}"
        for ours, theirs in (("g", "g"), ("theta", "theta"), ("phi", "phi"), ("W.0", "W")):
            sd[f"img_enc.{g}.{ours}.weight"] = _np(img[g][theirs]["kernel"]).T[:, :, None]
            sd[f"img_enc.{g}.{ours}.bias"] = _np(img[g][theirs]["bias"])
        _bn(sd, f"img_enc.{g}.W.1", img[g]["W_bn"], stats[g]["W_bn"])
    for ours, theirs in _GRU:
        sd[f"img_enc.img_rnn.{ours}"] = _np(img["img_rnn"][theirs])
    if "bn" in img:
        _bn(sd, "img_enc.bn", img["bn"]["BatchNorm_0"], stats["bn"]["BatchNorm_0"])


def _vsrn_caption(sd: dict, cm) -> None:
    """VSRN's caption model (itrx/utils/ref_convert.py::convert_vsrn_caption,
    the other way)."""
    for ours, path, w, b in _CAPTION_LINEARS:
        sd[f"caption_model.{ours}.weight"] = _np(_at(cm, path)[w]).T
        if b is not None:
            sd[f"caption_model.{ours}.bias"] = _np(_at(cm, path)[b])
    sd["caption_model.decoder.embedding.weight"] = _np(cm["decoder"]["embedding"])
    for ours, theirs in _GRU:
        sd[f"caption_model.encoder.rnn.{ours}"] = _np(cm["encoder"]["rnn"][theirs])
        sd[f"caption_model.decoder.rnn.{ours}"] = _np(cm["decoder"][theirs])


# one BERT layer: port module -> flax Dense, and port LayerNorm -> flax
# BertLayerNorm (itrx/utils/ref_convert.py::_bert_layer)
_BERT_LINEARS = (("attention.self.query", "query"), ("attention.self.key", "key"),
                 ("attention.self.value", "value"), ("attention.output.dense", "attn_output"),
                 ("intermediate.dense", "intermediate"), ("output.dense", "output"))
_BERT_NORMS = (("attention.output.LayerNorm", "attn_ln"), ("output.LayerNorm", "out_ln"))
_AGSA_LINEARS = (("linears.0", "linear_q"), ("linears.1", "linear_k"),
                 ("linears.2", "linear_v"), ("fc_q", "fc_q"), ("fc_k", "fc_k"),
                 ("fc_g", "fc_g"))


def _linear(sd: dict, key: str, node) -> None:
    sd[f"{key}.weight"] = _np(node["kernel"]).T
    sd[f"{key}.bias"] = _np(node["bias"])


def _layer_norm(sd: dict, key: str, node) -> None:
    sd[f"{key}.gamma"] = _np(node["gamma"])
    sd[f"{key}.beta"] = _np(node["beta"])


def _bert(sd: dict, key: str, bert) -> None:
    """A flax BertModel -> the port's BertModel keys under `key`."""
    for name in ("word", "position", "token_type"):
        sd[f"{key}.embeddings.{name}_embeddings.weight"] = _np(bert[f"{name}_embeddings"])
    _layer_norm(sd, f"{key}.embeddings.LayerNorm", bert["emb_ln"])
    i = 0
    while f"layer_{i}" in bert:
        layer, base = bert[f"layer_{i}"], f"{key}.encoder.layer.{i}"
        for ours, theirs in _BERT_LINEARS:
            _linear(sd, f"{base}.{ours}", layer[theirs])
        for ours, theirs in _BERT_NORMS:
            _layer_norm(sd, f"{base}.{ours}", layer[theirs])
        i += 1
    _linear(sd, f"{key}.pooler.dense", bert["pooler"])


def _agsa(sd: dict, key: str, agsa, stats) -> None:
    """A flax AGSA (att_{i}, bn_{i}) -> the reference's att_layers.{i},
    bns.{i} under `key`."""
    i = 0
    while f"att_{i}" in agsa:
        for ours, theirs in _AGSA_LINEARS:
            _linear(sd, f"{key}.att_layers.{i}.{ours}", agsa[f"att_{i}"][theirs])
        _bn(sd, f"{key}.bns.{i}", agsa[f"bn_{i}"]["BatchNorm_0"],
            stats[f"bn_{i}"]["BatchNorm_0"])
        i += 1


def _camera(variables) -> dict:
    """CAMERA's two towers (itrx/utils/ref_convert.py::convert_camera_img and
    ::convert_camera_txt, the other way); fc_g's (d_k, 2 d_k) kernel stays
    whole."""
    p, stats = variables["params"], variables["batch_stats"]
    img, txt = p["img_enc"], p["txt_enc"]
    sd = {}
    _linear(sd, "img_enc.fc", img["fc"])
    _linear(sd, "img_enc.position_enc.proj", img["position_enc"]["proj"])
    _agsa(sd, "img_enc.agsa", img["agsa"], stats["img_enc"]["agsa"])
    i = 0
    while f"conv_{i}" in img["mvs"]:
        conv = img["mvs"][f"conv_{i}"]
        sd[f"img_enc.mvs.convs_dilate.{i}.weight"] = _np(conv["kernel"]).transpose(2, 1, 0)
        sd[f"img_enc.mvs.convs_dilate.{i}.bias"] = _np(conv["bias"])
        i += 1
    _linear(sd, "img_enc.mvs.convs_fc", img["mvs"]["convs_fc"])
    _bert(sd, "txt_enc.bert", txt["bert"])
    _linear(sd, "txt_enc.mapping", txt["mapping"])
    _agsa(sd, "txt_enc.agsa", txt["agsa"], stats["txt_enc"]["agsa"])
    _linear(sd, "txt_enc.fc1", txt["fc1"])
    _linear(sd, "txt_enc.fc2", txt["fc2"])
    _bn(sd, "txt_enc.bn", txt["bn"]["BatchNorm_0"], stats["txt_enc"]["bn"]["BatchNorm_0"])
    return sd


def from_itrx_variables(variables) -> dict:
    """A JAX SCAN, VSRN, SGRAF or CAMERA variable tree ({'params': {...}}
    and, for VSRN, SGRAF and CAMERA, {'batch_stats': {...}}; leaves as
    arrays) -> the port's state dict (numpy values)."""
    p = variables["params"]
    img, txt = p["img_enc"], p["txt_enc"]
    if "mvs" in img:
        return {k: np.ascontiguousarray(v) for k, v in _camera(variables).items()}
    sd = {
        "img_enc.fc.weight": _np(img["fc"]["kernel"]).T,
        "img_enc.fc.bias": _np(img["fc"]["bias"]),
        "txt_enc.embed.weight": _np(txt["embedding"]),
    }
    gru = txt["MaskedGRU_0"]
    for suf in ("", "_reverse"):
        if f"w_ih{suf}" in gru:
            for ours, theirs in _GRU:
                sd[f"txt_enc.rnn.{ours}{suf}"] = _np(gru[f"{theirs}{suf}"])
    if "sim_enc" in p:
        sim, stats = p["sim_enc"], variables["batch_stats"]["sim_enc"]
        linears, bns = _sgraf_modules(sim["scorer"])
        for ours, path in _SGRAF_LINEARS + linears:
            sd[f"sim_enc.{ours}.weight"] = _np(_at(sim, path)["kernel"]).T
            sd[f"sim_enc.{ours}.bias"] = _np(_at(sim, path)["bias"])
        for ours, path in _SGRAF_BNS + bns:
            _bn(sd, f"sim_enc.{ours}", _at(sim, path), _at(stats, path))
    if "Rs_GCN_1" in img:
        _vsrn_image(sd, img, variables["batch_stats"]["img_enc"])
    if "caption_model" in p:
        _vsrn_caption(sd, p["caption_model"])
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def to_itrx_flat(state_dict) -> list:
    """The port's state dict -> the reference checkpoint's state-dict list,
    [img_enc, txt_enc] for SCAN and CAMERA, [img_enc, txt_enc, sim_enc] for SGRAF and
    [img_enc, txt_enc, caption_model] for VSRN (numpy values), which
    `itrx.utils.ref_convert.convert_state_list` flattens to the JAX
    package's {path: array} leaves (the BatchNorm running statistics
    included: they are eval state)."""
    parts = {"img_enc": {}, "txt_enc": {}, "sim_enc": {}, "caption_model": {}}
    for k, v in state_dict.items():
        head, _, rest = k.partition(".")
        parts[head][rest] = _np(v)
    return [parts["img_enc"], parts["txt_enc"]] + [
        parts[k] for k in ("sim_enc", "caption_model") if parts[k]]
