"""Weights between the JAX package and the port, numpy only (counterpart of
itrx/utils/ref_convert.py for SCAN and SGRAF with SGR or SAF).

The port keeps the reference PyTorch names and layouts: Linear `weight
(out, in)`, `torch.nn.GRU`'s `weight_ih_l0` ... (+ `_reverse`),
`embed.weight` and BatchNorm `weight`, `bias`, `running_mean`,
`running_var`.  The JAX package keeps flax's: Dense `kernel (in, out)`,
MaskedGRU `w_ih` ..., `embedding`, and BatchNorm `scale`, `bias` with
`mean`, `var` in the `batch_stats` collection.
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


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):  # a torch tensor
        v = v.detach().cpu().numpy()
    return np.array(v)  # a writable, contiguous copy


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def from_itrx_variables(variables) -> dict:
    """A JAX SCAN or SGRAF variable tree ({'params': {...}} and, for SGRAF,
    {'batch_stats': {...}}; leaves as arrays) -> the port's state dict
    (numpy values)."""
    p = variables["params"]
    img, txt = p["img_enc"], p["txt_enc"]
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
            sd[f"sim_enc.{ours}.weight"] = _np(_at(sim, path)["scale"])
            sd[f"sim_enc.{ours}.bias"] = _np(_at(sim, path)["bias"])
            sd[f"sim_enc.{ours}.running_mean"] = _np(_at(stats, path)["mean"])
            sd[f"sim_enc.{ours}.running_var"] = _np(_at(stats, path)["var"])
            sd[f"sim_enc.{ours}.num_batches_tracked"] = np.zeros((), np.int64)
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def to_itrx_flat(state_dict) -> list:
    """The port's state dict -> the reference checkpoint's state-dict list,
    [img_enc, txt_enc] for SCAN and [img_enc, txt_enc, sim_enc] for SGRAF
    (numpy values), which `itrx.utils.ref_convert.convert_state_list` flattens
    to the JAX package's {path: array} leaves (the BatchNorm running
    statistics included: they are eval state)."""
    parts = {"img_enc": {}, "txt_enc": {}, "sim_enc": {}}
    for k, v in state_dict.items():
        head, _, rest = k.partition(".")
        parts[head][rest] = _np(v)
    return [parts["img_enc"], parts["txt_enc"]] + ([parts["sim_enc"]] if parts["sim_enc"] else [])
