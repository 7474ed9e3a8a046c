"""Weights between the JAX package and the port, numpy only (counterpart of
itrx/utils/ref_convert.py for SCAN).

The port keeps the reference PyTorch names and layouts: Linear `weight
(out, in)`, `torch.nn.GRU`'s `weight_ih_l0` ... (+ `_reverse`), and
`embed.weight`.  The JAX package keeps flax's: Dense `kernel (in, out)`,
MaskedGRU `w_ih` ..., and `embedding`.
"""

from __future__ import annotations

import numpy as np

_GRU = (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh"),
        ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh"))


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):  # a torch tensor
        v = v.detach().cpu().numpy()
    return np.array(v)  # a writable, contiguous copy


def from_itrx_variables(variables) -> dict:
    """A JAX SCAN variable tree ({'params': {...}}, leaves as arrays) ->
    the port's state dict (numpy values)."""
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
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def to_itrx_flat(state_dict) -> list:
    """The port's state dict -> the reference checkpoint's state-dict list
    [img_enc, txt_enc] (numpy values), which
    `itrx.utils.ref_convert.convert_state_list('SCAN', ...)` flattens to the
    JAX package's {path: array} leaves."""
    img_sd, txt_sd = {}, {}
    for k, v in state_dict.items():
        head, _, rest = k.partition(".")
        {"img_enc": img_sd, "txt_enc": txt_sd}[head][rest] = _np(v)
    return [img_sd, txt_sd]
