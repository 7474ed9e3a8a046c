"""Model factory (counterpart of itrx/models/__init__.py::get_model)."""

from __future__ import annotations

import torch

from . import methods

# methods not ported yet -> the ROADMAP item that ports each
_NOT_PORTED = {
    "VSE_PP": "ROADMAP queue 1 item 3 (VSE_PP)",
    "VSE++": "ROADMAP queue 1 item 3 (VSE_PP)",
    "VSRN": "ROADMAP queue 1 item 9 (VSRN)",
    "SAEM": "ROADMAP queue 1 item 10 (SAEM)",
    "SGRAF": "ROADMAP queue 1 item 8 (SGRAF)",
    "CAMERA": "ROADMAP queue 1 item 11 (CAMERA)",
}


def get_model(config: dict, device="cpu", generator: torch.Generator | None = None):
    """Build the method named by config['name'] from a flat config dict.

    Weights are drawn on the CPU from `generator` (so one seed gives the same
    weights on every device) and then moved to `device`."""
    name = config["name"]
    if name in _NOT_PORTED:
        raise NotImplementedError(f"{name} is not ported yet: {_NOT_PORTED[name]}")
    if name != "SCAN":
        raise ValueError(f"unknown method {name!r}")
    if config.get("precomp_enc_type", "basic") != "basic":
        raise NotImplementedError(
            "precomp_enc_type='weight_norm' is not ported yet: ROADMAP queue 1 item 3"
        )
    model = methods.SCAN(
        vocab_size=config["vocab_size"],
        img_dim=config["img_dim"],
        embed_size=config["embed_size"],
        word_dim=config["word_dim"],
        bi_gru=config["bi_gru"],
        no_imgnorm=config["no_imgnorm"],
        no_txtnorm=config["no_txtnorm"],
        cross_attn=config["cross_attn"],
        raw_feature_norm=config["raw_feature_norm"],
        agg_func=config["agg_func"],
        lambda_lse=config["lambda_lse"],
        lambda_softmax=config["lambda_softmax"],
        margin=config["margin"],
        max_violation=config["max_violation"],
        generator=generator,
    )
    return model.to(device).eval()
