"""Model factory (counterpart of itrx/models/__init__.py::get_model)."""

from __future__ import annotations

import torch

from ..utils.cli import default_device
from . import methods

# methods not ported yet -> the ROADMAP item that ports each
_NOT_PORTED = {
    "VSE_PP": "ROADMAP queue 1 item 3 (VSE_PP)",
    "VSE++": "ROADMAP queue 1 item 3 (VSE_PP)",
    "VSRN": "ROADMAP queue 1 item 9 (VSRN)",
    "SAEM": "ROADMAP queue 1 item 10 (SAEM)",
    "CAMERA": "ROADMAP queue 1 item 11 (CAMERA)",
}


def get_model(config: dict, device=None, generator: torch.Generator | None = None):
    """Build the method named by config['name'] from a flat config dict.

    Weights are drawn on the CPU from `generator` (so one seed gives the same
    weights on every device) and then moved to `device`: cuda:0 when None
    (raising without a GPU), the CPU only when asked for."""
    device = default_device(device, "get_model")
    name = config["name"]
    if name in _NOT_PORTED:
        raise NotImplementedError(f"{name} is not ported yet: {_NOT_PORTED[name]}")
    if name == "SGRAF":
        model = methods.SGRAF(
            vocab_size=config["vocab_size"],
            img_dim=config["img_dim"],
            embed_size=config["embed_size"],
            word_dim=config["word_dim"],
            sim_dim=config["sim_dim"],
            bi_gru=config["bi_gru"],
            no_imgnorm=config["no_imgnorm"],
            no_txtnorm=config["no_txtnorm"],
            module_name=config["module_name"],
            sgr_step=config["sgr_step"],
            cap_chunk=config.get("cap_chunk", 32),
            sim_bf16=config.get("sim_bf16", False),
            dropout=config.get("sgraf_dropout", 0.4),
            margin=config.get("margin", 0.2),
            max_violation=config.get("max_violation", False),
            dropout_seed=config.get("seed", 0),
            generator=generator,
        )
        return model.to(device).eval()
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
