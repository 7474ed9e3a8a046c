"""Model factory (counterpart of itrx/models/__init__.py::get_model)."""

from __future__ import annotations

import os

import torch

from ..data.precomp import RAW_DATASET_NAMES
from ..utils.cli import default_device
from . import bert, bert_methods, methods


def get_model(config: dict, device=None, generator: torch.Generator | None = None):
    """Build the method named by config['name'] from a flat config dict.

    Weights are drawn on the CPU from `generator` (so one seed gives the same
    weights on every device) and then moved to `device`: cuda:0 when None
    (raising without a GPU), the CPU only when asked for."""
    device = default_device(device, "get_model")
    name = config["name"]
    if name in ("VSE_PP", "VSE++"):
        if config.get("data_name", "f30k_precomp") in RAW_DATASET_NAMES:
            raise NotImplementedError(
                f"VSE++ on raw images ({config['data_name']}) is not ported yet: ROADMAP "
                "queue 1 item 12 (the VGG19 / ResNet152 towers)")
        model = methods.VSEPP(
            vocab_size=config["vocab_size"],
            img_dim=config["img_dim"],
            embed_size=config["embed_size"],
            word_dim=config["word_dim"],
            measure=config["measure"],
            use_abs=config["use_abs"],
            no_imgnorm=config["no_imgnorm"],
            margin=config.get("margin", 0.2),
            max_violation=config.get("max_violation", False),
            generator=generator,
        )
        return model.to(device).eval()
    if name == "SAEM":
        return _saem(config, generator).to(device).eval()
    if name == "CAMERA":
        return _camera(config, generator).to(device).eval()
    if name == "VSRN":
        model = methods.VSRN(
            vocab_size=config["vocab_size"],
            img_dim=config["img_dim"],
            embed_size=config["embed_size"],
            word_dim=config["word_dim"],
            data_name=config["data_name"],
            measure=config["measure"],
            use_abs=config["use_abs"],
            no_imgnorm=config["no_imgnorm"],
            no_txtnorm=config["no_txtnorm"],
            margin=config.get("margin", 0.2),
            max_violation=config.get("max_violation", False),
            max_len=config["max_len"],
            dim_hidden=config["dim_hidden"],
            dim_vid=config["dim_vid"],
            dim_word=config["dim_word"],
            input_dropout_p=config["input_dropout_p"],
            dropout_seed=config.get("seed", 0),
            generator=generator,
        )
        return model.to(device).eval()
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
        use_fused_eval=config.get("use_fused_eval", True),
        precomp_enc_type=config.get("precomp_enc_type", "basic"),
        generator=generator,
    )
    return model.to(device).eval()


def _load_bert(config: dict, model) -> None:
    """The frozen tower loaded from `init_checkpoint` when that file exists
    (itrx's load_pretrained_weights)."""
    path = config.get("init_checkpoint")
    if path and os.path.exists(path):
        bert.load_torch_bert(path, model.txt_enc.bert)
        print(f"=> loaded pretrained BERT weights from {path}")


def _saem(config: dict, generator: torch.Generator | None):
    """SAEM with the config's BERT (`bert_config_file` when it exists, else
    BERT-base with `vocab_size`) and transformer block
    (bert_methods.trans_config_from), its frozen tower loaded from
    `init_checkpoint` when that file exists (itrx's build_saem)."""
    model = methods.SAEM(
        bert.bert_config_from(config),
        bert_methods.trans_config_from(config),
        img_dim=config["img_dim"],
        final_dims=config["final_dims"],
        embed_size=config["embed_size"],
        txt_stru=config["txt_stru"],
        img_stru=config.get("img_stru", "trans"),
        bi_gru=config["bi_gru"],
        margin=config.get("margin", 0.2),
        max_violation=config.get("max_violation", False),
        measure=config["measure"],
        dropout_seed=config.get("seed", 0),
        generator=generator,
    )
    _load_bert(config, model)
    return model


def _camera(config: dict, generator: torch.Generator | None):
    """CAMERA with the config's BERT (`bert_config_file` when it exists,
    else BERT-base with `vocab_size`), its frozen tower loaded from
    `init_checkpoint` when that file exists (itrx's load_pretrained_weights)."""
    model = methods.CAMERA(
        bert.bert_config_from(config),
        img_dim=config["img_dim"],
        embed_size=config["embed_size"],
        head=config["head"],
        smry_k=config["smry_k"],
        smry_lamda=config.get("smry_lamda", 0.01),
        drop=config.get("drop", 0.0),
        margin=config.get("margin", 0.2),
        max_violation=config.get("max_violation", False),
        dropout_seed=config.get("seed", 0),
        generator=generator,
    )
    _load_bert(config, model)
    return model
