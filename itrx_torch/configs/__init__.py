"""Config system: base config + six named method configs + CLI parsing.

Reference: itr/config.py (sacred Experiment "ITR").  sacred is not a
dependency; this module reproduces the exact CLI surface —

    python train.py with $METHOD key=value ...

— over plain dicts: a base config (:20-106), per-method named-config overlays
(:109-378), the config hook's derived state (seed default, save-dir layout,
BERT paths, hparams.yaml dump; :381-414) and the `load_hyperparams` resume
whitelist (:12-17).

The port's copy of itrx/configs/__init__.py: the port imports nothing of the JAX
package, so it keeps its own copy of this stdlib/numpy module.
"""

from __future__ import annotations

import ast
import os
import random
import time

__all__ = ["VSE_PP", "SCAN", "VSRN", "SAEM", "SGRAF", "CAMERA"]

# hyperparameters re-imposed from a checkpoint's embedded config on resume
# (ref config.py:12-17)
load_hyperparams = [
    "img_encoder", "crop_size", "img_dim", "no_imgnorm", "use_bbox",
    "finetune", "precomp_enc_type", "trans_cfg", "head", "text_encoder",
    "bi_gru", "word_dim", "no_txtnorm", "num_layers", "max_words",
    "txt_stru", "embed_size", "measure", "use_abs", "final_dims", "sim_dim",
    "rnn_type", "bidirectional", "dim_hidden", "dim_vid", "input_dropout_p",
    "rnn_dropout_p", "dim_word", "max_len", "module_name", "sgr_step",
    "max_violation", "margin", "cross_attn", "raw_feature_norm", "agg_func",
    "lambda_lse", "lambda_softmax", "smry_k", "smry_lamda", "lr_decay_gamma",
    "drop",
]


def base_config() -> dict:
    """Base flag set (ref config.py:20-106), plus TPU-specific knobs."""
    return dict(
        name="ITR",
        # load and save
        data_path="/workspace/dataset/data",
        data_name="f30k_precomp",
        vocab_path="./itrx/vocab",
        vocab_type="json",
        save_path="./runs",
        tail=None,
        # server
        seed=0,
        workers=8,          # raw-image decode threads (precomp path needs none)
        # train
        resume=None,
        num_epochs=30,
        batch_size=128,
        learning_rate=2e-4,
        lr_update=15,
        val_step=500,
        log_step=10,
        grad_clip=2.0,
        use_restval=False,
        # image encoder
        img_encoder="vgg19",
        crop_size=224,
        img_dim=4096,
        no_imgnorm=False,
        use_bbox=False,
        finetune=False,
        precomp_enc_type="basic",
        trans_cfg="./itrx/configs/trans_cfg.json",
        head=64,
        # text encoder
        text_encoder="gru",
        bi_gru=False,
        word_dim=300,
        no_txtnorm=False,
        num_layers=1,
        bert_path="/workspace/dataset/uncased_L-12_H-768_A-12",
        max_words=32,
        txt_stru="cnn",
        # fusion / joint embedding
        embed_size=1024,
        measure="cosine",
        use_abs=False,
        final_dims=256,
        sim_dim=256,
        rnn_type="gru",
        bidirectional=0,
        dim_hidden=512,
        dim_vid=2048,
        input_dropout_p=0.2,
        rnn_dropout_p=0.5,
        dim_word=300,
        max_len=60,
        module_name="SGR",
        sgr_step=3,
        # loss
        max_violation=False,
        margin=0.2,
        cross_attn="t2i",
        raw_feature_norm="clipped_l2norm",
        agg_func="LogSumExp",
        lambda_lse=6.0,
        lambda_softmax=9.0,
        smry_k=12,
        smry_lamda=0.01,
        lr_decay_gamma=0.1,
        drop=0.0,
        # TPU-native knobs (no reference equivalent)
        pad_words=96,        # static caption pad cap for GRU-family methods
        cap_chunk=32,        # SGRAF caption chunking
        eval_img_tile=256,   # eval sim-matrix tiling (images per tile)
        eval_cap_tile=1024,  # eval sim-matrix tiling (captions per tile)
        use_fused_eval=True,   # SCAN eval grid on the CUDA kernels (False: the plain grid)
        eval_bf16=False,     # bf16 embeddings in the eval sim grid (fp32 accum)
        train_bf16=False,    # bf16 mixed-precision training (fp32 master state)
        sim_bf16=False,      # SGRAF: bf16 alignment chain in the sim tower
        sim_remat=True,      # SGRAF: rematerialize chunk activations in bwd
        mesh_shape=None,     # e.g. {'dp': 8} for multi-chip data parallel
        # multi-host (pod) launch: one process per host (itrx/parallel/
        # multihost.py).  multihost=True auto-detects from TPU metadata;
        # explicit coordinator keys support generic launchers.
        multihost=False,
        coordinator_address=None,  # host:port of process 0
        num_processes=None,
        process_id=None,
    )


def VSE_PP() -> dict:
    """BMVC'17 VSE++ overlay (ref config.py:109-151)."""
    return dict(
        name="VSE++",
        data_name="f30k_precomp",
        vocab_type="pkl",
        val_step=10,
        img_encoder="vgg19",
        img_dim=4096,
        no_txtnorm=True,
        embed_size=1024,
        measure="cosine",
    )


def SCAN() -> dict:
    """ECCV'18 SCAN overlay (ref config.py:154-195)."""
    return dict(
        name="SCAN",
        img_dim=2048,
        no_txtnorm=True,
        embed_size=1024,
        cross_attn="t2i",
        raw_feature_norm="clipped_l2norm",
        agg_func="LogSumExp",
        lambda_lse=6.0,
        lambda_softmax=9.0,
    )


def VSRN() -> dict:
    """VSRN overlay (ref config.py:198-251)."""
    return dict(
        name="VSRN",
        img_dim=2048,
        embed_size=2048,
        dim_hidden=512,
        dim_vid=2048,
        max_len=60,
    )


def SAEM() -> dict:
    """ACM MM'19 SAEM overlay (ref config.py:254-290)."""
    return dict(
        name="SAEM",
        batch_size=64,
        learning_rate=1e-4,
        lr_update=10,
        val_step=1000,
        img_dim=2048,
        text_encoder="bert",
        max_words=32,
        txt_stru="cnn",
        final_dims=256,
    )


def SGRAF() -> dict:
    """AAAI'21 SGRAF overlay (ref config.py:293-330)."""
    return dict(
        name="SGRAF",
        module_name="SAF",
        sgr_step=3,
        num_epochs=40,
        lr_update=30,
        val_step=1000,
        img_dim=2048,
        bi_gru=True,
        embed_size=1024,
        sim_dim=256,
    )


def CAMERA() -> dict:
    """ACM MM'20 CAMERA overlay (ref config.py:333-378).

    num_epochs=1 mirrors the reference's odd named-config default; README
    commands override it (SURVEY.md §2.11 item 8).
    """
    return dict(
        name="CAMERA",
        num_epochs=1,
        learning_rate=1e-4,
        lr_update=10,
        img_dim=2048,
        use_bbox=True,
        head=64,
        text_encoder="bert",
        max_words=32,
        embed_size=2048,
        smry_k=12,
        smry_lamda=0.01,
        lr_decay_gamma=0.1,
        drop=0.0,
    )


_NAMED = {
    "VSE_PP": VSE_PP,
    "VSE++": VSE_PP,
    "SCAN": SCAN,
    "VSRN": VSRN,
    "SAEM": SAEM,
    "SGRAF": SGRAF,
    "CAMERA": CAMERA,
}


def _parse_value(v: str):
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        if v == "None":
            return None
        if v == "True":
            return True
        if v == "False":
            return False
        return v


def parse_cli(argv, make_dirs: bool = True) -> dict:
    """Parse `with METHOD k=v ...` into a finished config (sacred surface).

    sacred priority semantics: named configs resolve first (in argv order),
    then explicit `key=value` overrides apply on top — an explicit override
    always beats a named config regardless of its position on the line.
    """
    cfg = base_config()
    args = list(argv)
    if args and args[0] == "with":
        args = args[1:]
    overrides = []
    for a in args:
        if "=" in a:
            k, v = a.split("=", 1)
            overrides.append((k, _parse_value(v)))
        elif a in _NAMED:
            cfg.update(_NAMED[a]())
        else:
            raise ValueError(f"Unknown named config or malformed override: {a}")
    cfg.update(overrides)
    return finish_config(cfg, make_dirs=make_dirs)


def finish_config(cfg: dict, make_dirs: bool = True) -> dict:
    """The config hook (ref config.py:381-414): seed, dirs, BERT paths, dump."""
    if cfg.get("seed") is None:
        cfg["seed"] = random.randint(0, 10000)
    if cfg["name"] == "VSE++":
        cfg["name"] = "VSE_PP"
    if cfg["name"] not in __all__:
        raise ValueError(
            f"Please choose a method in {__all__}. {cfg['name']} is given."
        )

    if make_dirs:
        save_dir = os.path.join(
            cfg["save_path"],
            cfg["name"],
            "_".join(
                [
                    cfg["data_name"].split("_")[0],
                    str(cfg["seed"]),
                    time.strftime("%Y-%m-%d-%H-%M-%S", time.localtime()),
                ]
            ),
        )
        if cfg.get("tail"):
            save_dir = save_dir + cfg["tail"]
        os.makedirs(save_dir, exist_ok=True)
        cfg["save_dir"] = save_dir

    if cfg["text_encoder"] == "bert":
        cfg.setdefault("vocab_file", os.path.join(cfg["bert_path"], "vocab.txt"))
        cfg.setdefault(
            "bert_config_file", os.path.join(cfg["bert_path"], "bert_config.json")
        )
        cfg.setdefault(
            "init_checkpoint", os.path.join(cfg["bert_path"], "pytorch_model.bin")
        )

    if make_dirs:
        try:
            import yaml

            with open(os.path.join(save_dir, "hparams.yaml"), "w") as f:
                yaml.dump(cfg, f)
        except ImportError:
            import json

            with open(os.path.join(save_dir, "hparams.json"), "w") as f:
                json.dump(cfg, f, indent=2, default=str)
    return cfg
