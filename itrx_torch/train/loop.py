"""Training orchestration (counterpart of itrx/train/loop.py).

One train step (forward, backward through the GRU kernels, clip, step-decay
rate, Adam), the epoch loop with periodic validation and checkpoints, and
`fit` with resume.  As in the JAX package: validation returns (rsum,
i2t r1) in that order, checkpoints store `best_r1`, and the batch order is
the dataset's numpy order for (seed, epoch).
"""

from __future__ import annotations

import logging
import threading
import time
from queue import Queue

import numpy as np
import torch

from ..configs import load_hyperparams
from ..data import precomp
from ..eval import engine
from ..utils.checkpoint import (load_checkpoint, load_state_list,
                                save_train_checkpoint)
from ..utils.cli import default_device
from ..utils.logging import AverageMeter, LogCollector, MetricWriter, second2DHM
from .state import TrainState, create_train_state

logger = logging.getLogger("itrx")

PREFETCH_BATCHES = 2
_END = object()


def check_supported(config: dict) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for what the
    port's training does not do yet."""
    if config.get("train_bf16"):
        raise NotImplementedError(
            "train_bf16 is not ported yet: ROADMAP queue 1 item 7 (bf16 W_hh in "
            "both GRU kernels)")
    if config.get("mesh_shape") or config.get("multihost") or config.get(
            "coordinator_address"):
        raise NotImplementedError(
            "multi-device training (mesh_shape / multihost) is not ported yet: "
            "ROADMAP queue 1 item 13")
    if config["name"] not in ("SCAN", "VSRN", "SGRAF"):
        raise NotImplementedError(
            f"training {config['name']} is not ported yet: only SCAN, VSRN and SGRAF are "
            "(VSE++ is ROADMAP queue 1 item 3, SAEM item 10, CAMERA item 11b: the AGSA "
            "backward kernel; CAMERA evaluation is ported)")


def make_train_step(state: TrainState, seed: int = 0):
    """step(batch, log, epoch) -> aux floats when `log`, else None.  One update in
    train mode (BatchNorm on batch statistics, dropout on): reseed the
    model's dropout stream from (seed, update count), so a resumed run draws
    the masks an uninterrupted one draws; zero the grads, loss forward and
    backward, then clip, rate and Adam (TrainState.apply_gradients).  The
    epoch reaches the loss, as in `itrx`'s step.  Nothing waits for the
    device unless `log`."""
    model = state.model
    model.train()

    def step(batch: dict, log: bool = False, epoch: int = 0):
        if not model.training:
            model.train()
        if hasattr(model, "dropout_rng"):
            model.dropout_rng.manual_seed(seed * 100003 + state.step)
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = state.model.loss(batch, train=True, epoch=epoch)
        loss.backward()
        state.apply_gradients()
        if log:
            return {k: v.item() for k, v in aux.items()}
        return None

    return step


def prefetch(iterator, device):
    """Host -> device prefetch.  A producer thread gathers the numpy
    batches (and pins them when `device` is a GPU); the consumer copies them
    to `device` without blocking.  A producer error is re-raised in the
    consumer (a silent producer death would hang training on the queue)."""
    device = torch.device(device)
    pin = device.type == "cuda"
    q: Queue = Queue(maxsize=PREFETCH_BATCHES)

    def producer():
        try:
            for item in iterator:
                host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in item.items()}
                q.put({k: v.pin_memory() for k, v in host.items()} if pin else host)
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            q.put(e)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield {k: v.to(device, non_blocking=True) for k, v in item.items()}


def validate_step(config: dict, state: TrainState, val_dataset, device, writer):
    """Evaluate on the validation split (the port's evaluate_split, the
    method's eval kernel on a GPU) with the model in eval mode (running
    statistics, no dropout), then restore its mode.  Returns (rsum, i2t r1)."""
    start = time.time()
    was_training = state.model.training
    state.model.eval()
    try:
        res = engine.evaluate_split(state.model, val_dataset, config, device=device)
    finally:
        state.model.train(was_training)
    print("Calculate similarity time:", time.time() - start)
    logger.info(
        "Image to text: r1 %.1f; r5 %.1f; r10 %.1f; medr %.1f; meanr %.1f",
        res["i2t_r1"], res["i2t_r5"], res["i2t_r10"], res["i2t_medr"], res["i2t_meanr"],
    )
    logger.info(
        "Text to image: r1 %.1f; r5 %.1f; r10 %.1f; medr %.1f; meanr %.1f",
        res["t2i_r1"], res["t2i_r5"], res["t2i_r10"], res["t2i_medr"], res["t2i_meanr"],
    )
    writer.log_dict(
        {
            "r1_i2t": res["i2t_r1"], "r5_i2t": res["i2t_r5"],
            "r10_i2t": res["i2t_r10"], "medr_i2t": res["i2t_medr"],
            "meanr_i2t": res["i2t_meanr"], "r1_t2i": res["t2i_r1"],
            "r5_t2i": res["t2i_r5"], "r10_t2i": res["t2i_r10"],
            "medr_t2i": res["t2i_medr"], "meanr_t2i": res["t2i_meanr"],
            "r_sum": res["rsum"],
        },
        state.step,
    )
    return res["rsum"], res["i2t_r1"]


def train_epoch(config: dict, state: TrainState, train_dataset, val_dataset,
                epoch: int, writer, device, best_rsum: float, best_r1: float):
    """One epoch: train steps, logging every `log_step` updates, validation
    and checkpoints every `val_step` updates.  Returns (best_rsum, best_r1)."""
    batch_time = AverageMeter()
    data_time = AverageMeter()
    train_logger = LogCollector()
    step_fn = make_train_step(state, config["seed"])
    n_batches = len(train_dataset) // config["batch_size"]
    it = prefetch(
        train_dataset.train_batches(config["batch_size"], config["seed"], epoch), device
    )
    end = time.time()
    for i, batch in enumerate(it):
        data_time.update(time.time() - end, n=1)
        log = (state.step + 1) % config["log_step"] == 0
        aux = step_fn(batch, log=log, epoch=epoch)
        eiters = state.step
        if log:
            for k, v in aux.items():
                train_logger.update(k, v, config["batch_size"])
            batch_time.update(time.time() - end, n=1)
            logger.info(
                "Epoch: [%d][%d/%d]\t%s\tTime %.3f (%s)\tData %.3f (%s)",
                epoch, i, n_batches, str(train_logger),
                batch_time.avg, second2DHM(batch_time.sum)[0],
                data_time.avg, second2DHM(data_time.sum)[0],
            )
            writer.log_dict(
                {"epoch": epoch, "step": i, "batch_time": batch_time.val,
                 "data_time": data_time.val, **aux},
                eiters,
            )
        end = time.time()

        if config["val_step"] > 0 and eiters % config["val_step"] == 0:
            rsum, r1 = validate_step(config, state, val_dataset, device, writer)
            is_best = rsum > best_rsum
            best_rsum = max(rsum, best_rsum)
            best_r1 = max(r1, best_r1)
            save_train_checkpoint(state, config, epoch, best_rsum, best_r1, is_best,
                                  prefix=config["save_dir"])
    return best_rsum, best_r1


def fit(config: dict, train_dataset=None, val_dataset=None, device=None):
    """Full training on `device` (cuda:0 when None; the CPU only when asked
    for).  Returns (state, best_rsum).

    Weights are drawn from torch.Generator().manual_seed(config["seed"]);
    `resume` restores the model, the Adam state, Eiters, the epoch and the
    best scores, re-imposing the checkpoint's architecture hyperparameters
    (configs.load_hyperparams)."""
    from ..models import get_model

    check_supported(config)
    device = default_device(device, "fit")
    if train_dataset is None:
        train_dataset, val_dataset, vocab_size = precomp.get_loaders(config)
        config["vocab_size"] = vocab_size
    else:
        config.setdefault("vocab_size", train_dataset.vocab_size)

    steps_per_epoch = max(len(train_dataset) // config["batch_size"], 1)
    start_epoch, best_rsum, best_r1 = 0, 0.0, 0.0
    ckpt = None
    if config.get("resume"):
        ckpt = load_checkpoint(config["resume"])
        for k in load_hyperparams:
            if k in ckpt["_config"]:
                config[k] = ckpt["_config"][k]
    model = get_model(config, device=device,
                      generator=torch.Generator().manual_seed(config["seed"]))
    state = create_train_state(model, config, steps_per_epoch)
    writer = MetricWriter(config["save_dir"])
    try:
        if ckpt is not None:
            load_state_list(model, ckpt["model"])
            state.optimizer.load_state_dict(ckpt["opt"])
            state.step = int(ckpt["Eiters"])
            start_epoch = ckpt["epoch"]
            best_rsum, best_r1 = ckpt["best_rsum"], ckpt["best_r1"]
            print("=> loaded checkpoint '{}' (epoch {}, best_rsum {}, best_r1 {})".format(
                config["resume"], start_epoch, best_rsum, best_r1))
            validate_step(config, state, val_dataset, device, writer)

        n_params = sum(p.numel() for p in model.parameters())
        print("Optimizable parameter number of the whole model is ", n_params)

        for epoch in range(start_epoch, config["num_epochs"]):
            best_rsum, best_r1 = train_epoch(
                config, state, train_dataset, val_dataset, epoch, writer, device,
                best_rsum, best_r1,
            )
            rsum, r1 = validate_step(config, state, val_dataset, device, writer)
            is_best = rsum > best_rsum
            best_rsum = max(rsum, best_rsum)
            best_r1 = max(r1, best_r1)
            save_train_checkpoint(state, config, epoch, best_rsum, best_r1, is_best,
                                  prefix=config["save_dir"], is_epo_end=True)
    finally:
        writer.close()
    return state, best_rsum
