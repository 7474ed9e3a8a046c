"""Evaluation engine (counterpart of itrx/eval/engine.py: `encode_data`,
`cal_sims`, `evaluate_split` with fold5, `evalrank_single` and
`evalrank_ensemble`).

encode -> length-bucketed similarity grid -> Recall@K, all on `device`
(cuda:0 unless the caller passes another, e.g. `device="cpu"`).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from torch.func import functional_call

from ..utils.cli import default_device
from . import metrics

# budget of the plain path's (Ni, tile, R, L) fp32 attention tensor; the
# kernel path holds no such tensor
PLAIN_ATTN_BYTES = 1 << 30
# tiles of a grid of sentence-level (2-D) embeddings (itrx's cal_sims
# defaults): bounds order_sim's (cap tile, img tile, D) difference tensor
IMG_TILE = 256
CAP_TILE = 1024
# batch fields a reduced-precision encode keeps fp32 (itrx's _KEEP_F32): box
# geometry, whose bf16 rounding collapses a thin box to height 0
KEEP_F32 = ("boxes", "imgs_wh")


def _to_device(v: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(v))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


@torch.no_grad()
def encode_data(model, dataset, batch_size: int, device=None,
                compute_dtype: torch.dtype | None = None,
                encode_dtype: torch.dtype | None = None) -> dict:
    """Encode a split in order on `device` (cuda:0 when None); returns the
    stacked embeddings (+ masks).

    `encode_dtype=torch.bfloat16` runs the embed forward in bf16: the
    parameters and the float batch fields are cast; the buffers (BatchNorm
    statistics), the masks and the box geometry (KEEP_F32) stay fp32.
    `compute_dtype` casts the stacked embeddings (not the masks) for the
    similarity grid.
    """
    device = default_device(device, "encode_data")
    params = dict(model.named_parameters())
    if encode_dtype is not None:
        params = {k: p.to(encode_dtype) for k, p in params.items()}
    outs = []
    for batch in dataset.eval_batches(batch_size):
        n_valid = batch.pop("n_valid")
        placed = {k: _to_device(v, device) for k, v in batch.items()}
        if encode_dtype is not None:
            placed = {
                k: v.to(encode_dtype)
                if v.dtype == torch.float32 and "mask" not in k and k not in KEEP_F32 else v
                for k, v in placed.items()
            }
        e = functional_call(model, params, (placed,), strict=False)
        outs.append({k: v[:n_valid] for k, v in e.items()})
    result = {}
    for k in outs[0]:
        v = torch.cat([o[k] for o in outs], dim=0)
        if "mask" in k:
            v = v.float()
        elif compute_dtype is not None:
            v = v.to(compute_dtype)
        result[k] = v
    return result


def length_buckets(cap_mask: torch.Tensor, max_len: int):
    """Captions sorted into up to four length buckets with bounds at the
    length quartiles, rounded up to multiples of 8.  Returns
    [(caption indices (int64, numpy), word bound)]."""
    lengths = cap_mask.sum(dim=1).cpu().numpy().astype(np.int64)
    order = np.argsort(lengths, kind="stable")
    nc = len(lengths)
    bounds = sorted(
        {
            int(-(-int(lengths[order[min(int(q * nc), nc - 1)]]) // 8) * 8)
            for q in (0.25, 0.5, 0.75, 1.0)
        }
    )
    bounds[-1] = max(bounds[-1], int(-(-lengths.max() // 8) * 8))
    bounds[-1] = min(bounds[-1], max_len)
    buckets = []
    prev = 0
    for b in bounds:
        in_bucket = order[(lengths[order] > prev) & (lengths[order] <= b)]
        prev = b
        if len(in_bucket):
            buckets.append((in_bucket, b))
    return buckets


def _cal_sims_tiled(model, img_embs, cap_embs):
    """The (Ni, Nc) fp32 grid of `model.similarity` on sentence-level
    embeddings (no mask), over tiles of IMG_TILE images x CAP_TILE captions:
    the unbucketed path of itrx/eval/engine.py::_cal_sims_tiled."""
    ni, nc = img_embs.shape[0], cap_embs.shape[0]
    sims = torch.zeros(ni, nc, dtype=torch.float32, device=img_embs.device)
    for i0 in range(0, ni, IMG_TILE):
        for j0 in range(0, nc, CAP_TILE):
            sims[i0:i0 + IMG_TILE, j0:j0 + CAP_TILE] = model.similarity(
                img_embs[i0:i0 + IMG_TILE], cap_embs[j0:j0 + CAP_TILE], None, train=False)
    return sims


@torch.no_grad()
def cal_sims(model, img_embs, cap_embs, cap_mask=None,
             compute_dtype: torch.dtype | None = None, verbose: bool = True):
    """The (Ni, Nc) fp32 similarity grid.

    Sentence-level (2-D) caption embeddings (VSRN; no mask) go through
    `_cal_sims_tiled`.  Per-word (3-D) captions are sorted into length
    buckets, each trimmed to its own word bound (the similarity cost is
    linear in it), scored, and scattered back to their columns.  With fewer than 64 captions everything is one bucket
    at full length.  On the kernel path each bucket is one launch; on the
    plain path a bucket is tiled over captions so that its (Ni, tile, R, L)
    attention tensor stays under PLAIN_ATTN_BYTES.
    """
    t0 = time.perf_counter()
    if compute_dtype is not None:
        img_embs = img_embs.to(compute_dtype)
        cap_embs = cap_embs.to(compute_dtype)
    if cap_embs.dim() != 3:
        sims = _cal_sims_tiled(model, img_embs, cap_embs)
        _report(sims, t0, verbose)
        return sims
    ni, r = img_embs.shape[:2]
    nc, max_len = cap_embs.shape[:2]
    if nc < 64:
        buckets = [(np.arange(nc), max_len)]
    else:
        buckets = length_buckets(cap_mask, max_len)
    kernel = model.fused_eval_active(img_embs.device, train=False)
    sims = torch.zeros(ni, nc, dtype=torch.float32, device=img_embs.device)
    for in_bucket, b in buckets:
        idx = torch.from_numpy(in_bucket).to(img_embs.device)
        caps_b = cap_embs[idx, :b]
        mask_b = cap_mask[idx, :b]
        tile = len(in_bucket) if kernel else max(PLAIN_ATTN_BYTES // (ni * r * b * 4), 1)
        for j0 in range(0, len(in_bucket), tile):
            sims[:, idx[j0:j0 + tile]] = model.similarity(
                img_embs, caps_b[j0:j0 + tile], mask_b[j0:j0 + tile], train=False
            )
    _report(sims, t0, verbose)
    return sims


def _report(sims, t0: float, verbose: bool) -> None:
    if verbose:
        if sims.is_cuda:
            torch.cuda.synchronize(sims.device)
        print("Calculate similarity matrix elapses: {:.3f}s".format(time.perf_counter() - t0))


def _eval_dtypes(config: dict):
    """(encode dtype, grid dtype) of a config: a bf16 embed forward hands bf16
    stacks to the grid either way."""
    edt = torch.bfloat16 if config.get("encode_bf16") else None
    cdt = torch.bfloat16 if (config.get("eval_bf16") or edt) else None
    return edt, cdt


def _encode(model, dataset, config: dict, device) -> dict:
    edt, cdt = _eval_dtypes(config)
    return encode_data(model, dataset, config["batch_size"], device=device,
                       compute_dtype=cdt, encode_dtype=edt)


def _grid(model, enc: dict, config: dict, im_div: int, sl: slice = slice(None)):
    """cal_sims of the encoded split (or of its caption slice `sl`): every
    im_div-th image row against every caption."""
    mask = enc["cap_mask"][sl] if "cap_mask" in enc else None
    return cal_sims(model, enc["img"][sl][::im_div], enc["cap"][sl], mask,
                    compute_dtype=_eval_dtypes(config)[1])


def _fold5(grid_of) -> dict:
    """5-fold cross-validation over coco testall (itrx/eval/engine.py:731-757,
    ref evaluation.py:293-331): fold i is captions [5000 i, 5000 (i + 1)) and
    every 5th image row of them; grid_of(slice) gives its (1000, 5000) grid."""
    res = {"sum_result": []}
    for i in range(5):
        sims = grid_of(slice(i * 5000, (i + 1) * 5000))
        print(f"--------------------- The {i + 1} part ---------------------")
        r = metrics.cal_recall(sims)
        res[f"PART_{i + 1}"] = r
        res["sum_result"] += r["result"]
    res["Mean_metrics"] = _fold5_mean_metrics(res["sum_result"])
    return res


def _fold5_mean_metrics(sum_result) -> dict:
    """The per-direction mean block over the 5 folds.  Per-part rows are
    list(r) + list(ri) + [ar, ari, rsum]: indices 10 = ar, 11 = ari,
    12 = rsum (the reference's evaluation.py:310-314 misreads them; fixed
    as in the JAX package)."""
    mean_metrics = tuple(np.array(sum_result).mean(axis=0).flatten())
    print("---------------------------------------------------------")
    print("--------------------- Mean metrics: ---------------------")
    print("rsum: %.1f" % mean_metrics[12])
    print("Image to text: r1 %.1f; r5 %.1f; r10 %.1f; medr %.1f; meanr %.1f" % mean_metrics[:5])
    print("Text to image: r1 %.1f; r5 %.1f; r10 %.1f; medr %.1f; meanr %.1f" % mean_metrics[5:10])
    names = ("i2t_r1", "i2t_r5", "i2t_r10", "i2t_medr", "i2t_meanr",
             "t2i_r1", "t2i_r5", "t2i_r10", "t2i_medr", "t2i_meanr",
             "i2t_ave_r", "t2i_ave_r", "rsum")
    return dict(zip(names, mean_metrics))


def evaluate_split(model, dataset, config: dict, fold5: bool = False, device=None) -> dict:
    """encode -> dedup images -> sims -> recalls on `device` (cuda:0 when
    None).  With `fold5`, the five coco folds and their mean."""
    device = default_device(device, "evaluate_split")
    enc = _encode(model, dataset, config, device)
    if fold5:
        res = _fold5(lambda sl: _grid(model, enc, config, 5, sl))
        res["data_name"] = config["data_name"] + "_5fold"
        return res
    sims = _grid(model, enc, config, dataset.im_div)
    res = metrics.cal_recall(sims, cap_ratio=dataset.im_div)
    res["data_name"] = config["data_name"]
    return res


def _load_model_for_eval(model_path: str, data_path: str | None, device):
    """(model on `device`, config) from a `.pth.tar` of
    itrx_torch.utils.checkpoint: the model is rebuilt from the checkpoint's
    `_config` and its weights loaded."""
    from ..models import get_model
    from ..utils.checkpoint import load_checkpoint, load_state_list

    ckpt = load_checkpoint(model_path)
    config = dict(ckpt["_config"])
    print("Best model: Epoch = {}, Eiters = {}, Rsum = {:.2f}, R1 = {:.2f}".format(
        ckpt["epoch"], ckpt["Eiters"], ckpt["best_rsum"], ckpt["best_r1"]))
    if data_path is not None:
        config["data_path"] = data_path
    model = get_model(config, device=device)
    load_state_list(model, ckpt["model"])
    return model, config


def _dump_result(res: dict, model_path: str, suffix: str) -> str:
    """Write `{data_name}_{suffix}_result.yaml` beside the checkpoint when
    yaml imports (arrays left out).  Returns the path."""
    path = os.path.join(os.path.dirname(model_path),
                        f"{res['data_name']}_{suffix}_result.yaml")
    try:
        import yaml
    except ImportError:
        return path

    def clean(o):
        if isinstance(o, dict):
            return {k: clean(v) for k, v in o.items() if not isinstance(v, np.ndarray)}
        if isinstance(o, (np.floating, np.integer)):
            return float(o)
        return o

    with open(path, "w") as f:
        yaml.dump(clean(res), f)
    return path


def evalrank_single(model_path: str, data_path: str | None = None, split: str = "dev",
                    fold5: bool = False, device=None) -> dict:
    """Offline evaluation of one checkpoint on `device` (cuda:0 when None)."""
    from ..data import precomp

    device = default_device(device, "evalrank_single")
    model, config = _load_model_for_eval(model_path, data_path, device)
    print(f"Loading dataset : {config['data_name']} ......")
    dataset, _ = precomp.get_test_loader(split, config)
    print("Computing results...")
    res = evaluate_split(model, dataset, config, fold5=fold5, device=device)
    _dump_result(res, model_path, "single")
    return res


def evalrank_ensemble(model_path: str, model_path2: str, data_path: str | None = None,
                      split: str = "dev", fold5: bool = False, device=None) -> dict:
    """Two-checkpoint ensemble on `device` (cuda:0 when None): each model is
    rebuilt from its own config (so a t2i and an i2t SCAN can mix), the
    split comes from the first, and the two grids are averaged before
    ranking (itrx/eval/engine.py:851-915)."""
    from ..data import precomp

    device = default_device(device, "evalrank_ensemble")
    members = [_load_model_for_eval(p, data_path, device) for p in (model_path, model_path2)]
    config = members[0][1]
    dataset, _ = precomp.get_test_loader(split, config)
    encs = [_encode(m, dataset, cfg, device) for m, cfg in members]

    def averaged(im_div, sl=slice(None)):
        (m1, cfg1), (m2, cfg2) = members
        return (_grid(m1, encs[0], cfg1, im_div, sl) + _grid(m2, encs[1], cfg2, im_div, sl)) / 2.0

    if fold5:
        res = _fold5(lambda sl: averaged(5, sl))
        res["data_name"] = config["data_name"] + "_5fold"
    else:
        res = metrics.cal_recall(averaged(dataset.im_div), cap_ratio=dataset.im_div)
        res["data_name"] = config["data_name"]
    res["modal_path_1"] = model_path
    res["modal_path_2"] = model_path2
    _dump_result(res, model_path, "ensemble")
    return res
