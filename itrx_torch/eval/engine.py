"""Evaluation engine (counterpart of itrx/eval/engine.py: `encode_data`,
`cal_sims`, `evaluate_split` and `evalrank_single`, without fold5).

encode -> length-bucketed similarity grid -> Recall@K, all on `device`.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.func import functional_call

from . import metrics

# budget of the plain path's (Ni, tile, R, L) fp32 attention tensor; the
# kernel path holds no such tensor
PLAIN_ATTN_BYTES = 1 << 30


def _to_device(v: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(v))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


@torch.no_grad()
def encode_data(model, dataset, batch_size: int, device="cpu",
                compute_dtype: torch.dtype | None = None,
                encode_dtype: torch.dtype | None = None) -> dict:
    """Encode a split in order; returns the stacked embeddings (+ masks).

    `encode_dtype=torch.bfloat16` runs the embed forward in bf16: the
    parameters and the float batch fields are cast, the masks stay fp32.
    `compute_dtype` casts the stacked embeddings (not the masks) for the
    similarity grid.
    """
    device = torch.device(device)
    params = dict(model.named_parameters())
    if encode_dtype is not None:
        params = {k: p.to(encode_dtype) for k, p in params.items()}
    outs = []
    for batch in dataset.eval_batches(batch_size):
        n_valid = batch.pop("n_valid")
        placed = {k: _to_device(v, device) for k, v in batch.items()}
        if encode_dtype is not None:
            placed = {
                k: v.to(encode_dtype) if v.dtype == torch.float32 and "mask" not in k else v
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


@torch.no_grad()
def cal_sims(model, img_embs, cap_embs, cap_mask,
             compute_dtype: torch.dtype | None = None, verbose: bool = True):
    """The (Ni, Nc) fp32 similarity grid.

    Captions are sorted into length buckets, each trimmed to its own word
    bound (the similarity cost is linear in it), scored, and scattered back
    to their columns.  With fewer than 64 captions everything is one bucket
    at full length.  On the kernel path each bucket is one launch; on the
    plain path a bucket is tiled over captions so that its (Ni, tile, R, L)
    attention tensor stays under PLAIN_ATTN_BYTES.
    """
    t0 = time.perf_counter()
    ni, r = img_embs.shape[:2]
    nc, max_len = cap_embs.shape[:2]
    if nc < 64:
        buckets = [(np.arange(nc), max_len)]
    else:
        buckets = length_buckets(cap_mask, max_len)
    if compute_dtype is not None:
        img_embs = img_embs.to(compute_dtype)
        cap_embs = cap_embs.to(compute_dtype)
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
    if verbose:
        if sims.is_cuda:
            torch.cuda.synchronize(sims.device)
        print("Calculate similarity matrix elapses: {:.3f}s".format(time.perf_counter() - t0))
    return sims


def evaluate_split(model, dataset, config: dict, device="cpu") -> dict:
    """encode -> dedup images -> sims -> recalls (no fold5)."""
    edt = torch.bfloat16 if config.get("encode_bf16") else None
    # a bf16 embed forward hands bf16 stacks to the grid either way
    cdt = torch.bfloat16 if (config.get("eval_bf16") or edt) else None
    enc = encode_data(model, dataset, config["batch_size"], device=device,
                      compute_dtype=cdt, encode_dtype=edt)
    imgs = enc["img"][:: dataset.im_div]
    sims = cal_sims(model, imgs, enc["cap"], enc["cap_mask"], compute_dtype=cdt)
    res = metrics.cal_recall(sims, cap_ratio=dataset.im_div)
    res["data_name"] = config["data_name"]
    return res


def evalrank_single(model_path: str, data_path: str | None = None, split: str = "dev",
                    fold5: bool = False, device="cpu") -> dict:
    """Offline evaluation of one checkpoint (a `.pth.tar` of
    itrx_torch.utils.checkpoint): the model is rebuilt from the checkpoint's
    `_config`, its weights loaded, and `split` evaluated on `device`."""
    from itrx.data import precomp

    from ..models import get_model
    from ..utils.checkpoint import load_checkpoint, load_state_list

    if fold5:
        raise NotImplementedError("fold5 evaluation is not ported yet: ROADMAP queue 1 item 4")
    ckpt = load_checkpoint(model_path)
    config = dict(ckpt["_config"])
    print("Best model: Epoch = {}, Eiters = {}, Rsum = {:.2f}, R1 = {:.2f}".format(
        ckpt["epoch"], ckpt["Eiters"], ckpt["best_rsum"], ckpt["best_r1"]))
    if data_path is not None:
        config["data_path"] = data_path
    model = get_model(config, device=device)
    load_state_list(model, ckpt["model"])
    print(f"Loading dataset : {config['data_name']} ......")
    dataset, _ = precomp.get_test_loader(split, config)
    print("Computing results...")
    return evaluate_split(model, dataset, config, device=device)
