"""Host-side data pipeline over precomputed region features.

Reference: itr/datamodule/data_loader.py:52-235 (PrecompDataset/collate_fn/
loader factories).  TPU-first redesign:

 - captions are tokenized ONCE up front into dense (N, L) int32 arrays with a
   static per-split pad length, instead of per-item nltk calls in worker
   processes; L is the split's max caption length rounded up to a multiple of
   8 and capped by config['pad_words'],
 - batches keep STATIC shapes: no sort-by-length (ref :146), no
   pack_padded_sequence; validity travels as a (B, L) mask,
 - the big `{split}_ims.npy` is memory-mapped, so multi-GB COCO feature files
   never fully materialize in host RAM,
 - the final partial batch is dropped in training (shuffled epochs still
   cover the data) and zero-padded + masked in evaluation, so jit never sees
   a second batch shape.

VSRN parity quirk (deliberate): the reference pads every VSRN caption to
max_len+1 in the dataset itself, so its text GRU runs over pad tokens and the
"last valid state" gather lands at the fixed final index
(data_loader.py:117-125 + TextEncoder.py:57-60 with lengths == max_len+1).
We replicate that: for VSRN, `cap_mask` (fed to the encoder) is all-ones of
length max_len+1 while `label_mask` (for the caption decoder loss) marks real
tokens.

The port's copy of itrx/data/precomp.py: the port imports nothing of the JAX
package, so it keeps its own copy of this stdlib/numpy module.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from . import tokenization
from . import vocab as vocab_mod
from .treebank import word_tokenize


# raw-pixel datasets (VSE++ only, ref config.py:26: "coco|f8k|f30k only used
# in the VSE++"); everything else is precomp-format
RAW_DATASET_NAMES = {"coco", "f8k", "f30k"}
# the two vocabularies shipped with the repo (a data directory of the JAX
# package, read by path: nothing of it is imported)
SHIPPED_VOCAB_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "itrx", "vocab",
)


def _round_up(x, m=8):
    return ((x + m - 1) // m) * m


@dataclass
class PrecompDataset:
    """All-splits-in-RAM tokenized caption set + mmap'd image features."""

    data_path: str
    data_split: str
    config: dict
    # populated in __post_init__
    images: np.ndarray = field(init=False)
    cap_ids: np.ndarray = field(init=False)
    cap_mask: np.ndarray = field(init=False)
    type_ids: np.ndarray | None = field(init=False, default=None)
    label_ids: np.ndarray | None = field(init=False, default=None)
    label_mask: np.ndarray | None = field(init=False, default=None)
    boxes: np.ndarray | None = field(init=False, default=None)
    img_wh: np.ndarray | None = field(init=False, default=None)

    def __post_init__(self):
        cfg = self.config
        split = self.data_split

        captions = []
        with open(os.path.join(self.data_path, f"{split}_caps.txt"), "rb") as f:
            for line in f:
                captions.append(line.strip())

        self.images = np.load(
            os.path.join(self.data_path, f"{split}_ims.npy"), mmap_mode="r"
        )
        if cfg.get("use_bbox"):
            self.boxes = np.load(os.path.join(self.data_path, f"{split}_boxes.npy"))
            self.img_wh = np.load(
                os.path.join(self.data_path, f"{split}_img_sizes.npy")
            )

        self.length = len(captions)
        self.im_div = 5 if self.images.shape[0] != self.length else 1
        # the development set for coco is large; cap validation at 5000
        # (ref data_loader.py:79-80)
        if split == "dev" and self.length > 5000:
            self.length = 5000
            captions = captions[:5000]

        if cfg["text_encoder"] == "bert":
            self._tokenize_bert(captions)
        else:
            self._tokenize_words(captions)

        self.vocab_size = self._vocab_size

    # -- tokenization ------------------------------------------------------

    def _tokenize_bert(self, captions):
        cfg = self.config
        tokenizer = tokenization.FullTokenizer(
            vocab_file=cfg["vocab_file"], do_lower_case=True
        )
        self._vocab_size = len(tokenizer.vocab)
        L = cfg["max_words"]
        n = len(captions)
        ids = np.zeros((n, L), np.int32)
        mask = np.zeros((n, L), np.float32)
        type_ids = np.zeros((n, L), np.int32)
        for i, cap in enumerate(captions):
            _, cid, cm, ct = tokenization.convert_to_feature(cap, L, tokenizer)
            ids[i], mask[i], type_ids[i] = cid, cm, ct
        self.cap_ids, self.cap_mask, self.type_ids = ids, mask, type_ids

    def _tokenize_words(self, captions):
        cfg = self.config
        voc = self._load_vocab()
        self._vocab_size = len(voc)
        seqs = []
        for cap in captions:
            toks = word_tokenize(str(cap.decode("utf-8") if isinstance(cap, bytes) else cap).lower())
            seqs.append(
                [voc(vocab_mod.START)]
                + [voc(t) for t in toks]
                + [voc(vocab_mod.END)]
            )

        if cfg["name"] == "VSRN":
            # fixed length max_len+1, all-ones encoder mask (parity quirk),
            # real-token label mask for the caption decoder
            max_len = cfg["max_len"]
            L = max_len + 1
            n = len(seqs)
            ids = np.zeros((n, L), np.int32)
            lmask = np.zeros((n, L), np.float32)
            for i, s in enumerate(seqs):
                s = s[:max_len]
                ids[i, : len(s)] = s
                lmask[i, : len(s)] = 1.0
            self.cap_ids = ids
            self.cap_mask = np.ones((n, L), np.float32)
            self.label_ids = ids
            self.label_mask = lmask
            return

        max_words = max(len(s) for s in seqs)
        L = min(_round_up(max_words), cfg.get("pad_words", 96))
        n = len(seqs)
        ids = np.zeros((n, L), np.int32)
        mask = np.zeros((n, L), np.float32)
        for i, s in enumerate(seqs):
            s = s[:L]
            ids[i, : len(s)] = s
            mask[i, : len(s)] = 1.0
        self.cap_ids, self.cap_mask = ids, mask

    def _load_vocab(self):
        cfg = self.config
        vtype = cfg.get("vocab_type", "json")
        path = os.path.join(
            cfg["vocab_path"], f"{cfg['data_name']}_vocab.{ 'json' if vtype == 'json' else 'pkl'}"
        )
        if os.path.exists(path):
            if vtype == "json":
                return vocab_mod.deserialize_vocab(path)
            return vocab_mod.load_vocab_pkl(path)
        # also try the other extension before building from scratch
        stem, ext = os.path.splitext(path)
        alt = stem + (".pkl" if ext == ".json" else ".json")
        if os.path.exists(alt):
            if alt.endswith("json"):
                return vocab_mod.deserialize_vocab(alt)
            return vocab_mod.load_vocab_pkl(alt)
        # shipped reference vocab, read as a data file from the repo's
        # itrx/vocab/ (works from any cwd; same data files the reference
        # ships in itr/vocab/)
        shipped = os.path.join(SHIPPED_VOCAB_DIR, f"{cfg['data_name']}_vocab.json")
        if os.path.exists(shipped):
            return vocab_mod.deserialize_vocab(shipped)
        # no shipped vocab: build from the training captions (threshold 4,
        # ref vocab.py:79-106) and cache it
        train_caps = os.path.join(self.data_path, "train_caps.txt")
        with open(train_caps, "rb") as f:
            captions = [line.strip() for line in f]
        voc = vocab_mod.build_vocab(captions, threshold=4)
        os.makedirs(cfg["vocab_path"], exist_ok=True)
        vocab_mod.serialize_vocab(
            voc, os.path.join(cfg["vocab_path"], f"{cfg['data_name']}_vocab.json")
        )
        return voc

    # -- batching ----------------------------------------------------------

    def __len__(self):
        return self.length

    def gather(self, idx):
        """Assemble the universal batch dict for dataset indices `idx`."""
        img_idx = idx // self.im_div
        batch = {
            "images": np.ascontiguousarray(self.images[img_idx]).astype(
                np.float32, copy=False
            ),
            "cap_ids": self.cap_ids[idx],
            "cap_mask": self.cap_mask[idx],
            "ids": idx.astype(np.int32),
        }
        if self.type_ids is not None:
            batch["type_ids"] = self.type_ids[idx]
        if self.label_ids is not None:
            batch["label_ids"] = self.label_ids[idx]
            batch["label_mask"] = self.label_mask[idx]
        if self.boxes is not None:
            batch["boxes"] = self.boxes[img_idx].astype(np.float32, copy=False)
            batch["imgs_wh"] = self.img_wh[img_idx].astype(np.float32, copy=False)
        return batch

    def train_batches(self, batch_size, seed=0, epoch=0):
        """Shuffled batches; drops the final partial batch.

        Batches keep their random composition (same sampling as the
        reference), but each batch's caption arrays are trimmed to the batch
        max length rounded up to a multiple of 8 — a handful of static shapes
        instead of one, and the GRU scan + cross-attention cost tracks the
        true lengths instead of the corpus max.  VSRN keeps its fixed
        max_len+1 layout (the labels feed the fixed-length decoder).
        """
        rng = np.random.default_rng(seed + epoch)
        order = rng.permutation(self.length)
        n_batches = self.length // batch_size
        trim = self.label_ids is None and self.type_ids is None
        for b in range(n_batches):
            batch = self.gather(order[b * batch_size : (b + 1) * batch_size])
            if trim:
                lb = int(batch["cap_mask"].sum(axis=1).max())
                lb = min(_round_up(max(lb, 8)), batch["cap_ids"].shape[1])
                batch["cap_ids"] = batch["cap_ids"][:, :lb]
                batch["cap_mask"] = batch["cap_mask"][:, :lb]
            yield batch

    def eval_batches(self, batch_size):
        """In-order batches; the final batch is zero-padded with `n_valid` set."""
        for start in range(0, self.length, batch_size):
            idx = np.arange(start, min(start + batch_size, self.length))
            n_valid = len(idx)
            if n_valid < batch_size:
                idx = np.concatenate(
                    [idx, np.zeros(batch_size - n_valid, np.int64)]
                )
            batch = self.gather(idx)
            batch["n_valid"] = n_valid
            yield batch


def _refuse_raw_images(name):
    raise NotImplementedError(
        f"raw-image datasets ({name}) are not ported yet: ROADMAP queue 1 item 12 "
        "(VSE++ raw-image path)")


def get_loaders(config):
    """(train_dataset, val_dataset, vocab_size) — ref data_loader.py:199-228."""
    name = config["data_name"]
    dpath = os.path.join(config["data_path"], name)
    if name in RAW_DATASET_NAMES:
        _refuse_raw_images(name)
    train = PrecompDataset(dpath, "train", config)
    val = PrecompDataset(dpath, "dev", config)
    return train, val, train.vocab_size


def get_test_loader(split_name, config):
    """(test_dataset, vocab_size) — ref data_loader.py:231-235."""
    name = config["data_name"]
    dpath = os.path.join(config["data_path"], name)
    if name in RAW_DATASET_NAMES:
        _refuse_raw_images(name)
    ds = PrecompDataset(dpath, split_name, config)
    return ds, ds.vocab_size
