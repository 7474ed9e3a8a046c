"""Synthetic precomp-format dataset generator for tests and benchmarks.

Writes a directory with the exact file layout the reference consumes
(`{split}_caps.txt`, `{split}_ims.npy`, `{split}_boxes.npy`,
`{split}_img_sizes.npy`): images are region-feature arrays whose features
encode a few "concept" directions, and each image's 5 captions mention those
concepts, so retrieval is learnable and overfit tests can assert recall
actually rises.

The port's copy of itrx/data/synthetic.py: the port imports nothing of the JAX
package, so it keeps its own copy of this stdlib/numpy module.
"""

from __future__ import annotations

import os

import numpy as np

_WORDS = [
    "dog", "cat", "man", "woman", "child", "car", "bike", "tree", "beach",
    "mountain", "ball", "hat", "red", "blue", "green", "park", "street",
    "water", "grass", "table",
]
_FILLER = ["a", "the", "is", "on", "with", "near", "and"]


def generate(
    out_dir: str,
    n_images: int = 64,
    n_regions: int = 36,
    img_dim: int = 128,
    n_concepts_per_image: int = 3,
    splits=("train", "dev", "test"),
    seed: int = 0,
    n_concepts_range=None,
):
    """n_concepts_range=(lo, hi) draws a per-image concept count uniformly,
    giving a realistic caption-length distribution (bench.py uses (2, 10)
    for f30k-like ~14-token captions); None keeps the fixed count."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    k = len(_WORDS)
    basis = rng.standard_normal((k, img_dim)).astype(np.float32)

    for si, split in enumerate(splits):
        n = n_images if split == "train" else max(8, n_images // 4)
        srng = np.random.default_rng(seed + 100 + si)
        if n_concepts_range is not None:
            lo, hi = n_concepts_range
            counts = srng.integers(lo, min(hi, k) + 1, size=n)
        else:
            counts = np.full(n, n_concepts_per_image)
        concepts = [
            srng.choice(k, size=int(counts[i]), replace=False) for i in range(n)
        ]
        ims = np.zeros((n, n_regions, img_dim), np.float32)
        for i in range(n):
            for r in range(n_regions):
                c = concepts[i][r % len(concepts[i])]
                ims[i, r] = basis[c] + 0.3 * srng.standard_normal(img_dim)
        np.save(os.path.join(out_dir, f"{split}_ims.npy"), ims)

        caps = []
        for i in range(n):
            for _ in range(5):
                words = []
                for c in concepts[i]:
                    words.append(str(srng.choice(_FILLER)))
                    words.append(_WORDS[c])
                srng.shuffle(words)
                caps.append(" ".join(words))
        with open(os.path.join(out_dir, f"{split}_caps.txt"), "w") as f:
            f.write("\n".join(caps) + "\n")

        boxes = srng.uniform(0, 200, size=(n, n_regions, 4)).astype(np.float32)
        boxes[..., 2:] = boxes[..., :2] + srng.uniform(
            10, 100, size=(n, n_regions, 2)
        ).astype(np.float32)
        np.save(os.path.join(out_dir, f"{split}_boxes.npy"), boxes)
        wh = np.full((n, 2), 320.0, np.float32)
        np.save(os.path.join(out_dir, f"{split}_img_sizes.npy"), wh)

    return out_dir


def write_tiny_bert_vocab(path: str):
    """A minimal wordpiece vocab.txt covering the synthetic caption words."""
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    pieces = sorted(set(_WORDS + _FILLER))
    with open(path, "w") as f:
        f.write("\n".join(specials + pieces) + "\n")
    return path
