"""Word-level vocabulary (ref itr/datamodule/vocab.py).

Same on-disk JSON layout ({word2idx, idx2word, idx}) and the same special
tokens <pad>/<start>/<end>/<unk> at ids 0-3, so vocabularies built by the
reference load unchanged (and vice versa).  Pickled reference vocabs also
load via a small shim class registered under the reference module path.

The port's copy of itrx/data/vocab.py: the port imports nothing of the JAX
package, so it keeps its own copy of this stdlib/numpy module.
"""

from __future__ import annotations

import json
import pickle
from collections import Counter

from .treebank import word_tokenize

PAD, START, END, UNK = "<pad>", "<start>", "<end>", "<unk>"


class Vocabulary:
    def __init__(self):
        self.word2idx = {}
        self.idx2word = {}
        self.idx = 0

    def add_word(self, word):
        if word not in self.word2idx:
            self.word2idx[word] = self.idx
            self.idx2word[self.idx] = word
            self.idx += 1

    def __call__(self, word):
        return self.word2idx.get(word, self.word2idx[UNK])

    def __len__(self):
        return len(self.word2idx)


def serialize_vocab(vocab: Vocabulary, dest: str):
    d = {"word2idx": vocab.word2idx, "idx2word": vocab.idx2word, "idx": vocab.idx}
    with open(dest, "w") as f:
        json.dump(d, f)


def deserialize_vocab(src: str) -> Vocabulary:
    with open(src) as f:
        d = json.load(f)
    vocab = Vocabulary()
    vocab.word2idx = d["word2idx"]
    vocab.idx2word = d["idx2word"]
    vocab.idx = d["idx"]
    return vocab


class _RefVocabUnpickler(pickle.Unpickler):
    """Load reference-produced .pkl vocabs without the reference package."""

    def find_class(self, module, name):
        if name == "Vocabulary":
            return Vocabulary
        return super().find_class(module, name)


def load_vocab_pkl(src: str) -> Vocabulary:
    with open(src, "rb") as f:
        obj = _RefVocabUnpickler(f).load()
    if isinstance(obj, Vocabulary):
        return obj
    # tolerate plain dicts too
    vocab = Vocabulary()
    vocab.word2idx = obj["word2idx"]
    vocab.idx2word = obj["idx2word"]
    vocab.idx = obj.get("idx", len(vocab.word2idx))
    return vocab


def build_vocab(captions, threshold: int = 4) -> Vocabulary:
    """Build from an iterable of caption strings (ref vocab.py:79-106)."""
    counter = Counter()
    for caption in captions:
        if isinstance(caption, bytes):
            caption = caption.decode("utf-8")
        counter.update(word_tokenize(caption.lower()))

    words = [w for w, c in counter.items() if c >= threshold]
    vocab = Vocabulary()
    for tok in (PAD, START, END, UNK):
        vocab.add_word(tok)
    for w in words:
        vocab.add_word(w)
    return vocab


def main():
    """CLI: build a vocab from a precomp dataset's caption files.

    python -m itrx_torch.data.vocab --data_path data --data_name f30k_precomp
    (ref itr/datamodule/vocab.py:109-122)
    """
    import argparse
    import os

    ap = argparse.ArgumentParser()
    ap.add_argument("--data_path", default="data")
    ap.add_argument("--data_name", default="f30k_precomp")
    ap.add_argument("--out", default="./itrx/vocab")
    ap.add_argument("--threshold", type=int, default=4)
    args = ap.parse_args()

    captions = []
    for split in ("train", "dev"):
        path = os.path.join(args.data_path, args.data_name, f"{split}_caps.txt")
        if os.path.exists(path):
            with open(path, "rb") as f:
                captions += [line.strip() for line in f]
    vocab = build_vocab(captions, threshold=args.threshold)
    os.makedirs(args.out, exist_ok=True)
    dest = os.path.join(args.out, f"{args.data_name}_vocab.json")
    serialize_vocab(vocab, dest)
    print(f"Saved vocabulary ({len(vocab)} words) to {dest}")


if __name__ == "__main__":
    main()
