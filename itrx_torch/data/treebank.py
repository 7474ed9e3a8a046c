"""Self-contained Penn-Treebank-style word tokenizer.

The reference tokenizes captions with `nltk.tokenize.word_tokenize`
(itr/datamodule/data_loader.py:113), which is sentence-split + the Treebank
word tokenizer.  nltk is not a dependency here; this module implements the
standard published Treebank rules (punctuation splitting, contractions,
quote handling) as a small regex cascade.  Captions are single sentences in
these datasets, so sentence splitting is a no-op in practice.

The port's copy of itrx/data/treebank.py: the port imports nothing of the JAX
package, so it keeps its own copy of this stdlib/numpy module.
"""

from __future__ import annotations

import re

# Rule tables follow the classic sed-script formulation of the Penn Treebank
# tokenizer (tokenizer.sed, Robert McIntyre 1995), same source nltk uses.
_STARTING_QUOTES = [
    (re.compile(r"^\""), r"`` "),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
]

_PUNCTUATION = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    (
        re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'),
        r"\1 \2\3 ",
    ),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]

_PARENS_BRACKETS = [(re.compile(r"[\]\[\(\)\{\}\<\>]"), r" \g<0> ")]

_DOUBLE_DASHES = [(re.compile(r"--"), r" -- ")]

_ENDING_QUOTES = [
    (re.compile(r'"'), " '' "),
    (re.compile(r"(\S)(\'\')"), r"\1 \2 "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]

_CONTRACTIONS2 = [
    re.compile(r"(?i)\b(can)(?#X)(not)\b"),
    re.compile(r"(?i)\b(d)(?#X)('ye)\b"),
    re.compile(r"(?i)\b(gim)(?#X)(me)\b"),
    re.compile(r"(?i)\b(gon)(?#X)(na)\b"),
    re.compile(r"(?i)\b(got)(?#X)(ta)\b"),
    re.compile(r"(?i)\b(lem)(?#X)(me)\b"),
    re.compile(r"(?i)\b(more)(?#X)('n)\b"),
    re.compile(r"(?i)\b(wan)(?#X)(na)(?=\s)"),
]
_CONTRACTIONS3 = [
    re.compile(r"(?i) ('t)(?#X)(is)\b"),
    re.compile(r"(?i) ('t)(?#X)(was)\b"),
]


def treebank_word_tokenize(text: str) -> list[str]:
    """Tokenize one sentence with the Treebank rules."""
    for regexp, substitution in _STARTING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp, substitution in _PUNCTUATION:
        text = regexp.sub(substitution, text)
    for regexp, substitution in _PARENS_BRACKETS:
        text = regexp.sub(substitution, text)
    for regexp, substitution in _DOUBLE_DASHES:
        text = regexp.sub(substitution, text)
    text = " " + text + " "
    for regexp, substitution in _ENDING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp in _CONTRACTIONS2:
        text = regexp.sub(r" \1 \2 ", text)
    for regexp in _CONTRACTIONS3:
        text = regexp.sub(r" \1 \2 ", text)
    return text.split()


def word_tokenize(text: str) -> list[str]:
    """Drop-in for nltk.tokenize.word_tokenize on caption-style input."""
    if isinstance(text, bytes):
        text = text.decode("utf-8", errors="replace")
    return treebank_word_tokenize(text)
