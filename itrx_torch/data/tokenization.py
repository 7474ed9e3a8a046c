"""Self-contained BERT wordpiece tokenizer.

Implements the standard Google BERT tokenization algorithm (unicode cleanup +
whitespace/punctuation basic tokenizer + greedy longest-match-first wordpiece)
that the reference vendors in itr/datamodule/tokenization.py.  Written from
the published algorithm, not ported; behavior is interchangeable: same vocab
files, same [CLS]/[SEP]/[UNK]/## conventions.

The port's copy of itrx/data/tokenization.py: the port imports nothing of the JAX
package, so it keeps its own copy of this stdlib/numpy module.
"""

from __future__ import annotations

import collections
import unicodedata


def convert_to_unicode(text):
    if isinstance(text, str):
        return text
    if isinstance(text, bytes):
        return text.decode("utf-8", "ignore")
    raise ValueError(f"Unsupported string type: {type(text)}")


def load_vocab(vocab_file):
    """vocab.txt -> OrderedDict token -> id."""
    vocab = collections.OrderedDict()
    with open(vocab_file, "r", encoding="utf-8") as reader:
        for index, line in enumerate(reader):
            token = convert_to_unicode(line).strip()
            vocab[token] = index
    return vocab


def _is_whitespace(ch):
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch):
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch):
    cp = ord(ch)
    if (
        (33 <= cp <= 47)
        or (58 <= cp <= 64)
        or (91 <= cp <= 96)
        or (123 <= cp <= 126)
    ):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_chinese_char(cp):
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


class BasicTokenizer:
    """Whitespace cleanup, lowercasing, accent stripping, punctuation split."""

    def __init__(self, do_lower_case=True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text):
        text = convert_to_unicode(text)
        text = self._clean_text(text)
        text = self._tokenize_chinese_chars(text)
        tokens = text.split()
        out = []
        for token in tokens:
            if self.do_lower_case:
                token = token.lower()
                token = self._strip_accents(token)
            out.extend(self._split_on_punc(token))
        return " ".join(out).split()

    @staticmethod
    def _strip_accents(text):
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_on_punc(text):
        out = []
        word = []
        for ch in text:
            if _is_punctuation(ch):
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out

    @staticmethod
    def _tokenize_chinese_chars(text):
        out = []
        for ch in text:
            if _is_chinese_char(ord(ch)):
                out.append(" ")
                out.append(ch)
                out.append(" ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _clean_text(text):
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)


class WordpieceTokenizer:
    """Greedy longest-match-first subword tokenization."""

    def __init__(self, vocab, unk_token="[UNK]", max_input_chars_per_word=200):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, text):
        output_tokens = []
        for token in convert_to_unicode(text).split():
            chars = list(token)
            if len(chars) > self.max_input_chars_per_word:
                output_tokens.append(self.unk_token)
                continue
            is_bad = False
            start = 0
            sub_tokens = []
            while start < len(chars):
                end = len(chars)
                cur_substr = None
                while start < end:
                    substr = "".join(chars[start:end])
                    if start > 0:
                        substr = "##" + substr
                    if substr in self.vocab:
                        cur_substr = substr
                        break
                    end -= 1
                if cur_substr is None:
                    is_bad = True
                    break
                sub_tokens.append(cur_substr)
                start = end
            if is_bad:
                output_tokens.append(self.unk_token)
            else:
                output_tokens.extend(sub_tokens)
        return output_tokens


class FullTokenizer:
    """BasicTokenizer + WordpieceTokenizer over a vocab.txt file or dict."""

    def __init__(self, vocab_file=None, do_lower_case=True, vocab=None):
        self.vocab = vocab if vocab is not None else load_vocab(vocab_file)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.basic_tokenizer = BasicTokenizer(do_lower_case=do_lower_case)
        self.wordpiece_tokenizer = WordpieceTokenizer(vocab=self.vocab)

    def tokenize(self, text):
        split_tokens = []
        for token in self.basic_tokenizer.tokenize(text):
            split_tokens.extend(self.wordpiece_tokenizer.tokenize(token))
        return split_tokens

    def convert_tokens_to_ids(self, tokens):
        return [self.vocab[t] for t in tokens]

    def convert_ids_to_tokens(self, ids):
        return [self.inv_vocab[i] for i in ids]


def convert_to_feature(raw, seq_length, tokenizer):
    """Caption -> (tokens, ids, mask, type_ids) padded to seq_length.

    Mirrors the reference's convert_to_feature (data_loader.py:18-49),
    including its idiosyncratic `tokens.insert(-1, "[SEP]")` placement which
    puts [SEP] *before* the final wordpiece.
    """
    line = convert_to_unicode(raw)
    tokens_a = tokenizer.tokenize(line)
    if len(tokens_a) > seq_length - 2:
        tokens_a = tokens_a[0 : (seq_length - 2)]

    tokens = list(tokens_a)
    tokens.insert(0, "[CLS]")
    tokens.insert(-1, "[SEP]")
    input_type_ids = [0] * len(tokens)
    input_ids = tokenizer.convert_tokens_to_ids(tokens)
    input_mask = [1] * len(input_ids)

    if len(input_ids) < seq_length:
        fill_len = seq_length - len(input_ids)
        input_ids.extend([0] * fill_len)
        input_mask.extend([0] * fill_len)
        input_type_ids.extend([0] * fill_len)

    return tokens, input_ids, input_mask, input_type_ids
