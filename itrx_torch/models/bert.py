"""The BERT tower, written by hand (counterpart of itrx/models/bert.py).

The reference vendors Google's BERT (itr/modalmodule/bert.py): TF-style
LayerNorm with eps 1e-12 inside the sqrt and parameters `gamma` / `beta`,
erf-GELU, the additive -10000 attention mask, and a model that returns every
layer's output and the pooled [CLS] vector.  Module names give the
reference's state-dict keys (`embeddings.word_embeddings.weight`,
`encoder.layer.{i}.attention.self.query.weight`, ...,
`pooler.dense.weight`), so a port checkpoint is the reference's.

The tower runs as the reference's frozen, eval-mode BERT: it has no dropout.
`load_torch_bert` reads a torch BERT checkpoint (bare or `bert.`-prefixed
keys, LayerNorms as `gamma` / `beta` or `weight` / `bias`), as `itrx`'s
`convert_bert_state_dict` accepts it.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass

import torch
from torch import nn


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 16
    initializer_range: float = 0.02

    @classmethod
    def from_json_file(cls, path):
        """The fields this tower reads; the file's others (hidden_act,
        dropout rates) are left out."""
        with open(path) as f:
            d = json.load(f)
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


def bert_config_from(config: dict) -> BertConfig:
    """`config["bert_config_file"]` when that file exists, else BERT-base
    with `config["vocab_size"]` (itrx's build_camera)."""
    path = config.get("bert_config_file")
    if path and os.path.exists(path):
        return BertConfig.from_json_file(path)
    return BertConfig(vocab_size=config.get("vocab_size", 30522))


def _dense(n_in: int, n_out: int, std: float, generator) -> nn.Linear:
    """Linear with a N(0, std) weight and a zero bias (the reference's
    init_bert_weights)."""
    fc = nn.Linear(n_in, n_out)
    with torch.no_grad():
        fc.weight.normal_(0.0, std, generator=generator)
        fc.bias.zero_()
    return fc


def _embedding(n: int, d: int, std: float, generator) -> nn.Embedding:
    emb = nn.Embedding(n, d)
    with torch.no_grad():
        emb.weight.normal_(0.0, std, generator=generator)
    return emb


class BertLayerNorm(nn.Module):
    """TF-style LayerNorm: eps inside the sqrt (ref bert.py:113-126)."""

    def __init__(self, hidden: int, eps: float = 1e-12):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(hidden))
        self.beta = nn.Parameter(torch.zeros(hidden))
        self.eps = eps

    def forward(self, x):
        u = x.mean(dim=-1, keepdim=True)
        s = ((x - u) ** 2).mean(dim=-1, keepdim=True)
        return self.gamma * (x - u) / torch.sqrt(s + self.eps) + self.beta


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None):
        super().__init__()
        std = cfg.initializer_range
        self.word_embeddings = _embedding(cfg.vocab_size, cfg.hidden_size, std, generator)
        self.position_embeddings = _embedding(cfg.max_position_embeddings, cfg.hidden_size,
                                              std, generator)
        self.token_type_embeddings = _embedding(cfg.type_vocab_size, cfg.hidden_size, std,
                                                generator)
        self.LayerNorm = BertLayerNorm(cfg.hidden_size)

    def forward(self, input_ids, token_type_ids):
        n = input_ids.shape[1]
        x = (self.word_embeddings(input_ids.long())
             + self.position_embeddings.weight[None, :n]
             + self.token_type_embeddings(token_type_ids.long()))
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None):
        super().__init__()
        h, std = cfg.hidden_size, cfg.initializer_range
        self.heads = cfg.num_attention_heads
        self.query = _dense(h, h, std, generator)
        self.key = _dense(h, h, std, generator)
        self.value = _dense(h, h, std, generator)

    def forward(self, hidden, attn_bias):
        b, n, h = hidden.shape
        dk = h // self.heads
        q = self.query(hidden).reshape(b, n, self.heads, dk)
        k = self.key(hidden).reshape(b, n, self.heads, dk)
        v = self.value(hidden).reshape(b, n, self.heads, dk)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dk)
        # the bias in the scores' dtype: an fp32 bias would promote a bf16
        # encode back to fp32 (-10000 is exact in bf16)
        probs = torch.softmax(scores + attn_bias.to(scores.dtype), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, n, h)


class BertDenseNorm(nn.Module):
    """dense -> residual -> LayerNorm (the reference's BERTSelfOutput and
    BERTOutput)."""

    def __init__(self, n_in: int, hidden: int, std: float, generator=None):
        super().__init__()
        self.dense = _dense(n_in, hidden, std, generator)
        self.LayerNorm = BertLayerNorm(hidden)

    def forward(self, x, residual):
        return self.LayerNorm(residual + self.dense(x))


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None):
        super().__init__()
        self.self = BertSelfAttention(cfg, generator)
        self.output = BertDenseNorm(cfg.hidden_size, cfg.hidden_size, cfg.initializer_range,
                                    generator)

    def forward(self, hidden, attn_bias):
        return self.output(self.self(hidden, attn_bias), hidden)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None):
        super().__init__()
        self.dense = _dense(cfg.hidden_size, cfg.intermediate_size, cfg.initializer_range,
                            generator)

    def forward(self, x):
        return gelu_erf(self.dense(x))


class BertLayer(nn.Module):
    """One transformer block (ref BERTLayer, bert.py:262-273)."""

    def __init__(self, cfg: BertConfig, generator=None):
        super().__init__()
        self.attention = BertAttention(cfg, generator)
        self.intermediate = BertIntermediate(cfg, generator)
        self.output = BertDenseNorm(cfg.intermediate_size, cfg.hidden_size,
                                    cfg.initializer_range, generator)

    def forward(self, hidden, attn_bias):
        hidden = self.attention(hidden, attn_bias)
        return self.output(self.intermediate(hidden), hidden)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg, generator)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, x, attn_bias) -> list:
        out = []
        for layer in self.layer:
            x = layer(x, attn_bias)
            out.append(x)
        return out


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None):
        super().__init__()
        self.dense = _dense(cfg.hidden_size, cfg.hidden_size, cfg.initializer_range, generator)

    def forward(self, x):
        return torch.tanh(self.dense(x[:, 0]))


class BertModel(nn.Module):
    """Embeddings + encoder stack + pooler (ref BertModel, bert.py:305-358).
    forward returns (every layer's output, the pooled output)."""

    def __init__(self, cfg: BertConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg, generator)
        self.encoder = BertEncoder(cfg, generator)
        self.pooler = BertPooler(cfg, generator)

    def forward(self, input_ids, token_type_ids, attention_mask):
        attn_bias = (1.0 - attention_mask[:, None, None, :].float()) * -10000.0
        layers = self.encoder(self.embeddings(input_ids, token_type_ids), attn_bias)
        return layers, self.pooler(layers[-1])


def convert_bert_state_dict(sd: dict, num_hidden_layers: int) -> dict:
    """A torch BERT state dict (tensors or arrays; bare or `bert.`-prefixed
    keys; LayerNorms as gamma / beta or weight / bias) -> BertModel's state
    dict.  Keys BertModel has no use for (e.g. `embeddings.position_ids`, a
    pre-training head) are left out."""

    def take(key):
        for prefix in ("", "bert."):
            if prefix + key in sd:
                return torch.as_tensor(sd[prefix + key])
        raise KeyError(key)

    def norm(key):
        out = {}
        for ours, alt in (("gamma", "weight"), ("beta", "bias")):
            try:
                out[f"{key}.{ours}"] = take(f"{key}.{ours}")
            except KeyError:
                out[f"{key}.{ours}"] = take(f"{key}.{alt}")
        return out

    names = ["embeddings.word_embeddings.weight", "embeddings.position_embeddings.weight",
             "embeddings.token_type_embeddings.weight", "pooler.dense.weight",
             "pooler.dense.bias"]
    out = norm("embeddings.LayerNorm")
    for i in range(num_hidden_layers):
        base = f"encoder.layer.{i}"
        for lin in ("attention.self.query", "attention.self.key", "attention.self.value",
                    "attention.output.dense", "intermediate.dense", "output.dense"):
            names += [f"{base}.{lin}.weight", f"{base}.{lin}.bias"]
        out.update(norm(f"{base}.attention.output.LayerNorm"))
        out.update(norm(f"{base}.output.LayerNorm"))
    out.update({k: take(k) for k in names})
    return out


def load_torch_bert(path: str, bert: BertModel) -> None:
    """Load a torch BERT checkpoint (the reference's `pytorch_model.bin`)
    into `bert`, strictly."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    bert.load_state_dict(convert_bert_state_dict(sd, bert.config.num_hidden_layers), strict=True)
