"""BERT encoder in PyTorch (bert-base geometry), the text-embedding model.

Port of the JAX package's flax ``models/bert.py`` encoder, with the same
numerics:

- parameters are f32; the Q/K/V/output and MLP projections run in the
  compute ``dtype`` (their weights are cast to it once, where flax casts
  them on every call — the same values);
- the embedding sum and every LayerNorm (eps 1e-12) run in f32: the
  residual sum is cast to f32 before each LayerNorm and back to ``dtype``
  after; the embedding output is cast to ``dtype``. On the bf16 serving
  rung, which stores every parameter in bf16 as the JAX rung does, the
  embeddings are summed in bf16 and each LayerNorm upcasts its input and
  its scale and bias, as flax's LayerNorm promotes them;
- the additive key mask is ``(1 - mask) * finfo(float32).min`` and is
  added to f32 scores, whatever ``dtype`` is;
- GELU is exact (erf);
- ``pooled`` is the masked mean ``sum(x*m) / max(sum(m), 1)`` over f32
  hidden states.

Attention is pluggable: :func:`dense_attention` (the plain path) or the
flash kernel from ``ops/flash_attention.py`` (``make_flash_attention_fn``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32


BERT_CONFIGS = {
    "base": BertConfig(),
    # 4-layer/128-hidden geometry for tests
    "tiny": BertConfig(
        vocab_size=1000,
        hidden_size=128,
        num_layers=4,
        num_heads=4,
        intermediate_size=256,
        max_position_embeddings=128,
    ),
    # long-context geometry: tiny compute, 2048-entry position table
    "long": BertConfig(
        vocab_size=8192,
        hidden_size=128,
        num_layers=2,
        num_heads=4,
        intermediate_size=256,
        max_position_embeddings=2048,
    ),
}


def bert_base(dtype=torch.float32, device=None) -> "BertEncoder":
    return BertEncoder(replace(BERT_CONFIGS["base"], dtype=dtype), device=device)


def bert_tiny(dtype=torch.float32, device=None) -> "BertEncoder":
    return BertEncoder(replace(BERT_CONFIGS["tiny"], dtype=dtype), device=device)


def bert_long(dtype=torch.float32, device=None) -> "BertEncoder":
    return BertEncoder(replace(BERT_CONFIGS["long"], dtype=dtype), device=device)


def dense_attention(q, k, v, mask, dtype):
    """Standard softmax attention. q, k, v: [B, H, L, Dh]; mask: additive
    [B, 1, 1, L]. Scores and softmax in f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.matmul(probs, v)


class LayerNorm(nn.LayerNorm):
    """LayerNorm in f32 whatever the dtype of its input and parameters
    (f32, or bf16 on the serving rung): the output is f32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.eps,
        )


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        self.word_embeddings = nn.Embedding(
            c.vocab_size, c.hidden_size, device=device
        )
        self.position_embeddings = nn.Embedding(
            c.max_position_embeddings, c.hidden_size, device=device
        )
        self.token_type_embeddings = nn.Embedding(
            c.type_vocab_size, c.hidden_size, device=device
        )
        self.layer_norm = LayerNorm(
            c.hidden_size, eps=c.layer_norm_eps, device=device
        )

    def forward(self, input_ids, token_type_ids=None):
        pos_ids = torch.arange(input_ids.shape[1], device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        e = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(pos_ids)[None]
            + self.token_type_embeddings(token_type_ids)
        )
        return self.layer_norm(e).to(self.config.dtype)


class BertSelfAttention(nn.Module):
    def __init__(
        self,
        config: BertConfig,
        attention_fn: Optional[Callable] = None,
        device=None,
    ):
        super().__init__()
        c = config
        self.config = c
        self.attention_fn = attention_fn or dense_attention
        d = c.hidden_size
        self.query = nn.Linear(d, d, device=device)
        self.key = nn.Linear(d, d, device=device)
        self.value = nn.Linear(d, d, device=device)
        self.output = nn.Linear(d, d, device=device)

    def forward(self, x, mask):
        c = self.config
        B, L, _ = x.shape
        h, dh = c.num_heads, c.hidden_size // c.num_heads

        def split(t):  # [B, L, D] -> [B, H, L, Dh]
            return t.view(B, L, h, dh).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        out = self.attention_fn(q, k, v, mask, c.dtype)
        out = out.transpose(1, 2).reshape(B, L, c.hidden_size)
        return self.output(out)


class BertLayer(nn.Module):
    def __init__(
        self,
        config: BertConfig,
        attention_fn: Optional[Callable] = None,
        device=None,
    ):
        super().__init__()
        c = config
        self.config = c
        self.attention = BertSelfAttention(c, attention_fn, device=device)
        self.attention_norm = LayerNorm(
            c.hidden_size, eps=c.layer_norm_eps, device=device
        )
        self.intermediate = nn.Linear(
            c.hidden_size, c.intermediate_size, device=device
        )
        self.mlp_output = nn.Linear(
            c.intermediate_size, c.hidden_size, device=device
        )
        self.output_norm = LayerNorm(
            c.hidden_size, eps=c.layer_norm_eps, device=device
        )

    def forward(self, x, mask):
        dtype = self.config.dtype
        attn_out = self.attention(x, mask)
        x = self.attention_norm((x + attn_out).float()).to(dtype)
        mlp = F.gelu(self.intermediate(x), approximate="none")
        mlp = self.mlp_output(mlp)
        return self.output_norm((x + mlp).float()).to(dtype)


class BertEncoder(nn.Module):
    """Returns the last hidden state [B, L, D] in f32; ``pooled=True`` (or
    :meth:`embed`) gives masked mean-pooled embeddings [B, D]."""

    def __init__(
        self,
        config: BertConfig,
        attention_fn: Optional[Callable] = None,
        device=None,
    ):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config, device=device)
        self.layers = nn.ModuleList(
            BertLayer(config, attention_fn, device=device)
            for _ in range(config.num_layers)
        )

    def cast_projections(self) -> "BertEncoder":
        """Store the Linear layers in the compute dtype (embeddings and
        LayerNorms stay f32)."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.to(self.config.dtype)
        return self

    def forward(
        self,
        input_ids,
        attention_mask=None,
        token_type_ids=None,
        pooled: bool = False,
    ):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        additive = 1.0 - attention_mask[:, None, None, :].float()
        additive = additive * torch.finfo(torch.float32).min
        x = self.embeddings(input_ids, token_type_ids)
        for layer in self.layers:
            x = layer(x, additive)
        x = x.float()
        if pooled:
            m = attention_mask[..., None].float()
            return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        return x

    def embed(self, input_ids, attention_mask=None, token_type_ids=None):
        return self(input_ids, attention_mask, token_type_ids, pooled=True)


def init_bert_params(module: BertEncoder, generator: torch.Generator) -> None:
    """Seeded random init in place: weights of every Embedding and Linear
    from N(0, 0.02²), biases 0, LayerNorm scale 1 and bias 0."""
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (nn.Embedding, nn.Linear)):
                mod.weight.normal_(0.0, 0.02, generator=generator)
            if isinstance(mod, nn.Linear):
                mod.bias.zero_()
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()


def load_hf_bert_params(hf_params: dict, config: BertConfig) -> dict:
    """A Hugging Face ``FlaxBertModel`` params tree (numpy arrays, or
    anything ``np.asarray`` takes) -> the flax ``{"params": ...}`` tree of
    the JAX package's ``BertEncoder``, which
    ``models/convert.bert_params_from_flax`` carries into this module:
    the embeddings and ``config.num_layers`` encoder layers. The HF pooler
    head is not used: the pooled output here is the masked mean."""
    import numpy as np

    def t(x):
        return np.asarray(x)

    def dense(node):
        return {"kernel": t(node["kernel"]), "bias": t(node["bias"])}

    def norm(node):
        return {"scale": t(node["scale"]), "bias": t(node["bias"])}

    emb = hf_params["embeddings"]
    out = {
        "embeddings": {
            "word_embeddings": {"embedding": t(emb["word_embeddings"]["embedding"])},
            "position_embeddings": {"embedding": t(emb["position_embeddings"]["embedding"])},
            "token_type_embeddings": {"embedding": t(emb["token_type_embeddings"]["embedding"])},
            "layer_norm": norm(emb["LayerNorm"]),
        }
    }
    layers = hf_params["encoder"]["layer"]
    for i in range(config.num_layers):
        layer = layers[str(i)]
        att = layer["attention"]
        out[f"layer_{i}"] = {
            "attention": {
                "query": dense(att["self"]["query"]),
                "key": dense(att["self"]["key"]),
                "value": dense(att["self"]["value"]),
                "output": dense(att["output"]["dense"]),
            },
            "attention_norm": norm(att["output"]["LayerNorm"]),
            "intermediate": dense(layer["intermediate"]["dense"]),
            "mlp_output": dense(layer["output"]["dense"]),
            "output_norm": norm(layer["output"]["LayerNorm"]),
        }
    return {"params": out}
