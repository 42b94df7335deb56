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
:func:`bert_model_function_sequence_parallel` shards the sequence over a
mesh axis, with ring or Ulysses attention (``ops/ring_attention.py``,
``ops/ulysses.py``), for sequences past one device.

:class:`BertGenerator` runs prefill and cached single-token decode over an
encoder's modules (the serving generate path), as the JAX package's
``BertGenerator`` does over the flax param tree.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.runtime.device import exact_float32


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

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        """``position_ids`` (broadcastable to ``input_ids``) defaults to
        ``arange(L)``; decode passes each slot's own position."""
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        e = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(position_ids)
            + self.token_type_embeddings(token_type_ids)
        )
        return self.layer_norm(e).to(self.config.dtype)


def _split_heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """[B, L, D] -> [B, H, L, Dh]."""
    B, L, D = t.shape
    return t.view(B, L, h, D // h).transpose(1, 2)


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
        q, k, v = (_split_heads(proj(x), c.num_heads)
                   for proj in (self.query, self.key, self.value))
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
        return self.tail(x, self.attention(x, mask))

    def tail(self, x, attn_out):
        """The post-attention half: residual, LayerNorm, MLP, LayerNorm."""
        dtype = self.config.dtype
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
        position_ids=None,
    ):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        additive = 1.0 - attention_mask[:, None, None, :].float()
        additive = additive * torch.finfo(torch.float32).min
        x = self.embeddings(input_ids, token_type_ids, position_ids)
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


def bert_model_function_sequence_parallel(
    size: str = "base",
    mesh=None,
    axis: str = "sp",
    strategy: str = "ring",
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
    params=None,
    max_length: int = 128,
    device=None,
    inner: Optional[Callable] = None,
):
    """Sequence-parallel BERT embedder: the ``(ids, mask) -> [B, D]``
    pooled-embedding contract of the registry's text models, with the
    sequence sharded over the mesh ``axis`` (``parallel/mesh.py``; default:
    every process on ``axis``), the long-context path wherever a
    ModelFunction goes (TextEmbedder, the UDF registry).

    ``strategy``: 'ring' (K/V blocks passed around the axis; any head
    count) or 'ulysses' (all-to-all head swap; heads % axis size == 0;
    ``inner`` is its attention over the head-sharded layout, dense by
    default as in the JAX package, ``make_flash_attention_fn()`` for the
    flash kernel). Each process embeds its ``max_length / n`` tokens at
    position offset ``rank * max_length / n`` and the masked mean pools
    with two all-reduce sums over the axis, so every process returns the
    same rows. Differentiable with the dense inner: the parameters enter
    each process's shard through ``parallel/collectives.copy_to_axis``, so
    ``backward()`` of a loss over the rows leaves every process with the
    dense build's parameter gradients. Weights are the registry's:
    ``params`` (the JAX package's flax tree) or drawn from ``seed``, as
    ``get_model(...).model_function`` draws them; the attention holds none. ``device``: ``cuda`` by default
    (raises when there is none); pass ``"cpu"`` for the CPU.

    The function carries ``single_stream = True``: a batch runs on the
    whole axis at exactly ``max_length``, so it is neither bucketed by
    length nor spread over devices (``transformers/execution.py``), and
    its ``TextEmbedder``, ``ModelTransformer`` or catalog-UDF column runs
    the frame's partitions one at a time in index order
    (``DataFrame.withColumnPartition(..., serial=True)``), so that each
    rank's k-th batch meets every other rank's k-th batch."""
    from torch.func import functional_call

    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.models.registry import _bert_encoder
    from sparkdl_tpu_torch.parallel.collectives import all_reduce_sum, copy_to_axis
    from sparkdl_tpu_torch.parallel.mesh import make_mesh
    from sparkdl_tpu_torch.runtime.device import resolve_device

    device = resolve_device(device)
    if mesh is None:
        mesh = make_mesh({axis: -1})
    n = mesh.axis_size(axis)
    if max_length % n:
        raise ValueError(f"max_length {max_length} must be divisible by the {axis!r} axis size ({n})")
    if strategy == "ring":
        if inner is not None:
            raise ValueError("inner is the Ulysses strategy's attention; ring attention takes none")
        from sparkdl_tpu_torch.ops.ring_attention import make_ring_attention

        attention_fn = make_ring_attention(axis, mesh)
    elif strategy == "ulysses":
        from sparkdl_tpu_torch.ops.ulysses import make_ulysses_attention

        attention_fn = make_ulysses_attention(axis, inner=inner, mesh=mesh)
    else:
        raise ValueError(f"Unknown strategy {strategy!r}; expected 'ring' or 'ulysses'")
    if size not in ("base", "tiny"):
        raise ValueError(f"Unknown BERT size {size!r}; supported: base, tiny")
    config = replace(BERT_CONFIGS[size], dtype=dtype)
    if max_length > config.max_position_embeddings:
        raise ValueError(
            f"max_length {max_length} exceeds the model's learned position table "
            f"({config.max_position_embeddings}); sequence parallelism shards compute, "
            "not the position vocabulary"
        )
    if strategy == "ulysses" and config.num_heads % n:
        raise ValueError(
            f"ulysses needs heads ({config.num_heads}) divisible by the {axis!r} axis ({n}); "
            "use strategy='ring'"
        )
    module = _bert_encoder(config, attention_fn, seed, params, device)
    lc = max_length // n
    offset = mesh.axis_index(axis) * lc

    def fn(mod, x):
        ids, mask = x if isinstance(x, (tuple, list)) else (x, None)
        if mask is None:
            mask = torch.ones_like(ids)
        if ids.shape[1] != max_length:
            raise ValueError(
                f"sequence length {ids.shape[1]} != max_length {max_length} "
                "the mesh sharding was built for"
            )
        ids_sh = ids[:, offset : offset + lc]
        mask_sh = mask[:, offset : offset + lc]
        shard = (ids_sh, mask_sh)
        kwargs = {"position_ids": torch.arange(offset, offset + lc, device=ids.device)[None]}
        if n > 1 and torch.is_grad_enabled():
            # each process's parameter gradient covers its shard: sum them
            names, tensors = zip(*mod.named_parameters())
            h = functional_call(mod, dict(zip(names, copy_to_axis(tensors, mesh, axis))), shard, kwargs)
        else:
            h = mod(*shard, **kwargs)
        m = mask_sh[..., None].float()
        total = all_reduce_sum((h * m).sum(dim=1), mesh, axis)
        count = all_reduce_sum(m.sum(dim=1), mesh, axis)
        return total / torch.clamp(count, min=1.0)

    mf = ModelFunction(
        fn, module, device, name=f"bert_{size}[embed,{strategy}/{axis}x{n}]",
        vocab_size=config.vocab_size, single_stream=True,
    )
    return mf


# -- autoregressive generation ------------------------------------------------
#
# The serving generate path (serving/generation.py) needs each layer's K/V
# as explicit cache state: a prefill that runs the prompt once under a
# causal mask and returns the keys/values every later step attends, and a
# single-token decode that advances many sequences one position each call
# against a fixed [slots, max_length] cache. The generator runs over the
# modules and weights of a BertEncoder, so one registry entry serves
# embed and generate off one set of weights, as in the JAX package.


def _causal_forward(encoder: BertEncoder, ids: torch.Tensor):
    """Causal full-sequence forward: hidden [B, L, D] plus the per-layer
    keys/values [n_layers, B, H, L, Dh] the decode cache is seeded from.
    Pad positions after a row's real length compute garbage, which no later
    read sees: every key past a row's position is masked."""
    c = encoder.config
    B, L = ids.shape
    x = encoder.embeddings(ids)
    causal = torch.tril(torch.ones(L, L, device=ids.device))
    additive = (1.0 - causal)[None, None] * torch.finfo(torch.float32).min
    ks, vs = [], []
    for layer in encoder.layers:
        att = layer.attention
        q = _split_heads(att.query(x), c.num_heads)
        k = _split_heads(att.key(x), c.num_heads)
        v = _split_heads(att.value(x), c.num_heads)
        ks.append(k)
        vs.append(v)
        out = dense_attention(q, k, v, additive, torch.float32)
        out = out.transpose(1, 2).reshape(B, L, c.hidden_size)
        x = layer.tail(x, att.output(out))
    return x, torch.stack(ks), torch.stack(vs)


class BertGenerator:
    """Prefill + single-token decode over a float32 :class:`BertEncoder`.

    - :meth:`prefill` runs one prompt [1, Lb] (bucketed by the caller)
      under a causal mask and returns the per-layer K/V block and the
      next-token logits at the prompt's last real position;
    - :meth:`decode_step` advances every slot one token: it writes each
      row's new K/V at its own position (positions differ per row: that
      is continuous batching) and attends keys <= that position.

    Logits come from the tied word embeddings (``x @ E.T``). The cache is
    float32 ``[n_layers, slots, H, max_length, Dh]``;
    :attr:`kv_bytes_per_token` is the per-token charge of the admission
    budget. Every call runs under ``exact_float32`` (no TF32) and
    ``no_grad``, on the caller's current stream."""

    def __init__(self, encoder: BertEncoder, max_length: int):
        c = encoder.config
        if c.dtype != torch.float32:
            raise ValueError(f"BertGenerator runs float32 encoders; got {c.dtype}")
        self.max_length = int(max_length)
        if self.max_length > c.max_position_embeddings:
            raise ValueError(
                f"max_length {self.max_length} exceeds the model's learned "
                f"position table ({c.max_position_embeddings})"
            )
        self.config = c
        self.encoder = encoder.eval()
        self.vocab_size = int(c.vocab_size)
        self.device = encoder.embeddings.word_embeddings.weight.device

    @property
    def kv_bytes_per_token(self) -> int:
        """2 (K and V) x layers x hidden x 4 B (float32 cache)."""
        c = self.config
        return 2 * c.num_layers * c.hidden_size * 4

    @property
    def param_bytes(self) -> int:
        """Bytes of the encoder's parameters: the residency charge."""
        return sum(p.nbytes for p in self.encoder.parameters())

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.encoder.embeddings.word_embeddings.weight.T

    def new_cache(self, slots: int):
        """Zeroed (k_cache, v_cache) for ``slots`` decode slots."""
        c = self.config
        shape = (c.num_layers, int(slots), c.num_heads, self.max_length,
                 c.hidden_size // c.num_heads)
        return (torch.zeros(shape, device=self.device),
                torch.zeros(shape, device=self.device))

    def prefill(self, ids, length: int):
        """One prompt: ``ids`` [1, Lb] int (zero-padded past ``length``).
        Returns (k [n_layers, 1, H, Lb, Dh], v, logits [1, vocab])."""
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        with torch.no_grad(), exact_float32():
            x, k, v = _causal_forward(self.encoder, ids)
            return k, v, self._logits(x[:, int(length) - 1])

    def write_prefill(self, k_cache, v_cache, slot: int, k, v):
        """Install one prefilled sequence's K/V block into ``slot`` (in
        place). Positions past the block are never attended: the decode
        key mask stops at each row's own position."""
        width = k.shape[3]
        with torch.no_grad():
            k_cache[:, slot, :, :width] = k[:, 0]
            v_cache[:, slot, :, :width] = v[:, 0]
        return k_cache, v_cache

    def decode_step(self, k_cache, v_cache, tokens, positions):
        """One token for every slot: ``tokens``/``positions`` [slots] ints
        (a free slot passes token 0 at position 0; its write lands where
        the next prefill overwrites). Writes each slot's K/V at
        ``[layer, slot, :, position, :]`` in place; the JAX package blends
        a one-hot mask over the whole slab, which gives the same values on
        a slab of finite values. Returns (k_cache, v_cache, logits [slots,
        vocab])."""
        c = self.config
        h, dh = c.num_heads, c.hidden_size // c.num_heads
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        positions = torch.as_tensor(positions, dtype=torch.long, device=self.device)
        S = tokens.shape[0]
        rows = torch.arange(S, device=self.device)
        dead = positions[:, None] < torch.arange(self.max_length, device=self.device)
        additive = dead.float()[:, None, :] * torch.finfo(torch.float32).min  # [S, 1, M]
        scale = 1.0 / math.sqrt(dh)
        with torch.no_grad(), exact_float32():
            x = self.encoder.embeddings(tokens[:, None], position_ids=positions[:, None])[:, 0]
            for i, layer in enumerate(self.encoder.layers):
                att = layer.attention
                q = att.query(x).view(S, h, dh)
                kc, vc = k_cache[i], v_cache[i]  # [S, H, M, Dh] views
                kc[rows, :, positions] = att.key(x).view(S, h, dh)
                vc[rows, :, positions] = att.value(x).view(S, h, dh)
                scores = (kc @ q[..., None])[..., 0] * scale + additive  # [S, H, M]
                probs = torch.softmax(scores, dim=-1)
                out = (probs[:, :, None, :] @ vc)[:, :, 0].reshape(S, c.hidden_size)
                x = layer.tail(x, att.output(out))
            return k_cache, v_cache, self._logits(x)

    def oracle_logits(self, prompt_ids) -> torch.Tensor:
        """Cacheless next-token logits [vocab] after ``prompt_ids``: the
        full causal forward over the prompt, padded to a power-of-two width
        (capped at ``max_length``); zero pads past the prompt cannot reach
        its last position under the causal mask."""
        n = len(prompt_ids)
        width = 1
        while width < n:
            width *= 2
        width = min(max(width, n), self.max_length)
        ids = torch.zeros((1, width), dtype=torch.long)
        ids[0, :n] = torch.as_tensor(np.asarray(prompt_ids, np.int64))
        return self.prefill(ids, n)[2][0]

    def oracle_next_token(self, prompt_ids) -> int:
        """Greedy reference token: argmax of :meth:`oracle_logits`."""
        return int(torch.argmax(self.oracle_logits(prompt_ids)))

    def greedy_oracle(self, prompt_ids, max_new_tokens: int,
                      eos_id: Optional[int] = None) -> list:
        """Sequential greedy decode by full recompute (no cache): the
        oracle the continuous-batching engine is held to."""
        ids = [int(t) for t in prompt_ids]
        out = []
        for _ in range(int(max_new_tokens)):
            if len(ids) >= self.max_length:
                break
            tok = self.oracle_next_token(ids)
            out.append(tok)
            ids.append(tok)
            if eos_id is not None and tok == int(eos_id):
                break
        return out


def load_hf_bert_params(hf_params: dict, config: BertConfig) -> dict:
    """A Hugging Face ``FlaxBertModel`` params tree (numpy arrays, or
    anything ``np.asarray`` takes) -> the flax ``{"params": ...}`` tree of
    the JAX package's ``BertEncoder``, which
    ``models/convert.bert_params_from_flax`` carries into this module:
    the embeddings and ``config.num_layers`` encoder layers. The HF pooler
    head is not used: the pooled output here is the masked mean."""

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
