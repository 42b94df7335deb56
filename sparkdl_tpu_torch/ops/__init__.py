"""Hand-written kernels and their plain PyTorch versions, and the
sequence-parallel attentions over a mesh axis (ring and Ulysses)."""

from sparkdl_tpu_torch.ops.ring_attention import make_ring_attention, ring_attention_sharded
from sparkdl_tpu_torch.ops.ulysses import make_ulysses_attention, ulysses_attention_sharded

__all__ = [
    "make_ring_attention",
    "make_ulysses_attention",
    "ring_attention_sharded",
    "ulysses_attention_sharded",
]
