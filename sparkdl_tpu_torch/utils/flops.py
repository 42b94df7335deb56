"""Analytic FLOPs and model-FLOPs utilization (MFU).

The port of the JAX package's ``utils/flops.py``. A throughput number
alone cannot tell a slow device program from a slow host, so the serving
path's utilization ledger (``obs/utilization.py``) turns the analytic
FLOPs of the rows it served into a live ``serve.mfu`` gauge.

- Text: :func:`bert_flops_per_example`, the JAX package's formula.
- Images: the registry counts ``2 x bench_bounds.model_macs`` on the
  module itself (``models/registry.NamedImageModel.flops_per_item``), so
  the port keeps one source of MACs; the JAX package's table of published
  GMACs is not copied.
- Peaks: an H100 is the only device with a number, its dense bf16 rate
  from ``bench_bounds.PEAK_FLOP_PER_S``; any other device, the CPU among
  them, has none, and callers then report no MFU rather than a made-up one.
"""

from __future__ import annotations

from typing import Optional


def bert_flops_per_example(
    seq_len: int,
    hidden: int = 768,
    num_layers: int = 12,
    intermediate: int = 3072,
) -> float:
    """Forward FLOPs for one sequence through a BERT encoder.

    Per layer (MACs): the QKV and output projections ``4*T*d^2``, the
    scores and the mix ``2*T^2*d``, the FFN ``2*T*d*f``; embeddings and the
    pooling are left out (<1%). FLOPs = 2 x MACs."""
    t, d, f = seq_len, hidden, intermediate
    macs_per_layer = 4 * t * d * d + 2 * t * t * d + 2 * t * d * f
    return 2.0 * num_layers * macs_per_layer


def bert_size_flops_per_example(size: str, seq_len: int) -> float:
    """FLOPs by the bench's size ladder: ``tiny`` is bert-tiny's geometry,
    anything else bert-base's."""
    if size == "tiny":
        return bert_flops_per_example(seq_len, hidden=128, num_layers=4, intermediate=256)
    return bert_flops_per_example(seq_len)


def local_device_kind() -> Optional[str]:
    """``torch.cuda.get_device_name()``, or None without a CUDA device."""
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name()


def device_peak_flops(device_kind: str) -> Optional[float]:
    """Dense bf16 peak FLOP/s of one device, or None when unknown: an H100
    has one (``bench_bounds.PEAK_FLOP_PER_S["bf16"]``), every other name,
    the CPU's among them, has none."""
    if "H100" not in (device_kind or ""):
        return None
    from sparkdl_tpu_torch.bench_bounds import PEAK_FLOP_PER_S

    return PEAK_FLOP_PER_S["bf16"]


def mfu(
    flops_per_item: float,
    items_per_sec: float,
    device_kind: str,
    devices: int = 1,
) -> Optional[float]:
    """Model-FLOPs utilization in [0, 1], ``flops_per_item *
    items_per_sec / (peak * devices)`` over an achieved rate on
    ``devices`` devices; None when the peak is unknown."""
    peak = device_peak_flops(device_kind)
    if not peak or not items_per_sec:
        return None
    return flops_per_item * items_per_sec / (peak * max(1, devices))


__all__ = [
    "bert_flops_per_example",
    "bert_size_flops_per_example",
    "device_peak_flops",
    "local_device_kind",
    "mfu",
]
