"""The least time an H100 could take for a kernel's work: the yardstick
``chip_smoke.py`` holds each measured kernel time against. Nothing on
the port's path imports this module."""

from __future__ import annotations

import torch

#: H100 SXM data sheet, dense rates, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"bf16": 989e12, "tf32": 494.7e12}


def flash_attention_bound_ms(B: int, H: int, L: int, Dh: int, dtype, masked: bool):
    """The least time for one flash-attention call on the route its kernel
    takes: ``(ms, "bytes" | "operations")``.

    Bytes: q, k, v read and o written once, plus the f32 key mask. Work:
    the two products, 4·B·H·L²·Dh; bf16 runs them once at the bf16
    tensor-core rate, f32 runs them as 3xTF32, three TF32 products each.
    """
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * B * H * L * Dh * elem + (4 * B * L if masked else 0)
    flops = 4 * B * H * L * L * Dh
    if dtype == torch.float32:
        t_ops = 3 * flops / PEAK_FLOP_PER_S["tf32"]
    elif dtype == torch.bfloat16:
        t_ops = flops / PEAK_FLOP_PER_S["bf16"]
    else:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {dtype}")
    t_bytes = nbytes / HBM_BYTES_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"
