"""The least time an H100 could take for a kernel's work, and the work of
a model's products: the yardsticks ``chip_smoke.py`` holds measured times
against. The serving path reads two of them: the registry's image FLOPs
(``model_macs``) and the bf16 peak behind ``serve.mfu``
(``utils/flops.py``)."""

from __future__ import annotations

import copy

import torch
from torch import nn

#: H100 SXM data sheet, dense rates, at the full 700 W power limit; "f32"
#: is float32 on the CUDA cores, outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"bf16": 989e12, "tf32": 494.7e12, "f32": 67e12}


def model_macs(module: nn.Module, input_shape, **forward_kwargs) -> int:
    """Multiply-accumulates of one forward of ``module`` over one input of
    ``input_shape`` (without the batch axis), summed over its ``Conv2d``
    and ``Linear`` layers; normalization, activations and pooling are not
    counted. The forward runs on a meta-device copy, so no arithmetic is
    done."""
    meta = copy.deepcopy(module).to("meta")
    total = 0

    def count(layer, _inputs, out):
        nonlocal total
        if isinstance(layer, nn.Conv2d):
            kh, kw = layer.kernel_size
            total += out[0].numel() * (layer.in_channels // layer.groups) * kh * kw
        else:
            total += out[0].numel() * layer.in_features

    hooks = [
        m.register_forward_hook(count)
        for m in meta.modules()
        if isinstance(m, (nn.Conv2d, nn.Linear))
    ]
    try:
        with torch.no_grad():
            meta(torch.empty(1, *input_shape, device="meta"), **forward_kwargs)
    finally:
        for h in hooks:
            h.remove()
    return total


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
