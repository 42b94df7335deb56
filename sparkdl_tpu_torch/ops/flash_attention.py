"""Flash attention: the CUDA kernel for the text path, and its plain version.

Port of the JAX package's Pallas TPU kernel (``ops/flash_attention.py``).
:func:`flash_attention` computes ``softmax(q·kᵀ/√Dh + mask)·v`` with an
online softmax, forward only:

- on CUDA tensors it launches the hand-written Hopper kernel in
  ``csrc/flash_attention.cu`` (bf16: wgmma fed by TMA; f32: 3xTF32 on
  mma.sync; built with ``nvcc`` at first use) and counts the launch in
  ``flash_attention.launches`` and in the metrics registry
  (``kernel.flash_attention.launches.<dtype>``);
- on CPU tensors it runs :func:`flash_attention_reference`, the same
  online-softmax arithmetic written in PyTorch one key tile at a time.

There is no fallback between the two: a CUDA tensor either goes through
the kernel or raises.

Both run behind one registered torch operator,
``torch.ops.sparkdl_tpu_torch.flash_attention`` (defined with
``torch.library.Library(..., "DEF")`` when this module is imported, with a
CPU and a CUDA implementation, each checking its inputs;
``torch.library.custom_op`` cost about three times as much per call),
whose fake implementation gives the output's shape and dtype. Its
autograd formula is the plain version's gradient on CPU tensors and
raises on CUDA tensors (the kernel is forward-only), so a CPU trainer
never loses the attention's gradient. So ``torch.export`` traces a model through
the kernel, the exported graph holds one ``sparkdl_tpu_torch::flash_attention``
node per attention, and a loaded program launches (and counts) the same
kernel; ``graph/function.ModelFunction.load`` imports this module first.

Semantics kept from the TPU kernel: scale ``1/sqrt(Dh)`` of the true Dh;
the running max starts at ``NEG_INF = -1e30``, so a row whose keys are
all masked with ``finfo(float32).min`` comes out as 0 (dense softmax
would give the mean of V); f32 scores and accumulator; output in q's
dtype.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from sparkdl_tpu_torch.utils.metrics import metrics

NEG_INF = -1e30  # finite -inf stand-in: keeps exp()/max() NaN-free

#: Key tile of the plain version. The kernels walk K/V tiles of 64 keys
#: too (``kBlockK`` in ``csrc/flash_attention.cu``), so the running max,
#: and with it P before the bf16 kernel rounds it, is taken over the same
#: keys on both sides; the sums run in another order.
BLOCK_K = 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the registry counter of each dtype's kernel launches
LAUNCH_COUNTERS = {
    torch.float32: "kernel.flash_attention.launches.float32",
    torch.bfloat16: "kernel.flash_attention.launches.bfloat16",
}
_HEAD_DIMS = (32, 64)

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: guards the launch counts: serving launches from several feeder threads
_count_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from sparkdl_tpu_torch.runtime.cuda_build import build_library

            lib = ctypes.CDLL(build_library("flash_attention"))
            fn = lib.sdl_flash_attention_forward
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
                ctypes.c_float,
                ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _key_mask(mask: Optional[torch.Tensor], B: int, L: int):
    """The additive key mask as a contiguous f32 [B, L], or None."""
    if mask is None:
        return None
    if tuple(mask.shape) not in ((B, L), (B, 1, 1, L)):
        raise ValueError(
            f"mask must be [B, L] or [B, 1, 1, L] = {(B, L)}, got "
            f"{tuple(mask.shape)}"
        )
    if mask.dtype != torch.float32:
        raise TypeError(f"mask must be float32, got {mask.dtype}")
    return mask.reshape(B, L).contiguous()


def _check(q, k, v, mask) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, L, Dh], got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "q, k, v must share one [B, H, L, Dh] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q, k, v must all be float32 or bfloat16, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(
            f"head dim {q.shape[-1]} is not supported; the kernel takes "
            f"Dh in {_HEAD_DIMS}"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    devices = {q.device, k.device, v.device}
    if mask is not None:
        devices.add(mask.device)
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    p_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same online softmax, one
    key tile of ``BLOCK_K`` at a time, in f32. Returns [B, H, L, Dh] in
    q's dtype.

    ``p_dtype=torch.bfloat16`` rounds P to bf16 before P·V (l still sums
    the unrounded P), which is what the bf16 kernel does; None keeps P in
    f32, as the TPU kernel and the CPU path do."""
    B, H, L, Dh = q.shape
    scale = 1.0 / math.sqrt(Dh)
    key_mask = _key_mask(mask, B, L)
    qf = q.float()
    m = torch.full((B, H, L, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, L, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, L, Dh), dtype=torch.float32, device=q.device)
    for k0 in range(0, L, BLOCK_K):
        kt = k[:, :, k0 : k0 + BLOCK_K].float()
        vt = v[:, :, k0 : k0 + BLOCK_K].float()
        s = torch.matmul(qf, kt.transpose(-1, -2)) * scale
        if key_mask is not None:
            s = s + key_mask[:, None, None, k0 : k0 + BLOCK_K]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if p_dtype is not None:
            p = p.to(p_dtype).float()
        acc = acc * alpha + torch.matmul(p, vt)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Blockwise online-softmax attention, through the registered operator.

    Args:
        q, k, v: contiguous [B, H, L, Dh], float32 or bfloat16, Dh 32 or 64.
        mask: additive f32 key mask, [B, L] or [B, 1, 1, L] (0 keeps a key,
            a large negative value drops it), or None.

    Returns [B, H, L, Dh] in q's dtype. CUDA tensors run the kernel; CPU
    tensors run :func:`flash_attention_reference`; anything else raises.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return flash_attention_op(q, k, v, mask)


def _plain(q, k, v, mask) -> torch.Tensor:
    """The operator's CPU implementation: the plain version, checked."""
    _check(q, k, v, mask)
    return flash_attention_reference(q, k, v, mask)


def _launch(q, k, v, mask) -> torch.Tensor:
    """The operator's CUDA implementation: one launch of the kernel,
    checked and counted."""
    _check(q, k, v, mask)
    B, H, L, Dh = q.shape
    key_mask = _key_mask(mask, B, L)
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("q, k, v must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.sdl_flash_attention_forward(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            None if key_mask is None else key_mask.data_ptr(),
            out.data_ptr(),
            B,
            H,
            L,
            Dh,
            _DTYPES[q.dtype],
            1.0 / math.sqrt(Dh),
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash attention kernel launch failed: cudaError {err} "
            f"(B={B}, H={H}, L={L}, Dh={Dh}, dtype={q.dtype})"
        )
    with _count_lock:
        flash_attention.launches += 1  # the public function holds the counts
        flash_attention.launches_by_dtype[q.dtype] += 1
    # the same count in the metrics registry, so a serving worker's
    # /metrics (and a gateway's federated /metrics) shows it per dtype
    metrics.inc(LAUNCH_COUNTERS[q.dtype])
    return out


#: Kernel launches since the count was last set to 0 (CPU calls and
#: failed launches are not counted), in all and by dtype (the bf16 and the
#: f32 kernel).
flash_attention.launches = 0
flash_attention.launches_by_dtype = dict.fromkeys(_DTYPES, 0)


def _save_inputs(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs)


def _backward(ctx, grad):
    """The plain version's gradient, recomputed under autograd. The kernel
    has no backward (the JAX kernel has no ``custom_vjp``), so a CUDA
    tensor raises rather than losing its gradient."""
    if grad.device.type != "cpu":
        raise RuntimeError(
            "the flash-attention kernel has no backward: train the "
            "dense-attention build (models.registry._bert_text_builder(size, "
            "attention='dense'))"
        )
    needs = ctx.needs_input_grad
    with torch.enable_grad():
        inputs = [
            None if t is None else t.detach().requires_grad_(need)
            for t, need in zip(ctx.saved_tensors, needs)
        ]
        out = flash_attention_reference(*inputs)
        wanted = [t for t, need in zip(inputs, needs) if need]
        grads = iter(torch.autograd.grad(out, wanted, grad))
    return tuple(next(grads) if need else None for need in needs)


# The operator behind flash_attention: the kernel on CUDA, the plain
# version on the CPU, each checking its inputs (a loaded program calls the
# operator directly); the plain version's gradient under autograd.
_LIB = torch.library.Library("sparkdl_tpu_torch", "DEF")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, Tensor? mask) -> Tensor")
_LIB.impl("flash_attention", _plain, "CPU")
_LIB.impl("flash_attention", _launch, "CUDA")
torch.library.register_fake("sparkdl_tpu_torch::flash_attention", lib=_LIB)(
    lambda q, k, v, mask: torch.empty_like(q)
)
torch.library.register_autograd(
    "sparkdl_tpu_torch::flash_attention", _backward, setup_context=_save_inputs, lib=_LIB
)
flash_attention_op = torch.ops.sparkdl_tpu_torch.flash_attention.default


def make_flash_attention_fn():
    """An attention fn with the ``dense_attention(q, k, v, mask, dtype)``
    signature, for ``BertEncoder(attention_fn=...)``. It calls the
    registered operator, eager and under ``torch.export`` alike, which
    follows the tensors' device: the kernel for CUDA tensors, the plain
    version for CPU tensors. The kernel has no backward, as the JAX kernel
    has none: ``attention.flash`` tells a trainer so, and a backward
    through a CUDA tensor raises. On the CPU the gradient is the plain
    version's."""

    def attention(q, k, v, mask, dtype):
        out = flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), mask
        )
        return out.to(dtype)

    attention.flash = True
    return attention
