"""The CUDA flash-attention kernel against its plain PyTorch version, on
the card. Marked ``cuda``; each test skips (inside the ``cuda_device``
fixture) where no CUDA device is present. Run on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q``
(``--noconftest``: the tests' conftest imports jax, which a GPU machine
with only PyTorch lacks).

Tolerances: f32 atol 1e-4 (the kernel sums in another order; its 3xTF32
products keep f32 accuracy), bf16 atol 3e-2 (the kernel rounds P to bf16
before P·V and rounds the output once; the plain version keeps P in f32).
At the tile edges the bf16 kernel is also held to the plain version with
P rounded to bf16 (``p_dtype``) at rtol 1e-2, atol 4e-3. TF32 is off for
the f32 matmuls of the plain version.

``compute-sanitizer`` refuses the card's machine ("Device not
supported"), so ``test_kernel_stays_inside_its_tensors`` checks the
kernels' memory bounds with guard bands instead."""

import math

import numpy as np
import pytest
import torch

from sparkdl_tpu_torch.ops.flash_attention import (
    _library,
    flash_attention,
    flash_attention_reference,
)

pytestmark = pytest.mark.cuda

MASK_MIN = float(np.finfo(np.float32).min)
#: the bf16 kernel against the plain version with P rounded to bf16: the
#: output's own rounding (rtol) and P elements rounded the other way (atol)
BF16_EMULATION_TOL = {"rtol": 1e-2, "atol": 4e-3}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _inputs(device, B, H, L, Dh, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (
        torch.from_numpy(rng.normal(size=(B, H, L, Dh)).astype(np.float32))
        .to(device, dtype)
        for _ in range(3)
    )
    lengths = rng.integers(1, L + 1, size=B)
    lengths[0] = 0  # one row whose keys are all masked
    mask = torch.zeros(B, L)
    for b, n in enumerate(lengths):
        mask[b, n:] = MASK_MIN
    return q, k, v, mask.to(device)


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("L", [64, 200])
def test_kernel_matches_plain_version(cuda_device, dh, dtype, atol, L):
    q, k, v, mask = _inputs(cuda_device, 3, 4, L, dh, dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = flash_attention_reference(q, k, v, mask)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    assert not out[0].any()  # all keys masked -> 0


def test_kernel_without_mask(cuda_device):
    q, k, v, _ = _inputs(cuda_device, 2, 2, 130, 64, torch.float32, seed=1)
    out = flash_attention(q, k, v)
    ref = flash_attention_reference(q, k, v)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask_b11l"])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("L", [1, 63, 64, 65, 127, 128, 129, 513, 2048])
def test_kernel_at_tile_edges(cuda_device, L, dtype, atol, dh, masked):
    """Lengths around the kernels' 64-row query and 64-key tiles, and B*H
    = 15, which fills no power-of-two grid; rows past L must stay
    unwritten, keys past L must weigh nothing."""
    B, H = 3, 5
    q, k, v, mask = _inputs(cuda_device, B, H, L, dh, dtype, seed=L)
    mask = mask[:, None, None, :] if masked else None
    out = flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    ref = flash_attention_reference(q, k, v, mask)
    assert out.dtype == dtype and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    if dtype == torch.bfloat16:
        # closer: against the plain version that rounds P as the kernel does
        emu = flash_attention_reference(q, k, v, mask, p_dtype=torch.bfloat16)
        torch.testing.assert_close(out.float(), emu.float(), **BF16_EMULATION_TOL)
    if masked:
        assert not out[0].any()  # all keys masked -> 0


GUARD = 256  # elements each side of a tensor: keeps 16-byte alignment
SENTINEL = 7.0


def _guarded(t, fill):
    """A contiguous copy of t between two bands of ``fill``; returns the
    whole buffer and the copy."""
    n = t.numel()
    buf = torch.full((n + 2 * GUARD,), fill, dtype=t.dtype, device=t.device)
    view = buf[GUARD : GUARD + n].view(t.shape)
    view.copy_(t)
    return buf, view


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask_bl"])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 65, 129, 513])
def test_kernel_stays_inside_its_tensors(cuda_device, L, dtype, dh, masked):
    """A bounds check that needs no sanitizer: q, k, v and the mask sit
    between bands of NaN, which a read outside them would carry into the
    output; out sits between bands of a sentinel, which a write outside it
    would overwrite. Three calls agree bit for bit (no race shows)."""
    B, H = 3, 5
    q, k, v, mask = _inputs(cuda_device, B, H, L, dh, dtype, seed=L + 1)
    (_, qg), (_, kg), (_, vg) = (_guarded(t, float("nan")) for t in (q, k, v))
    mg = _guarded(mask, float("nan"))[1] if masked else None
    out_buf = torch.full((q.numel() + 2 * GUARD,), SENTINEL, dtype=dtype, device=q.device)
    out = out_buf[GUARD : GUARD + q.numel()].view(q.shape)
    fn = _library().sdl_flash_attention_forward
    results = []
    for _ in range(3):
        out.fill_(SENTINEL)
        err = fn(
            qg.data_ptr(), kg.data_ptr(), vg.data_ptr(),
            None if mg is None else mg.data_ptr(), out.data_ptr(),
            B, H, L, dh, 0 if dtype == torch.float32 else 1, 1.0 / math.sqrt(dh),
            torch.cuda.current_stream().cuda_stream,
        )
        torch.cuda.synchronize()
        assert err == 0
        assert (out_buf[:GUARD] == SENTINEL).all() and (out_buf[-GUARD:] == SENTINEL).all()
        results.append(out.clone())
    ref = flash_attention_reference(q, k, v, mask if masked else None)
    atol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(results[0].float(), ref.float(), atol=atol, rtol=0)
    assert all(torch.equal(results[0], r) for r in results[1:])
