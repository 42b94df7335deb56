"""The CUDA flash-attention kernel against its plain PyTorch version, on
the card. Marked ``cuda``; each test skips (inside the ``cuda_device``
fixture) where no CUDA device is present. Run on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q``
(``--noconftest``: the tests' conftest imports jax, which a GPU machine
with only PyTorch lacks).

Tolerances: f32 atol 1e-4 (the kernel sums in another order), bf16 atol
3e-2 (one bf16 rounding of the output). TF32 is off for the f32 matmuls
of the plain version."""

import numpy as np
import pytest
import torch

from sparkdl_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)

pytestmark = pytest.mark.cuda

MASK_MIN = float(np.finfo(np.float32).min)


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
