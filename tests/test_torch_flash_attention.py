"""The port's flash attention (plain PyTorch version on the CPU) against
the JAX package's Pallas kernel, run through the Pallas interpreter.

Same inputs from a numpy seed on both sides; f32 at atol 2e-5 (the two
sum in another order), bf16 I/O at atol 3e-2 (one bf16 rounding step)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.ops.flash_attention import flash_attention as jax_flash
from sparkdl_tpu_torch.bench_bounds import flash_attention_bound_ms
from sparkdl_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_reference,
    make_flash_attention_fn,
)

MASK_MIN = float(np.finfo(np.float32).min)  # BERT's additive mask value


def _qkv(seed, B, H, L, Dh):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, L, Dh)).astype(np.float32) for _ in range(3)]


def _key_mask(B, L, lengths):
    mask = np.zeros((B, L), np.float32)
    for b, n in enumerate(lengths):
        mask[b, n:] = MASK_MIN
    return mask


#: case -> (B, H, L, valid keys per batch row or None for no mask)
CASES = {
    "no_mask": (2, 2, 32, None),
    "padding_mask": (2, 2, 48, [31, 48]),
    "ragged_length": (2, 2, 40, [40, 27]),
    "fully_masked_row": (2, 2, 40, [0, 33]),
}


def _both(q, k, v, mask, dtype_j, dtype_t):
    ours = flash_attention(
        *(torch.from_numpy(t).to(dtype_t) for t in (q, k, v)),
        None if mask is None else torch.from_numpy(mask),
    )
    ref = jax_flash(
        *(jnp.asarray(t, dtype_j) for t in (q, k, v)),
        None if mask is None else jnp.asarray(mask),
        block_q=16,
        block_k=16,
        interpret=True,
    )
    return ours, np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_pallas_kernel(case, dh):
    B, H, L, lengths = CASES[case]
    q, k, v = _qkv(1, B, H, L, dh)
    mask = None if lengths is None else _key_mask(B, L, lengths)
    ours, ref = _both(q, k, v, mask, jnp.float32, torch.float32)
    assert ours.dtype == torch.float32 and ours.shape == (B, H, L, dh)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5, rtol=0)
    if case == "fully_masked_row":
        # the TPU kernel's semantics: all keys masked -> 0, not mean(V)
        assert not ours[0].any()
        assert not ref[0].any()


@pytest.mark.parametrize("dh", [32, 64])
def test_bfloat16_io_matches_pallas_kernel(dh):
    B, H, L = 2, 2, 40
    q, k, v = _qkv(2, B, H, L, dh)
    mask = _key_mask(B, L, [40, 21])
    ours, ref = _both(q, k, v, mask, jnp.bfloat16, torch.bfloat16)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=3e-2, rtol=0)


@pytest.mark.parametrize("dh", [32, 64])
def test_bf16_p_rounding_stays_within_tolerance_of_pallas_kernel(dh):
    """The bf16 kernel's one departure from the plain version, P in bf16
    for P·V, stays inside the bf16 tolerance (3e-2) against the Pallas
    kernel at the bf16 test shapes, and keeps the fully masked row at 0."""
    B, H, L = 2, 2, 40
    q, k, v = _qkv(2, B, H, L, dh)
    mask = _key_mask(B, L, [40, 21])
    _, ref = _both(q, k, v, mask, jnp.bfloat16, torch.bfloat16)
    qt, kt, vt = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    emu = flash_attention_reference(
        qt, kt, vt, torch.from_numpy(mask), p_dtype=torch.bfloat16
    )
    assert emu.dtype == torch.bfloat16
    np.testing.assert_allclose(emu.float().numpy(), ref, atol=3e-2, rtol=0)
    masked = torch.from_numpy(_key_mask(B, L, [0, 33]))
    emu_masked = flash_attention_reference(qt, kt, vt, masked, p_dtype=torch.bfloat16)
    assert not emu_masked[0].any()


@pytest.mark.parametrize("L", [40, 130])
def test_reference_rounds_p_only_when_asked(L):
    """p_dtype=None is the plain version unchanged; p_dtype=bf16 moves
    each output by at most P's rounding, 2^-9 relative per element, so by
    at most 2^-9 · max|v| after the division by l."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(6, 2, 2, L, 32))
    mask = torch.from_numpy(_key_mask(2, L, [L, L // 3]))
    plain = flash_attention_reference(q, k, v, mask)
    torch.testing.assert_close(
        flash_attention_reference(q, k, v, mask, p_dtype=None), plain, atol=0, rtol=0
    )
    rounded = flash_attention_reference(q, k, v, mask, p_dtype=torch.bfloat16)
    assert rounded.dtype == torch.float32
    diff = (rounded - plain).abs().max().item()
    assert 0 < diff <= 2.0**-9 * v.abs().max().item() + 1e-6


@pytest.mark.parametrize(
    "shape, dtype, ms, by",
    [
        # bert-base L=512: 100.7 MB over 3.35 TB/s beats 25.8 GFLOP at 989 TFLOP/s
        ((32, 12, 512, 64), torch.bfloat16, 0.0300683, "bytes"),
        # f32 runs as 3xTF32: 3 x 25.8 GFLOP at 494.7 TFLOP/s
        ((32, 12, 512, 64), torch.float32, 0.1562753, "operations"),
        # bert-long: 8.6 GFLOP at 989 TFLOP/s beats 8.4 MB
        ((4, 4, 2048, 32), torch.bfloat16, 0.0086855, "operations"),
    ],
)
def test_kernel_bound_follows_the_kernels_route(shape, dtype, ms, by):
    got_ms, got_by = flash_attention_bound_ms(*shape, dtype, masked=True)
    assert got_by == by
    assert got_ms == pytest.approx(ms, rel=1e-5)


def test_kernel_bound_rejects_other_dtypes():
    with pytest.raises(TypeError):
        flash_attention_bound_ms(1, 1, 64, 64, torch.float16, masked=False)


def test_online_softmax_semantics():
    """Running max starts at NEG_INF, division by max(l, 1e-30): a key
    mask of finfo.min on every key gives 0; one of NEG_INF itself does
    not dominate the start value and gives the mean of V, as in the
    TPU kernel."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(3, 1, 1, 70, 32))
    full_min = torch.full((1, 70), MASK_MIN)
    assert not flash_attention_reference(q, k, v, full_min).any()
    full_neg_inf = torch.full((1, 70), NEG_INF)
    np.testing.assert_allclose(
        flash_attention_reference(q, k, v, full_neg_inf).numpy(),
        v.mean(dim=2, keepdim=True).expand_as(v).numpy(),
        atol=1e-5,
    )


def test_dispatcher_runs_plain_version_on_cpu_tensors():
    B, H, L, Dh = 2, 2, 40, 32
    q, k, v = (torch.from_numpy(t) for t in _qkv(4, B, H, L, Dh))
    mask = torch.from_numpy(_key_mask(B, L, [40, 12]))
    attention = make_flash_attention_fn()
    before = flash_attention.launches
    # BERT hands over non-contiguous head views and a [B, 1, 1, L] mask
    qt, kt, vt = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    out = attention(qt, kt, vt, mask[:, None, None, :], torch.float32)
    assert flash_attention.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(
        out, flash_attention_reference(q, k, v, mask), atol=0, rtol=0
    )


@pytest.mark.parametrize(
    "bad, error",
    [
        ("head_dim_16", ValueError),
        ("float16", TypeError),
        ("float64", TypeError),
        ("mixed_dtypes", TypeError),
        ("non_contiguous", ValueError),
        ("mask_shape", ValueError),
        ("mask_dtype", TypeError),
        ("shape_mismatch", ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, error):
    Dh = 16 if bad == "head_dim_16" else 32
    q, k, v = (torch.from_numpy(t) for t in _qkv(5, 1, 2, 24, Dh))
    mask = torch.zeros(1, 24)
    if bad in ("float16", "float64"):
        q, k, v = (t.to(getattr(torch, bad)) for t in (q, k, v))
    elif bad == "mixed_dtypes":
        k = k.to(torch.bfloat16)
    elif bad == "non_contiguous":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "mask_shape":
        mask = torch.zeros(1, 23)
    elif bad == "mask_dtype":
        mask = torch.zeros(1, 24, dtype=torch.float64)
    elif bad == "shape_mismatch":
        k = k[:, :, :20].contiguous()
    with pytest.raises(error):
        flash_attention(q, k, v, mask)
