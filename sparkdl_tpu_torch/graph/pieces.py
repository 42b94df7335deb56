"""Prebuilt graph pieces: the image converter, the flattener, and the host
stage that packs image structs into batches.

Port of the JAX package's ``graph/pieces.py``. The split is the same:

- **Host stage** (numpy, on the batch producer thread): image struct ->
  HWC uint8 -> resize to the model's fixed geometry (PIL bilinear) ->
  a uint8 batch, packed channel-major (``chw=True``) for the device, which
  is PyTorch's native NCHW.
- **Device stage** (torch, on the model's device): uint8 NCHW -> float32,
  BGR -> RGB, the model family's normalization ('tf' / 'caffe' / 'torch'
  ImageNet conventions), then the model's dtype in ``channels_last``
  memory format, which cuDNN's convolutions take without a transpose.

The on-device preprocessing arm (``SPARKDL_DEVICE_PREPROC``,
:func:`build_device_preproc`) moves the resize to the device: the host
ships uint8 rows at the source geometry.

Where the JAX package works on NHWC (channel axis -1), the pieces here
work on NCHW (channel axis 1); the arithmetic is the same.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.graph.function import ModelFunction, piece
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.runtime.device import exact_float32

_IMAGENET_MEAN_RGB = (123.68, 116.779, 103.939)
_TORCH_MEAN = (0.485, 0.456, 0.406)
_TORCH_STD = (0.229, 0.224, 0.225)


def _channel_vector(values) -> Callable[[torch.device], torch.Tensor]:
    """Per-channel constants [1, C, 1, 1], made once per device: copying
    them from host memory for every batch would wait for the device."""
    made = {}

    def on(device: torch.device) -> torch.Tensor:
        if device not in made:
            made[device] = torch.tensor(
                values, dtype=torch.float32, device=device
            ).view(1, -1, 1, 1)
        return made[device]

    return on


def normalize_fn(mode: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """f(NCHW float RGB in [0, 255]) -> normalized float, per the keras
    imagenet_utils conventions."""
    if mode == "tf":
        return lambda x: x / 127.5 - 1.0
    if mode == "caffe":
        # RGB -> BGR, then subtract the ImageNet mean in BGR order
        mean = _channel_vector(_IMAGENET_MEAN_RGB[::-1])
        return lambda x: x.flip(1) - mean(x.device)
    if mode == "torch":
        mean, std = _channel_vector(_TORCH_MEAN), _channel_vector(_TORCH_STD)
        return lambda x: (x / 255.0 - mean(x.device)) / std(x.device)
    if mode in (None, "none", "identity"):
        return lambda x: x
    raise ValueError(f"Unknown preprocessing mode {mode!r}")


def build_image_converter(
    channel_order_in: str = "BGR",
    preprocessing: str = "none",
    out_dtype: torch.dtype = torch.float32,
) -> ModelFunction:
    """Device piece: NCHW uint8 batch in storage order (BGR by default, per
    the image schema) -> normalized RGB batch in ``out_dtype``, NCHW in
    ``channels_last`` memory format. The cast to float32 comes before the
    normalization, the cast to ``out_dtype`` after it."""
    norm = normalize_fn(preprocessing)

    def convert(x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if channel_order_in == "BGR" and x.shape[1] == 3:
            x = x.flip(1)  # -> RGB
        y = norm(x)
        return y.to(out_dtype).contiguous(memory_format=torch.channels_last)

    return piece(convert, name=f"spImageConverter[{preprocessing}]")


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """The (in_size, out_size) matrix of ``jax.image.resize``'s bilinear
    resize along one axis (``jax._src.image.scale.compute_weight_mat``
    with the triangle kernel, antialiased): half-pixel centres, and when
    the axis shrinks the kernel widened by the factor, so each output
    averages the inputs it covers; each column sums to 1. Computed in
    float64 and rounded to float32 once: jax computes the sample
    positions in float32, whose rounding (about 1e-5 of a pixel at 320)
    moves an output by up to 4e-3 on the 0-255 scale between two
    evaluations of the same resize."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0.0).astype(np.float32)


def build_device_preproc(src_hw: Tuple[int, int], dst_hw: Tuple[int, int]) -> ModelFunction:
    """Device piece of the on-device preprocessing arm
    (``SPARKDL_DEVICE_PREPROC``): an NCHW uint8 batch at the source
    geometry -> float32 NCHW at the model geometry, resized as
    ``jax.image.resize(method="bilinear")`` resizes (antialiased when it
    shrinks; ``F.interpolate`` does not follow that convention): one
    product per resized axis with the weight matrix of
    :func:`resize_weights`, in float32 (TF32 off). An axis of equal size
    is not touched, so at identity geometry the arm is bit-identical to
    the host path."""
    src = (int(src_hw[0]), int(src_hw[1]))
    dst = (int(dst_hw[0]), int(dst_hw[1]))
    rows = None if src[0] == dst[0] else resize_weights(src[0], dst[0]).T.copy()  # (H_out, H_in)
    cols = None if src[1] == dst[1] else resize_weights(src[1], dst[1])  # (W_in, W_out)
    made = {}

    def on(device: torch.device):
        if device not in made:
            made[device] = tuple(None if m is None else torch.from_numpy(m).to(device) for m in (rows, cols))
        return made[device]

    def pre(x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if rows is None and cols is None:
            return x
        r, c = on(x.device)
        with exact_float32():
            if r is not None:
                x = torch.matmul(r, x)
            if c is not None:
                x = torch.matmul(x, c)
        return x

    return piece(pre, name=f"deviceResize[{src[0]}x{src[1]}->{dst[0]}x{dst[1]}]")


def build_flattener() -> ModelFunction:
    """Model output -> flat [N, D] float32 rows (MLlib Vector analogue)."""

    def flatten(y):
        if isinstance(y, (tuple, list)):
            y = y[0]
        return y.reshape(y.shape[0], -1).to(torch.float32)

    return piece(flatten, name="flattener")


def host_resize_uint8(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    """HWC uint8 -> (height, width, C) uint8, PIL bilinear."""
    from PIL import Image

    if arr.shape[0] == height and arr.shape[1] == width:
        return arr
    if arr.shape[2] == 1:
        img = Image.fromarray(arr[:, :, 0], "L").resize(
            (width, height), Image.BILINEAR
        )
        return np.asarray(img, dtype=np.uint8)[:, :, None]
    img = Image.fromarray(arr[:, :, :3], "RGB").resize(
        (width, height), Image.BILINEAR
    )
    return np.asarray(img, dtype=np.uint8)


def image_structs_to_batch(
    structs: Sequence[Optional[dict]],
    height: int,
    width: int,
    n_channels: int = 3,
    chw: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host stage: image structs (possibly None) -> (uint8 batch, valid
    mask). The batch is (n, H, W, C), or (n, C, H, W) with ``chw=True``.
    A null or undecodable struct gives a zero row with mask False, so the
    output row can be nulled again; 1-channel images are repeated to 3,
    4-channel ones lose alpha, and 3-channel ones become ITU-R 601 luma
    when one channel is asked for."""
    n = len(structs)
    batch = np.zeros((n, height, width, n_channels), dtype=np.uint8)
    mask = np.zeros((n,), dtype=bool)
    for i, s in enumerate(structs):
        if s is None:
            continue
        try:
            arr = imageIO.imageStructToArray(s)
        except (ValueError, KeyError, TypeError):
            continue
        if arr.shape[2] == 1 and n_channels == 3:
            arr = np.repeat(arr, 3, axis=2)
        elif arr.shape[2] == 4 and n_channels == 3:
            arr = arr[:, :, :3]
        elif arr.shape[2] == 3 and n_channels == 1:
            # ITU-R 601 luma on BGR storage
            luma = (
                arr[:, :, 0].astype(np.uint32) * 114
                + arr[:, :, 1].astype(np.uint32) * 587
                + arr[:, :, 2].astype(np.uint32) * 299
                + 500
            ) // 1000
            arr = luma.astype(np.uint8)[:, :, None]
        elif arr.shape[2] != n_channels:
            continue
        batch[i] = host_resize_uint8(arr, height, width)
        mask[i] = True
    if chw:
        batch = np.ascontiguousarray(batch.transpose(0, 3, 1, 2))
    return batch, mask


class ImageInputSpec(NamedTuple):
    """A declared image input: the port's counterpart of the reference's
    shared TF placeholder (see :func:`imageInputPlaceholder`)."""

    name: str
    shape: tuple  # (batch, height, width, channels); None = any
    dtype: Any

    @property
    def tensor_name(self) -> str:
        return f"{self.name}:0"


def imageInputPlaceholder(nChannels: int = 3, name: str = "sparkdl_image_input") -> ImageInputSpec:
    """The reference's image-input declaration.

    Upstream (``sparkdl.imageInputPlaceholder``) returned a shared
    ``tf.placeholder`` of shape ``[None, None, None, nChannels]`` named
    ``"sparkdl_image_input"`` that user graphs attached to. The port has no
    placeholders, so, as the JAX package does, it returns an input SPEC
    with the same name, shape and dtype, for the ingestion doors' input
    mapping::

        spec = imageInputPlaceholder(3)
        mf = TFInputGraph.from_graph_def(pb, inputs=[spec.tensor_name],
                                         outputs=["features:0"])
    """
    return ImageInputSpec(name=name, shape=(None, None, None, nChannels), dtype=np.float32)
