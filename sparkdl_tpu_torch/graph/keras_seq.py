"""Keras sequence layers translated into torch modules, for ``keras_graph``.

The classes of :data:`SEQUENCE_CLASSES`: ``Embedding``, ``Masking``,
``Conv1D``, the 1-D pools, ``SpatialDropout1D``, ``SimpleRNN``, ``LSTM``,
``GRU``, ``Bidirectional`` and ``MultiHeadAttention``. Each computes what
the Keras 3 layer computes at inference on its JAX backend (the JAX
package's ``stateless_call``), masks included. Tensors are ``[B, T, C]``,
as in Keras.

Masks. ``keras_graph.KerasGraph`` carries beside each value the boolean
``[B, T]`` mask Keras attaches to it, by each module's ``mask_rule``:
``"keep"`` passes the input's mask on (the layers Keras marks
``supports_masking`` with the default ``compute_mask``), ``"own"`` takes
the mask into ``forward(x, mask)`` and gives the output's by
``output_mask(x, mask)``, and any other module drops it (a layer Keras
does not let masks through, Conv1D and the 1-D pools among them). As in
Keras 3, a layer whose ``call`` takes a ``mask`` argument (``mask_arg``:
the recurrent layers, Bidirectional, GlobalAveragePooling1D,
BatchNormalization, a nested model) is given the mask the model recorded
when it was built, and every other layer reads the mask its input
carries when it runs; the two differ after a MultiHeadAttention, which
takes the masks off its inputs (``clears_input_masks``), so that in
residual blocks (``Add([x, mha(x, x)])``) only the first attention is
masked.

- ``Embedding(mask_zero=True)`` and ``Masking`` make a mask.
- The recurrent layers keep their state through a masked step and give
  the state's output there (``zero_output_for_mask=False``, zeros when it
  is True, as ``Bidirectional`` sets it for its layers when they return
  sequences), as ``keras/src/backend/jax/rnn.py`` does; their sequence
  output keeps the mask.
- ``GlobalAveragePooling1D`` divides the masked sum by the count of
  unmasked steps; ``GlobalMaxPooling1D`` does not support masking in
  Keras and ignores it.
- ``MultiHeadAttention`` ANDs the query's mask ``[B, T, 1]`` with the
  value's (and the key's, when the key is another tensor) ``[B, 1, S]``
  and a causal mask, as ``_compute_attention_mask`` does; its output keeps
  the query's mask.

Embedding: ids are cast to integers as Keras casts them (float ids
truncated); an id in ``[-input_dim, 0)`` counts from the end of the table
and any other id outside it gives a NaN row, as ``jnp.take`` does on
Keras's JAX backend (``F.embedding`` would raise, and on the card assert
on the device).

Recurrences: two routes, chosen per call.

- ``"fused"``: torch's ``lstm``/``gru``/``rnn_tanh``/``rnn_relu`` (cuDNN
  on the card) over the whole batch, when the cell has a cuDNN form (LSTM
  with tanh and a sigmoid recurrent activation, GRU with those and
  ``reset_after=True``, SimpleRNN with tanh or relu) and every row's mask
  is one run of steps (none, or pre- or post-padding): a row's run is
  moved to the front, the recurrence runs from the zero state, and the
  outputs go back in Keras's places (zeros before the run, the last
  state's output, or zeros, after it).
- ``"steps"``: one torch step per time step, in Keras's arithmetic, for
  every other cell and for masks with holes (a 0 id inside a row).

``module.route_calls`` counts the calls each route took.

MultiHeadAttention: two routes, fixed per call site when the model is
built. ``"flash"`` runs the port's flash-attention op
(``ops/flash_attention.py``: the CUDA kernel on the card, its plain version
on the CPU) for self-attention (``mha(x, x)``) with ``key_dim ==
value_dim`` in the kernel's head dims (32, 64), no causal mask and no
``attention_mask`` argument, with the key mask as the kernel's additive
mask. ``"plain"`` runs Keras's own order for every other call. Keras
itself takes two paths, and they differ on a query row whose keys are all
masked (a padded query row, since the query's mask joins the key's):

- with ``dropout > 0``, ``_compute_attention``: the query scaled, the
  scores, ``where(mask, scores, -1e9)``, softmax, times the mask (Keras's
  ``Softmax`` layer): such a row attends to nothing and comes out 0, as
  the kernel's does;
- with ``dropout == 0``, ``ops.dot_product_attention``: the scores
  scaled, ``where(mask, scores, -0.7 * finfo(float32).max)``, softmax:
  such a row spreads evenly over all keys and comes out as the mean of V,
  which the flash route puts in the kernel's 0 rows.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.graph.keras_graph import (
    _Dropout,
    _Pool,
    _activation,
    _numpy,
    _param,
    _same_pads,
    _unsupported,
    _weights,
)
from sparkdl_tpu_torch.ops.flash_attention import _HEAD_DIMS, flash_attention

#: Keras's Softmax fill where masked (``_large_negative_number(float32)``)
_SOFTMAX_FILL = -1e9
#: jax.nn.dot_product_attention's fill for masked logits
_DPA_FILL = -0.7 * float(torch.finfo(torch.float32).max)


def _one(v) -> int:
    """A 1-D layer's size field: a number or a one-entry list."""
    return int(v[0] if isinstance(v, (list, tuple)) else v)


# -- embedding and masking ------------------------------------------------------


class _Embedding(nn.Module):
    """Embedding: a row of the table per id; ids in ``[-n, 0)`` count from
    the end and every other id out of ``[0, n)`` gives a NaN row (Keras's
    ``jnp.take``); with ``mask_zero`` the mask is ``ids != 0``."""

    mask_rule = "own"

    def __init__(self, table: torch.Tensor, mask_zero: bool):
        super().__init__()
        self.weight = _param(table)
        self.mask_zero = mask_zero

    def forward(self, x, mask=None):
        ids = x.long()  # float ids are truncated, as Keras's cast to int32
        n = self.weight.shape[0]
        ids = torch.where(ids < 0, ids + n, ids)
        valid = (ids >= 0) & (ids < n)
        rows = F.embedding(torch.where(valid, ids, torch.zeros_like(ids)), self.weight)
        return torch.where(valid.unsqueeze(-1), rows, torch.full_like(rows, float("nan")))

    def output_mask(self, x, mask):
        return x != 0 if self.mask_zero else None

    def keras_weights(self) -> List[np.ndarray]:
        return [_numpy(self.weight)]


class _Masking(nn.Module):
    """Masking: a step whose features all equal ``value`` is zeroed and
    masked."""

    mask_rule = "own"

    def __init__(self, value: float):
        super().__init__()
        self.value = value

    def forward(self, x, mask=None):
        return x * self.output_mask(x, None).unsqueeze(-1).to(x.dtype)

    def output_mask(self, x, mask):
        return (x != self.value).any(dim=-1)


# -- convolutions and pools ----------------------------------------------------


class _Conv1D(nn.Module):
    """Conv1D over ``[B, T, C]``: "valid", TF's "same" (the odd unit at the
    end) or "causal" (``dilation * (k - 1)`` steps on the left)."""

    def __init__(self, weight, bias, stride: int, dilation: int, groups: int, padding: str, act):
        super().__init__()
        self.weight = _param(weight)  # [filters, in / groups, k]
        self.bias = _param(bias)
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.padding, self.act = padding, act

    def forward(self, x):
        k = self.weight.shape[2]
        if self.padding == "causal":
            pads = (self.dilation * (k - 1), 0)
        elif self.padding == "same":
            pads = _same_pads(x.shape[1], k, self.stride, self.dilation)
        else:
            pads = (0, 0)
        y = F.conv1d(F.pad(x.transpose(1, 2), pads), self.weight, self.bias, self.stride, 0,
                     self.dilation, self.groups)
        return self.act(y.transpose(1, 2))

    def keras_weights(self) -> List[np.ndarray]:
        out = [_numpy(self.weight.permute(2, 1, 0))]  # -> (k, in / groups, filters)
        return out + ([] if self.bias is None else [_numpy(self.bias)])


class _Pool1D(nn.Module):
    """MaxPooling1D / AveragePooling1D: the 2-D pool over a ``[B, C, 1,
    T]`` view, with its "same" padding rules."""

    def __init__(self, kind: str, k: int, stride: int, padding: str):
        super().__init__()
        self.pool = _Pool(kind, (1, k), (1, stride), padding)

    def forward(self, x):
        return self.pool(x.transpose(1, 2).unsqueeze(2)).squeeze(2).transpose(1, 2)


class _GlobalPool1D(nn.Module):
    """GlobalAveragePooling1D (the masked mean: the masked sum over the
    count of unmasked steps) and GlobalMaxPooling1D (no mask, as in
    Keras)."""

    mask_rule = "own"

    def __init__(self, kind: str, keepdims: bool):
        super().__init__()
        self.kind, self.keepdims = kind, keepdims
        self.mask_arg = kind == "avg"  # GlobalMaxPooling1D's call takes no mask

    def forward(self, x, mask=None):
        if self.kind == "max":
            return x.amax(dim=1, keepdim=self.keepdims)
        if mask is None:
            return x.mean(dim=1, keepdim=self.keepdims)
        m = mask.to(x.dtype).unsqueeze(-1)
        return (x * m).sum(dim=1, keepdim=self.keepdims) / m.sum(dim=1, keepdim=self.keepdims)

    def output_mask(self, x, mask):
        return None


# -- recurrences ---------------------------------------------------------------

_RECURRENT = ("SimpleRNN", "LSTM", "GRU")


def _keras_to_torch_gates(w: torch.Tensor, kind: str) -> torch.Tensor:
    """Keras's gate blocks along the last axis -> torch's order (Keras's
    LSTM i, f, c, o is torch's i, f, g, o; Keras's GRU z, r, h becomes
    torch's r, z, n)."""
    if kind != "GRU":
        return w
    z, r, h = w.chunk(3, dim=-1)
    return torch.cat([r, z, h], dim=-1)


class _Recurrent(nn.Module):
    """SimpleRNN, LSTM or GRU with ``return_sequences``, ``go_backwards``
    and masks. Weights in torch's layout (``weight_ih`` ``[G*u, in]``,
    ``weight_hh`` ``[G*u, u]``, ``bias_ih``, and ``bias_hh`` for GRU's
    ``reset_after``). The outputs are in processing order, as Keras gives
    them: a ``go_backwards`` sequence output runs from the last step to
    the first."""

    mask_rule = "own"
    mask_arg = True

    def __init__(self, kind: str, kernel, recurrent, bias, act: str, rec_act: str, return_sequences: bool,
                 go_backwards: bool, zero_output_for_mask: bool, reset_after: bool, where: str):
        super().__init__()
        self.kind, self.units = kind, recurrent.shape[0]
        self.weight_ih = _param(_keras_to_torch_gates(kernel, kind).t().contiguous())
        self.weight_hh = _param(_keras_to_torch_gates(recurrent, kind).t().contiguous())
        bias_hh = None
        if bias is not None and bias.dim() == 2:  # GRU reset_after: input and recurrent biases
            bias, bias_hh = bias[0], bias[1]
        self.bias_ih = _param(None if bias is None else _keras_to_torch_gates(bias, kind).contiguous())
        self.bias_hh = _param(None if bias_hh is None else _keras_to_torch_gates(bias_hh, kind).contiguous())
        self.act = _activation(act, where)
        self.rec_act = _activation(rec_act, where) if kind != "SimpleRNN" else None
        self.return_sequences, self.go_backwards = return_sequences, go_backwards
        self.zero_output_for_mask, self.reset_after = zero_output_for_mask, reset_after
        if kind == "SimpleRNN":
            self.fused_op = {"tanh": torch.rnn_tanh, "relu": torch.rnn_relu}.get(act)
        elif act == "tanh" and rec_act == "sigmoid" and (kind == "LSTM" or reset_after):
            self.fused_op = torch.lstm if kind == "LSTM" else torch.gru
        else:
            self.fused_op = None
        self.route_calls: Dict[str, int] = {"fused": 0, "steps": 0}

    def keras_weights(self) -> List[np.ndarray]:
        def keras(w):
            if self.kind != "GRU":
                return w
            r, z, h = w.chunk(3, dim=-1)
            return torch.cat([z, r, h], dim=-1)

        out = [_numpy(keras(self.weight_ih.t())), _numpy(keras(self.weight_hh.t()))]
        if self.bias_hh is not None:
            out.append(_numpy(torch.stack([keras(self.bias_ih), keras(self.bias_hh)])))
        elif self.bias_ih is not None:
            out.append(_numpy(keras(self.bias_ih)))
        return out

    def output_mask(self, x, mask):
        return mask if self.return_sequences else None

    # the two routes ---------------------------------------------------------------

    def _cell(self, x_t, state):
        """One Keras step over the input projection ``x_t`` (bias
        included): the new output and state."""
        h = state[0]
        if self.kind == "SimpleRNN":
            h = self.act(x_t + F.linear(h, self.weight_hh))
            return h, (h,)
        if self.kind == "LSTM":
            i, f, g, o = (x_t + F.linear(h, self.weight_hh)).chunk(4, dim=-1)
            c = self.rec_act(f) * state[1] + self.rec_act(i) * self.act(g)
            h = self.rec_act(o) * self.act(c)
            return h, (h, c)
        xr, xz, xn = x_t.chunk(3, dim=-1)
        u = self.units
        if self.reset_after:
            hr, hz, hn = F.linear(h, self.weight_hh, self.bias_hh).chunk(3, dim=-1)
            r, z = self.rec_act(xr + hr), self.rec_act(xz + hz)
            n = self.act(xn + r * hn)
        else:
            hr, hz = F.linear(h, self.weight_hh[: 2 * u]).chunk(2, dim=-1)
            r, z = self.rec_act(xr + hr), self.rec_act(xz + hz)
            n = self.act(xn + F.linear(r * h, self.weight_hh[2 * u:]))
        h = z * h + (1 - z) * n
        return h, (h,)

    def _steps(self, x, mask):
        """Keras's loop (``backend/jax/rnn.py``) over ``x`` in processing
        order: at a masked step the state stays and the output is the
        state's (zeros with ``zero_output_for_mask``)."""
        B, T, _ = x.shape
        proj = F.linear(x, self.weight_ih, self.bias_ih)
        h = x.new_zeros(B, self.units)
        state = (h, h) if self.kind == "LSTM" else (h,)
        outs = []
        for t in range(T):
            out, new = self._cell(proj[:, t], state)
            if mask is not None:
                keep = mask[:, t, None]
                held = torch.zeros_like(out) if self.zero_output_for_mask else state[0]
                out = torch.where(keep, out, held)
                new = tuple(torch.where(keep, n, s) for n, s in zip(new, state))
            state = new
            outs.append(out)
        return torch.stack(outs, dim=1)

    def _fused(self, x):
        """torch's fused recurrence over ``x`` from the zero state: the
        output sequence ``[B, T, u]``."""
        h0 = x.new_zeros(1, x.shape[0], self.units)
        bias_ih = self.bias_ih if self.bias_ih is not None else x.new_zeros(self.weight_ih.shape[0])
        bias_hh = self.bias_hh if self.bias_hh is not None else torch.zeros_like(bias_ih)
        params = [self.weight_ih, self.weight_hh, bias_ih, bias_hh]
        hx = (h0, h0) if self.kind == "LSTM" else h0
        return self.fused_op(x, hx, params, True, 1, 0.0, False, False, True)[0]

    def _fused_run(self, x, mask):
        """The fused route over rows whose mask is one run of steps (in
        processing order, ``first`` to ``first + n``): the run moved to the
        front, the recurrence, and its outputs put back in Keras's
        places."""
        B, T, C = x.shape
        pos = torch.arange(T, device=x.device)
        n = mask.sum(dim=1)
        first = mask.to(torch.int8).argmax(dim=1)
        src = (first[:, None] + pos).clamp(max=T - 1)
        y = self._fused(x.gather(1, src[..., None].expand(B, T, C)))
        last = y.gather(1, (n - 1).clamp(min=0)[:, None, None].expand(B, 1, self.units))
        last = torch.where(n[:, None, None] > 0, last, torch.zeros_like(last))
        back = y.gather(1, (pos - first[:, None]).clamp(min=0)[..., None].expand(B, T, self.units))
        after = torch.zeros_like(back) if self.zero_output_for_mask else last.expand(B, T, self.units)
        before = (pos < first[:, None])[..., None]
        return torch.where(mask[..., None], back, torch.where(before, torch.zeros_like(back), after))

    def forward(self, x, mask=None):
        if self.go_backwards:
            x = x.flip(1)
            mask = None if mask is None else mask.flip(1)
        if mask is not None and not mask.all():
            steps = self.fused_op is None or not bool(_one_run(mask))
        else:
            mask, steps = None, self.fused_op is None
        self.route_calls["steps" if steps else "fused"] += 1
        if steps:
            y = self._steps(x, mask)
        elif mask is None:
            y = self._fused(x)
        else:
            y = self._fused_run(x, mask)
        return y if self.return_sequences else y[:, -1]


def _one_run(mask: torch.Tensor) -> torch.Tensor:
    """Whether every row of a ``[B, T]`` mask is one run of True steps (or
    none)."""
    T = mask.shape[1]
    pos = torch.arange(T, device=mask.device)
    n = mask.sum(dim=1, keepdim=True)
    first = mask.to(torch.int8).argmax(dim=1, keepdim=True)
    return (((pos >= first) & (pos < first + n)) == mask).all()


class _Bidirectional(nn.Module):
    """Bidirectional: the forward layer and the backward one (which runs
    the reversed sequence), the backward sequence output flipped back,
    merged by ``concat``, ``sum``, ``mul`` or ``ave``."""

    mask_rule = "own"
    mask_arg = True

    def __init__(self, forward_layer: _Recurrent, backward_layer: _Recurrent, merge_mode: str):
        super().__init__()
        self.forward_layer, self.backward_layer = forward_layer, backward_layer
        self.merge_mode = merge_mode
        self.return_sequences = forward_layer.return_sequences

    def keras_weights(self) -> List[np.ndarray]:
        return self.forward_layer.keras_weights() + self.backward_layer.keras_weights()

    def output_mask(self, x, mask):
        return mask if self.return_sequences else None

    def forward(self, x, mask=None):
        y = self.forward_layer(x, mask)
        y_rev = self.backward_layer(x, mask)
        if self.return_sequences:
            y_rev = y_rev.flip(1)
        if self.merge_mode == "concat":
            return torch.cat([y, y_rev], dim=-1)
        if self.merge_mode == "sum":
            return y + y_rev
        if self.merge_mode == "ave":
            return (y + y_rev) / 2
        return y * y_rev


# -- attention -----------------------------------------------------------------


class _MultiHeadAttention(nn.Module):
    """MultiHeadAttention over ``[B, T, d]`` query and ``[B, S, d]`` value
    (and key): the projections (Keras's EinsumDense kernels ``[d, N, k]``
    held as ``[N*k, d]``), attention by the call's route, and the output
    projection (``[N, v, d_out]`` held as ``[d_out, N*v]``). ``forward``
    takes ``[query, value, key]`` (key None for the value) and their masks,
    and the node's ``causal`` flag and ``route`` (see the module
    docstring)."""

    mask_rule = "own"
    clears_input_masks = True

    def __init__(self, ws: List[torch.Tensor], num_heads: int, key_dim: int, value_dim: int, dropout: float,
                 use_bias: bool):
        super().__init__()
        ws = list(ws)
        self.num_heads, self.key_dim, self.value_dim, self.dropout = num_heads, key_dim, value_dim, dropout
        self.use_bias = use_bias
        for name in ("query", "key", "value"):
            kernel = ws.pop(0)
            setattr(self, f"{name}_weight", _param(kernel.reshape(kernel.shape[0], -1).t().contiguous()))
            setattr(self, f"{name}_bias", _param(ws.pop(0).reshape(-1) if use_bias else None))
        kernel = ws.pop(0)
        self.out_shape = tuple(kernel.shape[2:])
        self.out_weight = _param(kernel.reshape(num_heads * value_dim, -1).t().contiguous())
        self.out_bias = _param(ws.pop(0).reshape(-1) if use_bias else None)

    @property
    def flash_ok(self) -> bool:
        """Whether a self-attention call fits the flash kernel."""
        return self.key_dim == self.value_dim and self.key_dim in _HEAD_DIMS

    def keras_weights(self) -> List[np.ndarray]:
        N = self.num_heads
        out = []
        for name, dim in (("query", self.key_dim), ("key", self.key_dim), ("value", self.value_dim)):
            w = getattr(self, f"{name}_weight")
            out.append(_numpy(w.t().reshape(w.shape[1], N, dim)))
            if self.use_bias:
                out.append(_numpy(getattr(self, f"{name}_bias").reshape(N, dim)))
        out.append(_numpy(self.out_weight.t().reshape(N, self.value_dim, *self.out_shape)))
        if self.use_bias:
            out.append(_numpy(self.out_bias.reshape(self.out_shape)))
        return out

    def output_mask(self, xs, masks):
        return masks[0] if masks is not None else None

    def _heads(self, x, name: str, dim: int) -> torch.Tensor:
        w, b = getattr(self, f"{name}_weight"), getattr(self, f"{name}_bias")
        return F.linear(x, w, b).view(*x.shape[:2], self.num_heads, dim)

    def forward(self, xs, masks=None, causal: bool = False, route: str = "plain"):
        query, value, key = xs
        q_mask, v_mask, k_mask = masks if masks is not None else (None, None, None)
        if key is None:
            key, k_mask = value, None
        q = self._heads(query, "query", self.key_dim)  # [B, T, N, k]
        k = self._heads(key, "key", self.key_dim)
        v = self._heads(value, "value", self.value_dim)
        if route == "flash":
            out = self._flash(q, k, v, q_mask, v_mask)
        else:
            out = self._plain(q, k, v, _attention_mask(q_mask, v_mask, k_mask, causal, q.shape[1], k.shape[1]))
        y = F.linear(out.reshape(*out.shape[:2], -1), self.out_weight, self.out_bias)
        return y.reshape(*y.shape[:2], *self.out_shape)

    def _flash(self, q, k, v, q_mask, kv_mask):
        """Self-attention through the flash op with the additive key mask;
        a query row Keras masks whole (a padded query) is 0 with dropout
        (its masked softmax) and the mean of V without (its dot-product
        attention over equal scores)."""
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))  # [B, N, L, k]
        additive = None
        if kv_mask is not None:
            additive = torch.zeros(kv_mask.shape, dtype=torch.float32, device=q.device).masked_fill(
                ~kv_mask, torch.finfo(torch.float32).min)
        out = flash_attention(q, k, v, additive)
        if q_mask is not None:
            empty = ~q_mask
            if kv_mask is not None:
                empty = empty | ~kv_mask.any(dim=1, keepdim=True)
            fill = v.mean(dim=2, keepdim=True) if self.dropout == 0 else torch.zeros_like(out[:, :, :1])
            out = torch.where(empty[:, None, :, None], fill, out)
        return out.transpose(1, 2)  # [B, T, N, k]

    def _plain(self, q, k, v, mask):
        """Keras's order: with dropout its ``_compute_attention``, else its
        ``ops.dot_product_attention``."""
        scale = 1.0 / math.sqrt(self.key_dim)
        if self.dropout > 0:
            scores = torch.einsum("btnh,bsnh->bnts", q * scale, k)
            if mask is None:
                probs = torch.softmax(scores, dim=-1)
            else:
                mask = mask[:, None]
                scores = torch.where(mask, scores, torch.full_like(scores, _SOFTMAX_FILL))
                probs = torch.softmax(scores, dim=-1) * mask.to(scores.dtype)
        else:
            scores = torch.einsum("btnh,bsnh->bnts", q, k) * scale
            if mask is not None:
                scores = torch.where(mask[:, None], scores, torch.full_like(scores, _DPA_FILL))
            probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bnts,bsnh->btnh", probs, v)


def _attention_mask(q_mask, v_mask, k_mask, causal: bool, T: int, S: int) -> Optional[torch.Tensor]:
    """``_compute_attention_mask``: the query mask ``[B, T, 1]``, the value
    and key masks ``[B, 1, S]`` and the causal mask ``[1, T, S]``, ANDed."""
    out = None
    for m in (None if q_mask is None else q_mask[:, :, None], None if v_mask is None else v_mask[:, None, :],
              None if k_mask is None else k_mask[:, None, :]):
        if m is not None:
            out = m if out is None else out & m
    if causal:
        device = next(m for m in (q_mask, v_mask, k_mask, torch.empty(0)) if m is not None).device
        tri = torch.ones(T, S, dtype=torch.bool, device=device).tril()[None]
        out = tri if out is None else out & tri
    return out


# -- from a layer config to its module -----------------------------------------------


def _build_embedding(cfg, source):
    table, = _weights(source, cfg["name"], 1)
    return _Embedding(table, bool(cfg.get("mask_zero", False)))


def _build_conv1d(cfg, source):
    padding = cfg.get("padding", "valid")
    if padding not in ("valid", "same", "causal"):
        raise _unsupported(f"Conv1D {cfg['name']!r} with padding {padding!r}")
    use_bias = cfg.get("use_bias", True)
    ws = _weights(source, cfg["name"], 2 if use_bias else 1)
    return _Conv1D(ws[0].permute(2, 1, 0).contiguous(), ws[1] if use_bias else None, _one(cfg.get("strides", 1)),
                   _one(cfg.get("dilation_rate", 1)), int(cfg.get("groups", 1)), padding,
                   _activation(cfg.get("activation"), cfg["name"]))


def _build_pool1d(kind):
    def build(cfg, source):
        k = _one(cfg.get("pool_size", 2))
        stride = cfg.get("strides")
        return _Pool1D(kind, k, k if stride is None else _one(stride), cfg.get("padding", "valid"))

    return build


def _build_global1d(kind):
    return lambda cfg, source: _GlobalPool1D(kind, bool(cfg.get("keepdims", False)))


def _recurrent(class_name: str, cfg: dict, ws: List[torch.Tensor], zero_output_for_mask=None) -> _Recurrent:
    """A recurrent layer's module from its config and its weights (kernel,
    recurrent kernel, bias if any). Refuses what Keras's inference does
    not reduce to the routes above."""
    where = f"{class_name} {cfg['name']!r}"
    for flag in ("return_state", "stateful"):
        if cfg.get(flag, False):
            raise _unsupported(f"{where} with {flag}=True")
    reset_after = bool(cfg.get("reset_after", True)) if class_name == "GRU" else False
    kernel, recurrent = ws[0], ws[1]
    bias = ws[2] if len(ws) > 2 else None
    if zero_output_for_mask is None:
        zero_output_for_mask = bool(cfg.get("zero_output_for_mask", False))
    return _Recurrent(class_name, kernel, recurrent, bias, cfg.get("activation", "tanh") or "linear",
                      cfg.get("recurrent_activation", "sigmoid") or "linear",
                      bool(cfg.get("return_sequences", False)), bool(cfg.get("go_backwards", False)),
                      zero_output_for_mask, reset_after, where)


def _n_recurrent_weights(cfg: dict) -> int:
    return 3 if cfg.get("use_bias", True) else 2


def _build_recurrent(class_name):
    def build(cfg, source):
        return _recurrent(class_name, cfg, _weights(source, cfg["name"], _n_recurrent_weights(cfg)))

    return build


def _build_bidirectional(cfg, source):
    merge_mode = cfg.get("merge_mode", "concat")
    if merge_mode not in ("concat", "sum", "mul", "ave"):
        raise _unsupported(f"Bidirectional {cfg['name']!r} with merge_mode={merge_mode!r}")
    inner = []
    for key in ("layer", "backward_layer"):
        layer = cfg.get(key) or cfg["layer"]
        if layer["class_name"] not in _RECURRENT:
            raise _unsupported(f"Bidirectional {cfg['name']!r} over a {layer['class_name']!r}")
        inner.append(layer)
    counts = [_n_recurrent_weights(layer["config"]) for layer in inner]
    ws = _weights(source, cfg["name"], sum(counts))
    fwd_cfg = dict(inner[0]["config"])
    bwd_cfg = dict(inner[1]["config"])
    if "backward_layer" not in cfg:  # the backward layer is the forward one going backwards
        bwd_cfg["go_backwards"] = not fwd_cfg.get("go_backwards", False)
    # Keras zeroes the masked outputs of both layers when they return sequences
    zero = bool(fwd_cfg.get("return_sequences", False))
    fwd = _recurrent(inner[0]["class_name"], fwd_cfg, ws[:counts[0]], zero)
    bwd = _recurrent(inner[1]["class_name"], bwd_cfg, ws[counts[0]:], zero)
    return _Bidirectional(fwd, bwd, merge_mode)


def _build_mha(cfg, source):
    where = f"MultiHeadAttention {cfg['name']!r}"
    axes = cfg.get("attention_axes")
    if axes not in (None, [1], (1,)):
        raise _unsupported(f"{where} with attention_axes {axes}")
    use_bias = cfg.get("use_bias", True)
    ws = _weights(source, cfg["name"], 8 if use_bias else 4)
    key_dim = int(cfg["key_dim"])
    value_dim = int(cfg.get("value_dim") or key_dim)
    return _MultiHeadAttention(ws, int(cfg["num_heads"]), key_dim, value_dim, float(cfg.get("dropout", 0.0)),
                               use_bias)


def _build_spatial_dropout(cfg, source):
    return _Dropout(float(cfg.get("rate", 0.0)), (None, 1, None))


#: the module of each class of :data:`keras_graph.SEQUENCE_CLASSES`, from its
#: config and weights
SEQUENCE_MODULES = {
    "Embedding": _build_embedding,
    "Masking": lambda cfg, source: _Masking(float(cfg.get("mask_value", 0.0))),
    "Conv1D": _build_conv1d,
    "MaxPooling1D": _build_pool1d("max"),
    "AveragePooling1D": _build_pool1d("avg"),
    "GlobalAveragePooling1D": _build_global1d("avg"),
    "GlobalMaxPooling1D": _build_global1d("max"),
    "SpatialDropout1D": _build_spatial_dropout,
    "SimpleRNN": _build_recurrent("SimpleRNN"),
    "LSTM": _build_recurrent("LSTM"),
    "GRU": _build_recurrent("GRU"),
    "Bidirectional": _build_bidirectional,
    "MultiHeadAttention": _build_mha,
}
