"""Keras ``compile``/``fit`` by name, on a Keras model translated to torch
(``graph/keras_graph.KerasModule``).

The JAX package's ``ImageFileEstimator`` calls ``model.compile(optimizer,
loss)`` and ``model.fit(x, y, **kerasFitParams)`` on keras's JAX backend.
The port has no keras, so it writes each rule as Keras 3 does (its
``optimizers/*.py`` ``update_step`` and ``backend/jax/nn.py``), not as
``torch.optim`` or ``torch.nn.functional`` would:

- optimizers, by name or ``{"class_name", "config"}``:
  ``adam`` (lr 0.001, beta_1 0.9, beta_2 0.999, epsilon 1e-7:
  ``w -= lr * sqrt(1 - beta_2^t) / (1 - beta_1^t) * m / (sqrt(v) + eps)``,
  amsgrad too), ``sgd`` (lr 0.01, momentum, nesterov) and ``rmsprop``
  (lr 0.001, rho 0.9, momentum, epsilon 1e-7, centered);
- losses, each reduced as ``sum_over_batch_size`` (the mean over the
  batch): ``categorical_crossentropy`` and
  ``sparse_categorical_crossentropy`` (the probabilities normalized to
  sum 1, then clipped to [1e-7, 1 - 1e-7]), ``binary_crossentropy``
  (clipped, mean over the last axis) and ``mean_squared_error``;
- ``fit`` keywords ``epochs`` (1), ``batch_size`` (32), ``shuffle``
  (True: each epoch's order from a ``torch.Generator`` seeded with the
  caller's seed) and ``verbose``; a partial last batch is one step.

Anything else (another optimizer, loss or keyword, a learning-rate
schedule, clipping, weight decay, EMA) raises NotImplementedError naming
ROADMAP Queue A item 9. ``fit`` trains where the module lives.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.graph.keras_graph import KerasModule
from sparkdl_tpu_torch.runtime.device import exact_float32

ROADMAP_ITEM = "ROADMAP Queue A item 9"
#: keras.config.epsilon()
EPSILON = 1e-7
#: optimizer config keys taken only at the value Keras defaults them to
_BASE_DEFAULTS = {
    "weight_decay": None, "clipnorm": None, "clipvalue": None, "global_clipnorm": None,
    "use_ema": False, "ema_momentum": 0.99, "ema_overwrite_frequency": None,
    "loss_scale_factor": None, "gradient_accumulation_steps": None,
}
_FIT_KEYS = ("epochs", "batch_size", "shuffle", "verbose")


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported from Keras ({ROADMAP_ITEM})")


class _Optimizer:
    """The per-variable state and the step count of a Keras optimizer."""

    defaults: Dict[str, Any] = {}

    def __init__(self, params: List[torch.nn.Parameter], **config):
        self.params = params
        self.config = dict(self.defaults, **config)
        if not isinstance(self.config["learning_rate"], (int, float)):
            raise _unsupported(f"learning rate {self.config['learning_rate']!r} (a schedule)")
        self.lr = float(self.config["learning_rate"])
        self.iterations = 0
        self.state: List[Dict[str, torch.Tensor]] = [{} for _ in params]

    def slot(self, i: int, name: str) -> torch.Tensor:
        if name not in self.state[i]:
            self.state[i][name] = torch.zeros_like(self.params[i])
        return self.state[i][name]

    @torch.no_grad()
    def step(self) -> None:
        for i, p in enumerate(self.params):
            if p.grad is not None:
                self.update(i, p, p.grad)
        self.iterations += 1

    def update(self, i: int, var: torch.Tensor, grad: torch.Tensor) -> None:
        raise NotImplementedError


class Adam(_Optimizer):
    defaults = {"learning_rate": 0.001, "beta_1": 0.9, "beta_2": 0.999, "epsilon": EPSILON, "amsgrad": False}

    def _alpha(self, var: torch.Tensor) -> torch.Tensor:
        """``lr * sqrt(1 - beta_2^t) / (1 - beta_1^t)`` in the variable's
        dtype (Keras: powers of the cast betas at the 1-based step), made
        once per step and device."""
        key = (self.iterations, var.device, var.dtype)
        if getattr(self, "_alpha_key", None) != key:
            c = self.config
            step = torch.tensor(float(self.iterations + 1), dtype=var.dtype)
            b1_power = torch.pow(torch.tensor(c["beta_1"], dtype=var.dtype), step)
            b2_power = torch.pow(torch.tensor(c["beta_2"], dtype=var.dtype), step)
            alpha = torch.tensor(self.lr, dtype=var.dtype) * torch.sqrt(1 - b2_power) / (1 - b1_power)
            self._alpha_key, self._alpha_value = key, alpha.to(var.device)
        return self._alpha_value

    def update(self, i, var, grad):
        c = self.config
        alpha = self._alpha(var)
        m, v = self.slot(i, "m"), self.slot(i, "v")
        m.add_((grad - m) * (1 - c["beta_1"]))
        v.add_((grad.square() - v) * (1 - c["beta_2"]))
        if c["amsgrad"]:
            v_hat = self.slot(i, "v_hat")
            v_hat.copy_(torch.maximum(v_hat, v))
            v = v_hat
        var.sub_((m * alpha) / (v.sqrt() + c["epsilon"]))


class SGD(_Optimizer):
    defaults = {"learning_rate": 0.01, "momentum": 0.0, "nesterov": False}

    def update(self, i, var, grad):
        momentum = float(self.config["momentum"])
        if momentum == 0:
            var.sub_(grad * self.lr)
            return
        m = self.slot(i, "m")
        m.copy_(m * momentum - grad * self.lr)
        if self.config["nesterov"]:
            var.add_(m * momentum - grad * self.lr)
        else:
            var.add_(m)


class RMSprop(_Optimizer):
    defaults = {"learning_rate": 0.001, "rho": 0.9, "momentum": 0.0, "epsilon": EPSILON, "centered": False}

    def update(self, i, var, grad):
        c = self.config
        rho = c["rho"]
        velocity = self.slot(i, "velocity")
        velocity.copy_(rho * velocity + (1 - rho) * grad.square())
        if c["centered"]:
            average = self.slot(i, "average")
            average.copy_(rho * average + (1 - rho) * grad)
            denominator = velocity - average.square() + c["epsilon"]
        else:
            denominator = velocity + c["epsilon"]
        increment = (self.lr * grad) / denominator.sqrt()
        if c["momentum"] > 0:
            m = self.slot(i, "m")
            m.copy_(c["momentum"] * m + increment)
            var.sub_(m)
        else:
            var.sub_(increment)


OPTIMIZERS = {"adam": Adam, "sgd": SGD, "rmsprop": RMSprop}


def make_optimizer(spec, params: List[torch.nn.Parameter]) -> _Optimizer:
    """A Keras optimizer given by name (``"adam"``) or as
    ``{"class_name": "Adam", "config": {...}}`` (``keras.optimizers.serialize``)."""
    if isinstance(spec, str):
        name, config = spec, {}
    elif isinstance(spec, dict) and "class_name" in spec:
        name, config = spec["class_name"], dict(spec.get("config") or {})
    else:
        raise _unsupported(f"the optimizer {spec!r} (give a name or a serialized config)")
    cls = OPTIMIZERS.get(str(name).lower())
    if cls is None:
        raise _unsupported(f"the optimizer {name!r}")
    config.pop("name", None)
    for key, default in _BASE_DEFAULTS.items():
        if config.pop(key, default) != default:
            raise _unsupported(f"optimizer {key}={spec['config'][key]!r}")
    unknown = set(config) - set(cls.defaults)
    if unknown:
        raise _unsupported(f"optimizer options {sorted(unknown)} of {name!r}")
    return cls(params, **config)


# -- losses (keras.src.backend.jax.nn and keras.src.losses) -------------------


def _normalized_log(y_pred: torch.Tensor) -> torch.Tensor:
    y_pred = y_pred / y_pred.sum(dim=-1, keepdim=True)
    return torch.log(y_pred.clamp(EPSILON, 1.0 - EPSILON))


def categorical_crossentropy(y_true, y_pred):
    return -(y_true * _normalized_log(y_pred)).sum(dim=-1)


def sparse_categorical_crossentropy(y_true, y_pred):
    if y_true.dim() == y_pred.dim() and y_true.shape[-1] == 1:
        y_true = y_true.squeeze(-1)
    one_hot = torch.nn.functional.one_hot(y_true.to(torch.int64), y_pred.shape[-1]).to(y_pred.dtype)
    return -(one_hot * _normalized_log(y_pred)).sum(dim=-1)


def binary_crossentropy(y_true, y_pred):
    y_pred = y_pred.clamp(EPSILON, 1.0 - EPSILON)
    bce = y_true * torch.log(y_pred) + (1.0 - y_true) * torch.log(1.0 - y_pred)
    return (-bce).mean(dim=-1)


def mean_squared_error(y_true, y_pred):
    return (y_true - y_pred).square().mean(dim=-1)


LOSSES: Dict[str, Callable] = {
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "mean_squared_error": mean_squared_error,
}


def make_loss(spec) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """A Keras loss by name -> ``loss(y_true, y_pred)``, the
    ``sum_over_batch_size`` reduction of the per-row values."""
    fn = LOSSES.get(spec) if isinstance(spec, str) else None
    if fn is None:
        raise _unsupported(f"the loss {spec!r}")

    def loss(y_true, y_pred):
        values = fn(y_true.to(y_pred.dtype) if spec != "sparse_categorical_crossentropy" else y_true, y_pred)
        return values.sum() / values.numel()

    return loss


# -- fit ------------------------------------------------------------------------


def _to_module_layout(x: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if t.dim() == 4:  # Keras NHWC -> the module's NCHW, channels_last on the card
        t = t.permute(0, 3, 1, 2)
        if t.device.type == "cuda":
            t = t.contiguous(memory_format=torch.channels_last)
    return t


def fit_params(params: Optional[dict]) -> Dict[str, Any]:
    """``kerasFitParams`` with Keras's defaults filled in; another keyword
    raises."""
    params = dict(params or {})
    unknown = set(params) - set(_FIT_KEYS)
    if unknown:
        raise _unsupported(f"fit keywords {sorted(unknown)}")
    out = {"epochs": 1, "batch_size": 32, "shuffle": True, "verbose": 0}
    out.update({k: v for k, v in params.items() if v is not None})
    if out["shuffle"] not in (True, False):
        raise _unsupported(f"shuffle={out['shuffle']!r}")
    return out


def fit(module: KerasModule, x: np.ndarray, y: np.ndarray, optimizer="adam",
        loss="categorical_crossentropy", params: Optional[dict] = None, seed: int = 0) -> Dict[str, list]:
    """``model.compile(optimizer, loss); model.fit(x, y, **params)`` on the
    translated module, where it lives. ``x`` and ``y`` are numpy arrays in
    Keras's layout; batches go to the device one at a time. Returns the
    history: per epoch the mean loss (weighted by batch rows, as Keras's
    loss tracker), the steps, and the seconds (the device synchronized at
    each epoch's end). Float32 stays float32 on the card, backward
    included (``exact_float32``)."""
    cfg = fit_params(params)
    device = next(module.parameters()).device
    trainable = [p for p in module.parameters() if p.requires_grad]
    opt = make_optimizer(optimizer, trainable)
    loss_fn = make_loss(loss)
    n, batch = len(x), int(cfg["batch_size"])
    if n == 0 or len(y) != n:
        raise ValueError(f"fit: {n} inputs and {len(y)} targets")
    steps = math.ceil(n / batch)
    generator = torch.Generator().manual_seed(int(seed))
    module.seed_dropout(seed)
    history: Dict[str, list] = {"loss": [], "steps": [], "epoch_time_s": []}
    module.train()
    try:
        for _ in range(int(cfg["epochs"])):
            order = torch.randperm(n, generator=generator).numpy() if cfg["shuffle"] else np.arange(n)
            total = torch.zeros((), dtype=torch.float64, device=device)
            t0 = time.perf_counter()
            for s in range(steps):
                rows = order[s * batch:(s + 1) * batch]
                xb = _to_module_layout(x[rows], device)
                yb = torch.from_numpy(np.ascontiguousarray(y[rows])).to(device)
                for p in trainable:
                    p.grad = None
                with exact_float32():  # the backward's convolutions too, not TF32
                    out = module(xb)
                    value = loss_fn(yb, out[0] if isinstance(out, (list, tuple)) else out)
                    value.backward()
                opt.step()
                total += value.detach().double() * len(rows)
            epoch_loss = float(total) / n  # waits for the device
            history["loss"].append(epoch_loss)
            history["steps"].append(steps)
            history["epoch_time_s"].append(time.perf_counter() - t0)
            if cfg["verbose"]:
                print(f"epoch {len(history['loss'])}: loss {epoch_loss:.6f}, {steps} steps, "
                      f"{history['epoch_time_s'][-1]:.3f} s")
    finally:
        module.eval()
        for p in trainable:
            p.grad = None
    return history


__all__ = ["Adam", "LOSSES", "OPTIMIZERS", "RMSprop", "SGD", "fit", "fit_params", "make_loss",
           "make_optimizer"]
