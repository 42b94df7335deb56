"""Multi-model device residency: load on demand, LRU-evict under budget.

The port of the JAX package's ``serving/residency.py``. A serving process
fields requests for many named models, but a card holds finite memory.
The first request for a model loads it (builds the ModelFunction at the
request's precision rung and wraps it in the device fn that the feeder
dispatches through) and later requests reuse the resident copy. When
loading one more model would push the resident parameter bytes past
``SPARKDL_SERVE_HBM_BUDGET_MB``, the least-recently-used idle model is
evicted first: its feeder streams are closed
(``runtime.feeder.close_feeders_for``) and the entry drops its module and
device fn, so its parameters leave the card once nothing else holds them.

Two hard rules:

- a model with open streams (requests in flight) is never evicted: a
  pinned model stays, however far over budget the manager is. Pinning is
  refcount-shaped: ``acquire`` pins, ``release`` unpins;
- sizing is honest: the budget compares the parameter and buffer bytes
  of the module actually loaded, so a bf16 rung charges its own bytes.

The registry loader builds straight onto the card, so its victims are
evicted before the build, sized by the registry's estimate; a custom
loader's module is sized once it exists. The budget covers the modules
only: activations, I/O buffers and each feeder thread's cuBLAS workspace
come on top.

Model resolution defaults to the named-model registry on the manager's
device (``cuda`` unless the caller asks for the CPU), with random weights
from ``seed``; any ``loader(name, mode)`` (or ``loader(name, mode,
precision)``) returning a ModelFunction works the same, as in the JAX
package.

Generation: ``mode="generate"`` loads the registry's float32
``BertGenerator`` (never a precision rung; no device fn: the generation
engine drives it), charged by its parameter bytes like any model. Each
admitted generate sequence reserves its KV-cache bytes against the same
budget (:meth:`ResidencyManager.reserve_kv`); a reservation that does not
fit raises :class:`~sparkdl_tpu_torch.serving.request.AdmissionRejected`
(HTTP 429) before anything reaches the device.

Every load and evict is noted in the memory ledger (``obs/memory.py``).
On CUDA a model is charged the bytes ``torch.cuda.memory_allocated``
grew by across its build (``mem.estimate_error.<name>`` publishes the
gap to the module's own parameter bytes), so the budget runs on what the
allocator holds; on the CPU, which has no probe, the module's parameter
bytes. An evict checks that the allocator went back to its count before
the load (the leak check), and a load that fails for memory files an
``{"kind": "oom"}`` event. Each entry carries its registry spec's
analytic FLOPs (``flops_per_item``, and ``flops_fn`` for text), which the
router feeds into ``serve.mfu``.

Not ported yet: mesh widths.
"""

from __future__ import annotations

import inspect
import math
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from sparkdl_tpu_torch.obs import memory as mem_mod
from sparkdl_tpu_torch.runtime import knobs
from sparkdl_tpu_torch.runtime.device import DeviceLike, resolve_device, warm_launcher
from sparkdl_tpu_torch.utils.metrics import metrics


def hbm_budget_bytes() -> Optional[int]:
    """``SPARKDL_SERVE_HBM_BUDGET_MB`` as bytes; None when unset or 0 (no
    budget). Malformed or negative values raise: a fat-fingered budget
    silently meaning "unbounded" is the OOM the knob exists to prevent."""
    try:
        mb = knobs.get_float("SPARKDL_SERVE_HBM_BUDGET_MB")
    except ValueError as e:
        raise ValueError(
            f"{e}: expected a number of megabytes (0/unset disables the budget)"
        ) from None
    if mb is None:
        return None
    if not math.isfinite(mb) or mb < 0:
        raise ValueError(
            "SPARKDL_SERVE_HBM_BUDGET_MB="
            f"{knobs.get_raw('SPARKDL_SERVE_HBM_BUDGET_MB')!r}: expected a "
            "finite, non-negative number of megabytes (0/unset disables "
            "the budget)"
        )
    return int(mb * 2**20) if mb > 0 else None


def _default_loader(
    name: str, mode: str, precision: str = "f32", device=None, seed: int = 0
):
    """Registry-backed loader. ``mode="generate"`` builds the float32
    :class:`~sparkdl_tpu_torch.models.bert.BertGenerator` whatever the
    rung. The ``bf16`` rung builds the module in
    bfloat16 natively (the registry's own precision policy: bf16 convs and
    projections), then stores every floating parameter and buffer in
    bfloat16, norms and embeddings included, as the JAX rung's
    ``apply_precision`` casts every floating leaf; the norms compute in
    float32 by upcasting in their forward (``graph/precision.bf16_rung``,
    which adds the rung's edge casts)."""
    from sparkdl_tpu_torch.graph.precision import bf16_rung
    from sparkdl_tpu_torch.models import get_model

    spec = get_model(name)
    if mode == "generate":
        return spec.generate_function(seed=seed, device=device)
    if precision == "bf16":
        return bf16_rung(spec.model_function(
            mode=mode, dtype=torch.bfloat16, seed=seed, device=device
        ))
    return spec.model_function(mode=mode, seed=seed, device=device)


class ResidentModel:
    """One loaded model: its ModelFunction, its device fn, and what the
    eviction policy reads."""

    __slots__ = (
        "key", "name", "mode", "model_function", "device_fn", "param_bytes",
        "pins", "loads", "last_used", "requests", "precision",
        "flops_per_item", "flops_fn", "mem_charge", "mem_baseline",
    )

    def __init__(
        self, key, name, mode, model_function, device_fn, nbytes,
        precision="f32", flops_per_item=None, flops_fn=None,
    ):
        self.key = key
        self.name = name
        self.mode = mode
        self.model_function = model_function
        self.device_fn = device_fn
        self.param_bytes = int(nbytes)
        self.pins = 0  # in-flight request groups holding this model
        self.loads = 1
        self.last_used = time.monotonic()
        self.requests = 0
        self.precision = precision
        #: the registry spec's analytic forward FLOPs per row, and for
        #: text the per-sequence-length function (None: a custom model)
        self.flops_per_item = float(flops_per_item) if flops_per_item else None
        self.flops_fn = flops_fn
        #: the bytes noted in the memory ledger, and the (ground truth,
        #: tracked) before the load, for the leak check
        self.mem_charge: Optional[int] = None
        self.mem_baseline: Optional[tuple] = None

    @property
    def busy(self) -> bool:
        return self.pins > 0


class ResidencyManager:
    """Thread-safe residency table keyed by ``(model name, mode,
    precision)``.

    ``acquire`` returns a PINNED :class:`ResidentModel`; callers
    ``release`` it when their dispatch completes. Loading happens outside
    the table lock (building ResNet50 must not stall lookups of resident
    models), with a per-key load lock so concurrent first requests build
    once. ``device``: where the default registry loader builds (``cuda``
    by default; raises without one unless ``"cpu"`` is asked for)."""

    def __init__(
        self,
        loader: Optional[Callable] = None,
        budget_bytes: Optional[int] = None,
        device: DeviceLike = None,
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        self._seed = seed
        self._loader = loader
        # custom loaders take (name, mode); precision-aware ones a third
        # parameter. Sniffed once so acquire never TypeErrors mid-request.
        self._loader_takes_precision = False
        if loader is not None:
            try:
                params = inspect.signature(loader).parameters.values()
            except (TypeError, ValueError):
                params = ()
            positional = sum(
                1 for p in params
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            )
            self._loader_takes_precision = positional >= 3 or any(
                p.kind == p.VAR_POSITIONAL for p in params
            )
        self._budget_override = budget_bytes
        self._lock = threading.Lock()
        self._models: Dict[tuple, ResidentModel] = {}
        self._load_locks: Dict[tuple, threading.Lock] = {}
        #: bytes reserved by loads in flight (key -> size): the budget
        #: check counts them beside resident models, so two concurrent
        #: first loads of DIFFERENT models cannot each pass the check and
        #: jointly blow the budget
        self._reserved: Dict[tuple, int] = {}
        #: KV-cache bytes reserved by admitted generate sequences, charged
        #: against the same budget as the parameters
        self._kv_bytes = 0

    def _budget(self) -> Optional[int]:
        if self._budget_override is not None:
            return self._budget_override or None
        return hbm_budget_bytes()

    def budget_bytes(self) -> Optional[int]:
        """The effective budget (constructor override or the knob); None
        = unbounded."""
        return self._budget()

    def _build(self, name: str, mode: str, precision: str):
        if self._loader is None:
            return _default_loader(
                name, mode, precision, device=self.device, seed=self._seed
            )
        if self._loader_takes_precision:
            return self._loader(name, mode, precision)
        return self._loader(name, mode)

    # -- introspection ------------------------------------------------------

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(m.param_bytes for m in self._models.values())

    def models(self) -> List[dict]:
        """Status rows for ``/v1/models``."""
        now = time.monotonic()
        with self._lock:
            return [
                {
                    "name": m.name,
                    "mode": m.mode,
                    "precision": m.precision,
                    "param_mb": round(m.param_bytes / 2**20, 2),
                    "param_bytes": m.param_bytes,
                    "busy": m.busy,
                    "loads": m.loads,
                    "requests": m.requests,
                    "idle_s": round(now - m.last_used, 3),
                }
                for m in self._models.values()
            ]

    def _publish_gauges_locked(self) -> None:
        metrics.gauge("serve.resident_models", len(self._models))
        metrics.gauge(
            "serve.resident_mb",
            sum(m.param_bytes for m in self._models.values()) / 2**20,
        )

    # -- KV-cache reservations (generation) ----------------------------------

    def reserve_kv(self, nbytes: int) -> int:
        """Reserve ``nbytes`` of KV cache against the budget at admission.
        Raises :class:`~sparkdl_tpu_torch.serving.request.AdmissionRejected`
        (HTTP 429, ``gen.kv_rejected``) when resident parameters, loads in
        flight and earlier reservations leave no room: the sequence is
        refused before any device allocation."""
        from sparkdl_tpu_torch.serving.request import AdmissionRejected

        nbytes = int(nbytes)
        budget = self._budget()
        with self._lock:
            if budget is not None:
                used = self._used_locked()
                if used + nbytes > budget:
                    metrics.inc("gen.kv_rejected")
                    raise AdmissionRejected(
                        f"KV-cache reservation of {nbytes / 2**20:.2f} MB "
                        f"refused: HBM budget {budget / 2**20:.1f} MB has "
                        f"{used / 2**20:.1f} MB resident/reserved"
                    )
            self._kv_bytes += nbytes
            metrics.gauge("gen.kv_bytes", self._kv_bytes)
        return nbytes

    def release_kv(self, nbytes: int) -> None:
        """Return a sequence's reservation; floors at zero, so a double
        release opens no phantom room."""
        with self._lock:
            self._kv_bytes = max(0, self._kv_bytes - int(nbytes))
            metrics.gauge("gen.kv_bytes", self._kv_bytes)

    def kv_reserved_bytes(self) -> int:
        with self._lock:
            return self._kv_bytes

    def _used_locked(self, except_key=None) -> int:
        """Resident parameters + loads in flight (but ``except_key``'s own)
        + KV reservations."""
        return (
            sum(m.param_bytes for m in self._models.values())
            + sum(b for k, b in self._reserved.items() if k != except_key)
            + self._kv_bytes
        )

    # -- the acquire/release protocol ---------------------------------------

    def acquire(
        self, name: str, mode: str = "features", precision: Optional[str] = None
    ) -> ResidentModel:
        """The resident entry for ``name`` (loading, and maybe evicting,
        on a miss), pinned against eviction until :meth:`release`. Keys
        are case-folded, as the registry resolves names, so two spellings
        share one resident copy; the precision rung is part of the key."""
        precision = precision or "f32"
        key = (str(name).lower(), str(mode), str(precision))
        with self._lock:
            entry = self._models.get(key)
            if entry is not None:
                entry.pins += 1
                entry.requests += 1
                entry.last_used = time.monotonic()
                return entry
            load_lock = self._load_locks.setdefault(key, threading.Lock())
        with load_lock:
            # double-check: a racing first request may have loaded it
            with self._lock:
                entry = self._models.get(key)
                if entry is not None:
                    entry.pins += 1
                    entry.requests += 1
                    entry.last_used = time.monotonic()
                    return entry
            try:
                entry = self._load(key, name, mode, precision)
                with self._lock:
                    # install and drop the reservation in ONE locked
                    # section: a concurrent budget check never sees the
                    # model both resident and reserved
                    self._models[key] = entry
                    self._reserved.pop(key, None)
                    entry.pins += 1
                    entry.requests += 1
                    self._publish_gauges_locked()
                return entry
            finally:
                with self._lock:  # no-op on success; frees a failed load
                    self._reserved.pop(key, None)

    def release(self, entry: ResidentModel) -> None:
        with self._lock:
            entry.pins = max(0, entry.pins - 1)
            entry.last_used = time.monotonic()

    def _load(self, key, name: str, mode: str, precision: str) -> ResidentModel:
        from sparkdl_tpu_torch.graph.precision import apply_precision
        from sparkdl_tpu_torch.models.registry import param_bytes
        from sparkdl_tpu_torch.obs import span
        from sparkdl_tpu_torch.transformers.execution import model_device_fn

        try:
            with span("serve.model_load", model=name, mode=mode, precision=precision):
                # The default loader builds straight onto the device, so the
                # victims leave BEFORE the build, sized by the registry's
                # estimate: the new parameters land in freed memory, not
                # beside the models they replace.
                estimate = self._estimate_bytes(name, precision)
                if estimate is not None:
                    self._evict_for(key, estimate, loading=name)
                if self.device.type == "cuda":
                    # the launch thread's cuBLAS workspaces outlive every
                    # model: made before the baseline, the leak check does
                    # not read them as this model's residue
                    warm_launcher(self.device)
                truth0, _ = mem_mod.ground_truth()
                tracked0 = mem_mod.tracked_bytes()
                mf = self._build(name, mode, precision)
                generate = mode == "generate"
                if not generate:
                    # the rung's casts apply uniformly: a loader that already
                    # built at the rung (mf.precision) is left alone
                    mf = apply_precision(mf, precision)
                built_on = getattr(mf, "device", None)
                if built_on is not None and torch.device(built_on).type != self.device.type:
                    raise ValueError(
                        f"the loader built {name!r} on {built_on}, but this "
                        f"router serves on {self.device}"
                    )
                # a generator (prefill/decode over its own encoder) has no
                # device fn: the generation engine drives it
                nbytes = mf.param_bytes if generate else param_bytes(mf)
                truth1, _ = mem_mod.ground_truth()
                measured = None
                if truth0 is not None and truth1 is not None and truth1 > truth0:
                    measured = int(truth1 - truth0)
                # the charge is what the allocator holds for the module (its
                # own bytes without a probe): evicts more if the estimate
                # fell short, and replaces its reservation
                charge = nbytes if measured is None else measured
                self._evict_for(key, charge, loading=name)
                device_fn = None if generate else model_device_fn(mf)
        except Exception as e:
            if mem_mod.is_oom_error(e):
                mem_mod.record_oom("load", name, e)
            raise
        metrics.inc("serve.model_loads")
        flops = flops_fn = None
        spec = self._spec(name)
        if spec is not None:
            flops = spec.flops_per_item()
            flops_fn = getattr(spec, "flops_fn", None)
        entry = ResidentModel(
            key, name, mode, mf, device_fn, charge, precision=precision,
            flops_per_item=flops, flops_fn=flops_fn,
        )
        entry.mem_charge = charge
        entry.mem_baseline = (truth0, tracked0)
        mem_mod.note_model_loaded(
            name, charge, estimate_bytes=nbytes if measured is not None else None
        )
        return entry

    @staticmethod
    def _spec(name: str):
        """The registry spec of ``name``, or None (a custom-loader name)."""
        from sparkdl_tpu_torch.models import get_model

        try:
            return get_model(name)
        except ValueError:
            return None

    # -- eviction -----------------------------------------------------------

    def _estimate_bytes(self, name: str, precision: str) -> Optional[int]:
        """The default loader's parameter bytes before it builds: the
        registry's float32 estimate, halved on the bf16 rung (exact: the
        rung stores every parameter and buffer in bfloat16). None for a
        custom loader, whose module is sized once it exists."""
        if self._loader is not None or self._budget() is None:
            return None
        from sparkdl_tpu_torch.models import get_model

        estimate = get_model(name).param_bytes_estimate()
        if estimate is None:
            return None
        return estimate // 2 if precision == "bf16" else estimate

    def _evict_for(self, key, incoming_bytes: int, loading: str) -> None:
        """Make room for ``incoming_bytes`` under the budget by evicting
        LRU idle models, then RESERVE the bytes under ``key`` (replacing an
        earlier reservation of the same load; released when the load lands
        or fails). Raises when the budget cannot be met: the model alone
        exceeds it, or everything resident is busy."""
        budget = self._budget()
        if budget is None:
            return
        while True:
            with self._lock:
                used = self._used_locked(except_key=key)
                if used + incoming_bytes <= budget:
                    self._reserved[key] = incoming_bytes
                    return
                idle = [m for m in self._models.values() if not m.busy]
                if not idle:
                    raise RuntimeError(
                        f"cannot load model {loading!r} "
                        f"({incoming_bytes / 2**20:.1f} MB): HBM budget "
                        f"{budget / 2**20:.1f} MB has {used / 2**20:.1f} MB "
                        "resident/reserved and nothing idle to evict (open "
                        "streams or loads in flight)"
                    )
                victim = min(idle, key=lambda m: m.last_used)
                del self._models[victim.key]
                self._publish_gauges_locked()
            self._close_entry(victim)
            metrics.inc("serve.evictions")

    @staticmethod
    def _close_entry(victim: ResidentModel) -> int:
        """Close the victim's feeder streams, drop its module and device fn
        (the entry must not be what keeps the parameters alive), return its
        charge to the memory ledger and check for a leak."""
        from sparkdl_tpu_torch.runtime.feeder import close_feeders_for

        closed = 0 if victim.device_fn is None else close_feeders_for(victim.device_fn)
        victim.model_function = None
        victim.device_fn = None
        if victim.mem_charge is not None:
            mem_mod.note_model_evicted(victim.name, victim.mem_charge)
            victim.mem_charge = None
        if victim.mem_baseline is not None:
            mem_mod.leak_check(victim.name, *victim.mem_baseline)
            victim.mem_baseline = None
        return closed

    def unload_all(self) -> None:
        """Evict everything (shutdown, drain, tests); busy models too: the
        router guarantees nothing is in flight when it calls this."""
        with self._lock:
            victims = list(self._models.values())
            self._models.clear()
            self._publish_gauges_locked()
        for v in victims:
            self._close_entry(v)


__all__ = ["ResidencyManager", "ResidentModel", "hbm_budget_bytes"]
