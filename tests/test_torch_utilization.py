"""The port's utilization ledger (``sparkdl_tpu_torch/obs/utilization.py``)
and FLOP counts against the JAX package's, on the CPU.

One sequence of ``note_busy`` / ``note_transfer`` / ``note_flops`` with
explicit clocks goes into both ledgers; the per-device views and the
``util.*`` counters agree within 1e-9, ``busy + idle`` equals the wall by
construction, and ``serve.mfu`` stays unset on the CPU in both packages
(no known peak). Under a device named as an H100 the port's gauge is the
same arithmetic over the H100's bf16 peak, published unclamped. The
port's view also names what its busy measures (``busy_source``: host
dispatch occupancy), a key the JAX view lacks. The registry's text FLOPs
equal the JAX package's formula exactly; image FLOPs are counted on the
port's modules (2 x ``bench_bounds.model_macs``), where the JAX package
keeps a table of published GMACs, so they agree within relative 0.07:
ResNet50's published 4.09 GMACs are 6.0% above the 3.858 G the module's
convolutions and head multiply-accumulate.
"""

import math

import numpy as np
import pytest
import torch

from sparkdl_tpu.models import get_model as jax_get_model
from sparkdl_tpu.obs import utilization as jax_util
from sparkdl_tpu.utils import flops as jax_flops
from sparkdl_tpu.utils.metrics import metrics as jax_metrics
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.models import get_model
from sparkdl_tpu_torch.obs import utilization
from sparkdl_tpu_torch.runtime import feeder
from sparkdl_tpu_torch.serving import Router
from sparkdl_tpu_torch.utils import flops
from sparkdl_tpu_torch.utils.metrics import metrics

TOL = 1e-9
T0 = 100.0
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _env():
    for mod in (utilization, jax_util):
        mod.reset()
    yield
    for mod in (utilization, jax_util):
        mod.reset()
    feeder.shutdown_feeders()


def _sequence(seed=0):
    rng = np.random.default_rng(seed)
    out, t = [], T0
    for i in range(60):
        t += float(rng.uniform(0.001, 0.05))
        kind = ("busy", "busy", "h2d", "d2h", "flops")[i % 5]
        out.append((t, kind, float(rng.uniform(0.0, 0.06)), float(rng.uniform(1e9, 1e11))))
    return out


def _replay(ledger, registry):
    """The sequence into the port's ledger, or into the JAX ledger (whose
    notes take a device fn first: None, one device). The port's status
    names what its busy measures (``busy_source``); the JAX one has no
    such key, so the views are compared without it."""
    ref = isinstance(ledger, jax_util.DeviceLedger)
    fn = (None,) if ref else ()
    before = dict(registry.snapshot()["counters"])
    views = []
    for i, (t, kind, dt, fl) in enumerate(_sequence()):
        if kind == "busy":
            ledger.note_busy(*fn, dt, now=t)
        elif kind == "h2d":
            ledger.note_transfer(*fn, h2d_s=dt, now=t)
        elif kind == "d2h":
            ledger.note_transfer(*fn, d2h_s=dt, now=t)
        else:
            ledger.note_flops(fl, now=t)
        if i % 6 == 5:
            view = ledger.status(now=t + 0.01)
            if not ref:
                assert view.pop("busy_source") == utilization.BUSY_SOURCE
            views.append(view)
    after = registry.snapshot()["counters"]
    counters = {k: after[k] - before.get(k, 0.0) for k in after if k.startswith("util.")}
    return views, counters


def _close(a, b, path="$"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert math.isclose(a, b, rel_tol=0, abs_tol=TOL), (path, a, b)


def test_ledgers_agree_on_one_sequence(monkeypatch):
    metrics.reset()  # the registries are process-global: start both empty
    jax_metrics.reset()
    ours, ref = utilization.DeviceLedger(), jax_util.DeviceLedger()
    mfu_before = metrics.gauge_stats("serve.mfu"), jax_metrics.gauge_stats("serve.mfu")
    ours_views, ours_counters = _replay(ours, metrics)
    ref_views, ref_counters = _replay(ref, jax_metrics)
    # no device peak on the CPU: neither package publishes an MFU
    assert (metrics.gauge_stats("serve.mfu"), jax_metrics.gauge_stats("serve.mfu")) == mfu_before
    _close(ours_views, ref_views)
    _close(ours_counters, ref_counters)
    for view in ours_views:
        for dev in view["devices"].values():
            assert math.isclose(dev["busy_ms"] + dev["idle_ms"], dev["wall_ms"], abs_tol=2e-3)
    assert sorted(ours_views[-1]["devices"]) == ["0"]
    assert flops.device_peak_flops(flops.local_device_kind() or "") is None
    assert jax_flops.device_peak_flops(jax_flops.local_device_kind() or "") is None


def test_mfu_under_an_h100(monkeypatch):
    """The same FLOPs over the same window: the port's gauge against the
    H100's bf16 peak equals the JAX ledger's against a TPU v5e's, scaled
    by the peaks' ratio."""
    monkeypatch.setattr(utilization, "_local_device_kind", lambda: H100)
    monkeypatch.setattr(jax_util, "_local_device_kind", lambda: "TPU v5 lite")
    gauges = []
    for mod, registry in ((utilization, metrics), (jax_util, jax_metrics)):
        ledger = mod.DeviceLedger()
        for i in range(10):
            ledger.note_flops(5e12, now=T0 + 0.5 * i)
        gauges.append(registry.gauge_stats("serve.mfu")["last"])
        ledger.note_busy(*((None,) if mod is jax_util else ()), 0.1, now=T0 + 5)
        assert ledger.status(now=T0 + 5)["mfu"] == gauges[-1]
    peak = flops.device_peak_flops(H100)
    assert peak == 989e12 and flops.device_peak_flops("NVIDIA A100-SXM4-80GB") is None
    assert math.isclose(gauges[0] * peak, gauges[1] * jax_flops.device_peak_flops("TPU v5 lite"), rel_tol=1e-12)
    assert math.isclose(gauges[0], 10 * 5e12 / 4.5 / peak, rel_tol=1e-12)
    assert flops.mfu(1e9, 100.0, H100) == 1e11 / peak and flops.mfu(1e9, 100.0, "cpu") is None


def test_mfu_past_the_peak_shows(monkeypatch):
    """The port publishes the gauge as computed: a FLOP count that claims
    more than the peak reads above 1 (the JAX package clamps it to 1)."""
    monkeypatch.setattr(utilization, "_local_device_kind", lambda: H100)
    peak = flops.device_peak_flops(H100)
    ledger = utilization.DeviceLedger()
    ledger.note_flops(3 * peak, now=T0)
    ledger.note_flops(3 * peak, now=T0 + 2.0)
    assert math.isclose(metrics.gauge_stats("serve.mfu")["last"], 6 * peak / 2.0 / peak, rel_tol=1e-12)


@pytest.mark.parametrize("name,size", [("bert-base", "base"), ("bert-tiny", "tiny"), ("bert-long-2048", "long")])
def test_text_flops_equal_jax_exactly(name, size):
    ours, ref = get_model(name), jax_get_model(name)
    for seq_len in (1, 16, 128, 200, ours.max_length):
        assert ours.flops_fn(seq_len) == ref.flops_fn(seq_len)
    assert ours.flops_per_item() == ref.flops_per_item()
    assert flops.bert_size_flops_per_example("tiny", 64) == jax_flops.bert_size_flops_per_example("tiny", 64)
    assert flops.bert_flops_per_example(512) == jax_flops.bert_flops_per_example(512)


@pytest.mark.parametrize("name", ["ResNet50", "InceptionV3", "Xception", "VGG16", "VGG19", "MobileNetV2"])
def test_image_flops_within_the_published_figures(name):
    ours = get_model(name).flops_per_item()
    ref = jax_flops.model_flops_per_image(name)
    assert abs(ours - ref) / ours <= 0.07, (name, ours, ref)
    assert ours == get_model(name).flops_per_item()  # computed once, cached


ROW = 8


def test_router_notes_busy_time_and_no_mfu_on_the_cpu():
    """A registry name would carry FLOPs; this custom model carries none,
    and on the CPU no FLOPs would become a gauge anyway."""
    w = torch.nn.Module()
    w.w = torch.nn.Parameter(torch.ones(ROW, 4))

    def loader(name, mode):
        return ModelFunction(lambda m, x: x @ m.w, w, torch.device("cpu"), name=name, input_shape=(ROW,))

    mfu_before = metrics.gauge_stats("serve.mfu")
    router = Router(loader=loader, device="cpu")
    try:
        for _ in range(4):
            router.submit("m", np.ones((2, ROW), np.float32)).result(timeout=60)
        status = router.stats()["utilization"]
    finally:
        router.close()
    dev = status["devices"]["0"]
    assert dev["busy_ms"] > 0 and 0 < status["busy_frac"] <= 1
    assert metrics.gauge_stats("serve.mfu") == mfu_before  # nothing published on the CPU
    assert math.isclose(dev["busy_ms"] + dev["idle_ms"], dev["wall_ms"], abs_tol=2e-3)


def _host_bound_loop(ledger, card_share=0.05, steps=50, dt=0.1):
    """A loop whose host dispatch wall fills every interval (occupancy
    near 1) while the injected NVML probe reads ``card_share`` of the
    wall as kernel-busy."""
    clock = {"t": T0}
    probe = lambda: card_share * (clock["t"] - T0)  # noqa: E731 — cumulative busy s
    ledger.set_busy_probe(probe)
    for _ in range(steps):
        clock["t"] += dt
        ledger.note_busy(dt, now=clock["t"])
    return clock["t"]


def test_busy_is_the_cards_share_under_an_nvml_probe():
    ledger = utilization.DeviceLedger(busy_probe=None)
    end = _host_bound_loop(ledger, card_share=0.05)
    view = ledger.status(now=end)
    assert view["busy_source"] == "nvml" == utilization.NVML_SOURCE
    assert abs(view["busy_frac"] - 0.05) < 1e-3
    assert abs(metrics.gauge_stats("util.busy_frac")["last"] - 0.05) < 1e-3
    dev = view["devices"]["0"]
    assert abs(dev["busy_ms"] + dev["idle_ms"] - dev["wall_ms"]) < 1e-3
    # the same loop without a card probe reads the host dispatch wall: near 1
    host = utilization.DeviceLedger(busy_probe=None)
    t = T0
    for _ in range(50):
        t += 0.1
        host.note_busy(0.1, now=t)
    assert host.status(now=t)["busy_source"] == "host_dispatch"
    assert host.status(now=t)["busy_frac"] > 0.95


def test_nvml_that_cannot_open_on_a_card_is_an_error(monkeypatch):
    import ctypes

    def no_lib(*a, **k):
        raise OSError("libnvidia-ml.so.1: cannot open shared object file")

    monkeypatch.setattr(ctypes, "CDLL", no_lib)
    with pytest.raises(RuntimeError, match="NVML"):
        utilization.NvmlBusyProbe(0)
    # a ledger on a machine with a card resolves NVML at its first note and
    # raises there, never falling back to the host dispatch wall
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="libnvidia-ml"):
        utilization.DeviceLedger().note_busy(0.01, now=T0)


class _FakeNvml:
    """``libnvidia-ml.so.1`` as far as :class:`NvmlBusyProbe` calls it:
    every read returns ``gpu`` percent, or ``fail`` as its error code."""

    def __init__(self, gpu):
        self.gpu, self.fail, self.reads = gpu, 0, 0
        self.nvmlErrorString = lambda rc: b"fake NVML error"

    def nvmlInit_v2(self):
        return 0

    def nvmlDeviceGetHandleByPciBusId_v2(self, bus_id, handle):
        self.bus_id = bus_id
        return 0

    def nvmlDeviceGetUtilizationRates(self, handle, rates):
        self.reads += 1
        if self.fail:
            return self.fail
        rates._obj.gpu = self.gpu
        return 0


def _wait(cond, timeout=10.0):
    import time

    end = time.monotonic() + timeout
    while not cond() and time.monotonic() < end:
        time.sleep(0.005)
    return cond()


def test_nvml_probe_integrates_the_polled_rate_and_raises_a_failed_poll(monkeypatch):
    import ctypes
    import time
    import types

    lib = _FakeNvml(gpu=40)
    monkeypatch.setattr(ctypes, "CDLL", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: types.SimpleNamespace(
        pci_bus_id=0x1B, pci_domain_id=0, pci_device_id=0))
    t0 = time.monotonic()
    probe = utilization.NvmlBusyProbe(0, poll_s=0.005)
    assert lib.bus_id == b"00000000:1b:00.0"
    assert _wait(lambda: lib.reads >= 6 and probe() > 0)
    busy = probe()
    # 40 % of the wall polled so far, never more
    assert 0 < busy <= 0.4 * (time.monotonic() - t0) + 1e-9
    # a read that fails later is raised by the next call, never a frozen busy
    lib.fail = 999
    with pytest.raises(RuntimeError, match="NVML polling stopped.*nvmlDeviceGetUtilizationRates"):
        _wait(lambda: probe() < 0, timeout=5.0)
    assert _wait(lambda: not probe._thread.is_alive())


def test_nvml_probe_refused_at_its_first_read_is_an_error(monkeypatch):
    import ctypes
    import types

    lib = _FakeNvml(gpu=0)
    lib.fail = 3  # NVML_ERROR_NOT_SUPPORTED
    monkeypatch.setattr(ctypes, "CDLL", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: types.SimpleNamespace(
        pci_bus_id=0x1B, pci_domain_id=0, pci_device_id=0))
    with pytest.raises(RuntimeError, match=r"NVML nvmlDeviceGetUtilizationRates failed \(3"):
        utilization.NvmlBusyProbe(0)


def test_a_probe_stepping_slower_than_the_notes_loses_no_busy():
    """NVML is polled every 50 ms while a busy card's dispatches note every
    10 ms: each probe step lands in one 10 ms gap, and what that gap cannot
    hold is credited at the next notes, so the share stays the card's."""
    clock = {"t": T0}
    share, poll, dt = 0.9, 0.05, 0.01
    ledger = utilization.DeviceLedger(busy_probe=None)
    # cumulative busy as a poller sees it: integrated at its last poll
    ledger.set_busy_probe(lambda: share * poll * math.floor((clock["t"] - T0) / poll + 1e-9))
    for _ in range(500):
        clock["t"] += dt
        ledger.note_busy(dt, now=clock["t"])
    view = ledger.status(now=clock["t"])
    assert abs(view["busy_frac"] - share) < 0.01
    dev = view["devices"]["0"]
    assert abs(dev["busy_ms"] + dev["idle_ms"] - dev["wall_ms"]) < 1e-3
