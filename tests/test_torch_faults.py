"""The port's fault injection (``sparkdl_tpu_torch/resilience/faults.py``)
against the JAX package's, on the CPU.

A corpus of valid and invalid plans parses to equal rules or to the same
``FaultPlanError``; firing sequences (the ``times`` cap, the seeded ``p=``
coin, claims in ``SPARKDL_FAULT_STATE`` across two "generations") fire on
the same calls in both; the ``{"kind": "fault"}`` events agree; ``plan``
prints the same JSON. Then each of the port's three hook sites fires:
``executor.partition`` (a retried partition), ``feeder.dispatch`` (the
owner's fail-all path, every open handle re-raises) and ``serve.request``
(``raise=torch.cuda.OutOfMemoryError`` fails that request alone and files
one ``{"kind": "oom"}`` event).
"""

import json
import os

import numpy as np
import pytest
import torch

from sparkdl_tpu.resilience import faults as jax_faults
from sparkdl_tpu.resilience.__main__ import main as jax_main
from sparkdl_tpu_torch.resilience import faults
from sparkdl_tpu_torch.resilience.__main__ import main as port_main
from sparkdl_tpu_torch.resilience.policy import RetryPolicy
from sparkdl_tpu_torch.utils.metrics import metrics

MODULES = {"jax": jax_faults, "torch": faults}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("SPARKDL_FAULT_PLAN", "SPARKDL_FAULT_STATE", "SPARKDL_FAULT_SEED",
                 "SPARKDL_OBS_RANK", "SPARKDL_OBS_JSONL"):
        monkeypatch.delenv(name, raising=False)
    faults.reset_state()
    jax_faults.reset_state()
    yield
    faults.reset_state()
    jax_faults.reset_state()


VALID = [
    "rank=1:step=3:crash",
    "partition=4:attempt=0:raise=IOError",
    "site=feeder.dispatch:times=2:raise=RuntimeError",
    "rank=0:step=1:p=0.5:crash",
    "site=serve.request:rank=0:request=6:crash",
    "site=serve.request:raise=torch.cuda.OutOfMemoryError",
    "site=u:times=0:sleep=0.25 ; site=v:exit=3",
    " site=a : raise=KeyError ;; site=b:crash ",
]

INVALID = [
    "",
    ";;",
    "rank=1:step=3",
    "crash:raise=IOError",
    "rank=1:bogusterm:crash",
    "rank=:crash",
    "=1:crash",
    "p=1.5:crash",
    "p=x:crash",
    "times=x:crash",
    "times=-1:crash",
    "sleep=soon",
    "exit=1.5",
    "site=a::crash",
]


def _fields(rule):
    return (rule.index, rule.source, rule.action, rule.arg, rule.match, rule.times, rule.p)


@pytest.mark.parametrize("plan", VALID)
def test_valid_plans_parse_to_equal_rules(plan):
    assert [_fields(r) for r in faults.parse_plan(plan)] == [
        _fields(r) for r in jax_faults.parse_plan(plan)
    ]


@pytest.mark.parametrize("plan", INVALID)
def test_invalid_plans_raise_the_same_error(plan):
    with pytest.raises(jax_faults.FaultPlanError) as ref:
        jax_faults.parse_plan(plan)
    with pytest.raises(faults.FaultPlanError) as ours:
        faults.parse_plan(plan)
    assert str(ours.value) == str(ref.value)
    assert isinstance(ours.value, ValueError)


def test_resolve_exception_by_import_path():
    assert faults._resolve_exception("torch.cuda.OutOfMemoryError") is torch.cuda.OutOfMemoryError
    assert faults._resolve_exception("IOError") is jax_faults._resolve_exception("IOError")
    for bad in ("NotAnError", "os.path", "no.such.module.Err"):
        with pytest.raises(faults.FaultPlanError):
            faults._resolve_exception(bad)


def _pattern(mod, calls):
    """Which of ``calls`` ((site, coords) pairs) raised, as 0/1."""
    out = []
    for site, coords in calls:
        try:
            mod.maybe_fault(site, **coords)
            out.append(0)
        except (IOError, RuntimeError, KeyError):
            out.append(1)
    return out


CALLS = [("u", {"step": s % 4, "partition": s % 3}) for s in range(48)] + [
    ("v", {"step": 1}), ("u", {}), ("w", {"step": 2})
]

SEQUENCES = [
    "site=u:step=2:raise=IOError",
    "site=u:step=2:times=3:raise=IOError",
    "site=u:times=0:p=0.5:raise=IOError",
    "step=1:times=0:p=0.25:raise=RuntimeError;site=u:partition=2:times=2:raise=KeyError",
    "rank=3:times=0:raise=IOError",
]


@pytest.mark.parametrize("seed", [None, "11", "12"])
@pytest.mark.parametrize("plan", SEQUENCES)
def test_firing_sequences_are_equal(plan, seed, monkeypatch):
    monkeypatch.setenv("SPARKDL_FAULT_PLAN", plan)
    monkeypatch.setenv("SPARKDL_OBS_RANK", "3")
    if seed is not None:
        monkeypatch.setenv("SPARKDL_FAULT_SEED", seed)
    patterns = {}
    for name, mod in MODULES.items():
        mod.reset_state()
        patterns[name] = _pattern(mod, CALLS)
    assert patterns["torch"] == patterns["jax"]
    assert sum(patterns["torch"]) > 0


def test_state_dir_claims_hold_across_generations(tmp_path, monkeypatch):
    """Two generations (a reset of the per-process counts, as a relaunch
    gives) against one claim directory each: the times cap holds across
    them in both packages, and the claim files are the same."""
    monkeypatch.setenv("SPARKDL_FAULT_PLAN", "site=u:times=2:raise=IOError;site=v:raise=KeyError")
    result = {}
    for name, mod in MODULES.items():
        state = tmp_path / name
        monkeypatch.setenv("SPARKDL_FAULT_STATE", str(state))
        gens = []
        for _generation in range(2):
            mod.reset_state()
            gens.append(_pattern(mod, [("u", {})] * 3 + [("v", {})] * 2))
        result[name] = (gens, sorted(os.listdir(state)))
    assert result["torch"] == result["jax"]
    gens, claims = result["torch"]
    assert gens == [[1, 1, 0, 1, 0], [0, 0, 0, 0, 0]]
    assert claims == ["claim.0.0", "claim.0.1", "claim.1.0"]


def test_fault_events_and_counter_agree(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARKDL_FAULT_PLAN", "site=u:partition=5:raise=KeyError")
    events = {}
    for name, mod in MODULES.items():
        log = tmp_path / f"{name}.jsonl"
        monkeypatch.setenv("SPARKDL_OBS_JSONL", str(log))
        mod.reset_state()
        with pytest.raises(KeyError, match=r"injected fault \[site=u:partition=5:raise=KeyError\] at u"):
            mod.maybe_fault("u", partition=5, attempt=0)
        rec = json.loads(log.read_text().strip().splitlines()[-1])
        assert rec.pop("pid") == os.getpid() and rec.pop("ts") > 0
        events[name] = rec
    assert events["torch"] == events["jax"]
    assert events["torch"]["kind"] == "fault"
    assert faults.CRASH_EXIT_CODE == jax_faults.CRASH_EXIT_CODE == 77


def test_crash_exits_with_the_crash_code(tmp_path):
    import subprocess
    import sys

    code = ("from sparkdl_tpu_torch.resilience.faults import maybe_fault\n"
            "maybe_fault('serve.request', request=6)\n"
            "print('survived')\n")
    env = dict(os.environ, SPARKDL_FAULT_PLAN="site=serve.request:request=6:crash",
               SPARKDL_FAULT_STATE=str(tmp_path / "claims"),
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    runs = [subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                           text=True, timeout=120) for _ in range(2)]
    assert runs[0].returncode == faults.CRASH_EXIT_CODE and "survived" not in runs[0].stdout
    assert runs[1].returncode == 0 and "survived" in runs[1].stdout  # the claim is spent


@pytest.mark.parametrize("argv", [["plan", "site=u:times=2:p=0.5:raise=IOError;rank=1:crash"],
                                  ["plan", "rank=1:step=3"], ["plan", "p=2:crash"]])
def test_plan_cli_prints_the_same(argv, capsys):
    rc_ref = jax_main(argv)
    ref = capsys.readouterr()
    rc = port_main(argv)
    ours = capsys.readouterr()
    assert (rc, ours.out, ours.err) == (rc_ref, ref.out, ref.err)


# ---------------------------------------------------------------------------
# the port's hook sites
# ---------------------------------------------------------------------------


def test_executor_partition_site_retries(monkeypatch):
    from sparkdl_tpu_torch.runtime.executor import Executor

    monkeypatch.setenv("SPARKDL_FAULT_PLAN", "site=executor.partition:partition=1:attempt=0:raise=IOError")
    before = metrics.counter("faults.injected")
    seen = []
    ex = Executor(max_workers=2, retry_policy=RetryPolicy(max_attempts=3, base_delay_s=0.0))
    out = ex.map_partitions(lambda i, part: seen.append(i) or [x * 2 for x in part], [[1, 2], [3, 4]])
    assert out == [[2, 4], [6, 8]]
    assert metrics.counter("faults.injected") == before + 1
    assert sorted(seen) == [0, 1]  # the fault fired before the body ran


def test_feeder_dispatch_site_takes_the_fail_all_path(monkeypatch):
    from sparkdl_tpu_torch.runtime import feeder

    monkeypatch.setenv("SPARKDL_DEVICE_STAGE", "0")
    monkeypatch.setenv("SPARKDL_FAULT_PLAN", "site=feeder.dispatch:raise=RuntimeError")
    calls = []

    def double(batch):
        calls.append(len(batch))
        return batch * 2.0

    double.device = torch.device("cpu")
    try:
        f = feeder.get_feeder(double, 4, (3,), np.float32, 2)
        outs = [[None] * 4 for _ in range(2)]
        handles = [f.open_handle(o) for o in outs]
        rows = np.arange(6, dtype=np.float32).reshape(2, 3)
        for h in handles:
            f.submit_rows(h, np.arange(2), rows)
        for h in handles:
            f.finish(h)
        for h in handles:
            with pytest.raises(RuntimeError, match="injected fault"):
                h.wait(timeout=30)
        assert calls == []  # the hook fires before the device fn
        # the claim is spent: the reset feeder serves the next handle
        out = [None] * 4
        h = f.open_handle(out)
        f.submit_rows(h, np.arange(2), rows)
        f.finish(h)
        h.wait(timeout=30)
        np.testing.assert_array_equal(np.stack(out[:2]), rows * 2.0)
    finally:
        feeder.shutdown_feeders()


def test_serve_request_site_oom_files_one_event(tmp_path, monkeypatch):
    from sparkdl_tpu_torch.obs import memory
    from sparkdl_tpu_torch.serving import Router
    from sparkdl_tpu_torch.graph.function import ModelFunction

    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("SPARKDL_OBS_JSONL", str(log))
    monkeypatch.setenv("SPARKDL_FAULT_PLAN",
                       "site=serve.request:request=1:raise=torch.cuda.OutOfMemoryError")
    memory.reset()

    def loader(name, mode):
        return ModelFunction(lambda m, x: x * 2.0, torch.nn.Identity(), torch.device("cpu"),
                             input_shape=(3,))

    router = Router(loader=loader, device="cpu").start()
    try:
        rows = np.ones((1, 3), np.float32)
        first = router.submit("m", rows, priority="interactive").result(timeout=60)
        req = router.submit("m", rows, priority="interactive")
        with pytest.raises(torch.cuda.OutOfMemoryError, match="injected fault"):
            req.result(timeout=60)
        third = router.submit("m", rows, priority="interactive").result(timeout=60)
    finally:
        router.close()
        memory.reset()
    np.testing.assert_array_equal(first, rows * 2.0)
    np.testing.assert_array_equal(third, rows * 2.0)
    events = [json.loads(line) for line in log.read_text().splitlines()]
    ooms = [e for e in events if e["kind"] == "oom"]
    assert len(ooms) == 1
    assert ooms[0]["phase"] == "dispatch" and ooms[0]["model"] == "m"
    assert ooms[0]["error"].startswith("OutOfMemoryError: injected fault")
    assert [e["coords"]["request"] for e in events if e["kind"] == "fault"] == [1]
