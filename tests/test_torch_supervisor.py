"""The port's gang supervisor (``sparkdl_tpu_torch/resilience/supervisor.py``)
against the JAX package's, on the CPU.

The ranks are ``sys.executable -c`` one-liners that import nothing heavy
(a beat file is written by hand, in the heartbeat format). Each scenario
runs under both supervisors and their decision events are held equal,
pids and clocks aside: a crash gives one restart and then success; a
stale heartbeat gives a kill and a restart; the restart cap raises
``GangFailedError``; a clean exit of a serving gang relaunches it; a stop
kills the gang; ``resize`` grows and shrinks a live gang. ``supervise
--cmd`` prints the same verdict as the JAX CLI for the same template, and
``supervise --job`` runs the port's batch gang worker on the CPU through a
crashed rank into a gather equal to a fault-free transform.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

from sparkdl_tpu.resilience import supervisor as jax_supervisor
from sparkdl_tpu.resilience.policy import RetryPolicy as JaxRetryPolicy
from sparkdl_tpu_torch.resilience import supervisor
from sparkdl_tpu_torch.resilience.policy import RetryPolicy

PACKAGES = {"jax": (jax_supervisor, JaxRetryPolicy), "torch": (supervisor, RetryPolicy)}

#: rank body: ``plan`` maps "<generation>.<rank>" (or "*.<rank>", or "*")
#: to 'ok', 'crash', 'wedge' (beats once, then hangs) or 'serve' (beats
#: until killed)
RANK = r"""
import json, os, sys, time
gen = int(os.environ["SPARKDL_GANG_GENERATION"]); rank = int(sys.argv[1])
hb, arg = sys.argv[2], sys.argv[3]
plan = json.load(open(arg)) if arg.endswith(".json") else json.loads(arg)
act = plan.get(f"{gen}.{rank}", plan.get(f"*.{rank}", plan.get("*", "ok")))
def beat(done=False):
    if hb == "-":
        return
    os.makedirs(hb, exist_ok=True)
    tmp = os.path.join(hb, f"hb.{rank}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump({"rank": rank, "pid": os.getpid(), "beats": 0, "time": time.time(),
                   "done": done, "generation": gen, "obs": None}, f)
    os.replace(tmp, os.path.join(hb, f"hb.{rank}"))
beat()
if act == "crash":
    sys.exit(3)
if act in ("wedge", "serve"):
    end = time.time() + 60
    while time.time() < end:
        if act == "serve":
            beat()
        time.sleep(0.1)
beat(done=True)
"""


def _launcher(plan, hb_dir=None):
    def launch(rank, generation):
        env = {**os.environ, "SPARKDL_GANG_GENERATION": str(generation)}
        return subprocess.Popen(
            [sys.executable, "-c", RANK, str(rank), hb_dir or "-", json.dumps(plan)],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )

    return launch


def _policy(cls, attempts=4):
    return cls(max_attempts=attempts, base_delay_s=0.01, max_delay_s=0.05, jitter=0.0)


def _strip(events):
    drop = ("pids", "retired_pids")
    return [{k: v for k, v in e.items() if k not in drop} for e in events]


def _both(make_and_run):
    out = {}
    for name, (mod, policy_cls) in PACKAGES.items():
        out[name] = make_and_run(mod, policy_cls)
    return out


def test_crash_gives_one_restart_then_success():
    def run(mod, policy_cls):
        sup = mod.GangSupervisor(_launcher({"0.0": "serve", "0.1": "crash"}), 2,
                                 poll_interval=0.05, restart_policy=_policy(policy_cls),
                                 kill_wait_s=2.0)
        res = sup.run()
        return (res.generations, res.restarts, _strip(res.events))

    out = _both(run)
    assert out["torch"] == out["jax"]
    generations, restarts, events = out["torch"]
    assert (generations, restarts) == (2, 1)
    assert [e["event"] for e in events] == [
        "gang_start", "rank_dead", "gang_killed", "gang_restart", "gang_start", "gang_complete"]
    assert events[1] == {"kind": "supervisor", "event": "rank_dead", "generation": 0, "rank": 1,
                         "returncode": 3}


def test_stale_heartbeat_gives_kill_and_restart(tmp_path):
    def run(mod, policy_cls):
        hb = str(tmp_path / mod.__name__.split(".")[0])
        # rank 0 beats until killed, rank 1 beats once and hangs; the
        # grace covers a slow interpreter start on a loaded machine
        sup = mod.GangSupervisor(_launcher({"0.0": "serve", "0.1": "wedge"}, hb), 2,
                                 heartbeat_dir=hb, stale_after=0.6, grace_s=3.0,
                                 poll_interval=0.05, restart_policy=_policy(policy_cls),
                                 kill_wait_s=2.0)
        res = sup.run()
        return (res.generations, res.restarts, res.ranks_killed, _strip(res.events))

    out = _both(run)
    assert out["torch"] == out["jax"]
    generations, restarts, killed, events = out["torch"]
    assert (generations, restarts, killed) == (2, 1, 2)
    assert {"kind": "supervisor", "event": "rank_stale", "generation": 0, "rank": 1} in events


def test_restart_cap_raises_gang_failed():
    def run(mod, policy_cls):
        sup = mod.GangSupervisor(_launcher({"*": "crash"}), 1, poll_interval=0.05,
                                 restart_policy=_policy(policy_cls, attempts=3))
        with pytest.raises(mod.GangFailedError) as err:
            sup.run()
        return (str(err.value), err.value.history, _strip(sup._events)[-1])

    out = _both(run)
    assert out["torch"] == out["jax"]
    message, history, last = out["torch"]
    assert "restart budget (2 restarts) exhausted" in message
    assert [h["generation"] for h in history] == [0, 1, 2]
    assert last == {"kind": "supervisor", "event": "giving_up", "generation": 2, "restarts": 2}


def test_clean_exit_relaunches_a_serving_gang_and_stop_kills_it():
    def run(mod, policy_cls):
        sup = mod.GangSupervisor(_launcher({"0.0": "ok", "*": "serve"}), 2, poll_interval=0.05,
                                 restart_policy=_policy(policy_cls), complete_on_exit0=False,
                                 kill_wait_s=2.0)
        gens = []
        sup.on_generation = lambda g, procs: gens.append((g, len(procs)))
        t = threading.Thread(target=sup.run, name="sparkdl-test-sup", daemon=True)
        t.start()
        deadline = time.monotonic() + 30
        while len(gens) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.3)
        procs = list(sup._procs)
        sup.request_stop()
        t.join(timeout=30)
        assert not t.is_alive()
        assert all(p.poll() is not None for p in procs)
        return gens, [e["event"] for e in sup._events]

    out = _both(run)
    assert out["torch"] == out["jax"]
    gens, events = out["torch"]
    assert gens == [(0, 2), (1, 2)]
    assert events[-1] == "supervisor_stop"


def test_resize_grows_and_shrinks_a_live_gang():
    def run(mod, policy_cls):
        sup = mod.GangSupervisor(_launcher({"*": "serve"}), 1, poll_interval=0.05,
                                 restart_policy=_policy(policy_cls), complete_on_exit0=False,
                                 kill_wait_s=2.0)
        t = threading.Thread(target=sup.run, name="sparkdl-test-sup", daemon=True)
        t.start()
        deadline = time.monotonic() + 30
        while not sup._procs and time.monotonic() < deadline:
            time.sleep(0.02)
        grown = sup.resize(3)
        shrunk = sup.resize(2)
        time.sleep(0.5)
        sup.request_stop()
        t.join(timeout=30)
        return grown, shrunk, _strip(sup._events)

    out = _both(run)
    assert out["torch"] == out["jax"]
    grown, shrunk, events = out["torch"]
    assert grown == {"from": 1, "to": 3, "generation": 0}
    assert shrunk == {"from": 3, "to": 2, "generation": 0}
    assert [e["event"] for e in events] == ["gang_start", "gang_resize", "gang_resize", "supervisor_stop"]
    with pytest.raises(ValueError):
        supervisor.GangSupervisor(_launcher({}), 1).resize(0)


def test_default_restart_policy_agrees(monkeypatch):
    monkeypatch.setenv("SPARKDL_SUPERVISOR_RETRY_ATTEMPTS", "6")
    monkeypatch.setenv("SPARKDL_SUPERVISOR_RETRY_BASE_MS", "20")
    ours, ref = supervisor.default_restart_policy(), jax_supervisor.default_restart_policy()
    assert (ours.max_attempts, ours.base_delay_s, ours.max_delay_s, ours.jitter) == (
        ref.max_attempts, ref.base_delay_s, ref.max_delay_s, ref.jitter)
    assert [ours.delay_s(i) for i in range(5)] == [ref.delay_s(i) for i in range(5)]


def _cli(package_main, argv):
    return subprocess.run(
        [sys.executable, "-m", package_main, *argv], capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env={**os.environ, "SPARKDL_SUPERVISOR_RETRY_BASE_MS": "10", "JAX_PLATFORMS": "cpu"},
    )


@pytest.mark.parametrize("plan, rc", [({"0.0": "serve", "0.1": "crash"}, 0),
                                      ({"*.0": "serve", "*.1": "crash"}, 1)])
def test_supervise_cmd_cli_same_verdict(plan, rc, tmp_path):
    script = tmp_path / "rank.py"
    script.write_text(RANK)
    plan_file = tmp_path / "plan.json"
    plan_file.write_text(json.dumps(plan))
    template = f"{sys.executable} {script} {{rank}} - {plan_file}"
    argv = ["supervise", "--num-ranks", "2", "--cmd", template, "--max-restarts", "1",
            "--poll-interval", "0.05"]
    ref = _cli("sparkdl_tpu.resilience", argv)
    ours = _cli("sparkdl_tpu_torch.resilience", argv)
    assert (ours.returncode, ref.returncode) == (rc, rc), (ours.stderr, ref.stderr)
    if rc == 0:
        assert json.loads(ours.stdout) == json.loads(ref.stdout) == {
            "supervise": "OK", "generations": 2, "restarts": 1, "ranks_killed": 1}
    else:
        assert json.loads(ours.stderr) == json.loads(ref.stderr.strip().splitlines()[-1])


def test_supervise_job_recovers_a_crashed_rank(tmp_path):
    import numpy as np

    from sparkdl_tpu_torch.dataframe import DataFrame
    from sparkdl_tpu_torch.estimators.logistic_regression import LogisticRegressionModel
    from sparkdl_tpu_torch.persistence import save_stage
    from sparkdl_tpu_torch.worker import gather_results

    rng = np.random.default_rng(5)
    stage = LogisticRegressionModel(
        w=rng.normal(size=(4, 3)).astype(np.float32), b=rng.normal(size=(3,)).astype(np.float32),
        featuresCol="features", predictionCol="pred", probabilityCol=None, device="cpu")
    save_stage(stage, str(tmp_path / "stage"))
    DataFrame.fromColumns({"features": list(rng.normal(size=(30, 4)).astype(np.float32))}, 1) \
        .writeParquet(str(tmp_path / "in.parquet"))
    job = {"stage_path": str(tmp_path / "stage"), "input_parquet": str(tmp_path / "in.parquet"),
           "num_partitions": 6, "output_dir": str(tmp_path / "out"),
           "heartbeat_dir": str(tmp_path / "hb"), "heartbeat_interval": 0.2}
    (tmp_path / "job.json").write_text(json.dumps(job))
    proc = subprocess.run(
        [sys.executable, "-m", "sparkdl_tpu_torch.resilience", "supervise", "--num-ranks", "2",
         "--job", str(tmp_path / "job.json"), "--device", "cpu", "--poll-interval", "0.1"],
        capture_output=True, text=True, timeout=240,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env={**os.environ, "SPARKDL_SUPERVISOR_RETRY_BASE_MS": "10",
             "SPARKDL_FAULT_PLAN": "site=worker.partition:rank=1:step=0:crash",
             "SPARKDL_FAULT_STATE": str(tmp_path / "faults")},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    verdict = json.loads(proc.stdout.strip().splitlines()[-1])
    assert verdict["supervise"] == "OK" and verdict["restarts"] == 1
    got = gather_results(job["output_dir"], 2).collectColumns()
    want = stage.transform(DataFrame.readParquet(job["input_parquet"], 6)).collectColumns()
    assert got["pred"] == want["pred"]
    np.testing.assert_array_equal(np.stack(got["features"]), np.stack(want["features"]))
    # generation 1 finished both ranks; rank 1 crashed before publishing,
    # so it resumed nothing, and rank 0 resumed only its own partitions
    success = [json.loads((tmp_path / "out" / f"_SUCCESS.{r}").read_text()) for r in (0, 1)]
    assert [s["generation"] for s in success] == [1, 1]
    assert set(success[0]["resumed"]) <= {0, 2, 4} and success[1]["resumed"] == []
    with pytest.raises(ValueError, match="module:function"):
        from sparkdl_tpu_torch.worker import _resolve_model_builder

        _resolve_model_builder({"builder": "no_colon"})
    launch = supervisor.worker_launcher(str(tmp_path / "job.json"), 2, device="cpu")
    assert callable(launch)
