"""The port's gang heartbeats (``sparkdl_tpu_torch/runtime/heartbeat.py``)
against the JAX package's, on the CPU, in one process.

A gang directory is written by one package's :class:`Heartbeat` (a rank
beating, a rank that exited cleanly, a rank whose beat went stale, a rank
of an earlier generation, a missing rank, a torn file) and read by both
packages: ``stale_ranks``, ``rank_status`` and the CLI's ``--json``
verdict agree, whichever package wrote the files (beat ages aside, which
move with the clock between two reads).
"""

import json
import os
import time

import pytest

from sparkdl_tpu.runtime import heartbeat as jax_heartbeat
from sparkdl_tpu_torch.runtime import heartbeat

PACKAGES = {"jax": jax_heartbeat, "torch": heartbeat}
NUM_RANKS = 6
STALE_AFTER = 30.0


def _age(path, seconds):
    t = time.time() - seconds
    os.utime(path, (t, t))


def _write_gang(writer, directory, generation=1):
    """rank 0 beating, 1 done, 2 stale, 3 an earlier generation's, 4
    missing, 5 torn."""
    with writer.Heartbeat(directory, 0, interval=60.0, generation=generation):
        pass  # exits cleanly: writes done -> rewritten below as beating
    beating = writer.Heartbeat(directory, 0, interval=60.0, generation=generation)
    beating._write()
    with writer.Heartbeat(directory, 1, interval=60.0, generation=generation):
        pass
    stale = writer.Heartbeat(directory, 2, interval=60.0, generation=generation)
    stale._write()
    _age(os.path.join(directory, "hb.2"), 120)
    old = writer.Heartbeat(directory, 3, interval=60.0, generation=generation - 1)
    old._write()
    with open(os.path.join(directory, "hb.5"), "w") as f:
        f.write('{"rank": 5, "pid"')


def _strip(statuses):
    return [{k: v for k, v in st.items() if k not in ("age_s", "pid")} for st in statuses]


@pytest.mark.parametrize("generation", [None, 1, 2])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_verdicts_agree_across_writers(writer, generation, tmp_path):
    _write_gang(PACKAGES[writer], str(tmp_path))
    verdicts = {
        name: (
            mod.stale_ranks(str(tmp_path), NUM_RANKS, STALE_AFTER, generation=generation),
            _strip(mod.rank_status(str(tmp_path), NUM_RANKS, STALE_AFTER, generation=generation)),
        )
        for name, mod in PACKAGES.items()
    }
    assert verdicts["torch"] == verdicts["jax"]
    status = {st["rank"]: st["status"] for st in verdicts["torch"][1]}
    if generation == 1:
        assert status == {0: "ok", 1: "done", 2: "stale", 3: "missing", 4: "missing", 5: "ok"}
    elif generation == 2:  # every readable beat is an earlier generation's
        assert [status[r] for r in range(5)] == ["missing"] * 5
    else:
        assert status[3] == "ok" and status[1] == "done"


@pytest.mark.parametrize("extra", [[], ["--generation", "1"], ["--obs"]])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cli_json_agrees(writer, extra, tmp_path, capsys):
    _write_gang(PACKAGES[writer], str(tmp_path))
    argv = ["--dir", str(tmp_path), "--num-ranks", str(NUM_RANKS),
            "--stale-after", str(STALE_AFTER), "--json", *extra]
    out = {}
    for name, mod in PACKAGES.items():
        rc = mod.main(argv)
        payload = json.loads(capsys.readouterr().out)
        payload["ranks"] = _strip(payload["ranks"])
        payload.pop("stage_divergence", None)  # the JAX CLI's snapshot extra
        if "obs" in payload:
            # each rank's last obs payload is its writer's, read as it is
            payload["obs"] = sorted(payload["obs"])
        out[name] = (rc, payload)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == 1 and 2 in out["torch"][1]["stale_ranks"]


def test_beat_payload_and_thread(tmp_path):
    hb = heartbeat.Heartbeat(str(tmp_path), 7, interval=0.05, generation=3)
    with hb:
        time.sleep(0.3)
        with open(tmp_path / "hb.7") as f:
            beat = json.load(f)
        assert beat["rank"] == 7 and beat["generation"] == 3 and not beat["done"]
        assert beat["pid"] == os.getpid() and beat["beats"] >= 2
        assert set(beat["obs"]) == {"active", "counters"}
    with open(tmp_path / "hb.7") as f:
        assert json.load(f)["done"] is True
    assert hb._thread is not None and not hb._thread.is_alive()
    assert heartbeat.last_obs(str(tmp_path), 7)["counters"] is not None
    assert heartbeat.last_obs(str(tmp_path), 8) is None


def test_open_spans_ride_the_beat(tmp_path):
    from sparkdl_tpu_torch.obs import span

    hb = heartbeat.Heartbeat(str(tmp_path), 0, interval=60.0)
    with span("serve.dispatch", model="m"):
        hb._write()
    active = heartbeat.last_obs(str(tmp_path), 0)["active"]
    assert [a["name"] for a in active] == ["serve.dispatch"]
    assert active[0]["attrs"] == {"model": "m"}


def test_dying_by_exception_leaves_the_beat_to_go_stale(tmp_path):
    with pytest.raises(RuntimeError):
        with heartbeat.Heartbeat(str(tmp_path), 0, interval=60.0):
            raise RuntimeError("rank died")
    with open(tmp_path / "hb.0") as f:
        assert json.load(f)["done"] is False
    _age(str(tmp_path / "hb.0"), 120)
    assert heartbeat.stale_ranks(str(tmp_path), 1, STALE_AFTER) == [0]
