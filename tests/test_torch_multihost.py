"""The port's ``repro_torch.dist`` multi-process surface, class for class
the twin of ``tests/test_multihost.py``: ``init_from_env``'s env contract
and retry (an ``init_process_group`` seam), the heartbeat mailboxes and
the monitor feeder, per-rank shard checkpoints (layout, commit barrier,
manifest-skew errors, the schema-1 reader), and real two-process gloo
pairs over a loopback coordinator (``REPRO_COORDINATOR``): per-rank shard
files, cross-process straggler flagging, SIGKILL detected through the
heartbeat, bit-exact resume, and an elastic 2 -> 1 restore.

Tolerance: none; every restored array is bit-equal."""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.dist import multihost
from repro_torch.dist.fault import CheckpointError, CheckpointManager
from repro_torch.dist.heartbeat import RING, FileMailbox, LocalMailbox, MonitorFeeder, open_mailbox
from repro_torch.dist.monitor import StepMonitor
from torch_ranks import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_multihost_state():
    multihost._reset_for_tests()
    yield
    multihost._reset_for_tests()


class TestInitFromEnv:
    def test_no_coordinator_is_a_single_process_noop(self, monkeypatch):
        monkeypatch.delenv("REPRO_COORDINATOR", raising=False)
        info = multihost.init_from_env()
        assert info == multihost.ProcessInfo(0, 1, None, False)
        assert not info.is_multiprocess

    def test_idempotent(self, monkeypatch):
        monkeypatch.delenv("REPRO_COORDINATOR", raising=False)
        a = multihost.init_from_env()
        b = multihost.init_from_env(coordinator="ignored:1234", num_processes=4)
        assert a is b

    def test_env_contract_parsed(self, monkeypatch):
        calls = []

        def fake_init(**kw):
            calls.append(kw)

        monkeypatch.setenv("REPRO_COORDINATOR", "10.0.0.1:8476")
        monkeypatch.setenv("REPRO_NUM_PROCESSES", "2")
        monkeypatch.setenv("REPRO_PROCESS_ID", "0")
        info = multihost.init_from_env(backend="gloo", _initialize=fake_init)
        assert len(calls) == 1
        assert calls[0]["init_method"] == "tcp://10.0.0.1:8476"
        assert calls[0]["world_size"] == 2
        assert calls[0]["rank"] == 0
        assert calls[0]["backend"] == "gloo"
        assert calls[0]["timeout"].total_seconds() >= 1
        assert info.initialized and info.coordinator == "10.0.0.1:8476"

    def test_retries_transient_failures_with_backoff(self):
        calls = []

        def flaky_init(**kw):
            calls.append(kw)
            if len(calls) < 3:
                raise RuntimeError("connection refused")

        info = multihost.init_from_env(
            coordinator="127.0.0.1:1", num_processes=2, process_id=0,
            timeout=30.0, backoff=0.01, _initialize=flaky_init)
        assert len(calls) == 3
        assert info.initialized

    def test_timeout_raises_descriptively(self):
        def dead_init(**kw):
            raise RuntimeError("no route to host")

        with pytest.raises(TimeoutError, match=r"127\.0\.0\.1:9"):
            multihost.init_from_env(
                coordinator="127.0.0.1:9", num_processes=2, process_id=1,
                timeout=0.15, backoff=0.02, _initialize=dead_init)

    def test_bad_process_id_rejected(self):
        with pytest.raises(ValueError, match="out of range"):
            multihost.init_from_env(coordinator="h:1", num_processes=2, process_id=5)

    def test_process_info_fallback(self):
        info = multihost.process_info()
        assert info.process_index == 0 and info.process_count >= 1

    def test_cuda_request_without_a_card_raises(self, monkeypatch):
        # no silent CPU run: the launchers' device defaults to the card
        monkeypatch.delenv(multihost.ENV_DEVICE, raising=False)
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            multihost.launch_device()
        monkeypatch.setenv(multihost.ENV_DEVICE, "cpu")
        assert multihost.launch_device().type == "cpu"


class TestMailbox:
    def test_file_roundtrip_and_liveness_only_beat(self, tmp_path):
        mb = FileMailbox(str(tmp_path), host=3)
        mb.beat(now=10.0)
        mb.beat(step=0, step_time=0.5, tokens=100.0, now=11.0)
        beats = mb.read()
        assert set(beats) == {3}
        b = beats[3]
        assert b.time == 11.0
        assert b.steps == [{"step": 0, "step_time": 0.5, "tokens": 100.0}]

    def test_ring_is_bounded(self, tmp_path):
        mb = FileMailbox(str(tmp_path), host=0)
        for s in range(RING + 10):
            mb.beat(step=s, step_time=0.1, now=float(s))
        steps = [r["step"] for r in mb.read()[0].steps]
        assert len(steps) == RING
        assert steps[-1] == RING + 9

    def test_unparseable_files_skipped(self, tmp_path):
        mb = FileMailbox(str(tmp_path), host=0)
        mb.beat(now=1.0)
        (tmp_path / "host1.json").write_text("{not json")
        (tmp_path / "hostX.json").write_text("{}")
        assert set(mb.read()) == {0}

    def test_two_writers_one_reader(self, tmp_path):
        a = FileMailbox(str(tmp_path), host=0)
        b = FileMailbox(str(tmp_path), host=1)
        a.beat(step=0, step_time=0.1, now=5.0)
        b.beat(step=0, step_time=0.2, now=6.0)
        beats = a.read()
        assert beats[0].steps[0]["step_time"] == 0.1
        assert beats[1].steps[0]["step_time"] == 0.2

    def test_local_mailbox_same_interface(self):
        mb = LocalMailbox(host=0)
        mb.beat(step=2, step_time=0.3, now=1.0)
        assert mb.read()[0].steps[-1]["step"] == 2

    def test_open_mailbox_dispatch(self, tmp_path):
        assert isinstance(open_mailbox(str(tmp_path), host=0), FileMailbox)
        assert isinstance(open_mailbox(None), LocalMailbox)

    def test_mailbox_file_format_shared_with_the_reference(self, tmp_path):
        from repro.dist.heartbeat import FileMailbox as RefMailbox

        FileMailbox(str(tmp_path), host=0).beat(step=4, step_time=0.25, tokens=8.0, now=3.0)
        RefMailbox(str(tmp_path), host=1).beat(step=4, step_time=0.5, tokens=8.0, now=4.0)
        mine, ref = FileMailbox(str(tmp_path), host=0).read(), RefMailbox(str(tmp_path), 0).read()
        assert sorted(mine) == sorted(ref) == [0, 1]
        for h in (0, 1):
            assert (mine[h].time, mine[h].steps) == (ref[h].time, ref[h].steps)


class TestMonitorFeeder:
    def test_feeds_only_complete_rows_in_order(self, tmp_path):
        mon = StepMonitor(num_hosts=2, min_records=1)
        a = FileMailbox(str(tmp_path), host=0)
        b = FileMailbox(str(tmp_path), host=1)
        feeder = MonitorFeeder(mon, FileMailbox(str(tmp_path), host=0))
        a.beat(step=0, step_time=0.1, tokens=10.0, now=1.0)
        a.beat(step=1, step_time=0.1, tokens=10.0, now=2.0)
        assert feeder.poll() == []
        b.beat(step=0, step_time=0.4, tokens=10.0, now=2.5)
        assert feeder.poll() == [0]
        b.beat(step=1, step_time=0.4, tokens=10.0, now=3.0)
        assert feeder.poll() == [1]
        assert feeder.poll() == []
        assert mon.flagged_hosts() == [1]

    def test_ring_covers_a_slow_poller(self, tmp_path):
        mon = StepMonitor(num_hosts=2, min_records=1)
        a = FileMailbox(str(tmp_path), host=0)
        b = FileMailbox(str(tmp_path), host=1)
        for s in range(5):
            a.beat(step=s, step_time=0.1, now=float(s))
            b.beat(step=s, step_time=0.1, now=float(s))
        feeder = MonitorFeeder(mon, a)
        assert feeder.poll() == [0, 1, 2, 3, 4]

    def test_dead_host_detected_without_any_complete_row(self, tmp_path):
        mon = StepMonitor(num_hosts=2, min_records=1, heartbeat_timeout=1.0)
        a = FileMailbox(str(tmp_path), host=0)
        feeder = MonitorFeeder(mon, a)
        a.beat(now=101.5)
        feeder.poll()
        assert mon.dead_hosts(now=102.0) == []
        a.beat(now=103.0)
        feeder.poll()
        assert mon.dead_hosts(now=103.5) == [1]
        FileMailbox(str(tmp_path), host=1).beat(now=104.0)
        feeder.poll()
        assert mon.dead_hosts(now=104.5) == [0]

    def test_summary_equals_the_reference_monitor(self):
        from repro.dist.monitor import StepMonitor as RefMonitor

        rng = np.random.default_rng(3)
        mine, ref = StepMonitor(num_hosts=3, min_records=2), RefMonitor(num_hosts=3, min_records=2)
        for s in range(9):
            t = rng.uniform(0.05, 0.2, 3) * (1, 1, 2)
            mine.record(t, tokens=96.0, now=float(s))
            ref.record(t, tokens=96.0, now=float(s))
        sm, sr = mine.summary(), ref.summary()
        sm.pop("dead_hosts"), sr.pop("dead_hosts")
        assert sm == sr
        assert mine.summary_rows() == ref.summary_rows()
        assert mine.to_markdown() == ref.to_markdown()


def _tree():
    return {
        "w": torch.arange(24, dtype=torch.float32).reshape(4, 6),
        "b": torch.full((3,), 2.5, dtype=torch.float32),
        "n": np.int64(7),
    }


def _equal(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


class TestCheckpointLayout:
    def test_per_rank_files_no_legacy_blob(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(1, _tree(), extra={"step": 1})
        d = tmp_path / "step_00000001"
        assert sorted(os.listdir(d)) == ["data.rank0.bin", "manifest.json"]
        man = json.loads((d / "manifest.json").read_text())
        assert man["schema"] == 2
        assert man["topology"]["processes"] == 1
        assert man["files"]["0"]["name"] == "data.rank0.bin"
        assert man["files"]["0"]["nbytes"] == os.path.getsize(d / "data.rank0.bin")

    def test_roundtrip_and_restore_stats(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        t = _tree()
        mgr.save(3, t, extra={"cursor": [1, 2]}, mesh={"data": 1})
        out, extra = mgr.restore(like=t)
        assert extra == {"cursor": [1, 2]}
        for k in t:
            assert _equal(out[k], t[k])
        stats = mgr.restore_stats()
        assert stats["files_read"] == ["data.rank0.bin"]
        assert stats["saved_topology"] == {"processes": 1, "devices": 1, "mesh": {"data": 1}}

    def test_commit_barrier_rank1_waits_for_rank0(self, tmp_path):
        t = _tree()
        m0 = CheckpointManager(str(tmp_path), async_save=False, process_index=0,
                               process_count=2)
        m1 = CheckpointManager(str(tmp_path), async_save=False, process_index=1,
                               process_count=2, commit_timeout=20.0)
        done = {}

        def rank1():
            m1.save(1, t, extra={"step": 1})
            done["t"] = time.monotonic()

        th = threading.Thread(target=rank1)
        th.start()
        time.sleep(0.1)
        assert "t" not in done
        m0.save(1, t, extra={"step": 1})
        th.join(timeout=10)
        assert "t" in done
        d = tmp_path / "step_00000001"
        assert sorted(os.listdir(d)) == ["data.rank0.bin", "data.rank1.bin", "manifest.json"]
        man = json.loads((d / "manifest.json").read_text())
        assert man["topology"]["processes"] == 2
        assert man["files"]["1"]["nbytes"] == 0
        out, _ = m0.restore(like=t)
        assert _equal(out["w"], t["w"])

    def test_missing_rank_marker_times_out_without_commit(self, tmp_path):
        m0 = CheckpointManager(str(tmp_path), async_save=False, process_index=0,
                               process_count=2, commit_timeout=0.3)
        with pytest.raises(TimeoutError, match=r"ranks \[1\]"):
            m0.save(1, _tree())
        assert m0.steps() == []
        m = CheckpointManager(str(tmp_path), async_save=False)
        m.save(2, _tree())
        assert [n for n in os.listdir(tmp_path) if n.startswith(".tmp")] == []

    def test_async_error_surfaces_on_wait(self, tmp_path):
        m0 = CheckpointManager(str(tmp_path), async_save=True, process_index=0,
                               process_count=2, commit_timeout=0.2)
        m0.save(1, _tree())
        with pytest.raises(TimeoutError):
            m0.wait()

    def test_async_save_snapshots_before_an_in_place_update(self, tmp_path):
        t = _tree()
        want = t["w"].clone()
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        mgr.save(1, t)
        t["w"].add_(1.0)
        mgr.wait()
        out, _ = mgr.restore(like=t)
        assert _equal(out["w"], want)

    def test_legacy_schema1_checkpoint_still_restores(self, tmp_path):
        t = _tree()
        d = tmp_path / "step_00000005"
        d.mkdir()
        blob, leaves = b"", []
        for k in sorted(t):
            arr = np.ascontiguousarray(np.asarray(t[k]))
            raw = arr.tobytes()
            leaves.append({"shape": list(arr.shape), "dtype": str(arr.dtype),
                           "offset": len(blob), "nbytes": len(raw), "enc": "raw"})
            blob += raw
        (d / "data.bin").write_bytes(blob)
        (d / "manifest.json").write_text(json.dumps(
            {"schema": 1, "leaves": leaves, "extra": {"step": 5}}))
        out, extra = CheckpointManager(str(tmp_path)).restore(like=t)
        assert extra == {"step": 5}
        for k in t:   # the writer above stored the 0-d leaf as (1,), as the reference's does
            np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(t[k]))


class TestManifestSkew:
    """A manifest that disagrees with the on-disk shards raises a
    descriptive CheckpointError, never loads garbage."""

    @pytest.fixture()
    def saved(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(1, _tree())
        return tmp_path / "step_00000001", mgr

    def _edit_manifest(self, d, fn):
        man = json.loads((d / "manifest.json").read_text())
        fn(man)
        (d / "manifest.json").write_text(json.dumps(man))

    def test_missing_shard_file(self, saved):
        d, mgr = saved
        os.rename(d / "data.rank0.bin", d / "data.rank0.bin.gone")
        with pytest.raises(CheckpointError, match="data.rank0.bin.*missing"):
            mgr.restore(like=_tree())

    def test_topology_process_count_mismatch(self, saved):
        d, mgr = saved
        self._edit_manifest(d, lambda m: m["topology"].update(processes=2))
        with pytest.raises(CheckpointError, match="2 processes.*1 shard"):
            mgr.restore(like=_tree())

    def test_truncated_shard_file(self, saved):
        d, mgr = saved
        size = os.path.getsize(d / "data.rank0.bin")
        with open(d / "data.rank0.bin", "r+b") as f:
            f.truncate(size - 8)
        with pytest.raises(CheckpointError, match="truncated|bytes on disk"):
            mgr.restore(like=_tree())

    def test_corrupted_shard_content(self, saved):
        d, mgr = saved
        with open(d / "data.rank0.bin", "r+b") as f:
            f.write(b"\xff\xfe\xfd\xfc")
        with pytest.raises(CheckpointError, match="hash"):
            mgr.restore(like=_tree())

    def test_shard_table_hole(self, saved):
        d, mgr = saved
        self._edit_manifest(d, lambda m: m["shards"]["0"].pop(0))
        with pytest.raises(CheckpointError, match="do not cover"):
            mgr.restore(like=_tree())

    def test_leaf_count_drift(self, saved):
        _, mgr = saved
        with pytest.raises(ValueError, match="structure drift"):
            mgr.restore(like={"w": torch.zeros(4, 6)})


# ---------------------------------------------------------------------------
# real two-process gloo pairs over a loopback coordinator
# ---------------------------------------------------------------------------

# Every rank runs this loop (as launch/train.py does): beat its own
# mailbox each step, write its own checkpoint shards; rank 0 also polls
# the feeder during the paced sleep.  The step is elementwise on the
# DTensor's local rows (no collective), so the survivor keeps stepping
# after its peer is SIGKILLed.
WORKER = textwrap.dedent(
    """
    import os, sys, time, json, hashlib
    import numpy as np
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.dist import multihost
    from repro_torch.dist import sharding as shd

    info = multihost.init_from_env()          # the REPRO_* env contract
    from repro_torch.dist.fault import CheckpointManager
    from repro_torch.dist.heartbeat import FileMailbox, MonitorFeeder
    from repro_torch.dist.monitor import StepMonitor

    assert info.is_multiprocess and info.process_count == 2
    rank = info.process_index
    CKPT, HB = os.environ["T_CKPT"], os.environ["T_HB"]
    STEPS, EVERY = int(os.environ["T_STEPS"]), int(os.environ["T_EVERY"])
    SLEEP = float(os.environ["T_SLEEP"])
    SLOW1 = os.environ.get("T_SLOW1") == "1"
    HT = float(os.environ.get("T_HB_TIMEOUT", "5.0"))

    def emit(kind, **kw):
        print(json.dumps({"kind": kind, "rank": rank, **kw}), flush=True)

    mesh = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("data",))
    row_sh = shd.named_sharding((2, 8), ("batch", None), mesh)
    rep_sh = shd.named_sharding((5,), (None,), mesh)
    shardings = {"x": row_sh, "y": rep_sh}
    state = shd.device_put(
        {"x": torch.arange(16, dtype=torch.float32).reshape(2, 8) / 7.0,
         "y": torch.linspace(0.0, 1.0, 5, dtype=torch.float32)}, shardings)

    def step_fn(s, i):
        f = float(np.float32(i))
        return {"x": s["x"] * 1.0001 + f * 0.01, "y": s["y"] * 0.999 + f * 0.001}

    mgr = CheckpointManager(CKPT, keep=10, async_save=False, commit_timeout=60.0)
    mailbox = FileMailbox(HB)
    monitor = StepMonitor(num_hosts=2, min_records=2, heartbeat_timeout=HT)
    feeder = MonitorFeeder(monitor, mailbox) if rank == 0 else None

    start = 0
    if mgr.latest_step() is not None:
        state, extra = mgr.restore(like=state, shardings=shardings)
        start = extra["step"]
        emit("resumed", step=start, files_read=mgr.restore_stats()["files_read"])

    # warm up, then handshake: rank 0 arms dead-host detection only after
    # BOTH mailboxes exist
    step_fn(state, start)
    mailbox.beat()
    if feeder is not None:
        t_end = time.monotonic() + 120
        while len(mailbox.read()) < 2:
            if time.monotonic() > t_end:
                raise SystemExit("peer mailbox never appeared")
            time.sleep(0.02)

    for step in range(start, STEPS):
        t0 = time.perf_counter()
        state = step_fn(state, step)
        end = time.perf_counter() + SLEEP
        while True:
            if feeder is not None:
                feeder.poll(now=time.time())
                dead = monitor.dead_hosts(now=time.time())
                if dead:
                    emit("dead", hosts=dead, at_step=step)
                    os._exit(3)
            rem = end - time.perf_counter()
            if rem <= 0:
                break
            time.sleep(min(rem, 0.05))
        dt = time.perf_counter() - t0
        mailbox.beat(step=step, step_time=dt + (0.5 if SLOW1 and rank else 0), tokens=8.0)
        if (step + 1) % EVERY == 0:
            mgr.save(step + 1, state, extra={"step": step + 1}, mesh=mesh)
            emit("saved", step=step + 1)
        emit("progress", step=step)

    mgr.save(STEPS, state, extra={"step": STEPS}, mesh=mesh)

    def sha(a):
        return hashlib.sha256(a.detach().contiguous().numpy().tobytes()).hexdigest()

    emit("final", step=STEPS, x_local=sha(state["x"].to_local()), x_row=rank,
         y=sha(state["y"]),
         stragglers=(monitor.flagged_hosts() if rank == 0 else None))
    os._exit(0)   # the peer may already be gone: skip the group's teardown
    """
)

ELASTIC = textwrap.dedent(
    """
    import os, json, hashlib
    import torch
    from repro_torch.dist.fault import CheckpointManager

    like = {"x": torch.zeros((2, 8)), "y": torch.zeros((5,))}
    mgr = CheckpointManager(os.environ["T_CKPT"])
    out, extra = mgr.restore(like=like)     # 2-rank save -> 1-process restore

    def sha(a):
        return hashlib.sha256(a.contiguous().numpy().tobytes()).hexdigest()

    print(json.dumps({"step": extra["step"], "rows": [sha(out["x"][0:1]), sha(out["x"][1:2])],
                      "y": sha(out["y"]), "files_read": mgr.restore_stats()["files_read"]}))
    """
)


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), REPRO_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="1")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _spawn_pair(ckpt, hb, **extra):
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, "-c", WORKER],
        env=_env(REPRO_COORDINATOR=f"127.0.0.1:{port}", REPRO_NUM_PROCESSES=2,
                 REPRO_PROCESS_ID=r, T_CKPT=ckpt, T_HB=hb, **extra),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in (0, 1)]


def _events(proc, timeout=240):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, f"rank exited {proc.returncode}:\n{err[-3000:]}"
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def _final(events):
    return next(e for e in events if e["kind"] == "final")


@pytest.mark.slow
class TestTwoProcessPair:
    def test_pair_checkpoint_straggler_and_elastic_restore(self, tmp_path):
        """Uninterrupted pair: per-rank shard files, cross-process straggler
        flagging, and a 2-rank checkpoint restored by 1 process bit for
        bit, reading both files."""
        ckpt = str(tmp_path / "ck")
        procs = _spawn_pair(ckpt, str(tmp_path / "hb"), T_STEPS=12, T_EVERY=6,
                            T_SLEEP=0.05, T_SLOW1=1)
        fin0, fin1 = (_final(_events(p)) for p in procs)

        d = os.path.join(ckpt, "step_00000012")
        with open(os.path.join(d, "manifest.json")) as f:
            man = json.load(f)
        assert man["topology"]["processes"] == 2
        assert man["topology"]["mesh"] == {"data": 2}
        assert os.path.exists(os.path.join(d, "data.rank0.bin"))
        assert os.path.exists(os.path.join(d, "data.rank1.bin"))
        assert int(man["files"]["1"]["nbytes"]) > 0

        assert fin0["stragglers"] == [1]

        out = subprocess.run([sys.executable, "-c", ELASTIC], env=_env(T_CKPT=ckpt),
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-3000:]
        single = json.loads(out.stdout.strip().splitlines()[-1])
        assert single["step"] == 12
        by_row = {fin0["x_row"]: fin0["x_local"], fin1["x_row"]: fin1["x_local"]}
        assert single["rows"] == [by_row[0], by_row[1]]
        assert single["y"] == fin0["y"] == fin1["y"]
        assert single["files_read"] == ["data.rank0.bin", "data.rank1.bin"]

    def test_fault_injection_and_bit_exact_resume(self, tmp_path):
        """SIGKILL rank 1 after a commit: rank 0 detects it through the
        heartbeat; a restarted pair resumes from the committed step and
        ends bit-equal to an uninterrupted pair."""
        ref = _spawn_pair(str(tmp_path / "ref"), str(tmp_path / "hb_ref"), T_STEPS=16,
                          T_EVERY=6, T_SLEEP=0.05)
        rfin = [_final(_events(p)) for p in ref]

        # the save cadence (EVERY x SLEEP = 3 s) exceeds the detection
        # latency (T_HB_TIMEOUT + one 0.05 s poll chunk), so rank 0 reports
        # the death before it could block in a save waiting on the dead
        # rank's marker; 2 s keeps a live rank that the host deschedules
        # (a loaded test machine) from being declared dead
        ckpt = str(tmp_path / "ck")
        p0, p1 = _spawn_pair(ckpt, str(tmp_path / "hb_kill"), T_STEPS=16, T_EVERY=6,
                             T_SLEEP=0.5, T_HB_TIMEOUT=2.0)
        committed = 0
        for line in p1.stdout:
            if not line.startswith("{"):
                continue
            e = json.loads(line)
            if e["kind"] == "saved":
                committed = e["step"]
            if committed and e["kind"] == "progress" and e["step"] >= committed:
                break
        assert committed == 6
        p1.kill()
        p1.communicate()

        dead = None
        for line in p0.stdout:
            if line.startswith("{"):
                e = json.loads(line)
                if e["kind"] == "dead":
                    dead = e
                    break
        assert dead is not None and dead["hosts"] == [1], dead
        p0.communicate(timeout=60)
        assert p0.returncode == 3

        assert CheckpointManager(ckpt).latest_step() == committed

        procs = _spawn_pair(ckpt, str(tmp_path / "hb_resume"), T_STEPS=16, T_EVERY=6,
                            T_SLEEP=0.05)
        evs = [_events(p) for p in procs]
        for ev in evs:
            assert next(e for e in ev if e["kind"] == "resumed")["step"] == committed
        # lazy restore: rank 0's rows and the rank-0-owned replicated leaf
        # both live in data.rank0.bin
        r0 = next(e for e in evs[0] if e["kind"] == "resumed")
        assert r0["files_read"] == ["data.rank0.bin"]

        for got, want in zip([_final(ev) for ev in evs], rfin):
            assert got["x_local"] == want["x_local"]
            assert got["y"] == want["y"]
