"""Trace actuation through the port's client shim and fabric, held to the
reference on the same scenarios (tests/test_actuation.py):

  * push delivery beats a 5 s poll interval;
  * an old shim (no push_proto) and an old daemon (--disable_config_push)
    still deliver by poke + poll;
  * a shim that advertises push and never acks falls back to the poll,
    and the daemon books the fallback;
  * a pushed config takes the daemon's base config under it;
  * the chunked stream commits byte-identical through the port's
    FabricClient with the reference's datagrams, and a silent sender's
    partial stream is discarded;
  * the port's streamed stop: the capture is exported first and the
    file streamed afterwards, byte for byte (the reference streams the
    serialized bytes while its export runs; ROADMAP Queue C).

Each delivery scenario runs once per shim, each against a fresh daemon,
and the outcomes the daemon and the shim report must be equal.
"""

import base64
import glob
import json
import os
import threading
import time
import zlib

import torch

from dynolog_tpu_torch.client.fabric import FabricClient
from dynolog_tpu_torch.utils.rpc import DynoClient
from torch_control_util import daemon, shims, stub_capture, wait_for


def _events_of(rpc, etype):
    return [e for e in rpc.get_events(limit=256)["events"]
            if e["type"] == etype]


def _deliver(cls, daemon_bin, monkeypatch, job, daemon_flags=(),
             accept_push=True, **client_kw):
    """Registers a client of ``cls`` with a stubbed capture, arms one
    config for it, and returns what delivery looked like from both
    ends."""
    with daemon(daemon_bin, monkeypatch, *daemon_flags) as d:
        client = cls(job_id=job, metrics_interval_s=3600, **client_kw)
        client._accept_push = accept_push
        got = stub_capture(client)
        try:
            client.start()
            rpc = DynoClient(port=d["port"])
            procs = wait_for(
                lambda: rpc.trace_registry().get("jobs", {}).get(job),
                10, f"job {job} registered")
            t0 = time.time()
            resp = rpc.set_trace_config(
                job, {"type": "xplane", "duration_ms": 1},
                pids=[os.getpid()])
            assert os.getpid() in resp["activityProfilersTriggered"]
            wait_for(lambda: got, 5, "config delivered")
            elapsed = time.time() - t0
            if accept_push and client.enable_push and \
                    "--disable_config_push" not in daemon_flags:
                wait_for(lambda: _events_of(rpc, "trace_pushed")
                         or _events_of(rpc, "trace_push_fallback"),
                         5, "the push settled")
            elif client.enable_push and not accept_push:
                wait_for(lambda: _events_of(rpc, "trace_push_fallback"),
                         5, "trace_push_fallback")
            counters = rpc.self_telemetry()["counters"]
            return {
                "push_capable": any(p.get("push_capable") for p in procs),
                "delivery": client.trace_timing.get("delivery"),
                "pushes_received": client.spans.counters().get(
                    "pushes_received", 0),
                "push_sent": counters.get("push_sent"),
                "push_fallback": counters.get("push_fallback"),
                "trace_pushed": len(_events_of(rpc, "trace_pushed")),
                "trace_push_fallback": len(
                    _events_of(rpc, "trace_push_fallback")),
                "config": got[0],
            }, elapsed
        finally:
            client.stop()


def _both(daemon_bin, monkeypatch, job, **kw):
    """The scenario on the port's shim and on the reference's; asserts
    their outcomes equal and returns the port's (outcome, elapsed)."""
    out = {name: _deliver(cls, daemon_bin, monkeypatch, job, **kw)
           for name, cls in shims()}
    assert out["torch"][0] == out["jax"][0], out
    return out["torch"]


def test_push_delivery_beats_poll_interval(daemon_bin, monkeypatch):
    """A 5 s poll interval, and the config still lands in under 2.5 s: the
    daemon pushed it in a 'cpsh' datagram and the shim acked it."""
    got, elapsed = _both(daemon_bin, monkeypatch, "pushjob",
                         poll_interval_s=5.0)
    assert elapsed < 2.5, f"delivery took {elapsed:.2f}s (poll path?)"
    assert got["push_capable"] and got["delivery"] == "push", got
    assert got["pushes_received"] >= 1, got
    assert got["trace_pushed"] >= 1 and got["push_sent"] >= 1, got
    assert got["push_fallback"] is None, got


def test_old_shim_without_push_proto_polls(daemon_bin, monkeypatch):
    """enable_push=False: no push_proto in the registration, and the
    config arrives by poke + poll with no push counted."""
    got, _ = _both(daemon_bin, monkeypatch, "oldshim",
                   poll_interval_s=0.5, enable_push=False)
    assert not got["push_capable"] and got["delivery"] == "poll", got
    assert got["push_sent"] is None and got["trace_pushed"] == 0, got


def test_old_daemon_ignores_push_advertisement(daemon_bin, monkeypatch):
    """A daemon without the push path ignores the advertisement; the
    poke-triggered poll delivers well inside the pre-push envelope."""
    got, elapsed = _both(daemon_bin, monkeypatch, "olddaemon",
                         daemon_flags=("--disable_config_push",),
                         poll_interval_s=0.5)
    assert elapsed < 3.0, elapsed
    assert got["delivery"] == "poll", got
    assert got["push_sent"] is None and got["push_fallback"] is None, got
    assert got["trace_pushed"] == 0 and got["trace_push_fallback"] == 0, got


def test_unacked_push_falls_back_to_poll(daemon_bin, monkeypatch):
    """A shim that advertises push and silently declines it (the
    `_accept_push` seam): the poll collects the config, and the daemon
    books trace_push_fallback and push_fallback."""
    got, _ = _both(daemon_bin, monkeypatch, "fbjob", accept_push=False,
                   poll_interval_s=0.5)
    assert got["push_capable"] and got["delivery"] == "poll", got
    assert got["push_sent"] >= 1 and got["push_fallback"] >= 1, got
    assert got["trace_push_fallback"] >= 1 and got["trace_pushed"] == 0, got


def test_base_config_fills_a_pushed_config(daemon_bin, monkeypatch,
                                           tmp_path):
    """End to end: a config pushed without duration_ms takes the base
    file's, and the operator's log_dir wins over the base's, in both
    shims."""
    base_path = tmp_path / "trace_base.json"
    base_path.write_text(json.dumps({"duration_ms": 300,
                                     "log_dir": "/base/dir"}))
    with daemon(daemon_bin, monkeypatch,
                f"--trace_base_config={base_path}") as d:
        clients = {name: cls(job_id=f"fill_{name}", poll_interval_s=5.0,
                             metrics_interval_s=3600)
                   for name, cls in shims()}
        got = {name: stub_capture(c) for name, c in clients.items()}
        try:
            for c in clients.values():
                c.start()
            rpc = DynoClient(port=d["port"])
            for name, c in clients.items():
                wait_for(lambda: c.job_id in rpc.trace_registry().get(
                    "jobs", {}), 10, f"{c.job_id} registered")
                rpc.set_trace_config(c.job_id, {"type": "xplane",
                                                "log_dir": str(tmp_path)})
                wait_for(lambda: got[name], 5, f"{name} config")
                assert c.trace_timing["delivery"] == "push", name
        finally:
            for c in clients.values():
                c.stop()
    assert got["torch"] == got["jax"] == [{
        "duration_ms": 300, "log_dir": str(tmp_path), "type": "xplane"}]


def test_stream_commit_roundtrip(daemon_bin, monkeypatch, tmp_path):
    """tbeg/tchk/tend through the port's FabricClient: the artifact lands
    byte-identical and renamed into place, tcom confirms the size, the
    daemon journals trace_streamed and counts the chunks, and the
    datagrams equal the reference FabricClient's for the same bytes."""
    from dynolog_tpu.client.fabric import FabricClient as RefFabric

    data = os.urandom(200_000)  # seven 32 KiB chunks
    monkeypatch.setattr(os, "urandom", lambda n: b"\x07" * n)
    out = {}
    with daemon(daemon_bin, monkeypatch) as d:
        rpc = DynoClient(port=d["port"])
        for name, cls in (("torch", FabricClient), ("jax", RefFabric)):
            fc = cls()
            wire = []
            real = fc._sendmsg

            def record(payload, ancillary, real=real, wire=wire):
                wire.append((payload, len(ancillary)))
                return real(payload, ancillary)

            fc._sendmsg = record
            dest = tmp_path / name
            dest.mkdir()
            fd = os.open(str(dest), os.O_RDONLY | os.O_DIRECTORY)
            try:
                reply = fc.upload_stream(
                    "streamjob", os.getpid(), fd, "streamed.pt.trace.json",
                    data, timeout_s=10.0)
            finally:
                os.close(fd)
                fc.close()
            assert reply is not None and reply.get("ok"), (name, reply)
            assert reply.get("bytes") == len(data), reply
            out[name] = (wire, sorted(reply), fc.stats(),
                         sorted(p.name for p in dest.iterdir()),
                         (dest / "streamed.pt.trace.json").read_bytes())
        wait_for(lambda: len(_events_of(rpc, "trace_streamed")) == 2, 5,
                 "trace_streamed twice")
        counters = rpc.self_telemetry()["counters"]
    wire, reply_keys, stats, files, artifact = out["torch"]
    assert [p[:4] for p, _ in wire] == [b"tbeg"] + [b"tchk"] * 7 + [b"tend"]
    assert wire[0][1] == 1  # the directory fd rides tbeg
    assert out["torch"] == out["jax"]
    assert files == ["streamed.pt.trace.json"] and artifact == data
    assert stats["fabric_streams_total"] == 1
    assert stats["fabric_stream_chunks_total"] == 7
    assert stats["fabric_stream_failures"] == 0
    assert counters.get("trace_chunks_rx", 0) >= 14, counters
    assert counters.get("trace_streams_committed", 0) >= 2, counters


def test_stream_abort_on_silent_sender(daemon_bin, monkeypatch, tmp_path):
    """A sender that goes silent after tbeg and 2 of 3 chunks, once
    through each fabric: the daemon's idle GC discards both partial
    assemblies (no temp file, nothing published) and journals
    trace_upload_aborted for each job."""
    from dynolog_tpu.client.fabric import FabricClient as RefFabric

    data = os.urandom(90_000)
    chunks = [data[i:i + 32768] for i in range(0, len(data), 32768)]
    with daemon(daemon_bin, monkeypatch,
                "--trace_stream_idle_ms", "300") as d:
        rpc = DynoClient(port=d["port"])
        fabrics = []
        try:
            for name, cls in (("torch", FabricClient), ("jax", RefFabric)):
                fc = cls()
                fabrics.append(fc)
                job, sid = f"abort_{name}", f"{name:0<8}".encode().hex()
                dest = tmp_path / name
                dest.mkdir()
                fd = os.open(str(dest), os.O_RDONLY | os.O_DIRECTORY)
                try:
                    assert fc.send_with_fd("tbeg", {
                        "job_id": job, "pid": os.getpid(), "stream_id": sid,
                        "file": "streamed.pt.trace.json",
                        "total_bytes": len(data),
                        "chunk_count": len(chunks),
                        "crc32": zlib.crc32(data) & 0xFFFFFFFF}, fd)
                finally:
                    os.close(fd)
                for seq in (0, 1):
                    assert fc.send("tchk", {
                        "job_id": job, "pid": os.getpid(),
                        "stream_id": sid, "seq": seq,
                        "crc32": zlib.crc32(chunks[seq]) & 0xFFFFFFFF,
                        "data": base64.b64encode(chunks[seq]).decode(),
                    })
            aborted = wait_for(
                lambda: len(_events_of(rpc, "trace_upload_aborted")) == 2
                and _events_of(rpc, "trace_upload_aborted"), 5,
                "trace_upload_aborted for both senders")
            counters = rpc.self_telemetry()["counters"]
        finally:
            for fc in fabrics:
                fc.close()
    for name in ("torch", "jax"):
        assert any(f"job abort_{name} " in e["detail"] for e in aborted), \
            aborted
    assert counters.get("trace_chunks_aborted", 0) >= 4, counters
    assert "trace_streams_committed" not in counters, counters
    for name in ("torch", "jax"):
        assert list((tmp_path / name).iterdir()) == [], name


def test_streamed_copy_follows_the_export(daemon_bin, monkeypatch, tmp_path):
    """The port's streamed stop: a real CPU capture under step() is
    exported, then the exported file is streamed, so the committed
    streamed.pt.trace.json is the export byte for byte and
    stream_commit comes after export_done (the reference stamps
    trace_stop at its commit and streams while it exports)."""
    from dynolog_tpu_torch.client import DynologClient

    with daemon(daemon_bin, monkeypatch) as d:
        client = DynologClient(job_id="streamstop", poll_interval_s=0.1,
                               metrics_interval_s=3600)
        stop = threading.Event()

        def train():
            x = torch.randn(32, 32)
            while not stop.is_set():
                x = torch.tanh(x @ x)
                client.step()
                time.sleep(0.005)

        trainer = threading.Thread(target=train, daemon=True)
        try:
            client.start()
            trainer.start()
            rpc = DynoClient(port=d["port"])
            wait_for(lambda: rpc.status()["registered_processes"] == 1, 10,
                     "registration")
            rpc.set_trace_config("streamstop", {
                "type": "xplane", "duration_ms": 100,
                "log_dir": str(tmp_path)})
            wait_for(lambda: client.captures_completed == 1, 30, "capture")
            t = dict(client.trace_timing)
        finally:
            stop.set()
            trainer.join(timeout=10)
            client.stop()
    assert not trainer.is_alive()
    exported = [p for p in glob.glob(str(tmp_path / "*" / "*.pt.trace.json"))
                if not os.path.basename(p).startswith("streamed.")]
    assert len(exported) == 1, exported
    streamed = os.path.join(os.path.dirname(exported[0]),
                            "streamed.pt.trace.json")
    with open(exported[0], "rb") as a, open(streamed, "rb") as b:
        assert a.read() == b.read()
    assert t["trace_start"] < t["trace_stop"] < t["export_done"] \
        <= t["stream_commit"], t
    assert "stream_failed" not in t
    assert json.loads(open(streamed).read())["traceEvents"]
