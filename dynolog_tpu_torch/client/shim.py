"""DynologClient — the in-process shim that connects a PyTorch training
job to the dynolog_tpu daemon.

The PyTorch counterpart of ``dynolog_tpu/client/shim.py`` (reference
flow: SURVEY.md §3.3): register over the UNIX-socket fabric, take pushed
or polled on-demand trace configs, and run the capture in-process with
``torch.profiler`` (Kineto). The daemon never touches trace data — the
profiled process writes the Chrome trace itself, and the daemon writes
``dynolog_manifest.json`` beside it through a directory fd the shim
hands over. The wire protocol is the reference shim's, byte for byte, so
the same daemon and ``dyno`` CLI serve both.

It also pushes per-device telemetry every metrics interval (see
telemetry.py).

Trace config grammar (JSON, produced by `dyno gputrace`):
  type: "xplane"            the one capture type the CLI and autocapture
                            send; here it means a torch.profiler capture
  log_dir: str              base output dir; per-process subdir appended
  duration_ms: int          wall-clock capture window
  start_time_ms: int        optional absolute epoch-ms start (multi-host sync)
  iterations: int           optional: capture N training steps instead of
                            duration (needs the workload to call step())
  iteration_roundup: int    start at next step divisible by this
  python_tracer: bool       maps to torch.profiler's with_stack
  host_tracer_level: int    accepted and ignored (no torch.profiler knob)

Artifacts: ``<log_dir>/<host>_<pid>/<host>_<pid>.pt.trace.json``, and
with streaming on, the same bytes committed by the daemon as
``streamed.pt.trace.json`` in that directory.

Profiler threading. Kineto records CPU ops only on the thread that
started the profiler, and a profiler must be stopped on the thread that
started it. So when the workload calls ``step()``, every capture —
duration or iteration — is armed by the capture thread and started and
stopped inside ``step()`` on the training thread: a duration capture
starts at the next ``step()`` and stops at the first ``step()`` after
``duration_ms``. Only when no ``step()`` arrives (the workload has no
hook, or has not stepped within ``_STEP_WAIT_S`` or three of its own
last step intervals, whichever is longer) does the capture thread start
the profiler itself; such a trace holds the kernels launched after the
start and the capture thread's own ops, and none of the training
thread's CPU ops. Only one profiler session can run in a process: when
the user's own ``torch.profiler`` is active the capture is dropped with a
warning and never raises into the training loop.

Flight recorder. A daemon started with ``--retro_window_ms`` advertises a
``retro`` block on its cack and poll replies; the shim then records
rolling windows and streams each into the daemon's retro ring, which the
daemon exports beside a forward capture when a watch rule fires. A
window is a ``torch.profiler`` session of ``ProfilerActivity.CUDA`` only
(``ProfilerActivity.CPU`` without CUDA in use), started and stopped in
``step()`` on the training thread, like a forward capture: stopping a
CUDA profiler on another thread while the training thread launches
kernels crashed the process on an H100 (PERF.md, PR 4). The recorder's
own thread exports each stopped window, gzips it (level 1), streams it,
and only then asks ``step()`` for the next one, so no session runs while
another is exported. A forward capture ends the window in flight at the
next ``step()`` and pauses the ring until it is done. Kineto's stop and
Chrome export hold the interpreter lock for their whole length, so the
training thread pays each window's stop and, through the lock, its
export. A workload that never calls ``step()`` records no window.

Usage:
    client = DynologClient(job_id="42")
    client.start()
    for batch in data:
        train_step(...)
        client.step()        # lets captures record the training thread
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import json
import logging
import os
import queue
import random
import shutil
import socket as _socket
import tempfile
import threading
import time

from dynolog_tpu_torch.client.fabric import FabricClient
from dynolog_tpu_torch.client.spans import SpanRecorder
from dynolog_tpu_torch.client.telemetry import (
    StepTracker,
    collect_device_metrics,
)

log = logging.getLogger("dynolog_tpu_torch.client")

# If an iteration-based config sees no step() call for this long, fall back
# to a duration capture (reference falls back the same way when the
# optimizer hook is absent; docs/pytorch_profiler.md:67-76).
_ITERATION_FALLBACK_S = 10.0

# A duration config, or a flight-recorder window, waits this long for the
# training thread's next step() to start the profiler there (a workload
# that never called step() falls back at once), or, when the workload's
# steps are longer, _STEP_WAIT_STEPS of its last step interval
# (_step_wait_s). A profiler started off the training thread in the
# middle of a step records none of the kernels that step queued before
# the start, so a GPU-bound job whose steps outlasted a fixed wait got
# traces with few or no kernel events (PERF.md §7); its ring windows were
# all skipped.
_STEP_WAIT_S = 2.0
_STEP_WAIT_STEPS = 3.0

# The flight recorder's thread checks this often, while it waits for
# step() to hand it a window, whether the client is stopping.
_RETRO_SLICE_S = 0.05

# Consecutive failed windows after which the flight recorder turns itself
# off for the life of the client.
_RETRO_MAX_FAILURES = 3

# Consecutive failed polls before the loop stops polling at full rate and
# backs off exponentially (jittered; see _next_wait_s).
_BACKOFF_AFTER_FAILURES = 3


def _default_job_id() -> str:
    for var in ("DYNOLOG_TPU_JOB_ID", "SLURM_JOB_ID", "MEGASCALE_SLICE_ID"):
        if os.environ.get(var):
            return os.environ[var]
    return "0"


def _cuda_in_use() -> bool:
    import torch
    return torch.cuda.is_initialized()


def _user_profiler_active() -> bool:
    """True while any torch.profiler session runs in this process. The
    flag is process-global (torch.profiler sets it on start), unlike the
    thread-local enabled check; a torch without it reads as idle."""
    from torch.autograd import profiler as _aprof
    return bool(getattr(_aprof, "_is_profiler_enabled", False))


def _end_session(prof) -> None:
    """Frees a retired torch.profiler session now, the counterpart of
    the reference's ``state.reset()``. A ``torch.profiler.profile`` keeps
    bound methods of itself (its schedule's action map), so it and the
    session holding Kineto's results form a reference cycle that only a
    full pass of the cyclic collector frees, dozens of captures later:
    until then each stop builds its results on fresh memory, which on an
    H100 took a median 1.22 s against 0.23 s (PERF.md §6). Clearing the
    profile's attributes breaks the cycle whatever torch names them, so
    dropping the last reference frees the session at once. Call once
    nothing reads the session."""
    vars(prof).clear()


class _RetroSkip(Exception):
    """No window this time, and no failure: step() did not start one (no
    training step, or a forward capture took the profiler first)."""


def _retro_upload_timeout_s(n_bytes: int) -> float:
    """The wait for the daemon's commit of one retro window: the
    reference's 2 s, plus the window's bytes at 8 MB/s, a quarter of the
    30 MB/s a window upload took on an H100 host
    (scripts/torch_retro_design.py)."""
    return 2.0 + n_bytes / 8e6


class DynologClient:
    def __init__(
        self,
        job_id: str | None = None,
        daemon_socket: str | None = None,
        poll_interval_s: float = 1.0,
        metrics_interval_s: float = 10.0,
        metadata: dict | None = None,
        profiler_server_port: int | None = None,
        backoff_cap_s: float = 30.0,
        enable_push: bool = True,
        enable_stream: bool = True,
    ):
        # enable_push: advertise "push_proto" so the daemon delivers trace
        # configs in a 'cpsh' datagram the moment they are staged; the
        # interval poll stays armed as the fallback either way.
        # enable_stream: stream the exported trace to the daemon, which
        # commits it as streamed.pt.trace.json. Either switch off -> the
        # exact pre-push/pre-stream wire behavior.
        # profiler_server_port: the reference starts jax.profiler's gRPC
        # server; torch.profiler has none, so the port is only logged.
        self.profiler_server_port = profiler_server_port
        self.job_id = str(job_id or _default_job_id())
        self.pid = os.getpid()
        self.poll_interval_s = poll_interval_s
        self.metrics_interval_s = metrics_interval_s
        self.backoff_cap_s = backoff_cap_s
        self.enable_push = enable_push
        self.enable_stream = enable_stream
        self._fabric = FabricClient(daemon_socket)
        self._fabric.on_stray_conf = self._on_stray_conf
        if enable_push:
            self._fabric.on_push = self._handle_push
        # Recently-acked push tokens: a duplicate token re-acks without
        # re-running the capture.
        self._push_tokens: collections.deque = collections.deque(maxlen=16)
        # Test seam (version-skew rehearsal): advertise push_proto but
        # silently decline every push.
        self._accept_push = True
        self._metadata = dict(metadata or {})
        self._tracker = StepTracker()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._registered = True  # start() registers before the loop runs
        self._daemon_epoch: int | None = None
        self._consec_failures = 0
        self._capture_lock = threading.Lock()
        self._capturing = False
        # Capture handoff to the training thread, guarded by
        # _capture_lock: _armed is a config waiting for step() to start
        # it (iteration configs only from _iter_start on); while
        # _trace_active, step() stops the profiler at _iter_stop
        # (iteration) or once monotonic time passes _dur_stop (duration).
        self._armed: dict | None = None
        self._iter_start = 0
        self._iter_stop = 0
        self._dur_stop: float | None = None
        self._trace_active = False
        # The running profiler, the thread that started it (only that
        # thread may stop it) and, after stop, the profile waiting for
        # the capture thread to export it.
        self._prof = None
        self._prof_thread: int | None = None
        self._stopped_prof = None
        self._last_trace_dir: str | None = None
        self.captures_completed = 0
        self._base_config_raw = ""
        self._base_config: dict = {}
        # Epoch-seconds timestamps of the most recent capture's phases
        # (config_received -> trace_start -> trace_stop -> export_done).
        # Read by chip_smoke.py and tests to split on-demand trace latency.
        self.trace_timing: dict = {}
        self._op_stats: list = []
        self.spans = SpanRecorder()
        self._phase_lock = threading.Lock()
        self._open_phases: list = []  # (name, t_push), outermost first
        self._phase_spans: collections.deque = collections.deque(maxlen=256)
        # Flight recorder: the daemon's {window_ms, ring_windows} (None
        # parks the loop), the loop's thread, started once, and the
        # scratch dir each window's Chrome trace is exported to.
        self._retro_cfg: dict | None = None
        self._retro_thread: threading.Thread | None = None
        self._retro_seq = 0
        self._retro_failures = 0
        self._retro_disabled = False
        self._retro_scratch: str | None = None
        # Window handoff with step(), guarded by _capture_lock:
        # _retro_ms asks step() for one window of that length; step()
        # starts it (_retro_prof, on _retro_owner's thread), stops it
        # once due, and hands (profile, t0_ms, t1_ms), or None when the
        # start failed, to the recorder's thread through _retro_stopped.
        self._retro_ms: int | None = None
        self._retro_prof = None
        self._retro_owner: threading.Thread | None = None
        self._retro_t0_ms = 0
        self._retro_end = 0.0
        self._retro_stopped: queue.Queue = queue.Queue(maxsize=1)
        # The latest window's stop, export and gzip times (ms) and JSON
        # bytes; they ride its retro_upload span.
        self._retro_timing: dict = {}
        # Profiler handoff gate: set while NO retro window is running.
        # A forward capture started off the training thread waits on it
        # (one profiler session per process).
        self._retro_idle = threading.Event()
        self._retro_idle.set()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "DynologClient":
        if self._thread is not None:
            return self
        if self.profiler_server_port:
            log.warning(
                "profiler_server_port=%s ignored: torch.profiler has no "
                "profiler server", self.profiler_server_port)
        # A profiler's first start imports torch._inductor, and so does
        # the workload's first optimizer (through torch._dynamo). Two
        # threads importing them at once deadlock the imports and raise
        # ImportError in both: a capture that arrived while the job was
        # still building its optimizer killed the job. Import them here,
        # on the caller's thread, before any capture thread can exist.
        import torch._inductor  # noqa: F401
        self._register()
        self._thread = threading.Thread(
            target=self._loop, name="dynolog-tpu-client", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._abort_capture("client stopping")
        self._end_retro_window()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._retro_thread is not None:
            # The recorder's thread sees the stop event within
            # _RETRO_SLICE_S, or after the export it is running.
            self._retro_thread.join(timeout=5)
            if not self._retro_thread.is_alive() and self._retro_scratch:
                shutil.rmtree(self._retro_scratch, ignore_errors=True)
                self._retro_scratch = None
            self._retro_thread = None
        self._fabric.close()

    # -- training-loop hook ------------------------------------------------

    def step(self) -> None:
        """Call once per training iteration, on the training thread.
        Cheap (no syscalls) unless a capture or a flight-recorder window
        starts or stops here."""
        n = self._tracker.step()
        # Unlocked fast-path peek: worst case one extra step() takes the
        # lock before observing a transition.
        if (self._armed is None and not self._trace_active
                and self._retro_ms is None and self._retro_prof is None):
            return
        with self._capture_lock:
            self._step_retro()
            cfg = self._armed
            if cfg is not None and not self._trace_active:
                iterations = int(cfg.get("iterations") or 0)
                if iterations and n < self._iter_start:
                    return
                self._armed = None
                # Fail-soft: a bad log_dir or a user's active profiler must
                # never propagate into the training loop.
                try:
                    self._start_trace(cfg)
                except Exception as e:
                    log.warning("trace start failed; dropping capture: %s", e)
                    return
                self._trace_active = True
                # The window opens when start returns: the first start in
                # a process initialises the device tracer (seconds).
                if iterations:
                    self._iter_stop = n + iterations
                    self._dur_stop = None
                else:
                    self._dur_stop = time.monotonic() + max(
                        cfg.get("duration_ms", 500), 1) / 1000.0
            elif self._trace_active and self._owns_profiler():
                done = (n >= self._iter_stop if self._dur_stop is None
                        else time.monotonic() >= self._dur_stop)
                if done:
                    self._stop_trace()
                    self._trace_active = False

    def _step_retro(self) -> None:
        """step()'s half of the flight recorder, with _capture_lock held:
        ends the running window once it is due or a forward capture or
        stop() wants the profiler, and starts the one the recorder's
        thread asked for while the profiler is free. Fail-soft."""
        pending = self._capturing or self._armed is not None \
            or self._trace_active or self._stop.is_set()
        if self._retro_prof is not None:
            if pending or time.monotonic() >= self._retro_end:
                self._stop_retro_window()
            return
        if self._retro_ms is None or pending or _user_profiler_active():
            return
        from torch.profiler import ProfilerActivity, profile
        window_ms, self._retro_ms = self._retro_ms, None
        activity = (ProfilerActivity.CUDA if _cuda_in_use()
                    else ProfilerActivity.CPU)
        prof = None
        try:
            prof = profile(activities=[activity])
            self._retro_t0_ms = int(time.time() * 1000)
            prof.start()
        except Exception:
            log.debug("retro window start failed", exc_info=True)
            if prof is not None:
                _end_session(prof)
            self._retro_stopped.put_nowait(None)
            return
        self._retro_prof = prof
        self._retro_owner = threading.current_thread()
        self._retro_end = time.monotonic() + max(window_ms, 1) / 1000.0
        self._retro_idle.clear()

    def _stop_retro_window(self) -> None:
        """Stops the running window on the thread that started it and
        hands it to the recorder's thread. Call with _capture_lock held."""
        prof, self._retro_prof, self._retro_owner = \
            self._retro_prof, None, None
        t_stop = time.perf_counter()
        try:
            prof.stop()
            item = (prof, self._retro_t0_ms, int(time.time() * 1000))
        except Exception:
            log.debug("retro window stop failed", exc_info=True)
            _end_session(prof)
            item = None
        self._retro_timing = {
            "stop_ms": round((time.perf_counter() - t_stop) * 1e3, 3)}
        self._retro_idle.set()
        self._retro_stopped.put_nowait(item)

    def _end_retro_window(self) -> None:
        """stop()'s end of a running window: stopped here when this is
        the thread that started it, else by that thread's next step()
        (a profiler stops only on its own thread), waited for briefly."""
        deadline = time.monotonic() + 5.0
        while True:
            with self._capture_lock:
                if self._retro_prof is None:
                    return
                if self._retro_owner is threading.current_thread():
                    self._stop_retro_window()
                    return
                owner_alive = (self._retro_owner is not None
                               and self._retro_owner.is_alive())
            if not owner_alive or time.monotonic() >= deadline:
                log.warning("flight-recorder window left running: the "
                            "thread that started it called no step() "
                            "after stop()")
                return
            time.sleep(0.005)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Annotates a nested phase of the training loop:

            with client.phase("eval"):
                ...

        The daemon slices annotations into per-phase wall-time
        attribution served by `dyno phases`. Best-effort like every
        fabric send — a dead daemon costs two dropped datagrams, never an
        exception in the training loop.
        """
        t_push = time.time()
        with self._phase_lock:
            depth = len(self._open_phases)
            self._open_phases.append((str(name), t_push))
        self._send_phase("push", name, t_push)
        try:
            yield
        finally:
            t_pop = time.time()
            with self._phase_lock:
                # Mirror the daemon slicer: a pop closes the deepest
                # matching frame and everything nested above it.
                for i in range(len(self._open_phases) - 1, -1, -1):
                    if self._open_phases[i][0] == str(name):
                        del self._open_phases[i:]
                        break
                self._phase_spans.append({
                    "name": str(name), "t_start": t_push,
                    "t_end": t_pop, "depth": depth,
                })
            self._send_phase("pop", name, t_pop)

    def _send_phase(self, op: str, name: str, t: float | None = None) -> None:
        try:
            self._fabric.send("phas", {
                "job_id": self.job_id, "pid": self.pid,
                "op": op, "phase": str(name),
                "t": time.time() if t is None else t,
            })
        except Exception:
            log.debug("phase annotation dropped", exc_info=True)

    def _export_phase_spans(self, limit: int = 128) -> list:
        """Completed phases (bounded ring) plus the currently-open stack
        (t_end=None, open=True) for the trace manifest."""
        with self._phase_lock:
            spans = list(self._phase_spans)[-limit:]
            spans.extend(
                {"name": n, "t_start": t, "t_end": None, "depth": i,
                 "open": True}
                for i, (n, t) in enumerate(self._open_phases))
        return spans

    def record_op_stats(self, ops) -> None:
        """Sets the per-op workload stats the next trace manifest will
        carry: a list of {name, count, total_ms[, cpu_ms, collective]}
        dicts. Entries missing a name or total_ms are dropped."""
        cleaned = []
        for op in ops or []:
            if not isinstance(op, dict) or "name" not in op \
                    or "total_ms" not in op:
                continue
            entry = {"name": str(op["name"]),
                     "count": int(op.get("count", 1)),
                     "total_ms": float(op["total_ms"])}
            if "cpu_ms" in op:
                entry["cpu_ms"] = float(op["cpu_ms"])
            if "collective" in op:
                entry["collective"] = bool(op["collective"])
            cleaned.append(entry)
        self._op_stats = cleaned

    # -- internals ---------------------------------------------------------

    def _register(self) -> None:
        meta = {
            "host": _socket.gethostname(),
            "argv": " ".join(os.sys.argv[:4]),
            **self._metadata,
        }
        if self.enable_push:
            meta["push_proto"] = 1
        if _cuda_in_use():
            import torch
            meta.setdefault("device_count", torch.cuda.device_count())
            meta.setdefault("platform", "gpu")
        else:
            meta.setdefault("device_count", 1)
            meta.setdefault("platform", "cpu")
        with self.spans.span("register") as s:
            s["ok"] = self._fabric.send(
                "ctxt",
                {"job_id": self.job_id, "pid": self.pid, "metadata": meta})
        # Replay still-open phases with their ORIGINAL timestamps: a
        # daemon that restarted mid-phase lost its tagstack.
        with self._phase_lock:
            replay = list(self._open_phases)
        for name, t_push in replay:
            self._send_phase("push", name, t_push)

    def _note_epoch(self, epoch) -> bool:
        """Tracks the daemon's per-boot instance epoch. Returns True —
        and marks us unregistered — when it changed, i.e. the daemon
        restarted and forgot this process. Poll thread only."""
        if not isinstance(epoch, int):
            return False
        if self._daemon_epoch is None:
            self._daemon_epoch = epoch
            return False
        if epoch == self._daemon_epoch:
            return False
        self._daemon_epoch = epoch
        self._registered = False
        self.spans.incr("daemon_restarts_detected")
        log.info("daemon restart detected (epoch changed); re-registering")
        return True

    def _next_wait_s(self) -> float:
        """Inter-poll wait: the poll interval while the daemon answers,
        jittered exponential backoff (capped at backoff_cap_s) after
        _BACKOFF_AFTER_FAILURES consecutive failures."""
        k = self._consec_failures - _BACKOFF_AFTER_FAILURES
        if k < 0:
            return self.poll_interval_s
        self.spans.incr("reconnect_backoffs")
        base = min(self.poll_interval_s * (2 ** k), self.backoff_cap_s)
        return base * random.uniform(0.5, 1.5)

    def _loop(self) -> None:
        next_metrics = 0.0
        while not self._stop.is_set():
            try:
                self._loop_once()
            except Exception:
                log.exception("client poll iteration failed; continuing")
            now = time.monotonic()
            if now >= next_metrics:
                try:
                    self._push_metrics()
                except Exception:
                    log.exception("metrics push failed; continuing")
                next_metrics = now + self.metrics_interval_s
            self._wait_or_poke(self._next_wait_s())

    def _wait_or_poke(self, timeout_s: float) -> None:
        """Sleeps up to timeout_s between polls, waking at once on a
        daemon 'poke' and delivering 'cpsh' pushes inside the wait.
        select.poll, not select.select: a big process easily holds >1024
        fds."""
        import select
        try:
            poller = select.poll()
            poller.register(self._fabric.fileno(), select.POLLIN)
        except (OSError, ValueError):
            self._stop.wait(timeout_s)
            return
        t_wait = time.time()
        deadline = time.monotonic() + timeout_s
        while not self._stop.is_set():
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            try:
                events = poller.poll(min(remaining, 0.2) * 1000)
            except OSError:
                self._stop.wait(remaining)
                return
            if not events:
                continue
            wake = poked = False
            while True:
                msg = self._fabric.recv_message()
                if msg is None:
                    break
                mtype, body = msg
                if mtype == "poke":
                    wake = poked = True
                    self._note_epoch(body.get("epoch"))
                elif mtype == "cack":
                    if self._note_epoch(body.get("epoch")):
                        wake = True
                    self._apply_retro_config(body.get("retro"))
                elif mtype == "conf":
                    # A late reply to a timed-out poll: the daemon handed
                    # the config off exactly-once, so it must not drop.
                    self._on_stray_conf(body)
                    wake = True
                elif mtype == "cpsh":
                    if self._note_epoch(body.get("epoch")):
                        wake = True
                    self._handle_push(body, t_wait)
            if wake:
                if poked:
                    self.spans.incr("pokes_received")
                    self.spans.record("poke_wake", t_wait)
                return  # poll immediately

    def _loop_once(self) -> None:
        was_registered = self._registered
        # Pessimistic: any exception below leaves us marked unregistered.
        self._registered = False
        with self.spans.span("poll") as s:
            resp = self._fabric.request(
                "poll",
                {"job_id": self.job_id, "pid": self.pid},
                timeout_s=self.poll_interval_s,
            )
            s["ok"] = resp is not None
        if resp is None:
            self._consec_failures += 1
            return
        restarted = self._note_epoch(resp.get("epoch"))
        if self._consec_failures > 0:
            self.spans.incr("reconnects")
            self._consec_failures = 0
        if restarted or not was_registered:
            self._register()
            self.spans.incr("reregistrations")
        self._registered = True
        self._apply_base_config(resp.get("base_config", ""))
        self._apply_retro_config(resp.get("retro"))
        config = resp.get("config", "")
        if config:
            self._on_config(config)

    def _apply_base_config(self, base: str) -> None:
        # Daemon-distributed defaults merge UNDER any operator config.
        if base == self._base_config_raw:
            return
        self._base_config_raw = base
        try:
            self._base_config = json.loads(base) if base else {}
            if not isinstance(self._base_config, dict):
                raise ValueError("base config must be a JSON object")
        except ValueError:
            log.warning("ignoring unparseable base config: %r", base)
            self._base_config = {}

    def _apply_retro_config(self, retro) -> None:
        """Arms (or parks) the flight-recorder loop from the 'retro'
        block the daemon attaches to cack/poll replies. A reply without
        the block (a daemon without --retro_window_ms, or an old daemon)
        parks the loop; the thread itself is started once and reused."""
        if (not isinstance(retro, dict)
                or int(retro.get("window_ms") or 0) <= 0):
            self._retro_cfg = None
            return
        self._retro_cfg = {
            "window_ms": int(retro["window_ms"]),
            "ring_windows": int(retro.get("ring_windows") or 8),
        }
        if self._retro_thread is None and not self._retro_disabled:
            self._retro_thread = threading.Thread(
                target=self._retro_loop, name="dynolog-tpu-retro",
                daemon=True)
            self._retro_thread.start()

    def _retro_loop(self) -> None:
        """Rolling pre-trigger capture: one --retro_window_ms window after
        another, each streamed into the daemon's retro ring.

        A DEDICATED fabric endpoint carries the uploads: the daemon's
        assembler keys live streams by sender endpoint, so a retro
        window must never ride (and displace) the capture thread's
        forward-trace stream on the shared socket. The loop skips
        windows while a forward capture or a user's own profiler holds
        the profiler (one session per process), or while the workload
        does not step, and fail-soft disables itself after three
        consecutive window failures."""
        fabric = FabricClient(self._fabric.daemon_socket)
        try:
            while not self._stop.is_set():
                cfg = self._retro_cfg
                if cfg is None or self._retro_disabled:
                    self._stop.wait(0.2)
                    continue
                window_ms = cfg["window_ms"]
                with self._capture_lock:
                    busy = (self._capturing or self._trace_active
                            or _user_profiler_active())
                if not busy:
                    try:
                        win = self._retro_capture_window(window_ms)
                    except _RetroSkip:
                        busy = True
                    except Exception:
                        log.debug("retro window capture failed",
                                  exc_info=True)
                        win = None
                if busy:
                    # The ring just has a gap here; a forward capture
                    # covers it.
                    self.spans.incr("retro_windows_skipped")
                    self._stop.wait(min(window_ms / 1000.0, 0.2))
                    continue
                if self._stop.is_set():
                    break
                if win is None:
                    self._retro_failures += 1
                    if self._retro_failures >= _RETRO_MAX_FAILURES:
                        self._retro_disabled = True
                        self.spans.incr("retro_disabled")
                        log.warning(
                            "flight recorder disabled after %d failed "
                            "window captures", self._retro_failures)
                    continue
                self._retro_failures = 0
                data, t0_ms, t1_ms = win
                seq = self._retro_seq
                self._retro_seq += 1
                with self.spans.span("retro_upload", bytes=len(data),
                                     **self._retro_timing) as s:
                    uploaded = fabric.upload_retro(
                        self.job_id, self.pid, seq, t0_ms, t1_ms, data,
                        timeout_s=_retro_upload_timeout_s(len(data))
                    ) is not None
                    s["ok"] = uploaded
                self.spans.incr("retro_windows_captured")
                if not uploaded:
                    # Daemon down or degraded: windows land again when it
                    # comes back; the loop itself never stops for it.
                    self.spans.incr("retro_upload_failures")
        finally:
            with self._capture_lock:
                self._retro_ms = None
            # A window stopped after this loop's last wait is never
            # exported; end its session here.
            try:
                item = self._retro_stopped.get_nowait()
            except queue.Empty:
                item = None
            if item is not None:
                _end_session(item[0])
            fabric.close()

    def _retro_capture_window(self, window_ms: int):
        """Asks step() for one window, waits for step() to start and stop
        it on the training thread, then exports and gzips it here.
        Returns (gzipped_chrome_trace, t0_ms, t1_ms), or None when the
        profiler served no trace; raises _RetroSkip when step() started
        no window within _step_wait_s() or a forward capture came first.
        Overridden by the test harness's FakeCaptureClient."""
        with self._capture_lock:
            self._retro_ms = window_ms
        start_by = time.monotonic() + self._step_wait_s()
        while True:
            try:
                item = self._retro_stopped.get(timeout=_RETRO_SLICE_S)
                break
            except queue.Empty:
                pass
            # step() hands a window over under the lock, so an empty
            # queue and no running window here means none is coming.
            with self._capture_lock:
                if (self._retro_prof is None and self._retro_stopped.empty()
                        and (self._stop.is_set() or self._capturing
                             or self._trace_active
                             or time.monotonic() >= start_by)):
                    self._retro_ms = None
                    raise _RetroSkip()
        if item is None:
            return None
        prof, t0_ms, t1_ms = item
        if self._retro_scratch is None:
            self._retro_scratch = tempfile.mkdtemp(prefix="dtpu_retro_")
        path = os.path.join(self._retro_scratch, "window.pt.trace.json")
        t_export = time.perf_counter()
        try:
            prof.export_chrome_trace(path)
            with open(path, "rb") as f:
                data = f.read()
            os.unlink(path)
            export_ms = round((time.perf_counter() - t_export) * 1e3, 3)
        finally:
            _end_session(prof)
        if not data:
            return None
        t_gzip = time.perf_counter()
        # zlib releases the interpreter lock; a tenth of the bytes cuts
        # the upload's Python work (base64, one datagram per 32 KiB) by
        # as much.
        packed = gzip.compress(data, compresslevel=1)
        self._retro_timing = {
            **self._retro_timing,
            "export_ms": export_ms,
            "gzip_ms": round((time.perf_counter() - t_gzip) * 1e3, 3),
            "json_bytes": len(data)}
        return packed, t0_ms, t1_ms

    def _push_metrics(self) -> None:
        with self.spans.span("telemetry_push") as s:
            records = collect_device_metrics(self._tracker.snapshot())
            # The shim's own control-plane cost rides every push as the
            # dyno_self_* family, fabric transport counters included.
            self_family = self.spans.self_metrics(
                extra=self._fabric.stats())
            for rec in records:
                rec.update(self_family)
            s["ok"] = self._fabric.send(
                "tmet",
                {"job_id": self.job_id, "pid": self.pid,
                 "devices": records})

    def _on_stray_conf(self, body: dict) -> None:
        """Deliver a 'conf' datagram consumed outside the normal poll
        reply path, base config first, exactly as _loop_once would."""
        try:
            if "base_config" in body:
                self._apply_base_config(body["base_config"])
            if "retro" in body:
                self._apply_retro_config(body["retro"])
            config = body.get("config", "")
            if config:
                self._on_config(config)
        except Exception:
            log.exception("late config delivery failed")

    def _handle_push(self, body: dict, t_wait: float | None = None) -> None:
        """Deliver a 'cpsh' pushed config, then ack its token so the
        daemon's poll fallback stands down."""
        if not self.enable_push or not self._accept_push:
            return
        token = body.get("token", "")
        if token and token in self._push_tokens:
            self._ack_push(token)
            return
        if token:
            self._push_tokens.append(token)
        self.spans.incr("pushes_received")
        if t_wait is not None:
            self.spans.record("push_wake", t_wait)
        try:
            if "base_config" in body:
                self._apply_base_config(body["base_config"])
            config = body.get("config", "")
            if config:
                self._on_config(config, delivery="push")
        finally:
            self._ack_push(token)

    def _ack_push(self, token: str) -> None:
        if not token:
            return
        self._fabric.send("pack", {
            "job_id": self.job_id, "pid": self.pid, "token": token})

    def _on_config(self, config_str: str, delivery: str = "poll") -> None:
        try:
            cfg = json.loads(config_str)
        except json.JSONDecodeError:
            log.warning("dropping unparseable trace config: %r", config_str)
            return
        if self._base_config:
            cfg = {**self._base_config, **cfg}
        if cfg.get("type", "xplane") != "xplane":
            log.warning("unknown trace type %r", cfg.get("type"))
            return
        t_received = time.time()
        with self._capture_lock:
            if self._capturing:
                log.warning("capture already in progress; dropping config")
                return
            self._capturing = True
            self.trace_timing = {
                "config_received": t_received,
                "delivery": delivery,
            }
        threading.Thread(
            target=self._capture, args=(cfg,), daemon=True,
            name="dynolog-tpu-capture").start()

    def _capture(self, cfg: dict) -> None:
        try:
            start_ms = cfg.get("start_time_ms")
            if start_ms:
                delay = start_ms / 1000.0 - time.time()
                if delay > 0:
                    time.sleep(delay)
            self._capture_via_step(cfg)
        except Exception:
            log.exception("trace capture failed")
        finally:
            with self._capture_lock:
                self._capturing = False

    def _step_wait_s(self) -> float:
        """How long a capture or a ring window waits for the training
        thread's step() before giving up on it: _STEP_WAIT_S, or
        _STEP_WAIT_STEPS of the job's last step interval when longer."""
        return max(_STEP_WAIT_S,
                   _STEP_WAIT_STEPS * self._tracker.last_interval_s)

    def _capture_via_step(self, cfg: dict) -> None:
        """Arms cfg for the training thread's step(), waits for step() to
        start and stop the profiler, then exports on this thread. Falls
        back to a capture-thread duration capture when no step() picks
        the config up in time."""
        iterations = bool(cfg.get("iterations"))
        cur = self._tracker.count
        if iterations:
            roundup = max(int(cfg.get("iteration_roundup", 1)), 1)
            wait_s = _ITERATION_FALLBACK_S
        else:
            roundup = 1
            wait_s = self._step_wait_s() if cur > 0 else 0.0
        with self._capture_lock:
            self._iter_start = ((cur + roundup) // roundup) * roundup
            self._armed = cfg
        deadline = time.monotonic() + wait_s
        while True:
            with self._capture_lock:
                if self._armed is None:  # step() picked it up
                    picked_up = True
                    break
                if self._stop.is_set() or time.monotonic() >= deadline:
                    self._armed = None
                    picked_up = False
                    break
            time.sleep(0.005)
        if not picked_up:
            if self._stop.is_set():
                return
            if iterations:
                log.warning(
                    "no step() calls within %.0fs; falling back to "
                    "duration capture", _ITERATION_FALLBACK_S)
            self._capture_duration_here(cfg)
            return
        # step() owns the capture now; it stops the profiler on the
        # training thread and leaves the profile for this thread. On
        # stop() the owner's next step() closes it early; it is waited
        # for as stop() waits for a ring window, so its session ends here.
        deadline = None
        while True:
            with self._capture_lock:
                if not self._trace_active:
                    break
            if deadline is None and self._stop.is_set():
                self._abort_capture("client stopping")
                deadline = time.monotonic() + 5.0
            elif deadline is not None and time.monotonic() >= deadline:
                log.warning("trace left running: the thread that started "
                            "it called no step() after stop()")
                break
            time.sleep(0.005)
        self._finish_trace()

    def _capture_duration_here(self, cfg: dict) -> None:
        self._start_trace(cfg)
        time.sleep(max(cfg.get("duration_ms", 500), 1) / 1000.0)
        with self._capture_lock:
            self._stop_trace()
        self._finish_trace()

    def _abort_capture(self, why: str) -> None:
        """Disarms a pending config and, on the thread that owns the
        running profiler, stops it. From any other thread the profiler
        cannot be stopped; the owner's next step() stops it."""
        with self._capture_lock:
            self._armed = None
            if self._trace_active and self._owns_profiler():
                log.warning("closing trace early: %s", why)
                self._stop_trace()
                self._trace_active = False
            elif self._trace_active:
                self._dur_stop = 0.0  # stop at the owner's next step()

    def _owns_profiler(self) -> bool:
        return self._prof_thread == threading.get_ident()

    # _start_trace/_stop_trace: call with _capture_lock held (or from the
    # capture thread on the fallback path), on one thread per capture.

    def _trace_dir(self, cfg: dict) -> str:
        base = cfg.get("log_dir", "/tmp/dynolog_tpu_traces")
        return os.path.join(base, f"{_socket.gethostname()}_{self.pid}")

    def _start_trace(self, cfg: dict) -> None:
        # The bounded handoff gate of the reference shim: a retro window
        # still running owns the profiler session. In step() the window
        # has just been stopped; off the training thread (no step())
        # none runs unless the workload stopped stepping mid-window.
        if not self._retro_idle.wait(timeout=2.0):
            log.warning("retro window still in flight; starting anyway")
        from torch.profiler import ProfilerActivity, profile
        if _user_profiler_active():
            raise RuntimeError(
                "another torch.profiler session is active in this process")
        activities = [ProfilerActivity.CPU]
        if _cuda_in_use():
            activities.append(ProfilerActivity.CUDA)
        # host_tracer_level has no torch.profiler counterpart: Kineto's
        # CPU tracer records every op on the starting thread.
        prof = profile(activities=activities,
                       with_stack=bool(cfg.get("python_tracer")))
        out = self._trace_dir(cfg)
        os.makedirs(out, exist_ok=True)
        log.info("starting torch.profiler capture -> %s", out)
        self._last_trace_dir = out
        self.trace_timing["trace_start"] = time.time()
        try:
            prof.start()
        except Exception:
            _end_session(prof)
            raise
        self._prof = prof
        self._prof_thread = threading.get_ident()
        self.trace_timing["start_returned"] = time.time()

    def _stop_trace(self) -> None:
        """Stops the profiler on the thread that started it and parks the
        profile for _finish_trace. Fail-soft: runs on the training
        thread."""
        prof, self._prof, self._prof_thread = self._prof, None, None
        try:
            self.trace_timing["stop_begin"] = time.time()
            prof.stop()
            self.trace_timing["trace_stop"] = time.time()
            self._stopped_prof = prof
        except Exception:
            log.exception("stop_trace failed")
            _end_session(prof)

    def _finish_trace(self) -> None:
        """Exports the stopped profile (off the training thread) and ends
        its session, streams the export to the daemon when enabled, and
        sends the manifest."""
        prof, self._stopped_prof = self._stopped_prof, None
        if prof is None:
            return
        try:
            path = os.path.join(
                self._last_trace_dir,
                f"{_socket.gethostname()}_{self.pid}.pt.trace.json")
            try:
                prof.export_chrome_trace(path)
                self.trace_timing["export_done"] = time.time()
            finally:
                _end_session(prof)
                del prof  # gone before the manifest reports it retired
            if self.enable_stream:
                self._stream_trace(path)
            self.captures_completed += 1
            log.info("torch.profiler capture complete (%d total)",
                     self.captures_completed)
            self._send_trace_manifest()
        except Exception:
            log.exception("trace export failed")

    def _stream_trace(self, path: str) -> None:
        """Uploads the exported Chrome trace through the daemon's chunked
        stream; the daemon verifies, fsyncs and renames it into the trace
        dir as streamed.pt.trace.json. A failed upload costs nothing but
        the copy: the exported file is already on disk."""
        with open(path, "rb") as f:
            payload = f.read()
        try:
            fd = os.open(self._last_trace_dir, os.O_RDONLY | os.O_DIRECTORY)
        except OSError:
            return
        try:
            with self.spans.span("stream_upload") as s:
                streamed = self._fabric.upload_stream(
                    self.job_id, self.pid, fd, "streamed.pt.trace.json",
                    payload)
                s["ok"] = streamed is not None
        finally:
            os.close(fd)
        if streamed is not None:
            self.trace_timing["stream_commit"] = time.time()
            self.spans.incr("streams_committed")
        else:
            self.spans.incr("stream_fallbacks")
            self.trace_timing["stream_failed"] = True

    def _send_trace_manifest(self) -> None:
        """Grants the daemon an fd of the trace output dir (SCM_RIGHTS)
        so it writes dynolog_manifest.json there — the daemon touches
        only the directory this process handed it. Best-effort."""
        t = self.trace_timing
        if "config_received" in t and "trace_start" in t:
            self.spans.record("deliver", t["config_received"],
                              t["trace_start"])
        if "trace_start" in t and "trace_stop" in t:
            self.spans.record("capture", t["trace_start"], t["trace_stop"])
        out = self._last_trace_dir
        if not out:
            return
        try:
            fd = os.open(out, os.O_RDONLY | os.O_DIRECTORY)
        except OSError:
            return
        try:
            with self.spans.span("manifest_send") as s:
                s["ok"] = self._fabric.send_with_fd("tdir", {
                    "job_id": self.job_id,
                    "pid": self.pid,
                    "hostname": _socket.gethostname(),
                    "captures_completed": self.captures_completed,
                    "trace_timing": dict(self.trace_timing),
                    "spans": self.spans.export(),
                    "phase_spans": self._export_phase_spans(),
                    "op_stats": list(self._op_stats),
                }, fd)
        finally:
            os.close(fd)


_global_client: DynologClient | None = None


def enable(**kwargs) -> DynologClient | None:
    """Module-level opt-in, usable as a one-liner at workload startup.

    Honors DYNOLOG_TPU_ENABLED=0 as a kill switch (analog of the
    reference's KINETO_USE_DAEMON opt-in env var).
    """
    global _global_client
    if os.environ.get("DYNOLOG_TPU_ENABLED", "1") in ("0", "false"):
        return None
    if _global_client is None:
        _global_client = DynologClient(**kwargs).start()
    return _global_client
