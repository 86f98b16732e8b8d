"""Client side of the daemon's UNIX-datagram rendezvous fabric.

Speaks the wire format of ``native/src/ipc/Endpoint.{h,cpp}``: one
datagram per message, a 4-byte ASCII type tag followed by UTF-8 JSON.
Abstract-namespace sockets by default; ``DYNOLOG_TPU_SOCKET_DIR`` switches
both sides to filesystem-path sockets (same escape hatch as the daemon).

Counterpart of the client half of the reference's ipcfabric, which is
compiled into libkineto (reference: dynolog/src/ipcfabric/FabricManager.h
:15-26); here the profiled process is Python/PyTorch, so the client is a small
Python module instead of vendored C++ headers.
"""

from __future__ import annotations

import array
import base64
import json
import os
import select
import socket
import threading
import time
import zlib

from ..utils import faultline

DAEMON_SOCKET = os.environ.get("DYNOLOG_TPU_SOCKET", "dynolog_tpu")
_MAX_DGRAM = 65536

# A send to a full daemon queue retries every _SEND_RETRY_S and gives up
# (send returns False) after _SEND_TIMEOUT_S; see _sendmsg.
_SEND_RETRY_S = 0.0005
_SEND_TIMEOUT_S = 2.0

# Reply types parked in the cross-thread reply box when a reader drains
# one it wasn't waiting for (see FabricClient._reply_box). 'conf' stays
# out: stray one-shot configs have their own exactly-once routing
# (on_stray_conf) with delivery semantics, not request/reply semantics.
# 'tack' is the resume handshake's answer to a 'tbeg' re-send — same
# request/reply shape as 'tcom'.
_BOXABLE_REPLIES = ("tcom", "tack")


def _addr(name: str) -> str | bytes:
    sock_dir = os.environ.get("DYNOLOG_TPU_SOCKET_DIR")
    if sock_dir:
        return os.path.join(sock_dir, name)
    return b"\0" + name.encode()


class FabricClient:
    """One bound endpoint talking to the daemon's endpoint.

    Thread-safe for interleaved request/reply use: sends are serialized,
    and only the poll path reads replies.
    """

    def __init__(self, daemon_socket: str | None = None):
        self.daemon_socket = daemon_socket or DAEMON_SOCKET
        self._name = f"dynolog_tpu_client_{os.getpid()}_{os.urandom(4).hex()}"
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        self._sock.bind(_addr(self._name))
        self._lock = threading.Lock()
        self._closed = False
        # Chaos hook (no-op unless DYNOLOG_TPU_FAULTS names the 'fabric'
        # scope): every outbound datagram goes through plan_tx, every
        # inbound one through drop_rx. Resolved once — a client outlives
        # env changes, and the chaos tests want one decision stream.
        self._faults = faultline.for_scope("fabric")
        # Transport counters for the shim's dyno_self_* family (spans.py):
        # a fleet debugging a "traces never arrive" report needs to know
        # whether the fabric itself is dropping. Guarded by _stats_lock
        # (recv paths don't hold _lock).
        self._stats_lock = threading.Lock()
        self._stats = {
            "fabric_send_total": 0,
            "fabric_send_failures": 0,
            "fabric_recv_total": 0,
            "fabric_requests_total": 0,
            "fabric_request_timeouts": 0,
            "fabric_streams_total": 0,
            "fabric_stream_chunks_total": 0,
            "fabric_stream_failures": 0,
            "fabric_stream_resumes": 0,
            "fabric_retro_windows_total": 0,
        }
        # Called (from the poll thread) with the parsed body of any 'conf'
        # datagram that request()'s pre-send drain would otherwise discard.
        # The daemon hands configs off exactly-once — a late reply to a
        # timed-out poll still carries a config the operator was told was
        # delivered, so it must reach the owner, not the floor.
        self.on_stray_conf = None
        # Called (from whichever thread is inside request()) with the
        # parsed body of any 'cpsh' config-push datagram that arrives
        # while a request is in flight. Pushed configs are the trace
        # fast path — dropping one costs a full poll interval of
        # latency, so like stray confs they are routed, not discarded.
        self.on_push = None
        # Cross-thread reply parking: the socket is shared, so the poll
        # thread (parked in the shim's wait loop) can win the race for a
        # reply datagram the capture thread's request() is blocked on —
        # concretely the 'tcom' stream-commit ack, which would then cost
        # the full request timeout instead of ~1 ms. Any reader that
        # drains a boxable reply it wasn't waiting for parks it here;
        # request() checks the box on every wakeup.
        self._reply_lock = threading.Lock()
        self._reply_box: dict[str, dict] = {}

    @property
    def endpoint_name(self) -> str:
        return self._name

    def close(self) -> None:
        """Idempotent, and safe against concurrent request()/
        recv_message() on the poll thread: the flag flips first so
        send() degrades to its normal False instead of raising on the
        dead fd, and the racing reader's EBADF/poll errors are already
        swallowed at every recv site. shutdown() before close(): merely
        closing an fd does NOT wake a thread already parked inside
        poll() on it (it would sleep out its full timeout); shutdown
        raises POLLHUP on the open file description, which does."""
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # never connected / already shut down
        try:
            self._sock.close()
        except OSError:
            pass  # double-close race with another finalizer
        sock_dir = os.environ.get("DYNOLOG_TPU_SOCKET_DIR")
        if sock_dir:
            try:
                os.unlink(os.path.join(sock_dir, self._name))
            except OSError:
                pass

    @staticmethod
    def _encode(msg_type: str, body: dict) -> bytes:
        assert len(msg_type) == 4, msg_type
        payload = msg_type.encode() + json.dumps(body).encode()
        if len(payload) > _MAX_DGRAM:
            raise ValueError(f"ipc message too large: {len(payload)}")
        return payload

    def _incr(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self._stats[key] += n

    def stats(self) -> dict[str, int]:
        """Transport counter snapshot (send/recv/request totals and
        failures); keys feed the shim's dyno_self_* telemetry family.
        Under fault injection the per-action injection counts ride along
        under a fault_ prefix, so a chaos run's telemetry says how much
        chaos it actually got."""
        with self._stats_lock:
            out = dict(self._stats)
        if self._faults is not None:
            for action, n in self._faults.counters().items():
                out[f"fault_{action}"] = n
        return out

    def _sendmsg(self, payload: bytes, ancillary: list) -> bool:
        if self._closed:
            return False
        self._incr("fabric_send_total")
        # Fault injection happens below the caller-visible send: a
        # "dropped" datagram still returns True, because real datagram
        # loss is invisible to the sender too.
        wire = [payload]
        if self._faults is not None:
            wire = self._faults.plan_tx(payload)
            if not wire:
                return True
        deadline = None
        for p in wire:
            while True:
                try:
                    with self._lock:
                        self._sock.sendmsg([p], ancillary,
                                           socket.MSG_DONTWAIT,
                                           _addr(self.daemon_socket))
                    break
                except BlockingIOError:
                    # The daemon's queue is full. Wait here, not in the
                    # kernel: some kernels (gVisor) never wake a sender
                    # parked in a blocking sendmsg on a full datagram
                    # queue, which would hang every thread sharing this
                    # socket — the training thread's phase sends too.
                    # The lock is released between tries.
                    now = time.monotonic()
                    if deadline is None:
                        deadline = now + _SEND_TIMEOUT_S
                    if now >= deadline or self._closed:
                        self._incr("fabric_send_failures")
                        return False
                    time.sleep(_SEND_RETRY_S)
                except OSError:
                    self._incr("fabric_send_failures")
                    return False
        return True

    def send(self, msg_type: str, body: dict) -> bool:
        """Fire one message at the daemon. Best-effort: False when the
        daemon is not running (the shim keeps retrying on its own pace)."""
        return self._sendmsg(self._encode(msg_type, body), [])

    def send_with_fd(self, msg_type: str, body: dict, fd: int) -> bool:
        """Like send, but passes an open file descriptor as SCM_RIGHTS
        ancillary data (the daemon receives a duplicate; this process
        keeps its own copy). Used to grant the daemon write access to a
        directory this process owns — e.g. the trace output dir for the
        capture manifest — without the daemon touching paths."""
        return self._sendmsg(
            self._encode(msg_type, body),
            [(socket.SOL_SOCKET, socket.SCM_RIGHTS,
              array.array("i", [fd]))])

    def fileno(self) -> int:
        """The socket fd, for select()-based waits (shim poke path)."""
        return self._sock.fileno()

    def _box_reply(self, msg_type: str, body: dict | None) -> None:
        if msg_type in _BOXABLE_REPLIES and body is not None:
            with self._reply_lock:
                self._reply_box[msg_type] = body

    def _take_reply(self, msg_type: str) -> dict | None:
        with self._reply_lock:
            return self._reply_box.pop(msg_type, None)

    @staticmethod
    def _decode(data: bytes) -> tuple[str, dict | None] | None:
        """Split a datagram into (4-byte type tag, parsed JSON body).
        None for runts; body None when the payload is not a JSON object —
        including a bare type tag with no payload, so a hostile local
        process writing b"conf" can't forge an empty-but-valid reply
        (the socket is writable by any local process)."""
        if len(data) < 4:
            return None
        msg_type = data[:4].decode(errors="replace")
        try:
            body = json.loads(data[4:])
            if not isinstance(body, dict):
                body = None
        except (UnicodeDecodeError, ValueError):
            body = None
        return msg_type, body

    def recv_message(self) -> tuple[str, dict] | None:
        """Non-blocking: consumes one pending datagram and returns its
        (type tag, parsed body) — None when nothing is queued. Used by
        the shim's wait loop to spot daemon 'poke' nudges. MSG_DONTWAIT
        rather than a setblocking toggle: the socket is shared with
        best-effort sends from the training thread (phase annotations,
        metric pushes), and a momentary non-blocking window would make
        those sends fail with EAGAIN and silently drop."""
        try:
            data = self._sock.recv(_MAX_DGRAM, socket.MSG_DONTWAIT)
        except OSError:
            # Includes EWOULDBLOCK and a socket closed mid-stop — never
            # let either escape into the poll thread.
            return None
        self._incr("fabric_recv_total")
        if self._faults is not None and self._faults.drop_rx():
            return None
        decoded = self._decode(data)
        if decoded is None:
            return None
        msg_type, body = decoded
        # Park replies the wait-loop caller won't handle itself, so a
        # concurrent request() (stream commit on the capture thread)
        # still gets its answer.
        self._box_reply(msg_type, body)
        return msg_type, body if body is not None else {}

    def request(self, msg_type: str, body: dict,
                timeout_s: float = 1.0,
                reply_type: str = "conf",
                fd: int | None = None) -> dict | None:
        """Send and wait for the reply datagram (matched by its type
        tag — unsolicited datagrams like 'poke' nudges are discarded,
        never mistaken for the reply). None on timeout or when the
        daemon is down.

        All receives use select + MSG_DONTWAIT: the socket's blocking
        mode and timeout are never changed, so concurrent best-effort
        sends from the training thread keep their normal semantics for
        the whole wait."""
        # Drain late replies from previously timed-out requests so this
        # request isn't answered one reply out of phase. A drained 'conf'
        # is a one-shot trace config the daemon already handed off —
        # route it to on_stray_conf instead of dropping it.
        while True:
            try:
                data = self._sock.recv(_MAX_DGRAM, socket.MSG_DONTWAIT)
            except OSError:
                break
            if self._faults is not None and self._faults.drop_rx():
                continue
            decoded = self._decode(data)
            if (decoded and decoded[0] == "conf" and decoded[1] is not None
                    and self.on_stray_conf is not None):
                try:
                    self.on_stray_conf(decoded[1])
                except Exception:
                    pass  # owner's handler must not break the poll path
            elif (decoded and decoded[0] == "cpsh"
                    and decoded[1] is not None
                    and self.on_push is not None):
                try:
                    self.on_push(decoded[1])
                except Exception:
                    pass
            elif decoded:
                self._box_reply(decoded[0], decoded[1])
        self._incr("fabric_requests_total")
        # A stale parked reply must not answer THIS request one exchange
        # out of phase (callers also match ids, but don't rely on it).
        self._take_reply(reply_type)
        sent = (self.send_with_fd(msg_type, body, fd) if fd is not None
                else self.send(msg_type, body))
        if not sent:
            return None
        deadline = time.monotonic() + timeout_s
        try:
            poller = select.poll()
            poller.register(self._sock.fileno(), select.POLLIN)
        except (OSError, ValueError):
            return None
        while True:
            # Another thread (the poll loop draining the shared socket)
            # may have consumed and parked our reply — check first, and
            # poll with a bounded slice so a parked reply is noticed
            # within ~10 ms even when no further datagram arrives to
            # wake this thread (the slice bounds the stream-commit
            # latency the capture thread pays when it loses the race).
            boxed = self._take_reply(reply_type)
            if boxed is not None:
                return {"type": reply_type, **boxed}
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._incr("fabric_request_timeouts")
                return None
            try:
                events = poller.poll(min(remaining, 0.01) * 1000)
            except OSError:
                return None
            if not events:
                continue  # box/deadline re-check
            if events[0][1] & (select.POLLERR | select.POLLHUP |
                               select.POLLNVAL):
                return None  # socket closed mid-stop: don't spin on it
            try:
                data = self._sock.recv(_MAX_DGRAM, socket.MSG_DONTWAIT)
            except BlockingIOError:
                continue  # raced another reader; wait again
            except OSError:
                return None  # EBADF etc — the fd is gone
            self._incr("fabric_recv_total")
            if self._faults is not None and self._faults.drop_rx():
                continue
            decoded = self._decode(data)
            if decoded is None or decoded[0] != reply_type:
                # A config push racing this request must not be eaten by
                # the wait loop — hand it to the owner and keep waiting.
                if (decoded and decoded[0] == "cpsh"
                        and decoded[1] is not None
                        and self.on_push is not None):
                    try:
                        self.on_push(decoded[1])
                    except Exception:
                        pass
                elif decoded:
                    # Someone else's reply (concurrent request on
                    # another thread): park it for them.
                    self._box_reply(decoded[0], decoded[1])
                continue  # poke/runt: keep waiting for the reply
            if decoded[1] is None:
                # Reply-typed garbage (the socket is writable by any
                # local process): no-reply; the next poll retries.
                return None
            return {"type": reply_type, **decoded[1]}

    def upload_stream(self, job_id: str, pid: int, dir_fd: int,
                      file_name: str, data: bytes,
                      timeout_s: float = 2.0,
                      chunk_bytes: int = 32768,
                      resume_retries: int = 2) -> dict | None:
        """Stream a serialized artifact to the daemon in CRC'd chunks.

        Wire sequence: 'tbeg' (carrying ``dir_fd`` over SCM_RIGHTS, so
        the daemon assembles only where this process granted access),
        N 'tchk' chunks (base64, per-chunk + running CRC-32), then
        'tend', which the daemon answers with 'tcom' once the artifact
        is verified, fsynced, and renamed into place. Returns the tcom
        body ({ok, bytes, epoch}) on success, None on any failure — the
        caller falls back to writing the artifact itself (the profiler
        export still runs, so nothing is lost but latency).

        A failed send or a missing 'tcom' no longer abandons the upload
        outright: the client re-sends 'tbeg' with ``resume: 1`` and the
        daemon — if its live assembly still matches stream id, byte
        count, chunk count and CRC — answers 'tack' with the next chunk
        it needs, so only the unacked suffix is re-sent (up to
        ``resume_retries`` times; daemon side counts the skipped prefix
        in dyno_self_trace_chunks_resumed_total).
        """
        if not data:
            return None
        stream_id = os.urandom(8).hex()
        begin = {
            "job_id": job_id, "pid": pid, "stream_id": stream_id,
            "file": file_name, "total_bytes": len(data),
            "chunk_count": -(-len(data) // chunk_bytes),
            "crc32": zlib.crc32(data) & 0xFFFFFFFF,
        }
        return self._upload(
            begin, dir_fd, data, timeout_s, chunk_bytes, resume_retries)

    def upload_retro(self, job_id: str, pid: int, seq: int,
                     t0_ms: int, t1_ms: int, data: bytes,
                     timeout_s: float = 2.0,
                     chunk_bytes: int = 32768) -> dict | None:
        """Stream one flight-recorder window into the daemon's retro
        ring. Same chunked wire as ``upload_stream`` but the 'tbeg'
        carries ``retro: 1`` plus the window's sequence number and wall
        span — and no directory fd: the daemon assembles into its own
        ``<storage_dir>/retro`` ring (self-owned, budget-shared,
        oldest-evicted), not into a client-granted directory."""
        if not data:
            return None
        begin = {
            "job_id": job_id, "pid": pid,
            "stream_id": os.urandom(8).hex(),
            "total_bytes": len(data),
            "chunk_count": -(-len(data) // chunk_bytes),
            "crc32": zlib.crc32(data) & 0xFFFFFFFF,
            "retro": 1, "seq": seq, "t0_ms": t0_ms, "t1_ms": t1_ms,
        }
        reply = self._upload(
            begin, None, data, timeout_s, chunk_bytes, resume_retries=1)
        if reply is not None:
            self._incr("fabric_retro_windows_total")
        return reply

    def _upload(self, begin: dict, dir_fd: int | None, data: bytes,
                timeout_s: float, chunk_bytes: int,
                resume_retries: int) -> dict | None:
        """Shared chunked-upload engine: tbeg -> tchk* -> tend -> tcom,
        with the resume handshake on failure (see upload_stream)."""
        self._incr("fabric_streams_total")
        job_id, pid = begin["job_id"], begin["pid"]
        stream_id = begin["stream_id"]
        chunks = [data[i:i + chunk_bytes]
                  for i in range(0, len(data), chunk_bytes)]
        sent = (self.send_with_fd("tbeg", begin, dir_fd)
                if dir_fd is not None else self.send("tbeg", begin))
        if not sent:
            self._incr("fabric_stream_failures")
            return None
        end = {"job_id": job_id, "pid": pid, "stream_id": stream_id,
               "chunk_count": len(chunks), "crc32": begin["crc32"]}
        next_seq = 0
        while True:
            sent_all = True
            for seq in range(next_seq, len(chunks)):
                chunk = chunks[seq]
                body = {
                    "job_id": job_id, "pid": pid, "stream_id": stream_id,
                    "seq": seq, "crc32": zlib.crc32(chunk) & 0xFFFFFFFF,
                    "data": base64.b64encode(chunk).decode("ascii"),
                }
                if not self.send("tchk", body):
                    sent_all = False
                    break
                self._incr("fabric_stream_chunks_total")
            if sent_all:
                reply = self.request(
                    "tend", end, timeout_s=timeout_s, reply_type="tcom")
                if (reply is not None and reply.get("ok")
                        and reply.get("stream_id") == stream_id):
                    return reply
            if resume_retries <= 0:
                self._incr("fabric_stream_failures")
                return None
            resume_retries -= 1
            # Resume handshake: the daemon matches (stream_id,
            # total_bytes, chunk_count, crc32) against its live assembly
            # and acks the next contiguous chunk it needs; a non-match
            # (idle-aborted, daemon restarted) acks 0 and the whole
            # stream is re-sent against a fresh assembly.
            tack = self.request(
                "tbeg", dict(begin, resume=1), timeout_s=timeout_s,
                reply_type="tack", fd=dir_fd)
            if tack is None or tack.get("stream_id") != stream_id:
                self._incr("fabric_stream_failures")
                return None
            next_seq = int(tack.get("next_seq", 0))
            self._incr("fabric_stream_resumes")
