"""Subprocess helpers shared by tests, selftest, and fleet tooling."""

from __future__ import annotations

import os
import re
import select
import time


def wait_for_stderr(proc, pattern: str, timeout_s: float = 10.0):
    """Accumulate `proc`'s stderr until `pattern` matches or the deadline
    passes. Reads the raw fd — select() on a buffered TextIOWrapper
    deadlocks when several lines arrive in one chunk and readline() only
    returns the first.

    Returns (match, buf); match is None on timeout or process exit.
    """
    fd = proc.stderr.fileno()
    buf = ""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        m = re.search(pattern, buf)
        if m:
            return m, buf
        ready, _, _ = select.select([fd], [], [], 0.2)
        if not ready:
            if proc.poll() is not None:
                break
            continue
        chunk = os.read(fd, 65536)
        if not chunk:
            break
        buf += chunk.decode(errors="replace")
    return re.search(pattern, buf), buf
