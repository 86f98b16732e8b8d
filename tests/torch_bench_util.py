"""Helpers shared by the tests that run a phase of the port's bench
beside bench.py's own (tests/test_torch_bench_*.py).

Each test runs the reference phase (the JAX package's minifleet,
fleetstatus, eventlog and client) and its port in
``dynolog_tpu_torch.bench`` one after the other on the session's built
daemon, each under a deadline, and holds the port to the reference's
outcomes and keys.

Socket directories and the phases' ``tmp`` come from
``tempfile.mkdtemp``, not pytest's ``tmp_path``: under xdist a per-test
path plus a socket name can pass AF_UNIX's 108-byte limit, and some
phases name their daemons' sockets after a path under ``tmp``.
"""

import faulthandler
import shutil
import tempfile
import threading

import pytest

import bench as ref_bench
from dynolog_tpu_torch import bench

TINY = bench.TINY_FLEET
PHASE_TIMEOUT_S = 120


@pytest.fixture
def sock_dir(monkeypatch):
    d = tempfile.mkdtemp(prefix="dtbf")
    monkeypatch.setenv("DYNOLOG_TPU_SOCKET_DIR", d)
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def short_tmp():
    """A factory of short temporary dirs, removed after the test."""
    made = []

    def make():
        made.append(tempfile.mkdtemp(prefix="dtb"))
        return made[-1]

    yield make
    for d in made:
        shutil.rmtree(d, ignore_errors=True)


def bounded(fn, *args, **kwargs):
    """fn(*args, **kwargs) on a thread, failed past PHASE_TIMEOUT_S with
    every thread's stack on stderr; its exception is re-raised here."""
    out = {}

    def run():
        try:
            out["value"] = fn(*args, **kwargs)
        except BaseException as e:  # re-raised on the test's thread
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(PHASE_TIMEOUT_S)
    if t.is_alive():
        faulthandler.dump_traceback(all_threads=True)
        pytest.fail(f"{fn.__module__}.{fn.__name__} ran past "
                    f"{PHASE_TIMEOUT_S} s")
    if "error" in out:
        raise out["error"]
    return out["value"]


def both(daemon_bin, tmp, name, ref_kwargs=None, **kwargs):
    """(bench.py's result, the port's) of phase ``name``, each with a dir
    of its own from the factory ``tmp``: the port at ``kwargs``, the
    reference at ``ref_kwargs`` (default: the same)."""
    ref = bounded(getattr(ref_bench, name), daemon_bin, tmp(),
                  **(kwargs if ref_kwargs is None else ref_kwargs))
    port = bounded(getattr(bench, name), daemon_bin, tmp(), **kwargs)
    return ref, port


def spy(monkeypatch, module, name):
    """Records what every call of module.name returns (and its args)."""
    calls = []
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        value = real(*args, **kwargs)
        calls.append((args, kwargs, value))
        return value

    monkeypatch.setattr(module, name, wrapper)
    return calls


def same_keys(ref, port, path=""):
    """The reference's keys at every level of nesting, in the port's
    result; a None on either side (a sample that did not occur) stops
    the descent."""
    if ref is None or port is None:
        return
    if isinstance(ref, dict):
        assert isinstance(port, dict), path
        assert set(port) == set(ref), (path, sorted(port), sorted(ref))
        for k in ref:
            same_keys(ref[k], port[k], f"{path}.{k}")
    elif isinstance(ref, list) and ref and port:
        same_keys(ref[0], port[0], f"{path}[0]")
    else:
        assert type(port) is type(ref) or (
            isinstance(port, (int, float)) and isinstance(ref, (int, float))
            and not isinstance(port, bool)), (path, port, ref)


def held(key, ref, port):
    """The port's result has the reference's keys, and a number under
    each of the phase's REQUIRED keys."""
    same_keys(ref, port, key)
    missing = [m for m in bench.missing_numbers({key: port})
               if m.startswith(f"{key}.")]
    assert missing == []
