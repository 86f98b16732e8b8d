"""Per-device telemetry read inside the PyTorch process.

The counterpart of ``dynolog_tpu/client/telemetry.py``: the shim samples
what the process can see of its devices and pushes it to the daemon over
the rendezvous fabric, under the same record keys, so the daemon, the
fleet tree and ``dyno fleetstatus`` read a GPU host as they read a TPU
host. Sources:

  * ``torch.cuda`` — caching-allocator bytes (``memory_allocated`` /
    ``max_memory_allocated``) and the card's capacity (``mem_get_info``).
  * NVML, reached through ``ctypes`` (``libnvidia-ml.so.1``): the card's
    utilization. It stands where the reference reads the libtpu SDK, and
    fails soft in the same way: no library, no symbol, or an NVML error
    drops the key, never the push.
  * step cadence from ``DynologClient.step()`` calls (``StepTracker``).

Key mapping (reference: dynolog_tpu/client/telemetry.py:69-123):

  device                      host-local physical index (NVML's index,
                              matched to the torch ordinal by PCI bus id,
                              so a renumbering CUDA_VISIBLE_DEVICES does not
                              mislabel cards); the torch ordinal when NVML
                              is absent
  global_device_id            the torch ordinal
  platform, device_kind       "gpu" / torch.cuda.get_device_name
  hbm_used_bytes              torch.cuda.memory_allocated
  hbm_peak_bytes              torch.cuda.max_memory_allocated
  hbm_total_bytes             torch.cuda.mem_get_info()[1]
  hbm_util_pct                derived, as in the reference
  tensorcore_duty_cycle_pct   nvmlDeviceGetUtilizationRates().gpu

On a GPU ``tensorcore_duty_cycle_pct`` is the share of the last sample
period in which any kernel ran on the card (NVML's "gpu" utilization),
not tensor-pipe activity: NVML has no tensor-pipe counter. The key keeps
its name because the fleet tree's watchlist and HOST_BOUND rule
(native/src/fleettree/FleetTree.cpp) and ``dyno fleetstatus`` read it.

Memory is read only on cards whose caching allocator already holds
memory: ``mem_get_info`` on an untouched card would create a CUDA
context there (hundreds of MB) from the monitoring thread. A process
that has not initialised CUDA reports one CPU record, as the reference
does on its CPU backend.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Any

_NVML_SUCCESS = 0


class _NvmlUtilization(ctypes.Structure):
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


class Nvml:
    """The few NVML calls the collector needs, bound with ``ctypes``.

    Loads and initialises the library on first use; every method returns
    None when the library, the symbol or the device is unavailable. Tests
    substitute an object with the same three methods."""

    def __init__(self, lib_name: str = "libnvidia-ml.so.1"):
        self._lib_name = lib_name
        self._lib = None
        self._probed = False
        self._lock = threading.Lock()

    def _load(self):
        with self._lock:
            if self._probed:
                return self._lib
            self._probed = True
            try:
                lib = ctypes.CDLL(self._lib_name)
                init = getattr(lib, "nvmlInit_v2", None) or lib.nvmlInit
                init.restype = ctypes.c_int
                init.argtypes = []
                if init() != _NVML_SUCCESS:
                    return None
                lib.nvmlDeviceGetHandleByPciBusId_v2.restype = ctypes.c_int
                lib.nvmlDeviceGetHandleByPciBusId_v2.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
                lib.nvmlDeviceGetIndex.restype = ctypes.c_int
                lib.nvmlDeviceGetIndex.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)]
                lib.nvmlDeviceGetUtilizationRates.restype = ctypes.c_int
                lib.nvmlDeviceGetUtilizationRates.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(_NvmlUtilization)]
            except (OSError, AttributeError):
                return None
            self._lib = lib
            return lib

    def handle_by_pci_bus_id(self, bus_id: str):
        lib = self._load()
        if lib is None:
            return None
        handle = ctypes.c_void_p()
        rc = lib.nvmlDeviceGetHandleByPciBusId_v2(
            bus_id.encode("ascii"), ctypes.byref(handle))
        return handle.value if rc == _NVML_SUCCESS else None

    def index(self, handle) -> int | None:
        lib = self._load()
        if lib is None:
            return None
        idx = ctypes.c_uint()
        rc = lib.nvmlDeviceGetIndex(handle, ctypes.byref(idx))
        return int(idx.value) if rc == _NVML_SUCCESS else None

    def gpu_utilization(self, handle) -> int | None:
        lib = self._load()
        if lib is None:
            return None
        util = _NvmlUtilization()
        rc = lib.nvmlDeviceGetUtilizationRates(handle, ctypes.byref(util))
        return int(util.gpu) if rc == _NVML_SUCCESS else None


_nvml = Nvml()


def pci_bus_id(props) -> str | None:
    """NVML's bus-id string for a torch device-properties object
    ("domain:bus:device.function", hex), or None on a torch build whose
    properties lack the PCI fields."""
    try:
        return "%08X:%02X:%02X.0" % (
            int(props.pci_domain_id), int(props.pci_bus_id),
            int(props.pci_device_id))
    except (AttributeError, TypeError, ValueError):
        return None


def collect_device_metrics(step_stats: dict[str, float] | None = None,
                           cuda: Any = None,
                           nvml: Any = None) -> list[dict]:
    """One dict per visible device; numeric keys forwarded verbatim by
    the daemon into per-device logger records. ``cuda`` and ``nvml`` are
    injection points for tests (default: ``torch.cuda`` and the ctypes
    NVML binding)."""
    if cuda is None:
        import torch
        cuda = torch.cuda
    nvml = nvml or _nvml
    if not cuda.is_initialized():
        rec: dict[str, Any] = {"device": 0, "global_device_id": 0,
                               "platform": "cpu", "device_kind": "cpu"}
        if step_stats:
            rec.update(step_stats)
        return [rec]
    try:
        count = cuda.device_count()
    except RuntimeError:
        return [{"device": -1, "tpu_error": 1}]

    records = []
    for ordinal in range(count):
        rec = {"device": ordinal, "global_device_id": ordinal,
               "platform": "gpu"}
        bus_id = handle = None
        try:
            rec["device_kind"] = str(cuda.get_device_name(ordinal))
            bus_id = pci_bus_id(cuda.get_device_properties(ordinal))
            if cuda.memory_reserved(ordinal) > 0:
                used = int(cuda.memory_allocated(ordinal))
                total = int(cuda.mem_get_info(ordinal)[1])
                rec["hbm_used_bytes"] = used
                rec["hbm_peak_bytes"] = int(
                    cuda.max_memory_allocated(ordinal))
                rec["hbm_total_bytes"] = total
                if total:
                    rec["hbm_util_pct"] = round(100.0 * used / total, 3)
        except RuntimeError:
            rec["tpu_error"] = 1
        if bus_id is not None:
            handle = nvml.handle_by_pci_bus_id(bus_id)
        if handle is not None:
            physical = nvml.index(handle)
            if physical is not None:
                rec["device"] = physical
            util = nvml.gpu_utilization(handle)
            if util is not None:
                rec["tensorcore_duty_cycle_pct"] = float(util)
        if step_stats:
            rec.update(step_stats)
        records.append(rec)
    return records


class StepTracker:
    """Derives step rate / step time from ``DynologClient.step()`` calls."""

    def __init__(self):
        self.count = 0
        self.last_step_walltime = 0.0
        self._window_start_count = 0
        self._window_start_time = time.monotonic()

    def step(self) -> int:
        self.count += 1
        self.last_step_walltime = time.monotonic()
        return self.count

    def snapshot(self) -> dict[str, float] | None:
        """Rate over the window since the last snapshot; None before the
        first step() call (workload has no hook installed)."""
        if self.count == 0:
            return None
        now = time.monotonic()
        dt = now - self._window_start_time
        dn = self.count - self._window_start_count
        self._window_start_time = now
        self._window_start_count = self.count
        if dt <= 0 or dn <= 0:
            return {"tpu_steps_total": float(self.count)}
        return {
            "tpu_steps_total": float(self.count),
            "tpu_steps_per_s": round(dn / dt, 4),
            "tpu_step_time_ms": round(1000.0 * dt / dn, 3),
        }
