"""dynolog_tpu_torch/client/telemetry.py — StepTracker windows and GPU
device collection.

The mapping cases of tests/test_telemetry.py, ported: torch.cuda is
monkeypatched with a fake card table and NVML is a fake with the
binding's three methods, so identity, memory, utilization and failure
paths are reachable without a GPU.
"""

import types

import pytest
import torch

from dynolog_tpu_torch.client import telemetry
from dynolog_tpu_torch.client.telemetry import (
    Nvml,
    StepTracker,
    collect_device_metrics,
    pci_bus_id,
)


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(telemetry.time, "monotonic", c)
    return c


def test_snapshot_none_before_first_step(clock):
    tr = StepTracker()
    assert tr.snapshot() is None
    clock.t += 100.0
    assert tr.snapshot() is None


def test_snapshot_rates(clock):
    tr = StepTracker()
    clock.t += 2.0
    for _ in range(4):
        tr.step()
    snap = tr.snapshot()
    assert snap["tpu_steps_total"] == 4.0
    assert snap["tpu_steps_per_s"] == pytest.approx(2.0)
    assert snap["tpu_step_time_ms"] == pytest.approx(500.0)
    clock.t += 1.0
    tr.step()
    snap = tr.snapshot()
    assert snap["tpu_steps_total"] == 5.0
    assert snap["tpu_steps_per_s"] == pytest.approx(1.0)


def test_snapshot_stalled_window_keeps_total_only(clock):
    tr = StepTracker()
    tr.step()
    tr.snapshot()
    clock.t += 10.0
    assert tr.snapshot() == {"tpu_steps_total": 1.0}


def test_snapshot_zero_dt_window(clock):
    tr = StepTracker()
    tr.step()
    assert tr.snapshot() == {"tpu_steps_total": 1.0}


# -- collect_device_metrics against a monkeypatched torch.cuda -------------


def _card(bus, allocated=0, peak=0, total=80 << 30, reserved=None,
          raises=False):
    return {"bus": bus, "allocated": allocated, "peak": peak, "total": total,
            "reserved": allocated if reserved is None else reserved,
            "raises": raises}


@pytest.fixture
def fake_cuda(monkeypatch):
    """Installs a card table behind torch.cuda; returns the setter and
    the list of ordinals mem_get_info was called on."""
    calls = []

    def install(cards, initialized=True, count_raises=False):
        def count():
            if count_raises:
                raise RuntimeError("driver gone")
            return len(cards)

        def checked(i):
            if cards[i]["raises"]:
                raise RuntimeError("card fell off the bus")
            return cards[i]

        def mem_get_info(i):
            calls.append(i)
            return (0, checked(i)["total"])

        patches = {
            "is_initialized": lambda: initialized,
            "device_count": count,
            "get_device_name": lambda i: f"Fake H100 #{i}",
            "get_device_properties": lambda i: types.SimpleNamespace(
                pci_domain_id=0, pci_bus_id=cards[i]["bus"],
                pci_device_id=0),
            "memory_reserved": lambda i: checked(i)["reserved"],
            "memory_allocated": lambda i: checked(i)["allocated"],
            "max_memory_allocated": lambda i: checked(i)["peak"],
            "mem_get_info": mem_get_info,
        }
        for name, fn in patches.items():
            monkeypatch.setattr(torch.cuda, name, fn)

    install.mem_get_info_calls = calls
    return install


class _FakeNvml:
    """bus id -> (physical index, gpu utilization %)."""

    def __init__(self, table):
        self._table = table

    def handle_by_pci_bus_id(self, bus_id):
        return bus_id if bus_id in self._table else None

    def index(self, handle):
        return self._table[handle][0]

    def gpu_utilization(self, handle):
        return self._table[handle][1]


def _bus(n):
    return "%08X:%02X:%02X.0" % (0, n, 0)


def test_no_backend_yields_error_record(fake_cuda):
    fake_cuda([], count_raises=True)
    recs = collect_device_metrics(nvml=_FakeNvml({}))
    assert recs == [{"device": -1, "tpu_error": 1}]


def test_memory_mapping_nvml_and_step_merge(fake_cuda):
    fake_cuda([_card(0x3B, allocated=600, peak=800, total=1000)])
    recs = collect_device_metrics(
        step_stats={"tpu_steps_total": 7.0},
        nvml=_FakeNvml({_bus(0x3B): (3, 42)}))
    (rec,) = recs
    assert rec["device"] == 3             # NVML's physical index
    assert rec["global_device_id"] == 0   # the torch ordinal
    assert rec["platform"] == "gpu"
    assert rec["device_kind"] == "Fake H100 #0"
    assert rec["hbm_used_bytes"] == 600
    assert rec["hbm_total_bytes"] == 1000
    assert rec["hbm_peak_bytes"] == 800
    assert rec["hbm_util_pct"] == pytest.approx(60.0)
    assert rec["tensorcore_duty_cycle_pct"] == 42.0
    assert rec["tpu_steps_total"] == 7.0
    assert "tpu_error" not in rec


def test_memory_failure_marks_record_only(fake_cuda):
    fake_cuda([_card(1, raises=True), _card(2, allocated=1, total=2)])
    recs = collect_device_metrics(
        nvml=_FakeNvml({_bus(1): (0, 5), _bus(2): (1, 6)}))
    assert recs[0]["tpu_error"] == 1
    assert "hbm_used_bytes" not in recs[0]
    assert "tpu_error" not in recs[1]  # one bad card, not a bad push
    assert recs[1]["hbm_used_bytes"] == 1
    assert recs[1]["hbm_util_pct"] == pytest.approx(50.0)
    # The failed memory read does not cost the card its NVML reading.
    assert recs[0]["tensorcore_duty_cycle_pct"] == 5.0


def test_renumbered_visible_devices_match_nvml_by_bus_id(fake_cuda):
    # CUDA_VISIBLE_DEVICES=5,2: torch ordinal 0 is physical card 5 and
    # ordinal 1 is card 2. Matching by index would swap both the label
    # and the utilization; matching by PCI bus id keeps them together.
    fake_cuda([_card(0xB5, allocated=10), _card(0x22, allocated=20)])
    nvml = _FakeNvml({_bus(0x22): (2, 20), _bus(0xB5): (5, 90)})
    recs = collect_device_metrics(nvml=nvml)
    assert [(r["device"], r["global_device_id"]) for r in recs] == [
        (5, 0), (2, 1)]
    assert [r["tensorcore_duty_cycle_pct"] for r in recs] == [90.0, 20.0]
    assert [r["hbm_used_bytes"] for r in recs] == [10, 20]


def test_without_nvml_ordinal_labels_and_no_duty_key(fake_cuda):
    fake_cuda([_card(0x3B, allocated=4)])
    (rec,) = collect_device_metrics(nvml=_FakeNvml({}))
    assert rec["device"] == 0
    assert "tensorcore_duty_cycle_pct" not in rec
    assert rec["hbm_used_bytes"] == 4


def test_untouched_card_reports_no_memory_and_creates_no_context(fake_cuda):
    fake_cuda([_card(1, allocated=8), _card(2, reserved=0)])
    recs = collect_device_metrics(nvml=_FakeNvml({_bus(2): (1, 0)}))
    assert fake_cuda.mem_get_info_calls == [0]
    assert "hbm_total_bytes" not in recs[1]
    assert recs[1]["tensorcore_duty_cycle_pct"] == 0.0


def test_process_without_cuda_reports_one_cpu_record(fake_cuda):
    fake_cuda([_card(1)], initialized=False)
    recs = collect_device_metrics(step_stats={"tpu_steps_total": 2.0},
                                  nvml=_FakeNvml({}))
    assert recs == [{"device": 0, "global_device_id": 0, "platform": "cpu",
                     "device_kind": "cpu", "tpu_steps_total": 2.0}]


def test_real_cpu_backend_smoke():
    # The real (CPU-only here) torch: one CPU record with the identity
    # fields, as the reference reports on its CPU backend.
    recs = collect_device_metrics(step_stats={"tpu_steps_total": 1.0})
    assert len(recs) == 1
    rec = recs[0]
    assert rec["platform"] == "cpu"
    assert "device" in rec and "global_device_id" in rec
    assert rec["tpu_steps_total"] == 1.0


def test_nvml_binding_fails_soft_without_library():
    nvml = Nvml("libnvidia-ml-missing.so.1")
    assert nvml.handle_by_pci_bus_id(_bus(1)) is None
    assert nvml.index(None) is None
    assert nvml.gpu_utilization(None) is None


def test_pci_bus_id_format():
    props = types.SimpleNamespace(pci_domain_id=1, pci_bus_id=0xCB,
                                  pci_device_id=3)
    assert pci_bus_id(props) == "00000001:CB:03.0"
    assert pci_bus_id(types.SimpleNamespace()) is None
