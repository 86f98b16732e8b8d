"""Client shim linking PyTorch processes to the dynolog_tpu daemon.

See shim.py for the full protocol description. Typical use:

    from dynolog_tpu_torch.client import enable
    client = enable(job_id="42")
    ...
    client.step()   # per training iteration, on the training thread
"""

from dynolog_tpu_torch.client.fabric import FabricClient
from dynolog_tpu_torch.client.shim import DynologClient, enable
from dynolog_tpu_torch.client.telemetry import (
    StepTracker,
    collect_device_metrics,
)

__all__ = [
    "DynologClient",
    "FabricClient",
    "StepTracker",
    "collect_device_metrics",
    "enable",
]
