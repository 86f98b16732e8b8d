"""dynolog_tpu_torch — the PyTorch side of dynolog_tpu.

The counterpart of the ``dynolog_tpu`` package for PyTorch processes on
NVIDIA GPUs, laid out the same way: the client shim that links a
training process to the C++ daemon and ``dyno`` CLI (``client``), the
observed training workload (``models``, ``parallel``) and protocol
utilities (``utils``). It speaks the same wire protocols to the same
daemon binaries, and imports nothing of JAX or of ``dynolog_tpu``.
"""

__version__ = "0.1.0"
