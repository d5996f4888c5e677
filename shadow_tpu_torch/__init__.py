"""shadow_tpu_torch — the PyTorch/CUDA port of the shadow_tpu simulator.

A second package beside ``shadow_tpu`` with the same CLI, the same YAML
configs and the same outputs, byte for byte. Host-side simulation code stays
numpy, as in ``shadow_tpu``; the device data plane (the batched per-packet
loss draws) runs as hand-written CUDA kernels on an NVIDIA GPU
(``shadow_tpu_torch/csrc``), launched through PyTorch's stream and memory.

This package never imports ``jax`` nor anything of ``shadow_tpu``: what it
needs of the reference it keeps as its own copy. It runs every config the
reference runs, on one card or over several device entries (``--device``).
"""

__version__ = "0.1.0"

from shadow_tpu_torch.core.time import SimTime, EmulatedTime  # noqa: F401

__all__ = ["SimTime", "EmulatedTime", "__version__"]
