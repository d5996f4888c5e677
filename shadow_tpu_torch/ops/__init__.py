"""Device kernels for the per-round network data plane.

Each kernel is hand-written CUDA (``shadow_tpu_torch/csrc``) beside a plain
PyTorch version of the same function in the same module; a wrapper launches
the kernel for CUDA tensors and runs the plain version only for CPU tensors.
The two agree bit for bit (tests/test_torch_propagate.py on the CPU,
chip_smoke.py on the card).
"""
