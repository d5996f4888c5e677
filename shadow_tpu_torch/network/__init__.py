"""Network model: topology graph, routing, packets, token-bucket routers.

Mirrors the reference's ``src/main/network`` + ``src/main/routing`` layers
(SURVEY.md §1 layers 7-8). The loss draws have twin implementations: a
numpy host twin (network/fluid.py::loss_flags) and the CUDA device kernels
(ops/propagate.py), which must agree bit-for-bit.
"""
