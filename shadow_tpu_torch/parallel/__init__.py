"""The mesh data plane of the tpu_mesh policy (parallel/mesh.py): hosts
sharded over N shards, one round or one causal window of the network as
hand-written CUDA kernels (csrc/mesh.cu) beside plain PyTorch versions."""
