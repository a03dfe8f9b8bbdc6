"""Hand-written CUDA kernels: build and load (`_build`).  Each kernel's
wrapper lives beside the op that uses it (K1: `subgraph.fused_ops`)."""
