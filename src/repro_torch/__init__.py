"""PyTorch/CUDA port of the MetaTT system (the JAX package in src/repro is
the reference). Runs on an NVIDIA Hopper GPU; the CPU is used only when a
caller passes device="cpu"."""
