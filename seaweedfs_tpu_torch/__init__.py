"""seaweedfs_tpu_torch — the EC data path of seaweedfs_tpu on PyTorch and
CUDA for one NVIDIA H100 (Hopper, sm_90a).

It mirrors the JAX package's layout (ops/, ec/, storage/, server/,
stats/, util/) and keeps its own copy of everything it needs: it imports
torch and numpy, never jax and nothing of seaweedfs_tpu. Entry points run on the card by
default (device="cuda") and raise when there is none; the CPU is used
only when the caller passes device="cpu".
"""
