"""PyTorch/CUDA port of poseidon_tpu: the firmament scheduler service with
the cost-scaling push-relabel solver on an NVIDIA GPU.

The JAX package ``poseidon_tpu`` stays the reference; this package imports
torch and none of it.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""
