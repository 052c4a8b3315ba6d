"""PyTorch/CUDA port of the contrastive sEMG serving path.

The package mirrors the JAX package's file names so each
module's counterpart is easy to find, but it imports only torch, numpy and
scipy. Its hot path (the streaming tick chain) runs three hand-written CUDA
kernels for Hopper (``csrc/``), each with a plain PyTorch version beside it
(``ops/kernels.py``).

Entry points run on the CUDA device unless the caller asks for the CPU
(``device.select_device``).
"""
