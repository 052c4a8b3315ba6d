"""PyTorch/CUDA port of the contrastive sEMG system.

The package mirrors the JAX package's file names so each module's
counterpart is easy to find, but it imports only torch, numpy and scipy.
Two paths are ported: streaming serve (``serve/stream.py``,
``cptorch-serve``), whose tick chain runs three hand-written CUDA kernels,
and training (``train/``, ``cptorch-train``): contrastive, with one-hot
or glove-encoded class embeddings, whose loss and its gradient run the
hand-written K1 pair, and the softmax baseline (``--prediction``). The kernels are Hopper CUDA C++
(``csrc/``), each with a plain PyTorch version beside it
(``ops/kernels.py``).

Entry points run on the CUDA device unless the caller asks for the CPU
(``device.select_device``).
"""
