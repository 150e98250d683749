"""PyTorch/CUDA port of fairfedmed_tpu for NVIDIA Hopper GPUs.

Module paths and function names follow the JAX package's.  Attention runs
through hand-written CUDA kernels (``ops/attention.py``, ``csrc/``) on the
GPU and through their plain PyTorch versions on the CPU.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
