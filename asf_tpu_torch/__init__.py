"""PyTorch/CUDA port of ``asf_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package imports nothing of it
(nor JAX). Plain tensor code is PyTorch and cuDNN; every Pallas kernel of
the JAX package on the ported path is a CUDA C++ kernel under ``csrc/``,
built with ``nvcc`` for ``sm_90a`` at first use and bound with ``ctypes``
(``ops/_build.py``). Entry points run on CUDA unless the caller passes
``device="cpu"``; a CPU tensor takes each kernel's plain PyTorch version.
"""
