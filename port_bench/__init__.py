"""The benchmark of asf_tpu_torch on an NVIDIA GPU (see run.py)."""
