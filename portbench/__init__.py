"""The benchmark of bbtools_torch on one NVIDIA card (see run.py)."""
