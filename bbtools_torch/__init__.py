"""bbtools_torch — the PyTorch/CUDA port of bbtools_tpu.

The port keeps the JAX package's module paths (`core/`, `io/`, `ops/`,
`models/`) so each module's counterpart is easy to find, and is held
against it array for array and byte for byte. Host code (IO, index
builds, orchestration) is numpy, copied from the JAX package; device code
is torch on an explicit device (`device.py`); the TPU's Pallas kernels
become CUDA C++ kernels under `csrc/`, built at first CUDA use by
`kernels/build.py`.

Integer widths are explicit everywhere (k-mer keys are int64), so
nothing here switches a global default.
"""

__version__ = "0.1.0"
