"""StableAvatar in PyTorch on NVIDIA Hopper: the port of `stableavatar_tpu`.

The same functions under the same module paths as the JAX package
(`ops/flash_attention.py`, `models/dit.py:dit_forward`,
`pipelines/long.py:generate_long`, ...), on torch tensors with an explicit
device.  The attention kernels of the JAX package's Pallas code are
hand-written CUDA for sm_90a under `csrc/`, built at first use
(`ops/cuda_lib.py`); on CPU tensors each kernel wrapper runs its plain
PyTorch version instead.  Nothing here imports JAX; the model configs are
the dataclasses of `stableavatar_tpu.config`, which imports no JAX either.
"""

__version__ = "0.1.0"
