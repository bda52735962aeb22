"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``csrc/`` holds the sources, ``_build`` compiles and loads them).

Importing this package registers the serving kernels' PyTorch custom ops
(``torch.ops.mrn_tpu_torch.fused_block``, ``fused_block_int8`` and
``grid_sample``), which a saved ``torch.export`` program calls: import it
before ``torch.export.load``."""

from mrn_tpu_torch.ops import grid_sample, svtr_block  # noqa: F401  (registers the custom ops)
