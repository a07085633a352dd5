"""AritPIM on PyTorch and hand-written Hopper kernels.

The counterpart of the JAX package ``repro``: the same gate-program IR and
arithmetic builders, executed by a CUDA slot-scan kernel on an NVIDIA GPU
(``kernels.pim_exec``) or by its plain PyTorch version (``kernels.slots``).
Entry point: :mod:`repro_torch.pim_ufunc`.
"""
