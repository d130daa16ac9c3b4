"""PyTorch/CUDA port of the ``repro`` package (SCOT/SMR-managed paged-KV
serving), beside the JAX reference.

The layout mirrors ``src/repro/`` file for file.  Host-only modules (the
paper's SMR schemes and structures, the runtime, the policies) are copies
of the reference's; the device side is PyTorch, with hand-written Hopper
kernels for the serving path under :mod:`repro_torch.kernels`.  Nothing
here imports JAX or the ``repro`` package."""
