"""Hand-written Hopper kernels (CUDA C++, sm_90a), twin of
`unet_research_tpu/ops/pallas/`.

Every wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain PyTorch version, which lives in the same module, for CPU tensors.
Each wrapper counts its launches in a `launches` attribute."""
