"""Hand-written CUDA kernels (sources in ``radio_mapper_tpu_torch/csrc``).

Each wrapper module holds the kernel's launcher, its plain PyTorch
version and a launch counter. A wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""
