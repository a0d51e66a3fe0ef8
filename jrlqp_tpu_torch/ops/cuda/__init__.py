"""Hand-written CUDA kernels (sources in jrlqp_tpu_torch/csrc/) and their
PyTorch wrappers and plain versions."""
