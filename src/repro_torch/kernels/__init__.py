"""Hand-written Hopper kernels of the port and their wrappers.

Every kernel module holds the CUDA wrapper and the kernel's plain PyTorch
version: a wrapper given CPU tensors runs the plain version, given CUDA
tensors it launches the kernel (built from ``repro_torch/csrc`` at first
use) or raises.  Importing this package builds and loads nothing.
"""
