"""Ops of the PyTorch port with hand-written CUDA kernels: ragged paged
attention and the int4 weight-only matmul. Kernels are built at first
use (``_build``)."""
