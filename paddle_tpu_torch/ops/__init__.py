"""Ops of the PyTorch port with hand-written CUDA kernels: ragged paged
attention, the int4 weight-only matmul and flash attention (forward and
fused backward). Kernels are built at first use (``_build``)."""
