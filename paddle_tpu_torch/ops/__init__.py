"""Ops of the PyTorch port with hand-written CUDA kernels: ragged paged
attention, the int4 weight-only matmul, flash attention (forward and
fused backward, with optional rope; the two-pass backward), the
blockwise LM-head cross entropy (forward, dh and dw) and FlashMask
attention (forward, dq, dk / dv). Kernels are built at first use
(``_build``)."""
