"""Ops of the PyTorch port with hand-written CUDA kernels: ragged paged
attention, the int4 weight-only matmul, flash attention (forward and
fused backward, with optional rope; the two-pass backward), the
blockwise LM-head cross entropy (forward, dh and dw), FlashMask
attention (forward, dq, dk / dv), and the training step's fused tier:
RMSNorm with its residual (``fused_norm``), SwiGLU (``swiglu``), the
streamed token cross entropy (``token_ce``) and AdamW with the clip
(``adamw``). Kernels are built at first use (``_build``)."""
