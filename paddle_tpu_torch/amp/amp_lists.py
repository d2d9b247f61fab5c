"""O1/O2 op dtype lists of the PyTorch port (a copy of
``paddle_tpu/amp/amp_lists.py``; reference python/paddle/amp/amp_lists.py).

Names are Paddle's op names: the port's named functional entries carry
them (``amp._hook.amp_op``) and its torch-function mode maps torch calls
onto them (``amp._hook.TORCH_NAMES``). White = tensor-core-bound ops that
benefit from bf16 / fp16; black = numerically sensitive ops pinned to
fp32 (reductions, exp/log chains, losses, norms).
"""

WHITE_LIST = {
    "matmul", "mm", "bmm", "addmm", "mv", "inner", "outer", "einsum",
    "linear", "linear_zb_dx", "conv1d", "conv2d", "conv3d", "conv1d_transpose",
    "conv2d_transpose", "conv3d_transpose", "flash_attention",
    "scaled_dot_product_attention", "fused_rotary_position_embedding",
    "fused_gemm_epilogue",
}

BLACK_LIST = {
    "exp", "expm1", "log", "log2", "log10", "log1p", "logsumexp",
    "logcumsumexp", "square", "pow", "rsqrt", "softmax", "log_softmax",
    "cross_entropy", "softmax_with_cross_entropy", "nll_loss",
    "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "sigmoid_cross_entropy_with_logits", "kl_div", "cos_sim",
    "mean", "sum", "prod", "cumsum", "cumprod", "norm", "p_norm",
    "layer_norm", "batch_norm", "instance_norm", "group_norm", "rms_norm",
    "softplus", "erf", "erfinv", "lgamma", "digamma",
}

# OD ("default") mode: only explicitly white ops are cast down
_OD_WHITE = {"matmul", "mm", "bmm", "conv2d", "linear", "linear_zb_dx",
             "flash_attention"}


def _get_lists(level):
    if level == "OD":
        return set(_OD_WHITE), set()
    return set(WHITE_LIST), set(BLACK_LIST)


def white_list():
    return set(WHITE_LIST)


def black_list():
    return set(BLACK_LIST)
