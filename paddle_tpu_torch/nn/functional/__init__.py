"""Functionals of the PyTorch port (counterpart of
``paddle_tpu/nn/functional``): the activations, the common functionals,
the convolutions and their transposes, the pools, the norms, the losses
(all but the five ROADMAP Queue 1 item 10 names), attention with
``flashmask_attention``, and rope."""
from .activation import (  # noqa: F401
    celu, elu, elu_, gelu, glu, hardshrink, hardsigmoid, hardswish,
    hardtanh, hardtanh_, leaky_relu, leaky_relu_, log_sigmoid, log_softmax,
    maxout, mish, prelu, relu, relu6, relu_, rrelu, selu, sigmoid, silu,
    softmax, softmax_, softplus, softshrink, softsign, swish, tanh, tanh_,
    tanhshrink, thresholded_relu, thresholded_relu_)
from .attention import (  # noqa: F401
    flash_attention, flashmask_attention, scaled_dot_product_attention)
from .common import (  # noqa: F401
    alpha_dropout, bilinear, cosine_similarity, dropout, dropout2d,
    dropout3d, embedding, fold, interpolate, label_smooth, linear, normalize,
    one_hot, pad, pairwise_distance, pixel_shuffle, pixel_unshuffle, unfold,
    upsample)
from .conv import (conv1d, conv1d_transpose, conv2d,  # noqa: F401
                   conv2d_transpose, conv3d, conv3d_transpose)
from .loss import (  # noqa: F401
    binary_cross_entropy, binary_cross_entropy_with_logits,
    cosine_embedding_loss, cross_entropy, dice_loss, gaussian_nll_loss,
    hinge_embedding_loss, huber_loss, kl_div, l1_loss, log_loss,
    margin_ranking_loss, mse_loss, multi_label_soft_margin_loss,
    multi_margin_loss, nll_loss, poisson_nll_loss, sigmoid_focal_loss,
    smooth_l1_loss, soft_margin_loss, softmax_with_cross_entropy,
    square_error_cost, triplet_margin_loss,
    triplet_margin_with_distance_loss)
from .norm import (batch_norm, group_norm, instance_norm,  # noqa: F401
                   layer_norm, local_response_norm, rms_norm)
from .pooling import (  # noqa: F401
    adaptive_avg_pool1d, adaptive_avg_pool2d, adaptive_avg_pool3d,
    adaptive_max_pool1d, adaptive_max_pool2d, adaptive_max_pool3d,
    avg_pool1d, avg_pool2d, avg_pool3d, fractional_max_pool2d,
    fractional_max_pool3d, lp_pool1d, lp_pool2d, max_pool1d, max_pool2d,
    max_pool3d, max_unpool1d, max_unpool2d, max_unpool3d)
from .rope import (  # noqa: F401
    apply_rotary_pos_emb, fused_rotary_position_embedding,
    rotary_embedding_cos_sin)
