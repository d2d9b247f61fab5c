"""Fused layer classes of the PyTorch port (counterpart of
``paddle_tpu/incubate/nn/layers.py``): ``FusedMultiHeadAttention``,
``FusedFeedForward``, ``FusedTransformerEncoderLayer``,
``FusedBiasDropoutResidualLayerNorm``, ``FusedLinear``,
``FusedDropoutAdd`` and ``FusedMultiTransformer`` as ``torch.nn.Module``s
over ``functional``.

Each keeps the JAX layer's parameter names, shapes and per-layer lists
(``FusedMultiTransformer``'s ``ln_scale_0``, ``qkv_weight_0``, ...) and
its defaults: Xavier-uniform weights (paddle's fans: [in, out] for a
matrix, dims 0 and 1 times the rest otherwise), ones for the norm
scales, zeros for the biases. Every parameter is float32 on ``device``
(default "cuda"), drawn from ``generator`` (a ``torch.Generator`` on that
device; None: one seeded from the port's seed chain). ``forward`` follows
``self.training`` as the JAX layer follows ``Layer.training``. The
``*_attr`` arguments are taken for the signature; the port has no
ParamAttr, so only the length of an attr list is read (it fixes
``FusedMultiTransformer``'s layer count). ``fused_layer_state_from_numpy``
carries a JAX layer's parameters over by name."""
import math

import numpy as np
import torch

from ...core import random as _random
from ...core.device import resolve_device
from ...core.random import make_generator
from ...nn.initializer import fan_in_out
from . import functional as F

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer",
           "FusedBiasDropoutResidualLayerNorm", "FusedLinear",
           "FusedDropoutAdd", "FusedMultiTransformer",
           "fused_layer_state_from_numpy"]


class _Init:
    """Where a layer draws its parameters: the device and the generator."""

    def __init__(self, device, generator):
        self.device = resolve_device(device)
        self.generator = generator if generator is not None else \
            make_generator(_random.fresh_seed(self.device), self.device)

    def xavier(self, shape):
        fi, fo = fan_in_out(shape)
        lim = math.sqrt(6.0 / (fi + fo))
        w = torch.empty(shape, dtype=torch.float32, device=self.device)
        return torch.nn.Parameter(w.uniform_(-lim, lim,
                                             generator=self.generator))

    def const(self, shape, value):
        return torch.nn.Parameter(torch.full(shape, float(value),
                                             dtype=torch.float32,
                                             device=self.device))


class FusedMultiHeadAttention(torch.nn.Module):
    """[pre-LN] -> QKV -> attention -> out projection -> residual
    [-> post-LN]: ``functional.fused_multi_head_attention``."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None, device="cuda",
                 generator=None):
        super().__init__()
        init = _Init(device, generator)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self._dropout_rate = dropout_rate
        self._attn_dropout_rate = attn_dropout_rate
        self._epsilon = epsilon
        self.qkv_weight = init.xavier([3, num_heads, self.head_dim,
                                       embed_dim])
        self.qkv_bias = init.const([3 * embed_dim], 0.0)
        self.linear_weight = init.xavier([embed_dim, embed_dim])
        self.linear_bias = init.const([embed_dim], 0.0)
        self.pre_ln_scale = init.const([embed_dim], 1.0)
        self.pre_ln_bias = init.const([embed_dim], 0.0)
        self.ln_scale = init.const([embed_dim], 1.0)
        self.ln_bias = init.const([embed_dim], 0.0)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        return F.fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            pre_ln_epsilon=self._epsilon, qkv_bias=self.qkv_bias,
            linear_bias=self.linear_bias, cache_kv=cache,
            attn_mask=attn_mask, dropout_rate=self._dropout_rate,
            attn_dropout_rate=self._attn_dropout_rate,
            ln_epsilon=self._epsilon, training=self.training)


class FusedFeedForward(torch.nn.Module):
    """[pre-LN] -> FC1 -> act -> FC2 -> residual [-> post-LN]:
    ``functional.fused_feedforward``."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks=1, ring_id=-1, name=None,
                 device="cuda", generator=None):
        super().__init__()
        init = _Init(device, generator)
        self._act = activation
        self._dropout_rate = dropout_rate
        self._act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                  else act_dropout_rate)
        self._epsilon = epsilon
        self.normalize_before = normalize_before
        self.linear1_weight = init.xavier([d_model, dim_feedforward])
        self.linear1_bias = init.const([dim_feedforward], 0.0)
        self.linear2_weight = init.xavier([dim_feedforward, d_model])
        self.linear2_bias = init.const([d_model], 0.0)
        self.ln1_scale = init.const([d_model], 1.0)
        self.ln1_bias = init.const([d_model], 0.0)
        self.ln2_scale = init.const([d_model], 1.0)
        self.ln2_bias = init.const([d_model], 0.0)

    def forward(self, src, cache=None):
        return F.fused_feedforward(
            src, self.linear1_weight, self.linear2_weight,
            linear1_bias=self.linear1_bias, linear2_bias=self.linear2_bias,
            ln1_scale=self.ln1_scale, ln1_bias=self.ln1_bias,
            ln2_scale=self.ln2_scale, ln2_bias=self.ln2_bias,
            dropout1_rate=self._act_dropout_rate,
            dropout2_rate=self._dropout_rate, activation=self._act,
            ln1_epsilon=self._epsilon, ln2_epsilon=self._epsilon,
            pre_layer_norm=self.normalize_before, training=self.training)


class FusedTransformerEncoderLayer(torch.nn.Module):
    """The fused attention block, then the fused feed-forward block."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 device="cuda", generator=None):
        super().__init__()
        init = _Init(device, generator)
        attn_dropout_rate = (dropout_rate if attn_dropout_rate is None
                             else attn_dropout_rate)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate,
            normalize_before=normalize_before, device=init.device,
            generator=init.generator)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, device=init.device,
            generator=init.generator)

    def forward(self, src, src_mask=None, cache=None):
        out = self.fused_attn(src, attn_mask=src_mask, cache=cache)
        if cache is not None:
            out, new_cache = out
            return self.ffn(out), new_cache
        return self.ffn(out)


class FusedBiasDropoutResidualLayerNorm(torch.nn.Module):
    """LayerNorm(dropout(x + bias) + residual)."""

    def __init__(self, embed_dim, dropout_rate=0.5, epsilon=1e-5,
                 bias_attr=None, ln_scale_attr=None, ln_bias_attr=None,
                 name=None, device="cuda", generator=None):
        super().__init__()
        init = _Init(device, generator)
        self._dropout_rate = dropout_rate
        self._epsilon = epsilon
        self.bias = init.const([embed_dim], 0.0)
        self.ln_scale = init.const([embed_dim], 1.0)
        self.ln_bias = init.const([embed_dim], 0.0)

    def forward(self, x, residual):
        return F.fused_bias_dropout_residual_layer_norm(
            x, residual, bias=self.bias, ln_scale=self.ln_scale,
            ln_bias=self.ln_bias, dropout_rate=self._dropout_rate,
            ln_epsilon=self._epsilon, training=self.training,
            generator=F._chain_generator(x.device)
            if self.training and self._dropout_rate > 0.0 else None)


class FusedLinear(torch.nn.Module):
    """x @ weight + bias, weight [in, out] (or [out, in] with
    ``transpose_weight``)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None,
                 device="cuda", generator=None):
        super().__init__()
        init = _Init(device, generator)
        shape = [out_features, in_features] if transpose_weight \
            else [in_features, out_features]
        self.weight = init.xavier(shape)
        self.bias = init.const([out_features], 0.0)
        self.transpose_weight = transpose_weight

    def forward(self, x):
        return F.fused_linear(x, self.weight, self.bias,
                              self.transpose_weight)


class FusedDropoutAdd(torch.nn.Module):
    """dropout(x) + y."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x, y):
        gen = F._chain_generator(x.device) \
            if self.training and self.p > 0.0 else None
        return F.fused_dropout_add(x, y, p=self.p, training=self.training,
                                   mode=self.mode, generator=gen)

    def extra_repr(self):
        return f"p={self.p}, mode={self.mode}"


# FusedMultiTransformer's per-layer lists: (list, parameter stem)
_LISTS = (("ln_scales", "ln_scale"), ("ln_biases", "ln_bias"),
          ("qkv_weights", "qkv_weight"), ("qkv_biases", "qkv_bias"),
          ("linear_weights", "linear_weight"),
          ("linear_biases", "linear_bias"),
          ("ffn_ln_scales", "ffn_ln_scale"),
          ("ffn_ln_biases", "ffn_ln_bias"),
          ("ffn1_weights", "ffn1_weight"), ("ffn1_biases", "ffn1_bias"),
          ("ffn2_weights", "ffn2_weight"), ("ffn2_biases", "ffn2_bias"))


class FusedMultiTransformer(torch.nn.Module):
    """The whole decoder stack as one op: ``num_layers`` x [LN -> QKV
    (+rope) -> cached attention -> out projection + residual -> LN -> FFN
    -> residual] through ``functional.fused_multi_transformer``, with the
    JAX layer's parameter layout (qkv [3, H, D, E], or [H + 2G, D, E]
    under GQA)."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu",
                 normalize_before=True, ln_scale_attrs=None,
                 ln_bias_attrs=None, qkv_weight_attrs=None,
                 qkv_bias_attrs=None, linear_weight_attrs=None,
                 linear_bias_attrs=None, ffn_ln_scale_attrs=None,
                 ffn_ln_bias_attrs=None, ffn1_weight_attrs=None,
                 ffn1_bias_attrs=None, ffn2_weight_attrs=None,
                 ffn2_bias_attrs=None, epsilon=1e-5, residual_alpha=1.0,
                 num_layers=-1, nranks=1, trans_qkvw=True, ring_id=-1,
                 name=None, norm_type="layernorm",
                 use_neox_rotary_style=False, gqa_group_size=-1,
                 device="cuda", generator=None):
        super().__init__()
        assert embed_dim > 0 and num_heads > 0 and dim_feedforward > 0
        if num_layers < 0:
            num_layers = len(qkv_weight_attrs) \
                if isinstance(qkv_weight_attrs, (list, tuple)) else 1
        init = _Init(device, generator)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self._epsilon = epsilon
        self._residual_alpha = residual_alpha
        self._trans_qkvw = trans_qkvw
        self._norm_type = norm_type
        self._use_neox_rotary_style = use_neox_rotary_style
        self._gqa_group_size = gqa_group_size
        self._dropout_rate = dropout_rate
        self.activation = activation
        self.num_layers = num_layers
        kv_heads = gqa_group_size if gqa_group_size > 0 else num_heads
        qkv_rows = num_heads + 2 * kv_heads
        hd = self.head_dim
        mha = kv_heads == num_heads
        ffn1_cols = dim_feedforward * (2 if "glu" in activation else 1)
        shapes = {
            "ln_scale": ([embed_dim], 1.0),
            "ln_bias": ([embed_dim], 0.0),
            "qkv_weight": ([3, num_heads, hd, embed_dim] if mha
                           else [qkv_rows, hd, embed_dim], None),
            "qkv_bias": ([3, num_heads, hd] if mha else [qkv_rows, hd], 0.0),
            "linear_weight": ([num_heads * hd, embed_dim], None),
            "linear_bias": ([embed_dim], 0.0),
            "ffn_ln_scale": ([embed_dim], 1.0),
            "ffn_ln_bias": ([embed_dim], 0.0),
            "ffn1_weight": ([embed_dim, ffn1_cols], None),
            "ffn1_bias": ([ffn1_cols], 0.0),
            "ffn2_weight": ([dim_feedforward, embed_dim], None),
            "ffn2_bias": ([embed_dim], 0.0)}
        for _, stem in _LISTS:
            shape, value = shapes[stem]
            for i in range(num_layers):
                self.register_parameter(
                    f"{stem}_{i}", init.xavier(shape) if value is None
                    else init.const(shape, value))

    def _list(self, stem):
        return [getattr(self, f"{stem}_{i}") for i in range(self.num_layers)]

    def forward(self, src, attn_mask=None, caches=None, pre_caches=None,
                rotary_embs=None, rotary_emb_dims=0, seq_lens=None,
                time_step=None):
        lists = {name: self._list(stem) for name, stem in _LISTS}
        return F.fused_multi_transformer(
            src, lists["ln_scales"], lists["ln_biases"],
            lists["qkv_weights"], lists["qkv_biases"],
            lists["linear_weights"], lists["linear_biases"],
            lists["ffn_ln_scales"], lists["ffn_ln_biases"],
            lists["ffn1_weights"], lists["ffn1_biases"],
            lists["ffn2_weights"], lists["ffn2_biases"],
            pre_layer_norm=self.normalize_before, epsilon=self._epsilon,
            residual_alpha=self._residual_alpha, cache_kvs=caches,
            pre_caches=pre_caches, seq_lens=seq_lens,
            rotary_embs=rotary_embs, time_step=time_step,
            attn_mask=attn_mask, dropout_rate=self._dropout_rate,
            rotary_emb_dims=rotary_emb_dims, activation=self.activation,
            training=self.training, trans_qkvw=self._trans_qkvw,
            norm_type=self._norm_type,
            use_neox_rotary_style=self._use_neox_rotary_style,
            gqa_group_size=self._gqa_group_size)


for _name, _stem in _LISTS:
    setattr(FusedMultiTransformer, _name,
            property(lambda self, stem=_stem: self._list(stem)))


def fused_layer_state_from_numpy(module, params):
    """Carry a JAX fused layer's parameters ({name: numpy array}, the JAX
    layer's ``named_parameters()`` names) into ``module`` in place, cast to
    each parameter's dtype on its device. Every parameter of the module
    must be given, at its shape, and no other name. Returns the module."""
    own = dict(module.named_parameters())
    missing = sorted(set(own) - set(params))
    unknown = sorted(set(params) - set(own))
    if missing or unknown:
        raise KeyError(f"fused_layer_state_from_numpy: missing {missing}, "
                       f"unknown {unknown}")
    with torch.no_grad():
        for name, p in own.items():
            a = np.array(params[name], copy=True)
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"fused_layer_state_from_numpy: {name} is "
                                 f"{tuple(a.shape)}, the module's "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.as_tensor(a).to(device=p.device, dtype=p.dtype))
    return module
