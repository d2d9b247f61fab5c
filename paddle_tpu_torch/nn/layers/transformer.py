"""Transformer layers of the PyTorch port (counterpart of
``paddle_tpu/nn/layers/transformer.py``): ``MultiHeadAttention``,
``TransformerEncoderLayer`` and ``TransformerEncoder``.

Attention goes through ``F.scaled_dot_product_attention``: without a mask
and without dropout in training it is ``flash_attention``, non-causal,
the CUDA kernels K1 / K2 on the card (a head dim they do not take
raises there); with a mask, or with dropout while training, the plain
``_sdpa_ref``, as the JAX layer routes it. ``TransformerEncoder``
deep-copies its layer, so every layer starts from the same weights, as
in the JAX package."""
import copy

import torch

from ...core.device import DEFAULT_DEVICE
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm


class MultiHeadAttention(torch.nn.Module):
    """q / k / v / out projections around the attention; keys and values
    of width ``kdim`` / ``vdim`` (cross-attention). ``cache`` (a dict):
    the new keys and values are appended to its "k" / "v" along the
    sequence and stored back."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"MultiHeadAttention: embed_dim {embed_dim} is "
                             f"not a multiple of num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(generator=generator, device=device,
                  weight_attr=weight_attr, bias_attr=bias_attr)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, **kw)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        b, s_q = query.shape[0], query.shape[1]
        h, d = self.num_heads, self.head_dim
        q = self.q_proj(query).reshape(b, s_q, h, d)
        k = self.k_proj(key).reshape(b, key.shape[1], h, d)
        v = self.v_proj(value).reshape(b, value.shape[1], h, d)
        if cache is not None:
            k = _concat_cache(cache, "k", k)
            v = _concat_cache(cache, "v", v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        return self.out_proj(out.reshape(b, s_q, self.embed_dim))


def _concat_cache(cache, name, new):
    prev = cache.get(name)
    if prev is not None:
        new = torch.cat([prev, new], dim=1)
    cache[name] = new
    return new


class TransformerEncoderLayer(torch.nn.Module):
    """Self-attention then the feed-forward block, each with a residual
    and a LayerNorm, before (``normalize_before``) or after it."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        init = dict(generator=generator, device=device)
        attrs = dict(weight_attr=weight_attr, bias_attr=bias_attr, **init)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **attrs)
        self.linear1 = Linear(d_model, dim_feedforward, **attrs)
        self.linear2 = Linear(dim_feedforward, d_model, **attrs)
        self.norm1 = LayerNorm(d_model, **init)
        self.norm2 = LayerNorm(d_model, **init)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = residual + self.dropout1(self.self_attn(src,
                                                      attn_mask=src_mask))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(torch.nn.Module):
    """``num_layers`` copies of ``encoder_layer`` (the first is the layer
    itself), then ``norm`` when given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] +
                                [copy.deepcopy(encoder_layer)
                                 for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        return out if self.norm is None else self.norm(out)
