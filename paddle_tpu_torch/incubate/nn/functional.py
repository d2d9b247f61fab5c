"""Fused decoder-stack ops, the fused attention, feed-forward and var-len
attention functions, the fused decode-attention ops and FlashMask
attention of the PyTorch port (counterpart of
``paddle_tpu/incubate/nn/functional/__init__.py``:
``fused_multi_transformer`` with its helpers and its int8 / int4
wrappers, ``masked_multihead_attention``, ``block_multihead_attention``,
``block_kv_cache_rewind``, ``blha_get_max_len``, ``flashmask_attention``),
and the training step's fused tier of that module: ``fused_rms_norm``
(RMSNorm of x + bias + residual, kernel A of ``ops.fused_norm``),
``swiglu`` and ``fused_bias_act``'s swiglu (kernel B of ``ops.swiglu``),
and in plain PyTorch, as the JAX package computes them in plain XLA,
``fused_layer_norm``, ``fused_bias_dropout_residual_layer_norm``,
``fused_dropout_add``, ``fused_bias_act``'s other activations,
``fused_matmul_bias``, ``fused_linear``, ``fused_linear_activation``,
``fused_linear_param_grad_add``, ``fused_multi_head_attention``,
``fused_feedforward`` and ``variable_length_memory_efficient_attention``.
Dropout draws from an explicit ``generator`` (the default one when None)
where the function takes one, else from the port's seed chain
(``core.random``: a fresh seed a draw, as a JAX op takes a fresh key):
the bits differ from JAX's, the keep rate and the scaling do not.

``fused_multi_transformer`` keeps the JAX package's three branches and
its cast points:

* dense prefill (no ``time_step``): causal attention over the prompt,
  caches [2, B, KVH, S_max, D] filled from position 0;
* dense decode (``time_step`` given, contiguous caches): one token per
  sequence at a shared time step, or at per-sequence ``seq_lens``;
* paged (``block_tables`` given): the continuous-batching step. New K/V
  append into [2, KVH, NB, BS, D] caches through the host-filtered write
  set, and attention runs ``ops.paged_attention.ragged_paged_attention``
  (the CUDA kernel on the card). ``chunk_lens`` switches from one decode
  token per row to chunked prefill.

Caches are updated IN PLACE; the function returns the output hidden
states. The TPU work-list arguments of the JAX signature (``ragged_work``,
``ragged_pack``, ``kv_buffer_depth``) have no counterpart: the CUDA
kernel walks the block tables. The options, as the JAX package has them:
``pre_caches`` (per layer [2, B, KVH, S_pre, D]) put a prompt prefix's
keys before the new ones in dense prefill, every new row seeing the whole
prefix, and the cache fills with prefix + new from position 0;
``attn_mask`` (additive, [B, H, S, S_kv]-broadcastable, H the query
heads under MHA, 1 under GQA) adds to the f32 logits before the causal /
position mask in dense prefill and dense decode; ``training`` with
``dropout_rate`` drops the out-projection output before the residual,
one draw a layer from the seed chain, upscaled by 1 / (1 - p) under
"upscale_in_train" and only zeroed under any other mode, and nothing in
eval. Refused as the JAX package refuses them: ``pre_caches`` with
``time_step``, ``attn_mask`` on the paged path, ``beam_offset``; the
tensor-parallel ``_tp_reduce`` hook is a later slice. A stored weight
whose dequantized form is float32 meets bf16 activations as in JAX: the
product runs in the promoted dtype.

The fused decode-attention ops keep the JAX signatures and return order.
``block_multihead_attention`` appends the new token with
``ops.paged_attention.update_paged_kv_cache`` and attends through
``ops.paged_attention.paged_attention`` (the legacy decode kernel on the
card); ``masked_multihead_attention`` is plain torch, as it is plain jnp
in JAX. Outputs are new tensors; the caches are updated IN PLACE and
returned.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F

from ...core import random as _random
from ...core.random import make_generator
from ...ops import flashmask as _fm
from ...ops import fused_norm as _fn
from ...ops import paged_attention as _pa
from ...ops.swiglu import swiglu as _swiglu

NEG_INF_F = -1e30

__all__ = ["blha_get_max_len", "block_kv_cache_rewind",
           "block_multihead_attention", "flashmask_attention",
           "fused_bias_act", "fused_bias_dropout_residual_layer_norm",
           "fused_dropout_add", "fused_feedforward", "fused_layer_norm",
           "fused_linear", "fused_linear_activation",
           "fused_linear_param_grad_add", "fused_matmul_bias",
           "fused_multi_head_attention", "fused_multi_transformer",
           "fused_multi_transformer_int4", "fused_multi_transformer_int8",
           "fused_rms_norm", "masked_multihead_attention", "quantize_int4",
           "swiglu", "variable_length_memory_efficient_attention"]


def _ln(h, eps, scale=None, bias=None):
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    out = (h - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    return out


def _rms(h, eps, scale=None):
    out = h * torch.rsqrt((h * h).mean(-1, keepdim=True) + eps)
    return out * scale if scale is not None else out


def _apply_rope_pair(q, k, cos, sin, neox):
    """q/k: [B, S, H, D]; cos/sin broadcastable [B, S, 1, D]."""
    if neox:
        half = q.shape[-1] // 2

        def rot(t):
            return torch.cat([-t[..., half:], t[..., :half]], dim=-1)
    else:
        def rot(t):
            t2 = t.reshape(*t.shape[:-1], -1, 2)
            r = torch.stack([-t2[..., 1], t2[..., 0]], dim=-1)
            return r.reshape(t.shape)
    return q * cos + rot(q) * sin, k * cos + rot(k) * sin


def _ragged_group_q(qkv_weights, gqa_group_size, trans_qkvw):
    """Queries per kv head, recovered from the packed qkv weight layout."""
    shape = qkv_weights[0].shape
    if gqa_group_size and gqa_group_size > 0:
        ht = shape[0] if trans_qkvw else shape[1]
        return (ht - 2 * gqa_group_size) // gqa_group_size
    return 1


def quantize_int4(w, axis=-1, group_size=None):
    """Pack a float weight into (packed int8 nibbles, scales): symmetric
    per-channel (or per-group) absmax quantization along the INPUT axis
    `axis`; two consecutive int4 values pack into one int8 byte (low
    nibble first) along that axis. Returns numpy (packed, scales): packed
    has `axis` halved; scales broadcast over `axis`."""
    if isinstance(w, torch.Tensor):
        w = w.detach().float().cpu().numpy()
    a = np.asarray(w, np.float32)
    a = np.moveaxis(a, axis, -1)
    n = a.shape[-1]
    if n % 2:
        raise ValueError("int4 packing needs an even axis length")
    g = group_size or n
    if n % g:
        raise ValueError("group_size must divide the quantized axis")
    grp = a.reshape(*a.shape[:-1], n // g, g)
    sc = np.abs(grp).max(-1, keepdims=True) / 7.0 + 1e-9
    q = np.clip(np.round(grp / sc), -8, 7).astype(np.int8)
    q = q.reshape(*a.shape[:-1], n)
    lo, hi = q[..., 0::2], q[..., 1::2]
    packed = ((hi.astype(np.uint8) << 4) |
              (lo.astype(np.uint8) & 0x0F)).astype(np.int8)
    packed = np.moveaxis(packed, -1, axis % a.ndim if axis >= 0 else axis)
    scales = np.moveaxis(sc[..., 0], -1, axis % a.ndim if axis >= 0
                         else axis)
    return packed, scales.astype(np.float32)


def _unpack_int4(p, axis=-1):
    """int8-packed nibbles (torch) -> int4 values (sign-extended, int8),
    `axis` doubled, low nibble first."""
    m = torch.movedim(p, axis, -1)
    u = m.to(torch.int16) & 0xFF
    lo = u & 0x0F
    hi = u >> 4
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], -1).reshape(*m.shape[:-1], m.shape[-1] * 2)
    return torch.movedim(out.to(torch.int8), -1, axis)


def _matmul(a, w):
    """a @ w in the promoted dtype of the two (jnp's rule: bf16 activations
    against a float32 dequantized weight compute in float32)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return torch.matmul(a.to(dt), w.to(dt))


def _paged_inputs(block_tables, seq_lens, chunk_lens, chunk, num_blocks,
                  block_size, device):
    """Everything the paged branch needs from the host, computed and
    uploaded ONCE per call (not per layer): the block tables, the
    attention lengths (seq_lens + span), the query spans, the rope
    positions and the cache write set."""
    tables = _pa._host_array(block_tables, np.int32)
    lens = _pa._host_array(seq_lens).reshape(-1)
    if chunk_lens is None:
        qls = np.ones_like(lens)
    else:
        qls = _pa._host_array(chunk_lens).reshape(-1)
    src, dst = _pa.paged_write_index(tables, lens, qls, chunk, num_blocks,
                                     block_size)

    up = _pa._on_device
    return {"tables": up(tables, device, torch.int32),
            "attn_lens": up(lens + qls, device, torch.int32),
            "q_lens": None if chunk_lens is None
            else up(qls, device, torch.int32),
            "lens": up(lens, device, torch.long),
            "src": up(src, device, torch.long),
            "dst": up(dst, device, torch.long)}


def fused_multi_transformer(
        x, ln_scales, ln_biases, qkv_weights, qkv_biases, linear_weights,
        linear_biases, ffn_ln_scales, ffn_ln_biases, ffn1_weights,
        ffn1_biases, ffn2_weights, ffn2_biases, pre_layer_norm=True,
        epsilon=1e-5, residual_alpha=1.0, cache_kvs=None, beam_offset=None,
        pre_caches=None, seq_lens=None, rotary_embs=None, time_step=None,
        attn_mask=None, dropout_rate=0.0, rotary_emb_dims=0,
        activation="gelu", training=False, mode="upscale_in_train",
        trans_qkvw=True, ring_id=-1, norm_type="layernorm",
        use_neox_rotary_style=False, gqa_group_size=-1, name=None,
        block_tables=None, chunk_lens=None, _dequant=None, _mm=None,
        _tp_reduce=None):
    """Whole-decoder-stack fused transformer: [LN -> QKV proj (+rope) ->
    cached attention -> out proj + residual -> LN -> FFN -> residual] x
    n_layers, one call for every layer.

    Shapes (trans_qkvw=True): x [B, S, E]; qkv_weight [3, H, D, E] (or
    [H + 2G, D, E] under GQA: H query heads, then G key heads, then G
    value heads); linear_weight [H*D, E]; ffn1_weight [E, F] (or [E, 2F]
    for *glu activations); ffn2 [F, E]; dense caches [2, B, KVH, S_max, D];
    paged caches [2, KVH, num_blocks, block_size, D] with block_tables
    [B, max_blocks] and per-sequence seq_lens; rotary_embs
    [2, B, 1, S_rope, D] (cos, sin); time_step: decode position (decode
    mode when given).

    Paged mode: x [B, 1, E] appends one token per row at slot seq_lens;
    with ``chunk_lens`` [B], x [B, C, E] appends chunk_lens[b] tokens at
    seq_lens[b].. and each attends causally to its own prefix
    (chunk_lens[b] == 0 parks the row: nothing written, output zero).
    Block tables and lengths are host data (numpy or tensors).

    ``_mm(z2d, w, kind, li)`` (with ``_mm.qkv_out``) replaces the four
    projection matmuls (the weight-only-quantized GEMM); ``_dequant(w,
    kind, li)`` maps a stored weight to its float form.

    Returns the output hidden states [B, S, E]; caches are updated in
    place."""
    if beam_offset is not None:
        raise NotImplementedError(
            "fused_multi_transformer: beam_offset unsupported")
    if _tp_reduce is not None:
        raise NotImplementedError("fused_multi_transformer: tensor-parallel "
                                  "reduction is a later slice")
    if chunk_lens is not None and block_tables is None:
        raise ValueError(
            "fused_multi_transformer: chunk_lens (chunked prefill) is a "
            "paged-cache feature — pass block_tables too")
    if pre_caches is not None and time_step is not None:
        raise NotImplementedError(
            "fused_multi_transformer: pre_caches apply to the context/"
            "prefill phase; at decode time the prefix already lives in "
            "cache_kvs (run prefill with pre_caches first)")
    caches = list(cache_kvs) if cache_kvs is not None else []
    b, s, e = x.shape
    paged = None
    if block_tables is not None:
        if time_step is None or seq_lens is None:
            raise ValueError(
                "fused_multi_transformer: the paged-cache path is decode-"
                "only — pass time_step and per-sequence seq_lens with "
                "block_tables")
        if not caches:
            raise ValueError(
                "fused_multi_transformer: block_tables without cache_kvs "
                "— the paged path needs the per-layer paged caches")
        if s != 1 and chunk_lens is None:
            raise ValueError(
                "fused_multi_transformer: paged decode takes one token "
                f"per sequence (x [B, 1, E]); got {list(x.shape)} — a "
                "multi-token chunk slab needs per-sequence chunk_lens")
        if attn_mask is not None:
            raise NotImplementedError(
                "fused_multi_transformer: attn_mask unsupported on the "
                "paged decode path")
        _, _, nb, bs, _ = caches[0].shape
        paged = _paged_inputs(block_tables, seq_lens, chunk_lens, s, nb, bs,
                              x.device)
    G = gqa_group_size if gqa_group_size and gqa_group_size > 0 else 0
    n_layers = len(qkv_weights)
    dq = _dequant or (lambda w, kind, li: w)
    if norm_type == "rmsnorm":
        def norm(h, sc, bi):
            return _rms(h, epsilon, sc)
    else:
        def norm(h, sc, bi):
            return _ln(h, epsilon, sc, bi)

    def item(lst, li):
        return lst[li] if lst else None

    pres = list(pre_caches) if pre_caches is not None else []
    mask = None if attn_mask is None else \
        attn_mask[:, :, None].to(torch.float32)    # [B, H, 1, S, S_kv]

    slens = None
    if paged is not None:
        slens = paged["lens"]
    elif isinstance(seq_lens, torch.Tensor):
        slens = seq_lens.to(device=x.device, dtype=torch.long).reshape(-1)
    elif seq_lens is not None:
        slens = torch.as_tensor(np.asarray(seq_lens), dtype=torch.long) \
            .to(x.device).reshape(-1)
    h = x
    for li in range(n_layers):
        resid = h
        z = norm(h, ln_scales[li], item(ln_biases, li)) \
            if pre_layer_norm else h
        if _mm is not None and trans_qkvw:
            qkv = _mm(z.reshape(b * s, e), qkv_weights[li], "qkv",
                      li).reshape((b, s) + tuple(_mm.qkv_out))
            if item(qkv_biases, li) is not None:
                qkv = qkv + qkv_biases[li][None, None]
            if G:
                ht, hd = _mm.qkv_out
                nh = ht - 2 * G
                q, k, v = qkv[:, :, :nh], qkv[:, :, nh:nh + G], \
                    qkv[:, :, nh + G:]
            else:
                nh, hd = _mm.qkv_out[1], _mm.qkv_out[2]
                q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        elif G:
            w = dq(qkv_weights[li], "qkv", li)
            if not trans_qkvw:
                w = w.permute(1, 2, 0)                # [E,H+2G,D] packed
            ht, hd = w.shape[0], w.shape[1]
            nh = ht - 2 * G
            qkv = torch.matmul(z.to(w.dtype), w.reshape(ht * hd, e).t()) \
                .reshape(b, s, ht, hd)
            if item(qkv_biases, li) is not None:
                qkv = qkv + qkv_biases[li][None, None]
            q, k, v = qkv[:, :, :nh], qkv[:, :, nh:nh + G], qkv[:, :, nh + G:]
        else:
            w = dq(qkv_weights[li], "qkv", li)
            if not trans_qkvw:
                w = w.permute(1, 2, 3, 0)             # [E,3,H,D] -> [3,H,D,E]
            nh, hd = w.shape[1], w.shape[2]
            qkv = torch.matmul(z.to(w.dtype), w.reshape(3 * nh * hd, e).t()) \
                .reshape(b, s, 3, nh, hd)
            if item(qkv_biases, li) is not None:
                qkv = qkv + qkv_biases[li][None, None]
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if rotary_embs is not None:
            cos = rotary_embs[0][:, 0][:, :, None, :]  # [B, S_rope, 1, D]
            sin = rotary_embs[1][:, 0][:, :, None, :]
            if time_step is not None and slens is not None:
                # ragged decode: each sequence rotates at its own length
                bidx = torch.arange(cos.shape[0], device=x.device) \
                    if cos.shape[0] > 1 else torch.zeros_like(slens)
                if s == 1:
                    cos = cos[bidx, slens][:, None]
                    sin = sin[bidx, slens][:, None]
                else:
                    posr = torch.clamp(
                        slens[:, None] + torch.arange(s, device=x.device),
                        max=cos.shape[1] - 1)
                    cos = cos[bidx[:, None], posr]
                    sin = sin[bidx[:, None], posr]
            elif time_step is not None:
                t0 = int(time_step)
                cos, sin = cos[:, t0:t0 + 1], sin[:, t0:t0 + 1]
            else:
                cos, sin = cos[:, :s], sin[:, :s]
            q, k = _apply_rope_pair(q, k, cos, sin, use_neox_rotary_style)
        scale = 1.0 / math.sqrt(hd)
        g_eff = G or nh
        r = nh // g_eff
        if paged is not None:
            cache = caches[li]                        # [2, KVH, NB, BS, D]
            _pa.write_paged_kv(cache[0], k, paged["src"], paged["dst"])
            _pa.write_paged_kv(cache[1], v, paged["src"], paged["dst"])
            qa = q.contiguous() if chunk_lens is not None \
                else q[:, 0].contiguous()
            ctx = _pa.ragged_paged_attention(
                qa, cache[0], cache[1], paged["tables"], paged["attn_lens"],
                scale=scale, q_lens=paged["q_lens"])
            if chunk_lens is None:
                ctx = ctx[:, None]
            ctx = ctx.to(x.dtype)                     # [B, S, H, D]
        elif time_step is not None and caches:
            cache = caches[li]                        # [2, B, g, S_max, D]
            smax = cache.shape[3]
            if slens is not None:
                bidx = torch.arange(b, device=x.device)
                cache[0][bidx, :, slens] = k[:, 0].to(cache.dtype)
                cache[1][bidx, :, slens] = v[:, 0].to(cache.dtype)
                posm = (torch.arange(smax, device=x.device)
                        [None, None, None, None, :]
                        <= slens[:, None, None, None, None])
            else:
                t0 = int(time_step)
                cache[0][:, :, t0:t0 + s] = k.transpose(1, 2).to(cache.dtype)
                cache[1][:, :, t0:t0 + s] = v.transpose(1, 2).to(cache.dtype)
                posm = torch.arange(smax, device=x.device)[
                    None, None, None, None, :] <= t0
            qg = q.reshape(b, s, g_eff, r, hd)
            logits = torch.einsum("bsgrd,bgtd->bgrst", qg.float(),
                                  cache[0].float()) * scale
            if mask is not None:
                logits = logits + mask
            logits = torch.where(posm, logits, NEG_INF_F)
            p = torch.softmax(logits, dim=-1)
            ctx = torch.einsum("bgrst,bgtd->bsgrd", p, cache[1].float()) \
                .reshape(b, s, nh, hd).to(x.dtype)
        else:
            # context/prefill: causal attention, fill cache [0:S_pre+S];
            # pre_caches (prompt-prefix KV) put their keys first, and every
            # new row sees the whole prefix plus the causal new part
            kk, vv = k, v
            s_pre = 0
            if pres:
                pk, pv = pres[li][0], pres[li][1]     # [B, g, S_pre, D]
                s_pre = pk.shape[2]
                dt = torch.promote_types(pk.dtype, k.dtype)
                kk = torch.cat([pk.transpose(1, 2).to(dt), k.to(dt)], 1)
                vv = torch.cat([pv.transpose(1, 2).to(dt), v.to(dt)], 1)
            qg = q.reshape(b, s, g_eff, r, hd)
            logits = torch.einsum("bsgrd,btgd->bgrst", qg.float(),
                                  kk.float()) * scale
            causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                           device=x.device))
            if s_pre:
                causal = torch.cat([torch.ones((s, s_pre), dtype=torch.bool,
                                               device=x.device), causal], 1)
            causal = causal[None, None, None]
            if slens is not None:
                # padded batch: keys at/after each row's length are out
                # (the prefix is always in)
                valid = (torch.arange(s, device=x.device)[None, :]
                         < slens[:, None])
                if s_pre:
                    valid = torch.cat([torch.ones((b, s_pre),
                                                  dtype=torch.bool,
                                                  device=x.device), valid],
                                      1)
                causal = causal & valid[:, None, None, None, :]
            if mask is not None:
                logits = logits + mask
            logits = torch.where(causal, logits, NEG_INF_F)
            p = torch.softmax(logits, dim=-1)
            ctx = torch.einsum("bgrst,btgd->bsgrd", p, vv.float()) \
                .reshape(b, s, nh, hd).to(x.dtype)
            if caches:
                cache = caches[li]
                cache[0][:, :, :s_pre + s] = kk.transpose(1, 2).to(
                    cache.dtype)
                cache[1][:, :, :s_pre + s] = vv.transpose(1, 2).to(
                    cache.dtype)
        if _mm is not None:
            attn = _mm(ctx.reshape(b * s, nh * hd), linear_weights[li],
                       "lin", li).reshape(b, s, -1)
        else:
            attn = _matmul(ctx.reshape(b, s, nh * hd),
                           dq(linear_weights[li], "lin", li))
        if item(linear_biases, li) is not None:
            attn = attn + linear_biases[li]
        if training and dropout_rate:
            # one draw a layer from the port's seed chain; eval leaves
            # attn as it is, in every mode (the JAX package's rule)
            keep = _keep(attn.shape, dropout_rate, _chain_generator(x.device),
                         attn.device)
            attn = torch.where(keep, attn / (1.0 - dropout_rate)
                               if mode == "upscale_in_train" else attn,
                               torch.zeros_like(attn))
        h = resid * residual_alpha + attn
        if not pre_layer_norm:
            h = norm(h, ln_scales[li], item(ln_biases, li))
        resid2 = h
        z2 = norm(h, ffn_ln_scales[li], item(ffn_ln_biases, li)) \
            if pre_layer_norm else h
        if _mm is not None:
            f1 = _mm(z2.reshape(b * s, -1), ffn1_weights[li], "f1",
                     li).reshape(b, s, -1)
        else:
            f1 = _matmul(z2, dq(ffn1_weights[li], "f1", li))
        if item(ffn1_biases, li) is not None:
            f1 = f1 + ffn1_biases[li]
        if activation.endswith("glu"):
            a, gate = f1.chunk(2, dim=-1)
            act = F.silu if activation == "swiglu" else \
                (lambda t: F.gelu(t, approximate="tanh"))
            f1 = act(a) * gate
        elif activation == "relu":
            f1 = F.relu(f1)
        else:
            f1 = F.gelu(f1, approximate="tanh")
        if _mm is not None:
            f2 = _mm(f1.reshape(b * s, -1), ffn2_weights[li], "f2",
                     li).reshape(b, s, -1)
        else:
            f2 = _matmul(f1, dq(ffn2_weights[li], "f2", li))
        if item(ffn2_biases, li) is not None:
            f2 = f2 + ffn2_biases[li]
        h = resid2 * residual_alpha + f2
        if not pre_layer_norm:
            h = norm(h, ffn_ln_scales[li], item(ffn_ln_biases, li))
    return h


def _scales(sc, like):
    """A scale list entry (tensor or array) as float32 on like's device."""
    if not isinstance(sc, torch.Tensor):
        sc = torch.as_tensor(np.asarray(sc))
    return sc.to(device=like.device, dtype=torch.float32)


def fused_multi_transformer_int8(
        x, ln_scales, ln_biases, qkv_weights, qkv_scales, qkv_biases,
        linear_weights, linear_scales, linear_biases, ffn_ln_scales,
        ffn_ln_biases, ffn1_weights, ffn1_scales, ffn1_biases, ffn2_weights,
        ffn2_scales, ffn2_biases, **kwargs):
    """Weight-only-int8 ``fused_multi_transformer`` (the JAX package's
    :844): int8 weights shaped as the float ones, each with the per-output-
    channel scale of its weight; every use dequantizes to float32 (qkv
    scales per (head, dim) row, the others per output column) and runs the
    float stack. The weight-only GEMM kernel serves the engine's int8 path
    (``inference``), not this op."""
    scales = {"qkv": list(qkv_scales), "lin": list(linear_scales),
              "f1": list(ffn1_scales), "f2": list(ffn2_scales)}

    def dq(w, kind, li):
        sc = _scales(scales[kind][li], w)
        if kind == "qkv":
            return w.float() * sc.reshape(*w.shape[:-1], 1)
        return w.float() * sc.reshape(-1)[None, :]

    return fused_multi_transformer(
        x, ln_scales, ln_biases, qkv_weights, qkv_biases, linear_weights,
        linear_biases, ffn_ln_scales, ffn_ln_biases, ffn1_weights,
        ffn1_biases, ffn2_weights, ffn2_biases, _dequant=dq, **kwargs)


def fused_multi_transformer_int4(
        x, ln_scales, ln_biases, qkv_weights, qkv_scales, qkv_biases,
        linear_weights, linear_scales, linear_biases, ffn_ln_scales,
        ffn_ln_biases, ffn1_weights, ffn1_scales, ffn1_biases, ffn2_weights,
        ffn2_scales, ffn2_biases, **kwargs):
    """Weight-only-int4 ``fused_multi_transformer`` (the JAX package's
    :931): weights are int8 bytes holding two nibbles along the INPUT axis
    (``quantize_int4``: qkv [3, H, D, E/2], linear [H*D/2, E], ffn1
    [E/2, F], ffn2 [F/2, E]) with the scales ``quantize_int4`` returns,
    which broadcast against the unpacked weight; every use unpacks and
    dequantizes to float32."""
    scales = {"qkv": list(qkv_scales), "lin": list(linear_scales),
              "f1": list(ffn1_scales), "f2": list(ffn2_scales)}

    def dq(w, kind, li):
        full = _unpack_int4(w, axis=-1 if kind == "qkv" else 0)
        return full.float() * _scales(scales[kind][li], w)

    return fused_multi_transformer(
        x, ln_scales, ln_biases, qkv_weights, qkv_biases, linear_weights,
        linear_biases, ffn_ln_scales, ffn_ln_biases, ffn1_weights,
        ffn1_biases, ffn2_weights, ffn2_biases, _dequant=dq, **kwargs)


def masked_multihead_attention(x, cache_kv, seq_lens, src_mask=None,
                               **kwargs):
    """Decode-step MHA over a contiguous KV cache (the JAX package's :274).
    x: [B, 3*H*D] fused qkv of the new token; cache_kv: [2, B, H, S_max, D],
    written IN PLACE at position seq_lens[b] (a position at or past S_max
    is dropped, as the JAX scatter drops it); src_mask (optional): additive
    logits bias broadcastable to [B, H, S_max]. Scores and softmax in
    float32 over the positions <= seq_lens[b]. Returns (out [B, H*D] in x's
    dtype, cache_kv)."""
    _, b, h, smax, d = cache_kv.shape
    qkv = x.reshape(b, 3, h, d)
    q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    lens = _pa._on_device(seq_lens, x.device, torch.long).reshape(-1)
    kc, vc = cache_kv[0], cache_kv[1]
    rows = torch.nonzero(lens < smax).reshape(-1)
    kc[rows, :, lens[rows]] = k_new[rows].to(kc.dtype)
    vc[rows, :, lens[rows]] = v_new[rows].to(vc.dtype)
    s = torch.einsum("bhd,bhsd->bhs", q.float(), kc.float()) \
        * (1.0 / math.sqrt(d))
    if src_mask is not None:
        s = s + src_mask.reshape(b, -1, smax).float()
    pos = torch.arange(smax, device=x.device)[None, None, :]
    s = torch.where(pos <= lens[:, None, None], s, NEG_INF_F)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bhsd->bhd", p, vc.float()).to(x.dtype)
    return out.reshape(b, h * d), cache_kv


def block_multihead_attention(qkv, k_cache, v_cache, block_tables,
                              context_lens, scale=None):
    """Paged-cache decode attention (the JAX package's :308). qkv:
    [B, 3, H, D] for the new token; caches [KVH, num_blocks, block_size,
    D] (KVH == H, or a divisor of H under GQA: the k and v of the new
    token are the first KVH heads of their qkv slots). Appends the token
    at position context_lens[b] IN PLACE (a row already at the table's
    capacity has its write dropped and still attends), then attends over
    context_lens + 1 positions through ``paged_attention``: the legacy
    decode kernel on the card, its plain version on the CPU. Returns
    (out [B, H, D], k_cache, v_cache)."""
    kvh = k_cache.shape[0]
    q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    if q.shape[1] != kvh:
        k_new, v_new = k_new[:, :kvh], v_new[:, :kvh]
    _pa.update_paged_kv_cache(k_cache, v_cache, k_new, v_new, block_tables,
                              context_lens)
    lens = _pa._on_device(context_lens, q.device, torch.int32).reshape(-1)
    out = _pa.paged_attention(q.contiguous(), k_cache, v_cache, block_tables,
                              lens + 1, scale=scale)
    return out, k_cache, v_cache


def block_kv_cache_rewind(k_cache, v_cache, block_tables, new_lens,
                          old_lens, max_span):
    """Speculative-decode rewind over the paged KV cache (the JAX
    package's :334): zero positions new_lens[b] .. old_lens[b]-1 IN PLACE
    (``ops.paged_attention.truncate_paged_kv_cache``); ``max_span`` bounds
    the widest rewind. Returns (k_cache, v_cache)."""
    return _pa.truncate_paged_kv_cache(k_cache, v_cache, block_tables,
                                       new_lens, old_lens, int(max_span))


def blha_get_max_len(seq_lens_encoder, seq_lens_decoder, batch_size):
    """Max encoder and decoder lengths for block_multihead_attention (the
    JAX package's :1221): two int32 tensors of shape [1]."""
    def peak(lens):
        t = lens if isinstance(lens, torch.Tensor) \
            else torch.as_tensor(np.asarray(lens))
        return t.max().to(torch.int32).reshape(1)

    return peak(seq_lens_encoder), peak(seq_lens_decoder)


def flashmask_attention(query, key, value, startend_row_indices,
                        causal=True):
    """FlashMask attention (paddle's flashmask_attention; the JAX
    package's :355-395), [B, S, H, D]. Key column j masks the query rows
    [start_j, end_j) on top of the causal mask: ``startend_row_indices``
    [B, MH, Sk, 1] gives start with end = S, [B, MH, Sk, 2] both; MH is
    1, the kv head count or H. Goes to
    ``ops.flashmask.flashmask_attention_bshd`` on every device: the CUDA
    kernels for CUDA tensors, the plain versions for CPU tensors. The JAX
    function's dense fallback (:368-392) computes the same function."""
    return _fm.flashmask_attention_bshd(query, key, value,
                                        startend_row_indices, causal=causal)


# -- the training step's fused tier (JAX :176-270, :970-1115) -------------

def _gelu(x):
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def _keep(shape, p, generator, device):
    """Bernoulli(1 - p) keep mask drawn from ``generator``."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - p


def _chain_generator(device):
    """A generator seeded from the port's seed chain (``core.random``): the
    counterpart of the fresh key a JAX op takes as an input."""
    return make_generator(_random.fresh_seed(device), device)


def _drop(t, p, training):
    """Upscale-in-train dropout of ``t`` with one draw from the seed
    chain; t itself when not training or p <= 0."""
    if not training or p <= 0.0:
        return t
    keep = _keep(t.shape, p, _chain_generator(t.device), t.device)
    return torch.where(keep, t / (1.0 - p), torch.zeros_like(t))


def _einsum(eq, a, b):
    """einsum in the promoted dtype of the two (jnp's rule)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.0,
                               attn_dropout_rate=0.0, ln_epsilon=1e-5,
                               training=True, num_heads=None):
    """[pre-LN] -> QKV projection -> MHA -> out projection -> residual
    [-> post-LN] (the JAX package's :47-122). x [B, S, E]; qkv_weight
    [3, H, D, E]; linear_weight [H*D, E]; cache_kv [2, B, S_cache, H, D]:
    its keys and values come before the new ones and the extended cache
    is returned as (out, new_cache); attn_mask additive, broadcastable to
    [B, H, S, S_kv]. In training the attention probabilities
    (``attn_dropout_rate``) and then the projection output
    (``dropout_rate``) drop, upscaled, each with one draw from the seed
    chain."""
    h = _ln(x, pre_ln_epsilon, pre_ln_scale, pre_ln_bias) \
        if pre_layer_norm else x
    b, s, _ = h.shape
    nh, hd = qkv_weight.shape[1], qkv_weight.shape[2]
    qkv = _einsum("bsd,tnhd->tbsnh", h, qkv_weight).to(h.dtype)
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.reshape(3, 1, 1, nh, hd)
    q, k, v = qkv[0], qkv[1], qkv[2]                    # [B, S, H, D]
    new_cache = None
    if cache_kv is not None:
        dt = torch.promote_types(cache_kv.dtype, k.dtype)
        k = torch.cat([cache_kv[0].to(dt), k.to(dt)], 1)
        v = torch.cat([cache_kv[1].to(dt), v.to(dt)], 1)
        new_cache = torch.stack([k, v])
    logits = torch.einsum("bsnh,btnh->bnst", q.float(), k.float()) \
        * (1.0 / math.sqrt(hd))
    if attn_mask is not None:
        logits = logits + attn_mask.to(torch.float32)
    p = _drop(torch.softmax(logits, dim=-1), attn_dropout_rate, training)
    ctx = torch.einsum("bnst,btnh->bsnh", p, v.float()).to(h.dtype)
    out = _einsum("bse,ed->bsd", ctx.reshape(b, s, nh * hd), linear_weight)
    if linear_bias is not None:
        out = out + linear_bias
    out = x + _drop(out, dropout_rate, training)
    if not pre_layer_norm:
        out = _ln(out, ln_epsilon, ln_scale, ln_bias)
    return out if new_cache is None else (out, new_cache)


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True):
    """[pre-LN] -> FC1 -> act -> dropout1 -> FC2 -> dropout2 -> residual
    [-> post-LN] (the JAX package's :124-175); relu, exact gelu or silu;
    each dropout upscaled, one draw from the seed chain when training."""
    h = _ln(x, ln1_epsilon, ln1_scale, ln1_bias) if pre_layer_norm else x
    h = _einsum("...d,de->...e", h, linear1_weight)
    if linear1_bias is not None:
        h = h + linear1_bias
    act = {"relu": torch.relu, "gelu": F.gelu, "silu": F.silu}[activation]
    h = _drop(act(h), dropout1_rate, training)
    h = _einsum("...e,ed->...d", h, linear2_weight)
    if linear2_bias is not None:
        h = h + linear2_bias
    out = x + _drop(h, dropout2_rate, training)
    if not pre_layer_norm:
        out = _ln(out, ln2_epsilon, ln2_scale, ln2_bias)
    return out


def variable_length_memory_efficient_attention(query, key, value, seq_lens,
                                               kv_seq_lens, mask=None,
                                               scale=None, causal=False,
                                               pre_cache_length=0):
    """Var-len attention over padded [B, H, S, D] tensors (the JAX
    package's :1184-1218): keys at or past kv_seq_lens[b] and, when
    causal, keys past row + ``pre_cache_length`` take float32's lowest
    logit, then the additive ``mask``; rows at or past seq_lens[b] are
    zero."""
    bsz, _, s, d = query.shape
    skv = key.shape[2]
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhsd,bhtd->bhst", query, key).to(
        torch.float32) * sc
    dev = query.device
    sl = torch.as_tensor(seq_lens, device=dev).reshape(bsz, 1)
    kvl = torch.as_tensor(kv_seq_lens, device=dev).reshape(bsz, 1)
    q_valid = torch.arange(s, device=dev)[None, :] < sl
    kv_valid = torch.arange(skv, device=dev)[None, :] < kvl
    neg = torch.finfo(torch.float32).min
    logits = torch.where(kv_valid[:, None, None, :], logits, neg)
    if causal:
        cm = (torch.arange(skv, device=dev)[None, :] - pre_cache_length
              <= torch.arange(s, device=dev)[:, None])
        logits = torch.where(cm[None, None], logits, neg)
    if mask is not None:
        logits = logits + mask.to(torch.float32)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", p.to(value.dtype), value)
    return torch.where(q_valid[:, None, :, None], out, torch.zeros_like(out))


def _add(a, b):
    """a + b with JAX's dtype promotion (torch keeps a 16-bit tensor's
    dtype against a 0-dim f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) + b.to(dt)


def fused_bias_act(x, bias=None, act_method="gelu"):
    """act(x + bias): relu, gelu (tanh form), silu, or the gated geglu /
    swiglu over the two halves of the last axis (swiglu through the
    SwiGLU kernel)."""
    h = x if bias is None else _add(x, bias)
    if act_method == "swiglu":
        return _swiglu(h)
    if act_method == "geglu":
        a, b = torch.chunk(h, 2, dim=-1)
        return _gelu(a) * b
    act = {"relu": torch.relu, "gelu": _gelu, "silu": F.silu}[act_method]
    return act(h)


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      generator=None):
    """dropout(x) + y; ``downscale_in_infer`` drops without rescaling in
    training and scales by 1 - p in inference."""
    if mode == "downscale_in_infer":
        if not training:
            return x * (1.0 - p) + y
        if p == 0.0:
            return x + y
        keep = _keep(x.shape, p, generator, x.device)
        return torch.where(keep, x, torch.zeros_like(x)) + y
    if not training or p == 0.0:
        return x + y
    keep = _keep(x.shape, p, generator, x.device)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x)) + y


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.0, ln_epsilon=1e-5,
                                           training=True, generator=None):
    """LayerNorm(dropout(x + bias) + residual)."""
    h = x if bias is None else x + bias
    if training and dropout_rate > 0.0:
        keep = _keep(h.shape, dropout_rate, generator, h.device)
        h = torch.where(keep, h / (1.0 - dropout_rate), torch.zeros_like(h))
    return _ln(h + residual, ln_epsilon, ln_scale, ln_bias)


def fused_linear_param_grad_add(x, dout, dweight=None, dbias=None,
                                multi_precision=True, has_bias=True):
    """dW (+ dweight) = x^T dout summed over the leading axes in f32, and
    with ``has_bias`` dB (+ dbias) = the sum of dout; f32 outputs under
    ``multi_precision``, else dout's dtype."""
    out_t = torch.float32 if multi_precision else dout.dtype
    dw = torch.einsum("...i,...o->io", x.to(torch.float32),
                      dout.to(torch.float32))
    if dweight is not None:
        dw = dweight.to(torch.float32) + dw
    outs = [dw.to(out_t)]
    if has_bias:
        db = dout.to(torch.float32).sum(dim=tuple(range(dout.dim() - 1)))
        if dbias is not None:
            db = dbias.to(torch.float32) + db
        outs.append(db.to(out_t))
    return tuple(outs) if len(outs) > 1 else outs[0]


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """x @ y (+ bias), either operand transposed on its last two axes."""
    a = x.transpose(-1, -2) if transpose_x else x
    b = y.transpose(-1, -2) if transpose_y else y
    dt = torch.promote_types(a.dtype, b.dtype)
    out = torch.matmul(a.to(dt), b.to(dt))
    return out if bias is None else _add(out, bias)


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """x @ weight (+ bias), weight [in, out] (or transposed)."""
    return fused_matmul_bias(x, weight, bias, False, transpose_weight, name)


def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False,
                            activation=None):
    """act(x @ y + bias) with act None, "none", "gelu" (tanh form) or
    "relu"."""
    if activation not in (None, "none", "gelu", "relu"):
        raise ValueError(f"unsupported epilogue activation {activation}")
    out = fused_matmul_bias(x, y, bias, trans_x, trans_y)
    if activation == "gelu":
        return _gelu(out)
    if activation == "relu":
        return torch.relu(out)
    return out


def swiglu(x, y=None, name=None):
    """silu(x) * y, or with y None silu(gate) * up over the halves of x's
    last axis: the SwiGLU kernel (``ops.swiglu``) on the card."""
    return _swiglu(x, y)


def _maybe_quant(out, quant_scale, quant_round_type, quant_max_bound,
                 quant_min_bound):
    if quant_scale <= 0:
        return out
    q = out.to(torch.float32) * quant_max_bound * quant_scale
    if quant_round_type == 0:
        q = torch.round(q)                      # half to even
    else:
        q = torch.where(q >= 0, torch.floor(q + 0.5), torch.ceil(q - 0.5))
    return torch.clamp(q, quant_min_bound, quant_max_bound).to(torch.int8)


def _trailing(t, shape, begin):
    """t as the [prod(shape[begin:])] vector it scales, or None when it
    does not span exactly the normalized axes."""
    n = math.prod(shape[begin:])
    return t.reshape(n) if t is not None and t.numel() == n else None


def fused_rms_norm(x, norm_weight, norm_bias, epsilon, begin_norm_axis,
                   bias=None, residual=None, quant_scale=-1,
                   quant_round_type=0, quant_max_bound=0, quant_min_bound=0):
    """RMSNorm over the axes from ``begin_norm_axis`` of x (+ bias)
    (+ residual), through kernel A (``ops.fused_norm``). Returns (out,
    residual_out), residual_out the pre-norm sum. The JAX dtype rule:
    ``round(h * inv) * norm_weight`` promotes, so an f32 scale over a bf16
    activation gives f32 (``nn.RMSNorm`` casts the scale down instead);
    then + norm_bias and the optional int8 quantization, in plain
    PyTorch."""
    shape = x.shape
    begin = begin_norm_axis % x.dim()
    hid = math.prod(shape[begin:])
    flat_bias = _trailing(bias, shape, begin)
    if bias is not None and flat_bias is None:
        x = _add(x, bias)                       # a bias of another shape
    if residual is not None:
        x, residual = torch.broadcast_tensors(x, residual)
        shape = x.shape
    x2 = x.reshape(-1, hid)
    res2 = None if residual is None else residual.reshape(-1, hid)
    w = None if norm_weight is None else norm_weight.reshape(hid)
    got = _fn.rms_norm(x2, w, epsilon, bias=flat_bias, residual=res2,
                       cast_weight=False)
    if flat_bias is None and res2 is None:
        out, h = got, x
    else:
        out, h = got
    out = out.reshape(shape)
    if norm_bias is not None:
        out = _add(out, norm_bias)
    out = _maybe_quant(out, quant_scale, quant_round_type, quant_max_bound,
                       quant_min_bound)
    return out, h.reshape(shape)


def fused_layer_norm(x, norm_weight, norm_bias, epsilon, residual_alpha=1.0,
                     begin_norm_axis=1, bias=None, residual=None,
                     quant_scale=-1, quant_round_type=0, quant_max_bound=0,
                     quant_min_bound=0):
    """LayerNorm over the axes from ``begin_norm_axis`` of x (+ bias)
    (+ residual_alpha * residual), in f32, cast back to the sum's dtype,
    then * norm_weight + norm_bias (promoting); with neither the result is
    the sum. Returns (out, residual_out); optional int8 quantization."""
    h = x
    if bias is not None:
        h = _add(h, bias)
    if residual is not None:
        h = _add(h, residual_alpha * residual)
    if norm_weight is None and norm_bias is None:
        return h, h
    red = tuple(range(begin_norm_axis % h.dim(), h.dim()))
    hf = h.to(torch.float32)
    mu = hf.mean(dim=red, keepdim=True)
    var = ((hf - mu) ** 2).mean(dim=red, keepdim=True)
    out = ((hf - mu) * torch.rsqrt(var + epsilon)).to(h.dtype)
    if norm_weight is not None:
        out = out * norm_weight
    if norm_bias is not None:
        out = _add(out, norm_bias)
    out = _maybe_quant(out, quant_scale, quant_round_type, quant_max_bound,
                       quant_min_bound)
    return out, h
