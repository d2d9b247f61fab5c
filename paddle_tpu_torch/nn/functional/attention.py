"""Attention functionals for the PyTorch port (counterpart of
``paddle_tpu/nn/functional/attention.py``).

``flash_attention`` goes to ``ops.flash_attention.flash_attention_bshd``
on every device: its wrappers launch the CUDA kernels for CUDA tensors
and run the plain versions for CPU tensors. A kernel that fails to build
or launch raises; there is no quiet fallback to another path.
``scaled_dot_product_attention`` with a mask runs ``_sdpa_ref`` in plain
PyTorch, as the JAX package runs it in plain XLA, and so does
``flashmask_attention`` with an index: the JAX package's form of it here
materializes the mask and never reaches the FlashMask kernels (those are
``incubate.nn.functional.flashmask_attention``'s).

Dropout (with ``training``) and ``return_softmax`` take ``_sdpa_ref`` too,
as the JAX package's routes do: the keep mask comes from a generator
seeded with a seed drawn from the default chain in the forward
(``core.random.fresh_seed``), the port's counterpart of the key the JAX
package passes in as an input. Autograd keeps the mask for the backward,
and activation recompute replays the chain, so a recomputed forward draws
the same mask. A dropout-free call keeps the flash kernels.

``flash_attention`` (its q, k and v; the rope tables stay f32) and
``scaled_dot_product_attention`` are named entries of the amp hook
(``amp._hook.amp_op``).
"""
import math

import torch

from ...amp._hook import amp_op
from ...core import random as _random
from ...ops import flash_attention as _fa
from .rope import apply_rotary_pos_emb


def _dropout_keep(shape, keep_prob, seed, device):
    """The Bernoulli(``keep_prob``) keep mask of ``shape`` that ``seed``
    gives on ``device`` (a generator of its own, seeded afresh)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return u < keep_prob


def _sdpa_ref(q, k, v, mask=None, causal=False, dropout=0.0, seed=None):
    """Reference attention in plain PyTorch, [B, S, H, D] layout. Scores
    and the prob @ v product in float32, the output cast to q's dtype.
    The causal mask is bottom-right aligned (``tril(k=t-s)``), as the JAX
    package's; it agrees with the kernel's top-left mask when q and k
    have the same length. ``dropout`` > 0 with a ``seed`` drops each
    probability with that chance and scales the kept ones by
    1 / (1 - dropout), the mask drawn from ``seed`` alone."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if k.shape[2] != q.shape[2]:            # GQA: repeat the kv head groups
        rep = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    logits = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * scale
    lowest = torch.finfo(torch.float32).min
    if causal:
        s, t = logits.shape[-2], logits.shape[-1]
        cm = torch.ones((s, t), dtype=torch.bool,
                        device=logits.device).tril(diagonal=t - s)
        logits = logits.masked_fill(~cm, lowest)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, lowest)
        else:
            logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1)
    if dropout > 0.0 and seed is not None:
        keep = _dropout_keep(probs.shape, 1.0 - dropout, seed, probs.device)
        probs = torch.where(keep, probs / (1.0 - dropout),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    out = torch.matmul(probs, vt.float()).to(q.dtype)
    return out.transpose(1, 2)


@amp_op("flash_attention", only=("query", "key", "value"))
def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    training=True, rope_cos=None, rope_sin=None):
    """paddle's flash_attention: inputs [batch, seqlen, num_heads,
    head_dim]; returns (out, None). rope_cos / rope_sin [S, D/2] (neox):
    applied to q and k inside the kernels, the rotated tensors never in
    memory. With ``dropout`` > 0 and ``training``, or ``return_softmax``,
    the call runs ``_sdpa_ref`` (q and k rotated first when the tables are
    given) and still returns (out, None), as the JAX package does."""
    drop = dropout > 0.0 and training
    if not drop and not return_softmax:
        return _fa.flash_attention_bshd(query, key, value, causal=causal,
                                        rope_cos=rope_cos,
                                        rope_sin=rope_sin), None
    if rope_cos is not None:
        query = apply_rotary_pos_emb(query, rope_cos, rope_sin, True)
        key = apply_rotary_pos_emb(key, rope_cos, rope_sin, True)
    seed = _random.fresh_seed(query.device) if drop else None
    return _sdpa_ref(query, key, value, causal=causal,
                     dropout=dropout if drop else 0.0, seed=seed), None


@amp_op("scaled_dot_product_attention")
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """paddle's scaled_dot_product_attention ([B, S, H, D] layout, bool or
    additive mask)."""
    if attn_mask is None:
        out, _ = flash_attention(query, key, value, dropout=dropout_p,
                                 causal=is_causal, training=training)
        return out
    if dropout_p > 0.0 and training:
        return _sdpa_ref(query, key, value, mask=attn_mask,
                         causal=is_causal, dropout=dropout_p,
                         seed=_random.fresh_seed(query.device))
    return _sdpa_ref(query, key, value, mask=attn_mask, causal=is_causal)


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=True):
    """paddle's flashmask_attention as the JAX package's ``nn.functional``
    has it (attention.py:142-167), [B, S, H, D]. With no index it is
    ``flash_attention``. Otherwise column c keeps the query rows r <
    start[c], the first index column ([B, 1 or H, S, 1 or 2]; a second
    column is not read), ``tril`` is added when causal, and ``_sdpa_ref``
    runs over the materialized mask, so a row that keeps no column gets
    the plain softmax over its masked logits. A 2-column index therefore
    means something else here than in
    ``incubate.nn.functional.flashmask_attention``, which masks [start,
    end): the JAX package has both, and so does the port (ROADMAP Queue
    3). ``dropout`` > 0 drops probabilities as ``_sdpa_ref`` does (the JAX
    package's form has no ``training`` switch)."""
    if startend_row_indices is None:
        out, _ = flash_attention(query, key, value, dropout=dropout,
                                 causal=causal)
        return out
    s = query.shape[1]
    rows = torch.arange(s, device=query.device)[:, None]
    start = startend_row_indices[..., 0].to(query.device)
    keep = rows[None, None] < start[:, :, None, :]
    if causal:
        keep = keep & torch.ones((s, s), dtype=torch.bool,
                                 device=query.device).tril()
    seed = _random.fresh_seed(query.device) if dropout > 0.0 else None
    return _sdpa_ref(query, key, value, mask=keep, causal=False,
                     dropout=dropout, seed=seed)
