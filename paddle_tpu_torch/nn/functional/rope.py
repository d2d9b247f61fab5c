"""Rotary position embedding for the PyTorch port (counterpart of
``paddle_tpu/nn/functional/rope.py``).

Layout as in the JAX package: [batch, seq, heads, head_dim]. The cos/sin
tables are computed in float32 and cast to the activation's dtype before
the rotation, so a bf16 activation rotates in bf16.
``fused_rotary_position_embedding`` is a named entry of the amp hook
(``amp._hook.amp_op``).
"""
import torch

from ...amp._hook import amp_op

__all__ = [
    "rotary_embedding_cos_sin", "apply_rotary_pos_emb",
    "fused_rotary_position_embedding",
]


def rotary_embedding_cos_sin(seq_len, head_dim, base=10000.0,
                             position_ids=None, device=None):
    """float32 cos/sin tables [seq, head_dim//2] (or [B, S, head_dim//2]
    from ``position_ids``)."""
    if position_ids is not None:
        device = position_ids.device
    inv_freq = 1.0 / (base ** (torch.arange(0, head_dim, 2,
                                            dtype=torch.float32,
                                            device=device) / head_dim))
    if position_ids is None:
        t = torch.arange(seq_len, dtype=torch.float32, device=device)
        freqs = torch.outer(t, inv_freq)                    # [S, D/2]
    else:
        freqs = position_ids[..., None].to(torch.float32) * inv_freq
    return torch.cos(freqs), torch.sin(freqs)


def _rotate(x, cos, sin, use_neox):
    """x: [B, S, H, D]; cos/sin: [S, D/2] or [B, S, D/2]."""
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    if use_neox:
        # neox style: rotate the [x_{0:D/2}, x_{D/2:D}] halves
        x1, x2 = torch.chunk(x, 2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    # GPT-J / interleaved style: rotate even/odd pairs
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape)


def apply_rotary_pos_emb(x, cos, sin, use_neox_rotary_style=True):
    return _rotate(x, cos.to(x.dtype), sin.to(x.dtype), use_neox_rotary_style)


@amp_op("fused_rotary_position_embedding")
def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    rotary_emb_base=10000.0):
    """q/k/v [B, S, H, D] -> rotated (q, k, v); v passes through. Tables
    passed in are paddle's [1, S_max, 1, D] form and are reduced to
    [S, D/2] by the pair layout (neox: first half, GPT-J: even columns),
    then gathered by ``position_ids`` when given."""
    head_dim = int(q.shape[-1])
    seq_len = int(q.shape[1])
    if cos is None or sin is None:
        cos, sin = rotary_embedding_cos_sin(
            seq_len, head_dim, base=rotary_emb_base,
            position_ids=position_ids, device=q.device)
    else:
        cos = torch.as_tensor(cos, device=q.device)
        sin = torch.as_tensor(sin, device=q.device)
        cos = cos.reshape(cos.shape[-3], cos.shape[-1])
        sin = sin.reshape(sin.shape[-3], sin.shape[-1])
        if use_neox_rotary_style:
            cos, sin = cos[:, : head_dim // 2], sin[:, : head_dim // 2]
        else:
            cos, sin = cos[:, 0::2], sin[:, 0::2]
        if position_ids is not None:
            cos = cos[position_ids.long()]                # [B, S, D/2]
            sin = sin[position_ids.long()]
        elif cos.shape[0] != seq_len:
            cos, sin = cos[:seq_len], sin[:seq_len]
    outs = [apply_rotary_pos_emb(q, cos, sin, use_neox_rotary_style)]
    outs.append(apply_rotary_pos_emb(k, cos, sin, use_neox_rotary_style)
                if k is not None else None)
    outs.append(v)
    return tuple(outs)
