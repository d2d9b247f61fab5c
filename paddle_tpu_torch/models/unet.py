"""Conditional diffusion UNet for the PyTorch port (counterpart of
``paddle_tpu/models/unet.py``): ResBlocks with the timestep embedding,
self- and cross-attention transformer blocks over the flattened spatial
tokens, GroupNorm + SiLU, strided-conv downsampling and nearest
upsampling, skips concatenated along the channels.

The attention is ``nn.MultiHeadAttention``'s non-causal flash attention
(K1 / K2 on the card): at the defaults (64 base channels, 4 heads) head
dim 16 at the first level and 32 at the second, self-attention over the
H x W tokens and cross-attention against the context's (77 for a text
encoder). The model has no dtype switch: run it in bf16 under ``amp``
O2."""
import math

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE
from .. import nn
from ..nn import functional as F

__all__ = ["timestep_embedding", "ResBlock", "CrossAttnBlock", "Downsample",
           "Upsample", "UNet2DConditionModel"]


def timestep_embedding(timesteps, dim, max_period=10000):
    """Sinusoidal embeddings [B, dim] (DDPM convention): the JAX model's
    frequencies, computed in numpy f32."""
    half = dim // 2
    freqs = np.exp(-math.log(max_period)
                   * np.arange(half, dtype=np.float32) / half)
    args = timesteps.to(torch.float32)[:, None] * torch.from_numpy(
        freqs[None]).to(timesteps.device)
    return torch.cat([args.cos(), args.sin()], dim=-1)


class ResBlock(torch.nn.Module):
    def __init__(self, in_ch, out_ch, temb_ch, groups=8, generator=None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        init = dict(generator=generator, device=device)
        self.norm1 = nn.GroupNorm(groups, in_ch, **init)
        self.conv1 = nn.Conv2D(in_ch, out_ch, 3, padding=1, **init)
        self.temb_proj = nn.Linear(temb_ch, out_ch, **init)
        self.norm2 = nn.GroupNorm(groups, out_ch, **init)
        self.conv2 = nn.Conv2D(out_ch, out_ch, 3, padding=1, **init)
        self.skip = (nn.Conv2D(in_ch, out_ch, 1, **init) if in_ch != out_ch
                     else None)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return h + (self.skip(x) if self.skip is not None else x)


class CrossAttnBlock(torch.nn.Module):
    """Self-attention, cross-attention (keys and values from the context)
    and a gelu MLP over the flattened spatial tokens, between GroupNorm +
    ``proj_in`` and ``proj_out`` with the residual."""

    def __init__(self, channels, context_dim, num_heads=4, groups=8,
                 generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        init = dict(generator=generator, device=device)
        self.norm = nn.GroupNorm(groups, channels, **init)
        self.proj_in = nn.Linear(channels, channels, **init)
        self.ln1 = nn.LayerNorm(channels, **init)
        self.self_attn = nn.MultiHeadAttention(channels, num_heads, **init)
        self.ln2 = nn.LayerNorm(channels, **init)
        self.cross_attn = nn.MultiHeadAttention(channels, num_heads,
                                                kdim=context_dim,
                                                vdim=context_dim, **init)
        self.ln3 = nn.LayerNorm(channels, **init)
        self.ff1 = nn.Linear(channels, channels * 4, **init)
        self.ff2 = nn.Linear(channels * 4, channels, **init)
        self.proj_out = nn.Linear(channels, channels, **init)

    def forward(self, x, context):
        b, c, h, w = x.shape
        t = self.norm(x).reshape(b, c, h * w).transpose(1, 2)
        t = self.proj_in(t)
        t = t + self.self_attn(self.ln1(t))
        t = t + self.cross_attn(self.ln2(t), context, context)
        t = t + self.ff2(F.gelu(self.ff1(self.ln3(t))))
        t = self.proj_out(t)
        return x + t.transpose(1, 2).reshape(b, c, h, w)


class Downsample(torch.nn.Module):
    def __init__(self, ch, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.conv = nn.Conv2D(ch, ch, 3, stride=2, padding=1,
                              generator=generator, device=device)

    def forward(self, x):
        return self.conv(x)


class Upsample(torch.nn.Module):
    def __init__(self, ch, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.conv = nn.Conv2D(ch, ch, 3, padding=1, generator=generator,
                              device=device)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UNet2DConditionModel(torch.nn.Module):
    """Down path -> mid (res + cross-attn + res) -> up path with skips.
    ``forward(sample, timesteps, encoder_hidden_states)`` predicts the
    noise. Weights are drawn on ``device`` (default "cuda") from
    ``generator``, or from one seeded with ``seed``."""

    def __init__(self, in_channels=4, out_channels=4, base_channels=64,
                 channel_mults=(1, 2), num_res_blocks=1, context_dim=128,
                 num_heads=4, groups=8, device=DEFAULT_DEVICE, seed=0,
                 generator=None):
        super().__init__()
        init = nn.model_init(device, seed, generator)
        temb_ch = base_channels * 4
        self.base_channels = base_channels
        self.temb1 = nn.Linear(base_channels, temb_ch, **init)
        self.temb2 = nn.Linear(temb_ch, temb_ch, **init)
        self.conv_in = nn.Conv2D(in_channels, base_channels, 3, padding=1,
                                 **init)

        chs = [base_channels]
        ch = base_channels
        self.down_blocks = nn.LayerList()
        for i, mult in enumerate(channel_mults):
            out_ch = base_channels * mult
            for _ in range(num_res_blocks):
                self.down_blocks.append(ResBlock(ch, out_ch, temb_ch, groups,
                                                 **init))
                ch = out_ch
                chs.append(ch)
                self.down_blocks.append(CrossAttnBlock(
                    ch, context_dim, num_heads, groups, **init))
            if i != len(channel_mults) - 1:
                self.down_blocks.append(Downsample(ch, **init))
                chs.append(ch)

        self.mid1 = ResBlock(ch, ch, temb_ch, groups, **init)
        self.mid_attn = CrossAttnBlock(ch, context_dim, num_heads, groups,
                                       **init)
        self.mid2 = ResBlock(ch, ch, temb_ch, groups, **init)

        self.up_blocks = nn.LayerList()
        for i, mult in reversed(list(enumerate(channel_mults))):
            out_ch = base_channels * mult
            for _ in range(num_res_blocks + 1):
                self.up_blocks.append(ResBlock(ch + chs.pop(), out_ch,
                                               temb_ch, groups, **init))
                ch = out_ch
                self.up_blocks.append(CrossAttnBlock(
                    ch, context_dim, num_heads, groups, **init))
            if i != 0:
                self.up_blocks.append(Upsample(ch, **init))

        self.norm_out = nn.GroupNorm(groups, ch, **init)
        self.conv_out = nn.Conv2D(ch, out_channels, 3, padding=1, **init)

    def forward(self, sample, timesteps, encoder_hidden_states):
        temb = timestep_embedding(timesteps, self.base_channels)
        temb = self.temb2(F.silu(self.temb1(temb)))

        h = self.conv_in(sample)
        skips = [h]
        for blk in self.down_blocks:
            if isinstance(blk, ResBlock):
                h = blk(h, temb)
                skips.append(h)
            elif isinstance(blk, CrossAttnBlock):
                h = blk(h, encoder_hidden_states)
            else:
                h = blk(h)
                skips.append(h)

        h = self.mid2(self.mid_attn(self.mid1(h, temb),
                                    encoder_hidden_states), temb)

        for blk in self.up_blocks:
            if isinstance(blk, ResBlock):
                h = blk(torch.cat([h, skips.pop()], dim=1), temb)
            elif isinstance(blk, CrossAttnBlock):
                h = blk(h, encoder_hidden_states)
            else:
                h = blk(h)

        return self.conv_out(F.silu(self.norm_out(h)))
