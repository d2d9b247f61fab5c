"""Vision Transformer for the PyTorch port (counterpart of
``paddle_tpu/models/vit.py``): a patch-embedding convolution, a class
token and learned position embeddings (``create_parameter``'s
XavierNormal, as the JAX model's), a pre-LN ``TransformerEncoder`` with
gelu, and a linear head on the class token. The attention is
``nn.MultiHeadAttention``'s: non-causal flash attention (K1 / K2 on the
card) at S = patches + 1, off the kernels' 64-row tile at 197. The
model has no dtype switch: run it in bf16 under ``amp`` O2, as a Paddle
user would."""
import torch

from ..core.device import DEFAULT_DEVICE
from .. import nn

__all__ = ["PatchEmbed", "VisionTransformer", "vit_base_patch16_224",
           "vit_large_patch16_224", "vit_tiny"]


class PatchEmbed(torch.nn.Module):
    def __init__(self, img_size=224, patch_size=16, in_chans=3, embed_dim=768,
                 generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.num_patches = (img_size // patch_size) ** 2
        self.proj = nn.Conv2D(in_chans, embed_dim, kernel_size=patch_size,
                              stride=patch_size, generator=generator,
                              device=device)

    def forward(self, x):
        x = self.proj(x)                       # [B, E, H/p, W/p]
        b, e = x.shape[0], x.shape[1]
        return x.reshape(b, e, -1).transpose(1, 2)   # [B, N, E]


class VisionTransformer(torch.nn.Module):
    """Weights are drawn on ``device`` (default "cuda") from ``generator``,
    or from one seeded with ``seed``."""

    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 num_classes=1000, embed_dim=768, depth=12, num_heads=12,
                 mlp_ratio=4.0, dropout=0.0, attn_dropout=0.0,
                 class_num=None, device=DEFAULT_DEVICE, seed=0,
                 generator=None):
        super().__init__()
        init = nn.model_init(device, seed, generator)
        num_classes = class_num or num_classes
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                      embed_dim, **init)
        n = self.patch_embed.num_patches
        self.cls_token = nn.create_parameter([1, 1, embed_dim], **init)
        self.pos_embed = nn.create_parameter([1, n + 1, embed_dim], **init)
        self.pos_drop = nn.Dropout(dropout)
        layer = nn.TransformerEncoderLayer(
            d_model=embed_dim, nhead=num_heads,
            dim_feedforward=int(embed_dim * mlp_ratio), dropout=dropout,
            activation="gelu", attn_dropout=attn_dropout,
            normalize_before=True, **init)
        self.encoder = nn.TransformerEncoder(
            layer, depth, norm=nn.LayerNorm(embed_dim, **init))
        self.head = nn.Linear(embed_dim, num_classes, **init)

    def forward(self, x):
        x = self.patch_embed(x)                # [B, N, E]
        cls = self.cls_token.expand(x.shape[0], 1, self.cls_token.shape[-1])
        h = self.pos_drop(torch.cat([cls, x], dim=1) + self.pos_embed)
        return self.head(self.encoder(h)[:, 0])


def vit_base_patch16_224(**kwargs):
    return VisionTransformer(patch_size=16, embed_dim=768, depth=12,
                             num_heads=12, **kwargs)


def vit_large_patch16_224(**kwargs):
    return VisionTransformer(patch_size=16, embed_dim=1024, depth=24,
                             num_heads=16, **kwargs)


def vit_tiny(**kwargs):
    kwargs.setdefault("img_size", 32)
    kwargs.setdefault("patch_size", 8)
    kwargs.setdefault("embed_dim", 64)
    kwargs.setdefault("depth", 2)
    kwargs.setdefault("num_heads", 4)
    kwargs.setdefault("num_classes", 10)
    return VisionTransformer(**kwargs)
