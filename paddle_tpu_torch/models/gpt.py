"""GPT-2 family for the PyTorch port (counterpart of
``paddle_tpu/models/gpt.py``): learned position embeddings, pre-LayerNorm
blocks with a fused [H, 3H] QKV projection, a gelu MLP and an LM head
tied to the word embeddings.

The JAX model's arithmetic: the embeddings' sum cast to bf16 when
``config.dtype`` is "bfloat16"; causal ``F.flash_attention`` (the CUDA
kernels K1 / K2 on the card); every linear's f32 bias promotes its
product as the JAX op does, so a bf16 activation comes out of the first
projection in f32, and from there on the blocks (their attention
included) compute in f32. The training step's bf16 weights
(``pretrain.make_train_step``) do not change that: the JAX step casts
only the parameters of two or more dims, and the biases keep f32.

Parameter names equal ``jit.functional.state_arrays``'s: the JAX model
binds its ``GPTModel`` as both ``gpt`` and ``model`` and names the
parameters once, under ``gpt``; the port registers ``gpt`` and reads
``model`` as a property."""
import torch

from ..core.device import DEFAULT_DEVICE
from .. import nn
from ..nn import functional as F
from ..nn import initializer as I

__all__ = ["GPTConfig", "GPTAttention", "GPTBlock", "GPTModel",
           "GPTForCausalLM"]


class GPTConfig:
    """The JAX package's GPT config surface; defaults are GPT-2 small."""

    def __init__(self, vocab_size=50304, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=None, max_position_embeddings=1024,
                 layer_norm_epsilon=1e-5, initializer_range=0.02,
                 dropout=0.0, tie_word_embeddings=True, dtype="bfloat16",
                 **kwargs):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position_embeddings = max_position_embeddings
        self.layer_norm_epsilon = layer_norm_epsilon
        self.initializer_range = initializer_range
        self.dropout = dropout
        self.tie_word_embeddings = tie_word_embeddings
        self.dtype = dtype
        for k, v in kwargs.items():
            setattr(self, k, v)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw):
        base = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=128)
        base.update(kw)
        return cls(**base)


def _attr(config):
    return nn.ParamAttr(initializer=I.Normal(0.0, config.initializer_range))


class GPTAttention(torch.nn.Module):
    def __init__(self, config, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = config.head_dim
        kw = dict(weight_attr=_attr(config), generator=generator,
                  device=device)
        self.qkv_proj = nn.Linear(h, 3 * h, **kw)
        self.out_proj = nn.Linear(h, h, **kw)
        self.dropout = config.dropout

    def forward(self, x):
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        out, _ = F.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                   dropout=self.dropout, causal=True,
                                   training=self.training)
        return self.out_proj(out.reshape(b, s, -1))


class GPTBlock(torch.nn.Module):
    def __init__(self, config, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_epsilon
        init = dict(generator=generator, device=device)
        self.ln_1 = nn.LayerNorm(h, epsilon=eps, **init)
        self.attn = GPTAttention(config, **init)
        self.ln_2 = nn.LayerNorm(h, epsilon=eps, **init)
        self.linear1 = nn.Linear(h, config.intermediate_size,
                                 weight_attr=_attr(config), **init)
        self.linear2 = nn.Linear(config.intermediate_size, h,
                                 weight_attr=_attr(config), **init)
        self.drop = nn.Dropout(config.dropout)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.drop(self.linear2(F.gelu(self.linear1(self.ln_2(x)))))


class GPTModel(torch.nn.Module):
    """Embeddings, ``num_hidden_layers`` blocks and the final LayerNorm.
    Weights are drawn on ``device`` (default "cuda") from ``generator``, or
    from one seeded with ``seed``."""

    def __init__(self, config, device=DEFAULT_DEVICE, seed=0, generator=None):
        super().__init__()
        init = nn.model_init(device, seed, generator)
        self.config = config
        self.word_embeddings = nn.Embedding(
            config.vocab_size, config.hidden_size, weight_attr=_attr(config),
            **init)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, config.hidden_size,
            weight_attr=_attr(config), **init)
        self.h = nn.LayerList([GPTBlock(config, **init)
                               for _ in range(config.num_hidden_layers)])
        self.ln_f = nn.LayerNorm(config.hidden_size,
                                 epsilon=config.layer_norm_epsilon, **init)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)
        x = self.word_embeddings(input_ids) + \
            self.position_embeddings(position_ids)
        if self.config.dtype == "bfloat16":
            x = x.to(torch.bfloat16)
        for block in self.h:
            x = block(x)
        return self.ln_f(x)


class GPTForCausalLM(torch.nn.Module):
    """``GPTModel`` and the tied LM head. ``forward(input_ids,
    position_ids=None, labels=None)`` returns the logits, or (logits,
    loss) with labels (mean token cross entropy; labels are the next
    tokens already)."""

    def __init__(self, config, device=DEFAULT_DEVICE, seed=0, generator=None):
        super().__init__()
        self.config = config
        self.gpt = GPTModel(config, device, seed, generator)

    @property
    def model(self):
        return self.gpt

    def forward(self, input_ids, position_ids=None, labels=None):
        hidden = self.gpt(input_ids, position_ids)
        w = self.gpt.word_embeddings.weight
        logits = F.linear(hidden, w.t().to(hidden.dtype))
        if labels is None:
            return logits
        v = logits.shape[-1]
        return logits, F.cross_entropy(logits.reshape(-1, v),
                                       labels.reshape(-1))
