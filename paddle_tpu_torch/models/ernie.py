"""ERNIE family for the PyTorch port (counterpart of
``paddle_tpu/models/ernie.py``): a BERT-style bidirectional encoder
(word, position and token-type embeddings, a post-LN
``TransformerEncoder`` with gelu, a tanh pooler) and its heads,
``ErnieForSequenceClassification`` and ``ErnieForMaskedLM`` (a decoder
tied to the word embeddings plus a bias).

The JAX routing of the attention: a 2-D 0/1 ``attention_mask`` becomes
the additive [B, 1, 1, S] mask of (1 - mask) * -1e4 in ``config.dtype``,
and ``scaled_dot_product_attention`` with a mask, or with dropout while
training, runs the plain ``_sdpa_ref``; with no mask in eval it runs
flash attention (K1 on the card; in f32 at the default dtype, K1's f32
route). ``config.dtype`` sets the mask's dtype only, as in the JAX
model: run the encoder in bf16 under ``amp`` O2."""
import torch

from ..core.device import DEFAULT_DEVICE
from .. import nn
from ..nn import functional as F
from .pretrain import ernie_sharding_rules

__all__ = ["ErnieConfig", "ErnieEmbeddings", "ErnieModel",
           "ErnieForSequenceClassification", "ErnieForMaskedLM",
           "ernie_sharding_rules"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class ErnieConfig:
    """The JAX package's ERNIE config surface; defaults are ERNIE-base."""

    def __init__(self, vocab_size=40000, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=4,
                 pad_token_id=0, dtype="float32"):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.pad_token_id = pad_token_id
        self.dtype = dtype

    @classmethod
    def tiny(cls, **kw):
        base = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128,
                    max_position_embeddings=64, type_vocab_size=2)
        base.update(kw)
        return cls(**base)


class ErnieEmbeddings(torch.nn.Module):
    def __init__(self, cfg, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        init = dict(generator=generator, device=device)
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            **init)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, **init)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size, **init)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, **init)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device).expand(
                b, s)
        if token_type_ids is None:
            token_type_ids = torch.zeros((b, s), dtype=torch.int64,
                                         device=input_ids.device)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class ErnieModel(torch.nn.Module):
    """Encoder stack and pooler: ``forward`` returns (hidden states,
    pooled). Weights are drawn on ``device`` (default "cuda") from
    ``generator``, or from one seeded with ``seed``."""

    def __init__(self, config, device=DEFAULT_DEVICE, seed=0, generator=None):
        super().__init__()
        init = nn.model_init(device, seed, generator)
        self.config = config
        self.embeddings = ErnieEmbeddings(config, **init)
        enc_layer = nn.TransformerEncoderLayer(
            d_model=config.hidden_size, nhead=config.num_attention_heads,
            dim_feedforward=config.intermediate_size,
            dropout=config.hidden_dropout_prob,
            activation=config.hidden_act,
            attn_dropout=config.attention_probs_dropout_prob,
            act_dropout=0.0, normalize_before=False, **init)
        self.encoder = nn.TransformerEncoder(enc_layer,
                                             config.num_hidden_layers)
        self.pooler = nn.Linear(config.hidden_size, config.hidden_size,
                                **init)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        h = self.embeddings(input_ids, token_type_ids, position_ids)
        if attention_mask is not None and attention_mask.dim() == 2:
            # [B, S] 1/0 -> additive [B, 1, 1, S]
            m = (1.0 - attention_mask.to(_DTYPES[self.config.dtype])) * -1e4
            attention_mask = m[:, None, None, :]
        h = self.encoder(h, src_mask=attention_mask)
        return h, F.tanh(self.pooler(h[:, 0]))


class ErnieForSequenceClassification(torch.nn.Module):
    def __init__(self, config, num_classes=2, device=DEFAULT_DEVICE, seed=0,
                 generator=None):
        super().__init__()
        init = nn.model_init(device, seed, generator)
        self.ernie = ErnieModel(config, **init)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)
        self.classifier = nn.Linear(config.hidden_size, num_classes, **init)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, labels=None):
        _, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                               attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        return logits, F.cross_entropy(logits, labels)


class ErnieForMaskedLM(torch.nn.Module):
    """The MLM head: transform, gelu, LayerNorm, then the decoder tied to
    the word embeddings (h @ E^T) plus ``bias``."""

    def __init__(self, config, device=DEFAULT_DEVICE, seed=0, generator=None):
        super().__init__()
        init = nn.model_init(device, seed, generator)
        self.ernie = ErnieModel(config, **init)
        self.transform = nn.Linear(config.hidden_size, config.hidden_size,
                                   **init)
        self.layer_norm = nn.LayerNorm(config.hidden_size, **init)
        self.bias = nn.create_parameter([config.vocab_size], is_bias=True,
                                        **init)

    def forward(self, input_ids, token_type_ids=None, labels=None,
                attention_mask=None):
        h, _ = self.ernie(input_ids, token_type_ids,
                          attention_mask=attention_mask)
        h = self.layer_norm(F.gelu(self.transform(h)))
        logits = F.linear(h, self.ernie.embeddings.word_embeddings
                          .weight.t()) + self.bias
        if labels is None:
            return logits
        return logits, F.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
            ignore_index=-100)
