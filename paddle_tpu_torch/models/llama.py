"""Llama model family for the PyTorch port (counterpart of
``paddle_tpu/models/llama.py``).

The same modules, parameter names and arithmetic as the JAX package:
float32 parameters, hidden states cast to bf16 when ``config.dtype`` is
"bfloat16", RMSNorm in float32 with its scale cast to the activation's
dtype, neox RoPE, attention through ``F.flash_attention`` (the CUDA
kernels on the card) or, with a mask, the plain ``_sdpa_ref``, and a
float32 cross entropy over the LM head's logits. The training step's
fused tier carries the rest on the card: each residual add goes into the
next RMSNorm's kernel (``ops.fused_norm``), the MLP's silu(gate) * up is
the SwiGLU kernel (``ops.swiglu``) and the criterion the token
cross-entropy kernel (``ops.token_ce``).

Two opt-in kernel options of the JAX model are ported:
``fuse_rope_in_attention`` hands ``[S, D/2]`` cos/sin tables to the flash
kernels, which rotate q and k themselves (only without position ids and
without a mask; otherwise the model rotates first, as the JAX model
does), and ``fused_lm_loss`` computes the loss with
``fused_lm_head_loss``, the blockwise LM-head cross entropy whose
``[B*S, V]`` logits never exist; the forward then returns ``(None,
loss)``.

Parameter names match ``jit.functional.state_arrays`` of the JAX model
(``llama.embed_tokens.weight``, ``llama.layers.{i}.self_attn.qkv_proj
.weight``, ``lm_head.weight`` [hidden, vocab], ...), so
``llama_state_from_numpy`` loads its arrays directly.

``recompute`` (True or a named policy of
``distributed.fleet.recompute``) runs each decoder layer through
``recompute`` while the model trains: the layer's activations are rebuilt
in the backward, the flash forward kernel then launching twice a layer.
``LlamaForCausalLMPipe`` is the pipeline form (``fleet.pipeline_parallel``:
a rank builds its stage's elements; ``llama_pipe_state_from_numpy`` /
``llama_pipe_state_to_numpy`` carry weights across under the JAX
``PipelineLayer``'s or ``LlamaForCausalLM``'s names).
``sequence_parallel`` only shards activations over a mesh and has no
effect on one device, as in the JAX package off-mesh.

``context_parallel`` (True, or the name of the mesh axis; default "sp")
with ``context_parallel_mode`` "ring" (default) or "ulysses": when the
mesh of the step (``distributed.mesh.get_mesh()``) has that axis at a
size above 1 and there is no ``attn_mask``, each rank holds its
contiguous block of the sequence and the attention runs as
``fleet.context_parallel``'s ``ring_attention`` or ``ulysses_attention``
over the axis; any other mode raises ``ValueError``. RoPE then rotates
by the block's global positions (the block's index times its length,
onward) with ``fused_rotary_position_embedding``, and
``fuse_rope_in_attention`` is ignored, as the JAX model ignores it.

On the training mesh (``pretrain.make_train_step`` with a mesh of more
than one rank, ``distributed.fleet.sharded``) each layer computes with
the weight its module is bound to (``_weight``: the gathered compute form
of the rank's shard), and the attention and the MLP take their local
head and column counts from it: a module split over mp runs its own
heads (the flash kernels on ``[B, S, H/mp, D]``) between the Megatron
operators of its ``_tp`` binding. An LM head bound to them runs
vocab-parallel: its logits are this rank's vocabulary columns, [B, S,
V/mp], and the criterion's loss is fleet's ``parallel_cross_entropy``
over them (kernel C's vocab-sharded form). Off the mesh nothing is bound
and the modules compute as above.
"""
import numpy as np
import torch
import torch.nn.functional as TF
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from ..core.random import make_generator
from .. import nn
from ..distributed.fleet.mp_layers import parallel_cross_entropy
from ..distributed.fleet.recompute import recompute
from ..nn import functional as F
from ..nn.layers.common import normal_
from ..ops.blockwise_ce import blockwise_lm_head_ce
from ..ops.swiglu import swiglu
from .state import load_numpy, state_to_numpy

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaLMHead", "LlamaForCausalLM",
           "LlamaPretrainingCriterion", "LlamaForCausalLMPipe",
           "LlamaEmbeddingPipe", "LlamaDecoderLayerPipe",
           "LlamaRMSNormHeadPipe", "fused_lm_head_loss",
           "llama_state_from_numpy", "llama_state_to_numpy",
           "llama_pipe_state_from_numpy", "llama_pipe_state_to_numpy"]


class LlamaConfig:
    """The JAX package's llama config surface; defaults are llama-2-7b."""

    def __init__(self, vocab_size=32000, hidden_size=4096,
                 intermediate_size=11008, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=None,
                 max_position_embeddings=4096, rms_norm_eps=1e-6,
                 rope_theta=10000.0, initializer_range=0.02,
                 tie_word_embeddings=False, sequence_parallel=False,
                 use_flash_attention=True, recompute=False,
                 dtype="bfloat16", **kwargs):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads or num_attention_heads
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.initializer_range = initializer_range
        self.tie_word_embeddings = tie_word_embeddings
        self.sequence_parallel = sequence_parallel
        self.use_flash_attention = use_flash_attention
        self.recompute = recompute
        self.dtype = dtype
        for k, v in kwargs.items():
            setattr(self, k, v)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw):
        """Small config for tests."""
        base = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=128)
        base.update(kw)
        return cls(**base)


def _weight(mod):
    """The weight a layer computes with: the module's parameter, or on the
    training mesh its gathered compute form (``sharded.bound``)."""
    bind = mod.__dict__.get("_shard_weight")
    return mod.weight if bind is None else bind(mod.weight)


class _Init:
    """Where a model's layers draw their initial weights: one generator on
    the model's device, Normal(0, initializer_range)."""

    def __init__(self, config, device, generator):
        self.std = config.initializer_range
        self.device = device
        self.generator = generator

    def linear(self, n_in, n_out):
        return nn.Linear(n_in, n_out, self.std, self.generator, self.device)


class LlamaAttention(torch.nn.Module):
    """Self-attention with neox RoPE and grouped-query heads; bias-free
    q/k/v/o projections, q/k/v fused into one when
    ``config.fuse_attention_qkv``."""

    def __init__(self, config, init):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.head_dim
        kv_out = self.num_kv_heads * self.head_dim
        self.fuse_qkv = getattr(config, "fuse_attention_qkv", False)
        if self.fuse_qkv:
            self.qkv_proj = init.linear(h, h + 2 * kv_out)
        else:
            self.q_proj = init.linear(h, h)
            self.k_proj = init.linear(h, kv_out)
            self.v_proj = init.linear(h, kv_out)
        self.o_proj = init.linear(h, h)

    def _context_parallel_axis(self):
        """(mesh, axis) of the active context-parallel axis when
        ``config.context_parallel`` is on and the mesh of the step carries
        the axis with a size above 1; None otherwise."""
        cp = getattr(self.config, "context_parallel", False)
        if not cp:
            return None
        from ..distributed.mesh import get_mesh
        axis = cp if isinstance(cp, str) else "sp"
        mesh = get_mesh()
        if mesh is not None and axis in mesh.dim_names \
                and mesh.get_dim_size(axis) > 1:
            return mesh, axis
        return None

    def forward(self, hidden_states, position_ids=None, attn_mask=None):
        b, s = hidden_states.shape[0], hidden_states.shape[1]
        d = self.head_dim
        tp = self.__dict__.get("_tp")
        if tp is not None:
            hidden_states = tp.enter(hidden_states)
        if self.fuse_qkv:
            w = _weight(self.qkv_proj)
            # mp's share of the heads: 1 off the mesh or run whole
            split = (self.num_heads + 2 * self.num_kv_heads) * d \
                // w.shape[1]
            nh, nkv = self.num_heads // split, self.num_kv_heads // split
            h, kv_out = nh * d, nkv * d
            qkv = F.linear(hidden_states, w)
            q = qkv[:, :, :h].reshape(b, s, nh, d)
            k = qkv[:, :, h:h + kv_out].reshape(b, s, nkv, d)
            v = qkv[:, :, h + kv_out:].reshape(b, s, nkv, d)
        else:
            wq, wk, wv = (_weight(self.q_proj), _weight(self.k_proj),
                          _weight(self.v_proj))
            nh, nkv = wq.shape[1] // d, wk.shape[1] // d
            h = nh * d
            q = F.linear(hidden_states, wq).reshape(b, s, nh, d)
            k = F.linear(hidden_states, wk).reshape(b, s, nkv, d)
            v = F.linear(hidden_states, wv).reshape(b, s, nkv, d)
        rope = {}
        cp = self._context_parallel_axis()
        mode = getattr(self.config, "context_parallel_mode", "ring")
        if cp is not None and mode not in ("ring", "ulysses"):
            raise ValueError(f"context_parallel_mode={mode!r}: expected "
                             "'ring' or 'ulysses'")
        if cp is not None and position_ids is None:
            # this rank's block of the sequence at its global positions
            from ..distributed.fleet.context_parallel import _sep_axis
            offset = _sep_axis(*cp).index * s
            position_ids = torch.arange(offset, offset + s,
                                        device=hidden_states.device)
        if getattr(self.config, "fuse_rope_in_attention", False) \
                and position_ids is None and attn_mask is None:
            # the flash kernels rotate q and k themselves
            cos, sin = F.rotary_embedding_cos_sin(
                s, self.head_dim, base=self.config.rope_theta,
                device=hidden_states.device)
            rope = dict(rope_cos=cos, rope_sin=sin)
        else:
            q, k, v = F.fused_rotary_position_embedding(
                q, k, v, position_ids=position_ids,
                use_neox_rotary_style=True,
                rotary_emb_base=self.config.rope_theta)
        if cp is not None and attn_mask is not None:
            # the JAX model attends over the whole sequence there (GSPMD
            # gathers it); a rank here holds its block alone
            raise NotImplementedError(
                "an attn_mask under context parallelism: the port attends "
                "over a sequence split by the mesh without masks only")
        if cp is not None:
            from ..distributed.fleet import context_parallel as _cp
            attn = _cp.ulysses_attention if mode == "ulysses" \
                else _cp.ring_attention
            out = attn(q, k, v, causal=True, mesh=cp[0], axis_name=cp[1],
                       stats=self.__dict__.get("_cp_stats"))
        elif attn_mask is None:
            out, _ = F.flash_attention(q, k, v, causal=True, **rope)
        else:
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                                 is_causal=True)
        out = F.linear(out.reshape(b, s, h), _weight(self.o_proj))
        return out if tp is None else tp.leave(out)


class LlamaMLP(torch.nn.Module):
    """SwiGLU MLP: down(silu(gate(x)) * up(x)); gate and up fused into one
    projection when ``config.fuse_attention_ffn``."""

    def __init__(self, config, init):
        super().__init__()
        h, im = config.hidden_size, config.intermediate_size
        self.im = im
        self.fuse_ffn = getattr(config, "fuse_attention_ffn", False)
        if self.fuse_ffn:
            self.gate_up_fused_proj = init.linear(h, 2 * im)
        else:
            self.gate_proj = init.linear(h, im)
            self.up_proj = init.linear(h, im)
        self.down_proj = init.linear(im, h)

    def forward(self, x):
        # SwiGLU kernel: the fused projection's halves are read in place
        # and its gradient is written as one [.., 2 im] tensor (on the
        # mesh a rank's [gate_r | up_r])
        tp = self.__dict__.get("_tp")
        if tp is not None:
            x = tp.enter(x)
        if self.fuse_ffn:
            act = swiglu(F.linear(x, _weight(self.gate_up_fused_proj)))
        else:
            act = swiglu(F.linear(x, _weight(self.gate_proj)),
                         F.linear(x, _weight(self.up_proj)))
        out = F.linear(act, _weight(self.down_proj))
        return out if tp is None else tp.leave(out)


class LlamaDecoderLayer(torch.nn.Module):
    def __init__(self, config, init):
        super().__init__()
        self.self_attn = LlamaAttention(config, init)
        self.mlp = LlamaMLP(config, init)
        self.input_layernorm = nn.RMSNorm(config.hidden_size,
                                          config.rms_norm_eps, init.device)
        self.post_attention_layernorm = nn.RMSNorm(
            config.hidden_size, config.rms_norm_eps, init.device)

    def forward(self, hidden_states, position_ids=None, attn_mask=None,
                residual=None):
        """(mlp output, residual stream): the residual add before each norm
        goes into the norm's kernel, and the layer's last add into the next
        layer's first norm (or the model's final norm). ``residual`` None
        (the first layer) takes ``hidden_states`` as the stream. The same
        rounded values as the JAX layer's ``residual + hidden_states``."""
        if residual is None:
            residual = hidden_states
            hidden_states = self.input_layernorm(hidden_states)
        else:
            hidden_states, residual = self.input_layernorm(hidden_states,
                                                           residual)
        hidden_states = self.self_attn(hidden_states, position_ids, attn_mask)
        hidden_states, residual = self.post_attention_layernorm(
            hidden_states, residual)
        return self.mlp(hidden_states), residual


class LlamaModel(torch.nn.Module):
    def __init__(self, config, init):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, init.std,
                                         init.generator, init.device)
        self.layers = torch.nn.ModuleList(
            [LlamaDecoderLayer(config, init)
             for _ in range(config.num_hidden_layers)])
        self.norm = nn.RMSNorm(config.hidden_size, config.rms_norm_eps,
                               init.device)

    def forward(self, input_ids, position_ids=None, attn_mask=None):
        hidden_states = F.embedding(input_ids, _weight(self.embed_tokens))
        if self.config.dtype == "bfloat16":
            hidden_states = hidden_states.to(torch.bfloat16)
        residual = None
        policy = self.config.recompute
        for layer in self.layers:
            if policy and self.training and torch.is_grad_enabled():
                # the residual stream (None at layer 0) goes through the
                # checkpoint beside the hidden states
                hidden_states, residual = recompute(
                    layer, hidden_states, position_ids, attn_mask, residual,
                    policy=policy if isinstance(policy, str) else None)
            else:
                hidden_states, residual = layer(hidden_states, position_ids,
                                                attn_mask, residual)
        if residual is None:
            return self.norm(hidden_states)
        return self.norm(hidden_states, residual)[0]


class LlamaLMHead(torch.nn.Module):
    """The [hidden, vocab] projection to logits, or the transposed input
    embedding when ``tie_word_embeddings``."""

    def __init__(self, config, init, embed=None):
        super().__init__()
        if config.tie_word_embeddings and embed is not None:
            # kept off the module tree: the table is the embedding's
            # parameter and is named (and loaded) there only
            object.__setattr__(self, "_tied", embed)
            self.weight = None
        else:
            object.__setattr__(self, "_tied", None)
            self.weight = torch.nn.Parameter(normal_(
                (config.hidden_size, config.vocab_size), init.std,
                init.generator, init.device))

    def get_weight(self):
        """The [hidden, vocab] projection, resolving weight tying."""
        return _weight(self._tied).t() if self._tied is not None \
            else _weight(self)

    def forward(self, hidden_states):
        # the logits product runs in the hidden states' dtype; the
        # criterion upcasts inside the softmax. Vocab-parallel on the
        # mesh (``_tp``): the input's gradient is summed over mp
        tp = self.__dict__.get("_tp")
        if tp is not None:
            hidden_states = tp.enter(hidden_states)
        return F.linear(hidden_states,
                        self.get_weight().to(hidden_states.dtype))


class LlamaPretrainingCriterion(torch.nn.Module):
    """Mean token cross entropy in float32 over already-shifted labels.
    ``denominator`` (a 0-dim f32 tensor) replaces the count of the labels
    kept: the training mesh divides a rank's sum by the global count.
    ``vocab_parallel`` (the mp operators of a vocab-parallel LM head):
    the logits are this rank's vocabulary columns, and the loss runs
    through ``parallel_cross_entropy``."""

    def forward(self, logits, labels, denominator=None, vocab_parallel=None):
        v = logits.shape[-1]
        if vocab_parallel is not None:
            lbl = labels.reshape(-1)
            rows = parallel_cross_entropy(logits.reshape(-1, v), lbl,
                                          vocab_parallel)
            if denominator is None:
                denominator = (lbl != -100).sum().to(
                    torch.float32).clamp_min(1.0)
            return rows.sum() / denominator
        if denominator is None:
            return F.cross_entropy(logits.reshape(-1, v), labels.reshape(-1),
                                   reduction="mean")
        return F.cross_entropy(logits.reshape(-1, v), labels.reshape(-1),
                               reduction="sum") / denominator


class LlamaForCausalLM(torch.nn.Module):
    """Decoder stack + LM head. ``forward(input_ids, position_ids=None,
    attn_mask=None, labels=None)`` returns logits, or (logits, loss) with
    labels, or (None, loss) with labels and ``config.fused_lm_loss``.
    Weights are drawn on ``device`` (default "cuda") from a generator
    seeded with ``seed``."""

    def __init__(self, config, device="cuda", seed=0):
        super().__init__()
        dev = resolve_device(device)
        init = _Init(config, dev, make_generator(seed, dev))
        self.config = config
        self.llama = LlamaModel(config, init)
        self.lm_head = LlamaLMHead(
            config, init,
            embed=self.llama.embed_tokens if config.tie_word_embeddings
            else None)

    @property
    def model(self):
        return self.llama

    def forward(self, input_ids, position_ids=None, attn_mask=None,
                labels=None, loss_denominator=None):
        hidden_states = self.llama(input_ids, position_ids, attn_mask)
        if labels is not None and getattr(self.config, "fused_lm_loss",
                                          False):
            return None, fused_lm_head_loss(
                hidden_states, self.lm_head.get_weight(), labels,
                denominator=loss_denominator)
        logits = self.lm_head(hidden_states)
        if labels is not None:
            return logits, LlamaPretrainingCriterion()(
                logits, labels, loss_denominator,
                self.lm_head.__dict__.get("_tp"))
        return logits


def fused_lm_head_loss(hidden_states, weight, labels, ignore_index=-100,
                       chunk_tokens=1024, mode=None, denominator=None):
    """Mean token cross entropy of the LM head; the [B*S, V] logits never
    exist. hidden_states [B, S, H], weight [H, V] (cast to the hidden
    states' dtype), labels [B, S]; the sum over non-ignored tokens divided
    by their count (at least 1), in float32, or by ``denominator`` (the
    training mesh's global count) when given.

    mode None or "pallas": the blockwise op (``ops.blockwise_ce``: the CUDA
    kernels on the card, their plain versions on the CPU). "scan": token
    chunks of ``chunk_tokens`` in plain PyTorch, each chunk's [chunk, V]
    logits recomputed in the backward (``torch.utils.checkpoint``), as the
    JAX package's scan mode; a caller has to name it."""
    if mode is None:
        mode = "pallas"
    if mode not in ("pallas", "scan"):
        raise ValueError(f"fused_lm_head_loss mode must be 'pallas' or "
                         f"'scan', got {mode!r}")
    b, s, hid = hidden_states.shape
    t = b * s
    h = hidden_states.reshape(t, hid)
    lab = labels.reshape(t).to(torch.int64)
    w = weight.to(hidden_states.dtype)
    if mode == "pallas":
        loss = blockwise_lm_head_ce(h, w, lab, ignore_index)
        if denominator is not None:
            return loss.sum() / denominator
        cnt = (lab != ignore_index).to(torch.float32).sum()
        return loss.sum() / cnt.clamp_min(1.0)
    nch = max(1, -(-t // chunk_tokens))
    per = -(-t // nch)
    pad = per * nch - t
    h = TF.pad(h, (0, 0, 0, pad))
    lab = TF.pad(lab, (0, pad), value=ignore_index)

    def body(hc, lc):
        logits = torch.matmul(hc.float(), w.float())
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, 1, lc.clamp(0, w.shape[1] - 1)[:, None])
        mask = (lc != ignore_index).to(torch.float32)
        return torch.sum((logz - gold[:, 0]) * mask), torch.sum(mask)

    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nch):
        lo, hi = i * per, (i + 1) * per
        dt, dc = checkpoint(body, h[lo:hi], lab[lo:hi], use_reentrant=False)
        tot, cnt = tot + dt, cnt + dc
    return tot / (cnt.clamp_min(1.0) if denominator is None
                  else denominator)


# -- the pipeline-parallel form (reference: paddlenlp LlamaForCausalLMPipe;
# the JAX package's models/llama.py:411-469) ---------------------------------

def _pipe_init(config, device, seed):
    dev = _pipe_device(device)
    return _Init(config, dev, make_generator(seed, dev))


def _pipe_device(device):
    """The device of a pipe element: the one named, else the device of
    this thread's hybrid topology, else the card."""
    if device is not None:
        return resolve_device(device)
    from ..distributed.fleet.topology import get_hcg
    hcg = get_hcg()
    return hcg.mesh.device if hcg is not None else resolve_device("cuda")


class LlamaEmbeddingPipe(torch.nn.Module):
    """First pipeline element: ids -> hidden states (cast to bf16 when
    ``config.dtype`` is "bfloat16")."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        init = _pipe_init(config, device, seed)
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, init.std,
                                         init.generator, init.device)

    def forward(self, input_ids):
        h = F.embedding(input_ids, _weight(self.embed_tokens))
        if self.config.dtype == "bfloat16":
            h = h.to(torch.bfloat16)
        return h


class LlamaDecoderLayerPipe(LlamaDecoderLayer):
    """A decoder block of the pipe: carry -> (hidden, residual), the
    one-card model's pair (the residual add goes into the next norm's
    kernel), so a stage boundary carries both tensors. The first block
    takes the embedding's hidden states alone. ``config.recompute``
    checkpoints the block while it trains, as ``LlamaModel`` does."""

    def __init__(self, config, device=None, seed=0):
        super().__init__(config, _pipe_init(config, device, seed))
        self.config = config

    def forward(self, carry, _inner=False):
        policy = self.config.recompute
        if policy and not _inner and self.training \
                and torch.is_grad_enabled():
            return recompute(self, carry, True,
                             policy=policy if isinstance(policy, str)
                             else None)
        hidden, residual = carry if isinstance(carry, tuple) \
            else (carry, None)
        return super().forward(hidden, None, None, residual)


class LlamaRMSNormHeadPipe(torch.nn.Module):
    """Last pipeline element: the final RMSNorm (with the last block's
    residual add) and the LM head -> logits; on the training mesh's mp
    axis the head runs vocab-parallel (``vocab_parallel()`` gives the
    criterion its operators)."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        init = _pipe_init(config, device, seed)
        self.norm = nn.RMSNorm(config.hidden_size, config.rms_norm_eps,
                               init.device)
        self.lm_head = LlamaLMHead(config, init)

    def forward(self, carry):
        hidden, residual = carry if isinstance(carry, tuple) \
            else (carry, None)
        h = self.norm(hidden) if residual is None \
            else self.norm(hidden, residual)[0]
        return self.lm_head(h)

    def vocab_parallel(self):
        return self.lm_head.__dict__.get("_tp")


def LlamaForCausalLMPipe(config, num_stages, loss_fn=None, device=None,
                         seed=0):
    """The llama model in ``PipelineLayer`` form: the embedding, the
    ``num_hidden_layers`` decoder blocks and the norm + head, as
    ``LayerDesc``s (a rank of a pp axis builds its stage's only), the
    loss ``LlamaPretrainingCriterion`` unless `loss_fn` is given, and
    ``_shard_rules`` (``pretrain.llama_sharding_rules``) for the mp
    axis. Element i draws its weights from ``seed * 100003 + i`` on
    `device` (default this thread's ``fleet.init`` device, else the
    card); ``llama_pipe_state_from_numpy`` loads given ones."""
    from ..distributed.fleet.pipeline_parallel import (LayerDesc,
                                                      PipelineLayer)
    from .pretrain import llama_sharding_rules
    n = config.num_hidden_layers

    def desc(cls, i):
        return LayerDesc(cls, config, device=device, seed=seed * 100003 + i)
    descs = [desc(LlamaEmbeddingPipe, 0)]
    descs += [desc(LlamaDecoderLayerPipe, i + 1) for i in range(n)]
    descs += [desc(LlamaRMSNormHeadPipe, n + 1)]
    pipe = PipelineLayer(layers=descs, num_stages=num_stages,
                         loss_fn=loss_fn or LlamaPretrainingCriterion())
    pipe._shard_rules = llama_sharding_rules()
    pipe._config = config
    return pipe


def _pipe_name(name, n_layers):
    """A ``LlamaForCausalLM`` parameter name as the pipe's, or the name
    itself when it is already one."""
    if name.startswith("llama.embed_tokens."):
        return "layers.0." + name[len("llama."):]
    if name.startswith("llama.layers."):
        i, rest = name[len("llama.layers."):].split(".", 1)
        return f"layers.{int(i) + 1}.{rest}"
    if name.startswith("llama.norm."):
        return f"layers.{n_layers + 1}." + name[len("llama."):]
    if name.startswith("lm_head."):
        return f"layers.{n_layers + 1}.{name}"
    return name


def _causal_lm_name(name, n_layers):
    i, rest = name[len("layers."):].split(".", 1)
    i = int(i)
    if i == 0:
        return "llama." + rest
    if i == n_layers + 1:
        return rest if rest.startswith("lm_head.") else "llama." + rest
    return f"llama.layers.{i - 1}.{rest}"


def _pipe_layer(pipe):
    return getattr(pipe, "_layers", pipe)


def llama_pipe_state_from_numpy(params, pipe, dtype=None):
    """Load this rank's stage (or chunks) of ``pipe`` (a
    ``LlamaForCausalLMPipe``, or the ``PipelineParallel`` around it) from
    whole weights: {name: array or tensor} under the JAX
    ``PipelineLayer``'s names (``layers.0.embed_tokens.weight``,
    ``layers.{i}.…``, ``layers.{L+1}.lm_head.weight``) or
    ``LlamaForCausalLM``'s (``llama.…``, ``lm_head.weight``). Names of
    other stages are skipped; one of this stage that is missing raises.
    A stage cut to its mp shards takes its shard. ``dtype`` casts every
    weight (default float32). Returns ``pipe``."""
    net = _pipe_layer(pipe)
    n = net._config.num_hidden_layers
    given = {_pipe_name(k, n): v for k, v in params.items()}
    own = dict(net.named_parameters())
    missing = sorted(set(own) - set(given))
    if missing:
        raise KeyError(f"llama_pipe_state_from_numpy: missing {missing}")
    mesh = getattr(pipe, "mesh", None)
    with torch.no_grad():
        for name, p in own.items():
            v = given[name]
            t = v.detach().to(torch.float32) if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.array(v, dtype=np.float32))
            plan = net._plans.get(name)
            if plan is not None:
                if tuple(t.shape) != plan.layout.shape:
                    raise ValueError(f"llama_pipe_state_from_numpy: {name} "
                                     f"has shape {tuple(t.shape)}, the model "
                                     f"{plan.layout.shape}")
                t = plan.layout.take(t.to(p.device), mesh.coords)
            elif tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"llama_pipe_state_from_numpy: {name} has "
                                 f"shape {tuple(t.shape)}, the model "
                                 f"{tuple(p.shape)}")
            # a copy of its own: training updates the parameter in place
            p.data = t.to(device=p.device, dtype=dtype or torch.float32,
                          copy=True)
    return pipe


def llama_pipe_state_to_numpy(pipe, names="pipe"):
    """{name: whole float32 np.ndarray} of this rank's stage of ``pipe``,
    under the JAX ``PipelineLayer``'s names, or ``LlamaForCausalLM``'s
    with ``names="causal_lm"``; the inverse of
    ``llama_pipe_state_from_numpy``. A stage cut to mp shards gathers
    them over the mp group (a collective: every mp rank of the stage
    calls it)."""
    net = _pipe_layer(pipe)
    n = net._config.num_hidden_layers
    mesh = getattr(pipe, "mesh", None)
    out = {}
    for name, p in net.named_parameters():
        a = p.detach().to(torch.float32)
        plan = net._plans.get(name)
        if plan is not None and "mp" in plan.layout.spec:
            from ..distributed import collective
            parts = collective.all_gather([], a.contiguous(),
                                          group=mesh.groups["mp"])
            whole = np.empty(plan.layout.shape, np.float32)
            for r, part in enumerate(parts):
                plan.layout.put(whole, part.cpu().numpy(),
                                dict(mesh.coords, mp=r))
            arr = whole
        else:
            arr = a.cpu().numpy().copy()    # not a view of the parameter
        key = _causal_lm_name(name, n) if names == "causal_lm" else name
        out[key] = arr
    return out


def llama_state_from_numpy(params, config, device="cuda", dtype=None):
    """A ``LlamaForCausalLM`` holding the JAX model's weights.

    ``params`` is {name: np.ndarray} as ``jit.functional.state_arrays``
    gives it for the JAX model (names and [in, out] layouts are the
    same). ``dtype`` casts every weight (default: keep float32). The key
    sets must match exactly."""
    return load_numpy(LlamaForCausalLM(config, device=device), params, dtype,
                      "llama_state_from_numpy")


def llama_state_to_numpy(model):
    """{name: float32 np.ndarray} of a port model's parameters, the
    inverse of ``llama_state_from_numpy``."""
    return state_to_numpy(model)
