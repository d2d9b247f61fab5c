"""Serving engine of the PyTorch port (counterpart of
``paddle_tpu/inference/__init__.py``: ``FusedMultiTransformerEngine``).

The engine holds per-layer weight lists plus the embedding and lm_head
on one device and serves them through ``fused_multi_transformer``:

* ``generate`` — dense-cache greedy or temperature/top-p decoding;
* ``_paged_step`` / ``_paged_rewind`` / ``_paged_copy`` — the three
  programs ``ContinuousBatchingEngine`` drives over the paged cache, with
  the JAX engine's signatures. PyTorch runs eagerly, so each is a plain
  function wrapped in a host-side dispatch span; caches are updated in
  place and returned, because the scheduler reassigns them.

``weight_quant="int4"`` and ``"int8"`` route the four projection
matrices through ``ops.quant_matmul.weight_only_matmul``: the CUDA kernel
on the card, its plain version on the CPU. int4 packs each [K, N] matrix
into the block-halved int4 layout, its block by the kernel's rule
(``kernel_block_n``: a multiple of 128 dividing the width). int8 keeps
the JAX engine's int8 values and per-output-channel scales (absmax / 127
+ 1e-9) repacked to [K, N] with [N] scales, its block by
``pick_block_n(n, "int8")``. The JAX engine leaves int8 to XLA, which
fuses the int8 -> bf16 convert into the matmul's operand load; the int8
kernel is the port's form of that fusion (no float copy of a weight in
device memory). On the card a width that fits no block raises; on the
CPU such widths are served as the JAX engine serves them off the TPU
(quantized at load, dequantized per use), so the two engines can be
held to each other.

``engine_weights_from_numpy`` carries the JAX engine's weight dict
(numpy arrays) over, so the two engines compute the same thing.
"""
import time as _time

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.random import make_generator
from ..incubate.nn.functional import (_unpack_int4, fused_multi_transformer,
                                      quantize_int4)
from ..observability import costs as _costs
from ..observability import instrument as _instrument
from ..observability import tracing as _tracing
from ..ops import paged_attention as _pa
from ..ops.quant_matmul import (kernel_block_n, pack_int4_blocked,
                                pick_block_n, weight_only_matmul)

__all__ = ["FusedMultiTransformerEngine", "engine_weights_from_numpy",
           "set_dispatch_delay"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

# host-side fault-injection point: a per-program dispatch delay in
# seconds, applied before the call is enqueued, inside its dispatch span
_dispatch_delay = {}


def set_dispatch_delay(program, delay_s):
    """Testing hook: stall `program`'s dispatches by `delay_s` host
    seconds (0/None clears). Returns the previous value so callers can
    restore."""
    prev = _dispatch_delay.get(program)
    if not delay_s:
        _dispatch_delay.pop(program, None)
    else:
        _dispatch_delay[program] = float(delay_s)
    return prev


def _dispatch_span(name, fn):
    """Host-side span around one serving program's dispatch (tracing.py
    ring; perf_counter timebase), also observed into the
    `dispatch_seconds{program}` histogram. CUDA work is asynchronous: the
    interval covers the host's enqueue of the program's kernels, not
    their completion on the device.

    While the cost catalog is enabled (``observability.costs``, opt-in),
    the FIRST call of each argument signature runs counted (its flops,
    bytes and peak memory land in the catalog under the program's name;
    the set is cleared when the catalog's generation changes), and every
    other call is timed on the device into
    ``program_device_seconds{program}`` (CUDA events read on a later
    call, never a synchronize)."""
    seen = set()
    seen_gen = [None]

    def call(*args, **kwargs):
        catalog = _costs.get_cost_catalog()
        counted = timer = None
        if catalog.enabled:
            if seen_gen[0] != catalog.generation:
                seen.clear()
                seen_gen[0] = catalog.generation
            sig = _costs.arg_signature(args, kwargs)
            if sig not in seen:
                seen.add(sig)
                counted = f"sig{len(seen)}"
            else:
                timer = catalog.start_timer(_costs.device_of(args, kwargs))
        t0 = _time.perf_counter()
        delay = _dispatch_delay.get(name)
        if delay:
            _time.sleep(delay)
        if counted is not None:
            out, _ = catalog.count_call(name, fn, args, kwargs,
                                        signature=counted)
        else:
            out = fn(*args, **kwargs)
        dur = _time.perf_counter() - t0
        if timer is not None:
            catalog.stop_timer(name, timer)
        _tracing.get_tracer().record_span(name, t0 * 1e6, dur * 1e6)
        _instrument.dispatch_seconds().labels(program=name).observe(dur)
        return out

    call.__wrapped__ = fn
    return call


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r} "
                         f"(have {sorted(_DTYPES)})") from None


def engine_weights_from_numpy(weights, device="cuda", dtype="bfloat16"):
    """The JAX engine's weight dict (numpy arrays or lists of them, as
    bench.py and examples/serve_llama.py build it) -> the port's dict of
    torch tensors on `device`, floating values cast to `dtype` (the JAX
    engine's cast at construction)."""
    dev = resolve_device(device)
    tdt = _torch_dtype(dtype)

    def conv(a):
        t = torch.as_tensor(np.asarray(a))
        if t.is_floating_point():
            t = t.to(tdt)
        return t.to(dev)

    return {k: ([conv(a) for a in v] if isinstance(v, (list, tuple))
                else conv(v)) for k, v in weights.items()}


_PROJECTIONS = (("qkv", "qkv_weights"), ("lin", "linear_weights"),
                ("f1", "ffn1_weights"), ("f2", "ffn2_weights"))


def _quant_blocks(weights, quant):
    """The ``quant`` kernel's block per projection kind ({kind: block_n})
    for the float weight dict: int4 by ``kernel_block_n``, int8 by
    ``pick_block_n(n, "int8")``, both multiples of 128 dividing the width.
    When some width fits no block, every kind gets None: the engine then
    serves all projections through the dequant route, as the JAX engine
    falls back as a whole on an indivisible shape
    (``paddle_tpu/inference/__init__.py`` :547-552), so its weights and
    scales are the JAX engine's. The same on every device."""
    blocks = {}
    for kind, key in _PROJECTIONS:
        w0 = weights[key][0]
        n = int(np.prod(w0.shape[:-1])) if kind == "qkv" else w0.shape[1]
        blocks[kind] = kernel_block_n(n) if quant == "int4" \
            else pick_block_n(n, "int8")
    if None in blocks.values():
        return dict.fromkeys(blocks)
    return blocks


def _quantize_int8(a, axis):
    """The JAX engine's int8 weight quantization (numpy float32 in): per
    output channel, reducing over the input axis ``axis``, scale =
    absmax / 127 + 1e-9, values rounded and clipped to [-127, 127].
    Returns (int8 values shaped as ``a``, scales with ``axis`` of size 1)."""
    m = np.moveaxis(a, axis, -1)
    sc = np.abs(m).max(-1, keepdims=True) / 127.0 + 1e-9
    q = np.clip(np.round(m / sc), -127, 127).astype(np.int8)
    return np.moveaxis(q, -1, axis), np.moveaxis(sc, -1, axis)


class FusedMultiTransformerEngine:
    """Serving engine over ``fused_multi_transformer``.

    weights: dict with keys matching fused_multi_transformer's list args
    (ln_scales, qkv_weights, ...), plus 'embedding' [V, E] and 'lm_head'
    [E, V]; torch tensors (or numpy arrays). Floating weights are cast to
    `dtype` and moved to `device` at construction.

    `device` defaults to "cuda" and raises without a GPU; pass
    device="cpu" for the plain path. ``tp > 1`` and ``autotune_cache``
    belong to a later slice."""

    def __init__(self, weights, num_heads, head_dim, max_seq_len=2048,
                 norm_type="layernorm", activation="gelu",
                 use_neox_rotary_style=False, dtype="bfloat16",
                 gqa_group_size=-1, weight_quant=None, tp=1,
                 autotune_cache=None, device="cuda"):
        self.tp = int(tp) if tp else 1
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        if self.tp > 1:
            raise NotImplementedError("tensor-parallel serving (tp > 1) is "
                                      "a later slice")
        if autotune_cache is not None:
            raise NotImplementedError("autotune_cache is a later slice")
        if weight_quant not in (None, "int4", "int8"):
            raise ValueError(f"weight_quant must be None/int4/int8, got "
                             f"{weight_quant!r}")
        self.device = resolve_device(device)
        self._tdtype = _torch_dtype(dtype)
        self._dtype = str(self._tdtype).replace("torch.", "")

        def arr(v):
            t = v.detach() if isinstance(v, torch.Tensor) \
                else torch.as_tensor(np.asarray(v))
            if t.is_floating_point():
                t = t.to(self._tdtype)
            return t.to(self.device)

        self._w = {k: ([arr(x) for x in v] if isinstance(v, (list, tuple))
                       else arr(v)) for k, v in weights.items()}
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.max_seq_len = max_seq_len
        self._n_layers = len(self._w["qkv_weights"])
        self._gqa = gqa_group_size if gqa_group_size and gqa_group_size > 0 \
            else 0
        self._kw = dict(norm_type=norm_type, activation=activation,
                        use_neox_rotary_style=use_neox_rotary_style,
                        gqa_group_size=gqa_group_size)
        self.weight_quant = weight_quant
        # {kind: "kernel" | "dequant"} per projection, fixed here
        self.quant_routes = {}
        if weight_quant:
            blocks = _quant_blocks(self._w, weight_quant)
            self.quant_routes = {k: "dequant" if bn is None else "kernel"
                                 for k, bn in blocks.items()}
            self._kw["_mm"] = self._build_quant_mm(blocks, weight_quant)
        self._gen = make_generator(0, self.device)
        self._paged_step = _dispatch_span("paged_step", self._paged_step_impl)
        self._paged_rewind = _dispatch_span("paged_rewind",
                                            self._paged_rewind_impl)
        self._paged_copy = _dispatch_span("paged_copy", self._paged_copy_impl)

    # -- weight-only quantization -----------------------------------------
    @staticmethod
    def _matrix(kind, a):
        """Stored weight (numpy or torch) -> its [K, N] matrix (trans_qkvw
        layouts): qkv [ht, hd, E] -> [E, ht*hd]; lin [H*D, E]; ffn1
        [E, 2F]; ffn2 [F, E]."""
        return a.reshape(-1, a.shape[-1]).T if kind == "qkv" else a

    def _build_quant_mm(self, blocks, quant):
        """Quantize the projection weights, REPLACING self._w's lists, and
        return the _mm(z2d, w, kind, li) hook. A kind with a block takes
        the weight-only GEMM: int4 packed into the K x N block-halved
        layout, int8 as the JAX engine's int8 values and scales in [K, N]
        / [N]. A kind without a block (``blocks[kind]`` None, which
        ``_quant_blocks`` gives all kinds or none) takes the dequant route
        of the JAX engine: its weight quantized in its stored layout (int4
        through ``quantize_int4``, int8 per output channel), expanded to
        the compute dtype per use, then a matmul."""
        qkv_out = tuple(self._w["qkv_weights"][0].shape[:-1])
        scales = {}
        for kind, key in _PROJECTIONS:
            packed_l, sc_l = [], []
            axis = -1 if kind == "qkv" else 0
            for t in self._w[key]:
                a = t.detach().float().cpu().numpy()
                if blocks[kind] is None and quant == "int4":
                    packed, sc = quantize_int4(a, axis=axis)
                elif blocks[kind] is None:
                    packed, sc = _quantize_int8(a, axis)
                elif quant == "int4":
                    packed, sc = pack_int4_blocked(self._matrix(kind, a),
                                                   block_n=blocks[kind])
                else:
                    q, sc = _quantize_int8(a, axis)
                    packed = np.ascontiguousarray(self._matrix(kind, q))
                    sc = sc.reshape(-1)
                packed_l.append(torch.as_tensor(packed).to(self.device))
                sc_l.append(torch.as_tensor(sc).to(self.device))
            self._w[key] = packed_l
            scales[kind] = sc_l
        dtype = self._tdtype

        def mm(z2d, w, kind, li):
            if blocks[kind] is None:
                full = _unpack_int4(w, axis=-1 if kind == "qkv" else 0) \
                    if quant == "int4" else w
                full = (full.float() * scales[kind][li]).to(dtype)
                return torch.matmul(z2d.to(dtype), self._matrix(kind, full))
            return weight_only_matmul(z2d.to(dtype).contiguous(), w,
                                      scales[kind][li], quant=quant,
                                      block_n=blocks[kind], out_dtype=dtype)

        mm.qkv_out = qkv_out
        mm.blocks = blocks
        mm.scales = scales
        return mm

    # -- the model --------------------------------------------------------
    def _lists(self):
        w = self._w

        def g(name):
            return w.get(name) or None
        return (w["ln_scales"], g("ln_biases"), w["qkv_weights"],
                g("qkv_biases"), w["linear_weights"], g("linear_biases"),
                w["ffn_ln_scales"], g("ffn_ln_biases"), w["ffn1_weights"],
                g("ffn1_biases"), w["ffn2_weights"], g("ffn2_biases"))

    def _fmt(self, h, **kwargs):
        return fused_multi_transformer(
            h, *self._lists(), rotary_embs=self._w.get("rotary_embs"),
            **self._kw, **kwargs)

    def _select(self, logits, temp, topp, gen):
        """Greedy when temp <= 0, else temperature + nucleus (top-p)
        sampling drawn from `gen` (the JAX engine's select semantics)."""
        if temp <= 0.0:
            return torch.argmax(logits, -1)
        lg = logits.float() / max(float(temp), 1e-6)
        sl = torch.sort(lg, -1, descending=True).values
        ps = torch.softmax(sl, -1)
        csum = torch.cumsum(ps, -1)
        # last sorted index whose PRECEDING mass is still < top_p
        k_idx = ((csum - ps) < topp).sum(-1, keepdim=True) - 1
        thresh = torch.gather(sl, -1, k_idx.clamp(min=0))
        filt = torch.where(lg >= thresh, lg, float("-inf"))
        probs = torch.softmax(filt, -1)
        flat = probs.reshape(-1, probs.shape[-1])
        samp = torch.multinomial(flat, 1, generator=gen)
        return samp.reshape(probs.shape[:-1])

    def _prefill_logits(self, ids, caches=None, lens=None):
        """Dense prefill over [B, S] prompt ids; logits [B, V] at each
        row's last valid position (lens - 1 when ragged)."""
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.long).to(
            self.device)
        if caches is None:
            caches = self.new_caches(ids.shape[0])
        out = self._fmt(self._w["embedding"][ids], cache_kvs=caches,
                        seq_lens=lens)
        if lens is None:
            last = out[:, -1]
        else:
            bidx = torch.arange(out.shape[0], device=self.device)
            last = out[bidx, lens - 1]
        return last @ self._w["lm_head"]

    def _decode_logits(self, caches, tok, t, lens=None):
        out = self._fmt(self._w["embedding"][tok][:, None], cache_kvs=caches,
                        time_step=t, seq_lens=lens)
        return out[:, 0] @ self._w["lm_head"]

    def _paged_step_impl(self, w, caches, toks, qlens, sel, tables, lens,
                         rwork, rpack, temp, topp, key):
        """One continuous-batching step over the PAGED cache. toks [B, C]
        is each slot's token slab (decode slots one token in column 0,
        prefill slots up to C prompt-chunk tokens), qlens [B] the valid
        columns per slot (0 parks the slot), tables/lens the host
        allocator's view BEFORE the step, sel [B, W] the slab columns to
        sample. `rwork`/`rpack` are the host's ragged work list for the
        step: the CUDA kernel walks the block tables, so the list is not
        uploaded (its padded length keys the scheduler's buckets). `key`
        is the scheduler's torch.Generator. `w` must be this engine's
        weights. Returns ([B, W] sampled tokens on the device, caches)."""
        if w is not self._w:
            raise ValueError("_paged_step serves this engine's own weights")
        dev = self.device
        toks_t = torch.as_tensor(np.asarray(toks), dtype=torch.long).to(dev)
        sel_t = torch.as_tensor(np.asarray(sel), dtype=torch.long).to(dev)
        out = self._fmt(w["embedding"][toks_t], cache_kvs=caches,
                        time_step=0, seq_lens=lens, chunk_lens=qlens,
                        block_tables=tables)
        bidx = torch.arange(out.shape[0], device=dev)
        logits = out[bidx[:, None], sel_t] @ w["lm_head"]       # [B, W, V]
        return self._select(logits, float(temp), float(topp), key), caches

    def _paged_rewind_impl(self, caches, tables, new_lens, old_lens, span):
        """Zero every layer's rejected speculative span (positions
        new_lens .. old_lens-1) in place; returns the caches."""
        if not caches:
            return caches
        _, kvh, nb, bs, d = caches[0].shape
        dst = _pa.truncate_index(tables, new_lens, old_lens, span, nb, bs)
        if dst.size:
            idx = torch.as_tensor(dst, dtype=torch.long).to(self.device)
            for c in caches:
                c.view(2, kvh, nb * bs, d).index_fill_(2, idx, 0)
        return caches

    def _paged_copy_impl(self, caches, src_block, dst_block):
        """Duplicate one physical cache block across every layer in place
        (the scheduler's copy-on-write); returns the caches."""
        for c in caches:
            _pa.copy_paged_kv_block(c[0], c[1], src_block, dst_block)
        return caches

    # -- caches and accounting --------------------------------------------
    def _kv_heads(self):
        return self._gqa or self.num_heads

    def new_caches(self, batch_size, dtype=None):
        """Dense per-layer caches [2, B, KVH, max_seq_len, D]."""
        dtype = _torch_dtype(dtype) if dtype else self._tdtype
        return [torch.zeros((2, batch_size, self._kv_heads(),
                             self.max_seq_len, self.head_dim), dtype=dtype,
                            device=self.device)
                for _ in range(self._n_layers)]

    def new_paged_caches(self, num_blocks, block_size, dtype=None):
        """Per-layer paged KV caches [2, KVH, num_blocks, block_size, D]
        for the continuous-batching serving path."""
        dtype = _torch_dtype(dtype) if dtype else self._tdtype
        return [torch.zeros((2, self._kv_heads(), num_blocks, block_size,
                             self.head_dim), dtype=dtype, device=self.device)
                for _ in range(self._n_layers)]

    def kv_device_block_bytes(self, block_size):
        """Bytes ONE allocator block occupies across every layer's cache:
        L x 2(K,V) x KVH x block_size x D x itemsize."""
        itemsize = torch.empty((), dtype=self._tdtype).element_size()
        return (self._n_layers * 2 * (self._kv_heads() // self.tp)
                * int(block_size) * self.head_dim * itemsize)

    def tp_step_comm_bytes(self, batch, width):
        """Collective payload of one paged step: 0, the port serves on one
        device (tensor-parallel serving is a later slice)."""
        return 0

    # -- dense generation -------------------------------------------------
    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_p=1.0, seed=None, prompt_lens=None):
        """Greedy by default; temperature > 0 enables temperature + nucleus
        sampling, drawn from a generator seeded with `seed` (the engine's
        own generator when None). input_ids: [B, S] ints. Returns numpy
        [B, max_new_tokens].

        prompt_lens (optional [B] ints): ragged-batch mode — input_ids is
        RIGHT-padded and each row prefills over its own length and decodes
        at its own cache slot; each length must be in (0, S]."""
        ids = np.asarray(input_ids)
        b, s = ids.shape
        if s + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"max_seq_len ({self.max_seq_len}); raise max_seq_len or "
                "shorten the request")
        gen = self._gen if seed is None else make_generator(seed,
                                                            self.device)
        lens = None
        if prompt_lens is not None:
            lens_np = np.asarray(prompt_lens)
            if lens_np.shape != (b,):
                raise ValueError(
                    f"prompt_lens must be shape [{b}], got {lens_np.shape}")
            if (lens_np <= 0).any() or (lens_np > s).any():
                raise ValueError(
                    f"prompt_lens must be in (0, {s}] (the padded width); "
                    f"got {lens_np.tolist()}")
            lens = torch.as_tensor(lens_np, dtype=torch.long).to(self.device)
        temp, topp = float(temperature), float(top_p)
        with torch.no_grad():
            caches = self.new_caches(b)
            tok = self._select(self._prefill_logits(ids, caches, lens),
                               temp, topp, gen)
            toks = [tok]
            for i in range(max_new_tokens - 1):
                logits = self._decode_logits(caches, tok, s + i, lens)
                tok = self._select(logits, temp, topp, gen)
                toks.append(tok)
                if lens is not None:
                    lens = lens + 1
            return torch.stack(toks, 1).cpu().numpy()
