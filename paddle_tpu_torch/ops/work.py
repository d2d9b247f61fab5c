"""The work of each hand-written kernel, from its shapes: the bytes it must
move (each input read once, each output written once) and the operations
it must do on them. One owner for these formulas: ``chip_smoke.py``
computes every kernel's bound from them, and each wrapper reports them at
its counted launch (``note``) to the cost catalog
(``observability.costs``), which cannot see a kernel launched through
``ctypes``.

The rules: causal flash counts the visible pairs, 4·D flops each forward
(two products) and 10·D backward (five); the blockwise CE counts 2·T·H·V
flops forward and 4·T'·H·V for each backward kernel (T' the rows not
ignored); FlashMask and the two-pass backward count 4·D flops per visible
pair for each of the forward, dq and dk / dv; the paged attention kernels
read the KV of min(ctx, capacity) positions once per kv head; the fused
tier is counted in bytes alone. ``bound_ms`` divides by the H100 SXM's
peaks (dense bf16 tensor cores, HBM3).

``note(kernel, nbytes, flops)`` adds a launch to every counter that
``observability.costs`` has active (the dispatch-mode stack, which the
autograd engine's threads inherit); with none active it returns at the
first test. ``counting()`` tells a wrapper whether to compute the work at
all (some of it reads indices back from the device)."""
import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak

_counting = [0]                  # active counters (observability.costs)


def counting():
    return _counting[0] > 0


def note(kernel, nbytes, flops):
    """Add one launch of ``kernel`` moving ``nbytes`` and doing ``flops``
    to each active counter."""
    if not _counting[0]:
        return
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for mode in _get_current_dispatch_mode_stack():
        add = getattr(mode, "add_kernel", None)
        if add is not None:
            add(kernel, nbytes, flops)


def bound_ms(nbytes, flops, bytes_per_s=HBM_BYTES_PER_S,
             flops_per_s=BF16_FLOPS_PER_S):
    """(ms, "bytes" or "operations"): the larger of the two times."""
    t_b = nbytes / bytes_per_s * 1e3
    t_f = flops / flops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# -- attention -----------------------------------------------------------------

def causal_pairs(sq, sk):
    """Visible (row, key) pairs of one causal head: row r sees
    min(r + 1, sk) keys."""
    m = min(sq, sk)
    return m * (m + 1) // 2 + (sq - m) * sk


def flash_pairs(bh, sq, sk, causal):
    return bh * (causal_pairs(sq, sk) if causal else sq * sk)


def flash_fwd(bh, sq, sk, d, causal, itemsize=2, rope=False):
    """(bytes, flops) of the flash forward over [BH, S, D]: q, k, v in, o
    and the f32 lse out; with rope the two f32 tables in and 6 flops per
    (row, pair of q and k)."""
    qo, kv, lse = bh * sq * d * itemsize, bh * sk * d * itemsize, bh * sq * 4
    nbytes = 2 * qo + 2 * kv + lse
    flops = 4 * d * flash_pairs(bh, sq, sk, causal)
    if rope:
        nbytes += 2 * sq * (d // 2) * 4
        flops += 3 * d * bh * 2 * sq
    return nbytes, flops


def flash_bwd(bh, sq, sk, d, causal, itemsize=2, rope=False):
    """(bytes, flops) of the fused flash backward: q, k, v, o, do and lse
    in, dq, dk and dv out; with rope the tables in and twice the forward's
    rotation flops."""
    qo, kv, lse = bh * sq * d * itemsize, bh * sk * d * itemsize, bh * sq * 4
    nbytes = 4 * qo + 4 * kv + lse
    flops = 10 * d * flash_pairs(bh, sq, sk, causal)
    if rope:
        nbytes += 2 * sq * (d // 2) * 4
        flops += 2 * 3 * d * bh * 2 * sq
    return nbytes, flops


def flashmask_pairs(sr, er, h, sq, causal):
    """Visible pairs of a FlashMask case from its [B, MH, Sk] start / end
    row bounds (numpy), counted per column: its causal rows less the
    interval's overlap, each mask row for its H / MH heads."""
    b, mh, sk = sr.shape
    j = np.arange(sk)
    lo = j if causal else np.zeros_like(j)
    over = np.clip(np.minimum(er, sq) - np.maximum(sr, lo), 0, None)
    return int(((sq - lo) - over).sum()) * (h // mh)


def flashmask(b, h, s, d, pairs, index_elems, itemsize=2):
    """{"fwd", "dq", "dkv"}: (bytes, flops) of the FlashMask forward and
    its two backward kernels over [B, S, H, D] with ``index_elems`` start
    and end bounds (0 for the two-pass flash backward): 4·D flops a
    visible pair each."""
    t = b * h * s * d * itemsize
    lse = b * h * s * 4
    idx = 2 * index_elems * 4
    bwd_in = 3 * t + 2 * t + lse + idx          # q k v, o do, lse, index
    flops = 4 * d * pairs
    return {"fwd": (3 * t + idx + t + lse, flops),
            "dq": (bwd_in + t, flops),
            "dkv": (bwd_in + 2 * t, flops)}


def ragged_attention(lens, q_lens, c, max_nb, bs, h, kvh, d, itemsize=2,
                     table_bytes=None):
    """(bytes, flops) of the ragged paged attention over the attention
    lengths ``lens`` [B] (numpy, the new tokens included) with
    ``q_lens`` query rows a sequence (None: one, decode) in a slab of
    ``c`` columns: each needed KV block read once per kv head, q read and
    out written once, the tables and two length arrays; 4·D flops a
    visible (query row, key) pair for each query head."""
    b = lens.shape[0]
    ql = np.ones(b, np.int64) if q_lens is None else \
        np.asarray(q_lens, np.int64)
    lens = np.asarray(lens, np.int64)
    nblk = np.where((lens > 0) & (ql > 0), np.minimum(-(-lens // bs), max_nb),
                    0)
    kv_bytes = int(nblk.sum()) * bs * d * itemsize * 2 * kvh
    qo_bytes = 2 * b * c * h * d * itemsize
    meta = (b * max_nb * 4 if table_bytes is None else table_bytes) + \
        2 * b * 4
    flops = 0
    for i in range(b):
        qs = max(int(lens[i]) - int(ql[i]), 0)
        cap = int(nblk[i]) * bs
        for j in range(int(ql[i])):
            flops += min(qs + j + 1, cap) * 4 * d * h
    return kv_bytes + qo_bytes + meta, flops


def paged_decode(lens, bs, max_nb, b, h, kvh, d, itemsize=2):
    """(bytes, flops) of the legacy decode kernel: the KV of each row's
    first min(ctx, capacity) positions read once per kv head, the table
    entries of the blocks used, q read and out written once; 4·D flops a
    (query head, key)."""
    lens = np.asarray(lens, np.int64)
    toks = int(np.minimum(lens, max_nb * bs).sum())
    blocks = int(np.minimum(-(-lens // bs), max_nb).sum())
    nbytes = (toks * kvh * d * itemsize * 2 + 2 * b * h * d * itemsize
              + blocks * 4 + b * 4)
    return nbytes, 4 * d * h * toks


# -- the LM-head cross entropy ----------------------------------------------------

def blockwise_ce(t, t_live, hid, vocab, itemsize=2):
    """{"fwd", "dh", "dw"}: (bytes, flops) of the blockwise CE kernels: h,
    w and the labels in, loss and lse out forward; the backward adds g and
    lse in and writes dh or dw. 2·T·H·V flops forward, 4·T'·H·V a backward
    kernel."""
    hw = t * hid * itemsize + hid * vocab * itemsize
    fwd = hw + t * 8 + 2 * t * 4
    bwd_in = hw + t * 8 + 2 * t * 4
    back = 4 * t_live * hid * vocab
    return {"fwd": (fwd, 2 * t * hid * vocab),
            "dh": (bwd_in + t * hid * itemsize, back),
            "dw": (bwd_in + hid * vocab * itemsize, back)}


# -- the weight-only GEMM ----------------------------------------------------------

def weight_only_matmul(m, k, n, bits, itemsize=2):
    """(bytes, flops): x [M, K] and the packed weight and its f32 scales
    in, [M, N] out; 2·M·N·K flops."""
    return (m * k * itemsize + k * n * bits // 8 + n * 4 + m * n * itemsize,
            2 * m * n * k)


# -- the training step's fused tier (bytes alone) -----------------------------------

def rms_norm_fwd(r, hid, eb, ob, residual):
    """x (and the residual) in, out (and h) out, the f32 inv and weight."""
    return r * hid * (eb * (1 + 2 * residual) + ob) + r * 4 + hid * 4, 0


def rms_norm_bwd(r, hid, eb, ob, residual):
    """dout, h in (and the residual's grad), dh out, inv, w in, dw out."""
    return r * hid * (eb * (2 + residual) + ob) + r * 4 + 2 * hid * 4, 0


def swiglu_fwd(r, im, eb=2):
    return 3 * r * im * eb, 0


def swiglu_bwd(r, im, eb=2):
    return 5 * r * im * eb, 0


def token_ce_fwd(n, vocab, eb):
    """The logits in; labels in, loss and three row stats out."""
    return n * vocab * eb + n * (8 + 12), 0


def token_ce_bwd(n, vocab, eb):
    return 2 * n * vocab * eb + n * 16, 0


def adamw(n, grad_itemsize=4):
    """p, g, m, v read and p, m, v written; all f32 but g."""
    return n * (4 * 6 + grad_itemsize), 0
