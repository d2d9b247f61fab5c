"""Weight-only int8 / int4 matmul for the PyTorch port (counterpart of
``paddle_tpu/ops/pallas/quant_matmul.py``).

Layout contract (unchanged from the JAX package):
  x        [M, K]     float32 / bfloat16 / float16 activations
  w_packed [K, N]     int8 values (int8 mode), or
           [K, N//2]  int8, BLOCK-HALVED nibbles from ``pack_int4_blocked``
                      (int4 mode): within each block_n output-column
                      block, the low nibbles carry the first block_n/2
                      columns and the high nibbles the second half
  scales   [N]        float32 per-output-channel scales
  out      [M, N]     x's dtype (or ``out_dtype``)

``weight_only_matmul`` launches a CUDA kernel of
``csrc/weight_only_matmul.cu`` for a CUDA tensor (int4 or int8, each
with its own launch count) and runs the plain
``weight_only_matmul_plain`` for a CPU tensor. bf16 / fp16 activations
take the tensor-core body, whose plan (``plan``: tile, K splits, blocks,
workspace) the kernel's source chooses from the shape and the card's SM
count; f32 takes the CUDA-core body.
"""
import ctypes
import functools

import numpy as np
import torch

from . import work as _work

DEFAULT_BLOCK_N = 512

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def pick_block_n(n, quant="int8", prefer=DEFAULT_BLOCK_N):
    """Largest lane-aligned block that divides N (int4 packs two columns
    per byte, so its block must be a multiple of 256). None if N fits no
    legal block."""
    step = 256 if quant == "int4" else 128
    b = min(prefer, n)
    b -= b % step
    while b >= step:
        if n % b == 0:
            return b
        b -= step
    return None


def kernel_block_n(n, prefer=DEFAULT_BLOCK_N):
    """Largest block the CUDA int4 kernel takes for N: a multiple of 128
    (each half-block holds whole 64-byte tiles) that divides N and is at
    most ``prefer``. None if N is not a multiple of 128. The TPU's rule,
    ``pick_block_n(n, "int4")``, wants multiples of 256."""
    b = min(prefer, n)
    b -= b % 128
    while b >= 128:
        if n % b == 0:
            return b
        b -= 128
    return None


def pack_int4_blocked(w, block_n=DEFAULT_BLOCK_N):
    """Quantize a float [K, N] weight to the kernel's packed int4 layout:
    per-output-channel symmetric scales, nibbles packed block-halved (see
    module docstring). Returns (packed [K, N//2] int8, scales [N] f32),
    both numpy."""
    w = np.asarray(w, np.float32)
    k, n = w.shape
    if n % block_n or block_n % 2:
        raise ValueError(f"block_n={block_n} must divide N={n} (and be even)")
    scales = np.abs(w).max(axis=0) / 7.0
    scales = np.where(scales == 0, 1.0, scales).astype(np.float32)
    q = np.clip(np.round(w / scales[None, :]), -8, 7).astype(np.int8)
    half = block_n // 2
    packed = np.empty((k, n // 2), np.int8)
    for j in range(n // block_n):
        blk = q[:, j * block_n:(j + 1) * block_n]
        lo, hi = blk[:, :half], blk[:, half:]
        packed[:, j * half:(j + 1) * half] = (
            (hi.astype(np.uint8) << 4) |
            (lo.astype(np.uint8) & 0x0F)).astype(np.int8)
    return packed, scales


def unpack_int4_blocked(w_packed, block_n=DEFAULT_BLOCK_N):
    """[K, N//2] block-halved int8 nibbles -> [K, N] int8 values in
    [-8, 7] (torch, on w_packed's device)."""
    k, nh = w_packed.shape
    half = block_n // 2
    u = w_packed.to(torch.int16) & 0xFF
    lo = ((u & 0x0F) ^ 8) - 8
    hi = ((u >> 4) ^ 8) - 8
    nblk = nh // half
    full = torch.cat([lo.reshape(k, nblk, half), hi.reshape(k, nblk, half)],
                     dim=2)
    return full.reshape(k, nh * 2).to(torch.int8)


def weight_only_matmul_plain(x, w_packed, scales, quant="int4",
                             block_n=DEFAULT_BLOCK_N, out_dtype=None):
    """x @ dequant(w_packed) * scales in plain PyTorch, on any device: the
    products and their sum in float32, the per-column scale after the sum,
    the result cast to ``out_dtype`` (default x's dtype)."""
    if quant == "int4":
        w = unpack_int4_blocked(w_packed, block_n)
    elif quant == "int8":
        w = w_packed
    else:
        raise ValueError(f"quant must be int8/int4, got {quant!r}")
    acc = x.float() @ w.float()
    return (acc * scales.float()[None, :]).to(out_dtype or x.dtype)


def weight_only_matmul(x, w_packed, scales, quant="int4",
                       block_n=DEFAULT_BLOCK_N, out_dtype=None):
    """x @ dequant(w_packed) * scales, the quantized weights never expanded
    to float in device memory. A CPU tensor runs the plain version; a CUDA
    tensor launches the int4 kernel (counted in
    ``weight_only_matmul.launches``) or the int8 kernel (counted in
    ``weight_only_matmul.int8_launches``), or raises. Both kernels take
    contiguous x and w on one device, x in float32 / bfloat16 / float16
    equal to the output dtype, float32 scales [N], and ``block_n`` a
    multiple of 128 dividing N, with w 16-byte aligned. A bf16 / fp16
    call whose plan splits K gets its f32 workspace from ``torch.empty``;
    it is still one kernel launch."""
    dev = x.device
    if dev.type == "cpu":
        return weight_only_matmul_plain(x, w_packed, scales, quant=quant,
                                        block_n=block_n, out_dtype=out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"weight_only_matmul: unsupported device {dev}")
    if quant not in ("int4", "int8"):
        raise ValueError(f"quant must be int8/int4, got {quant!r}")
    xs, wsh = x.shape, w_packed.shape
    if len(xs) != 2 or len(wsh) != 2 or xs[1] != wsh[0]:
        want = "[K, N/2]" if quant == "int4" else "[K, N]"
        raise ValueError(f"weight_only_matmul: x {tuple(xs)} and {quant} "
                         f"w {tuple(wsh)} must be [M, K], {want}")
    m, k = xs
    n = wsh[1] * (2 if quant == "int4" else 1)
    code = _DTYPE_CODE.get(x.dtype)
    if code is None or (out_dtype is not None and out_dtype != x.dtype):
        raise ValueError(f"weight_only_matmul: x dtype {x.dtype} (out "
                         f"{out_dtype}) must be float32/bfloat16/float16 "
                         "and equal the output dtype")
    if w_packed.dtype != torch.int8 or scales.dtype != torch.float32 \
            or scales.shape != (n,):
        raise ValueError("weight_only_matmul: w_packed must be int8 and "
                         f"scales float32 [{n}]")
    if block_n % 128 or n % block_n:
        raise ValueError(f"weight_only_matmul: block_n={block_n} must be a "
                         f"multiple of 128 dividing N={n}")
    if not (x.is_contiguous() and w_packed.is_contiguous()
            and scales.is_contiguous()) or w_packed.device != dev \
            or scales.device != dev:
        raise ValueError("weight_only_matmul: x, w_packed and scales must "
                         f"be contiguous tensors on {dev}")
    if w_packed.data_ptr() % 16:
        raise ValueError("weight_only_matmul: w_packed must be 16-byte "
                         "aligned")
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return out
    ws_bytes, sms = _workspace(m, k, n, code, dev.index)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev) \
        if ws_bytes else None
    rc = _launcher(quant)(code, x.data_ptr(), w_packed.data_ptr(),
                          scales.data_ptr(), out.data_ptr(), m, k, n,
                          int(block_n), None if ws is None else ws.data_ptr(),
                          ws_bytes, sms,
                          torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"weight_only_matmul: {quant} kernel launch "
                           f"failed with CUDA error {rc}")
    if quant == "int4":
        weight_only_matmul.launches += 1
    else:
        weight_only_matmul.int8_launches += 1
    if _work.counting():
        _work.note(f"weight_only_{quant}", *_work.weight_only_matmul(
            m, k, n, 4 if quant == "int4" else 8, x.element_size()))
    return out


weight_only_matmul.launches = 0         # int4 kernel launches
weight_only_matmul.int8_launches = 0    # int8 kernel launches


PLAN_KEYS = ("bm", "bn", "splits", "blocks", "workspace_bytes")


def plan(m, k, n, dtype=torch.bfloat16, device=None):
    """The kernel's launch plan (the same for int8 and int4) for x [M, K]
    of ``dtype`` against a weight of N columns on the card, from
    ``csrc/weight_only_matmul.cu``: rows ``bm`` and columns ``bn`` of a
    block's tile, K ``splits``, ``blocks`` in the grid and the
    ``workspace_bytes`` the wrapper allocates (0 at one split)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    return dict(zip(PLAN_KEYS, _plan(int(m), int(k), int(n),
                                     _DTYPE_CODE[dtype], _sms(device))))


@functools.cache
def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _workspace(m, k, n, code, index):
    """(workspace bytes of the plan, SM count) on card ``index``."""
    sms = _sms(torch.device("cuda", index))
    return _plan(m, k, n, code, sms)[4], sms


@functools.lru_cache(maxsize=1024)
def _plan(m, k, n, code, sms):
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    got = _launcher("plan")(m, k, n, code, sms, out)
    if got != len(PLAN_KEYS):
        raise ValueError(f"weight_only_matmul: no plan for M={m}, K={k}, "
                         f"N={n}")
    return tuple(out)


@functools.cache
def _launcher(which):
    """The kernel's C entry point (``which``: int4, int8 or plan) with its
    prototype bound, built and loaded on the first use."""
    from . import _build
    lib = _build.load("weight_only_matmul")
    if which == "plan":
        fn = lib.weight_only_plan
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
        return fn
    fn = getattr(lib, f"weight_only_{which}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_longlong,
                                ctypes.c_int, ctypes.c_void_p]
    return fn
