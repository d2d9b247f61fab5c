"""What the wrappers of the training step's fused tier (``fused_norm``,
``swiglu``, ``token_ce``, ``adamw``) share: the dtype codes of their C
entry points, the device rule (a CPU tensor runs the plain version, a
CUDA tensor the kernel, anything else raises), the 16-byte test of the
vector route, the launch check and the C entry points themselves."""
import ctypes
import functools

import torch

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def on_cuda(name, x):
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type == "cuda"


def dtype_code(name, x):
    code = DTYPE_CODE.get(x.dtype)
    if code is None:
        raise ValueError(f"{name}: dtype {x.dtype} is not one of float32, "
                         "bfloat16, float16")
    return code


def aligned16(*tensors):
    """Every tensor (None skipped) starts on a 16-byte boundary."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def ptr(t):
    return None if t is None else t.data_ptr()


def stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def raise_on(name, rc):
    if rc == -1:
        raise ValueError(f"{name}: dtype combination not built")
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


def sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# source -> {C entry point: argument types}; every entry returns an int
PROTOTYPES = {
    "fused_norm": {
        "fused_norm_fwd": [_I] * 4 + [_P] * 7 + [_L, _I, _F, _P],
        "fused_norm_bwd": [_I] * 4 + [_P] * 8 + [_L] + [_I] * 4 + [_P],
    },
    "swiglu": {
        "swiglu_fwd": [_I, _I] + [_P] * 3 + [_L] * 3 + [_L, _I, _P],
        "swiglu_bwd": [_I, _I] + [_P] * 5 + [_L] * 5 + [_L, _I, _P],
    },
    "token_ce": {
        "token_ce_fwd": [_I, _I] + [_P] * 5 + [_L, _L, _I, _L, _F, _F,
                                               _I, _I, _P],
        "token_ce_fwd_partial": [_I, _I] + [_P] * 3 + [_L, _L, _I, _L,
                                                       _I, _I, _P],
        "token_ce_bwd": [_I, _I] + [_P] * 6 + [_L, _L, _I, _L, _L, _F,
                                               _F, _I, _P],
    },
    "adamw": {
        "adamw_max_tensors": [],
        "adamw_chunk_elems": [],
        "adamw_max_groups": [],
        "adamw_ws_slots": [],
        "adamw_sumsq": [_I] + [_P] * 6 + [_F, _I, _P, _P, _P],
        "adamw_update": [_I] + [_P] * 9 + [_F] * 9 + [_I] + [_P] * 4
                        + [_I, _P, _P, _F, _P, _P],
        "adamw_eager_sumsq": [_I] + [_P] * 7 + [_F, _P, _P],
        "adamw_eager_update": [_I] + [_P] * 14 + [_F] * 7 + [_I, _I, _F,
                                                             _P, _P],
    },
}


@functools.cache
def entry(source, name):
    """The C entry point ``name`` of csrc/``source``.cu with its prototype
    bound, built and loaded on first use."""
    from . import _build
    fn = getattr(_build.load(source), name)
    fn.argtypes = PROTOTYPES[source][name]
    fn.restype = ctypes.c_int
    return fn
