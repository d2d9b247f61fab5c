"""AMP debugging of the PyTorch port (counterpart of
``paddle_tpu/amp/debugging.py``; reference python/paddle/amp/debugging.py
and accuracy_compare.py): operator stats, the tensor checker and run
comparison.

The collectors ride the auto-cast hook (``amp._hook``): they see a named
entry's or a mapped torch call's inputs after the cast, by Paddle's op
name, as JAX's collectors see them in the dispatch hook. Enabling a
collector enters the hook's torch-function mode on the calling thread,
so the torch calls of that thread are seen; the named entries are seen
on every thread.
"""
import contextlib
from collections import defaultdict

import torch

from . import _hook

__all__ = ["TensorCheckerConfig", "enable_operator_stats_collection",
           "disable_operator_stats_collection", "collect_operator_stats",
           "enable_tensor_checker", "disable_tensor_checker",
           "check_numerics", "collect_run_stats", "compare_accuracy"]

_stats = None  # {op_name: {dtype_str: count}} while collecting
_checker = None
_entered = {"stats": False, "checker": False}


def _dtype_str(dtype):
    return str(dtype).replace("torch.", "")


class TensorCheckerConfig:
    def __init__(self, enable=True, debug_mode=None, output_dir=None,
                 checked_op_list=None, skipped_op_list=None,
                 debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = set(checked_op_list or [])
        self.skipped_op_list = set(skipped_op_list or [])
        self.debug_step = debug_step
        self.stack_height_limit = stack_height_limit


def _stats_hook(name, args, kwargs):
    """Count every tensor input of op ``name`` by dtype, and check the
    floating ones for nan / inf under an enabled checker."""
    tensors = [a for a in list(args) + list(kwargs.values())
               if isinstance(a, torch.Tensor)]
    if _stats is not None:
        for a in tensors:
            _stats[name][_dtype_str(a.dtype)] += 1
    cfg = _checker
    if cfg is not None and cfg.enable and name not in cfg.skipped_op_list \
            and (not cfg.checked_op_list or name in cfg.checked_op_list):
        for a in tensors:
            if a.is_floating_point() and not bool(torch.isfinite(a).all()):
                raise FloatingPointError(
                    f"nan/inf detected in input of op '{name}'")


def _toggle(which, on):
    if on and not _entered[which]:
        _hook._enter()
        _entered[which] = True
    elif not on and _entered[which]:
        _hook._exit()
        _entered[which] = False


def enable_operator_stats_collection():
    global _stats
    _stats = defaultdict(lambda: defaultdict(int))
    _toggle("stats", True)


def disable_operator_stats_collection():
    global _stats
    stats = _stats
    _stats = None
    _toggle("stats", False)
    if stats:
        print("<{:-^120}>".format(" op list "))
        fmt = "<{:-^40}" + "|{:-^17}" * 4 + ">"
        print(fmt.format("Op Name", "FP16 Calls", "BF16 Calls",
                         "FP32 Calls", "Other Calls"))
        for op in sorted(stats):
            d = stats[op]
            f16 = d.get("float16", 0)
            bf16 = d.get("bfloat16", 0)
            f32 = d.get("float32", 0)
            other = sum(v for k, v in d.items()
                        if k not in ("float16", "bfloat16", "float32"))
            print("<{:-^40}".format(op)
                  + "|{:-^17}|{:-^17}|{:-^17}|{:-^17}>".format(
                      f16, bf16, f32, other))
    return stats


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def enable_tensor_checker(checker_config):
    global _checker
    _checker = checker_config
    _toggle("checker", True)


def disable_tensor_checker():
    global _checker
    _checker = None
    _toggle("checker", False)


def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
    """Check one tensor for nan / inf; raises FloatingPointError on any,
    else returns (num_nan, num_inf) as 0-dim int64 tensors."""
    t = torch.as_tensor(tensor)
    num_nan = int(torch.isnan(t).sum()) if t.is_floating_point() else 0
    num_inf = int(torch.isinf(t).sum()) if t.is_floating_point() else 0
    if num_nan or num_inf:
        raise FloatingPointError(
            f"{num_nan} nan and {num_inf} inf in {op_type}:{var_name}")
    return torch.tensor(num_nan), torch.tensor(num_inf)


# -- run comparison (reference python/paddle/amp/accuracy_compare.py) ------
class _RunDump:
    """Per-op output statistics of a run, for later comparison."""

    def __init__(self):
        self.records = []  # (op_name, mean, absmax, has_nan, has_inf, dtype)

    def _listener(self, name, outs):
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        for o in outs:
            if not isinstance(o, torch.Tensor) or not o.is_floating_point():
                continue
            a = o.detach().float()
            self.records.append((name, float(a.mean()),
                                 float(a.abs().max()) if a.numel() else 0.0,
                                 bool(torch.isnan(a).any()),
                                 bool(torch.isinf(a).any()),
                                 _dtype_str(o.dtype)))


@contextlib.contextmanager
def collect_run_stats():
    """Record per-op output statistics of every hooked op run inside (the
    dump side of accuracy_compare); yields the dump."""
    dump = _RunDump()
    _hook._listeners.append(dump._listener)
    _hook._enter()
    try:
        yield dump
    finally:
        _hook._exit()
        _hook._listeners.remove(dump._listener)


def compare_accuracy(dump_fp32, dump_amp, output_filename=None,
                     loss_scale=1.0, dump_all_tensors=False):
    """Diff two run dumps op by op (JAX's rows; an optional tsv). Rows
    pair the i-th op of each run: the runs must execute the same
    program."""
    rows = []
    n = min(len(dump_fp32.records), len(dump_amp.records))
    for i in range(n):
        f32 = dump_fp32.records[i]
        amp = dump_amp.records[i]
        rel = abs(f32[1] - amp[1]) / (abs(f32[1]) + 1e-12)
        # flag on absmax drift: means of near-zero-centered tensors make
        # the relative mean noise
        rel_absmax = abs(f32[2] - amp[2]) / (abs(f32[2]) + 1e-12)
        rows.append({
            "op": f32[0], "fp32_mean": f32[1], "amp_mean": amp[1],
            "fp32_absmax": f32[2], "amp_absmax": amp[2],
            "mean_rel_diff": rel, "absmax_rel_diff": rel_absmax,
            "amp_nan": amp[3], "amp_inf": amp[4],
            "fp32_dtype": f32[5], "amp_dtype": amp[5],
            "flag": "NAN/INF" if (amp[3] or amp[4]) else
                    ("LARGE_DIFF" if rel_absmax > 0.1 else ""),
        })
    if output_filename:
        with open(output_filename, "w") as f:
            cols = list(rows[0].keys()) if rows else []
            f.write("\t".join(cols) + "\n")
            for r in rows:
                f.write("\t".join(str(r[c]) for c in cols) + "\n")
    return rows
