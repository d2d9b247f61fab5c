"""Hygiene of the PyTorch port (``paddle_tpu_torch``): it imports neither
JAX nor the JAX package, its CUDA pieces load lazily, and its entry
points default to the GPU and refuse to run silently on the CPU."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paddle_tpu_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)[:-3]
        if rel == "chip_smoke":
            continue
        parts = rel.split(os.sep)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _forbidden(name):
    return any(name == p or name.startswith(p + ".")
               for p in ("jax", "jaxlib", "paddle_tpu"))


def test_every_module_imports_without_jax_or_paddle_tpu():
    mods = _modules()
    assert "paddle_tpu_torch.ops.paged_attention" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib') "
        "or m.startswith(('jax.', 'jaxlib.')) or m == 'paddle_tpu' "
        "or m.startswith('paddle_tpu.'))\n"
        "print(json.dumps(bad))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout


def test_no_jax_or_paddle_tpu_import_statement():
    offenders = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [(os.path.relpath(path, REPO), n)
                          for n in names if _forbidden(n)]
    assert offenders == []


def test_kernel_sources_and_lazy_build():
    from paddle_tpu_torch.ops import _build
    # the training step's fused tier replaces work XLA fuses: its sources
    # name the JAX package's function, the others the TPU kernel
    tier = ("fused_norm", "swiglu", "token_ce", "adamw")
    for name in _build.SOURCES:
        src = os.path.join(_build.CSRC_DIR, name + ".cu")
        with open(src) as f:
            text = f.read()
        assert "sm_90a" in text and 'extern "C"' in text
        assert ("paddle_tpu/" if name in tier
                else "paddle_tpu/ops/pallas/") in text
    assert "flashmask" in _build.SOURCES
    assert "paged_decode_attention" in _build.SOURCES
    assert set(tier) <= set(_build.SOURCES)
    assert len(_build.SOURCES) == 10
    # importing the ops built nothing
    assert _build._libs == {}
    assert "compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_an_edited_shared_header_renames_every_library(tmp_path, monkeypatch):
    """csrc/*.cuh is hashed into each library's file name, so editing a
    shared header rebuilds every source instead of loading a stale
    library."""
    import shutil
    from paddle_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    before = {n: _build._lib_path(n)[1] for n in _build.SOURCES}
    assert (csrc / "flash_tiles.cuh").exists()
    with open(csrc / "flash_tiles.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build._lib_path(n)[1] for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
    assert after == {n: _build._lib_path(n)[1] for n in _build.SOURCES}


def _tiny_weights():
    rng = np.random.default_rng(0)
    E, H, G, D, F, V = 16, 2, 1, 8, 16, 32
    return dict(ln_scales=[np.ones(E, np.float32)],
                qkv_weights=[rng.standard_normal((H + 2 * G, D, E))
                             .astype(np.float32)],
                linear_weights=[rng.standard_normal((H * D, E))
                                .astype(np.float32)],
                ffn_ln_scales=[np.ones(E, np.float32)],
                ffn1_weights=[rng.standard_normal((E, 2 * F))
                              .astype(np.float32)],
                ffn2_weights=[rng.standard_normal((F, E)).astype(np.float32)],
                embedding=rng.standard_normal((V, E)).astype(np.float32),
                lm_head=rng.standard_normal((E, V)).astype(np.float32))


def test_entry_points_default_to_cuda():
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.core.random import make_generator
    from paddle_tpu_torch.inference import (FusedMultiTransformerEngine,
                                            engine_weights_from_numpy)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.pretrain import batch_to_device
    from paddle_tpu_torch.nn import RMSNorm
    kw = dict(num_heads=2, head_dim=8, max_seq_len=16, dtype="float32",
              norm_type="rmsnorm", activation="swiglu", gqa_group_size=1)
    cfg = LlamaConfig.tiny(dtype="float32")
    batch = {"input_ids": np.zeros((1, 4), np.int32)}
    if torch.cuda.is_available():
        eng = FusedMultiTransformerEngine(_tiny_weights(), **kw)
        assert eng.device.type == "cuda"
        assert RMSNorm(8).weight.device.type == "cuda"
        assert next(LlamaForCausalLM(cfg).parameters()).device.type == "cuda"
        assert batch_to_device(batch)["input_ids"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FusedMultiTransformerEngine(_tiny_weights(), **kw)
    for build in (lambda: RMSNorm(8), lambda: LlamaForCausalLM(cfg),
                  lambda: batch_to_device(batch)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    assert RMSNorm(8, device="cpu").weight.device.type == "cpu"
    with pytest.raises(RuntimeError):
        engine_weights_from_numpy(_tiny_weights())
    with pytest.raises(RuntimeError):
        make_generator(0)
    with pytest.raises(RuntimeError):
        resolve_device()
    eng = FusedMultiTransformerEngine(_tiny_weights(), device="cpu", **kw)
    assert eng.device.type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_later_slice_engine_options_raise():
    from paddle_tpu_torch.incubate.nn import ContinuousBatchingEngine
    from paddle_tpu_torch.inference import FusedMultiTransformerEngine
    kw = dict(num_heads=2, head_dim=8, max_seq_len=16, dtype="float32",
              norm_type="rmsnorm", activation="swiglu", gqa_group_size=1,
              device="cpu")
    # tensor-parallel serving is served now, over the caller's group;
    # this engine's one kv head does not split over two ranks
    with pytest.raises(ValueError, match="kv_heads .1. divisible by tp"):
        FusedMultiTransformerEngine(_tiny_weights(), tp=2, **kw)
    # the autotune cache is served now (ops.autotune); a dict without the
    # port's schema is a broken cache and leaves both at their defaults
    eng = FusedMultiTransformerEngine(_tiny_weights(), autotune_cache={},
                                      **kw)
    assert eng.split_waves is None
    cb = ContinuousBatchingEngine(eng, num_blocks=4, block_size=4,
                                  autotune_cache={})
    assert cb.prefill_chunk == 64


def test_chip_smoke_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
