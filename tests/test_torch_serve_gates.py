"""``tools/torch_serve_gates.py`` on the CPU: the port's gateway, replica,
chaos, tensor-parallel and autotune gates reproduce every host-deterministic field
of the committed JAX baselines (``tools/serve_{gateway,replica,chaos,
tp}.json``: tokens, statuses, per-event token widths, routing tables,
cache counters, per-rank KV bytes, collective payload) and hold every
invariant. The port's fault schedules are the JAX package's
for the same seed."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "torch_serve_gates.py")


@pytest.mark.parametrize("leg", ["gateway", "replica", "chaos"])
def test_gate_reproduces_the_committed_baseline(leg):
    proc = subprocess.run(
        [sys.executable, TOOL, "--device", "cpu", "--check",
         os.path.join("tools", f"serve_{leg}.json")],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert f"{leg} leg OK [cpu]" in proc.stdout
    assert "MISMATCH" not in proc.stdout and "REGRESSION" not in proc.stdout


@pytest.mark.parametrize("tps", ["1,2,4,8"])
def test_tp_gate_reproduces_the_committed_baseline(tps):
    """tools/serve_tp.json (the JAX package's tensor-parallel baseline) at
    its own tps: the port's tp engines, ranks as threads over gloo,
    token-exact against tp=1 with the baseline's steps, spec and prefix
    counters, per-rank KV high-water bytes and collective payload."""
    proc = subprocess.run(
        [sys.executable, TOOL, "--device", "cpu", "--check",
         os.path.join("tools", "serve_tp.json")],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "tp leg OK [cpu]: tps [%s]" % tps.replace(",", ", ") \
        in proc.stdout
    assert "MISMATCH" not in proc.stdout and "REGRESSION" not in proc.stdout


def test_autotune_gate_reproduces_the_committed_baseline():
    """tools/serve_autotune.json's gate.autotune (the JAX package's
    serve_bench --autotune baseline): the port's model-ranked sweep gives
    the committed pack / prefill_chunk winners per bucket (split_waves in
    buffer_depth's place), twice; the tuned scheduler serves the same
    tokens in the same steps as the untuned one, with zero new buckets
    after warm-up and cache lookups at construction only."""
    proc = subprocess.run(
        [sys.executable, TOOL, "--device", "cpu", "--check",
         os.path.join("tools", "serve_autotune.json")],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "autotune leg OK [cpu]: winner pack 4 prefill_chunk 8" \
        in proc.stdout
    assert "MISMATCH" not in proc.stdout and "REGRESSION" not in proc.stdout


def test_gates_refuse_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the gates would run on it")
    proc = subprocess.run(
        [sys.executable, TOOL, "--check",
         os.path.join("tools", "serve_chaos.json")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "leg OK" not in proc.stdout


@pytest.mark.parametrize("seed", range(4))
def test_seeded_fault_plans_equal_jax(seed):
    from paddle_tpu.testing import seeded_plan as jax_plan
    from paddle_tpu_torch.testing import seeded_plan

    def schedule(inj):
        return (sorted(inj._alloc_fail_calls), sorted(inj._alloc_fail_steps),
                sorted(inj._slow_steps.items()), inj._dump_failures)

    kw = dict(steps=40, alloc_fail_rate=0.2, slow_rate=0.3,
              slow_delay_s=0.002, dump_failures=seed % 2)
    got = schedule(seeded_plan(seed, **kw))
    assert got == schedule(jax_plan(seed, **kw))
    assert got[1] and got[2]
