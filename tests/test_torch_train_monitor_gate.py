"""``tools/torch_train_monitor.py`` on the CPU: the port's train_health
gate holds every exact field and bound of the committed JAX baseline
(``tools/train_health.json``: telemetry neutrality, the group labels, a
healthy run with no breach, and each injected fault's fire matrix and
dump reasons)."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "torch_train_monitor.py")


def test_gate_holds_the_committed_jax_baseline():
    proc = subprocess.run(
        [sys.executable, TOOL, "--device", "cpu", "--check",
         os.path.join("tools", "train_health.json")],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "train_health gate OK (cpu): 18 exact fields, 9 bounds" in \
        proc.stdout
    assert "fired={'update_ratio': 1, 'loss_spike': 1, 'grad_spike': 1}" \
        in proc.stdout


def test_gate_holds_the_committed_jax_baseline_on_the_jax_gates_mesh():
    """The JAX gate's (dp2, fsdp2, mp2) mesh: eight thread ranks over
    gloo, the port's sharded step with the vocab-parallel LM head."""
    proc = subprocess.run(
        [sys.executable, TOOL, "--device", "cpu", "--mesh", "dp2,fsdp2,mp2",
         "--check", os.path.join("tools", "train_health.json")],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "train_health gate OK (cpu, mesh dp2,fsdp2,mp2): 18 exact " \
        "fields, 9 bounds" in proc.stdout
    assert "fired={'update_ratio': 1, 'loss_spike': 1, 'grad_spike': 1}" \
        in proc.stdout


def test_gate_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the gate would run on it")
    proc = subprocess.run(
        [sys.executable, TOOL, "--check",
         os.path.join("tools", "train_health.json")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "gate OK" not in proc.stdout
