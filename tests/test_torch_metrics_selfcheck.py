"""The port's two observability gates, each in a subprocess of its own
with a time limit: ``tools/torch_metrics_snapshot.py --selfcheck`` (the
whole metrics core, stdlib-only, under a blocked torch import) and
``tools/torch_cost_report.py --device cpu --check tools/train_obs.json``
(the train_obs gate: every required program counted, the baseline's
exact fields and bounds held, its serve and pretrain legs, the serve
keys the port cannot meet skipped by name and no pretrain key skipped)."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK_TORCH = """
import builtins, runpy, sys
real = builtins.__import__
def guarded(name, *a, **k):
    if name.split(".")[0] in ("torch", "numpy", "jax"):
        raise ImportError("blocked: " + name)
    return real(name, *a, **k)
builtins.__import__ = guarded
sys.argv = ["torch_metrics_snapshot.py", "--selfcheck"]
runpy.run_path({path!r}, run_name="__main__")
"""


def _run(args, timeout):
    return subprocess.run([sys.executable] + args, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))


def test_metrics_selfcheck_stdlib_only():
    path = os.path.join(REPO, "tools", "torch_metrics_snapshot.py")
    r = _run(["-c", _BLOCK_TORCH.format(path=path)], timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "metrics selfcheck: OK" in r.stdout


def test_cost_report_serve_gate():
    r = _run(["tools/torch_cost_report.py", "--device", "cpu", "--check",
              "tools/train_obs.json"], timeout=240)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert "train_obs gate (port) OK" in r.stdout
    # the pretrain leg runs on the mesh: none of its keys is skipped
    assert "skipped pretrain." not in r.stdout
    assert "skipped require pretrain" not in r.stdout
