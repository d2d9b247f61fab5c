"""``tools/torch_fleet_obs.py`` on the CPU: the port's fleet-observability
gate, two rank processes under one fleet directory (a serving loop on
the port's engine, a dp = 2 pretrain over gloo between them, one rank
delayed in the fault leg), holds every exact field and bound of the JAX
gate's committed baseline (``tools/fleet_obs.json``). Also: ranks that
export at the same moment keep each other's manifest entries."""
import os
import subprocess
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.observability import fleet_obs  # noqa: E402
from paddle_tpu_torch.observability.metrics import (  # noqa: E402
    MetricsRegistry)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "torch_fleet_obs.py")


def test_gate_holds_the_committed_jax_baseline():
    proc = subprocess.run(
        [sys.executable, TOOL, "--check",
         os.path.join("tools", "fleet_obs.json")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "fleet_obs gate OK: 19 exact fields, 9 bounds" in proc.stdout
    assert "on ranks [1] checks ['dispatch']" in proc.stdout


def test_concurrent_exports_keep_every_ranks_manifest_entry(tmp_path):
    """Eight ranks export 40 times each, all at once: the manifest ends
    with every rank's last seq (the read-merge-write is locked)."""
    world, rounds = 8, 40
    go = threading.Barrier(world)

    def rank(r):
        reg = MetricsRegistry()
        reg.counter("c_total").inc(r + 1)
        exp = fleet_obs.RankExporter(str(tmp_path), r, world, run_id="t",
                                     registry=reg, interval_s=0.0)
        go.wait()
        for _ in range(rounds):
            exp.export()
    threads = [threading.Thread(target=rank, args=(r,))
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    man = fleet_obs.load_fleet_manifest(str(tmp_path))
    assert {r: e["seq"] for r, e in man["ranks"].items()} == \
        {str(r): rounds for r in range(world)}
