"""Sharded Llama pretraining over a dp x fsdp x mp mesh, the PyTorch port
(counterpart of ``examples/llama_pretrain_sharded.py``).

Run on the card (one process a rank, all on the visible cards in turn):
  python examples/torch_llama_pretrain_sharded.py --dp 2 --fsdp 2 --mp 2
Run on the CPU:
  python examples/torch_llama_pretrain_sharded.py --dp 2 --fsdp 2 --mp 2 \\
      --device cpu

The script starts one process a rank (this script with ``--rank``) over a
``FileStore`` in a temporary directory and a gloo world group; each rank
builds the model from the same seed, keeps its shards of the masters and
moments (ZeRO-3 over fsdp, Megatron over mp, the batch over dp x fsdp),
and prints the global loss and grad norm; rank 0's lines are shown. The
mesh's sp and pp axes are a later slice of the port.
"""
import argparse
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def rank_main(args):
    import numpy as np
    import torch

    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         pretrain)

    world = args.dp * args.fsdp * args.mp
    device = args.device
    if device == "cuda":
        device = f"cuda:{args.rank % max(1, torch.cuda.device_count())}"
    group = collective.new_group(args.rank, world, args.store,
                                 timeout=args.timeout)
    cfg = LlamaConfig(
        vocab_size=2048, hidden_size=256, intermediate_size=688,
        num_hidden_layers=4, num_attention_heads=8, num_key_value_heads=4,
        max_position_embeddings=args.seq, dtype=args.dtype)
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    mesh = pretrain.make_mesh(world, dp=args.dp, fsdp=args.fsdp, mp=args.mp,
                              group=group, device=device)
    params, opt_state, meta = pretrain.make_train_state(model, mesh)
    step = pretrain.make_train_step(model, mesh, meta)
    rng = np.random.default_rng(0)
    for i in range(args.steps):
        host = {"input_ids": rng.integers(0, cfg.vocab_size,
                                          (args.batch, args.seq)),
                "labels": rng.integers(0, cfg.vocab_size,
                                       (args.batch, args.seq))}
        params, opt_state, loss, gnorm = step(
            params, opt_state, pretrain.shard_batch(host, mesh))
        if args.rank == 0:
            print(f"step {i}: loss {float(loss):.4f} gnorm "
                  f"{float(gnorm):.3f}", flush=True)
    if args.rank == 0:
        held = sum(t.numel() * t.element_size() for t in params.values())
        print(f"rank 0 at {mesh.coords}: {held} bytes of masters (x3 with "
              f"the moments); collectives of the last step: "
              f"{ {k: v['calls'] for k, v in step.comm.items()} }",
              flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--mp", type=int, default=1)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="bound of every collective, seconds")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        return rank_main(args)
    world = args.dp * args.fsdp * args.mp
    tmp = tempfile.mkdtemp(prefix="torch_pretrain_sharded_")
    store = os.path.join(tmp, "store")
    base = [sys.executable, os.path.abspath(__file__)] + [
        a for a in sys.argv[1:]]
    procs = [subprocess.Popen(base + ["--rank", str(r), "--store", store])
             for r in range(world)]
    try:
        rcs = [p.wait(timeout=args.timeout * (args.steps + 4))
               for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    bad = [r for r, rc in enumerate(rcs) if rc != 0]
    if bad:
        print(f"ranks {bad} failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
