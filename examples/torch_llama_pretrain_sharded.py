"""Sharded Llama pretraining over a dp x fsdp x sp x mp mesh, the PyTorch
port (counterpart of ``examples/llama_pretrain_sharded.py``).

Run on the card (one process a rank, all on the visible cards in turn):
  python examples/torch_llama_pretrain_sharded.py --dp 2 --fsdp 2 --mp 2
Run on the CPU:
  python examples/torch_llama_pretrain_sharded.py --dp 2 --fsdp 2 --mp 2 \\
      --device cpu
Context parallelism (each rank a block of the sequence, ring or Ulysses):
  python examples/torch_llama_pretrain_sharded.py --dp 2 --sp 2 \\
      --cp-mode ulysses --device cpu
Pipeline parallelism (each rank a stage of ``LlamaForCausalLMPipe``,
through ``fleet.distributed_model``; 1F1B, FThenB, VPP or ZBH1):
  python examples/torch_llama_pretrain_sharded.py --pp 2 --dp 2 --mp 2 \\
      --schedule ZBH1 --device cpu

The script starts one process a rank (this script with ``--rank``) over a
``FileStore`` in a temporary directory and a gloo world group; each rank
builds the model from the same seed, keeps its shards of the masters and
moments (ZeRO-3 over fsdp, Megatron over mp, the batch over dp x fsdp),
and prints the global loss and grad norm; rank 0's lines are shown. With
``--sp`` each rank holds a contiguous block of its rows' sequence and the
attention runs over the sp axis (``--cp-mode``). With ``--pp`` each rank
holds one stage (with ``--schedule VPP`` two chunks) and trains it with
``train_batch`` on its rows, ``--micro`` micro-batches a step; fsdp and
sp do not combine with pp yet.
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

    world = args.pp * args.dp * args.fsdp * args.sp * args.mp
    device = args.device
    if device == "cuda":
        device = f"cuda:{args.rank % max(1, torch.cuda.device_count())}"
    group = collective.new_group(args.rank, world, args.store,
                                 timeout=args.timeout)
    cfg = LlamaConfig(
        vocab_size=2048, hidden_size=256, intermediate_size=688,
        num_hidden_layers=4, num_attention_heads=8, num_key_value_heads=4,
        max_position_embeddings=args.seq, dtype=args.dtype,
        context_parallel=args.sp > 1, context_parallel_mode=args.cp_mode)
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    if args.pp > 1:
        return pipe_main(args, cfg, model, group, device)
    mesh = pretrain.make_mesh(world, dp=args.dp, fsdp=args.fsdp, mp=args.mp,
                              sp=args.sp, group=group, device=device)
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


def pipe_main(args, cfg, whole, group, device):
    """The pipeline: this rank's stage of the seeded model, trained by
    ``PipelineParallel.train_batch`` on its rows of each batch."""
    import numpy as np

    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models.llama import (LlamaForCausalLMPipe,
                                               llama_pipe_state_from_numpy)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs.update(
        pp_degree=args.pp, dp_degree=args.dp, mp_degree=args.mp,
        sharding_degree=args.fsdp, sep_degree=args.sp,
        pp_configs={"accumulate_steps": args.micro,
                    "schedule_mode": args.schedule, "vpp_degree": 2})
    hcg = fleet.init(is_collective=True, strategy=strategy, group=group,
                     device=device)
    pipe = LlamaForCausalLMPipe(cfg, num_stages=args.pp)
    llama_pipe_state_from_numpy(dict(whole.named_parameters()), pipe)
    del whole
    model = fleet.distributed_model(pipe)
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=3e-4, parameters=pipe.parameters(),
        grad_clip=nn.ClipGradByGlobalNorm(1.0)))
    d = hcg.get_data_parallel_rank()
    rows = slice(d * args.batch // args.dp, (d + 1) * args.batch // args.dp)
    rng = np.random.default_rng(0)
    for i in range(args.steps):
        ids = rng.integers(0, cfg.vocab_size, (args.batch, args.seq))
        labels = rng.integers(0, cfg.vocab_size, (args.batch, args.seq))
        loss = model.train_batch((ids[rows], labels[rows]), opt)
        if args.rank == 0:
            print(f"step {i}: loss {float(loss):.4f} gnorm "
                  f"{float(opt._last_grad_norm):.3f}", flush=True)
    if args.rank == 0:
        print(f"rank 0, stage {hcg.get_stage_id()} of {args.pp} "
              f"({args.schedule}): {model.max_in_flight} micro-batches in "
              f"flight at most; collectives of the last step: "
              f"{ {k: v['calls'] for k, v in model.comm.items()} }",
              flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages (fleet.distributed_model)")
    ap.add_argument("--schedule", default="1F1B",
                    choices=["1F1B", "FThenB", "VPP", "ZBH1"])
    ap.add_argument("--micro", type=int, default=2,
                    help="micro-batches a step a rank (accumulate_steps)")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--mp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=1,
                    help="context-parallel degree (the sequence's blocks)")
    ap.add_argument("--cp-mode", default="ring", choices=["ring", "ulysses"])
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
    world = args.pp * args.dp * args.fsdp * args.sp * args.mp
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
