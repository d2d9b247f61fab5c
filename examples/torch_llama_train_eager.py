"""The flagship Llama through the eager training loop of the PyTorch port:
``loss.backward()``, ``optimizer.AdamW`` with ``nn.ClipGradByGlobalNorm``
(kernel D's eager form on the card), ``step``, ``clear_grad``.

Run on the card (the flagship: B=8, S=2048, L=24; matrices in bf16 with
f32 masters, as the pretrain step's AMP-O2, through
``amp.decorate(model, opt, level="O2", dtype="bfloat16")``):
  python examples/torch_llama_train_eager.py
With ``--amp O1`` the parameters stay f32 and every forward runs under
``amp.auto_cast(level="O1", dtype="bfloat16")`` (the white list in bf16,
norms and the loss in f32):
  python examples/torch_llama_train_eager.py --amp O1
Data parallel over N processes (``fleet.distributed_model`` ->
``DataParallel``, ``fleet.distributed_optimizer``), or ZeRO over N:
  python examples/torch_llama_train_eager.py --dp 2 --layers 2
  python examples/torch_llama_train_eager.py --sharding p_g_os --dp 2
On the CPU (``pretrain.flagship_config``'s CPU form, f32):
  python examples/torch_llama_train_eager.py --device cpu --dp 2

With ``--dp N`` above 1 the script starts one process a rank (this
script with ``--rank``) over a ``FileStore`` in a temporary directory and
a gloo world group; each rank builds the model from the same seed and
takes its rows of each global batch. ``--sharding`` makes the N ranks a
sharding group (``group_sharded_parallel`` at that level) instead of a
data-parallel one. Rank 0 prints the loss (its own rows'), the grad
norm kernel D computed and the step's wall time.
"""
import argparse
import contextlib
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def train(args, rank=0, world=1, group=None):
    import numpy as np
    import torch

    from paddle_tpu_torch import amp, nn, optimizer
    from paddle_tpu_torch.distributed import fleet, sharding
    from paddle_tpu_torch.models import LlamaForCausalLM, pretrain

    device = args.device
    if device == "cuda":
        device = f"cuda:{rank % max(1, torch.cuda.device_count())}"
    cfg, batch, seq = pretrain.flagship_config(on_tpu=args.device == "cuda")
    if args.layers:
        cfg.num_hidden_layers = args.layers
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    ndims = {n: p.dim() for n, p in model.named_parameters()}
    opt = optimizer.AdamW(
        learning_rate=3e-4, beta1=0.9, beta2=0.95, epsilon=1e-8,
        weight_decay=0.1, parameters=model.named_parameters(),
        apply_decay_param_fun=lambda n: ndims[n] >= 2,
        grad_clip=nn.ClipGradByGlobalNorm(1.0))
    low = cfg.dtype == "bfloat16"
    if low:
        # O2: the matrices in bf16 (the RMSNorm weights, the only 1-D
        # parameters, stay f32) with f32 masters; O1 casts nothing
        model, opt = amp.decorate(model, opt, level=args.amp,
                                  dtype="bfloat16")
    def cast():
        return amp.auto_cast(level="O1", dtype="bfloat16") \
            if low and args.amp == "O1" else contextlib.nullcontext()
    net = model
    if world > 1:
        s = fleet.DistributedStrategy()
        key = "sharding_degree" if args.sharding else "dp_degree"
        s.hybrid_configs.update({key: world})
        fleet.init(is_collective=True, strategy=s, group=group,
                   device=device)
        if args.sharding:
            net, opt, _ = sharding.group_sharded_parallel(model, opt,
                                                          args.sharding)
        else:
            net = fleet.distributed_model(model)
            opt = fleet.distributed_optimizer(opt)
    if batch % world:
        raise SystemExit(f"the batch of {batch} does not split over "
                         f"{world} ranks")
    rows = slice(rank * batch // world, (rank + 1) * batch // world)
    rng = np.random.default_rng(0)
    for i in range(args.steps):
        host = {k: rng.integers(0, cfg.vocab_size, (batch, seq))
                for k in ("input_ids", "labels")}
        ids = torch.tensor(host["input_ids"][rows], device=device)
        labels = torch.tensor(host["labels"][rows], device=device)
        t0 = time.perf_counter()
        with cast():
            _, loss = net(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        loss = float(loss)
        wall = time.perf_counter() - t0
        if rank == 0:
            print(f"step {i}: loss {loss:.4f} gnorm "
                  f"{float(opt._last_grad_norm):.4f} {wall * 1e3:.1f} ms",
                  flush=True)
    return 0


def rank_main(args):
    from paddle_tpu_torch.distributed import collective
    group = collective.new_group(args.rank, args.dp, args.store,
                                 timeout=args.timeout)
    return train(args, args.rank, args.dp, group)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dp", type=int, default=1,
                    help="ranks (processes): data parallel, or the "
                    "sharding group with --sharding")
    ap.add_argument("--sharding", default=None,
                    choices=["os", "os_g", "p_g_os"])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: the config's)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--amp", default="O2", choices=["O1", "O2"],
                    help="O2 (default): bf16 matrices with f32 masters; "
                    "O1: f32 parameters, forwards under auto_cast O1")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="bound of every collective, seconds")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        return rank_main(args)
    if args.dp == 1:
        return train(args)
    tmp = tempfile.mkdtemp(prefix="torch_llama_train_eager_")
    store = os.path.join(tmp, "store")
    base = [sys.executable, os.path.abspath(__file__)] + sys.argv[1:]
    procs = [subprocess.Popen(base + ["--rank", str(r), "--store", store])
             for r in range(args.dp)]
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
