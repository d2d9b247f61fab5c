"""Model summary of the PyTorch port (counterpart of
``paddle_tpu/hapi/summary.py``; reference
python/paddle/hapi/model_summary.py): a forward hook on every leaf module
records its output shape and its own parameters' count."""
import torch

__all__ = ["summary"]


def _dtype(d):
    if d is None:
        return torch.float32
    if isinstance(d, (list, tuple)):
        d = d[0]
    return d if isinstance(d, torch.dtype) else getattr(torch, str(d))


def summary(net, input_size=None, dtypes=None, input=None):
    """Print a table of the leaf layers (name, type, output shape, their
    own parameters) from one forward on ``input`` (or zeros of
    ``input_size`` on the network's device), and return
    {"total_params", "trainable_params"}."""
    rows, hooks = [], []

    def make_hook(name):
        def hook(layer, inputs, outputs):
            n = sum(p.numel() for p in layer._parameters.values()
                    if p is not None)
            out = outputs[0] if isinstance(outputs, (list, tuple)) \
                else outputs
            shape = list(out.shape) if isinstance(out, torch.Tensor) else "-"
            rows.append((name, type(layer).__name__, shape, n))
        return hook

    for name, sub in net.named_modules():
        if name and not any(True for _ in sub.children()):
            hooks.append(sub.register_forward_hook(make_hook(name)))
    try:
        with torch.no_grad():
            if input is not None:
                net(input)
            elif input_size is not None:
                p = next(net.parameters(), None)
                dev = p.device if p is not None else torch.device("cpu")
                net(torch.zeros(list(input_size), dtype=_dtype(dtypes),
                                device=dev))
    finally:
        for h in hooks:
            h.remove()
    total = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
    if rows:
        w = max(len(r[0]) for r in rows) + 2
        print(f"{'Layer':<{w}}{'Type':<20}{'Output Shape':<20}{'Params':>10}")
        print("-" * (w + 50))
        for name, t, shape, n in rows:
            print(f"{name:<{w}}{t:<20}{str(shape):<20}{n:>10}")
        print("-" * (w + 50))
    print(f"Total params: {total}")
    print(f"Trainable params: {trainable}")
    return {"total_params": int(total), "trainable_params": int(trainable)}
