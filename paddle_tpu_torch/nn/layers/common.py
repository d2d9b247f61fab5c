"""Linear and Embedding layers of the PyTorch port (counterpart of
``paddle_tpu/nn/layers/common.py``), as ``torch.nn.Module``s.

Weights are drawn from Normal(0, std) with an explicit
``torch.Generator`` on the layer's device; the two frameworks give
different numbers for one seed, so parity tests load the JAX model's
weights instead (``models.llama.llama_state_from_numpy``)."""
import torch

from .. import functional as F


def normal_(shape, std, generator, device):
    """A float32 tensor of ``shape`` from Normal(0, std) on ``device``."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return w.normal_(0.0, std, generator=generator)


class Linear(torch.nn.Module):
    """Bias-free linear layer with paddle's [in_features, out_features]
    weight: ``x @ weight``."""

    def __init__(self, in_features, out_features, std, generator, device):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = torch.nn.Parameter(
            normal_((in_features, out_features), std, generator, device))

    def forward(self, x):
        return F.linear(x, self.weight)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(torch.nn.Module):
    """Lookup table [num_embeddings, embedding_dim]; an id outside
    [-num_embeddings, num_embeddings) reads a NaN row (``F.embedding``)."""

    def __init__(self, num_embeddings, embedding_dim, std, generator,
                 device):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = torch.nn.Parameter(
            normal_((num_embeddings, embedding_dim), std, generator, device))

    def forward(self, x):
        return F.embedding(x, self.weight)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"
