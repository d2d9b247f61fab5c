"""Norm layers of the PyTorch port (counterpart of
``paddle_tpu/nn/layers/norm.py``): RMSNorm, LayerNorm, GroupNorm, the
batch norms (``BatchNorm`` / ``1D`` / ``2D`` / ``3D``, ``SyncBatchNorm``),
the instance norms, ``LocalResponseNorm`` and ``SpectralNorm``. A scale
is ``Constant(1)`` and a shift zero by default, as the JAX layers'
(``weight_attr`` / ``bias_attr``: a ``ParamAttr``, or False to leave it
out)."""
import numpy as np
import torch

from ...core.device import DEFAULT_DEVICE, resolve_device
from .. import functional as F
from .. import initializer as I
from ..functional.norm import _channel_axis
from ..layer import create_parameter


class RMSNorm(torch.nn.Module):
    """RMSNorm with a float32 scale initialised to 1.0, built on ``device``
    (default "cuda", which raises without a GPU)."""

    def __init__(self, hidden_size, epsilon=1e-6, device=DEFAULT_DEVICE):
        super().__init__()
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = torch.nn.Parameter(
            torch.ones(hidden_size, dtype=torch.float32,
                       device=resolve_device(device)))

    def forward(self, x, residual=None):
        """RMSNorm of x, or with ``residual`` of h = x + residual (rounded
        to x's dtype): then (out, h), the add handed to the norm's kernel
        (the JAX layer's ``residual + hidden_states`` before the next
        norm). The scale is cast to the activation's dtype either way.
        Through ``F.rms_norm``, the amp hook's named entry."""
        return F.rms_norm(x, self.weight, self.epsilon, residual=residual)


class LayerNorm(torch.nn.Module):
    """``F.layer_norm`` over the trailing ``normalized_shape`` dims."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        kw = dict(generator=generator, device=device)
        self.weight = None if weight_attr is False else create_parameter(
            self.normalized_shape, weight_attr,
            default_initializer=I.Constant(1.0), **kw)
        self.bias = None if bias_attr is False else create_parameter(
            self.normalized_shape, bias_attr, is_bias=True, **kw)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class GroupNorm(torch.nn.Module):
    """``F.group_norm`` over ``num_groups`` groups of ``num_channels``;
    ``weight_attr=False`` leaves out both the scale and the shift, as the
    JAX layer does."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.epsilon = epsilon
        self.data_format = data_format
        kw = dict(generator=generator, device=device)
        if weight_attr is False:
            self.weight = self.bias = None
        else:
            self.weight = create_parameter(
                (num_channels,), weight_attr,
                default_initializer=I.Constant(1.0), **kw)
            self.bias = create_parameter((num_channels,), bias_attr,
                                         is_bias=True, **kw)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.epsilon, self.data_format)

    def extra_repr(self):
        return f"num_groups={self.num_groups}, num_channels={self.num_channels}"


class _BatchNormBase(torch.nn.Module):
    """Batch norm over the channel axis of ``data_format`` (``F.batch_norm``):
    a scale of ``Constant(1)`` and a zero shift (``weight_attr=False``
    leaves out both), and the running statistics as the buffers ``_mean``
    (zeros) and ``_variance`` (ones), the JAX layer's state_dict names."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, generator=None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        dev = resolve_device(device)
        kw = dict(generator=generator, device=dev)
        if weight_attr is False:
            self.weight = self.bias = None
        else:
            self.weight = create_parameter(
                (num_features,), weight_attr,
                default_initializer=I.Constant(1.0), **kw)
            self.bias = create_parameter((num_features,), bias_attr,
                                         is_bias=True, **kw)
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=dev))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=dev))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self.momentum,
            epsilon=self.epsilon, data_format=self.data_format,
            use_global_stats=self.use_global_stats)

    def extra_repr(self):
        return f"num_features={self.num_features}, momentum={self.momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over ``group``'s ranks; its gradient is the sum of
    the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        from ...distributed import collective
        ctx.group = group
        return collective.all_reduce(x.clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        from ...distributed import collective
        return collective.all_reduce(g.contiguous().clone(),
                                     group=ctx.group), None


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose training statistics cover the batch of every rank
    of ``group`` (default: the group of the ``DataParallel`` that wraps
    it, else fleet's data-parallel group, else the parallel environment's;
    ``distributed.parallel``). Each rank holds its own rows:
    the per-channel sum, sum of squares and count are all_reduced over the
    group (one f32 all_reduce of 2C + 1 values, differentiable), and the
    mean and biased variance of the whole batch normalise each rank's rows
    and update the running statistics, as Paddle's reference computes
    them. The JAX layer is plain batch norm over the global batch of its
    single controller, where XLA does the reduction; with no group, or a
    group of one rank, this is ``F.batch_norm``."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, group=None, generator=None,
                 device=DEFAULT_DEVICE):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, None, name, generator,
                         device)
        self.group = group

    def adopt_data_group(self, group):
        """The wrapping ``DataParallel``'s group, unless one was given."""
        if self.group is None:
            self.group = group

    def _group(self):
        if self.group is not None:
            return self.group
        from ...distributed.parallel import _data_group
        return _data_group()

    def forward(self, x):
        group = self._group() if self.training else None
        if group is None or group.size() == 1:
            return super().forward(x)
        ch = _channel_axis(x, self.data_format)
        xc = x.movedim(ch, 1).to(torch.float32)
        c = xc.shape[1]
        axes = [i for i in range(xc.dim()) if i != 1]
        count = torch.full((1,), xc.numel() // c, dtype=torch.float32,
                           device=x.device)
        stats = _AllReduceSum.apply(
            torch.cat([xc.sum(axes), (xc * xc).sum(axes), count]), group)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = torch.clamp_min(stats[c:2 * c] / n - mean * mean, 0.0)
        shape = [1, c] + [1] * (xc.dim() - 2)
        out = (xc - mean.reshape(shape)) \
            * torch.rsqrt(var.reshape(shape) + self.epsilon)
        if self.weight is not None:
            out = out * self.weight.reshape(shape) \
                + self.bias.reshape(shape)
        with torch.no_grad():
            m = self.momentum
            self._mean.mul_(m).add_(mean.detach(), alpha=1 - m)
            self._variance.mul_(m).add_(var.detach(), alpha=1 - m)
        return out.movedim(1, ch).to(x.dtype)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm inside (and itself) replaced by
        a ``SyncBatchNorm`` holding its parameters and statistics."""
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        if isinstance(layer, _BatchNormBase) \
                and not isinstance(layer, SyncBatchNorm):
            new = cls(layer.num_features, layer.momentum, layer.epsilon,
                      weight_attr=False if layer.weight is None else None,
                      data_format=layer.data_format,
                      device=layer._mean.device)
            new.load_state_dict(layer.state_dict())
            new.train(layer.training)
            return new
        return layer


class InstanceNorm1D(torch.nn.Module):
    """``F.instance_norm`` with a ``Constant(1)`` scale and a zero shift
    (``weight_attr=False`` leaves out both); ``momentum`` is taken and not
    read, as in the JAX layer."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.num_features = num_features
        self.epsilon = epsilon
        self.data_format = data_format
        kw = dict(generator=generator, device=device)
        if weight_attr is False:
            self.weight = self.bias = None
        else:
            self.weight = create_parameter(
                (num_features,), weight_attr,
                default_initializer=I.Constant(1.0), **kw)
            self.bias = create_parameter((num_features,), bias_attr,
                                         is_bias=True, **kw)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self.epsilon,
                               data_format=self.data_format)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, name, generator, device)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, name, generator, device)


class LocalResponseNorm(torch.nn.Module):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(torch.nn.Module):
    """``weight / sigma(weight)``, sigma from ``power_iters`` steps of the
    power iteration on the weight as a [shape[dim], -1] matrix, from the
    estimates ``weight_u`` / ``weight_v``: parameters without a gradient
    (as the JAX layer's), drawn from numpy's generators 0 and 1 as there.
    The gradient flows through the iteration, as in the JAX op; in
    training the new estimates are written back."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 dtype="float32", device=DEFAULT_DEVICE):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = epsilon
        h = int(weight_shape[dim])
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= int(s)
        dev = resolve_device(device)
        u = np.random.default_rng(0).standard_normal(h).astype(np.float32)
        v = np.random.default_rng(1).standard_normal(w).astype(np.float32)
        self.weight_u = torch.nn.Parameter(torch.from_numpy(u).to(dev),
                                           requires_grad=False)
        self.weight_v = torch.nn.Parameter(torch.from_numpy(v).to(dev),
                                           requires_grad=False)

    def forward(self, weight):
        m = weight.movedim(self._dim, 0).reshape(weight.shape[self._dim], -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self._power_iters):
            v = m.T @ u
            v = v / (torch.linalg.vector_norm(v) + self._eps)
            u = m @ v
            u = u / (torch.linalg.vector_norm(u) + self._eps)
        sigma = u @ (m @ v)
        if self.training:
            with torch.no_grad():
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        return weight / sigma
