"""Device resolution for the PyTorch port (counterpart of
``paddle_tpu/core/device.py``).

Every entry point of the port takes ``device=`` and defaults to
``"cuda"``. Asking for CUDA on a machine without a usable GPU raises:
the port never falls back to the CPU on its own. The CPU runs only when a
caller names it, which the tests do to hold the port against the JAX
package."""
import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE):
    """``device`` (str or torch.device) -> torch.device, checked.

    Raises RuntimeError for a CUDA device when CUDA is not available, and
    ValueError for a device type the port does not run on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not "
                "available; pass device='cpu' to run the plain PyTorch "
                "path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r} "
                         "(have 'cuda' and 'cpu')")
    return dev
