"""Device places.

Counterpart of paddle_tpu/core/places.py. A Place names a device; the
port's entry points take `device=None`, which means the GPU: every
entry point resolves its argument through `resolve_device`, which
returns `torch.device("cuda")` for None and raises when no GPU is
visible. There is no silent fall back to the CPU, and no environment
variable or flag that picks the device: a caller that wants the CPU
passes `device="cpu"` (the tests do).
"""
import torch

__all__ = ["Place", "CPUPlace", "CUDAPlace", "resolve_device"]


class Place:
    _type = None

    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    @property
    def device(self):
        if self._type == "cpu":
            return torch.device("cpu")
        return torch.device(self._type, self.device_id)

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))


class CPUPlace(Place):
    _type = "cpu"


class CUDAPlace(Place):
    """The TPUPlace analogue: one GPU of this host."""
    _type = "cuda"


def resolve_device(device=None):
    """None → torch.device("cuda"); a Place, a string or a torch.device
    → that device. Raises RuntimeError when the result is a GPU and no
    GPU is visible."""
    if device is None:
        device = "cuda"
    if isinstance(device, Place):
        device = device.device
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested (the default) but torch sees no CUDA "
            f"device; pass device='cpu' to run on the CPU")
    return dev
