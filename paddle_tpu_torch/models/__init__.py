"""Model zoo: the five BASELINE.md configs and the rest of the zoo.

Counterpart of paddle_tpu/models/__init__.py, with its exports: the
submodules `lenet`, `resnet`, `bert`, `transformer`, `deepfm`, `yolov3`
and `vision_zoo` (and the port's `bert_pretrain` and `crnn_ctc`). Each
model is an eager nn.Layer with a `build_static` helper emitting the
equivalent static Program. A submodule is imported on first access (a
module `__getattr__`), so importing the package stays light.
"""
import importlib

_SUBMODULES = ("lenet", "resnet", "bert", "transformer", "deepfm",
               "yolov3", "vision_zoo", "bert_pretrain", "crnn_ctc")

__all__ = list(_SUBMODULES)


def __getattr__(name):
    if name not in _SUBMODULES:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return importlib.import_module(f"{__name__}.{name}")


def __dir__():
    return sorted(set(globals()) | set(_SUBMODULES))
