"""ParamAttr — per-parameter configuration.

Counterpart of paddle_tpu/utils/param_attr.py (the reference's
param_attr.py: name, initializer, learning_rate, regularizer, trainable,
gradient_clip), read by every static layer that creates parameters.
"""

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 sharding=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.sharding = sharding

    @staticmethod
    def to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if arg is False:
            return False  # "no parameter" marker (e.g. bias_attr=False)
        raise TypeError(f"cannot interpret {arg!r} as ParamAttr")
