"""fluid.average module path (python/paddle/fluid/average.py).

Counterpart of paddle_tpu/average.py (numpy only, copied)."""
import numpy as np


class WeightedAverage:
    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = 0.0
        self.denominator = 0.0

    def add(self, value, weight):
        v = np.asarray(value, np.float64)
        self.numerator = self.numerator + v * float(weight)
        self.denominator += float(weight)

    def eval(self):
        if self.denominator == 0.0:
            raise ValueError(
                "can't eval WeightedAverage before adding values")
        out = self.numerator / self.denominator
        return float(out) if np.ndim(out) == 0 else out
