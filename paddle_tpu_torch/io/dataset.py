"""Built-in datasets: mnist and uci_housing.

Counterpart of paddle_tpu/io/dataset.py's offline synthetic generators
(the reference's paddle.dataset.* downloads files; this machine reads
none): the same seeds and the same numpy draws give the same samples as
the JAX package for the same `n` and split. Readers of real data files
and the other datasets come with the book tests that need them (ROADMAP
Queue 1 item 16).
"""
import numpy as np

__all__ = ["mnist", "uci_housing"]


def _rng(seed):
    return np.random.RandomState(seed)


class mnist:
    """28x28 grayscale digits, labels 0-9: class-conditional gaussian
    blobs around fixed prototypes."""

    IMAGE_SHAPE = (1, 28, 28)
    NUM_CLASSES = 10

    @staticmethod
    def _make(n, seed):
        protos = _rng(42).randn(10, 1, 28, 28).astype(np.float32)
        r = _rng(seed)

        def gen():
            for _ in range(n):
                y = int(r.randint(0, 10))
                x = protos[y] + 0.35 * r.randn(1, 28, 28).astype(np.float32)
                yield x.astype(np.float32), np.int64(y)
        return gen

    @staticmethod
    def train(n=8192):
        return mnist._make(n, seed=0)

    @staticmethod
    def test(n=1024):
        return mnist._make(n, seed=1)


class uci_housing:
    """13 features -> 1 target: y = w.x + b + noise, w and b fixed."""

    @staticmethod
    def _make(n, seed):
        r = _rng(42)
        w = r.randn(13).astype(np.float32)
        b = np.float32(0.5)
        r2 = _rng(seed)

        def gen():
            for _ in range(n):
                x = r2.randn(13).astype(np.float32)
                y = np.float32(x @ w + b + 0.01 * r2.randn())
                yield x, np.array([y], np.float32)
        return gen

    @staticmethod
    def train(n=404):
        return uci_housing._make(n, 0)

    @staticmethod
    def test(n=102):
        return uci_housing._make(n, 1)
