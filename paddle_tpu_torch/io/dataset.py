"""Built-in datasets: mnist, cifar, uci_housing, imdb, imikolov, wmt16
and ctr.

Counterpart of paddle_tpu/io/dataset.py's offline synthetic generators
(the reference's paddle.dataset.* downloads files; the port reads
none): the same seeds and the same numpy draws give the same samples as
the JAX package, bit for bit, for the same `n` and split. The readers
of real data files (`set_data_dir`) and the datasets of
io/dataset_ext.py are later work (ROADMAP Queue 1 item 16).
"""
import numpy as np

__all__ = ["mnist", "cifar", "uci_housing", "imdb", "imikolov", "wmt16",
           "ctr"]


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


class cifar:
    """3x32x32 images, 10 or 100 classes: class-conditional gaussian
    blobs around fixed prototypes."""

    IMAGE_SHAPE = (3, 32, 32)

    @staticmethod
    def _make(n, seed, num_classes):
        protos = _rng(42).randn(num_classes, 3, 32, 32).astype(np.float32)
        r = _rng(seed)

        def gen():
            for _ in range(n):
                y = int(r.randint(0, num_classes))
                x = protos[y] + 0.5 * r.randn(3, 32, 32).astype(np.float32)
                yield x.astype(np.float32), np.int64(y)
        return gen

    @staticmethod
    def train10(n=8192):
        return cifar._make(n, 0, 10)

    @staticmethod
    def test10(n=1024):
        return cifar._make(n, 1, 10)

    @staticmethod
    def train100(n=8192):
        return cifar._make(n, 0, 100)

    @staticmethod
    def test100(n=1024):
        return cifar._make(n, 1, 100)


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


class imdb:
    """Binary sentiment over token sequences of 10..199 tokens:
    class-biased token distributions."""

    VOCAB = 5000

    @staticmethod
    def _make(n, seed):
        r = _rng(seed)

        def gen():
            for _ in range(n):
                y = int(r.randint(0, 2))
                length = int(r.randint(10, 200))
                center = 1000 if y else 3000
                toks = np.clip(r.normal(center, 800, size=length), 0,
                               imdb.VOCAB - 1).astype(np.int64)
                yield toks, np.int64(y)
        return gen

    @staticmethod
    def train(n=4096):
        return imdb._make(n, 0)

    @staticmethod
    def test(n=512):
        return imdb._make(n, 1)


class imikolov:
    """N-gram language-model windows over a corpus with learnable bigram
    structure: each word follows its predecessor's fixed successor plus
    0..2."""

    VOCAB = 2048

    @staticmethod
    def _make(n, seed, window=5):
        r = _rng(seed)
        trans = r.randint(0, imikolov.VOCAB, size=imikolov.VOCAB)

        def gen():
            w = int(r.randint(0, imikolov.VOCAB))
            for _ in range(n):
                ctx = [w]
                for _ in range(window - 1):
                    w = int((trans[w] + r.randint(0, 3)) % imikolov.VOCAB)
                    ctx.append(w)
                yield tuple(np.int64(t) for t in ctx)
                w = int(r.randint(0, imikolov.VOCAB))
        return gen

    @staticmethod
    def train(n=8192, window=5):
        return imikolov._make(n, 0, window)

    @staticmethod
    def test(n=1024, window=5):
        return imikolov._make(n, 1, window)


class wmt16:
    """Translation pairs: the target is a fixed permutation of the source
    tokens, framed by BOS / EOS; samples are (src, trg[:-1], trg[1:])."""

    SRC_VOCAB = 1000
    TRG_VOCAB = 1000
    BOS, EOS = 0, 1

    @staticmethod
    def _make(n, seed):
        perm = _rng(99).permutation(wmt16.SRC_VOCAB)
        r2 = _rng(seed)

        def gen():
            for _ in range(n):
                length = int(r2.randint(4, 30))
                src = r2.randint(2, wmt16.SRC_VOCAB,
                                 size=length).astype(np.int64)
                trg = perm[src] % wmt16.TRG_VOCAB
                trg = np.concatenate([[wmt16.BOS], trg,
                                      [wmt16.EOS]]).astype(np.int64)
                yield src, trg[:-1], trg[1:]
        return gen

    @staticmethod
    def train(n=4096, src_dict_size=None, trg_dict_size=None):
        return wmt16._make(n, 0)

    @staticmethod
    def test(n=512, src_dict_size=None, trg_dict_size=None):
        return wmt16._make(n, 1)


class ctr:
    """Criteo-style CTR samples: 13 dense features, 26 sparse slots, a
    click label from a fixed logistic model."""

    DENSE_DIM = 13
    SLOTS = 26
    VOCAB_PER_SLOT = 10000

    @staticmethod
    def _make(n, seed):
        r = _rng(7)
        w_dense = r.randn(ctr.DENSE_DIM).astype(np.float32)
        w_slot = r.randn(ctr.SLOTS).astype(np.float32)
        r2 = _rng(seed)

        def gen():
            for _ in range(n):
                dense = r2.rand(ctr.DENSE_DIM).astype(np.float32)
                sparse = r2.randint(0, ctr.VOCAB_PER_SLOT,
                                    size=ctr.SLOTS).astype(np.int64)
                logit = dense @ w_dense + ((sparse % 7) / 7.0 - 0.5) @ w_slot
                y = np.int64(1 / (1 + np.exp(-logit)) > 0.5)
                yield dense, sparse, y
        return gen

    @staticmethod
    def train(n=8192):
        return ctr._make(n, 0)

    @staticmethod
    def test(n=1024):
        return ctr._make(n, 1)
