"""Built-in datasets: mnist, cifar, uci_housing, imdb, imikolov, wmt16
and ctr, and (from io/dataset_ext.py) movielens, conll05, flowers and
voc2012.

Counterpart of paddle_tpu/io/dataset.py (the reference's
paddle.dataset.*). When `set_data_dir` (or PT_DATA_DIR) names a
directory that holds a dataset in its canonical on-disk format, its
readers parse the real files; otherwise a deterministic synthetic
generator serves, with the same seeds and numpy draws as the JAX
package, so the samples are bit for bit the JAX package's for the same
`n` and split.
"""
import os

import numpy as np

__all__ = ["mnist", "cifar", "uci_housing", "imdb", "imikolov", "wmt16",
           "ctr", "movielens", "conll05", "flowers", "voc2012",
           "set_data_dir", "download", "md5file", "DATA_HOME"]

_data_dir = os.environ.get("PT_DATA_DIR")


def set_data_dir(path):
    global _data_dir
    _data_dir = path


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


# ---------------------------------------------------------------------
# Real-format parsers. Each train()/test() above consults these first:
# when `set_data_dir` (or PT_DATA_DIR) points at a directory holding the
# dataset in its canonical on-disk format, samples come from the real
# files with the exact same generator contract; otherwise the synthetic
# generator is used. Formats match what the reference's downloaders
# fetch (python/paddle/dataset/mnist.py IDX ubyte, cifar.py python
# pickles, uci_housing.py whitespace table, imdb.py aclImdb tree,
# plus Criteo TSV for the CTR config).
def _real_path(*names):
    if not _data_dir:
        return None
    for name in names:
        p = os.path.join(_data_dir, name)
        if os.path.exists(p):
            return p
    return None


def _open_maybe_gz(path):
    if path.endswith(".gz"):
        import gzip
        return gzip.open(path, "rb")
    return open(path, "rb")


def _parse_idx(images_path, labels_path):
    """MNIST IDX ubyte format (magic 2051 images / 2049 labels)."""
    import struct
    with _open_maybe_gz(images_path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad IDX image magic {magic}")
        images = np.frombuffer(f.read(n * rows * cols), np.uint8)
        images = images.reshape(n, 1, rows, cols)
    with _open_maybe_gz(labels_path) as f:
        magic, n2 = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad IDX label magic {magic}")
        labels = np.frombuffer(f.read(n2), np.uint8)
    if n != n2:
        raise ValueError("IDX image/label count mismatch")
    return images, labels


def _mnist_real(split, n):
    prefix = "train" if split == "train" else "t10k"
    ip = _real_path(f"{prefix}-images-idx3-ubyte",
                    f"{prefix}-images-idx3-ubyte.gz")
    lp = _real_path(f"{prefix}-labels-idx1-ubyte",
                    f"{prefix}-labels-idx1-ubyte.gz")
    if not (ip and lp):
        return None
    images, labels = _cached(("mnist", split),
                             lambda: _parse_idx(ip, lp))
    n = min(n or len(images), len(images))

    def gen():
        for i in range(n):
            # reference normalization (dataset/mnist.py): [0,255]→[-1,1]
            x = images[i].astype(np.float32) / 127.5 - 1.0
            yield x, np.int64(labels[i])
    return gen


def _cifar_real(split, n, num_classes):
    import pickle
    if num_classes == 10:
        sub = "cifar-10-batches-py"
        files = ([f"data_batch_{i}" for i in range(1, 6)]
                 if split == "train" else ["test_batch"])
        label_key = b"labels"
    else:
        sub = "cifar-100-python"
        files = ["train"] if split == "train" else ["test"]
        label_key = b"fine_labels"
    if not _data_dir or not os.path.isdir(os.path.join(_data_dir, sub)):
        return None
    def load():
        xs, ys = [], []
        for fname in files:
            p = os.path.join(_data_dir, sub, fname)
            if not os.path.exists(p):
                return None
            with open(p, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(np.asarray(d[b"data"], np.uint8))
            ys.extend(d[label_key])
        return (np.concatenate(xs).reshape(-1, 3, 32, 32),
                np.asarray(ys, np.int64))

    loaded = _cached(("cifar", num_classes, split), load)
    if loaded is None:
        return None
    data, labels = loaded
    n = min(n or len(data), len(data))

    def gen():
        for i in range(n):
            yield (data[i].astype(np.float32) / 255.0, np.int64(labels[i]))
    return gen


def _uci_housing_real(split, n):
    p = _real_path("housing.data")
    if not p:
        return None
    table = _cached(("housing",), lambda: np.loadtxt(p).astype(np.float32))
    # reference split (dataset/uci_housing.py feature_range): 80/20,
    # features scaled (x - avg) / (max - min) over the whole table
    feat, target = table[:, :-1], table[:, -1:]
    lo, hi, avg = feat.min(0), feat.max(0), feat.mean(0)
    feat = (feat - avg) / np.maximum(hi - lo, 1e-6)
    cut = int(len(table) * 0.8)
    sl = slice(0, cut) if split == "train" else slice(cut, None)
    feat, target = feat[sl], target[sl]
    n = min(n or len(feat), len(feat))

    def gen():
        for i in range(n):
            yield feat[i], target[i]
    return gen


_parsed_cache = {}


def _cached(key, loader):
    """Parse-once cache keyed on (data_dir, dataset, split) — real files
    are immutable for a session; switching set_data_dir changes the key."""
    full = (_data_dir,) + key
    if full not in _parsed_cache:
        _parsed_cache[full] = loader()
    return _parsed_cache[full]


_imdb_vocab_cache = _parsed_cache  # legacy alias (tests clear it)


def _imdb_tokenize(text):
    import re
    return re.findall(r"[a-z0-9']+", text.lower())


def _imdb_real(split, n):
    root = _real_path("aclImdb")
    if not root:
        return None
    vkey = (_data_dir, "imdb", "vocab")
    if vkey not in _parsed_cache:
        # vocab from train split, most-frequent first (dataset/imdb.py
        # build_dict), capped at imdb.VOCAB with id VOCAB-1 as <unk>
        from collections import Counter
        cnt = Counter()
        for lab in ("pos", "neg"):
            d = os.path.join(root, "train", lab)
            for fname in sorted(os.listdir(d)):
                with open(os.path.join(d, fname), errors="ignore") as f:
                    cnt.update(_imdb_tokenize(f.read()))
        words = [w for w, _ in cnt.most_common(imdb.VOCAB - 1)]
        _parsed_cache[vkey] = {w: i for i, w in enumerate(words)}
    vocab = _parsed_cache[vkey]
    unk = imdb.VOCAB - 1
    samples = []
    for y, lab in ((1, "pos"), (0, "neg")):
        d = os.path.join(root, split, lab)
        if not os.path.isdir(d):
            return None
        for fname in sorted(os.listdir(d)):
            samples.append((os.path.join(d, fname), y))
    n = min(n or len(samples), len(samples))

    def gen():
        for path, y in samples[:n]:
            with open(path, errors="ignore") as f:
                toks = np.asarray([vocab.get(w, unk)
                                   for w in _imdb_tokenize(f.read())],
                                  np.int64)
            if len(toks):
                yield toks, np.int64(y)
    return gen


def _ctr_real(split, n):
    """Criteo display-advertising TSV: label \\t 13 integer features \\t
    26 hashed categorical features (empty fields allowed)."""
    p = _real_path("train.txt" if split == "train" else "test.txt")
    if not p:
        return None

    def gen():
        count = 0
        nfield = ctr.DENSE_DIM + ctr.SLOTS
        with open(p) as f:
            for line in f:
                if n and count >= n:
                    break
                parts = line.rstrip("\n").split("\t")
                if len(parts) == 1 + nfield:       # labeled
                    y = np.int64(int(parts[0]))
                    parts = parts[1:]
                elif len(parts) == nfield:         # canonical unlabeled test
                    y = np.int64(-1)
                else:
                    continue
                dense = np.asarray(
                    [float(v) if v else 0.0
                     for v in parts[:ctr.DENSE_DIM]], np.float32)
                # log-transform per the Criteo winning-solution recipe
                dense = np.log1p(np.maximum(dense, 0.0))
                sparse = np.asarray(
                    [(int(v, 16) if v else 0) % ctr.VOCAB_PER_SLOT
                     for v in parts[ctr.DENSE_DIM:]], np.int64)
                count += 1
                yield dense, sparse, y
    return gen


def _with_real(synthetic_gen, real_gen):
    return real_gen if real_gen is not None else synthetic_gen


# hook the real parsers into the public readers
_mnist_train_syn, _mnist_test_syn = mnist.train, mnist.test
mnist.train = staticmethod(
    lambda n=8192: _with_real(_mnist_train_syn(n), _mnist_real("train", n)))
mnist.test = staticmethod(
    lambda n=1024: _with_real(_mnist_test_syn(n), _mnist_real("test", n)))

_cifar_tr10, _cifar_te10 = cifar.train10, cifar.test10
_cifar_tr100, _cifar_te100 = cifar.train100, cifar.test100
cifar.train10 = staticmethod(lambda n=8192: _with_real(
    _cifar_tr10(n), _cifar_real("train", n, 10)))
cifar.test10 = staticmethod(lambda n=1024: _with_real(
    _cifar_te10(n), _cifar_real("test", n, 10)))
cifar.train100 = staticmethod(lambda n=8192: _with_real(
    _cifar_tr100(n), _cifar_real("train", n, 100)))
cifar.test100 = staticmethod(lambda n=1024: _with_real(
    _cifar_te100(n), _cifar_real("test", n, 100)))

_uci_tr, _uci_te = uci_housing.train, uci_housing.test
uci_housing.train = staticmethod(lambda n=404: _with_real(
    _uci_tr(n), _uci_housing_real("train", n)))
uci_housing.test = staticmethod(lambda n=102: _with_real(
    _uci_te(n), _uci_housing_real("test", n)))

_imdb_tr, _imdb_te = imdb.train, imdb.test
imdb.train = staticmethod(lambda n=4096: _with_real(
    _imdb_tr(n), _imdb_real("train", n)))
imdb.test = staticmethod(lambda n=512: _with_real(
    _imdb_te(n), _imdb_real("test", n)))

_ctr_tr, _ctr_te = ctr.train, ctr.test
ctr.train = staticmethod(lambda n=8192: _with_real(
    _ctr_tr(n), _ctr_real("train", n)))
ctr.test = staticmethod(lambda n=1024: _with_real(
    _ctr_te(n), _ctr_real("test", n)))


# round-out datasets + fetch layer (io/dataset_ext.py): movielens,
# conll05 SRL, flowers-102, voc2012 segmentation, md5-cached download
from paddle_tpu_torch.io.dataset_ext import (  # noqa: E402,F401
    DATA_HOME, conll05, download, flowers, md5file, movielens, voc2012)
