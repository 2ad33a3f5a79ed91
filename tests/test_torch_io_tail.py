"""The port's reader tail, DataLoader, io.fs, dataset_ext and the
real-file readers against the JAX package's, on the CPU.

* `chain` / `compose` / `firstn` give the JAX package's samples;
  `xmap_readers` its multiset (it ignores `order`, as the JAX package
  does); `DataLoader` its feed dicts through each of its three setters.
* movielens, flowers and voc2012 (and conll05) give the JAX package's
  synthetic samples bit for bit; on real files this test writes (IDX
  mnist, cifar pickles, the housing table, an aclImdb tree, Criteo TSV,
  ml-1m, CoNLL-2005 columns, a flowers102 tree, a VOC2012 tree) both
  packages' readers give the same samples.
* `md5file`; `download` from `file://` and `mem://` sources into a
  temporary DATA_HOME, a cache hit, an md5 mismatch that leaves neither
  the target nor a `.part`, and an http URL with no registered
  FileSystem, which raises naming the path to stage the file at (no
  connection is made).
* MemFS / LocalFS semantics, and `save_inference_model` ->
  `load_inference_model` over `mem://`, bit-equal to a local save.
* The native InMemoryDataset loads in file-list order whatever its
  thread count, so a seeded shuffle gives the same batches.
"""
import gzip
import hashlib
import os
import pickle
import struct
from collections import Counter

import numpy as np
import pytest

from paddle_tpu.io import dataset as jds
from paddle_tpu.io import dataset_ext as jext
from paddle_tpu.io import fs as jfs
from paddle_tpu.io import reader as jreader
from paddle_tpu_torch.io import dataset as tds
from paddle_tpu_torch.io import dataset_ext as text
from paddle_tpu_torch.io import fs as tfs
from paddle_tpu_torch.io import reader as treader


def _eq(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_eq(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        bool((a == b).all())


def _samples(n=10):
    def reader():
        r = np.random.RandomState(0)
        for i in range(n):
            yield (r.rand(3).astype(np.float32), np.int64(i))
    return reader


def test_reader_tail_matches_jax():
    r = _samples()
    for t, j in ((treader.chain(r, r), jreader.chain(r, r)),
                 (treader.compose(r, r), jreader.compose(r, r)),
                 (treader.firstn(r, 4), jreader.firstn(r, 4))):
        assert _eq(list(t()), list(j()))

    def mapper(s):
        return s[0] * 2.0, s[1] + 1

    def key(s):
        return (int(s[1]), s[0].tobytes())

    for order in (False, True):
        got = list(treader.xmap_readers(mapper, r, 3, 4, order=order)())
        want = list(jreader.xmap_readers(mapper, r, 3, 4, order=order)())
        assert Counter(map(key, got)) == Counter(map(key, want))
        assert len(got) == 10


class _Var:
    def __init__(self, name):
        self.name = name


def test_dataloader_feed_dicts_match_jax():
    feed = [_Var("x"), _Var("y")]
    r = _samples(9)

    def batches():
        for b in treader.batch(r, 4, drop_last=False)():
            yield [np.stack([s[0] for s in b]),
                   np.stack([s[1] for s in b])]

    for setter, args in (("set_sample_generator", (r, 4)),
                         ("set_sample_list_generator",
                          (treader.batch(r, 4),)),
                         ("set_batch_generator", (batches,))):
        got = list(getattr(treader.DataLoader.from_generator(
            feed_list=feed, capacity=2), setter)(*args))
        want = list(getattr(jreader.DataLoader.from_generator(
            feed_list=feed, capacity=2), setter)(*args))
        assert _eq(got, want) and len(got) >= 2, setter
        assert set(got[0]) == {"x", "y"}
    from paddle_tpu_torch import io as tio
    assert tio.DataLoader is treader.DataLoader
    assert tio.xmap_readers is treader.xmap_readers


@pytest.mark.parametrize("name,splits", [
    ("movielens", ("train", "test")), ("flowers", ("train", "valid", "test")),
    ("voc2012", ("train", "val")), ("conll05", ("test",))])
def test_synthetic_datasets_bit_equal(name, splits):
    for split in splits:
        got = list(getattr(getattr(text, name), split)(n=6)())
        want = list(getattr(getattr(jext, name), split)(n=6)())
        assert len(got) == 6 and _eq(got, want), (name, split)
    if name == "movielens":
        for m in ("max_user_id", "max_movie_id", "max_job_id"):
            assert getattr(text.movielens, m)() == \
                getattr(jext.movielens, m)()


def test_md5file_and_download(tmp_path, monkeypatch):
    blob = os.urandom(4096)
    src = tmp_path / "src.bin"
    src.write_bytes(blob)
    md5 = hashlib.md5(blob).hexdigest()
    assert text.md5file(str(src)) == jext.md5file(str(src)) == md5
    home = tmp_path / "home"
    monkeypatch.setattr(text, "DATA_HOME", str(home))
    got = text.download("file://" + str(src), "mod", md5)
    assert got == str(home / "mod" / "src.bin")
    assert open(got, "rb").read() == blob
    src.unlink()                                  # a cache hit now
    assert text.download("file:///nowhere/src.bin", "mod", md5,
                         save_name="src.bin") == got
    with tfs.get_fs("mem://")[0].open("mem://ds/data.bin", "wb") as f:
        f.write(blob[:100])
    got = text.download("mem://ds/data.bin", "mem",
                        hashlib.md5(blob[:100]).hexdigest())
    assert open(got, "rb").read() == blob[:100]
    with pytest.raises(RuntimeError, match="md5 mismatch"):
        text.download("mem://ds/data.bin", "bad", "0" * 32)
    assert os.listdir(home / "bad") == []          # no target, no .part
    with pytest.raises(RuntimeError, match=str(home / "web" / "f.tgz")):
        text.download("https://example.invalid/f.tgz", "web", md5)
    assert os.listdir(home / "web") == []


def test_memfs_and_localfs(tmp_path):
    m = tfs.MemFS()
    with m.open("mem://a/b/c.txt", "w") as f:
        f.write("hi")
    assert m.exists("mem://a/b/c.txt") and m.exists("mem://a")
    assert m.listdir("mem://a") == ["b"]
    with m.open("mem://a/b/c.txt", "r") as f:
        assert f.read() == "hi"
    m.rename("mem://a/b/c.txt", "mem://a/d.txt")
    assert m.listdir("mem://a") == ["d.txt"]
    m.delete("mem://a")
    assert not m.exists("mem://a")
    loc = tfs.LocalFS()
    d = str(tmp_path / "x" / "y")
    loc.mkdirs(d)
    with loc.open(tfs.join(d, "f"), "wb") as f:
        f.write(b"1")
    loc.rename(tfs.join(d, "f"), tfs.join(d, "g"))
    assert loc.listdir(d) == ["g"] and tfs.join("mem://a/", "/b") == \
        jfs.join("mem://a/", "/b") == "mem://a/b"
    fs, path = tfs.get_fs("file://" + d)
    assert isinstance(fs, tfs.LocalFS) and path == d
    assert tfs.get_fs("mem://q")[1] == "mem://q"
    with pytest.raises(Exception, match="no filesystem"):
        tfs.get_fs("nope://x")


def test_inference_model_over_memfs_equals_a_local_save(tmp_path):
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        x = static.data("x", [6])
        out = static.fc(static.fc(x, 5, act="relu"), 3)
    exe = Executor("cpu")
    feed = {"x": np.random.RandomState(0).randn(4, 6).astype(np.float32)}
    with scope_guard(Scope()):
        exe.run(startup)
        static.io.save_inference_model("mem://slim/m", ["x"], [out], exe,
                                       main_program=main)
        static.io.save_inference_model(str(tmp_path / "m"), ["x"], [out],
                                       exe, main_program=main)
        static.io.save_params(exe, "mem://slim/p", main_program=main)
    memfs = tfs.get_fs("mem://")[0]
    assert memfs.listdir("mem://slim/m") == ["__model__.json",
                                             "params.npz"]
    assert not any(k.endswith(".saving") for k in memfs._files)
    with open(tmp_path / "m" / "params.npz", "rb") as f:
        assert memfs._files["mem://slim/m/params.npz"] == f.read()
    outs = []
    for d in ("mem://slim/m", str(tmp_path / "m")):
        with scope_guard(Scope()):
            prog, feeds, fetches = static.io.load_inference_model(d, exe)
            outs.append(exe.run(prog, feed=feed, fetch_list=fetches)[0])
            assert feeds == ["x"]
    np.testing.assert_array_equal(outs[0], outs[1])


# -------------------------------------------------------------------------
# real-file readers, on files written here
# -------------------------------------------------------------------------

def _write_real_tree(root):
    r = np.random.RandomState(0)
    # mnist IDX (gz)
    imgs = r.randint(0, 256, (3, 28, 28)).astype(np.uint8)
    with gzip.open(root / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 3, 28, 28) + imgs.tobytes())
    with gzip.open(root / "train-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, 3) + bytes([1, 7, 3]))
    # cifar-10 python pickles
    c = root / "cifar-10-batches-py"
    c.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(c / name, "wb") as f:
            pickle.dump({b"data": r.randint(0, 256, (2, 3072)).astype(
                np.uint8), b"labels": [1, 2]}, f)
    # uci housing
    np.savetxt(root / "housing.data", r.rand(10, 14))
    # aclImdb
    for split in ("train", "test"):
        for lab in ("pos", "neg"):
            d = root / "aclImdb" / split / lab
            d.mkdir(parents=True)
            for i in range(2):
                (d / f"{i}.txt").write_text(f"a {lab} movie, {split} {i}!")
    # Criteo TSV
    rows = []
    for i in range(4):
        dense = "\t".join(str(i + k) for k in range(13))
        sparse = "\t".join(f"{(i * 31 + k):x}" for k in range(26))
        rows.append(f"{i % 2}\t{dense}\t{sparse}")
    (root / "train.txt").write_text("\n".join(rows) + "\n")
    # ml-1m
    ml = root / "ml-1m"
    ml.mkdir()
    (ml / "movies.dat").write_text(
        "1::Toy Story (1995)::Animation|Comedy\n2::Heat (1995)::Action\n",
        encoding="latin-1")
    (ml / "users.dat").write_text(
        "1::F::1::10::48067\n2::M::56::16::70072\n", encoding="latin-1")
    (ml / "ratings.dat").write_text(
        "".join(f"{1 + i % 2}::{1 + i % 2}::{1 + i % 5}::97830{i}\n"
                for i in range(30)), encoding="latin-1")
    # CoNLL-2005 columns
    cn = root / "conll05st"
    cn.mkdir()
    (cn / "test.wsj.words").write_text(
        "The\ncat\nsat\ndown\n\nDogs\nrun\n\n")
    (cn / "test.wsj.props").write_text(     # lemma column, then labels
        "-\t(A0*\n-\t*)\nsit\t(V*)\n-\t(AM-DIR*)\n\n"
        "-\t(A0*)\nrun\t(V*)\n\n")
    # flowers102 and VOC2012 (PIL / scipy write them)
    from PIL import Image
    import scipy.io
    fl = root / "flowers102"
    (fl / "jpg").mkdir(parents=True)
    for i in range(1, 5):
        Image.fromarray(r.randint(0, 256, (20, 24, 3)).astype(np.uint8)) \
            .save(fl / "jpg" / f"image_{i:05d}.jpg")
    scipy.io.savemat(fl / "imagelabels.mat",
                     {"labels": np.asarray([[3, 1, 102, 7]])})
    scipy.io.savemat(fl / "setid.mat", {
        "trnid": np.asarray([[1, 2]]), "valid": np.asarray([[3]]),
        "tstid": np.asarray([[4]])})
    voc = root / "VOC2012"
    for sub in ("JPEGImages", "SegmentationClass",
                "ImageSets/Segmentation"):
        (voc / sub).mkdir(parents=True)
    for name in ("a", "b"):
        Image.fromarray(r.randint(0, 256, (16, 12, 3)).astype(np.uint8)) \
            .save(voc / "JPEGImages" / f"{name}.jpg")
        Image.fromarray(r.randint(0, 21, (16, 12)).astype(np.uint8)) \
            .save(voc / "SegmentationClass" / f"{name}.png")
    (voc / "ImageSets/Segmentation/train.txt").write_text("a\nb\n")


def test_real_file_readers_match_jax(tmp_path, monkeypatch):
    _write_real_tree(tmp_path)
    for mod in (jds, tds):
        monkeypatch.setattr(mod, "_data_dir", str(tmp_path))
        monkeypatch.setattr(mod, "_parsed_cache", {})
    readers = {
        "mnist": (lambda m: m.mnist.train(0)),
        "cifar": (lambda m: m.cifar.train10(0)),
        "cifar_test": (lambda m: m.cifar.test10(0)),
        "uci": (lambda m: m.uci_housing.test(0)),
        "imdb": (lambda m: m.imdb.train(0)),
        "ctr": (lambda m: m.ctr.train(0)),
    }
    counts = {}
    for name, make in readers.items():
        got, want = list(make(tds)()), list(make(jds)())
        assert got and _eq(got, want), name
        counts[name] = len(got)
    assert counts == {"mnist": 3, "cifar": 10, "cifar_test": 2, "uci": 2,
                      "imdb": 4, "ctr": 4}
    ext = {"movielens": lambda m: m.movielens.train(0),
           "conll05": lambda m: m.conll05.test(0),
           "flowers": lambda m: m.flowers.train(0),
           "flowers_test": lambda m: m.flowers.test(0),
           "voc2012": lambda m: m.voc2012.train(0)}
    for name, make in ext.items():
        got, want = list(make(text)()), list(make(jext)())
        assert got and _eq(got, want), name
        counts[name] = len(got)
    assert counts["flowers"] == 2 and counts["voc2012"] == 2
    assert counts["conll05"] == 2
    assert text.movielens.max_user_id() == 2
    assert _eq(text.conll05.get_dict(), jext.conll05.get_dict())
    # the real files win over the synthetic generator
    assert tds.mnist.train(0)().__next__()[0].shape == (1, 28, 28)
    assert text.flowers.train(0)().__next__()[0].shape == (3, 64, 64)


def test_in_memory_dataset_loads_in_file_order(tmp_path):
    from paddle_tpu_torch.io.fluid_dataset import DatasetFactory
    r = np.random.RandomState(0)
    files = []
    for i in range(5):
        p = tmp_path / f"part-{i}"
        p.write_text("".join(
            f"1 {r.rand():.4f} 1 {int(r.randint(0, 99))} 1 {i}\n"
            for _ in range(50)))
        files.append(str(p))
    orders = []
    for threads in (1, 4, 5, 4):
        ds = DatasetFactory().create_dataset("InMemoryDataset")
        ds.set_slots([("x", "dense", 1), ("id", "sparse", 0),
                      ("f", "sparse", 0)])
        ds.set_batch_size(16)
        ds.set_thread(threads)
        ds.set_filelist(files)
        ds.load_into_memory()
        ds.global_shuffle(None, 3)
        orders.append(np.concatenate(
            [np.asarray(b["x"]).reshape(-1) for b in ds]))
    for o in orders[1:]:
        np.testing.assert_array_equal(o, orders[0])
    assert len(orders[0]) == 250
