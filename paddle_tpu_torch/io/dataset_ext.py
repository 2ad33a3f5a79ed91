"""More datasets: movielens, conll05 (SRL), flowers, voc2012, and the
md5-cached fetch layer.

Counterpart of paddle_tpu/io/dataset_ext.py (the reference's
python/paddle/dataset/{movielens,conll05,flowers,voc2012}.py and
common.py:36 `download` / :57 `md5file`). Each class's train() / test()
returns a sample generator: the canonical on-disk files when they are
present under `dataset.set_data_dir`, else a deterministic synthetic
generator whose samples are the JAX package's bit for bit for the same
`n`.

`download` is offline: a cached file short-circuits, and a source is
read through the io/fs scheme registry (file://, mem://, plain paths,
or any scheme a deployment registers, http included) into a `.part`
file that is md5-checked and renamed into place. An http(s) URL with no
registered FileSystem raises with the cache path to stage the file at;
the port itself opens no network connection.
"""
import hashlib
import os
import shutil

import numpy as np

from paddle_tpu_torch.io import dataset as _ds

DATA_HOME = os.environ.get(
    "PT_DATA_HOME",
    os.path.expanduser("~/.cache/paddle_tpu_torch/dataset"))


def md5file(fname):
    """common.py:57 parity: md5 of a file, streamed."""
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url, module_name, md5sum=None, save_name=None):
    """common.py:66: fetch `url` into DATA_HOME/<module_name>/ with md5
    verification and caching. A cached file with the right md5
    short-circuits; otherwise the source is read through io/fs into a
    `.part` file that replaces the target only after its md5 matched,
    so an interrupted or corrupt fetch never reads as a cache hit."""
    from paddle_tpu_torch.io import fs as _fs
    dirname = os.path.join(DATA_HOME, module_name)
    os.makedirs(dirname, exist_ok=True)
    filename = os.path.join(
        dirname, save_name or url.split("/")[-1].split("?")[0])

    if os.path.exists(filename) and (md5sum is None
                                     or md5file(filename) == md5sum):
        return filename

    partial = filename + ".part"
    try:
        scheme = url.split("://", 1)[0] if "://" in url else None
        if scheme in ("http", "https") and not _fs.has_fs(scheme):
            raise RuntimeError(
                f"download({url}): no FileSystem is registered for "
                f"{scheme}:// (io.fs.register_fs) and the port opens no "
                f"network connection itself; stage the file at "
                f"{filename} (md5 {md5sum}) and retry")
        fs, path = _fs.get_fs(url)
        with fs.open(path, "rb") as src, open(partial, "wb") as dst:
            shutil.copyfileobj(src, dst)
        if md5sum is not None:
            got = md5file(partial)
            if got != md5sum:
                raise RuntimeError(
                    f"download({url}): md5 mismatch (want {md5sum}, "
                    f"got {got})")
        os.replace(partial, filename)
    finally:
        if os.path.exists(partial):
            os.remove(partial)
    return filename


# --------------------------------------------------------------------- #
# movielens (dataset/movielens.py)                                      #
# --------------------------------------------------------------------- #

class movielens:
    """ml-1m readers. Sample structure (movielens.py __reader__:167):
    [user_id, gender(0=M,1=F), age_bucket, job_id,
     movie_id, [category ids], [title word ids], [rating*2-5]].
    """

    age_table = [1, 18, 25, 35, 45, 50, 56]
    N_USERS, N_MOVIES, N_JOBS = 120, 180, 21
    N_CATEGORIES, TITLE_VOCAB = 18, 400

    # ---- synthetic metadata (deterministic) ----
    @classmethod
    def _syn_meta(cls):
        key = ("movielens", "syn_meta")
        if key not in _ds._parsed_cache:
            r = _ds._rng(13)
            movies = {}
            for mid in range(1, cls.N_MOVIES + 1):
                ncat = int(r.randint(1, 4))
                cats = sorted(set(r.randint(0, cls.N_CATEGORIES, ncat)
                                  .tolist()))
                ntit = int(r.randint(1, 6))
                title = r.randint(0, cls.TITLE_VOCAB, ntit).tolist()
                movies[mid] = (cats, title)
            users = {}
            for uid in range(1, cls.N_USERS + 1):
                users[uid] = (int(r.randint(0, 2)), int(r.randint(0, 7)),
                              int(r.randint(0, cls.N_JOBS)))
            _ds._parsed_cache[key] = (movies, users)
        return _ds._parsed_cache[key]

    @classmethod
    def _syn(cls, n, seed, is_test):
        movies, users = cls._syn_meta()
        r = _ds._rng(seed)

        def gen():
            for _ in range(n):
                uid = int(r.randint(1, cls.N_USERS + 1))
                mid = int(r.randint(1, cls.N_MOVIES + 1))
                gender, age, job = users[uid]
                cats, title = movies[mid]
                rating = float(r.randint(1, 6)) * 2 - 5.0
                yield [uid, gender, age, job, mid, list(cats), list(title),
                       [rating]]
        return gen

    # ---- real ml-1m parser ----
    @classmethod
    def _meta(cls):
        """Parse movies.dat/users.dat from ml-1m (zip or unpacked dir)."""
        import io
        import re
        import zipfile

        def loader():
            zpath = _ds._real_path("ml-1m.zip")
            root = _ds._real_path("ml-1m")
            if not zpath and not root:
                return None

            def open_member(name):
                if root:
                    return open(os.path.join(root, name), "rb")
                zf = zipfile.ZipFile(zpath)
                return zf.open("ml-1m/" + name)

            pattern = re.compile(r"^(.*)\((\d+)\)$")
            movies_raw = {}
            title_words, categories = set(), set()
            with open_member("movies.dat") as f:
                for line in io.TextIOWrapper(f, encoding="latin-1"):
                    mid, title, cats = line.strip().split("::")
                    cats = cats.split("|")
                    m = pattern.match(title)
                    title = m.group(1).strip() if m else title
                    movies_raw[int(mid)] = (title, cats)
                    categories.update(cats)
                    title_words.update(w.lower() for w in title.split())
            cat_dict = {c: i for i, c in enumerate(sorted(categories))}
            title_dict = {w: i for i, w in enumerate(sorted(title_words))}
            movies = {
                mid: ([cat_dict[c] for c in cats],
                      [title_dict[w.lower()] for w in title.split()])
                for mid, (title, cats) in movies_raw.items()}
            users = {}
            with open_member("users.dat") as f:
                for line in io.TextIOWrapper(f, encoding="latin-1"):
                    uid, gender, age, job, _zip = line.strip().split("::")
                    users[int(uid)] = (0 if gender == "M" else 1,
                                      cls.age_table.index(int(age)),
                                      int(job))
            return movies, users, cat_dict, title_dict

        return _ds._cached(("movielens", "meta"), loader)

    @classmethod
    def _real(cls, is_test, n):
        meta = cls._meta()
        if meta is None:
            return None
        movies, users, _, _ = meta
        import io
        import zipfile
        zpath = _ds._real_path("ml-1m.zip")
        root = _ds._real_path("ml-1m")

        def gen():
            r = np.random.RandomState(0)  # reference: seeded split
            if root:
                f = open(os.path.join(root, "ratings.dat"), "rb")
            else:
                f = zipfile.ZipFile(zpath).open("ml-1m/ratings.dat")
            count = 0
            with f:
                for line in io.TextIOWrapper(f, encoding="latin-1"):
                    if n and count >= n:
                        break
                    # 10% held out, same draw protocol as the reference
                    if (r.random_sample() < 0.1) != is_test:
                        continue
                    uid, mid, rating, _ts = line.strip().split("::")
                    uid, mid = int(uid), int(mid)
                    if uid not in users or mid not in movies:
                        continue
                    gender, age, job = users[uid]
                    cats, title = movies[mid]
                    count += 1
                    yield [uid, gender, age, job, mid, list(cats),
                           list(title), [float(rating) * 2 - 5.0]]
        return gen

    @classmethod
    def train(cls, n=4096):
        return _ds._with_real(cls._syn(n, 3, False), cls._real(False, n))

    @classmethod
    def test(cls, n=512):
        return _ds._with_real(cls._syn(n, 4, True), cls._real(True, n))

    # metadata surface (movielens.py __all__)
    @classmethod
    def max_user_id(cls):
        meta = cls._meta()
        if meta is None:
            return cls.N_USERS
        return max(meta[1])

    @classmethod
    def max_movie_id(cls):
        meta = cls._meta()
        if meta is None:
            return cls.N_MOVIES
        return max(meta[0])

    @classmethod
    def max_job_id(cls):
        meta = cls._meta()
        if meta is None:
            return cls.N_JOBS - 1
        return max(j for _, _, j in meta[1].values())

    @classmethod
    def movie_categories(cls):
        meta = cls._meta()
        if meta is None:
            return {f"cat_{i}": i for i in range(cls.N_CATEGORIES)}
        return dict(meta[2])

    @classmethod
    def get_movie_title_dict(cls):
        meta = cls._meta()
        if meta is None:
            return {f"w{i}": i for i in range(cls.TITLE_VOCAB)}
        return dict(meta[3])


# --------------------------------------------------------------------- #
# conll05 SRL (dataset/conll05.py)                                      #
# --------------------------------------------------------------------- #

class conll05:
    """Semantic-role labeling. Sample (conll05.py reader_creator:199):
    9 sequences — word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2
    (context words replicated to sentence length), predicate id
    (replicated), mark (0/1 window flags), label ids (B-/I-/O scheme)."""

    WORD_VOCAB, PRED_VOCAB, NUM_LABELS = 800, 60, 35
    UNK_IDX = 0

    # ---- label sequence from the props bracket column ----
    @staticmethod
    def _bracket_to_labels(col):
        """'(A0*', '*', '*)' bracket tags → B-/I-/O sequence (the
        conll05.py corpus_reader:109-131 state machine)."""
        out, cur, inside = [], "O", False
        for tok in col:
            if tok == "*":
                out.append("I-" + cur if inside else "O")
            elif tok == "*)":
                out.append("I-" + cur)
                inside = False
            elif "(" in tok and ")" in tok:
                cur = tok[1:tok.find("*")]
                out.append("B-" + cur)
                inside = False
            elif "(" in tok:
                cur = tok[1:tok.find("*")]
                out.append("B-" + cur)
                inside = True
            else:
                raise ValueError(f"unexpected props tag {tok!r}")
        return out

    @classmethod
    def _sentence_to_sample(cls, words, predicate, labels, word_dict,
                            pred_dict, label_dict):
        """Context-window featurization (reader_creator:154-199)."""
        sen_len = len(words)
        vi = labels.index("B-V")
        mark = [0] * sen_len

        def at(i, fallback):
            if 0 <= i < sen_len:
                mark[i] = 1
                return words[i]
            return fallback

        ctx_n2 = at(vi - 2, "bos")
        ctx_n1 = at(vi - 1, "bos")
        ctx_0 = at(vi, "bos")
        ctx_p1 = at(vi + 1, "eos")
        ctx_p2 = at(vi + 2, "eos")

        def widx(w):
            return word_dict.get(w, cls.UNK_IDX)

        word_idx = [widx(w) for w in words]
        reps = [[widx(c)] * sen_len
                for c in (ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2)]
        pred_idx = [pred_dict.get(predicate, 0)] * sen_len
        label_idx = [label_dict.get(l, 0) for l in labels]
        return tuple([word_idx] + reps + [pred_idx, mark, label_idx])

    # ---- synthetic ----
    @classmethod
    def _syn(cls, n, seed):
        r = _ds._rng(seed)
        word_dict, pred_dict, label_dict = cls.get_dict()

        def gen():
            for _ in range(n):
                sen_len = int(r.randint(5, 25))
                words = [f"w{int(i)}" for i in
                         r.randint(1, cls.WORD_VOCAB, sen_len)]
                vi = int(r.randint(0, sen_len))
                labels = ["O"] * sen_len
                labels[vi] = "B-V"
                # one argument span left or right of the verb
                if vi + 2 < sen_len:
                    labels[vi + 1] = "B-A0"
                    labels[vi + 2] = "I-A0"
                predicate = f"p{int(r.randint(0, cls.PRED_VOCAB))}"
                yield cls._sentence_to_sample(words, predicate, labels,
                                              word_dict, pred_dict,
                                              label_dict)
        return gen

    # ---- real conll05st files ----
    @classmethod
    def _corpus(cls, words_path, props_path):
        """Yield (words, predicate, label-seq) per predicate per sentence
        from the CoNLL-2005 column files (one token per line, blank line
        between sentences; props col 0 = predicate lemma or '-')."""
        import gzip

        def opener(p):
            return gzip.open(p, "rt") if p.endswith(".gz") else open(p)

        with opener(words_path) as wf, opener(props_path) as pf:
            words, prop_rows = [], []
            for wline, pline in zip(wf, pf):
                wline, ptoks = wline.strip(), pline.strip().split()
                if not wline and not ptoks:
                    if words:
                        cols = list(zip(*prop_rows))
                        verbs = [v for v in cols[0] if v != "-"]
                        for vi, col in enumerate(cols[1:]):
                            labels = cls._bracket_to_labels(list(col))
                            if "B-V" in labels:
                                yield list(words), verbs[vi], labels
                    words, prop_rows = [], []
                    continue
                words.append(wline.split()[0])
                prop_rows.append(ptoks)
            if words:
                cols = list(zip(*prop_rows))
                verbs = [v for v in cols[0] if v != "-"]
                for vi, col in enumerate(cols[1:]):
                    labels = cls._bracket_to_labels(list(col))
                    if "B-V" in labels:
                        yield list(words), verbs[vi], labels

    @classmethod
    def _real(cls, n):
        words_p = _ds._real_path("conll05st/test.wsj.words.gz",
                                 "conll05st/test.wsj.words",
                                 "test.wsj.words")
        props_p = _ds._real_path("conll05st/test.wsj.props.gz",
                                 "conll05st/test.wsj.props",
                                 "test.wsj.props")
        if not words_p or not props_p:
            return None
        word_dict, pred_dict, label_dict = cls._real_dicts(words_p, props_p)

        def gen():
            count = 0
            for words, pred, labels in cls._corpus(words_p, props_p):
                if n and count >= n:
                    break
                count += 1
                yield cls._sentence_to_sample(words, pred, labels,
                                              word_dict, pred_dict,
                                              label_dict)
        return gen

    @classmethod
    def _real_dicts(cls, words_p, props_p):
        def loader():
            words, preds, labels = set(), set(), set()
            for ws, p, ls in cls._corpus(words_p, props_p):
                words.update(ws)
                preds.add(p)
                labels.update(ls)
            wd = {w: i + 1 for i, w in enumerate(sorted(words))}
            wd["<unk>"] = cls.UNK_IDX
            pd_ = {p: i for i, p in enumerate(sorted(preds))}
            ld = {l: i for i, l in enumerate(sorted(labels))}
            return wd, pd_, ld
        return _ds._cached(("conll05", "dicts"), loader)

    @classmethod
    def get_dict(cls):
        """(word_dict, verb_dict, label_dict) — conll05.py get_dict."""
        words_p = _ds._real_path("conll05st/test.wsj.words.gz",
                                 "conll05st/test.wsj.words",
                                 "test.wsj.words")
        props_p = _ds._real_path("conll05st/test.wsj.props.gz",
                                 "conll05st/test.wsj.props",
                                 "test.wsj.props")
        if words_p and props_p:
            return cls._real_dicts(words_p, props_p)
        wd = {f"w{i}": i for i in range(cls.WORD_VOCAB)}
        wd["<unk>"] = cls.UNK_IDX
        pd_ = {f"p{i}": i for i in range(cls.PRED_VOCAB)}
        labels = ["O", "B-V", "I-V"]
        for tag in ("A0", "A1", "A2", "A3", "A4", "AM-TMP", "AM-LOC",
                    "AM-MNR", "AM-NEG", "AM-MOD", "AM-ADV", "AM-DIS",
                    "AM-PNC", "AM-DIR", "AM-EXT", "AM-PRD"):
            labels += [f"B-{tag}", f"I-{tag}"]
        ld = {l: i for i, l in enumerate(labels[:cls.NUM_LABELS])}
        return wd, pd_, ld

    @classmethod
    def test(cls, n=512):
        """conll05 ships only the test split for public download
        (conll05.py test():225)."""
        return _ds._with_real(cls._syn(n, 7), cls._real(n))


# --------------------------------------------------------------------- #
# flowers-102 (dataset/flowers.py)                                      #
# --------------------------------------------------------------------- #

class flowers:
    """102-category flowers. Sample: (CHW float32 image scaled [0,1],
    int64 label in [0,102)). Real layout: jpg/image_*.jpg +
    imagelabels.mat + setid.mat (flowers.py:60-120)."""

    IMAGE_SHAPE = (3, 64, 64)
    NUM_CLASSES = 102

    @classmethod
    def _syn(cls, n, seed):
        protos = _ds._rng(42).rand(cls.NUM_CLASSES, *cls.IMAGE_SHAPE) \
            .astype(np.float32)
        r = _ds._rng(seed)

        def gen():
            for _ in range(n):
                y = int(r.randint(0, cls.NUM_CLASSES))
                x = np.clip(protos[y] + 0.1 * r.randn(*cls.IMAGE_SHAPE), 0, 1)
                yield x.astype(np.float32), np.int64(y)
        return gen

    @classmethod
    def _real(cls, split, n):
        root = _ds._real_path("flowers102", "102flowers", "flowers")
        if not root:
            return None
        jpg_dir = os.path.join(root, "jpg")
        labels_mat = os.path.join(root, "imagelabels.mat")
        setid_mat = os.path.join(root, "setid.mat")
        if not (os.path.isdir(jpg_dir) and os.path.exists(labels_mat)
                and os.path.exists(setid_mat)):
            return None
        import scipy.io
        labels = scipy.io.loadmat(labels_mat)["labels"].ravel()  # 1-based
        sets = scipy.io.loadmat(setid_mat)
        # flowers.py: train←trnid, valid←valid, test←tstid
        ids = sets[{"train": "trnid", "valid": "valid",
                    "test": "tstid"}[split]].ravel()
        take = ids[:n] if n else ids

        def gen():
            from PIL import Image
            for i in take:
                p = os.path.join(jpg_dir, f"image_{int(i):05d}.jpg")
                img = Image.open(p).convert("RGB") \
                    .resize(cls.IMAGE_SHAPE[1:][::-1])
                arr = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
                yield arr, np.int64(int(labels[int(i) - 1]) - 1)
        return gen

    @classmethod
    def train(cls, n=2048):
        return _ds._with_real(cls._syn(n, 5), cls._real("train", n))

    @classmethod
    def valid(cls, n=256):
        return _ds._with_real(cls._syn(n, 6), cls._real("valid", n))

    @classmethod
    def test(cls, n=256):
        return _ds._with_real(cls._syn(n, 7), cls._real("test", n))


# --------------------------------------------------------------------- #
# voc2012 segmentation (dataset/voc2012.py)                             #
# --------------------------------------------------------------------- #

class voc2012:
    """Pascal VOC2012 segmentation. Sample: (CHW float32 image in [0,1],
    HW int64 class mask with 255=ignore). Real layout: the VOCdevkit tree
    (JPEGImages/, SegmentationClass/, ImageSets/Segmentation/{split}.txt),
    voc2012.py:44-85."""

    IMAGE_SHAPE = (3, 64, 64)
    NUM_CLASSES = 21

    @classmethod
    def _syn(cls, n, seed):
        r = _ds._rng(seed)
        c, h, w = cls.IMAGE_SHAPE

        def gen():
            for _ in range(n):
                img = r.rand(c, h, w).astype(np.float32)
                mask = np.zeros((h, w), np.int64)
                # one rectangular object of a random class
                y0, x0 = int(r.randint(0, h // 2)), int(r.randint(0, w // 2))
                cls_id = int(r.randint(1, cls.NUM_CLASSES))
                mask[y0:y0 + h // 3, x0:x0 + w // 3] = cls_id
                yield img, mask
        return gen

    @classmethod
    def _root(cls):
        for cand in ("VOCdevkit/VOC2012", "VOC2012"):
            p = _ds._real_path(cand)
            if p:
                return p
        return None

    @classmethod
    def _real(cls, split, n):
        root = cls._root()
        if not root:
            return None
        lst = os.path.join(root, "ImageSets", "Segmentation", f"{split}.txt")
        if not os.path.exists(lst):
            return None
        with open(lst) as f:
            names = [l.strip() for l in f if l.strip()]
        if n:
            names = names[:n]

        def gen():
            from PIL import Image
            for name in names:
                img = Image.open(os.path.join(
                    root, "JPEGImages", name + ".jpg")).convert("RGB")
                seg = Image.open(os.path.join(
                    root, "SegmentationClass", name + ".png"))
                arr = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
                mask = np.asarray(seg, np.int64)
                yield arr, mask
        return gen

    @classmethod
    def train(cls, n=512):
        return _ds._with_real(cls._syn(n, 8), cls._real("train", n))

    @classmethod
    def val(cls, n=128):
        return _ds._with_real(cls._syn(n, 9), cls._real("val", n))
