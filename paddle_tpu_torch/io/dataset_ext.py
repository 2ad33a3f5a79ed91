"""More built-in datasets: conll05 (semantic-role labeling).

Counterpart of paddle_tpu/io/dataset_ext.py's conll05 for now: its
offline synthetic generator and `get_dict`, giving the JAX package's
samples bit for bit for the same `n` (the same seed and numpy draws).
The readers of the real CoNLL-2005 files (`_real`, `_real_dicts`), the
fetch layer and the other datasets of the module wait for those files
and for ROADMAP Queue 1 item 16.
"""
from paddle_tpu_torch.io.dataset import _rng

__all__ = ["conll05"]


class conll05:
    """Semantic-role labeling. A sample (conll05.py reader_creator:199)
    is 9 sequences of the sentence's length: word ids, the five context
    words ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2 (each replicated), the
    predicate id (replicated), mark (1 inside the verb's window) and the
    label ids (B- / I- / O)."""

    WORD_VOCAB, PRED_VOCAB, NUM_LABELS = 800, 60, 35
    UNK_IDX = 0

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

        ctx = (at(vi - 2, "bos"), at(vi - 1, "bos"), at(vi, "bos"),
               at(vi + 1, "eos"), at(vi + 2, "eos"))

        def widx(w):
            return word_dict.get(w, cls.UNK_IDX)

        word_idx = [widx(w) for w in words]
        reps = [[widx(c)] * sen_len for c in ctx]
        pred_idx = [pred_dict.get(predicate, 0)] * sen_len
        label_idx = [label_dict.get(lb, 0) for lb in labels]
        return tuple([word_idx] + reps + [pred_idx, mark, label_idx])

    @classmethod
    def _syn(cls, n, seed):
        r = _rng(seed)
        word_dict, pred_dict, label_dict = cls.get_dict()

        def gen():
            for _ in range(n):
                sen_len = int(r.randint(5, 25))
                words = [f"w{int(i)}" for i in
                         r.randint(1, cls.WORD_VOCAB, sen_len)]
                vi = int(r.randint(0, sen_len))
                labels = ["O"] * sen_len
                labels[vi] = "B-V"
                # one argument span right of the verb
                if vi + 2 < sen_len:
                    labels[vi + 1] = "B-A0"
                    labels[vi + 2] = "I-A0"
                predicate = f"p{int(r.randint(0, cls.PRED_VOCAB))}"
                yield cls._sentence_to_sample(words, predicate, labels,
                                              word_dict, pred_dict,
                                              label_dict)
        return gen

    @classmethod
    def get_dict(cls):
        """(word_dict, verb_dict, label_dict), conll05.py get_dict: the
        synthetic vocabularies of 800 words, 60 verbs and 35 labels."""
        wd = {f"w{i}": i for i in range(cls.WORD_VOCAB)}
        wd["<unk>"] = cls.UNK_IDX
        pd_ = {f"p{i}": i for i in range(cls.PRED_VOCAB)}
        labels = ["O", "B-V", "I-V"]
        for tag in ("A0", "A1", "A2", "A3", "A4", "AM-TMP", "AM-LOC",
                    "AM-MNR", "AM-NEG", "AM-MOD", "AM-ADV", "AM-DIS",
                    "AM-PNC", "AM-DIR", "AM-EXT", "AM-PRD"):
            labels += [f"B-{tag}", f"I-{tag}"]
        ld = {lb: i for i, lb in enumerate(labels[:cls.NUM_LABELS])}
        return wd, pd_, ld

    @classmethod
    def test(cls, n=512):
        """conll05 ships only the test split (conll05.py test():225)."""
        return cls._syn(n, 7)
