"""Ragged sequences -> bucketed dense batches.

A copy of paddle_tpu/io/ragged.py (numpy only, so the port keeps its
own): samples are bucketed by length into a small fixed set of padded
shapes, the dense [B, T] + lengths form the sequence ops take (the
replacement for the reference's LoDTensor offsets, lod_tensor.h:52-104).
The batches equal the JAX package's, array for array.
"""
import numpy as np


def bucket_boundaries(max_len, num_buckets=8, min_len=16):
    """Geometric bucket sizes: min_len doubling, then max_len."""
    out = []
    b = min_len
    while b < max_len and len(out) < num_buckets - 1:
        out.append(b)
        b = int(b * 2)
    out.append(max_len)
    return out


class RaggedBatcher:
    """Groups variable-length samples into per-bucket batches.

    yields (padded_tokens [B, T_bucket], lengths [B], *other_cols) —
    the dense+length representation consumed by ops/sequence.py.
    """

    def __init__(self, reader, batch_size, boundaries, pad_value=0,
                 length_index=0, ragged_indices=None, drop_last=False):
        self.reader = reader
        self.batch_size = batch_size
        self.boundaries = sorted(boundaries)
        self.pad_value = pad_value
        self.length_index = length_index
        # all ragged columns are padded/truncated to the bucket chosen by
        # length_index (seq2seq: src picks the bucket, trg pads along)
        self.ragged_indices = set(ragged_indices if ragged_indices is not None
                                  else [length_index])
        self.ragged_indices.add(length_index)
        self.drop_last = drop_last

    def _bucket_of(self, length):
        for b in self.boundaries:
            if length <= b:
                return b
        return self.boundaries[-1]

    def __call__(self):
        buckets = {b: [] for b in self.boundaries}
        for sample in self.reader():
            seq = np.asarray(sample[self.length_index])
            b = self._bucket_of(len(seq))
            buckets[b].append(sample)
            if len(buckets[b]) == self.batch_size:
                yield self._emit(b, buckets[b])
                buckets[b] = []
        if not self.drop_last:
            for b, items in buckets.items():
                if items:
                    yield self._emit(b, items)

    def _pad_col(self, seqs, bucket):
        padded = np.full((len(seqs), bucket) + seqs[0].shape[1:],
                         self.pad_value, dtype=seqs[0].dtype)
        for i, q in enumerate(seqs):
            L = min(len(q), bucket)
            padded[i, :L] = q[:L]
        return padded

    def _emit(self, bucket, samples):
        li = self.length_index
        seqs = [np.asarray(s[li]) for s in samples]
        lengths = np.asarray([min(len(q), bucket) for q in seqs], np.int64)
        out = [self._pad_col(seqs, bucket), lengths]
        ncols = len(samples[0])
        for c in range(ncols):
            if c == li:
                continue
            col = [np.asarray(s[c]) for s in samples]
            if c in self.ragged_indices:
                out.append(self._pad_col(col, bucket))
            else:
                out.append(np.stack(col))
        return tuple(out)


class NestedRaggedBatcher:
    """Two-level ragged batches (lod_level=2 parity — the reference's
    nested LoD, lod_tensor.h:52: e.g. documents of sentences of tokens).

    Samples are lists of variable-length sequences. Emits the dense
    nested form:

        tokens      [B, S_max, T_bucket]   (pad_value filled)
        seq_counts  [B]        sentences per document
        tok_lengths [B, S_max] tokens per sentence (0 past seq_counts)
        *other_cols

    Sequence ops consume one ragged level at a time: flatten_nested()
    folds the outer level into the batch dim ([B*S, T] + [B*S] lengths,
    exactly what ops/sequence.py expects), compute, then unflatten_nested
    restores [B, S, ...] and the OUTER level pools with seq_counts — the
    TPU-native replacement for the reference's recursive LoD walk.
    """

    def __init__(self, reader, batch_size, boundaries, max_seqs=None,
                 pad_value=0, drop_last=False):
        self.reader = reader
        self.batch_size = batch_size
        self.boundaries = sorted(boundaries)
        self.max_seqs = max_seqs
        self.pad_value = pad_value
        self.drop_last = drop_last

    def _bucket_of(self, length):
        for b in self.boundaries:
            if length <= b:
                return b
        return self.boundaries[-1]

    def __call__(self):
        pending = []
        for sample in self.reader():
            pending.append(sample)
            if len(pending) == self.batch_size:
                yield self._emit(pending)
                pending = []
        if pending and not self.drop_last:
            yield self._emit(pending)

    def _emit(self, samples):
        docs = [[np.asarray(q) for q in s[0]] for s in samples]
        s_max = self.max_seqs or max(max(len(d) for d in docs), 1)
        t_bucket = self._bucket_of(
            max((len(q) for d in docs for q in d), default=1))
        # dtype/shape probe must survive empty documents in the batch
        probe = next((q for d in docs for q in d), None)
        first = probe if probe is not None else np.zeros((1,), np.float32)
        tokens = np.full((len(docs), s_max, t_bucket) + first.shape[1:],
                         self.pad_value, dtype=first.dtype)
        seq_counts = np.zeros(len(docs), np.int64)
        tok_lengths = np.zeros((len(docs), s_max), np.int64)
        for i, d in enumerate(docs):
            n = min(len(d), s_max)
            seq_counts[i] = n
            for j in range(n):
                L = min(len(d[j]), t_bucket)
                tok_lengths[i, j] = L
                tokens[i, j, :L] = d[j][:L]
        out = [tokens, seq_counts, tok_lengths]
        for c in range(1, len(samples[0])):
            out.append(np.stack([np.asarray(s[c]) for s in samples]))
        return tuple(out)


def flatten_nested(tokens, tok_lengths):
    """[B, S, T, ...] + [B, S] → ([B*S, T, ...], [B*S]) — fold the outer
    ragged level into the batch so level-1 sequence ops apply (the
    lod_reset-to-inner-level analogue). Works on numpy arrays and tensors."""
    b, s = tokens.shape[0], tokens.shape[1]
    return (tokens.reshape((b * s,) + tokens.shape[2:]),
            tok_lengths.reshape(b * s))


def unflatten_nested(x, batch, num_seqs):
    """Inverse of flatten_nested for per-sequence results:
    [B*S, ...] → [B, S, ...]."""
    return x.reshape((batch, num_seqs) + x.shape[1:])
