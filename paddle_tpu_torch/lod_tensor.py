"""fluid.lod_tensor module path on the dense + lengths ragged contract:
a "LoDTensor" is (padded data, lengths) (counterpart of
paddle_tpu/lod_tensor.py; numpy only)."""
import numpy as np

__all__ = ["create_lod_tensor", "create_random_int_lodtensor"]


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """(padded dense, int64 lengths) from a list of sequences, or from a
    flat array and the lengths (lod_tensor.py:24)."""
    lens = list(recursive_seq_lens[-1])
    if isinstance(data, (list, tuple)):
        rows = [np.asarray(r) for r in data]
    else:
        flat = np.asarray(data)
        rows, off = [], 0
        for n in lens:
            rows.append(flat[off:off + n])
            off += n
    t = max(len(r) for r in rows)
    feat = rows[0].shape[1:] if rows[0].ndim > 1 else ()
    out = np.zeros((len(rows), t) + feat, rows[0].dtype)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out, np.asarray(lens, np.int64)


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place,
                                low, high):
    """Sequences of uniform ints in [low, high] from numpy's global
    generator, padded (the reference's contract)."""
    lens = list(recursive_seq_lens[-1])
    rows = [np.random.randint(low, high + 1, size=(n,) + tuple(base_shape))
            for n in lens]
    return create_lod_tensor(rows, recursive_seq_lens, place)
