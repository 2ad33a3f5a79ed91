"""The fluid.layers compatibility surface: the LoD machinery's names,
the reader builders, and aliases whose reference behaviour the
dense + lengths design subsumes.

Counterpart of paddle_tpu/static/compat.py:

* The LoD tensor-array plumbing (layers/control_flow.py lod_rank_table,
  max_sequence_len, lod_tensor_to_array, array_to_lod_tensor,
  reorder_lod_tensor_by_rank, shrink_memory; layers/nn.py lod_reset /
  lod_append; split / merge_lod_tensor). Sequences here are dense
  [B, T, ...] + lengths, so these are dense carriers that keep each
  composite's end-to-end meaning; the ones that only do LoD bookkeeping
  are identities and warn once a name (`_compat_warn`), as in the JAX
  package.
* The SelectedRows helpers (get_tensor_from_selected_rows,
  merge_selected_rows): gradients here are dense, so both are `assign`.
* The readers (layers/io.py py_reader, create_py_reader_by_data,
  double_buffer, read_file): views that feed the Executor's feed dict
  from a decorated generator.
* Aliases over ported op types (cvm, cross_entropy, the shrinks,
  unique, trilinear_interp, pool3d), and save_combine / load_combine:
  every named var of the current scope in one numpy archive, the JAX
  package's file format, so each package loads what the other saved.
"""
import os
import warnings

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.scope import global_scope
from paddle_tpu_torch.static.common import _simple

_warned = set()


def _compat_warn(name, subsumed_by):
    """Once a name: this LoD / SelectedRows helper is an identity in the
    dense design."""
    if name in _warned:
        return
    _warned.add(name)
    warnings.warn(
        f"{name} is an identity in the dense+lengths design — its LoD "
        f"bookkeeping role is subsumed by {subsumed_by}. Review the call "
        f"site if your code depended on LoD side effects.",
        stacklevel=3)


__all__ = [
    "lod_reset", "lod_append", "lod_rank_table", "max_sequence_len",
    "lod_tensor_to_array", "array_to_lod_tensor",
    "reorder_lod_tensor_by_rank", "shrink_memory", "split_lod_tensor",
    "merge_lod_tensor", "get_tensor_from_selected_rows",
    "merge_selected_rows", "py_reader", "create_py_reader_by_data",
    "double_buffer", "read_file", "continuous_value_model",
    "cross_entropy2", "hard_shrink", "softshrink", "thresholded_relu",
    "unique", "unique_with_counts", "resize_trilinear", "adaptive_pool3d",
    "save_combine", "load_combine", "monkey_patch_reader_methods",
]


# ------------------------------------------------------- LoD machinery
def lod_reset(x, y=None, target_lod=None):
    """layers/nn.py lod_reset: the dense tensor carries no LoD; the new
    lengths (`y` or `target_lod`) travel beside it."""
    lengths = y if y is not None else target_lod
    return x if lengths is None else (x, lengths)


def lod_append(x, level):
    _compat_warn("lod_append",
                 "lengths vectors carried alongside dense tensors")
    return x


def lod_rank_table(x, level=0):
    """control_flow.py lod_rank_table: the dense ops read lengths
    directly, so the input is the 'table'."""
    _compat_warn("lod_rank_table",
                 "direct lengths consumption (ops/sequence.py)")
    return x


def max_sequence_len(rank_table):
    """control_flow.py max_sequence_len: dim 1 of the dense [B, T]
    layout."""
    from paddle_tpu_torch.static.common import fill_constant
    t = (rank_table.shape[1] if len(rank_table.shape) > 1
         else rank_table.shape[0])
    return fill_constant([1], "int64", t)


def lod_tensor_to_array(x, table):
    """A dense [B, T, ...] tensor already is the T-indexed array."""
    _compat_warn("lod_tensor_to_array",
                 "the static RNN time-major machinery (static/rnn.py)")
    return x


def array_to_lod_tensor(x, table):
    _compat_warn("array_to_lod_tensor",
                 "the static RNN time-major machinery (static/rnn.py)")
    return x


def reorder_lod_tensor_by_rank(x, rank_table):
    """Masking handles ragged tails, so no length-sorted order is
    needed."""
    _compat_warn("reorder_lod_tensor_by_rank", "mask-based ragged handling")
    return x


def shrink_memory(x, i, table):
    """The dense While keeps the whole batch and masks where the
    reference shrinks the state to the still-active prefix."""
    _compat_warn("shrink_memory", "full-batch masking in the dense While "
                 "(static/control_flow.py)")
    return x


def _mask_pair(mask):
    from paddle_tpu_torch.static.common import cast
    m = cast(mask, "float32")
    return m, _simple("scale", {"X": m}, {"scale": -1.0, "bias": 1.0})


def split_lod_tensor(input, mask, level=0):
    """control_flow.py split_lod_tensor (IfElse's primitive): under
    static shapes both branches stay full size, the rows the mask does
    not route to a branch zeroed. Returns (out_true, out_false)."""
    from paddle_tpu_torch.static.common import elementwise_mul
    m, inv = _mask_pair(mask)
    return (elementwise_mul(input, m, axis=0),
            elementwise_mul(input, inv, axis=0))


def merge_lod_tensor(in_true, in_false, x, mask, level=0):
    from paddle_tpu_torch.static.common import elementwise_add, \
        elementwise_mul
    m, inv = _mask_pair(mask)
    return elementwise_add(elementwise_mul(in_true, m, axis=0),
                           elementwise_mul(in_false, inv, axis=0))


# --------------------------------------------------- SelectedRows compat
def get_tensor_from_selected_rows(x, name=None):
    _compat_warn("get_tensor_from_selected_rows", "dense gradients")
    return _simple("assign", {"X": x})


def merge_selected_rows(x, name=None):
    _compat_warn("merge_selected_rows", "dense gradients")
    return _simple("assign", {"X": x})


# ----------------------------------------------------------- readers
class _CompatReader:
    """fluid's py_reader: start() / reset(), and iteration that yields
    one feed dict a batch of the decorated generator."""

    def __init__(self, feed_names, generator=None):
        self.feed_names = feed_names
        self._gen = generator
        self._iter = None

    def decorate_paddle_reader(self, reader):
        self._gen = reader

    decorate_sample_list_generator = decorate_paddle_reader
    decorate_batch_generator = decorate_paddle_reader

    def start(self):
        enforce(self._gen is not None,
                "py_reader: call decorate_paddle_reader(...) first")
        self._iter = iter(self._gen())

    def reset(self):
        self._iter = None

    def __iter__(self):
        enforce(self._iter is not None, "py_reader: call start() first")
        for sample in self._iter:
            if not isinstance(sample, (tuple, list)):
                sample = (sample,)
            yield dict(zip(self.feed_names, [np.asarray(s) for s in sample]))


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """layers/io.py py_reader: a reader and the feed variables it fills
    (plain data() slots: the feed dict carries the batch)."""
    from paddle_tpu_torch.static.nn import data
    names = [f"{name or 'py_reader'}_slot{i}" for i in range(len(shapes))]
    reader = _CompatReader(names)
    reader.feed_vars = [data(n, list(s), str(np.dtype(d)),
                             append_batch_size=False)
                        for n, s, d in zip(names, shapes, dtypes)]
    return reader


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    reader = _CompatReader([v.name for v in feed_list])
    reader.feed_vars = list(feed_list)
    return reader


def double_buffer(reader, place=None, name=None):
    """The identity on the compat reader (the feed is already a host
    batch a step)."""
    return reader


def read_file(reader):
    """layers/io.py read_file: the reader's feed variables."""
    vs = getattr(reader, "feed_vars", None)
    enforce(vs is not None, "read_file expects a py_reader")
    return vs if len(vs) > 1 else vs[0]


def monkey_patch_reader_methods(reader):
    """layers/io.py plumbing: the compat reader has its methods."""
    return reader


# ------------------------------------------------------------- aliases
def continuous_value_model(input, cvm, use_cvm=True):
    """layers/nn.py continuous_value_model: the cvm op (ops/ctr.py)."""
    return _simple("cvm", {"X": input, "CVM": cvm}, {"use_cvm": use_cvm},
                   out_slots=["Y"])


def cross_entropy2(input, label, ignore_index=-100):
    from paddle_tpu_torch.static.common import cross_entropy
    return cross_entropy(input, label, soft_label=False,
                         ignore_index=ignore_index)


def hard_shrink(x, threshold=0.5):
    return _simple("hard_shrink", {"X": x}, {"threshold": threshold})


def softshrink(x, alpha=0.5):
    return _simple("softshrink", {"X": x}, {"lambda": alpha})


def thresholded_relu(x, threshold=1.0):
    return _simple("thresholded_relu", {"X": x}, {"threshold": threshold})


def unique(x, dtype="int64"):
    return _simple("unique", {"X": x}, {}, n_out=2,
                   out_slots=["Out", "Index"])


def unique_with_counts(x, dtype="int64"):
    return _simple("unique_with_counts", {"X": x}, {}, n_out=3,
                   out_slots=["Out", "Index", "Count"])


def resize_trilinear(input, out_shape=None, scale=None, name=None,
                     align_corners=True, align_mode=1, data_format="NCDHW"):
    """layers/nn.py resize_trilinear on NCDHW (the trilinear_interp
    op)."""
    if out_shape is None:
        out_shape = [int(input.shape[i] * scale) for i in (2, 3, 4)]
    return _simple("trilinear_interp", {"X": input},
                   {"out_d": int(out_shape[0]), "out_h": int(out_shape[1]),
                    "out_w": int(out_shape[2])})


def adaptive_pool3d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    size = (list(pool_size) if isinstance(pool_size, (list, tuple))
            else [pool_size] * 3)
    return _simple("pool3d", {"X": input},
                   {"ksize": size, "pooling_type": pool_type,
                    "adaptive": True})


# -------------------------------------------------------- save_combine
def _var_name(v):
    return v if isinstance(v, str) else v.name


def save_combine(vars_list, file_path, executor=None):
    """save_combine_op.cc: the named vars of the current scope in one
    numpy archive (np.savez), written atomically."""
    sc = global_scope()
    arrs = {}
    for v in vars_list:
        name = _var_name(v)
        val = sc.find_np(name)
        enforce(val is not None, "save_combine: %s not in scope", name)
        arrs[name] = val
    tmp = file_path + ".saving"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, file_path)


def load_combine(vars_list, file_path, executor=None):
    """The named vars from one archive into the current scope, on the
    executor's device (None: CUDA, as `core.places.resolve_device`)."""
    from paddle_tpu_torch.core.places import resolve_device
    device = (executor.device if executor is not None
              else resolve_device(None))
    with open(file_path, "rb") as f:
        data = np.load(f)
        arrays = {n: np.asarray(data[n]) for n in data.files}
    sc = global_scope()
    for v in vars_list:
        name = _var_name(v)
        enforce(name in arrays, "load_combine: %s not in %s", name,
                file_path)
        sc.set(name, torch.from_numpy(arrays[name]).to(device))
