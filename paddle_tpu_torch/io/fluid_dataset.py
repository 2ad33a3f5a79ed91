"""Datasets over the native C++ data-feed pipeline.

Counterpart of paddle_tpu/io/fluid_dataset.py (the reference's
python/paddle/fluid/dataset.py: DatasetFactory, InMemoryDataset
(dataset.py:276: load_into_memory / local_shuffle / global_shuffle /
release_memory), QueueDataset (:660: streaming, no shuffle)), configured
with slots (data_feed.proto:17-27) and consumed by
`Executor.train_from_dataset` (executor.py:1098).

Parsing the MultiSlot text files on a thread pool, the shuffles and the
batching are C++ (the port's native/src/datafeed.cc, built by
`paddle_tpu_torch.native`), as in the reference (data_feed.cc,
data_set.cc). A batch is a feed dict:

* dense slot  -> float32 [B, dim]
* sparse slot -> int64 ids padded to the batch's longest row [B, L] with
  `pad_id` (default 0), plus "<name>.lens" int64 [B]: the LoD contract
  (lod_tensor.h:52) made dense at the data boundary. L is rounded up to
  a length bucket (`len_buckets`), so a captured step sees few shapes.

Iterating a dataset yields numpy arrays; `batches(device)` yields
tensors on a device (pinned host memory and a non-blocking copy on the
card), which is what `Executor.train_from_dataset` feeds.
"""
import numpy as np

from paddle_tpu_torch.core.enforce import enforce


class DatasetBase:
    def __init__(self):
        self._slots = []          # (name, kind, dim)
        self._files = []
        self._batch_size = 1
        self._threads = 4
        self._pad_id = 0
        self._len_buckets = (1, 8, 16, 32, 64, 128)
        self._native = None
        self._drop_last = False

    # -- reference config surface ------------------------------------
    def set_batch_size(self, bs):
        self._batch_size = int(bs)

    def set_thread(self, n):
        self._threads = int(n)

    def set_filelist(self, files):
        self._files = list(files)
        if self._native is not None:
            self._native.set_filelist(self._files)

    def set_pad_id(self, pad_id):
        self._pad_id = int(pad_id)

    def set_use_var(self, var_list):
        """Derive slots from program variables (set_use_var parity): a var
        with lod_level>0 is a ragged sparse slot; otherwise dense with
        dim = prod(shape[1:])."""
        self._slots = []
        for v in var_list:
            desc = getattr(v, "desc", v)
            if getattr(desc, "lod_level", 0) > 0:
                self._slots.append((desc.name, "sparse", 0))
            else:
                shape = desc.shape or (1,)
                dim = 1
                for d in shape[1:]:
                    dim *= max(int(d), 1)
                self._slots.append((desc.name, "dense", dim))

    def set_slots(self, slots):
        """Direct slot config: list of (name, "dense"|"sparse", dim)."""
        self._slots = list(slots)

    def _ensure_native(self):
        if self._native is None:
            enforce(self._slots, "dataset has no slots: call set_use_var "
                    "or set_slots first")
            from paddle_tpu_torch.native import NativeDataset
            self._native = NativeDataset(self._slots)
            self._native.set_filelist(self._files)
        return self._native

    def _pad_len(self, n):
        for b in self._len_buckets:
            if n <= b:
                return b
        return n

    def _to_feed(self, raw, batch_rows):
        feed = {}
        for name, kind, _dim in self._slots:
            if kind == "dense":
                feed[name] = raw[name]
            else:
                ids, lod = raw[name]
                lens = np.diff(lod).astype(np.int64)
                L = self._pad_len(int(lens.max()) if len(lens) else 1)
                padded = np.full((batch_rows, L), self._pad_id, np.int64)
                for r in range(batch_rows):
                    row = ids[lod[r]:lod[r + 1]]
                    padded[r, :len(row)] = row
                feed[name] = padded
                feed[name + ".lens"] = lens
        return feed

    def _iter_loaded(self):
        nat = self._ensure_native()
        for raw in nat.batches(self._batch_size, self._drop_last):
            first = self._slots[0]
            rows = (raw[first[0]].shape[0] if first[1] == "dense"
                    else len(raw[first[0]][1]) - 1)
            yield self._to_feed(raw, rows)

    def batches(self, device):
        """The batches as feed dicts of tensors on `device` (a
        torch.device; on the card through pinned host memory). The
        copies hold the process's capture gate shared, so a prefetch
        thread's pinned allocations and copies never overlap another
        thread's CUDA-graph capture (which they would invalidate)."""
        import torch
        from paddle_tpu_torch.observability.profile import capture_gate
        pin = device.type == "cuda"
        for feed in iter(self):
            out = {}
            with capture_gate().shared():
                for k, v in feed.items():
                    t = torch.from_numpy(np.ascontiguousarray(v))
                    if pin:
                        t = t.pin_memory()
                    out[k] = t.to(device, non_blocking=pin)
            yield out


class InMemoryDataset(DatasetBase):
    """fluid.InMemoryDataset (dataset.py:276): load once, shuffle in
    memory, iterate many epochs."""

    def load_into_memory(self):
        nat = self._ensure_native()
        nat.load_into_memory(self._threads)

    def local_shuffle(self, seed=0):
        self._ensure_native().local_shuffle(seed)

    def global_shuffle(self, fleet=None, seed=0):
        """With a fleet handle, every trainer shuffles with the SHARED seed
        then keeps its hash shard (reference data_set.cc GlobalShuffle
        redistribution semantics)."""
        nat = self._ensure_native()
        if fleet is not None:
            nat.set_trainer(fleet.worker_index(), fleet.worker_num())
        nat.global_shuffle(seed)

    def release_memory(self):
        if self._native is not None:
            self._native.release_memory()

    def get_memory_data_size(self):
        return self._ensure_native().size()

    def __iter__(self):
        return self._iter_loaded()


class QueueDataset(DatasetBase):
    """fluid.QueueDataset (dataset.py:660): streaming — each epoch re-reads
    the file list; no shuffle ops allowed."""

    def local_shuffle(self, *a, **k):
        raise RuntimeError("QueueDataset does not support local_shuffle "
                           "(reference dataset.py:713)")

    def global_shuffle(self, *a, **k):
        raise RuntimeError("QueueDataset does not support global_shuffle "
                           "(reference dataset.py:723)")

    def __iter__(self):
        # streaming parity: (re)load then drain; the native feed is
        # already multithreaded, so one-shot load ~ pipelined read
        nat = self._ensure_native()
        nat.load_into_memory(self._threads)
        try:
            yield from self._iter_loaded()
        finally:
            nat.release_memory()  # also on early break (GeneratorExit)


class DatasetFactory:
    """fluid.DatasetFactory parity (dataset.py:29)."""

    def create_dataset(self, datafeed_class="QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        raise ValueError(f"unknown dataset class {datafeed_class}")
