"""Reader decorators, DataLoader and DataFeeder.

Counterpart of paddle_tpu/io/reader.py (the reference's
python/paddle/reader/decorator.py, fluid.io.DataLoader.from_generator of
reader.py:73 and data_feeder.py): a reader is a function that returns an
iterator of samples; the decorators wrap one reader in another.
`DataLoader` iterates feed dicts with background prefetching (the
BufferedReader analogue); `DataFeeder.feed` turns a list of samples into
the feed dict `Executor.run` takes.
"""
import itertools
import queue
import random
import threading

import numpy as np

__all__ = ["map_readers", "shuffle", "batch", "buffered", "cache", "chain",
           "compose", "firstn", "xmap_readers", "DataLoader", "DataFeeder"]


def map_readers(func, *readers):
    def reader():
        for vals in zip(*[r() for r in readers]):
            yield func(*vals)
    return reader


def shuffle(reader, buf_size):
    """Shuffle within windows of `buf_size` samples (Python's `random`)."""
    def shuffled():
        buf = []
        for s in reader():
            buf.append(s)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                yield from buf
                buf = []
        random.shuffle(buf)
        yield from buf
    return shuffled


def batch(reader, batch_size, drop_last=True):
    def batched():
        b = []
        for s in reader():
            b.append(s)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return batched


def buffered(reader, size):
    """Prefetch up to `size` samples on a daemon thread."""
    def buffered_reader():
        q = queue.Queue(maxsize=size)
        end = object()

        def worker():
            try:
                for s in reader():
                    q.put(s)
            finally:
                q.put(end)

        t = threading.Thread(  # thread-ok: daemon tied to the generator
            target=worker, daemon=True)
        t.start()
        while True:
            s = q.get()
            if s is end:
                break
            yield s
    return buffered_reader


def cache(reader):
    """Read once, then replay the samples from memory."""
    data = []

    def cached():
        if not data:
            for s in reader():
                data.append(s)
                yield s
        else:
            yield from data
    return cached


def chain(*readers):
    """The readers' samples one reader after another."""
    def chained():
        for r in readers:
            yield from r()
    return chained


def compose(*readers):
    """Zip the readers; a tuple sample is spliced into the output tuple."""
    def composed():
        for vals in zip(*[r() for r in readers]):
            out = []
            for v in vals:
                if isinstance(v, tuple):
                    out.extend(v)
                else:
                    out.append(v)
            yield tuple(out)
    return composed


def firstn(reader, n):
    def limited():
        yield from itertools.islice(reader(), n)
    return limited


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """`mapper` over the samples on `process_num` threads (the reference
    uses a thread pool too). `order` is accepted and ignored, as in the
    JAX package: with more than one thread the mapped samples come in
    completion order, so only their multiset is defined."""
    def xreader():
        src_q = queue.Queue(buffer_size)
        dst_q = queue.Queue(buffer_size)
        end = object()

        def feeder():
            for s in reader():
                src_q.put(s)
            for _ in range(process_num):
                src_q.put(end)

        def worker():
            while True:
                s = src_q.get()
                if s is end:
                    dst_q.put(end)
                    break
                dst_q.put(mapper(s))

        threading.Thread(target=feeder, daemon=True).start()  # thread-ok: daemon drains to the end sentinel
        for _ in range(process_num):
            threading.Thread(target=worker, daemon=True).start()  # thread-ok: daemon drains to the end sentinel
        finished = 0
        while finished < process_num:
            s = dst_q.get()
            if s is end:
                finished += 1
            else:
                yield s
    return xreader


class DataLoader:
    """fluid.io.DataLoader: iterating yields feed dicts {name: batched
    ndarray} ready for `Executor.run(feed=...)`, prefetched `capacity`
    batches ahead on a background thread.

    `from_generator(feed_list=...)` takes the reference's capacity /
    iterable arguments; `set_sample_generator` batches a sample reader,
    `set_sample_list_generator` takes lists of samples and
    `set_batch_generator` already-batched arrays (or feed dicts)."""

    def __init__(self, feed_names, capacity=16):
        self.feed_names = feed_names
        self.capacity = capacity
        self._batch_reader = None

    @classmethod
    def from_generator(cls, feed_list=None, capacity=16, iterable=True,
                       use_double_buffer=True, return_list=False):
        names = [v.name for v in (feed_list or [])]
        return cls(names, capacity)

    def set_sample_generator(self, reader, batch_size, drop_last=True,
                             places=None):
        self._batch_reader = batch(reader, batch_size, drop_last)
        return self

    def set_sample_list_generator(self, reader, places=None):
        self._batch_reader = reader
        return self

    def set_batch_generator(self, reader, places=None):
        self._batch_reader = reader
        return self

    def __iter__(self):
        rdr = buffered(self._batch_reader, self.capacity)
        for samples in rdr():
            if isinstance(samples, dict):
                yield samples
                continue
            if isinstance(samples, (list, tuple)) and samples and \
                    isinstance(samples[0], (list, tuple)):
                cols = list(zip(*samples))
                arrays = [np.stack([np.asarray(v) for v in col])
                          for col in cols]
            else:   # already-batched arrays
                arrays = [np.asarray(s) for s in samples]
            yield dict(zip(self.feed_names, arrays))


class DataFeeder:
    """fluid.DataFeeder: a list of samples -> {feed name: stacked array}."""

    def __init__(self, feed_list, place=None, program=None):
        self.feed_names = [v.name for v in feed_list]

    def feed(self, iterable):
        cols = list(zip(*iterable))
        return {n: np.stack([np.asarray(v) for v in col])
                for n, col in zip(self.feed_names, cols)}
