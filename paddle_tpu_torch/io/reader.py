"""Reader decorators and DataFeeder.

Counterpart of paddle_tpu/io/reader.py (the reference's
python/paddle/reader/decorator.py and data_feeder.py): a reader is a
function that returns an iterator of samples; the decorators wrap one
reader in another. `DataFeeder.feed` turns a list of samples into the
feed dict `Executor.run` takes.
"""
import queue
import random
import threading

import numpy as np

__all__ = ["map_readers", "shuffle", "batch", "buffered", "cache",
           "DataFeeder"]


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


class DataFeeder:
    """fluid.DataFeeder: a list of samples -> {feed name: stacked array}."""

    def __init__(self, feed_list, place=None, program=None):
        self.feed_names = [v.name for v in feed_list]

    def feed(self, iterable):
        cols = list(zip(*iterable))
        return {n: np.stack([np.asarray(v) for v in col])
                for n, col in zip(self.feed_names, cols)}
