"""Data input: reader decorators, DataLoader, DataFeeder, the datasets
and the file systems.

Counterpart of paddle_tpu/io/: `reader.py` (the decorators and
DataLoader), `dataset.py` and `dataset_ext.py` (the synthetic generators
and the real-file readers, movielens, conll05, flowers, voc2012, the
md5-cached `download`), `fs.py` (file://, mem:// and registered
schemes), the eager models' ragged batching (`ragged.py`), and the
native data feed's datasets (`fluid_dataset.py`: DatasetFactory,
InMemoryDataset, QueueDataset). Checkpoints (`checkpoint.py`) are a
later slice (ROADMAP Queue 1 item 9).
"""
from paddle_tpu_torch.io.reader import (  # noqa: F401
    DataFeeder, DataLoader, batch, buffered, cache, chain, compose, firstn,
    map_readers, shuffle, xmap_readers,
)
from paddle_tpu_torch.io import fs  # noqa: F401
from paddle_tpu_torch.io import dataset  # noqa: F401
from paddle_tpu_torch.io import dataset_ext  # noqa: F401,E402
from paddle_tpu_torch.io import ragged  # noqa: F401,E402
from paddle_tpu_torch.io.fluid_dataset import (  # noqa: F401,E402
    DatasetFactory, InMemoryDataset, QueueDataset,
)
