"""Data input: reader decorators, DataFeeder and the synthetic datasets.

Counterpart of paddle_tpu/io/ for what static training's book tests
read: `reader.py`, `dataset.py`'s synthetic generators and
`dataset_ext.py`'s conll05, and the eager models' ragged batching
(`ragged.py`). The DataLoader, the other Fluid datasets and checkpoints
are later slices (ROADMAP Queue 1 item 16). numpy and the standard
library only.
"""
from paddle_tpu_torch.io.reader import (  # noqa: F401
    DataFeeder, batch, buffered, cache, map_readers, shuffle,
)
from paddle_tpu_torch.io import dataset  # noqa: F401
from paddle_tpu_torch.io import dataset_ext  # noqa: F401,E402
from paddle_tpu_torch.io import ragged  # noqa: F401,E402
