"""fluid.data_feeder module path — re-export of io/reader.py's
DataFeeder."""
from paddle_tpu_torch.io.reader import DataFeeder  # noqa: F401
