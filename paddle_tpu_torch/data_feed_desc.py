"""fluid.data_feed_desc: the slot schema of the C++ MultiSlot data feed.

Counterpart of paddle_tpu/data_feed_desc.py (the reference's
data_feed_desc.py:21). Its consumer is `AsyncExecutor.run` (through
io.fluid_dataset and the native data feed); DataFeedDesc keeps the
proto-text construction surface for scripts that build it by hand."""
from paddle_tpu_torch.core.enforce import enforce


class DataFeedDesc:
    """Constructed from the reference's proto-text (name/type/dense/dim
    fields) or programmatically; exposes the slot list the datasets
    consume."""

    def __init__(self, proto_string=""):
        self.proto_desc = {"name": "MultiSlotDataFeed", "batch_size": 32,
                           "slots": []}
        if proto_string:
            self._parse(proto_string)

    def _parse(self, text):
        """Minimal proto-text reader for the multi_slot_desc blocks the
        reference emits (data_feed.proto:17-27)."""
        cur = None
        for raw in text.splitlines():
            stripped = raw.strip()
            if stripped == "}":
                cur = None  # block closed: top-level fields must not
                continue    # overwrite the last slot
            line = stripped.rstrip("{").strip()
            if line.startswith("slots") or line.startswith("variables"):
                cur = {"name": "", "type": "float32", "is_dense": False,
                       "is_used": True, "shape": []}
                self.proto_desc["slots"].append(cur)
            elif ":" in line:
                k, v = [t.strip() for t in line.split(":", 1)]
                v = v.strip('"')
                if k == "batch_size":
                    self.proto_desc["batch_size"] = int(v)
                elif cur is None and k == "name":
                    self.proto_desc["name"] = v
                elif cur is not None and k == "name":
                    cur["name"] = v
                elif cur is not None and k == "type":
                    cur["type"] = v
                elif cur is not None and k == "is_dense":
                    cur["is_dense"] = v.lower() == "true"
                elif cur is not None and k == "is_used":
                    cur["is_used"] = v.lower() == "true"
                elif cur is not None and k == "shape":
                    cur["shape"].append(int(v))

    # reference mutator surface
    def set_batch_size(self, batch_size):
        enforce(batch_size > 0, "batch_size must be positive")
        self.proto_desc["batch_size"] = int(batch_size)

    def set_dense_slots(self, dense_slots_name):
        for s in self.proto_desc["slots"]:
            if s["name"] in dense_slots_name:
                s["is_dense"] = True

    def set_use_slots(self, use_slots_name):
        for s in self.proto_desc["slots"]:
            s["is_used"] = s["name"] in use_slots_name

    def desc(self):
        return dict(self.proto_desc)

    def __str__(self):
        return str(self.desc())
