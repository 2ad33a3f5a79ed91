"""AsyncExecutor — fluid's dataset-training entry point of old.

Counterpart of paddle_tpu/async_executor.py (the reference's
paddle/fluid/framework/async_executor.h:62: RunFromFile over a
DataFeedDesc and a file list with N worker threads, and the fleet hooks
InitServer / InitWorker / StopServer). The reference runs
ExecutorThreadWorkers, each over its shard of the file list; here one
stream owns the card, so the worker pool is the C++ data feed's
thread_num readers plus the Executor's prefetch thread: the same
observable semantics (dataset-driven epochs, fetches reported). New
code uses `Executor.train_from_dataset`.
"""
import numpy as np

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.io.fluid_dataset import DatasetFactory


class AsyncExecutor:
    def __init__(self, place=None, run_mode=""):
        """`place`: the Executor's device (None means the card)."""
        self.executor = Executor(place)
        self._server = None
        self._client = None

    # -- the RunFromFile surface (async_executor.h:66) -----------------
    def run(self, program, data_feed, filelist, thread_num, fetch,
            mode="", debug=False):
        """Train `program` over `filelist` described by `data_feed`
        (a DataFeedDesc); `thread_num` sizes the C++ reader pool (the
        reference's worker-thread count). Returns the per-batch fetch
        results."""
        enforce(thread_num >= 1, "thread_num must be >= 1, got %s",
                thread_num)
        # ALL slots stay in the dataset — the native MultiSlot parser is
        # positional (datafeed.cc), so dropping an unused slot here would
        # shift every later column; unused slots are parsed then stripped
        # from the feed below (the reference's is_used semantics)
        slots, unused = [], set()
        for s in data_feed.proto_desc.get("slots", []):
            dim = 1
            for d in s.get("shape", []) or [1]:
                dim *= max(int(d), 1)
            slots.append((s["name"],
                          "dense" if s.get("is_dense") else "sparse",
                          dim))
            if not s.get("is_used", True):
                unused.add(s["name"])
        enforce(slots, "DataFeedDesc has no slots")
        enforce(len(unused) < len(slots), "DataFeedDesc has no used slots")
        dataset = DatasetFactory().create_dataset("QueueDataset")
        dataset.set_slots(slots)
        dataset.set_batch_size(data_feed.proto_desc.get("batch_size", 32))
        dataset.set_thread(int(thread_num))
        dataset.set_filelist(list(filelist))
        if unused:
            class _Used:
                def __iter__(_s):
                    for batch in dataset:
                        yield {k: v for k, v in batch.items()
                               if k.split(".")[0] not in unused}
            feed_src = _Used()
        else:
            feed_src = dataset

        fetch_list = [f if isinstance(f, str) else f.name
                      for f in (fetch or [])]
        cb = None
        if debug:
            def cb(res):  # the reference's per-batch debug print
                print("AsyncExecutor fetch:",
                      [np.asarray(r).ravel()[:4] for r in res])
        return self.executor.train_from_dataset(
            program, feed_src, fetch_list=fetch_list, fetch_callback=cb)

    # -- fleet hooks (async_executor.h:74-82) --------------------------
    def init_server(self, dist_desc, index=0):
        """Start the native parameter server (InitServer parity). The
        reference's dist_desc proto collapses to TableConfig kwargs:
        pass a list of paddle_tpu_torch.ps.TableConfig (or dicts)."""
        from paddle_tpu_torch import ps
        tables = []
        for tc in (dist_desc or []):
            tables.append(tc if isinstance(tc, ps.TableConfig)
                          else ps.TableConfig(**tc))
        self._server = ps.Server(tables=tables)
        self._server.start()
        return self._server.port

    def init_worker(self, dist_desc, endpoints=None, index=0,
                    node_num=None):
        """Connect a PS client (InitWorker parity)."""
        from paddle_tpu_torch import ps
        enforce(endpoints, "init_worker needs server endpoints")
        self._client = ps.Client(endpoints)
        self._client.connect()
        return self._client

    def stop(self):
        """StopServer parity."""
        if self._client is not None:
            try:
                self._client.stop_servers()
            except Exception:
                pass
            self._client = None
        if self._server is not None:
            self._server.stop()
            self._server = None

    stop_server = stop
