"""The port's compile cache (core/compile_cache.py): signature entries and
warm-start manifests.

A manifest round trip; `warm_start` capturing every listed signature on
the wrapper that owns its token (a "hit") and a second engine that
warm-starts from the first one's manifest capturing nothing on traffic
(the capture itself stubbed, as tests/test_torch_capture_dispatch.py
stubs it); a clean miss, with its reason, on a truncated entry, a bad
CRC, another format and another device stamp; keep-last-N `gc`; and the
pathology ledger of slow captures.
"""
import contextlib
import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import compile_cache as cc
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.observability import profile as prof
from paddle_tpu_torch.ops import generation as tgen

SIG = (("tokens", (2, 8), "int32"), ("active", (2,), "bool"))


@pytest.fixture
def cache(tmp_path):
    flags.set_flag("compile_cache_dir", str(tmp_path / "cache"))
    cc.reset_compile_cache()
    prof.reset_profile()
    yield cc.compile_cache()
    flags.set_flag("compile_cache_dir", "")
    cc.reset_compile_cache()
    prof.reset_profile()


def _store(c, token="tok", sig=SIG, statics=(("bucket", 8),), compile_s=0.1,
           key="rung[bucket=8]", scope="eng1"):
    kh = c.key_for(token, tuple((s, d) for _, s, d in sig), statics)
    event, reason = c.store(kh, token, sig, statics, len(sig), compile_s,
                            component="generation", key=key, scope=scope)
    assert (event, reason) == ("store", None)
    return kh


class _Wrapper:
    """A stand-in rung: records the entries warm_start hands it."""

    def __init__(self, token):
        self.cache_token = token
        self.component = "generation"
        self.scope = "eng2"
        self.warmed = []

    def warm(self, meta, load_s=0.0):
        self.warmed.append(meta)
        return True


def test_manifest_round_trip_and_warm_start_hits(cache):
    khs = [_store(cache, statics=(("bucket", b),), key=f"r[bucket={b}]")
           for b in (8, 16, 32)]
    other = _store(cache, token="other", key="o", scope="eng9")
    assert cache.write_manifest("ladder", scope="eng1") == 3
    doc = cache.load_manifest("ladder")
    assert sorted(e["key_hash"] for e in doc["entries"]) == sorted(khs)
    assert other not in {e["key_hash"] for e in doc["entries"]}
    w = _Wrapper("tok")
    rep = cache.warm_start("ladder", [w, _Wrapper("unrelated")])
    assert rep["found"] and rep["requested"] == rep["loaded"] == 3
    assert rep["captured"] == 3
    assert sorted(m["static_kw"]["bucket"] for m in w.warmed) == [8, 16, 32]
    assert w.warmed[0]["signature"][0] == ["tokens", [2, 8], "int32"]
    assert len(cache.events(event="hit", scope="eng2")) == 3
    assert cache.warm_start("absent", [w])["found"] is False
    st = cache.stats()
    assert st["entries"] == 4 and st["manifests"] == ["ladder"]
    assert st["events"]["store"] == 4 and st["events"]["hit"] == 3


@pytest.mark.parametrize("damage,reason", [
    ("truncate", "truncated:entry"), ("flip", "crc_mismatch:entry"),
    ("format", "format_mismatch"), ("header", "truncated:header"),
    ("stamp", "device_stamp:device_kind"), ("torch", "version:torch"),
    ("delete", "absent")])
def test_damaged_entries_are_clean_misses(cache, damage, reason):
    kh = _store(cache)
    cache.write_manifest("ladder", scope="eng1")
    path = cache._entry_path(kh)
    head, body = open(path, "rb").read().split(b"\n", 1)
    if damage == "truncate":
        body = body[:-7]
    elif damage == "flip":
        body = body.replace(b'"compile_s": 0.1', b'"compile_s": 0.2')
    elif damage == "header":
        head = head[:5]
    elif damage in ("format", "stamp", "torch"):
        meta = json.loads(body)
        hdr = json.loads(head)
        if damage == "format":
            hdr["format"] = 99
        else:
            field = "device_kind" if damage == "stamp" else "torch"
            meta["stamp"][field] = "another"
            body = json.dumps(meta, sort_keys=True).encode()
            hdr.update(size=len(body), crc32=__import__("zlib").crc32(body))
        head = json.dumps(hdr).encode()
    if damage == "delete":
        os.remove(path)
    else:
        with open(path, "wb") as f:
            f.write(head + b"\n" + body)
    fresh = cc.CompileCache(cache.directory)       # nothing in memory
    assert fresh.lookup(kh) == (None, 0.0, reason)
    w = _Wrapper("tok")
    rep = fresh.warm_start("ladder", [w])
    assert rep["requested"] == 1 and rep["loaded"] == 0 and not w.warmed
    assert fresh.events(event="miss")[0]["reason"] == reason


def test_keep_last_n_gc(cache, tmp_path):
    c = cc.CompileCache(str(tmp_path / "gc"), keep=8)
    khs = []
    for i in range(5):
        khs.append(_store(c, statics=(("bucket", i),), key=f"k{i}"))
        os.utime(c._entry_path(khs[-1]), (1000 + i, 1000 + i))
    c._keep = 3
    assert c.gc() == 2
    assert c.entries_on_disk() == sorted(khs[2:])
    assert c.lookup(khs[0])[0] is None
    assert c.lookup(khs[4])[0]["key"] == "k4"


def test_slow_captures_are_flagged(cache):
    flags.set_flag("compile_cache_slow_compile_s", 1.0)
    try:
        slow = _store(cache, compile_s=2.5, key="slow")
        fast = _store(cache, statics=(("bucket", 16),), compile_s=0.5)
    finally:
        flags.set_flag("compile_cache_slow_compile_s", 10.0)
    pat = cache.pathologies()
    assert slow in pat and fast not in pat
    assert pat[slow]["compile_s"] == 2.5 and pat[slow]["key"] == "slow"
    os.remove(cache._entry_path(slow))
    cache._loaded.clear()
    cache.write_manifest("m", entries=[{"key_hash": slow,
                                        "component": "generation",
                                        "key": "slow"}])
    cache.warm_start("m", [_Wrapper("tok")])
    assert [e["event"] for e in cache.events()
            if e["key_hash"] == slow][-2:] == ["miss", "flagged"]
    assert cache.stats()["flagged_pathologies"] == 1


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _Stream:
    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass


@pytest.fixture
def stub_capture(monkeypatch):
    """The capture's CUDA calls stubbed: CPU tensors take the capture
    path (the body's Python runs at warm-up and at capture)."""
    monkeypatch.setattr(prof, "_captures_on",
                        lambda device: not prof.capture_disabled())
    monkeypatch.setattr(prof, "_capture_streams", {})
    for name, value in (
            ("CUDAGraph", _Graph),
            ("graph", lambda g, pool=None, stream=None:
             contextlib.nullcontext()),
            ("graph_pool_handle", lambda: None),
            ("Stream", lambda device=None: _Stream()),
            ("current_stream", lambda device=None: _Stream()),
            ("stream", lambda s: contextlib.nullcontext()),
            ("memory_allocated", lambda device=None: 0),
            ("max_memory_allocated", lambda device=None: 0),
            ("reset_peak_memory_stats", lambda device=None: None),
            ("memory_snapshot", lambda: [])):
        monkeypatch.setattr(torch.cuda, name, value)


@pytest.mark.parametrize("paged", [False, True])
def test_second_engine_warm_starts_from_the_manifest(cache, stub_capture,
                                                     paged):
    model = tgen.TinyDecoderLM(tgen.LMConfig(), device="cpu").init_params(0)

    def make():
        if paged:
            return tgen.PagedDecodeEngine(model, 2, 32, spec_k=2,
                                          kv_dtype="int8", device="cpu")
        return tgen.DecodeEngine(model, 2, 32, device="cpu")

    led = prof.compile_ledger()
    first = make()
    rep = first.warmup()
    assert rep["warm_start"]["found"] is False
    n = len(first.buckets) + (2 if paged else 1)
    stored = led.cache_entries(event="store", scope=first.ledger_scope)
    assert len(stored) == n
    second = make()
    assert second.cache_token == first.cache_token
    rep = second.warmup()["warm_start"]
    assert rep["requested"] == rep["loaded"] == rep["captured"] == n
    hits = led.entries(scope=second.ledger_scope)
    assert len(hits) == n and all(r.cache_hit for r in hits)
    assert not led.compile_events(scope=second.ledger_scope)
    # traffic captures nothing: every rung is already a graph
    state = second.init_state()
    prompt = np.arange(1, 6, dtype=np.int32)
    if paged:
        second.admit(state, 0, prompt, total_len=12)
        second.step(state, np.zeros(2, np.int32), np.ones(2, bool))
    else:
        second.prefill(state, 0, prompt)
        second.step(state, np.zeros(2, np.int32), np.ones(2, bool))
    assert len(led.entries(scope=second.ledger_scope)) == n
