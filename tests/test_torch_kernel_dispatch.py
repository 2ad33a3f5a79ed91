"""The host code of K5, of K6's and K7's two routes and of K8's split-K,
on the CPU.

`_build.load_library` is replaced by a recording stub (as in
tests/test_torch_flash_dispatch.py), so the launch helpers run with CPU
tensors: each records the C function it called and its arguments and
returns 0. That checks, without a card, that K5 and K6's decode route
(decode ticks and chunks below PAGED_TC_MIN_C) are one call of the
one-launch CUDA-core kernel that allocates nothing but its output (its
key ranges, f32_decode_split_count's, merge in a thread-block cluster:
no partials, no workspace); that K6's longer chunks go to its
tensor-core kernel with the partials and split count it needs;
that K7 sends decode ticks (C = 1) to its one-launch decode kernel with
a zeroed int32 workspace of arrival counters and records (reused from
call to call, dropped after a refused launch) and the verify and
prefill chunks to its tensor-core kernel with partial buffers; that K8
in int8 mode asks for the split count `k8_split_count` gives and hands
the kernel a zeroed int32 workspace of M * N sums plus one arrival
counter per output tile, reused from call to call (the kernel leaves it
zero); that every call has the arity `_build.SIGNATURES` declares; and
that those declarations match the C prototypes in csrc/. The kernels'
arithmetic is held against the plain versions on the card
(tests/test_torch_kernels_cuda.py).
"""
import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import decode_attention as tda
from paddle_tpu_torch.ops.kernels import quantized_matmul as tk8

CSRC = pathlib.Path(_build.__file__).resolve().parents[2] / "csrc"


class _Recorder:
    """Stands in for the kernel library: every ptt_* call is recorded as
    (name, args) and handed to `hook`, and returns 0."""

    def __init__(self, hook=None):
        self.calls = []
        self.hook = hook

    def __getattr__(self, name):
        if not name.startswith("ptt_"):
            raise AttributeError(name)

        def fn(*args):
            self.calls.append((name, args))
            if self.hook is not None:
                self.hook(name, args)
            return 0
        return fn


@pytest.fixture
def stub(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(tda, "_stream", lambda device: 0)
    monkeypatch.setattr(tk8, "_stream", lambda device: 0)
    monkeypatch.setattr(tk8, "_workspaces", {})
    monkeypatch.setattr(tk8, "_wo_workspaces", {})
    monkeypatch.setattr(tda, "_workspaces", {})
    tda.reset_launch_counts()
    tk8.reset_launch_counts()
    yield lib
    tda.reset_launch_counts()
    tk8.reset_launch_counts()


# ---------------------------------------------------------------------
# K7: decode route and prefill route
# ---------------------------------------------------------------------

def _k7_args(b, c, n=2, d=64, bs=8, m=16):
    rng = np.random.RandomState(c)
    nb = b * m + 1
    q = torch.from_numpy(rng.randn(b, c, n, d).astype(np.float32))
    kq = torch.from_numpy(rng.randint(-127, 128, size=(nb, bs, n, d))
                          .astype(np.int8))
    ks = torch.rand(nb, bs)
    tables = torch.arange(1, nb, dtype=torch.int32).reshape(b, m)
    lengths = torch.zeros(b, dtype=torch.int32)
    return q, kq, kq.clone(), ks, ks.clone(), tables, lengths


_K7_KERNELS = {"decode": "ptt_quantized_paged_decode_attention",
               "prefill": "ptt_quantized_paged_prefill_attention"}


@pytest.mark.parametrize("c,route", [(1, "decode"), (2, "prefill"),
                                     (5, "prefill"), (8, "prefill"),
                                     (16, "prefill"), (512, "prefill")])
def test_k7_route_by_chunk(stub, c, route):
    """Decode ticks (C = 1) stay on the decode kernel; every verify chunk
    (spec_k + 1 >= 2) and every prefill bucket (8 .. max_len) take the
    tensor-core kernel."""
    tda._launch_quantized(*_k7_args(1, c))
    assert [name for name, _ in stub.calls] == [_K7_KERNELS[route]]


@pytest.mark.parametrize("b,c", [(1, 1), (8, 1), (8, 5), (8, 16),
                                 (1, 512), (8, 512)])
def test_k7_launch_hands_each_kernel_its_partials(stub, monkeypatch, b, c):
    shapes = []
    real = tda._partials

    def partials(rows, nsplit, d, device):
        shapes.append((rows, nsplit, d))
        return real(rows, nsplit, d, device)

    monkeypatch.setattr(tda, "_partials", partials)
    args = _k7_args(b, c)
    route = "decode" if c == 1 else "prefill"
    out = tda._launch_quantized(*args)
    (name, call), = stub.calls
    assert name == _K7_KERNELS[route]
    assert len(call) == len(_build.SIGNATURES[name])
    n, d, m, bs = args[0].shape[2], args[0].shape[3], 16, 8
    if route == "prefill":   # 64-row tiles, key ranges of >= 64 keys
        nsplit = tda.split_count(b * n * -(-c // 64), m * bs, 64)
        assert shapes == [(b * c * n, nsplit, d)]
    else:                    # one row, one launch: a workspace, no partials
        nsplit = tda.decode_split_count(m * bs, d)
        assert shapes == []
    nsplit_arg = call[-4]
    assert nsplit_arg == nsplit
    # part_m (prefill) or the workspace (decode) only when split
    assert (call[8] is None) == (nsplit == 1)
    first_int = 11 if route == "prefill" else 9
    assert call[first_int:first_int + 7] == (b, c, n, d, b * m + 1, bs, m)
    assert out.shape == (b, c, n, d)
    assert tda.launch_counts["quantized_paged_decode_attention"] == 1
    assert tda.launch_counts["quantized_paged_prefill_attention"] == \
        (route == "prefill")


@pytest.mark.parametrize("blocks,cap,nsplit", [
    (8 * 12, 1024, 4),       # the verify chunk (C = 5, B = 8, N = 12)
    (12, 1024, 16),          # a prefill bucket of <= 64 rows at B = 1
    (8 * 12 * 8, 1024, 1),   # C = 512 at B = 8: the tiles fill the card
    (12, 100, 2),            # never under 64 keys a range
])
def test_k6_chunk_split_count(blocks, cap, nsplit):
    assert tda.chunk_split_count(blocks, cap) == nsplit


@pytest.mark.parametrize("cap,d,nsplit", [
    (1024, 64, 4),      # the main path's decode tick: two steps of 128 keys
    (1024, 32, 2),      # 64 lane groups: 256 keys a step
    (1024, 128, 8),     # 16 lane groups: 64 keys a step
    (256, 64, 1),       # two steps cover the window
    (100000, 64, 16),   # at most _MAX_SPLITS
])
def test_k7_decode_split_count(cap, d, nsplit):
    assert tda.decode_split_count(cap, d) == nsplit


@pytest.mark.parametrize("b,n,d", [(8, 12, 64), (1, 2, 32), (3, 5, 128)])
def test_k7_decode_launch_hands_a_zeroed_workspace(stub, b, n, d):
    """C = 1 with a window that splits: one call of the decode kernel
    with a zeroed int32 workspace of round_up(B * N, 4) arrival counters
    and B * N * nsplit records of D + 4 floats."""
    seen = {}
    nsplit = tda.decode_split_count(128 * 8, d)
    size = -(-(b * n) // 4) * 4 + b * n * nsplit * (d + 4)

    def hook(name, args):
        words = (ctypes.c_int32 * size).from_address(args[8])
        seen["zeroed"] = not any(words)

    stub.hook = hook
    args = _k7_args(b, 1, n=n, d=d, m=128)
    tda._launch_quantized(*args)
    (name, call), = stub.calls
    assert name == "ptt_quantized_paged_decode_attention"
    assert call[-4] == nsplit > 1 and seen["zeroed"]
    (work,) = tda._workspaces.values()
    assert work.dtype == torch.int32 and work.numel() == size


def test_k7_decode_calls_reuse_the_workspace(stub):
    """The kernel leaves its workspace zero, so the wrapper zeroes one
    only when it allocates or grows it: a smaller call reuses it."""
    ptrs = []
    stub.hook = lambda name, args: ptrs.append(args[8])
    tda._launch_quantized(*_k7_args(8, 1, n=12, m=128))
    tda._launch_quantized(*_k7_args(1, 1, n=12, m=128))    # fits
    tda._launch_quantized(*_k7_args(8, 1, n=12, m=128))
    assert len(set(ptrs)) == 1 and len(tda._workspaces) == 1
    tda._launch_quantized(*_k7_args(16, 1, n=12, m=128))   # grows
    assert ptrs[-1] != ptrs[0]
    assert tda._workspaces[(torch.device("cpu"), 0)].numel() >= \
        16 * 12 * (1 + 4 * 68)
    tda._launch_quantized(*_k7_args(1, 1, n=2, m=16))      # no split
    assert ptrs[-1] is None


def test_k7_decode_failed_launch_drops_the_workspace(monkeypatch, stub):
    """After a refused launch the workspace may not be zero: the next
    call gets a fresh one."""
    tda._launch_quantized(*_k7_args(8, 1, n=12, m=128))
    assert len(tda._workspaces) == 1
    monkeypatch.setattr(_Recorder, "__getattr__",
                        lambda self, name: lambda *args: 1)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        tda._launch_quantized(*_k7_args(8, 1, n=12, m=128))
    assert tda._workspaces == {}
    assert tda.launch_counts["quantized_paged_decode_attention"] == 1


def test_k7_prefill_splits_fill_the_card_at_batch_one():
    """The main path's prefill (B = 1, C = 512, N = 12): 8 row tiles x 12
    heads = 96 blocks, so the key ranges split; at B = 8 the tiles alone
    fill the card."""
    assert tda.split_count(1 * 12 * 8, 1024, 64) == 6
    assert tda.split_count(8 * 12 * 8, 1024, 64) == 1
    assert tda.split_count(1, 100, 64) == 2


# ---------------------------------------------------------------------
# K6: decode route and chunk route
# ---------------------------------------------------------------------

_K6_KERNELS = {"decode": "ptt_paged_decode_attention_f32",
               "chunk": "ptt_paged_prefill_attention_f32"}


def _k6_args(b, c, n=2, d=64, bs=8, m=16):
    rng = np.random.RandomState(c)
    nb = b * m + 1
    q = torch.from_numpy(rng.randn(b, c, n, d).astype(np.float32))
    kp = torch.from_numpy(rng.randn(nb, bs, n, d).astype(np.float32))
    tables = torch.arange(1, nb, dtype=torch.int32).reshape(b, m)
    return q, kp, kp.clone(), tables, torch.zeros(b, dtype=torch.int32)


@pytest.mark.parametrize("c,route", [(1, "decode"), (2, "decode"),
                                     (4, "decode"), (5, "decode"),
                                     (8, "chunk"), (64, "chunk"),
                                     (512, "chunk")])
def test_k6_route_by_chunk(stub, monkeypatch, c, route):
    """Decode ticks (C = 1) and chunks shorter than PAGED_TC_MIN_C (the
    verify chunk C = 5 too) stay on the CUDA-core kernel (one launch, no
    partials); every prefill bucket (C >= 8) takes the tensor-core
    kernel, with the partials its 64-row tiles need; both are
    counted."""
    assert tda.PAGED_TC_MIN_C == 8
    shapes = []
    real = tda._partials

    def partials(rows, nsplit, d, device):
        shapes.append((rows, nsplit, d))
        return real(rows, nsplit, d, device)

    monkeypatch.setattr(tda, "_partials", partials)
    b, m, bs = 2, 16, 8
    args = _k6_args(b, c, m=m, bs=bs)
    n, d = args[0].shape[2], args[0].shape[3]
    out = tda._launch_paged(*args)
    (name, call), = stub.calls
    assert name == _K6_KERNELS[route]
    assert len(call) == len(_build.SIGNATURES[name])
    if route == "chunk":
        nsplit = tda.chunk_split_count(b * n * -(-c // 64), m * bs)
        assert call[-3] == nsplit and shapes == [(b * c * n, nsplit, d)]
        assert call[9:16] == (b, c, n, d, b * m + 1, bs, m)
    else:
        nsplit = tda.f32_decode_split_count(m * bs, d)
        assert call[-3] == nsplit and shapes == []
        assert call[6:13] == (b, c, n, d, b * m + 1, bs, m)
    assert out.shape == (b, c, n, d)
    assert tda.launch_counts["paged_decode_attention"] == 1
    assert tda.launch_counts["paged_prefill_attention"] == (route == "chunk")


# ---------------------------------------------------------------------
# K5 and K6's decode route: f32_decode_kernel, one launch
# ---------------------------------------------------------------------

def _k5_args(b, s=1024, n=12, d=64):
    rng = np.random.RandomState(b)
    q = torch.from_numpy(rng.randn(b, n, d).astype(np.float32))
    k = torch.from_numpy(rng.randn(b, s, n, d).astype(np.float32))
    return q, k, k.clone(), torch.full((b,), s // 2, dtype=torch.int32)


def _f32_decode_args(kind, b, c, n=12, d=64, m=128):
    """(launch helper, operands) of K5 (kind "k5", C = 1) or of K6's
    decode route."""
    if kind == "k5":
        return tda._launch_contiguous, _k5_args(b, m * 8, n, d)
    return tda._launch_paged, _k6_args(b, c, n=n, d=d, m=m)


def _f32_decode_call(kind, b, c, **kw):
    fn, args = _f32_decode_args(kind, b, c, **kw)
    return fn(*args)


_F32_CASES = [("k5", 1), ("k6", 1), ("k6", 2), ("k6", 4)]


@pytest.mark.parametrize("cap,d,nsplit", [
    (1024, 64, 4),      # the main path: 4 ranges of 256 keys (128 KB)
    (1024, 32, 2),      # 512 keys a range at D = 32
    (1024, 128, 8),     # 128 keys a range at D = 128
    (300, 64, 2),       # a full range and a partial one
    (256, 64, 1),       # one range is the window
    (100000, 64, 16),   # at most _MAX_SPLITS (a cluster's most): long ranges
])
def test_f32_decode_split_count(cap, d, nsplit):
    assert tda.f32_decode_split_count(cap, d) == nsplit


@pytest.mark.parametrize("kind,c", _F32_CASES)
def test_f32_decode_is_one_call_that_allocates_only_its_output(
        stub, monkeypatch, kind, c):
    """K5 and K6 at C in {1, 2, 4}: exactly one library call each, with
    the split f32_decode_split_count gives, no partial buffer and no
    workspace: the one allocation is the output."""
    monkeypatch.setattr(tda, "_partials", None)   # a call would raise
    launch, args = _f32_decode_args(kind, 8, c)
    allocs = []
    for name in ("empty", "zeros"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _real=real, **k: (
            allocs.append(a), _real(*a, **k))[1])
    out = launch(*args)
    launch(*args)
    monkeypatch.undo()
    assert [name for name, _ in stub.calls] == 2 * [
        "ptt_decode_attention_f32" if kind == "k5"
        else "ptt_paged_decode_attention_f32"]
    for name, call in stub.calls:
        assert len(call) == len(_build.SIGNATURES[name])
        assert call[-3] == tda.f32_decode_split_count(1024, 64) == 4
    assert allocs == 2 * [(tuple(out.shape),)]
    assert tda._workspaces == {}
    assert tda.launch_counts["decode_attention" if kind == "k5"
                             else "paged_decode_attention"] == 2


@pytest.mark.parametrize("kind,c", _F32_CASES)
def test_f32_decode_refused_launch_raises_and_counts_nothing(
        stub, monkeypatch, kind, c):
    """A refused launch is an error (no fallback to the plain version)
    and is not counted."""
    monkeypatch.setattr(_Recorder, "__getattr__",
                        lambda self, name: lambda *args: 1)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        _f32_decode_call(kind, 8, c)
    assert tda.launch_counts == dict.fromkeys(tda.launch_counts, 0)


# ---------------------------------------------------------------------
# K8: split-K and its workspace
# ---------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,tile,splits", [
    (32, 2048, 1000, (32, 64), 8),      # the ResNet-50 fc at batch 32
    (8, 2048, 1000, (32, 64), 8),       # batch 8
    (1, 2048, 1000, (32, 64), 8),       # batch 1
    (4096, 768, 3072, (64, 256), 1),    # 768 tiles fill the card
    (5, 33, 17, (32, 64), 1),           # one k tile
    (130, 257, 129, (64, 256), 2),      # 3 tiles, 5 k tiles
])
def test_k8_split_count(m, k, n, tile, splits):
    assert tk8.k8_tile(m) == tile
    assert tk8.k8_split_count(m, k, n) == splits


@pytest.mark.parametrize("m,k,n", [(32, 2048, 1000), (1, 2048, 1000),
                                   (130, 257, 129), (4096, 64, 3072)])
@pytest.mark.parametrize("return_acc", [False, True])
def test_k8_launch_hands_a_zeroed_workspace(stub, m, k, n, return_acc):
    seen = {}

    def hook(name, args):
        work, splits = args[5], args[10]
        seen.update(splits=splits, work=work)
        if work is not None:
            bm, bn = tk8.k8_tile(m)
            size = m * n + -(-m // bm) * -(-n // bn)
            words = (ctypes.c_int32 * size).from_address(work)
            seen["zeroed"] = not any(words)

    stub.hook = hook
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32))
    w_q = torch.from_numpy(rng.randint(-127, 128, (k, n)).astype(np.int8))
    w_s = torch.rand(n)
    res = tk8._launch(x, w_q, w_s, 0.5, 8, return_acc)
    (name, call), = stub.calls
    assert name == "ptt_quantized_matmul"
    assert len(call) == len(_build.SIGNATURES[name])
    assert call[6:11] == (m, k, n, 1, tk8.k8_split_count(m, k, n))
    assert (call[4] is None) != return_acc
    if seen["splits"] > 1:
        assert seen["zeroed"]
    else:
        assert seen["work"] is None
    out = res[0] if return_acc else res
    assert out.shape == (m, n) and out.dtype == torch.float32
    assert tk8.launch_counts["quantized_matmul"] == 1


def test_k8_split_calls_reuse_the_workspace(stub):
    """The kernel leaves its workspace zero, so the wrapper zeroes one
    only when it allocates or grows it: a smaller call reuses it."""
    rng = np.random.RandomState(1)
    ptrs = []
    stub.hook = lambda name, args: ptrs.append(args[5])

    def call(m, k, n):
        x = torch.from_numpy(rng.randn(m, k).astype(np.float32))
        w_q = torch.ones(k, n, dtype=torch.int8)
        tk8._launch(x, w_q, torch.ones(n), 0.5, 8, False)

    call(32, 2048, 1000)
    call(1, 2048, 1000)      # fits: the same buffer
    call(130, 257, 129)      # fits too
    assert len(set(ptrs)) == 1
    (work,) = tk8._workspaces.values()
    assert work.numel() == 32 * 1000 + 16
    call(64, 2048, 1000)     # 64 x 1000 sums: grows
    assert ptrs[-1] != ptrs[0]
    assert tk8._workspaces[(torch.device("cpu"), 0)].numel() >= 64 * 1000


def test_k8_failed_launch_drops_the_workspace(monkeypatch, stub):
    """After a refused launch the workspace may not be zero: the next
    call gets a fresh one."""
    x = torch.ones(32, 2048)
    w_q = torch.ones(2048, 1000, dtype=torch.int8)
    monkeypatch.setattr(stub, "hook", None)
    monkeypatch.setattr(_Recorder, "__getattr__",
                        lambda self, name: lambda *args: 1)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        tk8._launch(x, w_q, torch.ones(1000), 0.5, 8, False)
    assert tk8._workspaces == {}
    assert tk8.launch_counts["quantized_matmul"] == 0


def test_k8_weight_only_asks_for_no_split(stub):
    """Weight-only mode takes no split where its tiles fill the card (or
    K holds one k tile): no workspace, one launch counted under both
    keys."""
    for m, k, n in [(4096, 768, 3072), (5, 33, 17)]:
        assert tk8.k8_wo_split_count(m, k, n) == 1
        tk8._launch(torch.ones(m, k), torch.ones(k, n, dtype=torch.int8),
                    torch.ones(n), None, 8, False)
    for _, call in stub.calls:
        assert call[9:11] == (0, 1) and call[5] is None
    assert tk8._wo_workspaces == {}
    assert tk8.launch_counts == {"quantized_matmul": 2,
                                 "quantized_matmul_weight_only": 2}


@pytest.mark.parametrize("m,k,n,tile,splits", [
    (32, 2048, 1000, (32, 64), 8),      # the ResNet-50 fc at batch 32
    (8, 2048, 1000, (8, 64), 8),        # batch 8: an n8 tile of x
    (1, 2048, 1000, (8, 64), 8),        # batch 1
    (4096, 768, 3072, (128, 128), 1),   # 768 tiles fill the card
    (5, 33, 17, (8, 64), 1),            # one k tile
    (130, 257, 129, (32, 64), 2),       # 128-row tiles: 4, too few
    (64, 2048, 1000, (64, 64), 8),
    (16, 4096, 8192, (16, 64), 1),      # 128 tiles of 64 columns
    (1, 64, 1000, (8, 64), 1),          # one k tile: no split
])
def test_k8_wo_split_count(m, k, n, tile, splits):
    """The weight-only kernel's tile (rows of x as wgmma's n side, 64
    weight columns a warpgroup; 128 x 128 only where those tiles fill
    the card) and split count, by k8_split_count's rule over its own
    tiles."""
    assert tk8.k8_wo_tile(m, n) == tile
    assert tk8.k8_wo_split_count(m, k, n) == splits


@pytest.mark.parametrize("m,k,n", [(32, 2048, 1000), (1, 2048, 1000),
                                   (130, 257, 129)])
def test_k8_weight_only_hands_a_workspace_with_zero_counters(stub, m, k, n):
    """A split weight-only launch gets its split count and a workspace of
    256 zero arrival counters (more than the tiles of any split call)
    followed by room for every split's partial tile (splits x tiles x
    threads x bm / 2 floats)."""
    seen = {}
    bm, bn = tk8.k8_wo_tile(m, n)
    tiles = -(-m // bm) * -(-n // bn)
    splits = tk8.k8_wo_split_count(m, k, n)
    words = 256 + splits * tiles * 2 * bn * bm // 2
    assert tiles < 132

    def hook(name, args):
        seen.update(splits=args[10], mode=args[9])
        counters = (ctypes.c_int32 * words).from_address(args[5])
        seen["zeroed"] = not any(counters[:256])

    stub.hook = hook
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32))
    w_q = torch.from_numpy(rng.randint(-127, 128, (k, n)).astype(np.int8))
    out = tk8._launch(x, w_q, torch.rand(n), None, 8, False)
    (name, call), = stub.calls
    assert len(call) == len(_build.SIGNATURES[name])
    assert seen == {"splits": splits, "mode": 0, "zeroed": True}
    assert splits > 1 and call[4] is None
    (work,) = tk8._wo_workspaces.values()
    assert work.numel() == words and tk8._workspaces == {}
    assert out.shape == (m, n) and out.dtype == torch.float32


def test_k8_weight_only_reuses_its_workspace_and_drops_it_on_failure(
        monkeypatch, stub):
    """Like int8 mode's: one buffer for calls that fit, grown when a call
    needs more, and dropped after a refused launch (the counters may not
    be zero then)."""
    ptrs = []
    stub.hook = lambda name, args: ptrs.append(args[5])

    def call(m, k, n):
        tk8._launch(torch.ones(m, k), torch.ones(k, n, dtype=torch.int8),
                    torch.ones(n), None, 8, False)

    call(32, 2048, 1000)
    call(1, 2048, 1000)        # fits: the same buffer
    assert len(ptrs) == 2 and ptrs[0] == ptrs[1]
    call(64, 2048, 1000)       # bm 64: grows
    assert ptrs[-1] != ptrs[0]
    assert len(tk8._wo_workspaces) == 1
    monkeypatch.setattr(_Recorder, "__getattr__",
                        lambda self, name: lambda *args: 1)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        call(32, 2048, 1000)
    assert tk8._wo_workspaces == {}
    assert tk8.launch_counts["quantized_matmul_weight_only"] == 3


# ---------------------------------------------------------------------
# the C prototypes against the ctypes declarations
# ---------------------------------------------------------------------

def _kind(param):
    param = param.strip()
    if "long long*" in param.replace(" *", "*"):
        return ctypes.POINTER(ctypes.c_longlong)
    if "*" in param:
        return ctypes.c_void_p
    for prefix, kind in (("float", ctypes.c_float),
                         ("unsigned", ctypes.c_uint),
                         ("long long", ctypes.c_longlong),
                         ("int", ctypes.c_int)):
        if param.startswith(prefix):
            return kind
    raise AssertionError(f"unknown parameter type: {param}")


def _prototypes():
    protos = {}
    for path in sorted(CSRC.glob("*.cu")):
        src = path.read_text()
        for name, params in re.findall(r"\bint (ptt_\w+)\(([^)]*)\)\s*\{",
                                       src):
            protos[name] = [_kind(p) for p in params.split(",")]
    return protos


def test_c_prototypes_match_signatures():
    protos = _prototypes()
    assert set(protos) == set(_build.SIGNATURES)
    for name, kinds in protos.items():
        assert kinds == list(_build.SIGNATURES[name]), name
