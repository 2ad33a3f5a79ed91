"""The host code of K7's two routes and of K8's split-K, on the CPU.

`_build.load_library` is replaced by a recording stub (as in
tests/test_torch_flash_dispatch.py), so the launch helpers run with CPU
tensors: each records the C function it called and its arguments and
returns 0. That checks, without a card, that K7 sends decode ticks
(C = 1) to the decode kernel and the verify and prefill chunks to the
tensor-core kernel with the partial buffers each needs; that K8 in int8
mode asks for the split count `k8_split_count` gives and hands the
kernel a zeroed int32 workspace of M * N sums plus one arrival counter
per output tile, reused from call to call (the kernel leaves it zero);
that every call has the arity `_build.SIGNATURES`
declares; and that those declarations match the C prototypes in
csrc/. The kernels' arithmetic is held against the plain versions on
the card (tests/test_torch_kernels_cuda.py).
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
    else:                    # one row, >= 32 keys
        nsplit = tda.split_count(b * n, m * bs)
    assert shapes == [(b * c * n, nsplit, d)]
    nsplit_arg = call[-4]
    assert nsplit_arg == nsplit
    assert (call[8] is None) == (nsplit == 1)       # part_m only when split
    assert call[11:18] == (b, c, n, d, b * m + 1, bs, m)
    assert out.shape == (b, c, n, d)
    assert tda.launch_counts["quantized_paged_decode_attention"] == 1
    assert tda.launch_counts["quantized_paged_prefill_attention"] == \
        (route == "prefill")


def test_k7_prefill_splits_fill_the_card_at_batch_one():
    """The main path's prefill (B = 1, C = 512, N = 12): 8 row tiles x 12
    heads = 96 blocks, so the key ranges split; at B = 8 the tiles alone
    fill the card."""
    assert tda.split_count(1 * 12 * 8, 1024, 64) == 6
    assert tda.split_count(8 * 12 * 8, 1024, 64) == 1
    assert tda.split_count(1, 100, 64) == 2


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
    x = torch.ones(32, 2048)
    w_q = torch.ones(2048, 1000, dtype=torch.int8)
    tk8._launch(x, w_q, torch.ones(1000), None, 8, False)
    (_, call), = stub.calls
    assert call[9:11] == (0, 1) and call[5] is None


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
