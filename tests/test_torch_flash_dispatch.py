"""The flash wrapper's host code on the CPU: which kernel each dtype goes
to and what it is handed.

`_build.load_library` is replaced by a recording stub, so `_FlashFn`
(the autograd function a CUDA call runs) can be driven with CPU tensors:
the stub records every kernel call and returns 0 (success). That checks,
without a card, that a bfloat16 call goes to the two tensor-core kernels
(`ptt_flash_fwd`, `ptt_flash_bwd`) and a float32 call to its two
(`ptt_flash_fwd_f32`, csrc/flash_fwd_f32_tc.cu, and `ptt_flash_bwd_f32`,
csrc/flash_bwd_f32_tc.cu), one launch each way, with the argument
counts `_build.SIGNATURES` declares, the strides of a fused-QKV view,
the zeroed float32 dQ workspace [B, Tq, N, D] (cast to bf16 for bf16;
for float32 the workspace is dQ itself, returned without a copy); that
a float32 view whose rows are not 16-byte aligned is launched, not
refused; and that what the JAX wrapper does not take either is refused
before any launch. The widened shapes run through a stub that computes
each forward launch with the plain version on the memory it was handed
(`_emulated_forward`): a head dim padded to the next instantiation with
the true sm_scale, exact against the unpadded plain version; float16
on the float32 kernels, against the JAX package's float16 path; an
unaligned bfloat16 view copied; B * N above grid.y's limit launched in
chunks that cover every (batch, head) once with the whole call's
dropout mask.
The kernels' arithmetic is held against the plain version on the card
(tests/test_torch_kernels_cuda.py).
"""
import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import flash_attention as tfa


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
    monkeypatch.setattr(tfa, "_stream", lambda device: 0)
    tfa.reset_launch_counts()
    yield lib
    tfa.reset_launch_counts()


def _n_ptrs(name):
    return sum(t is ctypes.c_void_p for t in _build.SIGNATURES[name]) - 1


def _qkv(dtype, b=2, t=24, n=3, d=64):
    x = torch.from_numpy(np.random.RandomState(0).randn(b, t, 3, n, d)
                         .astype(np.float32)).to(dtype).requires_grad_()
    return x, (x[:, :, 0], x[:, :, 1], x[:, :, 2])


def _run(dtype, mask_grad, b=2, t=24, n=3, d=64):
    x, (q, k, v) = _qkv(dtype, b, t, n, d)
    mask = torch.zeros((b, 1, 1, t), requires_grad=mask_grad)
    cfg = (False, 1.0 / d ** 0.5, 0.1, 7)
    out, lse = tfa._FlashFn.apply(q, k, v, mask, cfg, mask_grad)
    (out.float().sum() + lse.sum()).backward()
    return x, mask, out


@pytest.mark.parametrize("mask_grad", [False, True], ids=["mask", "dmask"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_each_dtype_goes_to_its_own_kernels(stub, dtype, mask_grad):
    b, t, n, d = 2, 24, 3, 64
    x, mask, out = _run(dtype, mask_grad, b, t, n, d)
    fwd, bwd = tfa.KERNELS[dtype]
    names = ["ptt_" + k for k in (fwd, *bwd)]
    # one forward and one backward launch, each on the tensor cores
    assert names == {torch.bfloat16: ["ptt_flash_fwd", "ptt_flash_bwd"],
                     torch.float32: ["ptt_flash_fwd_f32",
                                     "ptt_flash_bwd_f32"]}[dtype]
    assert [name for name, _ in stub.calls] == names
    assert tfa.launch_counts == {k: int(k in (fwd, *bwd))
                                 for k in tfa.launch_counts}
    qkv_strides = [t * 3 * n * d, 3 * n * d, d]
    esize = x.element_size()
    for name, args in stub.calls:
        assert len(args) == len(_build.SIGNATURES[name]), name
        nptr = _n_ptrs(name)
        # q, k, v: the three views of the fused [B, T, 3, N, D] tensor
        assert args[:3] == tuple(x.data_ptr() + i * n * d * esize
                                 for i in range(3))
        assert args[3] is not None                         # the bias
        assert args[nptr:nptr + 5] == (b, n, t, t, d)
        strides = list(args[nptr + 5])
        assert strides[0:9] == qkv_strides * 3, name
        assert args[nptr + 6] == pytest.approx(1.0 / d ** 0.5)
        assert args[nptr + 8:nptr + 10] == (1, 7)          # dropout, seed
    if mask_grad:
        assert mask.grad is not None and mask.grad.shape == mask.shape
    assert x.grad.dtype == dtype and x.grad.shape == x.shape


def test_bf16_backward_sums_dq_in_a_zeroed_f32_workspace(monkeypatch):
    """ptt_flash_bwd gets a float32 [B, Tq, N, D] workspace, contiguous and
    zeroed (the kernel adds into it); dQ is that workspace cast to bf16."""
    b, t, n, d = 2, 24, 3, 64
    numel = b * t * n * d
    pattern = (np.arange(numel, dtype=np.float32) % 97) * 0.01 - 0.3
    seen = {}

    def hook(name, args):
        if name != "ptt_flash_bwd":
            return
        buf = (ctypes.c_float * numel).from_address(args[7])
        seen["zeros"] = not np.frombuffer(buf, np.float32).any()
        seen["strides"] = list(args[_n_ptrs(name) + 5])
        buf[:] = pattern.tolist()

    lib = _Recorder(hook)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(tfa, "_stream", lambda device: 0)
    x, _, _ = _run(torch.bfloat16, False, b, t, n, d)
    assert seen["zeros"]
    assert seen["strides"][12:15] == [t * n * d, n * d, d]
    want = torch.from_numpy(pattern.reshape(b, t, n, d)).to(torch.bfloat16)
    assert torch.equal(x.grad[:, :, 0], want)


def test_f32_backward_is_one_launch_whose_workspace_is_dq(stub):
    """float32: ptt_flash_bwd_f32 is the only backward launch, and the dQ
    it returns is the very float32 workspace the kernel added into (no
    copy, no cast), contiguous [B, Tq, N, D]."""
    _, (q, k, v) = _qkv(torch.float32, b=2, t=24, n=3, d=64)
    q, k, v = q.detach(), k.detach(), v.detach()
    dout = torch.ones_like(q)
    lse = torch.zeros((2, 3, 24))
    delta = torch.zeros((2, 3, 24))
    dq, dk, dv, dbias = tfa._launch_bwd_tc(q, k, v, None, dout, lse, delta,
                                           (True, 0.125, 0.0, None), True)
    assert [name for name, _ in stub.calls] == ["ptt_flash_bwd_f32"]
    args = stub.calls[0][1]
    assert args[7] == dq.data_ptr() and dq.dtype == torch.float32
    assert dq.is_contiguous() and dq.shape == q.shape
    assert (args[8], args[9], args[10]) == (dk.data_ptr(), dv.data_ptr(),
                                            dbias.data_ptr())
    assert tfa.launch_counts["flash_bwd_f32"] == 1


def test_unsupported_inputs_are_refused_before_any_launch(stub):
    """Only what the JAX wrapper does not take either is refused: a dtype
    other than float32, bfloat16 and float16, a head dim above the widest
    instantiation, dtypes or shapes that differ, a tensor off the card.
    float16, a head dim below 128 outside (32, 64, 128), a bfloat16 view
    not 16-byte aligned and T >= 65536 pass every check but the device's
    (the tensors lie on the CPU here)."""
    q = torch.zeros((1, 16, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(EnforceError, match="float32, bfloat16 or float16"):
        tfa._check(q.double(), q.double(), q.double(), None)
    q160 = torch.zeros((1, 16, 2, 160), dtype=torch.bfloat16)
    with pytest.raises(EnforceError, match="head dim 160 above 128"):
        tfa._check(q160, q160, q160, None)
    with pytest.raises(EnforceError, match="dtypes differ"):
        tfa._check(q, q.float(), q, None)
    # a view whose rows start 2 bytes past a 16-byte boundary
    odd = torch.zeros(1 * 16 * 2 * 64 + 1, dtype=torch.bfloat16)[1:]
    odd = odd.view(1, 16, 2, 64)
    q48 = torch.zeros((1, 16, 2, 48), dtype=torch.bfloat16)
    long_t = torch.zeros((1, 65536, 1, 32))
    for t in (q, q.half(), q48, odd, long_t):
        with pytest.raises(EnforceError, match="must be a CUDA tensor"):
            tfa._check(t, t, t, None)
    assert stub.calls == []
    assert not any(tfa.launch_counts.values())


def test_f32_forward_launches_the_tensor_core_entry_point(stub):
    """The f32 forward runs ptt_flash_fwd_f32 at every T, and that entry
    point is the six-piece-pair tensor-core kernel's
    (csrc/flash_fwd_f32_tc.cu): no CUDA-core forward is left."""
    for t in (1, 64, 129, 512, 1024):
        _, (q, k, v) = _qkv(torch.float32, b=1, t=t, n=2, d=32)
        tfa._launch_fwd(q.detach(), k.detach(), v.detach(), None,
                        (True, 0.5, 0.0, None))
    assert [name for name, _ in stub.calls] == ["ptt_flash_fwd_f32"] * 5
    assert tfa.launch_counts["flash_fwd_f32"] == 5
    csrc = pathlib.Path(_build.__file__).parents[2] / "csrc"
    defines = [f.name for f in sorted(csrc.glob("*.cu"))
               if re.search(r"\nint ptt_flash_fwd_f32\(", f.read_text())]
    assert defines == ["flash_fwd_f32_tc.cu"]
    assert "flash_fwd_f32_tc_kernel" in (csrc / defines[0]).read_text()


def test_unaligned_f32_view_is_launched_not_refused(stub):
    """The f32 kernels read rows that are not 16-byte aligned (4-byte
    loads in both): a view one float into its buffer (every row 4 bytes
    past a 16-byte boundary) passes the checks and reaches the forward
    and the backward kernel as it is."""
    b, t, n, d = 1, 24, 3, 32
    buf = torch.zeros(b * t * 3 * n * d + 1)
    x = buf[1:].view(b, t, 3, n, d).requires_grad_()
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    assert q.data_ptr() % 16 == 4
    # every check passes but the device's (the tensors lie on the CPU)
    with pytest.raises(EnforceError, match="must be a CUDA tensor"):
        tfa._check(q.detach(), k.detach(), v.detach(), None)
    out, lse = tfa._FlashFn.apply(q, k, v, None, (False, 0.1, 0.0, None),
                                  False)
    (out.sum() + lse.sum()).backward()
    fwd_name, bwd_names = tfa.KERNELS[torch.float32]
    assert [name for name, _ in stub.calls] == [
        "ptt_" + kernel for kernel in (fwd_name, *bwd_names)]
    for _, args in stub.calls:
        assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())


def test_ctypes_signatures_match_the_flash_entry_points():
    """The argtypes `_build` declares have the arity and kinds of the C
    functions in csrc/flash*.cu: the four tensor-core entry points, the
    f32 backward in csrc/flash_bwd_f32_tc.cu with the bf16 backward's
    arguments."""
    csrc = pathlib.Path(_build.__file__).parents[2] / "csrc"
    src = "".join(f.read_text() for f in sorted(csrc.glob("flash*.cu")))
    protos = dict(re.findall(r"\nint (ptt_flash_\w+)\(([^)]*)\)", src))
    assert set(protos) == {k for k in _build.SIGNATURES
                           if k.startswith("ptt_flash")} == {
        "ptt_flash_fwd", "ptt_flash_bwd", "ptt_flash_fwd_f32",
        "ptt_flash_bwd_f32"}
    assert "\nint ptt_flash_bwd_f32(" in (
        csrc / "flash_bwd_f32_tc.cu").read_text()
    assert (_build.SIGNATURES["ptt_flash_bwd_f32"]
            == _build.SIGNATURES["ptt_flash_bwd"])
    for name, proto in protos.items():
        kinds = []
        for p in (p.strip() for p in proto.split(",")):
            kinds.append(_build._c_ll_p if p.startswith("const long long*")
                         else ctypes.c_void_p if "*" in p
                         else ctypes.c_float if p.startswith("float")
                         else ctypes.c_uint if p.startswith("unsigned")
                         else ctypes.c_int)
        assert _build.SIGNATURES[name] == kinds, name


# ---------------------------------------------------------------------------
# what the wrapper brings to the kernels: padded head dims, float16,
# unaligned bfloat16 views, (batch, head) chunks
# ---------------------------------------------------------------------------

def _view(ptr, shape, strides, dtype):
    """The tensor of `shape` / `strides` at host address `ptr` (the stub
    runs on CPU tensors, so a kernel argument's pointer is host memory)."""
    esize = torch.empty((), dtype=dtype).element_size()
    span = 1 + sum((n - 1) * st for n, st in zip(shape, strides))
    buf = (ctypes.c_byte * (span * esize)).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype).as_strided(shape, strides)


def _emulated_forward(rate=0.0):
    """A stub hook that computes each forward launch with the plain
    version on the memory it was handed (q, k, v, bias through their
    pointers and strides, the launch's sm_scale, causal flag and seed)
    and writes o and lse where the kernel would: a CPU stand-in for the
    kernel, so what the wrapper does around it is held end to end."""
    def hook(name, args):
        if not name.startswith("ptt_flash_fwd"):
            return
        q_p, k_p, v_p, bias_p, o_p, lse_p = args[:6]
        b, n, tq, tk, d = args[6:11]
        st = list(args[11])
        scale, causal, dropout, seed = args[12:16]
        dt = torch.float32 if name.endswith("f32") else torch.bfloat16
        q = _view(q_p, (b, tq, n, d), st[0:3] + [1], dt)
        k = _view(k_p, (b, tk, n, d), st[3:6] + [1], dt)
        v = _view(v_p, (b, tk, n, d), st[6:9] + [1], dt)
        bias = (None if bias_p is None
                else _view(bias_p, (b, tk), (tk, 1), torch.float32))
        keep = (tfa.batch_keep_masks(seed, b, n, tq, tk, rate)
                if dropout else None)
        o, lse = tfa.attention_reference(q, k, v, bias, bool(causal), scale,
                                         keep, return_lse=True)
        _view(o_p, (b, tq, n, d), st[12:15] + [1], dt).copy_(o)
        _view(lse_p, (b, n, tq), (n * tq, tq, 1), torch.float32).copy_(
            lse[..., 0].permute(0, 2, 1))
    return hook


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_head_dim_80_is_padded_to_128_with_the_true_scale(stub, dtype):
    """D = 80 reaches the kernels as D = 128: q, k, v zero-padded copies,
    sm_scale 1/sqrt(80); the output is sliced back and equals the plain
    version on the unpadded inputs (zero columns add nothing to q.k^T
    and give zero output columns); dQ, dK, dV come back at D = 80.
    float16 runs the float32 kernels."""
    b, t, n, d = 2, 24, 3, 80
    stub.hook = _emulated_forward()
    x, (q, k, v) = _qkv(dtype, b, t, n, d)
    mask = torch.zeros((b, 1, 1, t))
    mask[1, ..., 20:] = -1e9
    cfg = tfa._resolve(q, None, True, 0.0, None)
    out, lse = tfa._on_kernels(q, k, v, mask, cfg, False)
    kdt = torch.float32 if dtype == torch.float16 else dtype
    fwd, bwd = ("ptt_" + tfa.KERNELS[kdt][0], "ptt_" + tfa.KERNELS[kdt][1][0])
    (name, args), = stub.calls
    assert name == fwd and args[6:11] == (b, n, t, t, 128)
    assert args[12] == pytest.approx(1.0 / 80 ** 0.5)
    padded = _view(args[0], (b, t, n, 128), list(args[11])[0:3] + [1], kdt)
    assert torch.equal(padded[..., :d], q.detach().to(kdt))
    assert not padded[..., d:].any()
    assert out.shape == (b, t, n, d) and out.dtype == dtype
    want, want_lse = tfa.attention_reference(
        *(a.detach().to(kdt) for a in (q, k, v)), mask, True, None,
        return_lse=True)
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  want.to(dtype).float().numpy())
    np.testing.assert_array_equal(lse.detach().numpy(), want_lse.numpy())
    out.float().sum().backward()
    assert [c for c, _ in stub.calls] == [fwd, bwd]
    assert stub.calls[1][1][11:16] == (b, n, t, t, 128)
    assert x.grad.shape == x.shape and x.grad.dtype == dtype


def test_float16_is_within_tolerance_of_the_jax_float16_path(stub):
    """float16 on the kernels (the float32 kernels on a float32 copy,
    cast back) against the JAX package's flash_attention on the same
    float16 inputs (its Pallas kernel, interpreted on the CPU): within
    2e-3 absolute, two float16 roundings of values below 4 (the JAX
    kernel also rounds its probabilities to float16)."""
    import importlib
    import jax.numpy as jnp
    jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
    b, t, n, d = 1, 16, 2, 32
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(b, t, n, d).astype(np.float16) for _ in range(3))
    stub.hook = _emulated_forward()
    cfg = tfa._resolve(torch.from_numpy(q), None, True, 0.0, None)
    got, _ = tfa._on_kernels(*(torch.from_numpy(a) for a in (q, k, v)),
                             None, cfg, False)
    want = np.asarray(jfa.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True))
    assert got.dtype == torch.float16 and want.dtype == np.float16
    np.testing.assert_allclose(got.float().numpy(),
                               want.astype(np.float32), atol=2e-3, rtol=0)


def test_unaligned_bf16_view_is_copied_and_only_then(stub):
    """A bfloat16 view 2 bytes past a 16-byte boundary reaches the kernel
    as an aligned contiguous copy, and the result is the plain version's
    on the view; an aligned view (a fused-QKV slice) is launched as it
    is."""
    b, t, n, d = 1, 16, 2, 64
    stub.hook = _emulated_forward()
    buf = torch.from_numpy(np.random.RandomState(1).randn(
        b * t * n * d + 1).astype(np.float32)).to(torch.bfloat16)
    odd = buf[1:].view(b, t, n, d)
    assert odd.data_ptr() % 16 == 2
    cfg = tfa._resolve(odd, None, False, 0.0, None)
    out, _ = tfa._on_kernels(odd, odd, odd, None, cfg, False)
    args = stub.calls[0][1]
    assert all(p % 16 == 0 and p != odd.data_ptr() for p in args[:3])
    want = tfa.attention_reference(odd, odd, odd)
    assert torch.equal(out, want)
    _, (q, k, v) = _qkv(torch.bfloat16, 1, 16, 2, 64)
    tfa._on_kernels(q, k, v, None, cfg, False)
    assert stub.calls[1][1][:3] == (q.data_ptr(), k.data_ptr(),
                                    v.data_ptr())


def _covered(calls, x, b, n):
    """The (batch, head) pairs the launches of `calls` cover, as a list,
    from each launch's q pointer into x [B, T, 3, N, D] and its B, N."""
    esize = x.element_size()
    bstride, hstride = x.stride(0) * esize, x.stride(3) * esize
    pairs = []
    for _, args in calls:
        off = args[0] - x.data_ptr()
        b0, rem = divmod(off, bstride)
        n0 = rem // hstride
        nptr = 11 if len(args) == 24 else 6
        bc, nc = args[nptr], args[nptr + 1]
        pairs += [(b0 + i, n0 + j) for i in range(bc) for j in range(nc)]
    return pairs


@pytest.mark.parametrize("limit,b,n", [(4, 3, 3), (4, 2, 9),
                                       (tfa.MAX_GRID_ROWS, 2049, 32)],
                         ids=["batches", "heads", "grid-y"])
def test_chunked_launch_covers_every_batch_head_once(stub, monkeypatch,
                                                     limit, b, n):
    """B * N above grid.y's limit launches in chunks, forward and
    backward: whole batches (or heads of one batch when N alone exceeds
    it), every (batch, head) pair exactly once, each chunk's seed moved
    by its first pair; with dropout the chunks' output is the plain
    version's on the whole call, bit for bit. The small limits stand in
    for 65535 (same code); the last case is B * N = 65568 at the real
    limit."""
    monkeypatch.setattr(tfa, "MAX_GRID_ROWS", limit)
    t, d, rate = (5, 32, 0.3) if limit < 100 else (1, 32, 0.0)
    stub.hook = _emulated_forward(rate)
    x, (q, k, v) = _qkv(torch.float32, b, t, n, d)
    cfg = tfa._resolve(q, None, False, rate, 11 if rate else None)
    out, _ = tfa._on_kernels(q, k, v, None, cfg, False)
    out.sum().backward()
    fwd = [c for c in stub.calls if c[0] == "ptt_flash_fwd_f32"]
    bwd = [c for c in stub.calls if c[0] == "ptt_flash_bwd_f32"]
    assert len(fwd) == len(bwd) == len(tfa.bh_chunks(b, n)) > 1
    every = sorted((i, j) for i in range(b) for j in range(n))
    assert sorted(_covered(fwd, x, b, n)) == every
    assert sorted(_covered(bwd, x, b, n)) == every
    assert all(args[7] * args[6] <= limit for _, args in fwd)
    if rate:
        for (_, args), (b0, _, n0, _) in zip(fwd, tfa.bh_chunks(b, n)):
            assert args[15] == tfa.chunk_seed(11, b0 * n + n0)
        keep = tfa.batch_keep_masks(11, b, n, t, t, rate)
        want = tfa.attention_reference(q.detach(), k.detach(), v.detach(),
                                       keep_masks=keep)
        assert torch.equal(out.detach(), want)
