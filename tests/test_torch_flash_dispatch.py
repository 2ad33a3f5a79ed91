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
refused; and that unsupported inputs are refused before any launch.
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
    q = torch.zeros((1, 16, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(EnforceError, match="float32 or bfloat16"):
        tfa._check(q.half(), q.half(), q.half(), None)
    q48 = torch.zeros((1, 16, 2, 48), dtype=torch.bfloat16)
    with pytest.raises(EnforceError, match="head dim"):
        tfa._check(q48, q48, q48, None)
    # a view whose rows start 2 bytes past a 16-byte boundary
    odd = torch.zeros(1 * 16 * 2 * 64 + 1, dtype=torch.bfloat16)[1:]
    odd = odd.view(1, 16, 2, 64)
    with pytest.raises(EnforceError, match="16-byte aligned"):
        tfa._check(odd, odd, odd, None)
    with pytest.raises(EnforceError, match="dtypes differ"):
        tfa._check(q, q.float(), q, None)
    # everything else in order: only the device is wrong here
    with pytest.raises(EnforceError, match="must be a CUDA tensor"):
        tfa._check(q, q, q, None)
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
