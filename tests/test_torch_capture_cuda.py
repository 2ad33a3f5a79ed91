"""The real capture on the card: the engines' rungs and TrainStep as
captured CUDA graphs against the same rungs run eagerly
(`observability.profile.disable_capture()`), at narrow widths.

The tests are marked `cuda` and skip without a GPU (decided in a
fixture). On the card:

    python -m pytest -m cuda tests/test_torch_capture_cuda.py -q

The file imports no JAX: the reference here is the port's eager path.
"""
import contextlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.observability import profile as prof
from paddle_tpu_torch.ops import generation as gen
from paddle_tpu_torch.ops.kernels import decode_attention as da
from paddle_tpu_torch.serving.generation import GenerationServer

#: head dim 32: the smallest the decode kernels take
CFG = dict(vocab_size=96, d_model=64, num_heads=2, num_layers=2,
           max_len=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured graphs")
    torch.backends.cuda.matmul.allow_tf32 = False
    prof.reset_profile()
    yield torch.device("cuda")
    prof.reset_profile()


def _model():
    return gen.TinyDecoderLM(gen.LMConfig(**CFG)).init_params(2)


def _requests():
    rng = np.random.RandomState(5)
    shared = rng.randint(1, 96, size=17)
    return [(np.concatenate([shared, rng.randint(1, 96, size=4 + i)])
             .astype(np.int32) if i % 2 else
             rng.randint(1, 96, size=3 + 2 * i).astype(np.int32), 6 + i)
            for i in range(6)]


def _serve(eng, **kw):
    with GenerationServer(eng, **kw) as srv:
        reqs = [srv.submit(p, n) for p, n in _requests()]
        toks = [r.result(timeout=120)["tokens"] for r in reqs]
        return toks, srv.stats()


ENGINES = {
    "contiguous": lambda m: gen.DecodeEngine(m, 3, CFG["max_len"]),
    "paged f32": lambda m: gen.PagedDecodeEngine(m, 3, CFG["max_len"],
                                                 spec_k=2),
    "paged int8": lambda m: gen.PagedDecodeEngine(m, 3, CFG["max_len"],
                                                  spec_k=2,
                                                  kv_dtype="int8"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(ENGINES))
def test_captured_rungs_serve_the_eager_tokens(cuda, kind):
    model = _model()
    draft = None if kind == "contiguous" else gen.NgramDraft(96)
    kw = {} if draft is None else {"draft": draft}
    eager_eng = ENGINES[kind](model)
    with prof.disable_capture():
        eager_eng.warmup()
        want, _ = _serve(eager_eng, **kw)
    eng = ENGINES[kind](model)
    eng.warmup()
    n_rungs = len(eng.buckets) + (1 if kind == "contiguous" else 2)
    recs = prof.compile_ledger().entries(scope=eng.ledger_scope,
                                         kind="graph")
    assert len(recs) == eng.compile_count() == n_rungs
    assert all(r.memory["pool_bytes"] > 0 and r.flops > 0 for r in recs)
    got, stats = _serve(eng, **kw)
    assert got == want
    assert eng.compile_count() == stats["compiled_signatures"] == n_rungs


@pytest.mark.cuda
def test_decode_replay_counts_launches_and_matches_eager(cuda):
    eng = gen.DecodeEngine(_model(), 3, CFG["max_len"])
    state = eng.init_state()
    for slot, (p, _) in enumerate(_requests()[:3]):
        state, _ = eng.prefill(state, slot, p)
    tokens, active = np.asarray([1, 2, 3], np.int32), np.ones(3, bool)
    eng.step(state, tokens, active)          # the capture
    saved = [t.clone() for t in state]
    da.reset_launch_counts()
    _, got = eng.step(state, tokens, active)
    assert da.launch_counts["decode_attention"] == CFG["num_layers"]
    for t, s in zip(state, saved):
        t.copy_(s)
    with prof.disable_capture():
        _, want = eng.step(state, tokens, active)
    np.testing.assert_array_equal(got, want)
    other = gen.DecodeEngine(_model(), 3, CFG["max_len"]).init_state()
    with pytest.raises(prof.CaptureError, match="not the state"):
        eng.step(other, tokens, active)


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda):
    calls = []

    def body(x):
        calls.append(1)
        return x * float(x.sum())        # a host read: not capturable

    g = prof.profiled_graph(body, "probe", "host_read", device="cuda",
                            arg_names=("x",))
    with pytest.raises(prof.CaptureError, match="probe/host_read"):
        g(torch.ones(4, device="cuda"))
    assert len(calls) == 2               # the warm-up and the capture
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_train_step_captured_matches_eager(cuda):
    def run(eager):
        tnn.seed(4)
        net = tnn.Sequential(tnn.Linear(16, 32, act="relu", device="cuda"),
                             tnn.Linear(32, 4, device="cuda"))
        step = tnn.TrainStep(net, lambda m, x, y: ((m(x) - y) ** 2).mean(),
                             learning_rate=0.05, momentum=0.9)
        rng = np.random.RandomState(1)
        losses = []
        with (prof.disable_capture() if eager
              else contextlib.nullcontext()):
            for b in (8, 8, 12, 8, 12):
                x = torch.from_numpy(rng.randn(b, 16).astype(np.float32))
                y = torch.from_numpy(rng.randn(b, 4).astype(np.float32))
                losses.append(float(step(x.cuda(), y.cuda())))
        return losses, {k: p.detach().cpu() for k, p in
                        net.trainable_dict().items()}

    lc, pc = run(False)
    recs = prof.compile_ledger().entries(component="train", kind="graph")
    assert len(recs) == 2                 # one graph per input signature
    le, pe = run(True)
    np.testing.assert_allclose(lc, le, rtol=1e-6)
    for k in pe:
        np.testing.assert_allclose(pc[k].numpy(), pe[k].numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.cuda
def test_k7_workspace_never_grows_in_a_capture(cuda):
    from paddle_tpu_torch.core.enforce import EnforceError
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        small = da._workspace(64, cuda)
        graph = torch.cuda.CUDAGraph()
        with pytest.raises(EnforceError, match="would grow"):
            with torch.cuda.graph(graph, stream=side):
                da._workspace(1 << 20, cuda)
        assert da._workspace(64, cuda) is small
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_dropout_generator_argument_draws_as_eager(cuda):
    """A step whose dropout draws from a torch.Generator passed as an
    argument: the captured replays draw the eager steps' masks."""
    def run(eager):
        tnn.seed(5)
        net = tnn.Linear(16, 16, device="cuda")
        drop = tnn.Dropout(0.5)
        step = tnn.TrainStep(net, lambda m, x, g: (drop(m(x), g) ** 2).mean(),
                             learning_rate=0.05, momentum=0.9)
        gen = torch.Generator(device="cuda").manual_seed(9)
        x = torch.ones(8, 16, device="cuda")
        with (prof.disable_capture() if eager
              else contextlib.nullcontext()):
            return [float(step(x, gen)) for _ in range(4)]

    captured, eager = run(False), run(True)
    assert len(set(captured)) == 4          # fresh masks every step
    np.testing.assert_allclose(captured, eager, rtol=1e-6)
