"""The Executor's captured graphs on the card, at narrow widths, against
the same programs under `observability.profile.disable_capture()`.

* Re-seeding a generator registered with a graph between replays gives
  the draws of a fresh generator at that seed (what the Executor's
  persistent draw sites rely on), and a dropout program's captured runs
  draw bit for bit what its eager runs draw.
* `load_persistables` between two replays is seen by the next one.
* A Predictor and its clone replaying one entry from two threads give
  each request the result it gets alone.
* K8 launches once per int8 request under replay.
* An op that reads the host without saying so fails its capture with a
  CaptureError naming the op.

The tests are marked `cuda` and skip without a GPU (decided in a
fixture). On the card:

    python -m pytest -m cuda tests/test_torch_executor_capture_cuda.py -q

The file imports no JAX: the reference is the port's eager path.
"""
import shutil
import tempfile
import threading

import numpy as np
import pytest
import torch

from paddle_tpu_torch import inference, optimizer
from paddle_tpu_torch import static as S
from paddle_tpu_torch.core import ir
from paddle_tpu_torch.core import registry
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.scope import Scope, scope_guard
from paddle_tpu_torch.observability import profile as prof
from paddle_tpu_torch.ops.kernels import quantized_matmul as k8
from paddle_tpu_torch.static import io


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured graphs")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prof.reset_profile()
    yield torch.device("cuda")
    prof.reset_profile()


def _programs(build, seed=0):
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    main.random_seed = startup.random_seed = seed
    with ir.program_guard(main, startup):
        fetch = build()
    return main, startup, [f.name for f in fetch]


def _dropout_net():
    x = S.data("x", [64, 32], "float32", append_batch_size=False)
    h = S.fc(x, 64, act="relu")
    d = S.dropout(h, 0.5, dropout_implementation="upscale_in_train")
    loss = S.mean(S.square(S.fc(d, 1)))
    noise = S.uniform_random([5, 7], min=-1.0, max=1.0)
    optimizer.SGD(0.1).minimize(loss)
    return [loss, d, noise]


def _feed(seed):
    return {"x": np.random.RandomState(seed).randn(64, 32).astype(
        np.float32)}


def _state(scope, program):
    return {v.name: scope.find_np(v.name) for v in program.list_vars()
            if v.persistable and scope.has(v.name)}


def _scope_of(state):
    sc = Scope()
    for n, a in state.items():
        sc.set(n, a)
    return sc


@pytest.mark.cuda
def test_reseeding_a_registered_generator_between_replays(cuda):
    gen = torch.Generator(device=cuda)
    out = torch.empty(1000, device=cuda)
    g = torch.cuda.CUDAGraph()
    g.register_generator_state(gen)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        gen.manual_seed(0)
        out.uniform_(generator=gen)
    torch.cuda.current_stream().wait_stream(s)
    gen.manual_seed(0)
    with torch.cuda.graph(g, stream=s):
        out.uniform_(generator=gen)
    for seed in (3, 3, 4):
        gen.manual_seed(seed)
        g.replay()
        fresh = torch.empty(1000, device=cuda).uniform_(
            generator=torch.Generator(device=cuda).manual_seed(seed))
        torch.cuda.synchronize()
        assert torch.equal(out, fresh), seed


@pytest.mark.cuda
def test_captured_dropout_runs_draw_what_eager_runs_draw(cuda):
    main, startup, fetch = _programs(_dropout_net)
    scope = Scope()
    Executor().run(startup, scope=scope)
    start = _state(scope, main)
    eager_scope = _scope_of(start)
    exe, eexe = Executor(), Executor()
    for seed in range(4):
        got = exe.run(main, feed=_feed(seed), fetch_list=fetch, scope=scope)
        with prof.disable_capture():
            want = eexe.run(main, feed=_feed(seed), fetch_list=fetch,
                            scope=eager_scope)
        np.testing.assert_array_equal(got[1] != 0, want[1] != 0)
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    for n, a in _state(eager_scope, main).items():
        np.testing.assert_allclose(scope.find_np(n), a, rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    recs = prof.compile_ledger().entries(kind="graph")
    assert [r.tags["segments"] for r in recs][-1] == 1


def _convnet():
    img = S.data("img", [3, 16, 16], "float32")
    label = S.data("label", [1], "int64")
    c = S.conv2d(img, 8, 3, padding=1, act="relu")
    p = S.pool2d(c, 2, "max", 2)
    h = S.fc(p, 64, act="relu")
    logits = S.fc(h, 10)
    loss = S.mean(S.softmax_with_cross_entropy(logits, label))
    return [logits, loss]


def _batch(seed, n=8):
    rng = np.random.RandomState(seed)
    return {"img": rng.randn(n, 3, 16, 16).astype(np.float32),
            "label": rng.randint(0, 10, (n, 1)).astype(np.int64)}


@pytest.mark.cuda
def test_load_persistables_between_replays_is_seen(cuda):
    def build():
        logits, loss = _convnet()
        optimizer.Momentum(0.05, 0.9).minimize(loss)
        return [loss]

    main, startup, fetch = _programs(build)
    scope = Scope()
    exe = Executor()
    exe.run(startup, scope=scope)
    d = tempfile.mkdtemp(prefix="exec_capture_")
    try:
        for i in range(2):
            exe.run(main, feed=_batch(i), fetch_list=fetch, scope=scope)
        with scope_guard(scope):
            io.save_persistables(exe, d, main)
        saved = _state(scope, main)
        for i in range(2, 4):                       # replays move on
            exe.run(main, feed=_batch(i), fetch_list=fetch, scope=scope)
        with scope_guard(scope):
            io.load_persistables(exe, d, main)
        (got,) = exe.run(main, feed=_batch(9), fetch_list=fetch,
                         scope=scope)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    with prof.disable_capture():
        eager_scope = _scope_of(saved)
        (want,) = Executor().run(main, feed=_batch(9), fetch_list=fetch,
                                 scope=eager_scope)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for n, a in _state(eager_scope, main).items():
        np.testing.assert_allclose(scope.find_np(n), a, rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def _saved_model(build, d):
    main, startup, fetch = _programs(build)
    exe = Executor()
    with scope_guard(Scope()):
        exe.run(startup)
        io.save_inference_model(d, ["img"],
                                [main.global_block().var(fetch[0])], exe,
                                main_program=main)


@pytest.mark.cuda
def test_a_predictor_and_its_clone_in_two_threads(cuda):
    d = tempfile.mkdtemp(prefix="exec_pred_")
    try:
        _saved_model(lambda: _convnet()[:1], d)
        pred = inference.create_predictor(inference.Config(d))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    clone = pred.clone()
    reqs = [_batch(i)["img"] for i in range(12)]
    with prof.disable_capture():
        want = [pred.run({"img": x})[0] for x in reqs]
    pred.run({"img": reqs[0]})                 # capture the entry
    got = [None] * len(reqs)

    def serve(p, idx):
        for i in idx:
            got[i] = p.run({"img": reqs[i]})[0]

    threads = [threading.Thread(target=serve, args=(p, range(k, 12, 2)))
               for k, p in enumerate((pred, clone))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_k8_launches_once_per_int8_request_under_replay(cuda):
    def build():
        x = S.data("img", [64], "float32")
        h = S.fc(x, 64, act="relu")
        return [S.fc(h, 32)]

    rng = np.random.RandomState(0)
    d = tempfile.mkdtemp(prefix="exec_int8_")
    try:
        _saved_model(build, d)
        cfg = inference.Config(d)
        cfg.enable_int8([{"img": rng.randn(8, 64).astype(np.float32)}
                         for _ in range(2)])
        pred = inference.create_predictor(cfg)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    n_mul = [op.type for op in pred._program.global_block().ops].count(
        "quantized_mul")
    assert n_mul == 2
    x = rng.randn(8, 64).astype(np.float32)
    pred.run({"img": x})                       # warm-up and capture
    k8.reset_launch_counts()
    outs = [pred.run({"img": x})[0] for _ in range(5)]
    assert k8.launch_counts["quantized_matmul"] == 5 * n_mul
    with prof.disable_capture():
        (want,) = pred.run({"img": x})
    for o in outs:
        np.testing.assert_allclose(o, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_an_unmarked_host_read_fails_its_capture_naming_the_op(cuda):
    if not registry.has_op("test_reads_host_cuda"):
        @registry.register_op("test_reads_host_cuda", inputs=["X"],
                              outputs=["Out"])
        def _reads(ctx, x):
            return x * float(x.sum().item())

    main = ir.Program()
    with ir.program_guard(main, ir.Program()):
        x = S.data("x", [2, 2], "float32", append_batch_size=False)
        y = S.scale(x, scale=2.0)
        out = main.global_block().create_var(name="out", shape=(2, 2),
                                             dtype="float32")
        main.global_block().append_op("test_reads_host_cuda",
                                      {"X": [y.name]}, {"Out": ["out"]})
    with pytest.raises(prof.CaptureError,
                       match=r"block 0, op 1 \('test_reads_host_cuda'\)"):
        Executor().run(main, feed={"x": np.ones((2, 2), np.float32)},
                       fetch_list=[out], scope=Scope())
