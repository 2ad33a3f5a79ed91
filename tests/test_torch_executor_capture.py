"""The Executor's capture (core/lowering.py's capture plan, observability
/profile.py's LedgerJit) on the CPU.

* `capture_plan` splits a block at its host ops (`while`,
  `conditional_block`, `py_func`, `print`) and names each one's reason;
  an `autodiff` region is one segment.
* The segmented step, which every CPU run takes, gives the JAX
  Executor's fetches and new state on the same programs and seeded numpy
  inputs: 1e-5 for floats, ids bit-equal.
* `program_cache_token` equals the JAX package's, is stable across a
  save / load round trip and changes with the program; the ledger's
  sites, signatures and cache tokens are the JAX Executor's.
* Random ops draw the same from the same run seed and otherwise from
  another, eagerly and captured.

The capture path runs on CPU tensors through `cuda_tape`: `torch.cuda`'s
graph, stream and memory calls are stubs, and a stub graph records, as a
TorchDispatchMode, every aten op its capture runs (and refuses a host
read, as a real capture does); its replay runs the recorded ops again on
the same tensors, writing each result into the tensor the capture made,
as a CUDA graph reruns its kernels on its fixed buffers. So, without a
card: captured runs give the eager runs' results bit for bit (dropout
draws included, which re-seeding the registered generators gives), a
replay runs no Python, state is updated in place, a `scope.set` between
runs is seen, a while body is one graph replayed per iteration, and an
unmarked op that reads the host fails its capture naming the op. The
real captures run on the card (tests/test_torch_executor_capture_cuda.py,
chip_smoke phase 32).
"""
import contextlib
import json
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as pt
from paddle_tpu.core import compile_cache as jcc
from paddle_tpu.core import ir as jir
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.observability import profile as jprof
from paddle_tpu.utils.param_attr import ParamAttr as JParamAttr
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core import compile_cache as tcc
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core import lowering as tlowering
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope, scope_guard
from paddle_tpu_torch.observability import profile as tprof
from paddle_tpu_torch.ops import control_flow as tcf
from paddle_tpu_torch.utils.param_attr import ParamAttr as TParamAttr
from paddle_tpu_torch.weights import scope_from_jax

SIDES = {"jax": (jir, pt.static, pt.optimizer, JParamAttr),
         "port": (tir, tstatic, topt, TParamAttr)}
#: float fetches and state against the JAX Executor's
TOL = dict(rtol=1e-5, atol=1e-5)
_X64 = {"int64": "int32"}


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    prev_m = tir.switch_main_program(tir.Program())
    prev_s = tir.switch_startup_program(tir.Program())
    tir.reset_unique_names()
    with scope_guard(Scope()):
        yield
    tir.switch_main_program(prev_m)
    tir.switch_startup_program(prev_s)


# --- a CUDA graph on CPU tensors -------------------------------------------

_aten = torch.ops.aten
#: what a capture refuses: reads of device values on the host
HOST_READS = {_aten._local_scalar_dense.default, _aten.nonzero.default,
              _aten.masked_select.default, _aten.equal.default,
              _aten.is_nonzero.default, _aten._unique2.default,
              _aten.unique_dim.default, _aten.unique_consecutive.default}


def _storage(t):
    return t.untyped_storage().data_ptr()


class _Tape(TorchDispatchMode):
    """Records every aten op run under it; a host read raises as a real
    capture does. Like a real capture it changes no tensor that existed
    before it: a write into one is recorded and not run (ops on tensors
    the capture made run, so its outputs have their shapes)."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self._made = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in HOST_READS:
            raise RuntimeError(f"operation not permitted when stream is "
                               f"capturing ({func} reads the device)")
        written = []
        for i, a in enumerate(func._schema.arguments):
            v = args[i] if i < len(args) else kwargs.get(a.name)
            if a.alias_info is not None and a.alias_info.is_write and \
                    isinstance(v, torch.Tensor):
                written.append(v)
        if written and any(_storage(w) not in self._made for w in written):
            out = written[0]
        else:
            out = func(*args, **kwargs)
            ins = {_storage(a) for a in torch.utils._pytree.tree_leaves(
                (args, kwargs)) if isinstance(a, torch.Tensor)}
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and _storage(t) not in ins:
                    self._made.add(_storage(t))     # not a view
        self.ops.append((func, args, kwargs, out))
        return out


def _into(made, got):
    """Write a replayed op's result into the tensors its capture made
    (results that alias them, views and in-place ops, need nothing)."""
    if isinstance(made, torch.Tensor):
        if _storage(made) != _storage(got):
            made.copy_(got)
    elif isinstance(made, (tuple, list)):
        for m, g in zip(made, got):
            _into(m, g)


class TapeGraph:
    """Stands in for torch.cuda.CUDAGraph."""

    made = []

    def __init__(self):
        self.tape = None
        self.generators = []
        self.replays = 0
        TapeGraph.made.append(self)

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1
        for func, args, kwargs, out in self.tape.ops:
            _into(out, func(*args, **kwargs))


class _Stream:
    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass


@pytest.fixture
def cuda_tape(monkeypatch):
    """The capture path of the Executor's entries on CPU tensors."""
    @contextlib.contextmanager
    def graph(g, pool=None, stream=None):
        tape = _Tape()
        with tape:
            yield
        g.tape = tape

    TapeGraph.made = []
    monkeypatch.setattr(tprof, "_captures_on",
                        lambda device: not tprof.capture_disabled())
    monkeypatch.setattr(tprof, "_capture_streams", {})
    for name, value in (
            ("CUDAGraph", TapeGraph), ("graph", graph),
            ("graph_pool_handle", lambda: ("pool",)),
            ("Stream", lambda device=None: _Stream()),
            ("current_stream", lambda device=None: _Stream()),
            ("stream", lambda s: contextlib.nullcontext()),
            ("memory_allocated", lambda device=None: 0),
            ("max_memory_allocated", lambda device=None: 0),
            ("reset_peak_memory_stats", lambda device=None: None),
            ("memory_snapshot", lambda: [])):
        monkeypatch.setattr(torch.cuda, name, value)
    tprof.reset_profile()
    yield TapeGraph
    tprof.reset_profile()


# --- the programs ----------------------------------------------------------

def _build(side, fn, seed=0):
    ir, static, opt, param_attr = SIDES[side]
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    main.random_seed = startup.random_seed = seed
    with ir.program_guard(main, startup):
        fetch = fn(static, opt, param_attr)
    return main, startup, [f if isinstance(f, str) else f.name
                           for f in fetch]


def _lenet(S, opt, PA):
    img = S.data("img", [1, 28, 28], "float32")
    label = S.data("label", [1], "int64")
    c = S.conv2d(img, 6, 5, act="relu")
    p = S.pool2d(c, 2, "max", 2)
    c = S.conv2d(p, 16, 5, act="relu")
    p = S.pool2d(c, 2, "max", 2)
    h = S.fc(p, 32, act="relu")
    logits = S.fc(h, 10)
    loss = S.mean(S.softmax_with_cross_entropy(logits, label))
    ids = S.argmax(logits, axis=1)
    opt.Momentum(0.05, 0.9).minimize(loss)
    return [loss, ids]


def _double(a):
    return a * 2.0


def _host_ops(S, opt, PA):
    """fc, py_func, Print, a While that accumulates the fc output ten
    times, a cond on its sum, argmax ids."""
    x = S.data("x", [4, 3], "float32", append_batch_size=False)
    h = S.fc(x, 5, param_attr=PA(name="w"), bias_attr=PA(name="b"))
    doubled = S.default_main_program().global_block().create_var(
        name="doubled", shape=(4, 5), dtype="float32", stop_gradient=True)
    S.py_func(_double, h, doubled)
    shown = S.Print(doubled, message="captured:")
    acc = S.fill_constant([4, 5], "float32", 0.0)
    i = S.fill_constant([1], "int64", 0)
    n = S.fill_constant([1], "int64", 10)
    cond = S.less_than(i, n)
    loop = S.While(cond)
    with loop.block():
        S.assign(S.elementwise_add(acc, S.tanh(shown)), acc)
        ni = S.increment(S.assign(i), value=1)
        S.assign(ni, i)
        S.assign(S.less_than(ni, n), cond)
    total = S.reduce_sum(acc)
    pred = S.less_than(total, S.fill_constant([1], "float32", 0.0))
    out = S.cond(pred, lambda: S.scale(acc, scale=-1.0),
                 lambda: S.scale(acc, scale=0.5))
    ids = S.argmax(out, axis=1)
    return [out, ids, i]


def _dropout(S, opt, PA):
    x = S.data("x", [16, 12], "float32", append_batch_size=False)
    h = S.fc(x, 24, act="relu")
    d = S.dropout(h, 0.5, dropout_implementation="upscale_in_train")
    loss = S.mean(S.square(S.fc(d, 1)))
    noise = S.uniform_random([3, 4], min=-1.0, max=1.0)
    opt.SGD(0.1).minimize(loss)
    return [loss, d, noise]


def _feed(name, seed=0):
    rng = np.random.RandomState(seed)
    if name == "lenet":
        return {"img": rng.randn(4, 1, 28, 28).astype(np.float32),
                "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    if name == "host_ops":
        return {"x": rng.randn(4, 3).astype(np.float32)}
    return {"x": rng.randn(16, 12).astype(np.float32)}


PROGRAMS = {"lenet": _lenet, "host_ops": _host_ops, "dropout": _dropout}


def _persistables(program, scope):
    return {v.name: scope.find_np(v.name) for v in program.list_vars()
            if v.persistable and scope.has(v.name)}


def _port_state(name, seed=0):
    """The port's program, fetches and a scope its startup filled."""
    main, startup, fetch = _build("port", PROGRAMS[name], seed)
    scope = Scope()
    TExecutor("cpu").run(startup, scope=scope)
    return main, fetch, scope


def _copy_scope(scope, names):
    out = Scope()
    for n in names:
        out.set(n, scope.find_np(n))
    return out


# --- the plan --------------------------------------------------------------

def test_capture_plan_segments_and_host_reasons():
    main, _, _ = _build("port", _host_ops)
    plan = tlowering.capture_plan(main, 0)
    kinds = [(s.kind, main.global_block().ops[s.start].type
              if s.kind == "host" else None) for s in plan]
    py_func = next(op.type for op in main.global_block().ops
                   if op.type.startswith("py_func_"))
    assert kinds == [("graph", None), ("host", py_func), ("host", "print"),
                     ("graph", None), ("host", "while"), ("graph", None),
                     ("host", "conditional_block"), ("graph", None)]
    reasons = [s.reason for s in plan if s.kind == "host"]
    assert "Python callback" in reasons[0] and "prints" in reasons[1]
    assert "condition on the host" in reasons[2]
    assert "predicate on the host" in reasons[3]
    # the while body and the branches are straight-line graphs
    w = next(op for op in main.global_block().ops if op.type == "while")
    body = tlowering.capture_plan(main, w.attrs["sub_block"])
    assert [s.kind for s in body] == ["graph"]
    # a segment reads what it needs from before it and writes its outputs
    first = plan[0]
    assert {"x", "w", "b"} <= first.reads
    assert plan is tlowering.capture_plan(main, 0)        # memoised
    # a training program is one segment, the autodiff region
    lenet, _, _ = _build("port", _lenet)
    (seg,) = tlowering.capture_plan(lenet, 0)
    assert (seg.kind, seg.start, seg.stop) == (
        "graph", 0, len(lenet.global_block().ops))


def test_a_host_op_in_the_autodiff_region_makes_it_one_eager_segment():
    def fn(S, opt, PA):
        x = S.data("x", [4, 3], "float32", append_batch_size=False)
        shown = S.Print(S.fc(x, 2), message="loss input")
        loss = S.mean(shown)
        opt.SGD(0.1).minimize(loss)
        return [loss]

    main, _, _ = _build("port", fn)
    (seg,) = tlowering.capture_plan(main, 0)
    assert seg.kind == "eager"
    assert "'print'" in seg.reason and "autodiff region" in seg.reason


def test_affine_grid_is_a_host_op_only_with_a_tensor_shape():
    main = tir.Program()
    with tir.program_guard(main, tir.Program()):
        theta = tstatic.data("theta", [2, 2, 3], "float32",
                             append_batch_size=False)
        shape = tstatic.data("shape", [4], "int32", append_batch_size=False)
        blk = main.global_block()
        for i, (ins, attrs) in enumerate((
                ({"Theta": [theta.name]}, {"output_shape": [2, 1, 3, 4]}),
                ({"Theta": [theta.name], "OutputShape": [shape.name]}, {}))):
            blk.create_var(name=f"grid{i}", dtype="float32")
            blk.append_op("affine_grid", ins, {"Output": [f"grid{i}"]},
                          attrs)
    plan = tlowering.capture_plan(main, 0)
    assert [s.kind for s in plan] == ["graph", "host"]
    assert ".tolist()" in plan[1].reason


# --- against the JAX Executor ----------------------------------------------

@pytest.mark.parametrize("name", ["lenet", "host_ops", "dropout"])
def test_segmented_step_matches_the_jax_executor(name, capsys):
    """Two runs from the JAX startup's state: the fetches and every
    persistable after each run. The dropout program runs its test clone
    (the masks are torch's draws, not jax.random's) and leaves out its
    uniform draws."""
    jmain, jstart, fetch = _build("jax", PROGRAMS[name])
    tmain, _, tfetch = _build("port", PROGRAMS[name])
    assert tfetch == fetch
    if name == "dropout":
        jmain, tmain = jmain.clone(for_test=True), tmain.clone(for_test=True)
        fetch = fetch[:2]
    jscope = JScope()
    jexe = pt.Executor()
    jexe.run(jstart, scope=jscope)
    tscope = scope_from_jax(_persistables(jmain, jscope), Scope(), "cpu")
    texe = TExecutor("cpu")
    for seed in (0, 1):
        feed = _feed(name, seed)
        want = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
        got = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
        for w, g in zip(want, got):
            w = np.asarray(w)
            if np.issubdtype(w.dtype, np.integer):
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, **TOL)
        for n, w in _persistables(jmain, jscope).items():
            np.testing.assert_allclose(tscope.find_np(n), w, **TOL,
                                       err_msg=n)
    if name == "host_ops":
        assert capsys.readouterr().out.count("captured:") == 4


def test_program_cache_token_is_the_jax_token_and_stable():
    jmain, _, _ = _build("jax", _lenet)
    tmain, _, _ = _build("port", _lenet)
    token = tcc.program_cache_token(tmain)
    assert token == jcc.program_cache_token(jmain)
    assert tcc.program_cache_token(
        tir.Program.from_json(tmain.to_json())) == token
    assert tcc.program_cache_token(tmain) == token          # memoised
    with tir.program_guard(tmain, tir.Program()):
        tstatic.scale(tmain.global_block().var("img"), scale=2.0)
    assert tcc.program_cache_token(tmain) != token


def test_ledger_sites_signatures_and_tokens_match_the_jax_executor():
    """A train and a test program through both Executors: one ledger
    record each, at the JAX site name (program id aside) with the JAX
    state and feed signature; the cache tokens are equal."""
    jmain, jstart, fetch = _build("jax", _lenet)
    jtest = jmain.clone(for_test=True)
    tmain, tstart, _ = _build("port", _lenet)
    ttest = tmain.clone(for_test=True)
    jscope = JScope()
    jexe = pt.Executor()
    jexe.run(jstart, scope=jscope)
    tscope = scope_from_jax(_persistables(jmain, jscope), Scope(), "cpu")
    texe = TExecutor("cpu")
    feed = _feed("lenet")
    recs = {}
    for side, exe, prof, (main, test), scope in (
            ("jax", jexe, jprof, (jmain, jtest), jscope),
            ("port", texe, tprof, (tmain, ttest), tscope)):
        prof.reset_profile()
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        exe.run(test, feed=feed, fetch_list=fetch[1:], scope=scope)
        exe.run(test, feed=feed, fetch_list=fetch[1:], scope=scope)
        # the JAX package narrows 64-bit feeds (x64 off); the port keeps
        # them (core/dtypes.py)
        recs[side] = [(r.site.split("v", 1)[1],
                       [(a, shape, _X64.get(d, d))
                        for a, shape, d in r.signature
                        if not a.startswith("rng")])
                      for r in prof.compile_ledger().entries()]
    assert recs["port"] == recs["jax"]
    assert [s for s, _ in recs["port"]] == [
        f"{tmain._version}/{','.join(fetch)}/train",
        f"{ttest._version}/{fetch[1]}/infer"]
    state = [v.name for v in tmain.list_vars()
             if v.persistable and tscope.has(v.name)]
    for training, prog in ((True, tmain), (False, ttest)):
        names = sorted(n for n in state if prog.global_block().has_var(n)
                       or any(b.has_var(n) for b in prog.blocks))
        want = pt.Executor._cache_token(jmain if training else jtest, None,
                                        fetch if training else fetch[1:],
                                        names, training)
        got = TExecutor._cache_token(prog, fetch if training else fetch[1:],
                                     names, training)
        assert got == want


# --- randomness ------------------------------------------------------------

def test_random_ops_draw_from_the_run_seed():
    """The same program seed gives the same draws run for run; another
    seed other draws; a second run of one Executor other draws (its step
    counter)."""
    draws = []
    for seed in (0, 0, 1):
        main, fetch, scope = _port_state("dropout", seed=7)
        main.random_seed = seed
        exe = TExecutor("cpu")
        runs = [exe.run(main, feed=_feed("dropout"), fetch_list=fetch[1:],
                        scope=scope) for _ in range(2)]
        draws.append(runs)
    for a, b in zip(draws[0][0], draws[1][0]):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(draws[0][0][1], draws[2][0][1])
    assert not np.array_equal(draws[0][0][1], draws[0][1][1])
    assert not np.array_equal(draws[0][0][0] != 0, draws[2][0][0] != 0)


def test_run_generators_keep_eager_draws_for_a_site_drawn_twice():
    """A persistent generator per (site, draw): re-seeded, each draw of a
    site gives the numbers a fresh generator at that seed gives."""
    rngs = tregistry.RunGenerators("cpu")
    used = rngs.begin()
    a = torch.rand(5, generator=rngs.draw(3, 7))
    b = torch.rand(5, generator=rngs.draw(3, 7))
    fresh = torch.rand(5, generator=tregistry.op_generator(3, 7, "cpu"))
    assert torch.equal(a, fresh) and torch.equal(b, fresh)
    assert len({id(g) for g, _, _ in used}) == 2
    rngs.capturing = True
    rngs.begin()
    g = rngs.draw(3, 7)
    torch.rand(5, generator=g)
    tregistry.RunGenerators.reseed(used, 3)
    assert torch.equal(torch.rand(5, generator=g), fresh)
    fixed = rngs.draw(3, 8, fixed=11)
    assert fixed is not g


def _print_dropout(S, opt, PA):
    """A Print inside the autodiff region makes the step one eager
    segment, so its dropout draws eagerly in a captured run too."""
    x = S.data("x", [16, 12], "float32", append_batch_size=False)
    h = S.Print(S.fc(x, 24, act="relu"), message="h", summarize=1)
    d = S.dropout(h, 0.5, dropout_implementation="upscale_in_train")
    loss = S.mean(S.square(S.fc(d, 1)))
    opt.SGD(0.1).minimize(loss)
    return [loss]


@pytest.mark.parametrize("mode", ["cpu", "captured"])
def test_draw_sites_keep_their_generators_run_after_run(request, mode,
                                                        capsys):
    """200 runs of a dropout program: the entry's generators and the
    run's draw list stay as many as one run makes (each run keys its
    draws from (op index, 0) again), eagerly on the CPU and in the eager
    segment of a captured run."""
    if mode == "captured":
        request.getfixturevalue("cuda_tape")
    main, startup, fetch = _build("port", _print_dropout)
    scope = Scope()
    exe = TExecutor("cpu")
    exe.run(startup, scope=scope)
    sizes = []
    for i in range(200):
        exe.run(main, feed=_feed("dropout", i % 3), fetch_list=fetch,
                scope=scope)
        (entry,) = [e for p, e in exe._cache.values() if p is main]
        sizes.append((len(entry.rngs._gens), len(entry.rngs._used)))
    assert sizes[0][0] >= 1
    assert set(sizes) == {sizes[0]}, sizes[:3]
    capsys.readouterr()


def test_an_entry_drops_the_graphs_of_a_dead_scope(cuda_tape):
    """Evaluating under a fresh scope each time: each scope's graphs go
    with it, so the entry holds the live scope's alone."""
    main, fetch, scope = _port_state("lenet")
    test = main.clone(for_test=True)
    exe = TExecutor("cpu")
    runs = []
    for seed in range(3):
        fresh = _copy_scope(scope, [v.name for v in main.list_vars()
                                    if v.persistable and scope.has(v.name)])
        exe.run(test, feed=_feed("lenet", seed), fetch_list=fetch[1:],
                scope=fresh, training=False)
        (entry,) = [e for p, e in exe._cache.values() if p is test]
        (run,) = entry._runs.values()
        runs.append(weakref.ref(run))
        del run
    assert [r() is None for r in runs] == [True, True, False]
    del fresh
    assert runs[2]() is None and not entry._runs


def test_host_constants_live_with_their_graph(cuda_tape):
    """A NumpyArrayInitializer weight reaches the device through
    assign_value's host constant: the graph that captured it keeps the
    device copy, and nothing process-wide does, on the CPU or captured."""
    from paddle_tpu_torch.utils.initializer import NumpyArrayInitializer
    value = np.arange(64 * 32, dtype=np.float32).reshape(64, 32) / 7.0
    main, startup = tir.Program(), tir.Program()
    with tir.program_guard(main, startup):
        x = tstatic.data("x", [64], "float32")
        tstatic.fc(x, 32, param_attr=TParamAttr(
            name="w", initializer=NumpyArrayInitializer(value)))
    with tprof.disable_capture():
        TExecutor("cpu").run(startup, scope=Scope())
    assert getattr(tregistry._kept, "store", None) is None
    exe = TExecutor("cpu")
    for _ in range(3):
        scope = Scope()
        exe.run(startup, scope=scope)
        np.testing.assert_array_equal(scope.find_np("w"), value)
        (entry,) = [e for _, e in exe._cache.values()]
        (run,) = entry._runs.values()
        kept = [t for g in run.graphs.values() for t in g.constants.values()]
        assert [t.numel() for t in kept] == [value.size]
        np.testing.assert_array_equal(kept[0].numpy().reshape(64, 32),
                                      value)
        assert getattr(tregistry._kept, "store", None) is None
    del run, kept


# --- captured against eager (the capture path on CPU tensors) --------------

@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_captured_runs_equal_eager_runs(cuda_tape, name, capsys):
    """Three runs of each program captured (a warm-up, then replays) and
    three eager from the same state: fetches and state bit-equal (the
    dropout masks and uniform draws too), one graph per segment, a replay
    runs no Python (the host ops aside)."""
    main, fetch, scope = _port_state(name)
    names = sorted(_persistables(main, scope))
    eager_scope = _copy_scope(scope, names)
    startup_graphs = len(cuda_tape.made)
    exe = TExecutor("cpu")
    got, want = [], []
    for seed in (0, 1, 2):
        got.append(exe.run(main, feed=_feed(name, seed), fetch_list=fetch,
                           scope=scope))
    with tprof.disable_capture():
        exe2 = TExecutor("cpu")
        for seed in (0, 1, 2):
            want.append(exe2.run(main, feed=_feed(name, seed),
                                 fetch_list=fetch, scope=eager_scope))
    for g_run, w_run in zip(got, want):
        for g, w in zip(g_run, w_run):
            np.testing.assert_array_equal(g, w)
    for n in names:
        np.testing.assert_array_equal(scope.find_np(n),
                                      eager_scope.find_np(n), err_msg=n)
    plan = tlowering.capture_plan(main, 0)
    graphs = [g for g in cuda_tape.made[startup_graphs:]
              if g.tape is not None]
    if name == "host_ops":
        # four top-level graph segments, the while body, both branches'
        # graphs where each branch ran
        assert len(graphs) >= 5
        body = [g for g in graphs if g.replays >= 9]
        assert len(body) == 1           # ten iterations a run, one capture
        assert capsys.readouterr().out.count("captured:") == 6
    else:
        assert len(plan) == 1 and len(graphs) == 1
        assert graphs[0].replays == 2
    recs = [r for r in tprof.compile_ledger().entries(kind="graph")
            if r.site.startswith(f"executor/{id(main):x}v")]
    assert recs and recs[0].tags["segments"] == len(plan)
    assert recs[0].tags["captured"] == len(
        [g for g in graphs if g.replays or name != "host_ops"]) or \
        name == "host_ops"
    # state stays bound: the scope holds the tensors the graphs read
    (entry,) = exe._cache.values()
    run = next(iter(entry[1]._runs.values()))
    for n, t in run.bound.items():
        assert scope.get(n) is t


def test_training_updates_bound_state_in_place_and_sees_scope_set(
        cuda_tape):
    main, fetch, scope = _port_state("lenet")
    exe = TExecutor("cpu")
    feed = _feed("lenet")
    exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    w, b = "fc_w_1", "fc_b_1"         # the logits' fc
    held = scope.get(w)
    before = held.clone()
    exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    assert scope.get(w) is held and not torch.equal(held, before)
    # a value set between runs (load_persistables, a user) is seen by the
    # next run, which puts the bound tensor back
    test = main.clone(for_test=True)
    (ids,) = exe.run(test, feed=feed, fetch_list=fetch[1:], scope=scope)
    scope.set(w, np.zeros(tuple(held.shape), np.float32))
    (ids0,) = exe.run(test, feed=feed, fetch_list=fetch[1:], scope=scope)
    assert scope.get(w) is held and not held.any()
    np.testing.assert_array_equal(
        ids0, np.full_like(ids0, int(np.argmax(scope.find_np(b)))))
    # a fetch with return_numpy=False is a fresh tensor every call
    a = exe.run(test, feed=feed, fetch_list=fetch[1:], scope=scope,
                return_numpy=False)[0]
    b = exe.run(test, feed=feed, fetch_list=fetch[1:], scope=scope,
                return_numpy=False)[0]
    assert a is not b and a.untyped_storage().data_ptr() != \
        b.untyped_storage().data_ptr()


def test_a_changed_state_shape_is_a_new_signature(cuda_tape):
    main, fetch, scope = _port_state("host_ops")
    exe = TExecutor("cpu")
    exe.run(main, feed=_feed("host_ops"), fetch_list=fetch, scope=scope)
    first = len(cuda_tape.made)
    scope.set("b", np.ones((5,), np.float64))         # dtype changed
    (out, _, _) = exe.run(main, feed=_feed("host_ops"), fetch_list=fetch,
                          scope=scope)
    assert len(cuda_tape.made) > first                # captured anew
    assert scope.get("b").dtype == torch.float64


def test_state_an_inference_run_writes_is_copied_out_of_the_graphs(
        cuda_tape):
    """The training program run with training=False writes its updates
    into the scope as new tensors, never into the bound ones, and never
    as memory the graphs keep; the values are the eager run's."""
    main, fetch, scope = _port_state("lenet")
    names = sorted(_persistables(main, scope))
    eager_scope = _copy_scope(scope, names)
    exe, exe2 = TExecutor("cpu"), TExecutor("cpu")
    for seed in range(3):
        exe.run(main, feed=_feed("lenet", seed), fetch_list=fetch,
                scope=scope, training=False)
        with tprof.disable_capture():
            exe2.run(main, feed=_feed("lenet", seed), fetch_list=fetch,
                     scope=eager_scope, training=False)
    (entry,) = exe._cache.values()
    run = next(iter(entry[1]._runs.values()))
    assert any(g.replays == 2 for g in cuda_tape.made)
    written = [n for n in names if scope.get(n) is not run.bound[n]]
    assert any(n.endswith("velocity_Momentum") for n in written)
    for n in names:
        t = scope.get(n)
        assert n not in written or \
            t.untyped_storage().data_ptr() not in run._owned, n
        np.testing.assert_array_equal(scope.find_np(n),
                                      eager_scope.find_np(n), err_msg=n)


def test_a_host_read_in_an_unmarked_op_fails_its_capture_naming_it(
        cuda_tape):
    if not tregistry.has_op("test_reads_host"):
        @tregistry.register_op("test_reads_host", inputs=["X"],
                               outputs=["Out"])
        def _reads(ctx, x):
            return x * float(x.sum().item())

    main = tir.Program()
    with tir.program_guard(main, tir.Program()):
        x = tstatic.data("x", [2, 2], "float32", append_batch_size=False)
        y = tstatic.scale(x, scale=2.0)
        out = main.global_block().create_var(name="out", shape=(2, 2),
                                             dtype="float32")
        main.global_block().append_op("test_reads_host", {"X": [y.name]},
                                      {"Out": ["out"]})
    with pytest.raises(tprof.CaptureError) as e:
        TExecutor("cpu").run(main, feed={"x": np.ones((2, 2), np.float32)},
                             fetch_list=[out], scope=Scope())
    msg = str(e.value)
    assert "block 0, op 1 ('test_reads_host')" in msg
    assert "executor/" in msg


def test_while_host_reads_keep_their_counts_captured(cuda_tape):
    main, fetch, scope = _port_state("host_ops")
    exe = TExecutor("cpu")
    for seed in (0, 1):
        exe.run(main, feed=_feed("host_ops", seed), fetch_list=fetch,
                scope=scope)
    tcf.reset_host_reads()
    exe.run(main, feed=_feed("host_ops", 2), fetch_list=fetch, scope=scope)
    assert tcf.host_reads["while"] == 11
    assert tcf.host_reads["while_iterations"] == 10
    assert tcf.host_reads["conditional_block"] == 1


def test_compile_cache_records_executor_entries(cuda_tape, tmp_path):
    tflags.set_flag("compile_cache_dir", str(tmp_path))
    tcc.reset_compile_cache()
    try:
        main, fetch, scope = _port_state("lenet")
        exe = TExecutor("cpu")
        for _ in range(2):
            exe.run(main, feed=_feed("lenet"), fetch_list=fetch, scope=scope)
        events = [e["event"] for e in tcc.compile_cache().events()]
        assert events.count("store") == 2 and events.count("miss") == 2
        rec = tprof.compile_ledger().entries(kind="graph")[-1]
        assert rec.cache["event"] == "store"
        doc = json.loads(open(next((tmp_path / "entries").iterdir()))
                         .read().split("\n", 1)[1])
        assert doc["token"].startswith("prog:")
    finally:
        tflags.set_flag("compile_cache_dir", "")
        tcc.reset_compile_cache()


@pytest.mark.parametrize("meta_name", ["ema", "model_average",
                                       "lookahead"])
def test_meta_optimizers_keep_copies_across_captured_runs(cuda_tape,
                                                          meta_name):
    """EMA's and ModelAverage's `apply()` swap averages in for test runs
    and restore the parameters after, and Lookahead's slow weights sync
    every k-th step: captured runs, which write the bound state in
    place, leave the scope where eager runs leave it."""
    def build():
        x = tstatic.data("x", [13], "float32")
        y = tstatic.data("y", [1], "float32")
        loss = tstatic.mean(tstatic.square_error_cost(tstatic.fc(x, 1), y))
        test = tir.default_main_program().clone(for_test=True)
        if meta_name == "lookahead":
            meta = topt.LookaheadOptimizer(topt.SGD(0.01), alpha=0.5, k=2)
            meta.minimize(loss)
        else:
            topt.SGD(0.01).minimize(loss)
            meta = (topt.ExponentialMovingAverage(0.9) if meta_name == "ema"
                    else topt.ModelAverage(0.15))
            if meta_name == "ema":
                meta.update()
        return loss, test, meta

    rng = np.random.RandomState(3)
    feeds = [{"x": rng.randn(8, 13).astype(np.float32),
              "y": rng.randn(8, 1).astype(np.float32)} for _ in range(4)]
    finals = []
    for capture in (True, False):
        tir.reset_unique_names()
        main, startup = tir.Program(), tir.Program()
        with tir.program_guard(main, startup):
            loss, test, meta = build()
        scope = Scope()
        ctx = (contextlib.nullcontext() if capture
               else tprof.disable_capture())
        with ctx, scope_guard(scope):
            exe = TExecutor("cpu")
            exe.run(startup)
            outs = []
            for i, feed in enumerate(feeds):
                exe.run(main, feed=feed, fetch_list=[loss])
                if meta_name == "lookahead":
                    meta.sync()
                elif i % 2:
                    with meta.apply(exe):
                        outs.append(exe.run(test, feed=feed,
                                            fetch_list=[loss.name])[0])
            finals.append((outs, _persistables(main, scope)))
    (c_outs, c_state), (e_outs, e_state) = finals
    for a, b in zip(c_outs, e_outs):
        np.testing.assert_array_equal(a, b)
    for n, a in e_state.items():
        np.testing.assert_array_equal(c_state[n], a, err_msg=n)


def test_an_outgrown_k8_workspace_stays_alive(monkeypatch):
    """An int8 Predictor captures one graph per batch size, each holding
    the split-K workspace it was captured with: a larger batch grows the
    workspace, and the one the smaller batch's graph holds stays alive."""
    from paddle_tpu_torch.ops.kernels import quantized_matmul as tk8
    monkeypatch.setattr(tk8, "_workspaces", {})
    monkeypatch.setattr(tk8, "_retired_workspaces", [])
    monkeypatch.setattr(tk8, "_stream", lambda device: 0)
    small = tk8._workspace(1000 + 16, torch.device("cpu"), tk8._workspaces)
    assert tk8._workspace(500, torch.device("cpu"), tk8._workspaces) \
        is small
    big = tk8._workspace(32 * 1000 + 16, torch.device("cpu"),
                         tk8._workspaces)
    assert big is not small and tk8._retired_workspaces == [small]


def test_a_predictor_and_its_clones_from_many_threads(cuda_tape,
                                                      tmp_path):
    """Eight threads (more than this box's cores need not be) serve a
    Predictor and its clones at once, with a short switch interval: the
    Executor serialises each entry's input copies, replays and output
    copies, so every request gets the logits it gets alone."""
    import sys
    import threading

    from paddle_tpu_torch import inference
    from paddle_tpu_torch.static import io
    main, startup, fetch = _build("port", _lenet)
    test = main.clone(for_test=True)
    exe = TExecutor("cpu")
    with scope_guard(Scope()):
        exe.run(startup)
        io.save_inference_model(str(tmp_path), ["img"],
                                [test.global_block().var(fetch[1])], exe,
                                main_program=test)
    cfg = inference.Config(str(tmp_path))
    cfg.disable_gpu()
    pred = inference.create_predictor(cfg)
    reqs = [_feed("lenet", i)["img"] for i in range(16)]
    with tprof.disable_capture():
        want = [pred.run({"img": x})[0] for x in reqs]
    preds = [pred] + [pred.clone() for _ in range(7)]
    got = [None] * len(reqs)
    errors = []

    def serve(p, idx):
        try:
            for i in idx:
                got[i] = p.run({"img": reqs[i]})[0]
        except Exception as e:           # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=serve,
                                    args=(p, range(k, 16, 8)))
                   for k, p in enumerate(preds)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
