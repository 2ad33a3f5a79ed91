"""slim/prune.py, distill.py and nas.py of the port against the JAX
package's, on the CPU.

* `Pruner` (l1_norm and channel) gives the JAX package's masks and
  pruned values, `sensitivity` its {param: {ratio: metric}} dict and
  `sparsity` its fraction, on the same seeded numpy parameters.
* `distill.merge` gives the JAX `merge`'s program (vars and ops, op for
  op), the teacher frozen (stop_gradient, not trainable) and its
  persistables copied under the prefix; a step of the merged program
  moves the student and leaves the teacher bit-equal.
* The soft-label, L2 and FSP losses agree with JAX's within 1e-6, and
  none sends a gradient into the teacher's side.
* `SAController` gives the JAX package's token and reward history for
  the same seed, through `NASSearcher` under a FLOPs constraint that no
  evaluated candidate exceeds.
* `flops_of` of a 64 x 64 square matmul is 2 * 64^3 in both packages;
  on a small padded conv net they differ (FlopCounterMode counts every
  tap of the conv, padding included, and no elementwise op; XLA counts
  only the taps inside the input, and the elementwise ops): the
  divergence is pinned with both numbers.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import ir as jir
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.slim import distill as jdistill
from paddle_tpu.slim import nas as jnas
from paddle_tpu.slim import prune as jprune
from paddle_tpu_torch import optimizer as toptimizer
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope as TScope, scope_guard
from paddle_tpu_torch.slim import distill as tdistill
from paddle_tpu_torch.slim import nas as tnas
from paddle_tpu_torch.slim import prune as tprune

TOL = 1e-6


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {"conv_w": rng.randn(8, 4, 3, 3).astype(np.float32),
            "fc_w": rng.randn(16, 10).astype(np.float32)}


def _scopes(params):
    js, ts = JScope(), TScope()
    for k, v in params.items():
        js.set(k, v.copy())
        ts.set(k, torch.from_numpy(v.copy()))
    return js, ts


@pytest.mark.parametrize("criterion", ["l1_norm", "channel"])
def test_pruner_and_sparsity_match_jax(criterion):
    params = _params()
    js, ts = _scopes(params)
    ratios = {"conv_w": 0.5, "fc_w": 0.3}
    jm = jprune.Pruner(criterion).prune(js, ratios)
    tm = tprune.Pruner(criterion).prune(ts, ratios)
    for name in ratios:
        np.testing.assert_array_equal(tm[name], jm[name])
        np.testing.assert_array_equal(ts.find_np(name), js.find_np(name))
    if criterion == "channel":     # whole output channels, shapes kept
        w = ts.find_np("conv_w")
        assert w.shape == (8, 4, 3, 3)
        assert int((np.abs(w).sum((1, 2, 3)) == 0).sum()) == 4
    names = sorted(params)
    assert tprune.sparsity(ts, names) == jprune.sparsity(js, names) > 0
    # an optimizer step un-zeros entries; apply_masks restores them
    ts.set("conv_w", torch.from_numpy(params["conv_w"]))
    tprune.Pruner(criterion).apply_masks(ts, tm)
    np.testing.assert_array_equal(ts.find_np("conv_w"), js.find_np("conv_w"))


def test_sensitivity_matches_jax():
    params = _params(1)
    js, ts = _scopes(params)

    def metric(scope):
        return lambda: float(sum(np.square(scope.find_np(n)).sum()
                                 for n in sorted(params)))

    ratios = (0.3, 0.5)
    want = jprune.sensitivity(None, None, js, sorted(params), metric(js),
                              ratios)
    got = tprune.sensitivity(None, None, ts, sorted(params), metric(ts),
                             ratios)
    assert got == want
    for name in params:      # restored after each ratio
        np.testing.assert_array_equal(ts.find_np(name), params[name])


def _nets(ir, static):
    """A teacher (fc 8 -> 16 -> 4) and a student (fc 8 -> 4) over feed
    `img`, each its own Program."""
    ir.reset_unique_names()
    progs = {}
    for kind, hidden in (("teacher", 16), ("student", None)):
        main, startup = ir.Program(), ir.Program()
        with ir.program_guard(main, startup):
            x = static.data("img", [8], "float32")
            h = static.fc(x, hidden, act="relu") if hidden else x
            logits = static.fc(h, 4)
        progs[kind] = (main, startup, logits)
    return progs


def test_merge_matches_jax_and_freezes_the_teacher():
    rng = np.random.RandomState(2)
    jp, tp = _nets(jir, pt.static), _nets(tir, tstatic)
    assert tp["teacher"][0].to_dict() == jp["teacher"][0].to_dict()
    tvals = {v.name: (0.3 * rng.randn(*v.shape)).astype(np.float32)
             for v in tp["teacher"][0].list_vars() if v.persistable}
    js, ts = JScope(), TScope()
    for k, v in tvals.items():
        js.set(k, v)
        ts.set(k, torch.from_numpy(v.copy()))
    jdistill.merge(jp["teacher"][0], jp["student"][0], {"img": "img"},
                   scope=js)
    merged = tdistill.merge(tp["teacher"][0], tp["student"][0],
                            {"img": "img"}, scope=ts)
    assert merged is tp["student"][0]
    assert merged.to_dict() == jp["student"][0].to_dict()
    block = merged.global_block()
    for name, v in tvals.items():
        d = block.var("teacher_" + name).desc
        assert d.stop_gradient and not d.trainable
        np.testing.assert_array_equal(ts.find_np("teacher_" + name), v)
    assert not block.has_var("teacher_img")
    # a step of the merged program: student soft-label + CE from the
    # port's static layers; the teacher's vars stay bit-equal
    student_logits = tp["student"][2]
    t_logits = block.var("teacher_" + tp["teacher"][2].name)
    with tir.program_guard(merged, tp["student"][1]):
        label = tstatic.data("label", [1], "int64")
        ce = tstatic.mean(tstatic.softmax_with_cross_entropy(
            student_logits, label))
        soft = tstatic.mean(tstatic.softmax_with_cross_entropy(
            tstatic.scale(student_logits, 0.25),
            tstatic.softmax(tstatic.scale(t_logits, 0.25)),
            soft_label=True))
        loss = tstatic.elementwise_add(ce, tstatic.scale(soft, 16.0))
        toptimizer.Momentum(0.1, 0.9).minimize(loss)
    exe = TExecutor("cpu")
    with scope_guard(ts):
        exe.run(tp["student"][1])
        feed = {"img": rng.randn(6, 8).astype(np.float32),
                "label": rng.randint(0, 4, (6, 1)).astype(np.int64)}
        student = {v.name: ts.find_np(v.name) for v in
                   tp["student"][0].global_block().vars.values()
                   if v.is_parameter and not v.name.startswith("teacher_")}
        for _ in range(2):
            (lv,) = exe.run(merged, feed=feed, fetch_list=[loss])
        assert np.isfinite(lv).all()
    for name, v in tvals.items():
        np.testing.assert_array_equal(ts.find_np("teacher_" + name), v)
    assert student and all(not np.array_equal(ts.find_np(n), v)
                           for n, v in student.items())


def test_losses_match_jax_and_detach_the_teacher():
    import jax.numpy as jnp
    rng = np.random.RandomState(3)
    tl, sl = rng.randn(2, 5, 7).astype(np.float32) * 3
    fa, fb, ga, gb = (rng.randn(2, c, 4, 4).astype(np.float32)
                      for c in (3, 5, 3, 5))
    cases = (("soft_label_loss", (tl, sl), {"temperature": 4.0}),
             ("l2_loss", (fa, ga), {}),
             ("fsp_loss", (fa, fb, ga, gb), {}))
    for name, args, kw in cases:
        want = float(getattr(jdistill, name)(
            *[jnp.asarray(a) for a in args], **kw))
        ts = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
              for a in args]
        got = getattr(tdistill, name)(*ts, **kw)
        assert abs(float(got.detach()) - want) <= TOL * max(1.0, abs(want)), name
        got.backward()
        teacher = ts[:1] if len(ts) == 2 else ts[:2]
        assert all(t.grad is None for t in teacher), name
        assert all(t.grad is not None for t in ts[len(teacher):]), name


class _Space(tnas.SearchSpace):
    def __init__(self, table):
        self.table = table

    def init_tokens(self):
        return [0] * len(self.table)

    def range_table(self):
        return list(self.table)


def _reward(tokens):
    return -float(sum((t - 2) ** 2 for t in tokens))


def test_sa_controller_and_searcher_match_jax():
    table = [4, 5, 3]
    for seed in (0, 7):
        jc = jnas.SAController(seed=seed, init_temperature=10.0)
        tc = tnas.SAController(seed=seed, init_temperature=10.0)
        for c in (jc, tc):
            c.reset(table)
        for _ in range(12):
            jt, tt = jc.next_tokens(), tc.next_tokens()
            assert tt == jt
            assert tc.update(tt, _reward(tt)) == jc.update(jt, _reward(jt))
        assert tc.best_tokens == jc.best_tokens
    evaluated = []

    def flops_fn(tokens):
        return 10.0 * sum(tokens)

    def eval_fn(tokens):
        evaluated.append(list(tokens))
        return _reward(tokens)

    runs = []
    for mod in (jnas, tnas):
        space = _Space(table)
        s = mod.NASSearcher(space, mod.SAController(seed=3),
                            max_flops=50.0, flops_fn=flops_fn,
                            search_steps=10)
        runs.append(s.search(eval_fn))
    assert runs[0] == runs[1]
    assert evaluated and all(flops_fn(t) <= 50.0 for t in evaluated)


def test_flops_of_a_square_matmul_matches_jax():
    import jax.numpy as jnp
    a = np.random.RandomState(4).randn(64, 64).astype(np.float32)
    got = tnas.flops_of(torch.matmul, torch.from_numpy(a),
                        torch.from_numpy(a))
    want = jnas.flops_of(jnp.matmul, jnp.asarray(a), jnp.asarray(a))
    assert got == want == 2 * 64 ** 3


def test_flops_of_a_conv_net_diverges_from_xla_pinned():
    """ROADMAP Queue 3: FlopCounterMode counts the conv's every tap,
    the padded ones too, and the matmul (2 per multiply-add), and no
    elementwise op; XLA's cost analysis counts the conv's taps inside
    the input only, plus the add, the relu and the mean."""
    import jax
    import jax.numpy as jnp
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    w = rng.randn(4, 3, 3, 3).astype(np.float32)
    fw = rng.randn(4, 5).astype(np.float32)

    def tnet(x, w, fw):
        h = torch.relu(torch.nn.functional.conv2d(x, w, padding=1) + 1.0)
        return h.mean((2, 3)) @ fw

    def jnet(x, w, fw):
        h = jax.lax.conv_general_dilated(x, w, (1, 1), "SAME")
        h = jnp.maximum(h + 1.0, 0.0)
        return h.mean((2, 3)) @ fw

    got = tnas.flops_of(tnet, *(torch.from_numpy(a) for a in (x, w, fw)))
    want = jnas.flops_of(jnet, *(jnp.asarray(a) for a in (x, w, fw)))
    conv = 2 * 2 * 4 * 8 * 8 * 3 * 3 * 3
    matmul = 2 * 2 * 4 * 5
    assert got == conv + matmul == 27728
    inside = 2 * 2 * 4 * 3 * (8 * 3 - 2) ** 2      # taps within 8 x 8
    assert want == 24848 and inside + matmul < want < got
