"""Rank-side functions of the port's parallelism tests.

Each runs in a worker of `paddle_tpu_torch.parallel.ranks.RankPool` as
`fn(ctx, *args)` (ctx: rank, world, device, backend) and returns numpy
values. This module imports torch, numpy and the port only, never jax
or paddle_tpu, so a rank process stays free of both (each function
reports `ctx.jax_loaded`). The test files compare what comes back with
the JAX package on the same inputs.
"""
import numpy as np
import torch


def _np(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------------------- collectives
def collective(ctx, op, x, cot, attrs):
    """Run op type `op` on this rank's block x over a dp mesh of the whole
    world; returns (out, d out·cot / dx, jax_loaded)."""
    from paddle_tpu_torch.core.registry import OpContext, get_op
    from paddle_tpu_torch.parallel import bind_mesh, make_mesh
    mesh = make_mesh({"dp": ctx.world}, device="cpu")
    impl = get_op(op)
    xt = torch.tensor(x).requires_grad_()
    with bind_mesh(mesh), torch.enable_grad():
        c = OpContext(dict(attrs), 0, True, 0, "cpu")
        out = impl.fn(c, xt)
        g, = torch.autograd.grad((out * torch.tensor(cot)).sum(), [xt])
    return _np(out), _np(g), ctx.jax_loaded


def collective_noops(ctx, x):
    from paddle_tpu_torch.core.registry import OpContext, get_op
    from paddle_tpu_torch.parallel import bind_mesh, make_mesh
    mesh = make_mesh({"dp": ctx.world}, device="cpu")
    c = OpContext({}, 0, True, 0, "cpu")
    xt = torch.tensor(x)
    with bind_mesh(mesh):
        outs = [_np(get_op(o).fn(c, xt)) for o in ("c_sync_calc_stream",
                                                   "c_sync_comm_stream")]
        empty = [get_op(o).fn(c) for o in ("c_comm_init", "c_gen_unique_id")]
    return outs, empty


# ------------------------------------------------------------ static dp/tp
def fc_program(S, ir, ParamAttr, tp=False, bn=False, optimizer=None,
               conv=False):
    """tests/test_parallel.py's fc + Momentum program (tp: Megatron
    shardings on the two fcs; bn: a batch norm after the first; conv: a
    conv + BN stem on a [3, 8, 8] image) in the package of `S` / `ir`."""
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    main.random_seed = startup.random_seed = 11
    with ir.program_guard(main, startup):
        if conv:
            x = S.data("x", [-1, 3, 8, 8], append_batch_size=False)
            h = S.conv2d(x, 4, 3, padding=1, bias_attr=False)
            h = S.batch_norm(h, act="relu")
            h = S.pool2d(h, 2, "avg", 2)
            h = S.reshape(h, [-1, 64])
        else:
            x = S.data("x", [-1, 32], append_batch_size=False)
            h = x
        y = S.data("y", [-1, 1], dtype="int64", append_batch_size=False)
        a1 = ParamAttr(name="w1", sharding=(None, "tp") if tp else None)
        a2 = ParamAttr(name="w2", sharding=("tp", None) if tp else None)
        h = S.fc(h, 64, param_attr=a1, act="relu")
        if bn:
            h = S.batch_norm(h)
        logits = S.fc(h, 4, param_attr=a2)
        loss = S.mean(S.softmax_with_cross_entropy(logits, y))
        total = S.reduce_sum(logits)
        optimizer(loss, startup)
    return main, startup, loss, total


def fc_optimizer(pt, kind="momentum"):
    """The update of the fc program in the package `pt`: Momentum, or one
    whose ops reduce over a whole parameter (a global-norm clip, LARS,
    LAMB, dpsgd's clip without noise) or over all the gradients (AMP's
    overflow check under a dynamic loss scale: the fc stays float32, the
    scale starts at 1e32 and drops to 1e22 after one overflow, and the
    rate suits gradients of 1e9)."""
    import importlib
    clip = importlib.import_module(pt.__name__ + ".clip")
    amp = importlib.import_module(pt.__name__ + ".amp")

    def opt(loss, startup):
        if kind == "momentum":
            o = pt.optimizer.Momentum(0.05, 0.9)
        elif kind == "clip":
            o = pt.optimizer.Momentum(
                0.05, 0.9, grad_clip=clip.GradientClipByGlobalNorm(0.05))
        elif kind == "lars":
            o = pt.optimizer.LarsMomentum(0.5, 0.9, lars_coeff=0.1)
        elif kind == "dpsgd":
            o = pt.optimizer.Dpsgd(0.5, clip=0.05, batch_size=1.0,
                                   sigma=0.0)
        elif kind == "amp":
            o = amp.decorate(
                pt.optimizer.Momentum(1e-20, 0.9),
                amp.AutoMixedPrecisionLists(custom_black_list={"mul"}),
                init_loss_scaling=1e32, decr_every_n_nan_or_inf=1,
                decr_ratio=1e-10, use_dynamic_loss_scaling=True)
        else:
            o = pt.optimizer.Lamb(0.01)
        o.minimize(loss, startup_program=startup)
    return opt


def _port_fc(tp=False, bn=False, conv=False, opt="momentum"):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import static as S
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.utils.param_attr import ParamAttr
    return fc_program(S, ir, ParamAttr, tp=tp, bn=bn,
                      optimizer=fc_optimizer(pt, opt), conv=conv)


def train_static(ctx, mesh_axes, state, batches, tp=False, bn=False,
                 conv=False, scale="coeff", opt="momentum"):
    """Train the fc program from `state` (numpy, the JAX package's
    startup) through CompiledProgram over `mesh_axes`; returns the
    per-step (loss, reduce_sum) fetches and the final w1 (gathered)."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.parallel import (BuildStrategy, CompiledProgram,
                                           make_mesh)
    from paddle_tpu_torch.weights import scope_from_jax
    main, startup, loss, total = _port_fc(tp=tp, bn=bn, conv=conv, opt=opt)
    scope = scope_from_jax(state, Scope(), "cpu", program=main)
    exe = Executor("cpu")
    bs = BuildStrategy()
    if scale == "one":
        bs.gradient_scale_strategy = BuildStrategy.GradientScaleStrategy.One
    prog = main
    if mesh_axes:
        prog = CompiledProgram(main, bs).with_data_parallel(
            loss_name=loss.name, mesh=make_mesh(mesh_axes, device="cpu"))
    out = []
    for xs, ys in batches:
        lv, tv, w1 = exe.run(prog, feed={"x": xs, "y": ys},
                             fetch_list=[loss, total, "w1"], scope=scope)
        out.append((float(np.asarray(lv).reshape(-1)[0]),
                    float(np.asarray(tv).reshape(-1)[0])))
    return out, np.asarray(w1), tuple(scope.get("w1").shape), \
        ctx.jax_loaded


def uneven_batch(ctx, state, xs, ys):
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.parallel import CompiledProgram, make_mesh
    from paddle_tpu_torch.weights import scope_from_jax
    main, startup, loss, _ = _port_fc()
    scope = scope_from_jax(state, Scope(), "cpu", program=main)
    prog = CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=make_mesh({"dp": ctx.world},
                                            device="cpu"))
    try:
        Executor("cpu").run(prog, feed={"x": xs, "y": ys},
                            fetch_list=[loss], scope=scope)
    except EnforceError as e:
        return str(e)
    return None


def axis_program(S, ir, ParamAttr):
    """Ops whose axis attr names the batch dim (they read the whole
    batch), beside the same ops on other axes, and a reshape that folds
    the batch into dim 0 (a fetch dp cannot classify)."""
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    main.random_seed = startup.random_seed = 11
    with ir.program_guard(main, startup):
        x = S.data("x", [-1, 32], append_batch_size=False)
        h = S.fc(x, 16, param_attr=ParamAttr(name="w"))
        outs = [S.argmax(h, axis=0), S.argmin(h, axis=-2),
                S.softmax(h, axis=0), S.log_softmax(h, axis=0),
                S.argmax(h, axis=1), S.softmax(h), S.pad(h, [1, 2, 0, 1])]
        folded = S.reshape(h, [-1, 8])
    return main, startup, outs, folded


def axis_ops(ctx, state, xs):
    """The axis program over dp=world: its fetches, and the message the
    folded reshape's fetch raises."""
    from paddle_tpu_torch import static as S
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.parallel import CompiledProgram, make_mesh
    from paddle_tpu_torch.utils.param_attr import ParamAttr
    from paddle_tpu_torch.weights import scope_from_jax
    main, _, outs, folded = axis_program(S, ir, ParamAttr)
    scope = scope_from_jax(state, Scope(), "cpu", program=main)
    prog = CompiledProgram(main).with_data_parallel(
        mesh=make_mesh({"dp": ctx.world}, device="cpu"))
    exe = Executor("cpu")
    got = [np.asarray(v) for v in exe.run(prog, feed={"x": xs},
                                          fetch_list=outs, scope=scope)]
    try:
        exe.run(prog, feed={"x": xs}, fetch_list=[folded], scope=scope)
        msg = None
    except EnforceError as e:
        msg = str(e)
    return got, msg


def parallel_executor(ctx, state, batches):
    """The legacy ParallelExecutor over the same program: a list of
    per-device feed dicts, concatenated."""
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel_executor import ParallelExecutor
    from paddle_tpu_torch.weights import scope_from_jax
    main, startup, loss, _ = _port_fc()
    scope = scope_from_jax(state, Scope(), "cpu", program=main)
    pe = ParallelExecutor(use_cuda=False, loss_name=loss.name,
                          main_program=main, scope=scope,
                          mesh=make_mesh({"dp": ctx.world}, device="cpu"))
    out = []
    for xs, ys in batches:
        h = len(xs) // 2
        halves = [{"x": xs[:h], "y": ys[:h]}, {"x": xs[h:], "y": ys[h:]}]
        lv, = pe.run([loss], feed=halves)
        out.append(float(np.asarray(lv).reshape(-1)[0]))
    return out, pe.device_count


# --------------------------------------------------------------- eager dp
def data_parallel(ctx, params, xs, ys):
    """nn.DataParallel.value_and_grad of a Linear's mean squared error:
    the global loss and the replicated gradients."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.parallel import make_mesh
    mesh = make_mesh({"dp": ctx.world}, device="cpu")
    layer = nn.Linear(params["weight"].shape[0], params["weight"].shape[1],
                      device="cpu")
    dp = nn.DataParallel(layer, mesh)
    dp.set_state_dict({k: torch.tensor(v) for k, v in params.items()})

    def loss_fn(model, x, y):
        return ((model(x) - y) ** 2).mean()

    loss, grads = dp.value_and_grad(loss_fn)(
        None, torch.tensor(xs), torch.tensor(ys))
    y = dp(torch.tensor(xs))
    return float(loss), {k: _np(g) for k, g in grads.items()}, _np(y)


# -------------------------------------------------------------------- moe
def moe(ctx, x, gw, wi, wo, cot):
    """switch_moe over ep=world: this rank's expert slices; returns y,
    aux and the gradients summed over the group (seeded 1/P)."""
    from paddle_tpu_torch.ops.collective import all_reduce
    from paddle_tpu_torch.parallel import bind_mesh, make_mesh, switch_moe
    mesh = make_mesh({"ep": ctx.world}, device="cpu")
    e = gw.shape[1]
    lo, n = ctx.rank * (e // ctx.world), e // ctx.world
    leaves = [torch.tensor(a).requires_grad_() for a in
              (x, gw, wi[lo:lo + n], wo[lo:lo + n])]
    with bind_mesh(mesh), torch.enable_grad():
        y, aux = switch_moe(*leaves, mesh=mesh)
        loss = ((y * torch.tensor(cot)).sum() + 0.01 * aux) / ctx.world
        g = torch.autograd.grad(loss, leaves)
        gx = all_reduce(g[0], "ep")
        ggw = all_reduce(g[1], "ep")
    return _np(y), float(aux), _np(gx), _np(ggw), _np(g[2]), _np(g[3])


def moe_static(ctx, state, xs, ys, mesh_axes):
    """tests/test_parallel.py's static switch_moe program (experts
    ParamAttr-sharded over ep) through CompiledProgram: two SGD steps."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import static as S
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.parallel import CompiledProgram, make_mesh
    from paddle_tpu_torch.utils.param_attr import ParamAttr
    from paddle_tpu_torch.weights import scope_from_jax
    main, startup, loss = moe_program(S, ir, pt.optimizer, ParamAttr)
    scope = scope_from_jax(state, Scope(), "cpu", program=main)
    prog = main
    if mesh_axes:
        prog = CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, mesh=make_mesh(mesh_axes, device="cpu"))
    exe = Executor("cpu")
    return [float(np.asarray(exe.run(prog, feed={"x": xs, "y": ys},
                                     fetch_list=[loss], scope=scope)[0])
                  .reshape(-1)[0]) for _ in range(2)]


def moe_program(S, ir, optimizer, ParamAttr):
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    main.random_seed = startup.random_seed = 7
    with ir.program_guard(main, startup):
        x = S.data("x", [16, 8], "float32", append_batch_size=False)
        y = S.data("y", [16, 1], "float32", append_batch_size=False)
        mo, aux = S.switch_moe(x, num_experts=4, hidden_dim=16,
                               expert_attr=ParamAttr(
                                   name="moe2_wi",
                                   sharding=("ep", None, None)))
        pred = S.fc(mo, 1)
        loss = S.mean(S.square_error_cost(pred, y)) + S.scale(aux,
                                                              scale=0.01)
        optimizer.SGD(0.05).minimize(loss)
    return main, startup, loss


# -------------------------------------------------------- context parallel
def attention(ctx, impl, q, k, v, mask, cot, causal, mesh_axes,
              batch_axis=None):
    """shard_map_attention on this rank's shards of the global arrays;
    returns its output shard and the gradients of sum(out·cot) for its
    q, k, v shards."""
    from paddle_tpu_torch.parallel import (make_mesh, shard_map_attention,
                                           shard_sequence)
    mesh = make_mesh(mesh_axes, device="cpu")

    def cut(a, seq_dim=1):
        return shard_sequence(torch.tensor(a), mesh, "sp", batch_axis,
                              seq_dim)
    qkv = [cut(a).clone().requires_grad_() for a in (q, k, v)]
    m = None if mask is None else cut(mask, 3)
    with torch.enable_grad():
        out = shard_map_attention(mesh, *qkv, mask=m, causal=causal,
                                  impl=impl, batch_axis=batch_axis)
        g = torch.autograd.grad((out * cut(cot)).sum(), qkv)
    coords = (mesh.coord(batch_axis) if batch_axis else 0,
              mesh.coord("sp"))
    return coords, _np(out), [_np(t) for t in g]


# ---------------------------------------------------------------- pipeline
def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _mse(y, t):
    return ((y - t) ** 2).mean()


def pipeline(ctx, schedule, M, v, stacked, x, tgt, remat=True):
    """Pipeline.loss_and_grad and __call__ over pp=world from the stack_*
    layout; returns the loss, this rank's grads and the forward."""
    from paddle_tpu_torch.parallel import Pipeline, make_mesh
    mesh = make_mesh({"pp": ctx.world}, device="cpu")
    pipe = Pipeline(mesh, _stage, ctx.world, M, schedule=schedule,
                    virtual_stages=v, remat=remat)
    local = pipe.local_params(stacked)
    to_t = (lambda t: {k: torch.tensor(a) for k, a in t.items()})
    local = [to_t(c) for c in local] if v > 1 else to_t(local)
    loss, g = pipe.loss_and_grad(_mse, local, torch.tensor(x),
                                 torch.tensor(tgt))
    y = pipe(local, torch.tensor(x))
    to_np = (lambda t: {k: _np(a) for k, a in t.items()})
    g = [to_np(c) for c in g] if v > 1 else to_np(g)
    return float(loss), g, _np(y), ctx.jax_loaded


def pipeline_program(S, ir, optimizer_mod, PipelineOptimizer, schedule,
                     nsec, M, v=1):
    """A static MLP cut into `nsec` sections of one fc (tanh) each."""
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    main.random_seed = startup.random_seed = 3
    with ir.program_guard(main, startup):
        x = S.data("x", [-1, 8], append_batch_size=False)
        y = S.data("y", [-1, 8], append_batch_size=False)
        h, cuts = x, []
        for i in range(nsec):
            h = S.fc(h, 8, act="tanh")
            if i < nsec - 1:
                cuts.append(h)
        loss = S.mean(S.square_error_cost(h, y))
        opt = optimizer_mod.SGD(0.1)
        if PipelineOptimizer is not None:
            opt = PipelineOptimizer(opt, num_microbatches=M, cut_list=cuts,
                                    schedule=schedule, virtual_stages=v)
        opt.minimize(loss)
    return main, startup, loss


def pipeline_static(ctx, state, xs, ys, schedule, M, v, steps=2):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import static as S
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.parallel import (PipelineCompiledProgram,
                                           PipelineOptimizer, make_mesh)
    from paddle_tpu_torch.weights import scope_from_jax
    main, startup, loss = pipeline_program(
        S, ir, pt.optimizer, PipelineOptimizer, schedule, ctx.world * v,
        M, v)
    scope = scope_from_jax(state, Scope(), "cpu", program=main)
    prog = PipelineCompiledProgram(
        main, make_mesh({"pp": ctx.world}, device="cpu")
    ).with_data_parallel(distributed_strategy=None)
    exe = Executor("cpu")
    losses = [float(np.asarray(exe.run(prog, feed={"x": xs, "y": ys},
                                       fetch_list=[loss], scope=scope)[0])
                    .reshape(-1)[0]) for _ in range(steps)]
    return losses, {n: np.asarray(scope.find_np(n)) for n in state}


# -------------------------------------------------------------- grad hooks
def dgc(ctx, grads_per_rank, steps, kw):
    """dgc_allreduce over dp=world for `steps` steps from zero state;
    returns the reduced tensors of each step and the final state."""
    from paddle_tpu_torch.parallel import (bind_mesh, dgc_allreduce,
                                           dgc_init_state, make_mesh)
    mesh = make_mesh({"dp": ctx.world}, device="cpu")
    g = {k: torch.tensor(a[ctx.rank]) for k, a in grads_per_rank.items()}
    state = dgc_init_state(g)
    outs = []
    with bind_mesh(mesh):
        for s in range(steps):
            red, state = dgc_allreduce(state, g, s, **kw)
            outs.append({k: _np(t) for k, t in red.items()})
    return outs, {k: {n: _np(t) for n, t in d.items()}
                  for k, d in state.items()}


def local_sgd(ctx, params_per_rank, step, k):
    from paddle_tpu_torch.parallel import (bind_mesh, local_sgd_average,
                                           make_mesh)
    mesh = make_mesh({"dp": ctx.world}, device="cpu")
    p = {n: torch.tensor(a[ctx.rank]) for n, a in params_per_rank.items()}
    with bind_mesh(mesh):
        out = local_sgd_average(p, step, k)
    return {n: _np(t) for n, t in out.items()}
