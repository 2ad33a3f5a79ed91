"""Control-flow constructs for the static-graph API.

Counterpart of paddle_tpu/static/control_flow.py (fluid's While,
StaticRNN, DynamicRNN, Switch, cond / case): each construct records a
sub-block in the Program and emits one op (`while`, `scan` or
`conditional_block`, ops/control_flow.py), the JAX package's program op
for op.

Carry discipline: a variable is loop-carried iff the body writes it via
`assign(new_value, output=var)` (fluid's in-place update idiom). Values
only read inside a body need no declaration: a sub-block runs over the
enclosing environment.

DynamicRNN consumes padded [B, T, ...] + lengths and freezes each
sequence's state and output past its length (the reference shrinks a
LoD batch instead; the arithmetic is the same).
"""
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.ir import Variable, default_main_program, unique_name
from paddle_tpu_torch.static import common as _c
from paddle_tpu_torch.static.helper import LayerHelper

__all__ = ["While", "StaticRNN", "DynamicRNN", "cond", "case",
           "switch_case", "Switch"]


def _external_writes(block):
    """Names written by block ops that live in an ancestor block (the
    loop-carried set), in first-write order."""
    writes = []
    for op in block.ops:
        for names in op.outputs.values():
            for n in names:
                if n not in block.vars and n not in writes:
                    writes.append(n)
    return writes


class _BlockGuard:
    def __init__(self, program, on_exit):
        self.program = program
        self.on_exit = on_exit

    def __enter__(self):
        self.block = self.program._create_block()
        return self.block

    def __exit__(self, exc_type, *a):
        self.program._rollback()
        if exc_type is None:
            self.on_exit(self.block)
        return False


class While:
    """fluid.layers.While (control_flow.py:763).

        i = fill_constant([1], "int64", 0)
        cond = less_than(i, n)
        w = While(cond)
        with w.block():
            ...compute...
            assign(increment(i), i)        # carried update
            assign(less_than(i, n), cond)  # condition update (required)
    """

    def __init__(self, cond, is_test=False, name=None):
        self.cond = cond
        self.program = default_main_program()

    def block(self):
        return _BlockGuard(self.program, self._build)

    def _build(self, sub):
        parent = self.program.current_block()
        carry = _external_writes(sub)
        enforce(self.cond.name in carry,
                "While body must update the condition variable %r via "
                "assign(..., output=cond)", self.cond.name)
        parent.append_op(
            "while",
            {"Condition": [self.cond.name], "Carry": list(carry)},
            {"CarryOut": list(carry)},
            {"sub_block": sub.idx, "carry_vars": list(carry),
             "cond_var": self.cond.name})


class StaticRNN:
    """fluid.layers.StaticRNN (control_flow.py:291) → one `scan` op.

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)          # x: [T, ...] time-major
            h = rnn.memory(init=h0)
            nh = some_layers(x_t, h)
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        out, = rnn()                          # [T, ...]
    """

    def __init__(self, name=None):
        self.program = default_main_program()
        self._inputs = []    # (parent [T,...] var, sub x_t var)
        self._mems = []      # (sub mem var, parent init var)
        self._outputs = []   # sub vars
        self._outs_parent = None
        self._sub = None
        self._guard = None

    def step(self):
        self._guard = _BlockGuard(self.program, self._build)
        return self._guard

    def _in_step(self):
        enforce(self.program.current_block().parent_idx >= 0,
                "call inside `with rnn.step():`")
        return self.program.current_block()

    def step_input(self, x):
        sub = self._in_step()
        shape = None if x.shape is None else tuple(x.shape[1:])
        xt = sub.create_var(name=unique_name(x.name + "@step"),
                            shape=shape, dtype=x.dtype,
                            stop_gradient=bool(x.desc.stop_gradient))
        self._inputs.append((x, xt))
        return xt

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=1):
        enforce(init is not None,
                "StaticRNN.memory requires init= (create it with "
                "fill_constant_batch_size_like before the loop)")
        sub = self._in_step()
        mem = sub.create_var(name=unique_name(init.name + "@mem"),
                             shape=init.shape, dtype=init.dtype,
                             stop_gradient=False)
        self._mems.append((mem, init))
        return mem

    def update_memory(self, mem, new):
        sub = self._in_step()
        sub.append_op("assign", {"X": [new.name]}, {"Out": [mem.name]})

    def step_output(self, o):
        self._in_step()
        self._outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _build(self, sub):
        parent = self.program.current_block()
        enforce(self._inputs or self._mems, "empty StaticRNN")
        t_dim = None
        for x, _ in self._inputs:
            if x.shape is not None:
                t_dim = x.shape[0]
                break
        ys = []
        for o in self._outputs:
            shape = None
            if o.shape is not None:
                shape = (t_dim if t_dim is not None else -1,) + tuple(o.shape)
            ys.append(parent.create_var(
                name=unique_name(o.name + "@ys"), shape=shape,
                dtype=o.dtype, stop_gradient=False))
        finals = [parent.create_var(name=unique_name(m.name + "@final"),
                                    shape=m.shape, dtype=m.dtype,
                                    stop_gradient=False)
                  for m, _ in self._mems]
        parent.append_op(
            "scan",
            {"Xs": [x.name for x, _ in self._inputs],
             "Init": [i.name for _, i in self._mems]},
            {"YsOut": [y.name for y in ys],
             "CarryOut": [f.name for f in finals]},
            {"sub_block": sub.idx,
             "x_vars": [xt.name for _, xt in self._inputs],
             "carry_vars": [m.name for m, _ in self._mems],
             "y_vars": [o.name for o in self._outputs]})
        self._outs_parent = ys
        self._finals = finals

    def __call__(self):
        enforce(self._outs_parent is not None, "StaticRNN not built yet")
        outs = self._outs_parent
        return outs[0] if len(outs) == 1 else outs

    def final_states(self):
        return self._finals


class DynamicRNN:
    """fluid.layers.DynamicRNN (control_flow.py:1999), padded redesign:

        drnn = DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x, lens)     # x: [B, T, D] batch-major
            h = drnn.memory(init=h0)           # [B, H]
            nh = some_layers(x_t, h)
            drnn.update_memory(h, nh)          # frozen past each seq's len
            drnn.output(nh)
        out = drnn()                           # [B, T, H], zero past lens

    Memory updates apply only while t < len(seq) — finished rows keep
    their state exactly as fluid's shrinking-batch execution does; step
    outputs are zero-masked past each row's length.
    """

    def __init__(self, name=None):
        self.program = default_main_program()
        self._rnn = StaticRNN()
        self._lens = None
        self._tvar = None
        self._outputs = []
        self._guard = None

    def block(self):
        g = self._rnn.step()

        class _G:
            def __enter__(_s):
                g.__enter__()
                return self

            def __exit__(_s, *exc):
                return g.__exit__(*exc)

        return _G()

    def step_input(self, x, lens=None):
        enforce(lens is not None or self._lens is not None,
                "first step_input needs lens= (sequence lengths [B])")
        if lens is not None:
            self._lens = lens
        # the transpose + time-index streams are PRE-loop computation: they
        # must be recorded in the parent block, not the step sub-block
        prev = self.program._current_block_idx
        self.program._current_block_idx = \
            self.program.current_block().parent_idx
        try:
            helper = LayerHelper("drnn")
            ndim = len(x.shape)
            xt_major = _c.transpose(x, [1, 0] + list(range(2, ndim)))
            steps = None
            if self._tvar is None:
                self._maxlen = int(x.shape[1])
                steps = helper.create_tmp(dtype="int64", stop_gradient=True)
                helper.append_op("range", {}, {"Out": [steps]},
                                 {"start": 0, "end": self._maxlen,
                                  "step": 1, "dtype": "int64"})
        finally:
            self.program._current_block_idx = prev
        if steps is not None:
            self._tvar = self._rnn.step_input(steps)  # scalar per step
        return self._rnn.step_input(xt_major)

    def memory(self, init=None, **kw):
        return self._rnn.memory(init=init, **kw)

    def update_memory(self, mem, new):
        # freeze rows whose sequence already ended: t < lens ? new : mem.
        # built from primitive ops — less_than broadcasts t [] vs lens [B]
        sub = self._rnn._in_step()
        helper = LayerHelper("drnn")
        active = _c.less_than(self._tvar, self._lens)       # [B] bool
        nd = len(mem.shape) if mem.shape is not None else 2
        for _ in range(nd - 1):
            active = _c.unsqueeze(active, [-1])
        sel = helper.create_tmp(dtype=new.dtype)
        helper.append_op("where", {"Condition": active, "X": new, "Y": mem},
                         {"Out": [sel]})
        sub.append_op("assign", {"X": [sel.name]}, {"Out": [mem.name]})

    def output(self, *outs):
        for o in outs:
            self._rnn.step_output(o)
            self._outputs.append(o)

    def __call__(self):
        ys = self._rnn()
        ys = ys if isinstance(ys, list) else [ys]
        outs = []
        for y in ys:
            # back to batch-major and zero past each row's length
            ndim = len(y.shape) if y.shape is not None else 3
            ym = _c.transpose(y, [1, 0] + list(range(2, ndim)))
            mask = _c.sequence_mask(self._lens, maxlen=self._maxlen,
                                    dtype=ym.dtype)       # [B, T]
            for _ in range(ndim - 2):
                mask = _c.unsqueeze(mask, [-1])
            outs.append(_c.elementwise_mul(ym, mask))
        return outs[0] if len(outs) == 1 else outs


def cond(pred, true_fn=None, false_fn=None, name=None):
    """paddle.static.nn.cond / fluid cond: one conditional_block with
    both branches; they must return the same structure of same-shaped
    vars."""
    program = default_main_program()
    parent = program.current_block()

    def trace(fn):
        blk = program._create_block()
        rets = fn() if fn is not None else None
        if rets is None:
            rets = ()
        if not isinstance(rets, (tuple, list)):
            rets = (rets,)
        program._rollback()
        return blk, tuple(rets)

    t_blk, t_rets = trace(true_fn)
    f_blk, f_rets = trace(false_fn)
    enforce(len(t_rets) == len(f_rets),
            "cond branches return different arity (%d vs %d)",
            len(t_rets), len(f_rets))
    outs = [parent.create_var(name=unique_name("cond_out"),
                              shape=r.shape, dtype=r.dtype,
                              stop_gradient=False)
            for r in t_rets]
    for blk, rets in ((t_blk, t_rets), (f_blk, f_rets)):
        for r, o in zip(rets, outs):
            blk.append_op("assign", {"X": [r.name]}, {"Out": [o.name]})
    out_names = [o.name for o in outs]
    parent.append_op(
        "conditional_block",
        {"Cond": [pred.name], "Input": []},
        {"Out": out_names},
        {"sub_block": t_blk.idx, "else_block": f_blk.idx,
         "input_vars": [], "output_vars": out_names})
    result = tuple(Variable(parent, parent.vars[n]) for n in out_names)
    return result[0] if len(result) == 1 else result


def case(pred_fn_pairs, default=None, name=None):
    """paddle.static.nn.case: first true predicate wins."""
    enforce(pred_fn_pairs, "case needs at least one (pred, fn) pair")
    pred, fn = pred_fn_pairs[0]
    rest = pred_fn_pairs[1:]
    if not rest:
        enforce(default is not None, "case needs a default fn")
        return cond(pred, fn, default)
    return cond(pred, fn, lambda: case(rest, default))


switch_case = case  # modern alias (semantics: index/case chains)


class Switch:
    """fluid.layers.Switch (control_flow.py:1678): sequential cases,
    first match wins; each case body assigns to outer variables (the LR-
    schedule idiom). Lowered to a chain of conditional_block ops whose
    pass-through inputs ARE the written vars (no-op when not taken)."""

    def __init__(self, name=None):
        self.program = default_main_program()
        self._cases = []          # (cond var name or None, block)
        self._entered = False

    def __enter__(self):
        self._entered = True
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is not None:
            return False
        parent = self.program.current_block()
        matched = None  # var name of "some earlier case matched"
        for cond_var, blk in self._cases:
            writes = _external_writes(blk)
            if cond_var is None:      # default case
                enforce(matched is not None,
                        "Switch.default before any case")
                eff = _c.logical_not(matched)
            elif matched is None:
                eff = cond_var
                matched = cond_var
            else:
                eff = _c.logical_and(cond_var, _c.logical_not(matched))
                matched = _c.logical_or(matched, cond_var)
            parent.append_op(
                "conditional_block",
                {"Cond": [eff.name], "Input": list(writes)},
                {"Out": list(writes)},
                {"sub_block": blk.idx, "else_block": -1,
                 "input_vars": list(writes), "output_vars": list(writes)})
        return False

    class _CaseGuard:
        def __init__(self, outer, cond_var):
            self.outer = outer
            self.cond_var = cond_var

        def __enter__(self):
            self.blk = self.outer.program._create_block()
            return self.blk

        def __exit__(self, exc_type, *a):
            self.outer.program._rollback()
            if exc_type is None:
                self.outer._cases.append((self.cond_var, self.blk))
            return False

    def case(self, condition):
        enforce(self._entered, "use `with Switch() as sw:`")
        return Switch._CaseGuard(self, condition)

    def default(self):
        enforce(self._entered, "use `with Switch() as sw:`")
        return Switch._CaseGuard(self, None)
