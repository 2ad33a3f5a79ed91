"""Optimizers of the static graph.

Counterpart of paddle_tpu/optimizer/__init__.py (the reference's
optimizer.py: minimize() :641 = append_backward + apply_gradients): SGD,
Momentum, LarsMomentum, Adam, Adamax, Adagrad, DecayedAdagrad, Adadelta,
RMSProp, Ftrl, Lamb and Dpsgd, with their `*Optimizer` aliases; the
meta-optimizers of `meta.py`; the LR schedulers of `lr.py`, whose
Variable any of them takes as `learning_rate`. `minimize` appends the `autodiff` op, then per
parameter its regularizer's ops (ParamAttr's, else the optimizer's), the
gradient clip's ops (the optimizer's, else `set_gradient_clip`'s), and
the update op (ops/optimizer_ops.py), with the learning rate scaled by
`ParamAttr.learning_rate`. Accumulators are persistable vars named
`{param}_{suffix}_{optimizer name}`, as in the JAX package, so a scope
moves between the packages by name.

The eager trainer of the port is nn/train.py; the JAX package's eager
`init_state` / `apply` halves have no counterpart here.
"""
from paddle_tpu_torch.core import dtypes as _dt
from paddle_tpu_torch.core.ir import (OpRole, Variable, default_main_program,
                                      default_startup_program)
from paddle_tpu_torch.static.backward import append_backward
from paddle_tpu_torch.static.helper import param_attr_of
from paddle_tpu_torch.utils import clip as clip_mod

__all__ = [
    "Optimizer", "SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer",
    "LarsMomentum", "LarsMomentumOptimizer", "Adam", "AdamOptimizer",
    "Adamax", "AdamaxOptimizer", "Adagrad", "AdagradOptimizer",
    "DecayedAdagrad", "DecayedAdagradOptimizer", "Adadelta",
    "AdadeltaOptimizer", "RMSProp", "RMSPropOptimizer", "Ftrl",
    "FtrlOptimizer", "Lamb", "LambOptimizer", "Dpsgd", "DpsgdOptimizer",
    "ExponentialMovingAverage", "ModelAverage", "LookaheadOptimizer",
    "RecomputeOptimizer",
]


def _persistable_var(program, startup, name, shape, dtype, init_value=0.0):
    """A persistable state var in both programs, with its startup init."""
    gb = program.global_block()
    if not gb.has_var(name):
        gb.create_var(name=name, shape=shape, dtype=dtype, persistable=True,
                      stop_gradient=True)
    sb = startup.global_block()
    if not sb.has_var(name):
        sb.create_var(name=name, shape=shape, dtype=dtype, persistable=True,
                      stop_gradient=True)
        sb.append_op("fill_constant", {}, {"Out": [name]},
                     {"shape": list(shape), "value": init_value,
                      "dtype": _dt.dtype_name(_dt.normalize_dtype(dtype))})
    return gb.var(name)


class Optimizer:
    def __init__(self, learning_rate=0.001, regularization=None, name=None,
                 grad_clip=None):
        self._lr = learning_rate
        self.regularization = regularization
        self.grad_clip = grad_clip
        self._name = name or type(self).__name__
        self._accumulators = {}

    def _lr_var(self, program, startup):
        """The global learning rate: a float becomes a persistable [1]
        var (a scope write changes it between steps); a Variable is used
        as it is."""
        if isinstance(self._lr, Variable):
            return self._lr
        return _persistable_var(program, startup,
                                f"learning_rate_{self._name}", [1],
                                "float32", float(self._lr))

    def _add_accumulator(self, program, startup, param_name, suffix, shape,
                         init_value=0.0, dtype="float32"):
        name = f"{param_name}_{suffix}_{self._name}"
        v = _persistable_var(program, startup, name, shape, dtype, init_value)
        self._accumulators.setdefault(suffix, {})[param_name] = name
        return v

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """backward + apply_gradients. The ops go into the loss's program
        and the accumulators' init ops into `startup_program` (default:
        the default startup program). Returns (update ops,
        params_grads)."""
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        program = loss.block.program if isinstance(loss, Variable) \
            else default_main_program()
        opt_ops = self.apply_gradients(params_grads, program=program,
                                       startup_program=startup_program)
        program.meta["optimizer"] = self._name
        return opt_ops, params_grads

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, checkpoints=None):
        program = loss.block.program if isinstance(loss, Variable) else None
        return append_backward(loss, parameter_list, no_grad_set,
                               program=program, checkpoints=checkpoints)

    def apply_gradients(self, params_grads, program=None,
                        startup_program=None):
        program = program or default_main_program()
        startup = startup_program or default_startup_program()
        block = program.global_block()

        pg_names = [(p.name, g.name) for p, g in params_grads]
        with program.op_role_guard(OpRole.BACKWARD):
            for pname, gname in pg_names:
                attr = param_attr_of(pname)
                reg = (attr.regularizer if attr is not None
                       and attr.regularizer is not None
                       else self.regularization)
                if reg is not None:
                    reg.append_ops(block, pname, gname)
            gclip = self.grad_clip or clip_mod.get_gradient_clip()
            if gclip is not None:
                gclip.append_clip_ops(block, pg_names)

        lr = self._lr_var(program, startup)
        ops = []
        with program.op_role_guard(OpRole.OPTIMIZE):
            for pname, gname in pg_names:
                lr_name = lr.name
                attr = param_attr_of(pname)
                if attr is not None and attr.learning_rate != 1.0:
                    scaled = block.create_var(dtype="float32").name
                    block.append_op("scale", {"X": [lr_name]},
                                    {"Out": [scaled]},
                                    {"scale": attr.learning_rate})
                    lr_name = scaled
                ops.append(self._append_update_op(
                    program, startup, block, pname, gname, lr_name))
        return ops

    def _append_update_op(self, program, startup, block, pname, gname, lr):
        raise NotImplementedError


class SGD(Optimizer):
    def _append_update_op(self, program, startup, block, p, g, lr):
        return block.append_op(
            "sgd", {"Param": [p], "Grad": [g], "LearningRate": [lr]},
            {"ParamOut": [p]})


class Momentum(Optimizer):
    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False,
                 **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _append_update_op(self, program, startup, block, p, g, lr):
        v = self._add_accumulator(program, startup, p, "velocity",
                                  block.var(p).shape)
        return block.append_op(
            "momentum",
            {"Param": [p], "Grad": [g], "Velocity": [v.name],
             "LearningRate": [lr]},
            {"ParamOut": [p], "VelocityOut": [v.name]},
            {"mu": self.momentum, "use_nesterov": self.use_nesterov})


class LarsMomentum(Optimizer):
    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.lars_coeff = lars_coeff
        self.lars_weight_decay = lars_weight_decay

    def _append_update_op(self, program, startup, block, p, g, lr):
        v = self._add_accumulator(program, startup, p, "velocity",
                                  block.var(p).shape)
        return block.append_op(
            "lars_momentum",
            {"Param": [p], "Grad": [g], "Velocity": [v.name],
             "LearningRate": [lr]},
            {"ParamOut": [p], "VelocityOut": [v.name]},
            {"mu": self.momentum, "lars_coeff": self.lars_coeff,
             "lars_weight_decay": self.lars_weight_decay})


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _append_update_op(self, program, startup, block, p, g, lr):
        shape = block.var(p).shape
        m1 = self._add_accumulator(program, startup, p, "moment1", shape)
        m2 = self._add_accumulator(program, startup, p, "moment2", shape)
        b1p = self._add_accumulator(program, startup, p, "beta1pow", [1],
                                    self.beta1)
        b2p = self._add_accumulator(program, startup, p, "beta2pow", [1],
                                    self.beta2)
        return block.append_op(
            "adam",
            {"Param": [p], "Grad": [g], "Moment1": [m1.name],
             "Moment2": [m2.name], "Beta1Pow": [b1p.name],
             "Beta2Pow": [b2p.name], "LearningRate": [lr]},
            {"ParamOut": [p], "Moment1Out": [m1.name],
             "Moment2Out": [m2.name], "Beta1PowOut": [b1p.name],
             "Beta2PowOut": [b2p.name]},
            {"beta1": self.beta1, "beta2": self.beta2,
             "epsilon": self.epsilon})


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _append_update_op(self, program, startup, block, p, g, lr):
        shape = block.var(p).shape
        m = self._add_accumulator(program, startup, p, "moment", shape)
        u = self._add_accumulator(program, startup, p, "inf_norm", shape)
        b1p = self._add_accumulator(program, startup, p, "beta1pow", [1],
                                    self.beta1)
        return block.append_op(
            "adamax",
            {"Param": [p], "Grad": [g], "Moment": [m.name],
             "InfNorm": [u.name], "Beta1Pow": [b1p.name],
             "LearningRate": [lr]},
            {"ParamOut": [p], "MomentOut": [m.name], "InfNormOut": [u.name],
             "Beta1PowOut": [b1p.name]},
            {"beta1": self.beta1, "beta2": self.beta2,
             "epsilon": self.epsilon})


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self.epsilon = epsilon
        self.init_acc = initial_accumulator_value

    def _append_update_op(self, program, startup, block, p, g, lr):
        m = self._add_accumulator(program, startup, p, "moment",
                                  block.var(p).shape, self.init_acc)
        return block.append_op(
            "adagrad",
            {"Param": [p], "Grad": [g], "Moment": [m.name],
             "LearningRate": [lr]},
            {"ParamOut": [p], "MomentOut": [m.name]},
            {"epsilon": self.epsilon})


class DecayedAdagrad(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.decay, self.epsilon = decay, epsilon

    def _append_update_op(self, program, startup, block, p, g, lr):
        m = self._add_accumulator(program, startup, p, "moment",
                                  block.var(p).shape)
        return block.append_op(
            "decayed_adagrad",
            {"Param": [p], "Grad": [g], "Moment": [m.name],
             "LearningRate": [lr]},
            {"ParamOut": [p], "MomentOut": [m.name]},
            {"decay": self.decay, "epsilon": self.epsilon})


class Adadelta(Optimizer):
    """The update has no learning rate (adadelta_op.cc); the rate var is
    made all the same, as in the JAX package."""

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self.epsilon, self.rho = epsilon, rho

    def _append_update_op(self, program, startup, block, p, g, lr):
        shape = block.var(p).shape
        ag = self._add_accumulator(program, startup, p, "avg_squared_grad",
                                   shape)
        au = self._add_accumulator(program, startup, p, "avg_squared_update",
                                   shape)
        return block.append_op(
            "adadelta",
            {"Param": [p], "Grad": [g], "AvgSquaredGrad": [ag.name],
             "AvgSquaredUpdate": [au.name]},
            {"ParamOut": [p], "AvgSquaredGradOut": [ag.name],
             "AvgSquaredUpdateOut": [au.name]},
            {"rho": self.rho, "epsilon": self.epsilon})


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self.rho, self.epsilon, self.momentum, self.centered = (
            rho, epsilon, momentum, centered)

    def _append_update_op(self, program, startup, block, p, g, lr):
        shape = block.var(p).shape
        ms = self._add_accumulator(program, startup, p, "mean_square", shape)
        mg = self._add_accumulator(program, startup, p, "mean_grad", shape)
        mom = self._add_accumulator(program, startup, p, "momentum_acc",
                                    shape)
        return block.append_op(
            "rmsprop",
            {"Param": [p], "Grad": [g], "MeanSquare": [ms.name],
             "MeanGrad": [mg.name], "Moment": [mom.name],
             "LearningRate": [lr]},
            {"ParamOut": [p], "MeanSquareOut": [ms.name],
             "MeanGradOut": [mg.name], "MomentOut": [mom.name]},
            {"decay": self.rho, "epsilon": self.epsilon,
             "momentum": self.momentum, "centered": self.centered})


class Ftrl(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self.l1, self.l2, self.lr_power = l1, l2, lr_power

    def _append_update_op(self, program, startup, block, p, g, lr):
        shape = block.var(p).shape
        sq = self._add_accumulator(program, startup, p, "squared", shape)
        lin = self._add_accumulator(program, startup, p, "linear", shape)
        return block.append_op(
            "ftrl",
            {"Param": [p], "Grad": [g], "SquaredAccumulator": [sq.name],
             "LinearAccumulator": [lin.name], "LearningRate": [lr]},
            {"ParamOut": [p], "SquaredAccumOut": [sq.name],
             "LinearAccumOut": [lin.name]},
            {"l1": self.l1, "l2": self.l2, "lr_power": self.lr_power})


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.wd, self.beta1, self.beta2, self.epsilon = (
            lamb_weight_decay, beta1, beta2, epsilon)

    def _append_update_op(self, program, startup, block, p, g, lr):
        shape = block.var(p).shape
        m1 = self._add_accumulator(program, startup, p, "moment1", shape)
        m2 = self._add_accumulator(program, startup, p, "moment2", shape)
        b1p = self._add_accumulator(program, startup, p, "beta1pow", [1],
                                    self.beta1)
        b2p = self._add_accumulator(program, startup, p, "beta2pow", [1],
                                    self.beta2)
        return block.append_op(
            "lamb",
            {"Param": [p], "Grad": [g], "Moment1": [m1.name],
             "Moment2": [m2.name], "Beta1Pow": [b1p.name],
             "Beta2Pow": [b2p.name], "LearningRate": [lr]},
            {"ParamOut": [p], "Moment1Out": [m1.name],
             "Moment2Out": [m2.name], "Beta1PowOut": [b1p.name],
             "Beta2PowOut": [b2p.name]},
            {"beta1": self.beta1, "beta2": self.beta2,
             "epsilon": self.epsilon, "weight_decay": self.wd})


class Dpsgd(Optimizer):
    """Clipped, noised SGD; the noise comes from each op's generator, so
    it differs from the JAX package's draws."""

    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16.0,
                 sigma=1.0, **kw):
        super().__init__(learning_rate, **kw)
        self.clip, self.batch_size, self.sigma = clip, batch_size, sigma

    def _append_update_op(self, program, startup, block, p, g, lr):
        return block.append_op(
            "dpsgd", {"Param": [p], "Grad": [g], "LearningRate": [lr]},
            {"ParamOut": [p]},
            {"clip": self.clip, "batch_size": self.batch_size,
             "sigma": self.sigma})


SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdamOptimizer = Adam
LarsMomentumOptimizer = LarsMomentum
AdamaxOptimizer = Adamax
AdagradOptimizer = Adagrad
DecayedAdagradOptimizer = DecayedAdagrad
AdadeltaOptimizer = Adadelta
RMSPropOptimizer = RMSProp
FtrlOptimizer = Ftrl
LambOptimizer = Lamb
DpsgdOptimizer = Dpsgd

from paddle_tpu_torch.optimizer.meta import (  # noqa: E402,F401
    ExponentialMovingAverage, LookaheadOptimizer, ModelAverage,
    RecomputeOptimizer)
from paddle_tpu_torch.optimizer import lr  # noqa: E402,F401
