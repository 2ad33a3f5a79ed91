"""Eager training helpers.

Counterpart of paddle_tpu/nn/train.py. The JAX package differentiates a
loss function of the layer's parameter pytree and jit-compiles the step
with donated parameters (`profiled_jit`, component "train"); here
autograd is the tape, `TrainStep` updates the parameters and the
velocity in place where JAX donated them, and on the card each input
signature is one captured CUDA graph (`observability.profile.
profiled_graph`, key `train_step/<Model>`), recorded in the
CompileLedger. The parameters and the velocity are bound to the graphs:
a step after the model's parameters were replaced raises.
"""
import torch

from paddle_tpu_torch.observability import profile as obs_profile

__all__ = ["value_and_grad", "grad", "TrainStep"]


def value_and_grad(loss_fn, layer):
    """fn(*args) -> (loss, {flat name: grad}) over the layer's trainable
    parameters (a parameter the loss does not reach gets zeros, as
    jax.grad gives)."""

    def wrapped(*args, **kwargs):
        params = layer.trainable_dict()
        with torch.enable_grad():
            loss = loss_fn(*args, **kwargs)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
        return loss.detach(), {
            k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), grads)}

    return wrapped


def grad(loss_fn, layer):
    vag = value_and_grad(loss_fn, layer)

    def wrapped(*args, **kwargs):
        return vag(*args, **kwargs)[1]

    return wrapped


class TrainStep:
    """step = TrainStep(model, loss_fn, lr, momentum); loss = step(*args)
    with loss_fn(model, *args) and tensor args. Momentum SGD as the JAX
    package's: v = mu*v + g (f32), p = (p - lr*v) cast back to p's
    dtype. The velocity is built at the first step, before any capture;
    the returned loss is a tensor of its own."""

    def __init__(self, model, loss_fn, learning_rate=0.01, momentum=0.9):
        self.model = model
        self.loss_fn = loss_fn
        self.lr = learning_rate
        self.momentum = momentum
        self._velocity = None
        self._compiled = None

    def _bound(self):
        return {"params": self.model.trainable_dict(),
                "velocity": self._velocity}

    def _step(self, params, velocity, *args):
        loss, grads = value_and_grad(
            lambda: self.loss_fn(self.model, *args), self.model)()
        with torch.no_grad():
            for k, p in params.items():
                v = velocity[k]
                v.mul_(self.momentum).add_(grads[k].float())
                p.copy_((p.float() - self.lr * v).to(p.dtype))
        return loss

    def __call__(self, *args):
        params = self.model.trainable_dict()
        if self._compiled is None:
            self._velocity = {k: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device)
                              for k, p in params.items()}
            device = next(iter(params.values())).device
            self._compiled = obs_profile.profiled_graph(
                self._step, component="train",
                name=f"train_step/{type(self.model).__name__}",
                arg_names=("params", "velocity"), bound=self._bound,
                device=device)
        return self._compiled(params, self._velocity, *args).clone()
