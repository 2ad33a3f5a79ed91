"""Eager training helpers.

Counterpart of paddle_tpu/nn/train.py. The JAX package differentiates a
loss function of the layer's parameter pytree and jit-compiles the step
with donated parameters; here the step runs eagerly, autograd is the
tape, and `TrainStep` updates the parameters in place where JAX donated
them. `profiled_jit` and the CompileLedger have no counterpart.
"""
import torch

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
    with loss_fn(model, *args). Momentum SGD as the JAX package's:
    v = mu*v + g (f32), p = (p - lr*v) cast back to p's dtype."""

    def __init__(self, model, loss_fn, learning_rate=0.01, momentum=0.9):
        self.model = model
        self.loss_fn = loss_fn
        self.lr = learning_rate
        self.momentum = momentum
        self._velocity = None

    def __call__(self, *args):
        params = self.model.trainable_dict()
        if self._velocity is None:
            self._velocity = {k: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device)
                              for k, p in params.items()}
        loss, grads = value_and_grad(
            lambda: self.loss_fn(self.model, *args), self.model)()
        with torch.no_grad():
            for k, p in params.items():
                v = self._velocity[k]
                v.mul_(self.momentum).add_(grads[k].float())
                p.copy_((p.float() - self.lr * v).to(p.dtype))
        return loss
