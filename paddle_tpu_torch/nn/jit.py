"""Eager checkpoints and traced layers.

Counterpart of paddle_tpu/nn/jit.py:

* `save_dygraph` / `load_dygraph` (the reference's dygraph/checkpoint.py)
  write and read the same files as the JAX package: one `.npz` of
  {flat name: array} per state dict, and the optimizer's state beside it
  as `<path>.opt.npz`. So a checkpoint written by either package loads in
  the other (tensors leave as numpy arrays, on the host).
* `TracedLayer` traces an eager layer in eval mode with `torch.export`
  into a program with its parameters inside, saved as `model.pt2` (and
  `traced_meta.json`, the input shapes and dtypes it was traced at). The
  JAX package's artifact is a `jax.export` StableHLO module
  (`model.jaxexport`); the two cannot be interchanged.
* `DataParallel` runs each rank's slice of the global batch over a
  parallel.env.Mesh and averages the gradients across the ranks.
"""
import json
import os

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import enforce

__all__ = ["TracedLayer", "save_dygraph", "load_dygraph", "DataParallel"]

_TRACED_FILE = "model.pt2"
_TRACED_META = "traced_meta.json"


class TracedLayer:
    """Trace an eager Layer into a deployable program.

        out, traced = TracedLayer.trace(model, inputs=[x])
        y = traced([x])
        traced.save_inference_model("dir")    # model.pt2 + traced_meta.json
        y2 = TracedLayer.load("dir")([x])
    """

    def __init__(self, exported):
        self._exported = exported
        self._module = exported.module()

    @staticmethod
    def trace(layer, inputs):
        """-> (the eager forward's output on `inputs`, TracedLayer). The
        layer is traced in eval mode (no dropout, batch norm on its
        running statistics) and put back in the mode it was in."""
        inputs = tuple(inputs)
        was_training = layer.training
        layer.eval()
        try:
            with torch.no_grad():
                exported = torch.export.export(layer, inputs)
                out = layer(*inputs)
        finally:
            layer.train(was_training)
        return out, TracedLayer(exported)

    def __call__(self, inputs):
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        with torch.no_grad():
            out = self._module(*inputs)
        if isinstance(out, (list, tuple)) and len(out) == 1:
            return out[0]
        return out

    def save_inference_model(self, dirname, feed=None, fetch=None):
        """Write the traced program to `dirname/model.pt2`; returns the
        path."""
        os.makedirs(dirname, exist_ok=True)
        path = os.path.join(dirname, _TRACED_FILE)
        torch.export.save(self._exported, path)
        specs = [{"shape": list(a.shape), "dtype": str(a.dtype)}
                 for a in self._exported.example_inputs[0]]
        with open(os.path.join(dirname, _TRACED_META), "w") as f:
            json.dump({"format": "torch.export", "inputs": specs}, f)
        return path

    @staticmethod
    def load(dirname):
        path = os.path.join(dirname, _TRACED_FILE)
        enforce(os.path.exists(path), "no traced model at %s", path)
        return TracedLayer(torch.export.load(path))


def _numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu").numpy()
    return np.asarray(v)


def save_dygraph(state_dict, model_path):
    """One `.npz` per state dict (a layer's `state_dict()` or an
    optimizer's): `model_path + ".npz"`; returns the path."""
    os.makedirs(os.path.dirname(model_path) or ".", exist_ok=True)
    np.savez(model_path + ".npz",
             **{k: _numpy(v) for k, v in state_dict.items()})
    return model_path + ".npz"


def load_dygraph(model_path):
    """-> (param dict, optimizer dict or None) of numpy arrays, as the
    reference returns them; load into a layer with `set_state_dict`."""
    path = (model_path if model_path.endswith(".npz")
            else model_path + ".npz")
    enforce(os.path.exists(path), "no dygraph checkpoint at %s", path)
    with np.load(path) as data:
        params = {k: data[k] for k in data.files}
    opt_path = model_path + ".opt.npz"
    opt = None
    if os.path.exists(opt_path):
        with np.load(opt_path) as data:
            opt = {k: data[k] for k in data.files}
    return params, opt


class DataParallel:
    """Eager data parallelism (dygraph/parallel.py:84 DataParallel),
    counterpart of the JAX package's, over the `axis` dim of a
    parallel.env.Mesh (default: the bound mesh):

        dp_model = DataParallel(model, mesh)
        loss, grads = dp_model.value_and_grad(loss_fn)(params, *batch)

    Every rank passes the global batch; each runs its slice (dim 0 of
    every tensor argument). `value_and_grad` returns the global loss and
    the replicated gradients, both the mean over the ranks of the
    per-slice ones: exact for a loss that is a mean over the batch, the
    reference's contract (`scale_loss`). `forward` returns the global
    output (the slices all-gathered; its gradient reaches each rank's
    slice). After a `backward` of a per-slice loss,
    `apply_collective_grads` averages each parameter's `.grad` over the
    ranks."""

    def __init__(self, layers, mesh=None, axis="dp"):
        from paddle_tpu_torch.parallel.env import get_mesh
        self._layer = layers
        self.mesh = mesh or get_mesh()
        self.axis = axis

    def _n(self):
        return self.mesh.axis_size(self.axis)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        from paddle_tpu_torch.ops.collective import all_reduce
        from paddle_tpu_torch.parallel.env import bind_mesh
        with bind_mesh(self.mesh), torch.no_grad():
            for p in self._layer.parameters():
                if p.grad is not None:
                    p.grad.copy_(all_reduce(p.grad, self.axis) / self._n())

    def _shard(self, args):
        n, c = self._n(), self.mesh.coord(self.axis)
        out = []
        for a in args:
            if isinstance(a, torch.Tensor) and a.dim() >= 1 and n > 1:
                enforce(a.shape[0] % n == 0, "DataParallel: batch %d does "
                        "not split over %s=%d", a.shape[0], self.axis, n)
                b = a.shape[0] // n
                a = a.narrow(0, c * b, b)
            out.append(a)
        return tuple(out)

    def forward(self, *args):
        from paddle_tpu_torch.ops.collective import all_gather
        from paddle_tpu_torch.parallel.env import bind_mesh
        y = self._layer(*self._shard(args))
        with bind_mesh(self.mesh):
            return all_gather(y, self.axis, 0)

    __call__ = forward

    def value_and_grad(self, loss_fn):
        """f(params, *batch) -> (global loss, {name: gradient}), params a
        {flat name: tensor} loaded into the layer first (None: the
        layer's own)."""
        from paddle_tpu_torch.ops.collective import all_reduce
        from paddle_tpu_torch.parallel.env import bind_mesh
        model = self._layer

        def wrapped(params, *args):
            if params is not None:
                model.set_state_dict(params)
            named = dict(model.named_parameters())
            with torch.enable_grad():
                loss = loss_fn(model, *self._shard(args))
                grads = torch.autograd.grad(loss, list(named.values()),
                                            allow_unused=True)
            n = self._n()
            with bind_mesh(self.mesh), torch.no_grad():
                loss = all_reduce(loss.detach(), self.axis) / n
                out = {k: all_reduce(torch.zeros_like(p) if g is None
                                     else g, self.axis) / n
                       for (k, p), g in zip(named.items(), grads)}
            return loss, out

        return wrapped

    def state_dict(self, *a, **k):
        return self._layer.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layer.set_state_dict(*a, **k)
