"""Gradient-transform hooks: DGC and LocalSGD.

Counterpart of paddle_tpu/parallel/grad_hooks.py (the reference's
DGCMomentumOptimizer, optimizer.py:870, dgc_op.h:25-35, and LocalSGD,
transpiler/collective.py:269). Both are functional transforms over
gradient / parameter trees (a tensor, or dicts, lists and tuples of
them), applied by the caller inside its training step; the collective
runs over the process group of the bound mesh's axis (parallel/env.py):

* **DGC**: momentum correction, error feedback and top-k masking before
  the cross-rank sum, so each rank contributes a sparse tensor and the
  masked-out mass stays in its local accumulators.
* **LocalSGD**: no per-step gradient collective; the parameters are
  averaged across ranks every k steps.

The top-k threshold is the linear-interpolation quantile of |v|, the
JAX package's `jnp.quantile`, computed from a sort: `torch.quantile`
refuses inputs over 2**24 elements (a BERT-base word embedding has
23.4 M). The index arithmetic is float32 as in `jnp.quantile`, so the
threshold is the JAX package's bit for bit on the same values.
"""
import torch

from paddle_tpu_torch.ops.collective import all_reduce
from paddle_tpu_torch.parallel.env import axis_info

__all__ = ["dgc_init_state", "dgc_sparsity", "dgc_transform",
           "dgc_allreduce", "local_sgd_average", "quantile_linear"]


def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


# ---- DGC ----------------------------------------------------------------

def dgc_init_state(params):
    """Error-feedback state: u (momentum-corrected velocity) and v
    (residual accumulator), float32 zeros shaped like params."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"u": _tree_map(zeros, params), "v": _tree_map(zeros, params)}


def dgc_sparsity(step, rampup_begin_step=0, rampup_step=1,
                 sparsity=(0.999,)):
    """Ramp-up schedule (dgc_op.h:25-35): dense (0) before
    rampup_begin_step, then rampup_step steps split evenly across the
    schedule entries, holding the last one. A float32 scalar tensor (on
    step's device when step is a tensor)."""
    dev = step.device if isinstance(step, torch.Tensor) else "cpu"
    step = torch.as_tensor(step, dtype=torch.float32, device=dev)
    sched = torch.tensor(sparsity, dtype=torch.float32, device=dev)
    per_entry = float(max(rampup_step, 1)) / len(sparsity)
    idx = torch.clamp((step - float(rampup_begin_step)) / per_entry, 0,
                      len(sparsity) - 1).to(torch.int64)
    return torch.where(step < float(rampup_begin_step),
                       torch.zeros((), dtype=torch.float32, device=dev),
                       sched[idx])


def quantile_linear(x, q):
    """jnp.quantile(x.ravel(), q) (method "linear") for any size: the
    sorted values at floor and ceil of q·(n-1), interpolated, with the
    position computed in float32 as jnp does (n rounded to float32
    first)."""
    flat = torch.sort(x.reshape(-1).float()).values
    n = flat.numel()
    q = torch.as_tensor(q, dtype=torch.float32, device=flat.device)
    # jnp: n in float32 first (rounded above 2**24), then n - 1
    nf = torch.tensor(float(n), dtype=torch.float32, device=flat.device)
    pos = q * (nf - 1.0)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    lv = flat[low.to(torch.int64).clamp(0, n - 1)]
    hv = flat[high.to(torch.int64).clamp(0, n - 1)]
    return lv * lw + hv * hw


def _topk_threshold(x, sparsity):
    """|value| threshold keeping the top (1-sparsity) fraction."""
    return quantile_linear(torch.abs(x), torch.clamp(sparsity, 0.0, 0.9999))


def dgc_transform(state, grads, step, momentum=0.9, rampup_begin_step=0,
                  rampup_step=1, sparsity=(0.999,)):
    """One DGC step over a grads tree: u = m·u + g, v = v + u,
    send = v·mask, u, v ← u, v·(1 - mask). Returns (send, new_state)."""
    s = dgc_sparsity(step, rampup_begin_step, rampup_step, sparsity)

    def one(u, v, g):
        g = g.float()
        u_n = momentum * u + g
        v_n = v + u_n
        thr = _topk_threshold(v_n, s.to(v_n.device))
        mask = torch.abs(v_n) >= thr
        send = torch.where(mask, v_n, torch.zeros_like(v_n))
        keep = (~mask).to(v_n.dtype)
        return send, u_n * keep, v_n * keep

    flat = _tree_map(one, state["u"], state["v"], grads)
    return _unzip(flat, 0), {"u": _unzip(flat, 1), "v": _unzip(flat, 2)}


def _is_leaf_triple(t):
    return (isinstance(t, tuple) and len(t) == 3
            and all(isinstance(x, torch.Tensor) for x in t))


def _unzip(tree, i):
    if _is_leaf_triple(tree):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _unzip(v, i) for k, v in tree.items()}
    return type(tree)(_unzip(v, i) for v in tree)


def dgc_allreduce(state, grads, step, axis_name="dp", **kwargs):
    """DGC, then the mean across the ranks of `axis_name` of the sparse
    tensors. Apply the result with plain SGD: it carries momentum."""
    send, new_state = dgc_transform(state, grads, step, **kwargs)
    ax = axis_info(axis_name)
    n = 1 if ax is None else ax.size
    return _tree_map(lambda t: all_reduce(t, axis_name) / n, send), \
        new_state


# ---- LocalSGD -----------------------------------------------------------

def local_sgd_average(params, step, k_steps, axis_name="dp"):
    """Parameter mean across the ranks of `axis_name` every k steps;
    between them the ranks train alone and the tree comes back as it
    is. `step` is a Python int (a tensor is read on the host)."""
    if int(step) % int(k_steps):
        return params
    ax = axis_info(axis_name)
    n = 1 if ax is None else ax.size
    return _tree_map(
        lambda x: (all_reduce(x, axis_name) / n).to(x.dtype), params)
