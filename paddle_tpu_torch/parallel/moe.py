"""Mixture-of-Experts with expert parallelism (the `ep` mesh axis).

Counterpart of paddle_tpu/parallel/moe.py. The routing is the same
static-shape Switch formulation: softmax in f32 (f64 for f64 tokens), argmax, cumsum queue
positions, the capacity drop and the Switch aux loss. The JAX package
constrains the expert tensors to shard over `ep` and GSPMD inserts the
all-to-alls; here, with the bound mesh's `ep` axis of size P, each rank
holds E/P experts (`w_in` / `w_out` are its slices [E/P, ...]), computes
its experts' slice of the dispatched tokens `xe`, and an all_gather over
`ep` assembles `ye`. The tokens `x` are the same on every rank of the
group. Without an `ep` axis the same math runs unsharded with all E
experts: the parity reference, as in the JAX function.

Gradients follow ops/collective.py's convention: each rank's graph
holds its share, so a rank that seeds its loss with 1/P and sums the
replicated gradients (x, gate_w) over the group gets the unsharded
gradients, and its expert slices' gradients are exact already.

Shapes:
  x      [N, D]   tokens (flatten [B, T, D] first)
  gate_w [D, E]
  w_in   [E, D, H] (or [E/P, D, H]), w_out [E, H, D] (or [E/P, H, D])

Returns (y [N, D], aux_loss).
"""
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.dtypes import at_least_f32
from paddle_tpu_torch.core.registry import register_op

__all__ = ["switch_moe", "moe_op_attrs"]


def switch_moe(x, gate_w, w_in, w_out, capacity_factor=1.25, mesh=None,
               ep_axis="ep"):
    """Top-1 (Switch) MoE layer. With the `ep` axis bound (by `mesh`, a
    parallel.env.Mesh, or the bound mesh), w_in / w_out are this rank's
    E/P experts; without it, all E."""
    from paddle_tpu_torch.ops.collective import all_gather
    from paddle_tpu_torch.parallel.env import axis_info, bind_mesh
    if mesh is not None:
        with bind_mesh(mesh):
            return switch_moe(x, gate_w, w_in, w_out, capacity_factor,
                              None, ep_axis)
    n, d = x.shape
    e = gate_w.shape[1]
    cap = int(max(1, (n * capacity_factor) // e))
    ax = axis_info(ep_axis)
    if ax is not None and w_in.shape[0] == e:
        ax = None        # all E experts on this rank (a gathered parameter)
    p = 1 if ax is None else ax.size
    assert e % p == 0 and w_in.shape[0] == e // p, (
        f"switch_moe: {e} experts over ep={p} needs w_in with {e // p} "
        f"or {e} experts, got {w_in.shape[0]}")

    logits = x @ gate_w                                   # [N, E]
    # float32 as in the JAX package (float64 stays float64)
    probs = torch.softmax(at_least_f32(logits), dim=-1)
    expert = torch.argmax(probs, dim=-1)                  # [N]
    gate = torch.amax(probs, dim=-1)                      # [N]

    onehot = F.one_hot(expert, e).float()                 # [N, E]
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0      # [N, E]
    keep = (pos < cap) & (onehot > 0)
    # jax.nn.one_hot of an index outside [0, cap) is all zeros: clamp it
    # into range, the keep mask zeroes those rows
    pos_c = F.one_hot(pos.long().clamp(0, cap - 1), cap).float() \
        * keep.unsqueeze(-1)
    dispatch = pos_c                                      # [N, E, C]
    combine = dispatch * gate[:, None, None]              # [N, E, C]

    if ax is not None:
        lo = ax.rank * (e // p)
        disp_local = dispatch[:, lo:lo + e // p]
    else:
        disp_local = dispatch
    xe = torch.einsum("nec,nd->ecd", disp_local.to(x.dtype), x)
    # jax.nn.gelu defaults to the tanh approximation
    hidden = F.gelu(torch.einsum("ecd,edh->ech", xe, w_in),
                    approximate="tanh")
    ye = torch.einsum("ech,ehd->ecd", hidden, w_out)       # [E/P, C, D]
    if ax is not None:
        ye = all_gather(ye, ax, 0)                        # [E, C, D]
    y = torch.einsum("nec,ecd->nd", combine.to(ye.dtype), ye).to(x.dtype)

    frac = torch.mean(onehot, dim=0)
    mean_prob = torch.mean(probs, dim=0)
    aux = torch.sum(frac * mean_prob) * e
    return y, aux


def moe_op_attrs(capacity_factor=1.25, expert_axis="ep", capacity=None):
    """The attrs contract for a `moe_switch` OpDesc, what the static
    planner (analysis/planner.py `_moe_rule`) reads to price the layer's
    pair of all-to-alls: ``expert_axis``, ``capacity_factor`` and an
    optional explicit ``capacity`` (C = max(1, (N·factor)//E) without
    it, the formula `switch_moe` uses)."""
    attrs = {"capacity_factor": float(capacity_factor),
             "expert_axis": str(expert_axis)}
    if capacity is not None:
        attrs["capacity"] = int(capacity)
    return attrs


@register_op("moe_switch",
             inputs=["X", "GateW", "WIn", "WOut"], outputs=["Out", "AuxLoss"])
def _moe_switch_op(ctx, x, gate_w, w_in, w_out):
    return switch_moe(x, gate_w, w_in, w_out,
                      capacity_factor=ctx.attr("capacity_factor", 1.25),
                      ep_axis=ctx.attr("expert_axis", "ep"))
