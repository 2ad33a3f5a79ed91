"""Text and structured-input ops.

Counterpart of paddle_tpu/ops/text.py, so far its `tree_conv` (the
reference's operators/tree_conv_op.h + math/tree2col.cc, TBCNN, arXiv
1409.5718), which the eager `TreeConv` layer runs: per-root patches of
the nodes within max_depth, continuous-binary-tree weights eta_l / eta_r
/ eta_t combined with the [F, 3, out, filters] filter. Patch membership
is reachability by repeated boolean matmuls over the child adjacency,
as in the JAX package (a batch dimension here where it vmaps). The rest
of that module waits for a later slice (ROADMAP Queue 1 item 6).
"""
import torch

from paddle_tpu_torch.core.dtypes import at_least_f32_dtype
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.registry import register_op


@register_op("tree_conv", inputs=["NodesVector", "EdgeSet", "Filter"],
             outputs=["Out"])
def _tree_conv(ctx, nodes, edges, filt):
    """nodes: [B, N, F]; edges: [B, E, 2] (1-indexed (parent, child),
    all-zero rows pad); filt: [F, 3, out_size, num_filters]; node slot 0
    of `nodes` is node id 1. Out: [B, N, out_size, num_filters]."""
    k = float(ctx.attr("max_depth", 2))
    b, n, f = nodes.shape
    fdim, three, _, _ = filt.shape
    enforce(three == 3 and fdim == f, "tree_conv Filter must be [F,3,o,m]")
    dt = at_least_f32_dtype(nodes, filt)
    dev = nodes.device
    nodes_f = nodes.to(dt)
    par = edges[..., 0].long()
    chd = edges[..., 1].long()
    valid = (par > 0) & (chd > 0)                               # [B, E]
    e = par.shape[1]
    # child adjacency over node ids 1..N -> 0-based
    flat = torch.where(valid, (par - 1) * n + (chd - 1),
                       torch.zeros_like(par))
    adj = torch.zeros((b, n * n), dtype=dt, device=dev).scatter_add_(
        1, flat, valid.to(dt)).reshape(b, n, n)
    # sibling index (1-based, edge order) and parent fanout per child
    same_p = ((par[:, :, None] == par[:, None, :]) & valid[:, :, None]
              & valid[:, None, :])                              # [B, E, E]
    earlier = torch.tril(torch.ones((e, e), dtype=torch.bool, device=dev),
                         diagonal=-1)
    sib_index = (same_p & earlier).sum(dim=2) + 1
    fanout = same_p.sum(dim=2)
    child = torch.where(valid, chd - 1, torch.zeros_like(chd))

    def scatter_max(vals):
        return torch.zeros((b, n), dtype=dt, device=dev).scatter_reduce(
            1, child, torch.where(valid, vals.to(dt), torch.zeros((), dtype=dt,
                                                                  device=dev)),
            reduce="amax", include_self=True)

    idx_v, pcl_v = scatter_max(sib_index), scatter_max(fanout)
    # depth(u, v): reach at power d (a tree: unique); depth 0 = self
    out = 0
    reach = torch.eye(n, dtype=dt, device=dev).expand(b, n, n)
    wl, wr, wt = filt[:, 0].to(dt), filt[:, 1].to(dt), filt[:, 2].to(dt)
    for d in range(int(k)):
        if d > 0:
            reach = (reach @ adj > 0).to(dt)
        eta_t = (k - d) / k
        if d == 0:
            temp = torch.full((b, n), 0.5, dtype=dt, device=dev)
        else:
            temp = torch.where(pcl_v == 1.0, torch.full_like(pcl_v, 0.5),
                               (idx_v - 1.0) / torch.clamp(pcl_v - 1.0,
                                                           min=1.0))
        eta_l = (1.0 - eta_t) * temp                             # [B, n]
        eta_r = (1.0 - eta_t) * (1.0 - eta_l)
        mix = (torch.einsum("bvf,fom->bvom", nodes_f * eta_l[..., None], wl)
               + torch.einsum("bvf,fom->bvom", nodes_f * eta_r[..., None], wr)
               + torch.einsum("bvf,fom->bvom", nodes_f * eta_t, wt))
        out = out + torch.einsum("buv,bvom->buom", reach, mix)
    return out.to(nodes.dtype)
