"""Vision ops beyond the detection family.

Counterpart of paddle_tpu/ops/vision.py, so far its `spectral_norm`
(the reference's operators/spectral_norm_op.h
CalcMatrixSigmaAndNormWeight), which the eager `SpectralNorm` layer
runs: power iteration on the [h, w] view of the `dim`-fronted Weight,
sigma = u^T W v, Out = W / sigma, with U and V constants for the
gradient. The rest of that module (affine_grid, the index and pyramid
pools, the ROI pools, the deformable convolutions) waits for the
detection slice (ROADMAP Queue 1 item 6).
"""
import torch

from paddle_tpu_torch.core.registry import register_op


@register_op("spectral_norm", inputs=["Weight", "U", "V"], outputs=["Out"])
def _spectral_norm(ctx, weight, u, v):
    dim = ctx.attr("dim", 0)
    power_iters = ctx.attr("power_iters", 1)
    eps = ctx.attr("eps", 1e-12)
    perm = [dim] + [i for i in range(weight.dim()) if i != dim]
    wmat = weight.permute(perm)
    shape = wmat.shape
    wmat = wmat.reshape(shape[0], -1)
    u = u.reshape(-1).to(wmat.dtype)
    v = v.reshape(-1).to(wmat.dtype)
    for _ in range(power_iters):
        v = wmat.t() @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = wmat @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    u, v = u.detach(), v.detach()
    sigma = u @ (wmat @ v)
    out = (wmat / sigma).reshape(shape)
    inv = [perm.index(i) for i in range(weight.dim())]
    return out.permute(inv)
