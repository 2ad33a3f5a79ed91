"""The loss-scaling core shared by the eager GradScaler.

Counterpart of paddle_tpu/amp/schedule.py on torch tensors: unscale and
check for overflow, and the dynamic loss-scale schedule (the reference's
fp16_utils.py:279 update_loss_scaling). Both are selects on device
tensors, with no read on the host.
"""
import torch


def unscale_and_check(leaves, scale):
    """-> (new_leaves, found_inf). Multiplies every leaf by 1 / `scale`
    in f32 (cast back to its dtype); if any leaf holds a nan or inf,
    every leaf comes back zeroed (the reference skips the update,
    decorator.py:160-167)."""
    scale = torch.as_tensor(scale).reshape(())
    finite = torch.ones((), dtype=torch.bool, device=scale.device)
    for g in leaves:
        finite = finite & torch.isfinite(g).all()
    inv = (1.0 / scale).to(torch.float32)
    outs = [torch.where(finite, g.float() * inv,
                        torch.zeros((), device=g.device)).to(g.dtype)
            for g in leaves]
    return outs, ~finite


def update_scale(scale, good, bad, found_inf, incr_every_n_steps,
                 decr_every_n_nan_or_inf, incr_ratio, decr_ratio):
    """After `incr_every_n_steps` finite steps in a row scale *=
    incr_ratio; after `decr_every_n_nan_or_inf` overflowed steps scale *=
    decr_ratio, floored at 1.0. -> (scale, good, bad)."""
    inf = torch.as_tensor(found_inf).reshape(())
    good = torch.where(inf, torch.zeros_like(good), good + 1)
    bad = torch.where(inf, bad + 1, torch.zeros_like(bad))
    should_incr = good >= incr_every_n_steps
    should_decr = bad >= decr_every_n_nan_or_inf
    s = scale.reshape(())
    s = torch.where(should_decr, torch.clamp(s * decr_ratio, min=1.0),
                    torch.where(should_incr, s * incr_ratio, s))
    good = torch.where(should_incr, torch.zeros_like(good), good)
    bad = torch.where(should_decr, torch.zeros_like(bad), bad)
    return s, good, bad
