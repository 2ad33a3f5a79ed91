"""Knowledge distillation.

Counterpart of paddle_tpu/slim/distill.py (the reference's
contrib/slim/dist/single_distiller.py): `merge(teacher, student)` copies
the teacher's ops and vars into the student program under a prefix, and
the distillation losses (soft label, L2, FSP) work on torch tensors. The
teacher is frozen: its vars are marked stop-gradient and not trainable,
so the backward reaches only the student's parameters.
"""
import copy

from paddle_tpu_torch.core.ir import OpDesc

__all__ = ["merge", "soft_label_loss", "l2_loss", "fsp_loss"]


def merge(teacher_program, student_program, data_name_map, scope=None,
          name_prefix="teacher_"):
    """Clone the teacher's ops and vars into the student program with
    `name_prefix`, wiring the teacher's feed vars onto student vars per
    `data_name_map` ({teacher feed name: student var name}). The
    teacher's persistables are copied in `scope` (the global scope by
    default) under the prefixed names. Returns the student program."""
    if scope is None:
        from paddle_tpu_torch.core.scope import global_scope
        scope = global_scope()
    t_block = teacher_program.global_block()
    s_block = student_program.global_block()

    def rename(n):
        return data_name_map.get(n, name_prefix + n)

    for name, var in t_block.vars.items():
        if name in data_name_map:
            continue
        new = rename(name)
        if not s_block.has_var(new):
            nv = copy.deepcopy(var)
            nv.name = new
            nv.stop_gradient = True       # frozen teacher
            nv.trainable = False
            s_block.vars[new] = nv
        if var.persistable:
            val = scope.find_np(name)
            if val is not None:
                scope.set(new, val)

    for op in t_block.ops:
        inputs = {k: [rename(n) for n in v] for k, v in op.inputs.items()}
        outputs = {k: [rename(n) for n in v] for k, v in op.outputs.items()}
        s_block.ops.append(OpDesc(op.type, inputs, outputs, dict(op.attrs),
                                  op.role))
    student_program._version += 1
    return student_program


# ---- losses on torch tensors; the teacher side is detached -------------

def soft_label_loss(teacher_logits, student_logits, temperature=4.0):
    """KL(teacher || student) at temperature T, scaled by T^2 (Hinton)."""
    import torch
    t = torch.log_softmax(teacher_logits.detach() / temperature, dim=-1)
    s = torch.log_softmax(student_logits / temperature, dim=-1)
    return torch.mean(torch.sum(torch.exp(t) * (t - s), dim=-1)) \
        * temperature ** 2


def l2_loss(teacher_feat, student_feat):
    import torch
    return torch.mean((teacher_feat.detach() - student_feat) ** 2)


def fsp_loss(t_a, t_b, s_a, s_b):
    """Flow-of-solution-procedure matrices (contrib/slim fsp_loss): the
    Gram matrix between two [N, C, H, W] feature maps of each network,
    matched in L2."""
    import torch

    def fsp(a, b):
        n, ca, h, w = a.shape
        cb = b.shape[1]
        a2 = a.reshape(n, ca, h * w)
        b2 = b.reshape(n, cb, h * w)
        return torch.einsum("nax,nbx->nab", a2, b2) / (h * w)

    return torch.mean((fsp(t_a.detach(), t_b.detach())
                       - fsp(s_a, s_b)) ** 2)
