"""Program debugging / visualization.

Counterpart of paddle_tpu/utils/debug.py (the reference's
graph_viz_pass.cc + debugger.py/graphviz.py and the op DebugStringEx
dump, operator.h:144). `program_to_dot` renders the dataflow of any
block as graphviz DOT; `program_debug_string` is the human-readable
ProgramDesc dump.

Rendering goes through paddle_tpu_torch.analysis.diagnostic.
format_record — the same `SEV [code] location: message` line the
verifier emits — so a debug dump and a findings report read as one
document (`with_diagnostics=True` appends the analysis of the program,
`analysis.lint_graph`).
"""

__all__ = ["program_debug_string", "program_to_dot", "save_program_dot"]


def program_debug_string(program, with_shapes=True,
                         with_diagnostics=False):
    """ProgramDesc dump (framework.py Program.to_string parity). With
    with_diagnostics=True the full analysis pipeline (verifier +
    lints) runs in collect mode and its findings are appended."""
    from paddle_tpu_torch.analysis.diagnostic import format_record

    lines = []
    for block in program.blocks:
        lines.append(f"-- block {block.idx} (parent {block.parent_idx}) --")
        for name, v in sorted(block.vars.items()):
            bits = []
            if with_shapes and v.shape is not None:
                bits.append(f"shape={tuple(v.shape)}")
            if v.dtype is not None:
                from paddle_tpu_torch.core.dtypes import dtype_name
                bits.append(f"dtype={dtype_name(v.dtype)}")
            if v.persistable:
                bits.append("persistable")
            if v.is_parameter:
                bits.append("param")
            lines.append(format_record("info", "var", f"var {name}",
                                       ", ".join(bits) or "-"))
        for i, op in enumerate(block.ops):
            ins = {k: v for k, v in op.inputs.items() if v}
            outs = {k: v for k, v in op.outputs.items() if v}
            lines.append(format_record(
                "info", "op", f"op[{i}] {op.type}",
                f"role={op.role} inputs={ins} outputs={outs} "
                f"attrs={op.attrs}"))
    if with_diagnostics:
        from paddle_tpu_torch.analysis import lint_graph, render_diagnostics
        lines.append(render_diagnostics(lint_graph(program),
                                        "-- diagnostics --"))
    return "\n".join(lines)


def _dot_escape(s):
    return str(s).replace('"', '\\"')


def program_to_dot(program, block_idx=0, max_attr_len=40):
    """Graphviz DOT of one block's dataflow: op nodes (boxes) + var nodes
    (ellipses; parameters shaded). Render with `dot -Tpng`."""
    block = program.blocks[block_idx]
    lines = ["digraph program {", "  rankdir=TB;",
             '  node [fontsize=10, fontname="Helvetica"];']
    seen_vars = set()

    def var_node(name):
        if name in seen_vars:
            return
        seen_vars.add(name)
        style = ""
        v = block.vars.get(name)
        if v is None:
            b = block
            while b.parent_idx >= 0 and v is None:
                b = program.blocks[b.parent_idx]
                v = b.vars.get(name)
        if v is not None and v.is_parameter:
            style = ', style=filled, fillcolor="#c0d8f0"'
        elif v is not None and v.persistable:
            style = ', style=filled, fillcolor="#e8e8c0"'
        shape = ""
        if v is not None and v.shape is not None:
            shape = f"\\n{tuple(v.shape)}"
        lines.append(f'  "v_{_dot_escape(name)}" '
                     f'[label="{_dot_escape(name)}{shape}", '
                     f'shape=ellipse{style}];')

    for i, op in enumerate(block.ops):
        attrs = {k: v for k, v in op.attrs.items()
                 if not isinstance(v, (list, dict)) or len(str(v)) < max_attr_len}
        label = f"{op.type}"
        if attrs:
            label += "\\n" + _dot_escape(
                ", ".join(f"{k}={v}" for k, v in list(attrs.items())[:4]))
        lines.append(f'  "op_{i}" [label="{label}", shape=box, '
                     f'style=filled, fillcolor="#f0f0f0"];')
        for names in op.inputs.values():
            for n in names:
                var_node(n)
                lines.append(f'  "v_{_dot_escape(n)}" -> "op_{i}";')
        for names in op.outputs.values():
            for n in names:
                var_node(n)
                lines.append(f'  "op_{i}" -> "v_{_dot_escape(n)}";')
    lines.append("}")
    return "\n".join(lines)


def save_program_dot(program, path, block_idx=0):
    with open(path, "w") as f:
        f.write(program_to_dot(program, block_idx))
    return path
