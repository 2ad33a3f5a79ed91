"""fluid.distribute_lookup_table: locate the distributed (parameter-
server-backed) lookup table in a program.

Counterpart of paddle_tpu/distribute_lookup_table.py (the reference's
distribute_lookup_table.py:18, :37, :56)."""
LOOKUP_TABLE_TYPE = "lookup_table"


def find_distributed_lookup_table_inputs(program, table_name):
    """:18 — the Ids vars feeding the distributed table."""
    ids = []
    for op in program.global_block().ops:
        if op.type == LOOKUP_TABLE_TYPE and \
                table_name in op.inputs.get("W", []):
            ids.extend(op.inputs.get("Ids", []))
    return ids


def find_distributed_lookup_table_outputs(program, table_name):
    """:37 — the Out vars produced from the distributed table."""
    outs = []
    for op in program.global_block().ops:
        if op.type == LOOKUP_TABLE_TYPE and \
                table_name in op.inputs.get("W", []):
            outs.extend(op.outputs.get("Out", []))
    return outs


def find_distributed_lookup_table(program):
    """:56 — the unique is_distributed lookup table name (or None).
    Errors if multiple distinct tables are marked distributed, like the
    reference's assert."""
    table_name = None
    for op in program.global_block().ops:
        if op.type == LOOKUP_TABLE_TYPE and \
                op.attrs.get("is_distributed", False):
            w = op.inputs["W"][0]
            if table_name is None:
                table_name = w
            elif table_name != w:
                raise ValueError(
                    "all distributed lookup_table ops must share one "
                    f"table, found {table_name!r} and {w!r}")
    return table_name
