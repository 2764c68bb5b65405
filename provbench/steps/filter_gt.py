"""Keep the rows whose ``col`` exceeds ``value``."""


def apply(cur, sources, col, value, op_name="filter"):
    return cur.filter_rows(cur.table.col(col) > value, op_name=op_name)
