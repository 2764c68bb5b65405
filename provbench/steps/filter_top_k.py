"""Keep the ``k`` rows of largest ``col`` (ties by row order), as the
Compas pipeline's filter does: a threshold from the data, then a mask."""
import torch


def apply(cur, sources, col, k, op_name="filter"):
    vals = cur.table.col(col)
    thresh = torch.kthvalue(vals, len(vals) - k + 1).values
    kept = torch.nonzero(vals >= thresh).reshape(-1)[:k]
    mask = torch.zeros(len(vals), dtype=torch.bool, device=vals.device)
    mask[kept] = True
    return cur.filter_rows(mask, op_name=op_name)
