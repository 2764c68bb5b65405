"""Streaming capture: bounded memory + always-warm lineage on a live pipeline, on the port.

    PYTHONPATH=src python examples/torch/streaming_lineage.py              # the card
    PYTHONPATH=src python examples/torch/streaming_lineage.py --device cpu

The twin of ``examples/streaming_lineage.py`` on ``repro_torch``, on the
same seeded stream.  A long-running preparation service never stops
appending ops, so two things that are fine for batch pipelines become
problems: provenance tensors accumulate in device memory without bound,
and a naive composed cache would recompose the whole chain to stay
current.  This example runs a small append stream against both mechanisms:

* ``ProvenanceIndex(spill=...)`` — cold op tensors leave the device for a
  compact on-disk log under an LRU byte budget and fault back transparently
  when a query touches them (answers stay byte-identical);
* ``index.composed(spill=True)`` — the hop-cache extends its warm composed
  relations by ONE closed-form step per appended op (``extends`` counter)
  and spills evicted relations instead of dropping them.
"""
import argparse

import numpy as np

from repro_torch.core.device import resolve_device
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.core.spill import SpillPolicy
from repro_torch.dataprep.table import Table
from repro_torch.dataprep.tracked import track
from repro_torch.provenance import prov

N = 400


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the host)")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(7)

    # --- a spill-tiered index: op tensors bounded to 8 KB resident -------------
    index = ProvenanceIndex("stream", device=dev, spill=SpillPolicy(budget_bytes=8 << 10))
    composed = index.composed(memory_budget_bytes=32 << 10, spill=True)

    cur = track(Table.from_columns({
        "x": rng.normal(size=N).astype(np.float32),
        "g": rng.integers(0, 4, N).astype(np.float32),
    }, device=dev), index, "src")

    # --- the live stream: filters and transforms keep arriving -----------------
    cur = cur.value_transform("x", "scale", factor=1.01)
    composed.relation("src", cur.dataset_id)    # first probe: src is now tracked
    for i in range(40):
        if i % 3 == 2:
            mask = cur.table.col("x") > float(rng.normal(-1.2, 0.3))
            if not bool(mask.any()):
                mask[0] = True
            cur = cur.filter_rows(mask)
        else:
            cur = cur.value_transform("x", "scale", factor=1.01)
        # any probe keeps the composed relation warm: the appended tail is
        # absorbed by ONE closed-form extension per op, never a recompose
        composed.contains("src", cur.dataset_id)

    sink = cur.mark_sink().dataset_id
    stats = composed.stats()
    print(f"after 40 appended ops: extends={stats['extends']} "
          f"recomposes={stats['recomposes']}")

    spill = index.stats()["spill"]
    print(f"op tensors: {spill['resident_ops']} resident "
          f"({spill['resident_bytes']} B <= {spill['budget_bytes']} B budget), "
          f"{spill['spilled_ops']} spilled to disk")

    # --- queries fault spilled state back transparently ------------------------
    rows = prov(index).source(sink).rows([0, 1]).backward().to("src").run()
    print("Q2  sink rows [0, 1] derive from src rows:", rows.tolist())
    fwd = prov(index).source("src").rows(rows[:1].tolist()).forward().to(sink).run()
    print("Q1  src row", int(rows[0]), "reaches sink rows:", fwd.tolist())
    print(f"rehydrations: hop-cache={stats['rehydrations']} "
          f"tensors={index.stats()['spill']['rehydrations']}")

    # --- where does each hop of the chain live right now? ----------------------
    spilled = [d for d in index.datasets if composed.residency("src", d) == "spilled"]
    ram = sum(1 for d in index.datasets if composed.residency("src", d) == "ram")
    print(f"composed relations from src: {ram} in RAM, {len(spilled)} on disk")

    # probing a spilled pair faults it back from the log (one mmap read)
    # instead of recomposing the chain up to it
    composed.relation("src", spilled[0])
    print(f"probe of spilled ('src', '{spilled[0]}') faulted back: "
          f"rehydrations={composed.stats()['rehydrations']}")
    if composed.stats()["bytes"] > 32 << 10:
        raise SystemExit("composed-relation residency exceeded its budget")
    print("bounded: composed-relation residency stayed under the 32 KB budget")


if __name__ == "__main__":
    main()
