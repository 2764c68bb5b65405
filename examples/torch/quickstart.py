"""Quickstart: TensProv on the paper's own running example (Tables II-V), on the port.

    PYTHONPATH=src python examples/torch/quickstart.py              # the card
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu

The twin of ``examples/quickstart.py`` on ``repro_torch``.  Builds the
join of D^l and D^r, tracks a small preparation pipeline through the
decorator front-end, and answers the Table-VII queries through the unified
lazy query API (``repro_torch.provenance``): a fluent builder compiles
each query to a ``QueryPlan``, and the index's shared ``QuerySession``
picks the physical strategy (vectorized walk vs composed hop-cache probe)
and fuses batches that share endpoints into one pass.  Answers are printed
as numpy arrays, as the original prints them.
"""
import argparse

import numpy as np

from repro_torch.core.compose import dataset_lineage
from repro_torch.core.device import resolve_device
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.dataprep.table import Table
from repro_torch.dataprep.tracked import track
from repro_torch.provenance import prov


def host(t):
    return t.cpu().numpy()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the host)")
    dev = resolve_device(ap.parse_args(argv).device)

    # --- the paper's datasets (Tables II and III) ---------------------------
    dl = Table.from_columns({
        "ID": [10., 20., 30., 40.],
        "Birthdate": [1996.0712, 1994.0308, np.nan, 1987.1123],
        "Gender": [0., 1., 0., 1.],           # F=0, M=1
    }, null={"Birthdate": [False, False, True, False]}, device=dev)
    dr = Table.from_columns({"ID": [20., 40.], "Name": [0., 1.]}, device=dev)  # Alice, Bob

    index = ProvenanceIndex("quickstart", device=dev)
    tl = track(dl, index, "D_l")
    tr = track(dr, index, "D_r")

    # --- the pipeline --------------------------------------------------------
    tj = tl.join(tr, on="ID", how="inner")          # Table IV
    tf = tj.filter_rows(tj.table.col("Gender") > 0.5)
    to = tf.onehot("Gender", n_values=2).mark_sink()
    sink = to.dataset_id

    print("join result rows:", tj.table.n_rows, "| final rows:", to.table.n_rows)
    print("provenance stats:", index.stats())

    # --- Q2: backward why-provenance -----------------------------------------
    print("\nQ2  output record 0 derives from:")
    print("    D_l rows:", host(prov(index).source(sink).rows([0]).backward().to("D_l").run()))
    print("    D_r rows:", host(prov(index).source(sink).rows([0]).backward().to("D_r").run()))

    # --- Q1: forward — which outputs did D_l record 1 (ID=20) reach? ---------
    print("\nQ1  D_l record 1 reaches output rows:",
          host(prov(index).source("D_l").rows([1]).forward().to(sink).run()))
    print("Q1  D_l record 0 (ID=10, dangling) reaches:",
          host(prov(index).source("D_l").rows([0]).forward().to(sink).run()))

    # --- Q4: attribute-value backward ----------------------------------------
    gcol = to.table.columns.index("Gender=1")
    cells = host(prov(index).source(sink).rows([0]).attrs([gcol]).backward().to("D_l").run())
    print(f"\nQ4  cell (row 0, '{to.table.columns[gcol]}') derives from D_l cells:",
          [tuple(c) for c in cells], "(row, attr) =",
          [(int(r), dl.columns[int(a)]) for r, a in cells])

    # --- Q6: how-provenance — the same backward trace, plus the per-op hops ---
    recs, hops = prov(index).source(sink).rows([0]).backward().to("D_l").how().run()
    print("\nQ6  row 0 <- D_l rows", recs.tolist(), "via",
          " -> ".join(h.op_name for h in reversed(hops)))

    # --- Q9: all transformations ----------------------------------------------
    print("\nQ9  transformations applied:",
          [o["op"] for o in prov(index).source(sink).transformations().run()])

    # --- dataset-level composition ---------------------------------------------
    rel = dataset_lineage(index, "D_l", sink)
    print("\nwhole-dataset lineage relation D_l -> sink (the composition path):")
    print(host(rel).astype(int))

    # --- batch queries: one explicit .rows_batch, one vectorized pass ----------
    probes = [[0], [1], [2, 3]]
    print("\nbatched Q1 (one pass over the DAG, all probe sets at once):")
    for p, res in zip(probes, prov(index).source("D_l").rows_batch(probes)
                      .forward().to(sink).run()):
        print(f"    D_l rows {p} -> output rows {res.tolist()}")

    # --- run_many: mixed plans, fused by (source, target) into shared passes ---
    session = index.session()
    plans = [
        prov(index).source("D_l").rows([0]).forward().to(sink).plan(),
        prov(index).source("D_l").rows([1]).forward().to(sink).plan(),   # fuses w/ ^
        prov(index).source(sink).rows([0]).backward().to("D_r").plan(),
    ]
    res = session.run_many(plans)
    print("\nrun_many fused", session.stats()["planner"]["fused_plans"],
          "plans into", session.stats()["planner"]["fused_groups"], "group(s):",
          [r.tolist() for r in res])
    print("session stats:", session.stats())


if __name__ == "__main__":
    main()
