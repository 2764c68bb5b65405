"""Dataset-level fairness / consent audit via composition, on the port.

    PYTHONPATH=src python examples/torch/fairness_audit.py              # the card
    PYTHONPATH=src python examples/torch/fairness_audit.py --device cpu

The twin of ``examples/fairness_audit.py`` on ``repro_torch``.  The paper's
motivating audit: "determine the proportion of female/male individuals in
the output dataset using a gender attribute available only in the input
dataset".  It runs three ways, which must agree:

  1. one backward record plan through the unified query API
     (``prov(idx)...backward()``, the walking reference);
  2. the composed relation (``dataset_lineage``: boolean-semiring products
     of the per-op tensors, ``kernels.ops.bitmatmul`` on the card);
  3. the MESH-SHARDED audit: the relation's rows sharded over a
     ("data",) mesh of this process's world (``make_local_mesh``; one rank
     here, NCCL on the card, gloo on the CPU), one int32 all-reduce.

Then one ``erasure_plan`` per group answers "which downstream records derive
from this group's rows", cross-checked against method 2's relation.
"""
import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.compose import dataset_lineage
from repro_torch.core.device import resolve_device
from repro_torch.core.distributed import lineage_audit_sharded, shard_relation
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.dataprep.table import Table
from repro_torch.dataprep.tracked import track
from repro_torch.kernels.ref import pack_bits
from repro_torch.launch.mesh import init_world, make_local_mesh
from repro_torch.provenance import erasure_plan, prov

N = 2000


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the host)")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    # --- a credit-scoring style pipeline -------------------------------------
    idx = ProvenanceIndex("audit", device=dev)
    src = Table.from_columns({
        "gender": rng.integers(0, 2, N).astype(np.float32),
        "age": rng.uniform(18, 80, N).astype(np.float32),
        "income": rng.lognormal(10, 1, N).astype(np.float32),
        "score": rng.normal(size=N).astype(np.float32),
    }, device=dev)
    t = track(src, idx, "applicants")
    t = t.impute(["income"], strategy="median")
    t = t.normalize(["age", "income"], kind="zscore")
    t = t.drop_columns(["gender"])                    # gender REMOVED mid-pipeline
    t = t.filter_rows(t.table.col("score") > 0.2)    # selection step
    t = t.oversample(frac=0.25, seed=3)
    t.mark_sink()
    sink = t.dataset_id
    n_out = idx.datasets[sink].n_rows
    print(f"pipeline: {N} applicants -> {n_out} selected+augmented records "
          f"(gender column dropped mid-way), on {dev}\n")
    gender = src.col("gender").to(torch.int64)

    # --- 1. hop-by-hop reference (one lazy backward plan) ----------------------
    t0 = time.perf_counter()
    contributors = (prov(idx).source(sink).rows(np.arange(n_out))
                    .backward().to("applicants").run())
    ref_counts = torch.bincount(gender[contributors], minlength=2).cpu().numpy()
    t_ref = time.perf_counter() - t0

    # --- 2. composition -------------------------------------------------------
    t0 = time.perf_counter()
    rel = dataset_lineage(idx, "applicants", sink)          # (N, n_out) bool
    hits = rel.any(dim=1)
    comp_counts = torch.bincount(gender[hits], minlength=2).cpu().numpy()
    t_comp = time.perf_counter() - t0

    # --- 3. sharded audit over a ("data",) mesh ---------------------------------
    init_world(0, 1, store=dist.HashStore(), device_type=dev.type)
    try:
        mesh = make_local_mesh(dev.type)
        rel_sh = shard_relation(pack_bits(rel), mesh)
        grp = shard_relation(gender.to(torch.int32), mesh)
        mw = pack_bits(torch.ones((1, n_out), dtype=torch.bool, device=dev))[0]
        t0 = time.perf_counter()
        shard_counts = lineage_audit_sharded(rel_sh, grp, mw, 2).cpu().numpy()
        t_shard = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()

    print(f"{'method':28s} {'female':>7s} {'male':>7s} {'time':>9s}")
    print(f"{'1. hop-by-hop Q2':28s} {ref_counts[0]:7d} {ref_counts[1]:7d} {t_ref*1e3:7.1f}ms")
    print(f"{'2. composition':28s} {comp_counts[0]:7d} {comp_counts[1]:7d} {t_comp*1e3:7.1f}ms")
    print(f"{'3. sharded audit':28s} {shard_counts[0]:7d} {shard_counts[1]:7d} "
          f"{t_shard*1e3:7.1f}ms")
    if not ((ref_counts == comp_counts).all() and (ref_counts == shard_counts).all()):
        raise SystemExit("the three methods disagree")
    sel = ref_counts / ref_counts.sum()
    base = np.bincount(gender.cpu().numpy(), minlength=2) / N
    print(f"\nselection rate by gender: female {sel[0]:.3f} vs base {base[0]:.3f}; "
          f"male {sel[1]:.3f} vs base {base[1]:.3f}")
    print("all three methods agree — the audit answers WITHOUT the gender column "
          "ever reaching the output dataset.")

    # --- 4. impact API: erasure closure over protected-group rows ---------------
    out_by_group = []
    for g, label in ((0, "female"), (1, "male")):
        plan = erasure_plan(idx, "applicants", torch.nonzero(gender == g).reshape(-1))
        impact = plan.impact(sink)
        derived = impact.rows.cpu() if impact is not None else torch.empty(0, dtype=torch.int64)
        out_by_group.append(derived)
        print(f"erasure closure [{label:6s}]: {len(derived)}/{n_out} output "
              f"records derive from {int((gender == g).sum())} applicants; "
              f"rebuild {list(plan.rebuild)}")
        want = torch.nonzero(rel[gender == g].any(dim=0)).reshape(-1).cpu()
        if not torch.equal(derived, want):
            raise SystemExit(f"erasure closure [{label}] disagrees with the relation")
    union = torch.unique(torch.cat(out_by_group))
    if not torch.equal(union, torch.nonzero(rel.any(dim=0)).reshape(-1).cpu()):
        raise SystemExit("the union of the closures disagrees with the relation")
    print("impact closure matches the composed relation group-by-group — one "
          "RecomputePlan per erasure request, no per-row loop.")


if __name__ == "__main__":
    main()
