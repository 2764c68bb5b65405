"""A closed loop of captures: each iteration makes a fresh
``ProvenanceIndex``, runs the configuration's pipeline through the tracked
tables into it, marks the sink and synchronises; the index is dropped
before the next iteration (but for the one kept to be judged, drawn from
the seed as the window runs, and the last).  The input tables are made
once, in set-up.

After the window the allocator's bytes are read with the input tables
and the last index alone held, and again after that index is dropped:
the difference is what the index keeps on the device.

Mix parameters: ``warmup_captures``.
"""
from __future__ import annotations

import time

import torch

from provbench import hosttable, program
from provbench.loops._queries import reference, sink_check
from provbench.harness import settle
from provbench.reference.lineage import relation_mismatches, run_pipeline


def setup(run):
    tables = {n: program.to_device(t, run.device) for n, t in run.tables.items()}
    for _ in range(run.mix["warmup_captures"]):
        program.capture(run.config, tables, run.device)
        program.sync(run.device)
    return {"tables": tables}


def window(run, st):
    rng = run.rng(hosttable.SAMPLE)
    kept = last = None
    captures = 0
    spans = run.rec.setdefault("spans", {}) if run.trace else None
    with run.window():
        t0 = time.perf_counter()
        while True:
            last = None     # dropped before the next capture, unless kept
            try:
                index, sink = program.capture(run.config, st["tables"], run.device, spans)
                program.sync(run.device)
            except Exception as exc:        # noqa: BLE001 — counted, judged
                run.failed += 1
                run.notes.append(f"capture {run.attempted}: {type(exc).__name__}: {exc}"[:300])
            else:
                captures += 1
                if rng.random() * captures < 1.0:   # a reservoir of one
                    kept = index
                last = (index, sink)
                del index
            run.attempted += 1
            if time.perf_counter() - t0 >= run.seconds:
                break
        t1 = time.perf_counter()
    rows = sum(t.n_rows for t in run.tables.values())
    run.rec.update(captures=captures, input_rows=rows, window_s=t1 - t0,
                   input_bytes=sum(t.n_rows * t.n_cols * 4 for t in run.tables.values()))
    st.update(kept=kept, last=last)


def finish(run, st):
    kept, last = st.pop("kept"), st.pop("last")
    got = []
    if last is not None:
        last, sink = last
    if kept is not None and kept is not last:
        got.append(program.relations_to_host(kept))
    del kept
    if last is not None:
        settle(run.device)
        held = torch.cuda.memory_allocated(run.device) if run.device.type == "cuda" else 0
        run.rec["prov_bytes"] = last.stats()["prov_bytes"]
        got.append(program.relations_to_host(last))
        run.judge["sink"] = program.sink_to_host(last, sink)
        del last
        settle(run.device)
        if run.device.type == "cuda":
            run.rec["index_bytes"] = held - torch.cuda.memory_allocated(run.device)
    run.judge.update(relations=got, unanswered=run.failed)
    st.clear()


def check(run):
    want = reference(run).ops
    bad = sum(relation_mismatches(g, want) for g in run.judge["relations"])
    if not run.judge["relations"]:
        bad = relation_mismatches([], want)
    run.notes.append(f"judged {len(run.judge['relations'])} captures")
    checks = {"relation_mismatches": (bad, 0), "unanswered": (run.judge["unanswered"], 0)}
    if "sink" in run.judge:
        checks.update(sink_check(run))
    return checks


def control(run) -> dict:
    want = reference(run).ops
    low = run_pipeline(run.config, run.tables, precision="bfloat16")
    return {"relation_mismatches": relation_mismatches(low.ops, want),
            "sink_value_gap": sink_check(run, low.sink)["sink_value_gap"][0]}
