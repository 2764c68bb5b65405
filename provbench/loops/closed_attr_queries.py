"""One closed-loop caller of attribute-level what- and how-provenance:
each call builds its plan, runs it in the index's shared ``QuerySession``
and synchronises; the next call starts when it returns.  A query's
latency runs from the start of building its plan to its synchronised
answer.  Kinds: Q3 (forward cells), Q4 (backward cells), Q7 and Q8 (the
same with each probe's hop trace, ``.how()``).  The window closes once
``run.seconds`` have passed and every kind has been called.

Mix parameters: ``kinds`` (each ``{"q": q3|q4|q7|q8, "src": index into
the configuration's sources}``, cycled), ``batch``, ``rows_per_probe``,
``attrs_per_probe`` (a call's probes: rows uniform over the dataset it
starts from, the source for Q3/Q7 and the sink for Q4/Q8, and distinct
attributes uniform over its columns; each call drawn from the seed's
stream as it falls due), ``warmup_calls`` (from a stream of its own, a
multiple of the kinds' number), ``check_calls`` (calls judged: a
reservoir drawn from the seed over those answered, and the one with the
largest answer).

A traced run, once the window and its profiler have closed, replays the
first ``REPLAY_CALLS`` calls of a stream of its own under the port's span
recorder (``repro_torch.core.spans``) and keeps its summary under
``rec["program"]``: inside the profiled window the recorder's ranges
would show on the device's timeline.
"""
from __future__ import annotations

import statistics
import time

import numpy as np

from provbench import hosttable, program
from provbench.loops import _queries
from provbench.reference import how
from provbench.reference.lineage import Answers, count_wrong, run_pipeline
from provbench.streams import Call

KINDS = ("q3", "q4", "q7", "q8")
FORWARD = ("q3", "q7")
HOW = ("q7", "q8")
CELLS_OF = {"q3": "q3", "q4": "q4", "q7": "q3", "q8": "q4"}
REPLAY, REPLAY_CALLS = 5, 64        # the replay's stream and its number of calls


def draw_call(rng: np.random.Generator, mix: dict, sources, sizes, sink: str, i: int) -> Call:
    """The ``i``-th call of the stream, its probes drawn from ``rng``;
    ``sizes`` maps each dataset to its (rows, columns)."""
    batch, k, a = mix["batch"], mix["rows_per_probe"], mix["attrs_per_probe"]
    kind = mix["kinds"][i % len(mix["kinds"])]
    q, src = kind["q"], sources[kind["src"] % len(sources)]
    if q not in KINDS:
        raise ValueError(f"unknown attribute query kind {q!r}")
    n_rows, n_cols = sizes[src if q in FORWARD else sink]
    rows = rng.integers(0, n_rows, size=(batch, k))
    attrs = np.argsort(rng.random((batch, n_cols)), axis=1)[:, :a]
    return Call(q, src, rows, attrs)


def calls(rng, run, sizes, sink, n):
    return [draw_call(rng, run.mix, run.config["sources"], sizes, sink, i) for i in range(n)]


def build_plan(index, sink: str, call: Call):
    from repro_torch.provenance import prov

    q = prov(index)
    if call.q in FORWARD:
        q = q.source(call.src).forward().to(sink)
    else:
        q = q.source(sink).backward().to(call.src)
    q = q.rows_batch(call.rows).attrs_batch(call.attrs)
    return (q.how() if call.q in HOW else q).plan()


def cells_of(res) -> list:
    """A call's per-probe cell tensors (a how answer's first parts)."""
    return [r[0] if isinstance(r, tuple) else r for r in res]


def setup(run):
    tables, index, sink, sizes = _queries.captured(run)
    session = index.session()
    for call in calls(run.rng(hosttable.WARMUP), run, sizes, sink, run.mix["warmup_calls"]):
        session.run(build_plan(index, sink, call))
    program.sync(run.device)
    return {"tables": tables, "index": index, "sink": sink, "session": session,
            "sizes": sizes}


def window(run, st):
    index, sink, session, sizes = st["index"], st["sink"], st["session"], st["sizes"]
    probes_rng, rng = run.rng(hosttable.PROBES), run.rng(hosttable.SAMPLE)
    k = run.mix["check_calls"]
    # answers kept for judging: a reservoir of k calls drawn from the seed,
    # and the call with the largest answer; the others are dropped at once
    kept, largest, largest_size = [], None, -1
    lat, probes, by_kind = [], 0, {}
    with run.window():
        t0 = time.perf_counter()
        i = 0
        while True:
            call = draw_call(probes_rng, run.mix, run.config["sources"], sizes, sink, i)
            t = time.perf_counter()
            try:
                with run.span("plan"):
                    plan = build_plan(index, sink, call)
                with run.span("run"):
                    res = session.run(plan)
                    program.sync(run.device)
            except Exception as exc:        # noqa: BLE001 — counted, judged
                run.failed += 1
                run.notes.append(f"call {i}: {type(exc).__name__}: {exc}"[:300])
            else:
                dt = time.perf_counter() - t
                lat.append(dt)
                by_kind.setdefault(f"{call.q}:{call.src}", []).append(dt)
                probes += call.n_probes
                n_done = len(lat)
                if n_done <= k:
                    kept.append((i, call, res))
                elif rng.random() * n_done < k:
                    kept[int(rng.integers(k))] = (i, call, res)
                size = sum(int(c.numel()) for c in cells_of(res))
                if size > largest_size:
                    largest, largest_size = (i, call, res), size
                del res
            run.attempted += 1
            i += 1
            if time.perf_counter() - t0 >= run.seconds and i >= len(run.mix["kinds"]):
                break
        t1 = time.perf_counter()
    run.rec.update(latencies_ms=[x * 1e3 for x in lat], probes=probes, window_s=t1 - t0)
    run.notes.append("median ms by kind: " + ", ".join(
        f"{kind} {statistics.median(v) * 1e3:.3f}" for kind, v in sorted(by_kind.items())))
    if largest is not None and all(j != largest[0] for j, _, _ in kept):
        kept.append(largest)
    st["kept"] = kept


def replay(run, st) -> None:
    """The port's spans and counters over the replayed calls, under
    ``rec["program"]``: the recorder's summary, ``calls`` and ``how_calls``
    (those of Q7/Q8)."""
    from repro_torch.core import spans

    index, sink, session = st["index"], st["sink"], st["session"]
    todo = calls(run.rng(REPLAY), run, st["sizes"], sink, REPLAY_CALLS)
    with spans.recording() as rec:
        for call in todo:
            session.run(build_plan(index, sink, call))
            program.sync(run.device)
    run.rec["program"] = {"calls": len(todo), "how_calls": sum(c.q in HOW for c in todo),
                          **rec.summary()}


def finish(run, st):
    if run.trace:
        replay(run, st)
    sample = []
    for _, call, res in sorted(st["kept"], key=lambda x: x[0]):
        hops = None
        if call.q in HOW:
            hops = [[(h.op_id, h.category, h.n_records) for h in r[1]] for r in res]
        sample.append((call, program.answers_to_host(cells_of(res)), hops))
    run.judge["sample"] = sample
    run.judge["unanswered"] = run.failed
    run.judge["sink"] = program.sink_to_host(st["index"], st["sink"])
    st.clear()


def wrong(run, sample):
    """(probes whose cells differ, probes whose trace differs) among
    ``sample`` (triples of a call, its cells a probe and its traces a probe
    or None), against the reference pipeline in the configuration's
    precision."""
    lin = _queries.reference(run)
    answers, traces = Answers(lin), how.Traces(run.config, lin)
    cells = hops = 0
    for call, got_cells, got_hops in sample:
        cells += count_wrong(got_cells, answers.answer(CELLS_OF[call.q], call.src, call.rows,
                                                       call.attrs))
        if call.q in HOW:
            hops += how.count_wrong(got_hops, traces.answer(call.q, call.src, call.rows,
                                                            call.attrs))
    return cells, hops


def check(run):
    run.notes.append(f"judged {sum(c.n_probes for c, _, _ in run.judge['sample'])} probes")
    cells, hops = wrong(run, run.judge["sample"])
    return {"wrong_answers": (cells, 0), "wrong_hops": (hops, 0),
            "unanswered": (run.judge["unanswered"], 0), **_queries.sink_check(run)}


def control(run) -> dict:
    """The control's reading: the reference in bfloat16 in the port's place,
    on the same sample."""
    low = run_pipeline(run.config, run.tables, precision="bfloat16")
    answers, traces = Answers(low), how.Traces(run.config, low)
    sample = [(call, answers.answer(CELLS_OF[call.q], call.src, call.rows, call.attrs),
               traces.answer(call.q, call.src, call.rows, call.attrs) if call.q in HOW else None)
              for call, _, _ in run.judge["sample"]]
    cells, hops = wrong(run, sample)
    return {"wrong_answers": cells, "wrong_hops": hops,
            "sink_value_gap": _queries.sink_check(run, low.sink)["sink_value_gap"][0]}
