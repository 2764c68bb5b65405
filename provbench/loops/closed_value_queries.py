"""One closed-loop caller of record lineage that returns values: each call
builds a ``.values()`` plan, runs it in the index's shared
``QuerySession`` and synchronises; the next call starts when it returns.
A query's latency runs from the start of building its plan to its
synchronised answer with its values.  Kinds: Q1 (forward from a source)
and Q2 (backward from the sink), each to the output of pipeline step
``to``, which the index need not keep: its values are then recomputed.
The window closes once ``run.seconds`` have passed and every kind has
been called.

Mix parameters: ``kinds`` (each ``{"q": q1|q2, "src": index into the
configuration's sources, "to": pipeline step}``, cycled), ``batch``,
``rows_per_probe`` (see ``streams.draw_call``: rows uniform over the
dataset a call starts from, the source for Q1 and the sink for Q2; each
call drawn from the seed's stream as it falls due), ``warmup_calls``
(from a stream of its own, a multiple of the kinds' number),
``check_calls`` (calls judged: a reservoir drawn from the seed over those
answered, and the one with the largest answer).

A traced run, once the window and its profiler have closed, replays the
first ``REPLAY_CALLS`` calls of a stream of its own under the port's span
recorder (``repro_torch.core.spans``) and keeps its summary under
``rec["program"]``.
"""
from __future__ import annotations

import statistics
import time

from provbench import hosttable, program
from provbench.loops import _queries
from provbench.reference import values as ref_values
from provbench.reference.lineage import count_wrong
from provbench.streams import draw_call, query_calls

KINDS = ("q1", "q2")
REPLAY, REPLAY_CALLS = 5, 64        # the replay's stream and its number of calls


def targets(run, index) -> list:
    """The target dataset of each kind of the mix: the output of its
    pipeline step ``to`` (one op a step)."""
    if len(index.ops) != len(run.config["pipeline"]):
        raise ValueError(f"{len(index.ops)} ops captured for "
                         f"{len(run.config['pipeline'])} pipeline steps")
    for kind in run.mix["kinds"]:
        if kind["q"] not in KINDS:
            raise ValueError(f"a values query is Q1 or Q2, not {kind['q']!r}")
    return [index.ops[kind["to"]].output_id for kind in run.mix["kinds"]]


def build_plan(index, sink: str, target: str, call):
    from repro_torch.provenance import prov

    q = prov(index)
    q = q.source(call.src).forward() if call.q == "q1" else q.source(sink).backward()
    return q.to(target).rows_batch(call.rows).values().plan()


def setup(run):
    tables, index, sink, sizes = _queries.captured(run)
    session = index.session()
    mix, sources, tgt = run.mix, run.config["sources"], targets(run, index)
    warm = query_calls(run.rng(hosttable.WARMUP), mix, sources, sizes, sink, mix["warmup_calls"])
    for i, call in enumerate(warm):
        session.run(build_plan(index, sink, tgt[i % len(tgt)], call))
    program.sync(run.device)
    return {"tables": tables, "index": index, "sink": sink, "session": session,
            "sizes": sizes, "targets": tgt}


def window(run, st):
    index, sink, session, tgt = st["index"], st["sink"], st["session"], st["targets"]
    mix, sources, sizes = run.mix, run.config["sources"], st["sizes"]
    probes_rng, rng = run.rng(hosttable.PROBES), run.rng(hosttable.SAMPLE)
    k = mix["check_calls"]
    # answers kept for judging: a reservoir of k calls drawn from the seed,
    # and the call with the largest answer; the others are dropped at once
    kept, largest, largest_size = [], None, -1
    lat, probes, by_kind = [], 0, {}
    with run.window():
        t0 = time.perf_counter()
        i = 0
        while True:
            call = draw_call(probes_rng, mix, sources, sizes, sink, i)
            t = time.perf_counter()
            try:
                with run.span("plan"):
                    plan = build_plan(index, sink, tgt[i % len(tgt)], call)
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
                size = int(res.data.numel())
                if size > largest_size:
                    largest, largest_size = (i, call, res), size
                del res
            run.attempted += 1
            i += 1
            if time.perf_counter() - t0 >= run.seconds and i >= len(mix["kinds"]):
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
    ``rec["program"]``: the recorder's summary and ``calls``."""
    from repro_torch.core import spans

    index, sink, session, tgt = st["index"], st["sink"], st["session"], st["targets"]
    todo = query_calls(run.rng(REPLAY), run.mix, run.config["sources"], st["sizes"], sink,
                       REPLAY_CALLS)
    with spans.recording() as rec:
        for i, call in enumerate(todo):
            session.run(build_plan(index, sink, tgt[i % len(tgt)], call))
            program.sync(run.device)
    run.rec["program"] = {"calls": len(todo), **rec.summary()}


def to_host(res) -> tuple:
    """A call's answer as (columns, [(rows, data, null)] a probe) in numpy."""
    rows, data, null = (t.cpu().numpy() for t in (res.rows, res.data, res.null))
    o = res.offsets
    return list(res.columns), [(rows[a:b], data[a:b], null[a:b]) for a, b in zip(o, o[1:])]


def finish(run, st):
    if run.trace:
        replay(run, st)
    run.judge["sample"] = [(i % len(run.mix["kinds"]), call, to_host(res))
                           for i, call, res in sorted(st["kept"], key=lambda x: x[0])]
    run.judge["unanswered"] = run.failed
    run.judge["sink"] = program.sink_to_host(st["index"], st["sink"])
    st.clear()


def reference(run, precision: str = "float32") -> dict:
    """The values reference of every step the mix targets, in
    ``precision``; the float32 one also serves ``_queries.sink_check``."""
    key = f"values:{precision}"
    if key not in run.judge:
        steps = sorted({kind["to"] for kind in run.mix["kinds"]})
        run.judge[key] = {to: ref_values.run_to(run.config, run.tables, to, precision)
                          for to in steps}
        if precision == "float32":
            run.judge["reference"] = run.judge[key][steps[0]].lineage
    return run.judge[key]


def wrong(run, sample):
    """(probes whose rows differ, probes whose rows, values or columns
    differ) among ``sample`` (triples of the kind's position, the call and
    its host answer), against the float32 reference."""
    want = reference(run)
    rows = vals = 0
    for kind_at, call, (columns, got) in sample:
        tgt = want[run.mix["kinds"][kind_at]["to"]]
        expect = tgt.answer(call.q, call.src, call.rows)
        rows += count_wrong([g[0] for g in got], [w[0] for w in expect])
        vals += abs(len(got) - len(expect)) + sum(
            ref_values.probe_differs(g, w, columns, tgt.table.columns)
            for g, w in zip(got, expect))
    return rows, vals


def check(run):
    run.notes.append(f"judged {sum(c.n_probes for _, c, _ in run.judge['sample'])} probes")
    rows, vals = wrong(run, run.judge["sample"])
    return {"wrong_answers": (rows, 0), "wrong_values": (vals, 0),
            "unanswered": (run.judge["unanswered"], 0), **_queries.sink_check(run)}


def control(run) -> dict:
    """The control's reading: the reference in bfloat16 in the port's place,
    on the same sample."""
    low = reference(run, "bfloat16")
    sample = []
    for kind_at, call, _ in run.judge["sample"]:
        tgt = low[run.mix["kinds"][kind_at]["to"]]
        sample.append((kind_at, call, (list(tgt.table.columns),
                                       tgt.answer(call.q, call.src, call.rows))))
    rows, vals = wrong(run, sample)
    low_sink = next(iter(low.values())).lineage.sink
    return {"wrong_answers": rows, "wrong_values": vals,
            "sink_value_gap": _queries.sink_check(run, low_sink)["sink_value_gap"][0]}
