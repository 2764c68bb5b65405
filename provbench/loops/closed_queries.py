"""One closed-loop caller: each call builds its plan, runs it in the
index's shared ``QuerySession`` and synchronises; the next call starts
when it returns.  A query's latency runs from the start of building its
plan to its synchronised answer.

Mix parameters: ``kinds``, ``batch``, ``rows_per_probe``,
``attrs_per_probe`` (see ``streams.draw_call``; each call is drawn from
the seed's stream as it falls due, so no call repeats), ``warmup_calls``
(from a stream of its own, a multiple of the kinds' number),
``check_calls`` (calls judged: a reservoir drawn from the seed over those
answered, and the one with the largest answer).
"""
from __future__ import annotations

import statistics
import time

from provbench import hosttable, program
from provbench.loops import _queries
from provbench.streams import draw_call, query_calls


def setup(run):
    tables, index, sink, sizes = _queries.captured(run)
    session = index.session()
    mix, sources = run.mix, run.config["sources"]
    warm = query_calls(run.rng(hosttable.WARMUP), mix, sources, sizes, sink, mix["warmup_calls"])
    for call in warm:
        session.run(program.build_plan(index, sink, call))
    program.sync(run.device)
    return {"tables": tables, "index": index, "sink": sink, "session": session,
            "sizes": sizes}


def window(run, st):
    index, sink, session = st["index"], st["sink"], st["session"]
    mix, sources, sizes = run.mix, run.config["sources"], st["sizes"]
    probes_rng, rng = run.rng(hosttable.PROBES), run.rng(hosttable.SAMPLE)
    k = run.mix["check_calls"]
    # answers kept for judging: a reservoir of k calls drawn from the seed,
    # and the call with the largest answer; the others are dropped at once
    # (answers held by the thousand make the collector's pauses the tail)
    kept, largest, largest_size = [], None, -1
    lat, probes, by_kind = [], 0, {}
    routes = dict(session.counters)
    with run.window():
        t0 = time.perf_counter()
        i = 0
        while True:
            call = draw_call(probes_rng, mix, sources, sizes, sink, i)
            t = time.perf_counter()
            try:
                with run.span("plan"):
                    plan = program.build_plan(index, sink, call)
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
                size = sum(int(a.numel()) for a in res)
                if size > largest_size:
                    largest, largest_size = (i, call, res), size
                del res
            run.attempted += 1
            i += 1
            if time.perf_counter() - t0 >= run.seconds:
                break
        t1 = time.perf_counter()
    run.rec.update(latencies_ms=[x * 1e3 for x in lat], probes=probes, window_s=t1 - t0)
    run.notes.append("routes in the window: " + ", ".join(
        f"{k} {v - routes[k]}" for k, v in session.counters.items() if v > routes[k]))
    run.notes.append("median ms by kind: " + ", ".join(
        f"{kind} {statistics.median(v) * 1e3:.3f}" for kind, v in sorted(by_kind.items())))
    if largest is not None and all(j != largest[0] for j, _, _ in kept):
        kept.append(largest)
    st["kept"] = kept


def finish(run, st):
    run.judge["sample"] = [(call, program.answers_to_host(res))
                           for _, call, res in sorted(st["kept"], key=lambda x: x[0])]
    run.judge["unanswered"] = run.failed
    run.judge["sink"] = program.sink_to_host(st["index"], st["sink"])
    st.clear()


def check(run):
    run.notes.append(f"judged {sum(c.n_probes for c, _ in run.judge['sample'])} probes")
    return {"wrong_answers": (_queries.wrong_answers(run), 0),
            "unanswered": (run.judge["unanswered"], 0), **_queries.sink_check(run)}


control = _queries.control
