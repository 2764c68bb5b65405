"""What the query loops share: the captured index in set-up, the
stream's dataset sizes, and the judging of answers against the plain
reference."""
from __future__ import annotations

from provbench import program
from provbench.reference.lineage import Answers, count_wrong, run_pipeline, value_gap


def captured(run):
    """The configuration's tables on the device and its pipeline captured:
    (device tables, index, sink id, {dataset: (rows, cols)})."""
    tables = {n: program.to_device(t, run.device) for n, t in run.tables.items()}
    index, sink = program.capture(run.config, tables, run.device)
    sizes = {d: (index.datasets[d].n_rows, index.datasets[d].n_cols)
             for d in [*run.config["sources"], sink]}
    return tables, index, sink, sizes


def reference(run):
    """The reference pipeline over the run's tables, worked out once."""
    if "reference" not in run.judge:
        run.judge["reference"] = run_pipeline(run.config, run.tables)
    return run.judge["reference"]


def sink_check(run, sink=None) -> dict:
    """The sink the index holds (or ``sink``, the control's) against the
    reference's: {"sink_value_gap": (reading, the configuration's limit)}."""
    want = reference(run).sink
    got = run.judge["sink"] if sink is None else sink
    return {"sink_value_gap": (value_gap(got, want), run.config["limits"]["sink_value_gap"])}


def wrong_answers(run, answers=None) -> int:
    """Probes among ``run.judge["sample"]`` (pairs of a call and the port's
    answer) whose answer differs from the reference's; with ``answers`` (an ``Answers``), that one's answers are judged
    instead of the port's (the control)."""
    want = Answers(reference(run))
    wrong = 0
    for call, got in run.judge["sample"]:
        if answers is not None:
            got = answers.answer(call.q, call.src, call.rows, call.attrs)
        wrong += count_wrong(got, want.answer(call.q, call.src, call.rows, call.attrs))
    return wrong


def control(run) -> dict:
    """The control's reading: the reference in bfloat16 in the port's place."""
    low = run_pipeline(run.config, run.tables, precision="bfloat16")
    return {"wrong_answers": wrong_answers(run, answers=Answers(low)),
            "sink_value_gap": sink_check(run, low.sink)["sink_value_gap"][0]}
