"""The port's examples run as real subprocesses on the CPU, as
``tests/test_examples.py`` runs the reference's (a deadline each).

``examples/torch/fairness_audit.py --device cpu`` (world size 1, gloo)
must exit 0 with its landmarks, and its per-group counts and erasure
closures must equal those ``examples/fairness_audit.py`` prints on the same
seeded pipeline.  ``quickstart.py``, ``erasure_audit.py`` and
``streaming_lineage.py`` print the landmarks of ``tests/test_examples.py``
and every line the reference prints, the same (answers, plans, counters,
stats), but for the name of quickstart's composition path.  The serving
twins are in ``test_torch_examples_serving.py``, the training twin in
``test_torch_examples_train.py``.
"""
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(path, *args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run([sys.executable, os.path.join(REPO, path), *args],
                          capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)
    assert proc.returncode == 0, (f"{path} exited {proc.returncode}\n--- stdout ---\n"
                                  f"{proc.stdout}\n--- stderr ---\n{proc.stderr}")
    return proc.stdout


def _answers(out):
    """The three methods' (female, male) counts and the closure lines."""
    counts = [tuple(map(int, m)) for m in re.findall(r"^\d\. .*?\s(\d+)\s+(\d+)\s", out, re.M)]
    return counts, re.findall(r"^erasure closure .*$", out, re.M)


def test_fairness_audit_example_matches_reference():
    out = _run("examples/torch/fairness_audit.py", "--device", "cpu")
    assert "all three methods agree" in out
    assert "impact closure matches the composed relation" in out
    counts, closures = _answers(out)
    assert len(counts) == 3 and len(set(counts)) == 1 and len(closures) == 2
    assert (counts, closures) == _answers(_run("examples/fairness_audit.py"))


def _twins(name):
    """(port output, reference output) of one example."""
    return (_run(f"examples/torch/{name}.py", "--device", "cpu"),
            _run(f"examples/{name}.py"))


def test_quickstart_example_matches_reference():
    out, ref = _twins("quickstart")
    assert "Q2  output record 0 derives from" in out
    assert "run_many fused" in out
    assert "session stats" in out
    path = "whole-dataset lineage relation D_l -> sink"
    same = [line for line in out.splitlines() if not line.startswith(path)]
    assert same == [line for line in ref.splitlines() if not line.startswith(path)]


def test_erasure_audit_example_matches_reference():
    out, ref = _twins("erasure_audit")
    for landmark in ("RecomputePlan", "rebuild order:", "stale cached relations dropped:",
                     "what-if: zero ingest row 0's income", "without rerunning the pipeline"):
        assert landmark in out
    assert out == ref


def test_streaming_lineage_example_matches_reference():
    out, ref = _twins("streaming_lineage")
    for landmark in ("after 40 appended ops: extends=", "spilled to disk",
                     "faulted back: rehydrations=",
                     "bounded: composed-relation residency stayed under"):
        assert landmark in out
    assert out == ref
