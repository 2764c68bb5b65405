"""The port's examples run as real subprocesses on the CPU, as
``tests/test_examples.py`` runs the reference's (a deadline each).

``examples/torch/fairness_audit.py --device cpu`` (world size 1, gloo)
must exit 0 with its landmarks, and its per-group counts and erasure
closures must equal those ``examples/fairness_audit.py`` prints on the same
seeded pipeline.
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
