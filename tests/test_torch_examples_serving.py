"""The port's serving twins, ``examples/torch/{federated_lineage,
serve_with_lineage}.py --device cpu``, run as subprocesses beside the
reference's examples: each prints the landmarks of
``tests/test_examples.py`` and every line the reference prints, the same
(lineage rows, traces to the raw source, plan split, federation and session
counters, provenance bytes), but for the generated tokens (the weights are
random in each package).
"""
import pytest

from test_torch_examples import _run


def _twins(name):
    return (_run(f"examples/torch/{name}.py", "--device", "cpu", timeout=600),
            _run(f"examples/{name}.py", timeout=600))


def _without_tokens(text):
    """The output without the block of generated tokens."""
    lines = text.splitlines()
    if "generated tokens:" not in lines:
        return lines
    i = lines.index("generated tokens:")
    j = next(k for k in range(i + 1, len(lines)) if lines[k].startswith("recorded:"))
    return lines[:i] + lines[j:]


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_federated_lineage_example_matches_reference():
    out, ref = _twins("federated_lineage")
    for landmark in ("capability: prep index is read-only from the serving tier",
                     "traces to raw user row", "batch trace-to-source:", "federation stats:"):
        assert landmark in out
    assert out == ref


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_serve_with_lineage_example_matches_reference():
    out, ref = _twins("serve_with_lineage")
    for landmark in ("response row 2 derives from request row",
                     "session stats (shared composed relations)",
                     "federation stats (single-entry catalog)"):
        assert landmark in out
    assert "generated tokens:" in out
    assert _without_tokens(out) == _without_tokens(ref)
