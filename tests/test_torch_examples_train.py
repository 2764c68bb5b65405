"""The port's training twin, ``examples/torch/train_with_provenance.py
--tiny --steps 2 --device cpu``, beside the reference's example at the same
size, each with its own checkpoint directory: the model, corpus, consent
audit and final index lines (the data path and its lineage) equal the
reference's; the worst-loss batch's Q2 and Q1 lines are compared where
both packages pick the same step (the weights are random in each package,
so the losses differ).
"""
import re

from test_torch_examples import _run

DATA_PATH = ("model:", "corpus:", "consent audit:", "final provenance index:")


def _lines(text, prefixes):
    return [line for line in text.splitlines() if line.strip().startswith(prefixes)]


def test_train_with_provenance_example_matches_reference(tmp_path):
    args = ("--tiny", "--steps", "2")
    out = _run("examples/torch/train_with_provenance.py", *args, "--device", "cpu",
               "--ckpt-dir", str(tmp_path / "port"), timeout=600)
    ref = _run("examples/train_with_provenance.py", *args,
               "--ckpt-dir", str(tmp_path / "ref"), timeout=600)
    assert "trained 2 steps" in out and "worst-loss batch = step" in out
    assert _lines(out, DATA_PATH) == _lines(ref, DATA_PATH)
    assert len(_lines(out, DATA_PATH)) == 4
    worst = [re.search(r"worst-loss batch = step (\d+)", t).group(1) for t in (out, ref)]
    if worst[0] == worst[1]:
        assert _lines(out, ("Q2:", "Q1:")) == _lines(ref, ("Q2:", "Q1:"))
