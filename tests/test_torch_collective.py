"""The port's collective engine against ``repro``'s merged index.

Twins of ``tests/test_sharded_parity.py::test_collective_engine_parity`` at
2, 4 and 8 ranks and ``SEEDS[:4]``: one module fixture spawns three gloo
jobs of CPU ranks at once (``torch_spawn``, one deadline of 240 s); each
rank builds the port's twin of ``pipegen.random_pipeline(seed,
name="shardcoll")``, views it with ``ShardedProvenanceIndex(idx, world,
engine="collective")`` and runs the reference test's probes (drawn here
from its rng) forward and backward through ``session(use_hopcache=False)``,
then the same through the sequential engine.  Every rank's mask stacks
equal ``repro``'s merged session's and the sequential engine's;
``engine_name`` is ``"collective"``; ``"auto"`` picks it with a world of
``n_shards`` ranks and the sequential engine with fewer.  Without a
process group ``"collective"`` raises and ``"auto"`` is sequential.
Tolerance 0: masks are booleans.
"""
import numpy as np
import pytest

import pipegen
from repro.provenance import prov as rprov
from repro_torch.provenance import ShardedProvenanceIndex
from torch_pipegen import random_pipeline
from torch_spawn import run_jobs

WORLDS = [2, 4, 8]
SEEDS = list(range(8))[:4]


def _reference(seed):
    idx, sink, rng = pipegen.random_pipeline(seed, name="shardcoll")
    merged = idx.session()
    fwd = pipegen.row_probes(rng, idx.datasets["src"].n_rows) + [[]]
    bwd = pipegen.row_probes(rng, idx.datasets[sink].n_rows)
    return (fwd, bwd,
            np.asarray(merged.run_masks(rprov(idx).source("src").rows_batch(fwd)
                                        .forward().to(sink).plan())),
            np.asarray(merged.run_masks(rprov(idx).source(sink).rows_batch(bwd)
                                        .backward().to("src").plan())))


@pytest.fixture(scope="module")
def reference():
    return {seed: _reference(seed) for seed in SEEDS}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory, reference):
    probes = {seed: (fwd, bwd) for seed, (fwd, bwd, _, _) in reference.items()}
    specs = [("collective", w, tmp_path_factory.mktemp(f"coll{w}"), {"probes": probes})
             for w in WORLDS]
    return dict(zip(WORLDS, run_jobs(specs, deadline=240)))


@pytest.mark.parametrize("n_shards", WORLDS)
@pytest.mark.parametrize("seed", SEEDS)
def test_collective_engine_parity(jobs, reference, seed, n_shards):
    _, _, want_f, want_b = reference[seed]
    for rank, res in enumerate(jobs[n_shards]):
        got = res[seed]
        assert got["collective"]["name"] == "collective"
        assert got["numpy"]["name"] == "sequential"
        assert got["auto"] == "collective" and got["auto_wider"] == "sequential"
        for engine in ("collective", "numpy"):
            np.testing.assert_array_equal(got[engine]["fwd"], want_f,
                                          err_msg=f"{engine} fwd rank {rank}")
            np.testing.assert_array_equal(got[engine]["bwd"], want_b,
                                          err_msg=f"{engine} bwd rank {rank}")


def test_collective_engine_needs_a_process_group():
    idx, _, _ = random_pipeline(0, name="shardcoll")
    with pytest.raises(RuntimeError, match="process group"):
        ShardedProvenanceIndex(idx, 2, engine="collective")
    assert ShardedProvenanceIndex(idx, 2).engine_name == "sequential"
    assert ShardedProvenanceIndex(idx, 1, engine="auto").engine_name == "sequential"
