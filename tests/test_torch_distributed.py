"""The port's ``core.distributed`` against ``repro``'s, on gloo meshes.

Twin of ``tests/test_compose.py::test_sharded_compose_and_audit_match_local``
on its pipeline (``torch_pipegen.compose_pipeline``, the port's twin of
``_pipeline``) with 48 source rows and with 37, a count no rank count
above 1 divides (rows padded to the shard multiple).  One module fixture
spawns gloo jobs of 1, 2 and 4 CPU ranks at once (``torch_spawn``, one
deadline of 180 s); each rank, on a ``make_local_mesh`` ("data",) mesh:

* composes (src -> filter) · (filter -> sink) with ``compose_sharded``
  (B all-gathered in packed words, the local product through
  ``ops.bitmatmul``, whose launch count must rise);
* audits the src rows of each "g" group that reach the first half of the
  sink (``lineage_audit_sharded``), and takes the backward frontier.

At world size 1 every answer equals ``repro``'s (``dataset_lineage``,
``compose_sharded``, ``lineage_audit_sharded`` and
``backward_frontier_sharded`` on a one-device mesh, and the test's local
oracle); at 2 and 4 ranks, and on a (2, 2) ("pod", "data") mesh whose rows
split pod-major over both axes, every rank's answers equal world size 1's.
Tolerance 0: packed words, counts and masks are integers and booleans.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.compose import dataset_lineage as r_lineage
from repro.core.distributed import (
    backward_frontier_sharded as r_frontier,
    compose_sharded as r_compose,
    lineage_audit_sharded as r_audit,
    shard_relation as r_shard,
)
from repro.kernels.ref import pack_bits as r_pack
from repro.launch.mesh import make_mesh_compat
from test_compose import _pipeline
from torch_spawn import run_jobs

WORLDS = [1, 2, 4]
NS = [48, 37]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    specs = [("distributed", w, tmp_path_factory.mktemp(f"dist{w}"), {"ns": NS})
             for w in WORLDS]
    return dict(zip(WORLDS, run_jobs(specs, deadline=180)))


def _reference(n):
    """``repro``'s answers on the same pipeline, on a one-device mesh."""
    idx, to = _pipeline(1, n=n)
    sink, mid = to.dataset_id, idx.ops[1].output_id            # the filter's output
    assert idx.ops[1].info.op_name.startswith("filter")
    n_src, n_dst = idx.datasets["src"].n_rows, idx.datasets[sink].n_rows
    mesh = make_mesh_compat((1,), ("data",))
    rel = r_lineage(idx, "src", sink, use_pallas=False)
    bits = lambda m: np.asarray(r_pack(jnp.asarray(m)))  # noqa: E731
    composed = r_compose(r_shard(bits(r_lineage(idx, "src", mid, use_pallas=False)), mesh),
                         r_shard(bits(r_lineage(idx, mid, sink, use_pallas=False)), mesh), mesh)
    mask = np.zeros(n_dst, bool)
    mask[: n_dst // 2] = True
    mw = jnp.asarray(r_pack(jnp.asarray(mask[None]))[0])
    grp = jnp.asarray(idx.datasets["src"].table.col("g").astype(np.int32))
    rb = r_shard(bits(rel), mesh)
    hits = rel[:, mask].any(axis=1)
    return {"rel_bits": bits(rel).view(np.int32), "composed": np.asarray(composed).view(np.int32),
            "counts": np.asarray(r_audit(rb[:n_src], grp, mw, 2, mesh)),
            "oracle": np.array([np.sum(hits & (np.asarray(grp) == g)) for g in range(2)]),
            "frontier": np.asarray(r_frontier(rb[:n_src], mw, mesh)), "hits": hits}


@pytest.mark.parametrize("n", NS)
def test_world_size_one_matches_reference(jobs, n):
    (got,) = jobs[1]
    got, want = got["data", n], _reference(n)
    np.testing.assert_array_equal(got["rel_bits"], want["rel_bits"])
    np.testing.assert_array_equal(got["composed"], want["composed"])
    np.testing.assert_array_equal(got["composed"], got["rel_bits"])
    np.testing.assert_array_equal(got["composed_dtensor"], got["composed"])   # gather_rows
    np.testing.assert_array_equal(got["counts"], want["counts"])
    np.testing.assert_array_equal(got["counts"], want["oracle"])
    np.testing.assert_array_equal(got["frontier"], want["frontier"])
    np.testing.assert_array_equal(got["frontier"], want["hits"])
    assert got["launches"] >= 1 and got["counts"].dtype == np.int32


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("mesh", ["data 2", "data 4", "pod 2 x data 2"])
def test_ranks_match_world_size_one(jobs, mesh, n):
    world = 2 if mesh == "data 2" else 4
    want = jobs[1][0]["data", n]
    for rank, res in enumerate(jobs[world]):
        got = res["pod" if mesh.startswith("pod") else "data", n]
        assert got["local_rows"] == -(-n // world)            # padded row blocks
        for key in ("composed", "composed_dtensor", "counts", "frontier", "rel_bits"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{key} rank {rank}")
        assert got["launches"] >= 1                           # the local product
