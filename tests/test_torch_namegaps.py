"""The names the port lacked against ``repro`` (ROADMAP C.1), each held to
the reference on the CPU:

* ``ProvenanceIndex.version`` — bumped by every recorded op, not by
  ``add_source`` (twin of the assertion at ``tests/test_query_parity.py``
  that ``idx.version == len(idx.ops)``), and ``ShardedProvenanceIndex``'s,
  which delegates to its base;
* ``ComposedIndex(extend_eager=False)`` — twins of ``tests/test_spill.py``'s
  ``test_eager_extend_disabled`` and
  ``test_extend_counter_vs_recompose_counter``, with the ``extends`` and
  ``recomposes`` counters equal to ``repro``'s at every step;
* ``capture.structured_capture_enabled()`` inside and outside
  ``force_coo_capture``;
* ``models.common.init_dense`` — shape, dtype and scale (the values are
  torch's draws, not ``jax.random``'s: the empirical standard deviation of
  a 512 x 512 draw is held to the reference's within 3%, about six
  standard errors of a sample of 262,144).
"""
import jax
import numpy as np
import pytest
import torch

import pipegen
from repro.core import capture as r_capture
from repro.core.hopcache import ComposedIndex as RComposed
from repro.core.opcat import AttrMap as RAttrMap
from repro.core.opcat import CaptureInfo as RInfo
from repro.core.opcat import OpCategory as ROpCategory
from repro.dataprep.table import Table as RTable
from repro.dataprep.tracked import TrackedTable as RTracked
from repro.dataprep.tracked import track as rtrack
from repro.models import common as r_common
from repro.provenance import ShardedProvenanceIndex as RSharded
from repro_torch.core import capture
from repro_torch.core.hopcache import ComposedIndex
from repro_torch.core.opcat import AttrMap, CaptureInfo, OpCategory
from repro_torch.dataprep.table import Table
from repro_torch.dataprep.tracked import TrackedTable, track
from repro_torch.models import common
from repro_torch.provenance import ShardedProvenanceIndex
from test_torch_spill import _columns, _filter_chains
from torch_pipegen import random_pipeline

CPU = "cpu"


# ===========================================================================
# ProvenanceIndex.version
# ===========================================================================
def test_version_counts_recorded_ops_not_sources():
    r_idx, r_sink, _ = pipegen.random_pipeline(0)
    t_idx, t_sink, _ = random_pipeline(0)
    assert t_idx.version == r_idx.version == len(t_idx.ops) == len(r_idx.ops)
    rv, tv = RSharded(r_idx, 2, engine="numpy"), ShardedProvenanceIndex(t_idx, 2)
    assert tv.version == rv.version == t_idx.version
    rtrack(RTable.from_columns({"x": np.zeros(3, np.float32)}), r_idx, "late_src")
    track(Table.from_columns({"x": np.zeros(3, np.float32)}, device=CPU), t_idx, "late_src")
    assert t_idx.version == r_idx.version == len(t_idx.ops)   # add_source bumps nothing
    mask = np.zeros(r_idx.datasets[r_sink].n_rows, dtype=bool)
    mask[0] = True
    RTracked(r_idx.datasets[r_sink].table, r_idx, r_sink).filter_rows(mask)
    TrackedTable(t_idx.datasets[t_sink].table, t_idx, t_sink).filter_rows(torch.from_numpy(mask))
    assert t_idx.version == r_idx.version == len(t_idx.ops)
    assert tv.version == rv.version == t_idx.version          # the view follows its base


# ===========================================================================
# ComposedIndex(extend_eager=...)
# ===========================================================================
def _filter_both(r_idx, t_idx, cur, out, seed):
    """``tests/test_spill.py``'s appended filter (rows drawn > 0.1) in both
    packages."""
    cn = r_idx.datasets[cur].n_rows
    kept = np.flatnonzero(np.random.default_rng(seed).random(cn) > 0.1).astype(np.int32)
    cols = _columns(len(kept), 0)
    r_idx.record([cur], out, RTable.from_columns(cols),
                 RInfo(op_name=f"{out}f", category=ROpCategory.HREDUCE, contextual=False,
                       n_out=len(kept), n_in=[cn], kept_rows=kept.copy(),
                       attr_maps=[RAttrMap("identity")]))
    t_idx.record([cur], out, Table.from_columns(cols, device=CPU),
                 CaptureInfo(op_name=f"{out}f", category=OpCategory.HREDUCE, contextual=False,
                             n_out=len(kept), n_in=[cn], kept_rows=torch.from_numpy(kept),
                             attr_maps=[AttrMap("identity")]))


def _counters(ci):
    st = ci.stats()
    return st["extends"], st["recomposes"]


def _same_relation(rc, tc, src, dst):
    """The composed relation (as CSR) and its backend equal the reference's."""
    r, t = rc.relation_csr(src, dst), tc.relation_csr(src, dst)
    np.testing.assert_array_equal(t.to_dense().numpy() != 0, r.toarray() != 0)
    assert tc.relation_backend(src, dst) == rc.relation_backend(src, dst)


@pytest.mark.parametrize("eager", [False, True])
def test_eager_extend_disabled(eager):
    r_idx, t_idx, cur = _filter_chains(n=128, hops=4, seed=23)
    rc, tc = RComposed(r_idx, extend_eager=eager), ComposedIndex(t_idx, extend_eager=eager)
    assert tc.extend_eager == rc.extend_eager == eager
    _same_relation(rc, tc, "d0", cur)
    assert _counters(tc) == _counters(rc)
    _filter_both(r_idx, t_idx, cur, "e0", seed=5)
    assert tc.contains("d0", "e0") == rc.contains("d0", "e0") == eager
    _same_relation(rc, tc, "d0", "e0")               # lazy single-step extend without
    assert _counters(tc) == _counters(rc)
    assert tc.stats()["extends"] >= 1


def test_extend_counter_vs_recompose_counter():
    r_idx, t_idx, cur = _filter_chains(n=128, hops=5, seed=29)
    rc, tc = RComposed(r_idx, extend_eager=False), ComposedIndex(t_idx, extend_eager=False)
    _same_relation(rc, tc, "d0", cur)                 # cold multi-step
    assert _counters(tc) == _counters(rc)
    assert tc.stats()["recomposes"] >= 1
    _filter_both(r_idx, t_idx, cur, "x0", seed=31)
    before = tc.stats()["extends"]
    _same_relation(rc, tc, "d0", "x0")                # ONE pending op
    assert tc.stats()["extends"] == before + 1
    assert _counters(tc) == _counters(rc)


# ===========================================================================
# capture.structured_capture_enabled
# ===========================================================================
def test_structured_capture_enabled_follows_force_coo():
    assert capture.structured_capture_enabled() == r_capture.structured_capture_enabled() is True
    with capture.force_coo_capture(), r_capture.force_coo_capture():
        assert capture.structured_capture_enabled() == \
            r_capture.structured_capture_enabled() is False
        with capture.force_coo_capture(), r_capture.force_coo_capture():
            assert capture.structured_capture_enabled() is False
        assert capture.structured_capture_enabled() is False
    assert capture.structured_capture_enabled() == r_capture.structured_capture_enabled() is True


# ===========================================================================
# models.common.init_dense
# ===========================================================================
@pytest.mark.parametrize("scale", [1.0, 0.02, 1 / np.sqrt(768)])
def test_init_dense_shape_dtype_and_scale(scale):
    shape = (512, 512)
    want = np.asarray(r_common.init_dense(jax.random.PRNGKey(0), shape, scale))
    got = common.init_dense(torch.Generator().manual_seed(0), shape, scale, CPU)
    assert tuple(got.shape) == want.shape == shape
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert got.device.type == "cpu"
    assert abs(float(got.std()) / float(want.std()) - 1) < 0.03
    assert abs(float(got.std()) / scale - 1) < 0.03
    assert abs(float(got.mean())) < 0.03 * scale
    again = common.init_dense(torch.Generator().manual_seed(0), shape, scale, CPU)
    assert torch.equal(got, again)                    # a function of the generator


def test_init_dense_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("the default device is the card here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.init_dense(torch.Generator().manual_seed(0), (2, 2), 1.0)
