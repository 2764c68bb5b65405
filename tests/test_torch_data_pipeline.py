"""The port's training-data pipeline against ``repro``'s, on the CPU.

Both packages build the same corpus from the same seed: the metadata
table and every document's tokens, the packed tokens, each step's tokens,
labels and sequence rows (into a second epoch), each recorded op (name,
category, inputs, output, shape, contextual flag and every provenance
link) and every lineage answer (Q2 of each recorded batch, Q1 of
documents that reached batches, were filtered out or were duplicates)
must be equal, exactly.  The port's answers are also taken through a walk
session on the fused kernel's plain version and through the default
session.  Then the twins of every test of ``tests/test_data_pipeline.py``.
"""
import numpy as np
import pytest
import torch

from repro.core import query as RQ
from repro.data import pipeline as RP
from repro_torch.core import query as Q
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.data import pipeline as TP
from repro_torch.provenance.session import QuerySession

CPU = "cpu"
CFG = dict(n_docs=256, mean_len=96, seed=7)
STEPS = (0, 1, 2, 3, 5, 40)       # step 40 of batch 8 lies in the second epoch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both():
    """(reference, port) pipelines, each with the batches of STEPS recorded."""
    r = RP.TokenPipeline(RP.CorpusConfig(**CFG), seq_len=128)
    t = TP.TokenPipeline(TP.CorpusConfig(**CFG), seq_len=128, device=CPU)
    for step in STEPS:
        r.batch_at(step, 8, record_provenance=True)
        t.batch_at(step, 8, record_provenance=True)
    return r, t


@pytest.fixture(scope="module")
def tp():
    return TP.TokenPipeline(TP.CorpusConfig(**CFG), seq_len=128, device=CPU)


# ===========================================================================
# Parity with the reference
# ===========================================================================
@pytest.mark.parametrize("cfg", [dict(CFG), dict(n_docs=100, mean_len=20, vocab=97, seed=3,
                                                 min_quality=0.6)])
def test_corpus_equals_reference(cfg):
    rmeta, rdocs = RP.make_corpus(RP.CorpusConfig(**cfg))
    tmeta, tdocs = TP.make_corpus(TP.CorpusConfig(**cfg), device=CPU)
    assert tmeta.columns == rmeta.columns and tmeta.device == torch.device(CPU)
    np.testing.assert_array_equal(tmeta.data.numpy(), rmeta.data)
    np.testing.assert_array_equal(tmeta.null.numpy(), rmeta.null)
    assert len(tdocs) == len(rdocs)
    for a, b in zip(tdocs, rdocs):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_tokens_and_batches_equal_reference(both):
    r, t = both
    assert t.tokens.dtype == torch.int32 and t.tokens.device == torch.device(CPU)
    np.testing.assert_array_equal(t.tokens.numpy(), r.tokens)
    np.testing.assert_array_equal(t.doc_rows, r.doc_rows)
    assert t.n_seq == r.n_seq
    for step in STEPS + (7, 23, 24):
        rb, tb = r.batch_at(step, 8), t.batch_at(step, 8)
        assert set(tb) == set(rb)
        for k in rb:
            assert tb[k].device == torch.device(CPU)
            assert tb[k].numpy().dtype == rb[k].dtype, k
            np.testing.assert_array_equal(tb[k].numpy(), rb[k], err_msg=f"step {step} {k}")


def test_recorded_provenance_equals_reference(both):
    r, t = both
    assert list(t.index.datasets) == list(r.index.datasets)
    for name, rd in r.index.datasets.items():
        td = t.index.datasets[name]
        assert (td.n_rows, td.n_cols, td.columns, td.materialized, td.is_source) == \
            (rd.n_rows, rd.n_cols, rd.columns, rd.materialized, rd.is_source), name
        if rd.materialized:
            np.testing.assert_array_equal(td.table.data.numpy(), rd.table.data)
    assert len(t.index.ops) == len(r.index.ops)
    for ro, to in zip(r.index.ops, t.index.ops):
        assert (to.info.op_name, to.info.category.value, to.info.contextual, to.info.n_out,
                list(to.info.n_in), to.input_ids, to.output_id, to.info.params) == \
            (ro.info.op_name, ro.info.category.value, ro.info.contextual, ro.info.n_out,
             list(ro.info.n_in), ro.input_ids, ro.output_id, ro.info.params)
        rc, tc = np.asarray(ro.tensor.coo), to.tensor.coo.numpy()
        key = lambda a: np.lexsort(a.T[::-1])     # noqa: E731
        np.testing.assert_array_equal(tc[key(tc)], rc[key(rc)], err_msg=ro.info.op_name)


def test_lineage_answers_equal_reference(both):
    r, t = both
    walk = QuerySession(t.index, use_hopcache=False, fused_walk=True)
    docs = set()
    for step in STEPS:
        want = np.asarray(r.batch_to_documents(step))
        for session in (None, walk, t.index.session()):
            got = t.batch_to_documents(step, session)
            assert got.dtype == torch.int64 and got.device == torch.device(CPU)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"step {step}")
        docs.update(int(d) for d in want[:3])
    assert walk.counters["fused_walk"] == len(STEPS)
    quality = r.index.datasets["corpus"].table.col("quality")
    dropped = np.flatnonzero(quality < r.cfg.min_quality)[:3].tolist()
    dupes = sorted(set(r.doc_rows.tolist()) ^ set(range(len(quality))))[:6]
    for d in sorted(docs) + dropped + dupes:
        want = r.document_to_batches(d)
        assert t.document_to_batches(d) == want, d
        assert t.document_to_batches(d, walk) == want, d
    assert any(t.document_to_batches(d) for d in docs)


def test_pack_links_equal_sorted_unique_pairs():
    rng = np.random.default_rng(0)
    for n_seq, s, n_docs in ((0, 4, 0), (1, 8, 1), (3, 5, 4), (40, 16, 90), (7, 1, 7)):
        owner = np.sort(rng.integers(0, max(n_docs, 1), n_seq * s)).astype(np.int32) \
            .reshape(n_seq, s)
        want = np.unique(np.stack([np.repeat(np.arange(n_seq, dtype=np.int32), s),
                                   owner.reshape(-1)], axis=1), axis=0).reshape(-1, 2)
        got = TP._pack_links(owner)
        assert got.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_pipeline_on_a_given_index():
    idx = ProvenanceIndex("mine", device=CPU)
    t = TP.TokenPipeline(TP.CorpusConfig(n_docs=32, mean_len=40, seed=2), seq_len=16, index=idx)
    assert t.index is idx and t.device == torch.device(CPU) and "sequences" in idx.datasets
    with pytest.raises(ValueError, match="index on cpu"):
        TP.TokenPipeline(TP.CorpusConfig(n_docs=32, mean_len=40), seq_len=16,
                         index=ProvenanceIndex("other", device=CPU), device="meta")


# ===========================================================================
# The twins of tests/test_data_pipeline.py
# ===========================================================================
def test_shapes_and_determinism(tp):
    assert tp.tokens.shape[1] == 128
    b1 = tp.batch_at(3, 8)
    tp2 = TP.TokenPipeline(TP.CorpusConfig(**CFG), seq_len=128, device=CPU)
    b2 = tp2.batch_at(3, 8)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert torch.equal(b1["seq_rows"], b2["seq_rows"])


def test_batch_backward_lineage(tp):
    tp.batch_at(0, 8, record_provenance=True)
    docs = tp.batch_to_documents(0)
    assert len(docs) > 0
    n_corpus = tp.index.datasets["corpus"].n_rows
    assert all(0 <= int(d) < n_corpus for d in docs)


def test_document_forward_lineage(tp):
    tp.batch_at(1, 8, record_provenance=True)
    docs = tp.batch_to_documents(1)
    target = int(docs[0])
    batches = tp.document_to_batches(target)
    assert 1 in batches


def test_filtered_documents_have_no_lineage(tp):
    meta = tp.index.datasets["corpus"].table
    dropped = torch.nonzero(meta.col("quality") < tp.cfg.min_quality).reshape(-1)
    if len(dropped):
        masks, _ = Q.forward_record_masks(tp.index, "corpus", dropped[:3])
        seqs = masks.get("sequences")
        assert seqs is None or not bool(seqs.any())


def test_consent_audit(tp):
    """The paper's §IV consent use case: every sequence must trace only to
    consenting documents, and the audit exposes any that do not."""
    tp.batch_at(2, 8, record_provenance=True)
    meta = tp.index.datasets["corpus"].table
    consent = meta.col("consent") > 0
    docs = tp.batch_to_documents(2)
    flagged = [int(d) for d in docs if not bool(consent[d])]
    # the audit finds exactly the non-consenting contributors
    want = set(torch.nonzero(~consent).reshape(-1).tolist()) & set(int(d) for d in docs)
    assert set(flagged) == want


def test_dedup_is_contextual_and_materializes_input(tp):
    op = next(o for o in tp.index.ops if o.info.op_name == "dedup")
    assert op.info.contextual
    for d in op.input_ids:
        assert tp.index.datasets[d].materialized


def test_filtered_document_masks_equal_reference(both):
    """The reference's forward masks of filtered documents, the port's too."""
    r, t = both
    meta = r.index.datasets["corpus"].table
    dropped = np.flatnonzero(meta.col("quality") < r.cfg.min_quality)[:3]
    rm, _ = RQ.forward_record_masks(r.index, "corpus", dropped)
    tm, _ = Q.forward_record_masks(t.index, "corpus", dropped.tolist())
    assert set(tm) == set(rm)
    for k in rm:
        np.testing.assert_array_equal(tm[k].numpy(), rm[k], err_msg=k)
