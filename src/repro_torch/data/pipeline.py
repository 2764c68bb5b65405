"""Training-data pipeline with first-class provenance.

The port of ``repro.data.pipeline``.  The document -> batch dataflow is
itself a data-preparation pipeline (paper Table I categories in
parentheses), and every step's provenance is captured in a
:class:`~repro_torch.core.pipeline.ProvenanceIndex` on the device:

    raw corpus table
      -> quality filter          (horizontal reduction)
      -> dedup                   (horizontal reduction; contextual)
      -> tokenize + pack to S    (horizontal augmentation, MULTI-PARENT links:
                                  one packed sequence <- several documents)
      -> shuffle + batch         (horizontal reduction per step: the batch's
                                  sequence ids ARE the kept-rows payload)

So "which raw documents fed step 734's batch?" is a Q2 backward query
(:meth:`TokenPipeline.batch_to_documents`) and "which batches did flagged
document 17 reach?" is Q1 (:meth:`TokenPipeline.document_to_batches`),
answered on the card during training.

The corpus comes from the reference's numpy generators, so the tokens,
the labels, every batch's sequence rows, the recorded provenance and every
lineage answer equal ``repro``'s.  The loader is DETERMINISTIC and
RESUMABLE: the batch of step t is a pure function of (seed, t), so a
checkpoint restart re-seeks without state.  Token arrays and batches lie on
the index's device; the per-document token payload stays on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.opcat import AttrMap, CaptureInfo, OpCategory
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.dataprep.table import Table

__all__ = ["CorpusConfig", "TokenPipeline", "make_corpus"]


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    n_docs: int = 2048
    mean_len: int = 384
    vocab: int = 50_000
    seed: int = 0
    min_quality: float = 0.25


_META = ("doc_id", "length", "quality", "source", "consent")


def make_corpus(cfg: CorpusConfig, device=None) -> Tuple[Table, List[np.ndarray]]:
    """Synthetic raw corpus: a metadata table on ``device`` (``None``: the
    card, raising without one; the provenance-visible record space) and the
    per-document int32 token arrays on the host (the hash-tokenized
    payload), drawn as the reference draws them."""
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    lens = np.maximum(16, rng.poisson(cfg.mean_len, cfg.n_docs)).astype(np.int64)
    quality = rng.beta(4, 2, cfg.n_docs).astype(np.float32)
    source = rng.integers(0, 8, cfg.n_docs).astype(np.float32)
    # ~2% exact duplicates to make dedup non-trivial
    dup_of = np.full(cfg.n_docs, -1, np.int64)
    n_dup = max(1, cfg.n_docs // 50)
    dupes = rng.choice(np.arange(1, cfg.n_docs), n_dup, replace=False)
    for d in dupes:
        dup_of[d] = rng.integers(0, d)
    data = np.stack([np.arange(cfg.n_docs, dtype=np.float32), lens.astype(np.float32), quality,
                     source, (rng.random(cfg.n_docs) > 0.05).astype(np.float32)], axis=1)
    docs = []
    for i in range(cfg.n_docs):
        src = dup_of[i] if dup_of[i] >= 0 else i
        r = np.random.default_rng(cfg.seed * 1_000_003 + int(src))
        docs.append(r.integers(1, cfg.vocab, lens[src], dtype=np.int32))
        if dup_of[i] >= 0:
            data[i] = data[src].copy()
            data[i, 0] = i  # doc_id stays unique
    meta = Table.from_columns({c: data[:, j] for j, c in enumerate(_META)}, device=dev)
    return meta, docs


def _pack_links(owner: np.ndarray) -> np.ndarray:
    """The sorted unique (sequence, document) pairs of a (n_seq, S) owner
    table whose rows concatenate to a non-decreasing stream: one pair where
    the document or the sequence changes (``np.unique(..., axis=0)`` of all
    n_seq * S pairs, without sorting them)."""
    n_seq, s = owner.shape
    seq = np.repeat(np.arange(n_seq, dtype=np.int32), s)
    flat = owner.reshape(-1)
    start = np.ones(flat.shape[0], dtype=bool)
    start[1:] = (flat[1:] != flat[:-1]) | (seq[1:] != seq[:-1])
    return np.stack([seq[start], flat[start]], axis=1).astype(np.int32)


class TokenPipeline:
    """corpus -> packed sequences -> deterministic batches, provenance
    captured end to end in a ProvenanceIndex on ``index.device`` (a new
    index on ``device`` when none is given; ``None``: the card, raising
    without one)."""

    def __init__(self, corpus_cfg: CorpusConfig, seq_len: int,
                 index: Optional[ProvenanceIndex] = None, device=None):
        self.cfg = corpus_cfg
        self.seq_len = seq_len
        if index is None:
            index = ProvenanceIndex("data-pipeline", device=device)
        elif device is not None and resolve_device(device) != index.device:
            raise ValueError(f"index on {index.device}, device {device} asked for")
        self.index = index
        self.device = index.device
        self._build()

    # -- the tracked pipeline ------------------------------------------------
    def _build(self) -> None:
        cfg, dev = self.cfg, self.device
        meta, docs = make_corpus(cfg, dev)
        self.index.add_source("corpus", meta)

        # 1. quality filter (HREDUCE)
        kept = torch.nonzero(meta.col("quality") >= cfg.min_quality).reshape(-1).cpu().numpy()
        t1 = meta.take_rows(torch.from_numpy(kept).to(dev))
        self.index.record(
            ["corpus"], "filtered", t1,
            CaptureInfo(op_name="quality_filter", category=OpCategory.HREDUCE,
                        contextual=False, n_out=len(kept), n_in=[meta.n_rows],
                        kept_rows=torch.from_numpy(kept.astype(np.int32)).to(dev),
                        attr_maps=[AttrMap(kind="identity")],
                        params={"min_quality": cfg.min_quality}),
        )

        # 2. dedup by content hash (HREDUCE; contextual: needs the whole set)
        hashes = {}
        uniq = []
        for j, i in enumerate(kept):
            h = docs[i][: min(64, len(docs[i]))].tobytes()
            if h not in hashes:
                hashes[h] = j
                uniq.append(j)
        uniq = np.asarray(uniq, dtype=np.int64)
        t2 = t1.take_rows(torch.from_numpy(uniq).to(dev))
        self.index.record(
            ["filtered"], "deduped", t2,
            CaptureInfo(op_name="dedup", category=OpCategory.HREDUCE,
                        contextual=True, n_out=len(uniq), n_in=[t1.n_rows],
                        kept_rows=torch.from_numpy(uniq.astype(np.int32)).to(dev),
                        attr_maps=[AttrMap(kind="identity")],
                        params={}),
            input_tables=[t1],
        )
        self.doc_rows = kept[uniq]                       # deduped -> corpus row
        self.docs = [docs[i] for i in self.doc_rows]

        # 3. tokenize + pack (HAUGMENT with multi-parent links)
        S = self.seq_len
        stream = np.concatenate(self.docs) if self.docs else np.zeros(0, np.int32)
        owner = np.repeat(np.arange(len(self.docs), dtype=np.int32),
                          [len(d) for d in self.docs])
        n_seq = len(stream) // S
        self.tokens = torch.from_numpy(
            stream[: n_seq * S].reshape(n_seq, S).astype(np.int32)).to(dev)
        owner = owner[: n_seq * S].reshape(n_seq, S)
        seq_table = Table.from_columns({
            "seq_id": np.arange(n_seq, dtype=np.float32),
            "n_docs": ((owner[:, 1:] != owner[:, :-1]).sum(axis=1) + 1).astype(np.float32),
        }, device=dev)
        self.index.record(
            ["deduped"], "sequences", seq_table,
            CaptureInfo(op_name="pack", category=OpCategory.HAUGMENT,
                        contextual=False, n_out=n_seq, n_in=[len(self.docs)],
                        links=torch.from_numpy(_pack_links(owner)).to(dev),
                        attr_maps=[AttrMap(kind="identity")],
                        params={"seq_len": S}),
        )
        self.n_seq = n_seq

    # -- deterministic resumable batches ---------------------------------------
    def _order(self, epoch: int) -> np.ndarray:
        return np.random.default_rng((self.cfg.seed, epoch)).permutation(self.n_seq)

    def batch_at(self, step: int, batch_size: int,
                 record_provenance: bool = False) -> Dict[str, torch.Tensor]:
        """Batch for global step ``step`` (a pure function of seed and step):
        int32 ``tokens`` and ``labels`` (the next token, -1 after the last)
        of shape (batch_size, S) and int64 ``seq_rows``, on the device."""
        per_epoch = max(self.n_seq // batch_size, 1)
        epoch, off = divmod(step, per_epoch)
        rows = self._order(epoch)[off * batch_size: (off + 1) * batch_size]
        seq_rows = torch.from_numpy(rows.astype(np.int64)).to(self.device)
        toks = self.tokens[seq_rows]
        batch = {
            "tokens": toks,
            "labels": torch.cat([toks[:, 1:], toks.new_full((len(rows), 1), -1)], dim=1),
            "seq_rows": seq_rows,
        }
        if record_provenance:
            self._record_batch(step, rows)
        return batch

    def batches(self, batch_size: int, record_provenance: bool = False
                ) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step, batch_size, record_provenance)
            step += 1

    # -- per-batch provenance (HREDUCE of the sequence space) --------------------
    def _record_batch(self, step: int, rows: np.ndarray) -> None:
        ds = f"batch@{step}"
        if ds in self.index.datasets:
            return
        bt = Table.from_columns({"seq_id": rows.astype(np.float32)}, device=self.device)
        self.index.record(
            ["sequences"], ds, bt,
            CaptureInfo(op_name=f"batch_select:{step}", category=OpCategory.HREDUCE,
                        contextual=False, n_out=len(rows), n_in=[self.n_seq],
                        kept_rows=torch.from_numpy(rows.astype(np.int32)).to(self.device),
                        attr_maps=[AttrMap(kind="identity")],
                        params={"step": step}),
        )

    # -- the paper's queries, specialized --------------------------------------
    def batch_to_documents(self, step: int, session=None) -> torch.Tensor:
        """Q2: the corpus rows (int64, on the device) that fed the batch at
        ``step``, through ``session`` (default: the index's shared one)."""
        from repro_torch.provenance import prov

        ds = f"batch@{step}"
        n = self.index.datasets[ds].n_rows
        return (prov(self.index).source(ds).rows(torch.arange(n, device=self.device))
                .backward().to("corpus").run(session))

    def document_to_batches(self, corpus_row: int, session=None) -> List[int]:
        """Q1: the steps whose batches a raw document reached — by the
        per-op walk, or with ``session`` one forward plan per recorded batch
        through it (so a caller can pin the route, e.g. the fused walk)."""
        batches = [ds for ds in self.index.datasets if ds.startswith("batch@")]
        if session is None:
            from repro_torch.core.query import forward_record_masks

            masks, _ = forward_record_masks(self.index, "corpus", [corpus_row])
            hit = [ds for ds in batches if ds in masks and bool(masks[ds].any())]
        else:
            from repro_torch.provenance import prov

            hit = [ds for ds in batches
                   if prov(self.index).source("corpus").rows([corpus_row]).forward()
                   .to(ds).run(session).numel()]
        return sorted(int(ds.split("@")[1]) for ds in hit)
