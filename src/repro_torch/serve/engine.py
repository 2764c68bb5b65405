"""Batched serving engine: the prompt and the new tokens through ``decode_step``.

The port of ``repro.serve.engine``.  The engine holds the KV cache of a
batch of requests, advances them one token per decode step, and traces
every emitted token back to its REQUEST RECORD — record-level
why-provenance of the serving path, captured with the same ProvTensor
machinery as the data pipeline (each response row derives from its request
row: one HAUGMENT link).

The engine owns its OWN :class:`ProvenanceIndex` (the serving pipeline's)
and a :class:`~repro_torch.provenance.catalog.ProvCatalog` around it, both
on the engine's ``device``.  Upstream data-preparation provenance attaches
through ``upstream=``:

* a :class:`~repro_torch.provenance.catalog.BoundaryHandle` minted by
  ``prep_index.export(dataset_id)`` — the engine registers the read-only
  capability, never the prep index object itself, and links each recorded
  request batch to boundary rows through the ``request_ids`` alignment;
* or ``(catalog, "name/dataset")`` — the engine registers its serving
  index into an EXISTING catalog and uses that qualified ref as the
  boundary.

``generate(..., record_provenance=True)`` registers the
(response -> request) op; :meth:`ServeEngine.response_lineage` /
:meth:`ServeEngine.response_lineage_batch` compile to ``QueryPlan``\\ s —
serving-local targets route through the index's shared ``QuerySession``,
upstream targets through the catalog's ``FederatedSession``, which crosses
the boundary into the prep member's own session (its fused walk where that
session is configured so), tracing responses back to raw prep sources.

The legacy ``prov_index=`` attach — handing the engine the whole prep
index to record into — is DEPRECATED (it grants the serving tier mutation
rights over data-prep provenance): it still works, wrapped in a
single-entry catalog, and warns once per process.

The engine serves every model family of the configs: the decoder-only LM
(dense, SSD, MoE and hybrid stacks) and the encoder-decoder, whose
``generate`` takes the stub frontend's ``frames`` and encodes them into the
cache before the prompt is consumed.  It serves; it does not train.

The weights are cast to the engine's ``dtype`` once, when it is built (the
norm scales, the MoE router and the SSD's ``A_log``/``dt_bias`` stay
float32): the values of the reference's per-matmul cast, at half the
bytes a bf16 step reads.  Sampling draws from a ``torch.Generator`` on the
engine's device: seeded and deterministic, but not the reference's
``jax.random`` stream.
"""
from __future__ import annotations

import dataclasses
import sys
import warnings
from typing import List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.opcat import AttrMap, CaptureInfo, OpCategory
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.dataprep.table import Table
from repro_torch.models import whisper as W
from repro_torch.models.registry import get_model
from repro_torch.provenance.catalog import (
    BoundaryHandle,
    ProvCatalog,
    qualify,
    split_ref,
)

__all__ = ["ServeEngine", "GenerationResult"]

_DEPRECATION_WARNED: Set[str] = set()


def _warn_once(key: str, message: str) -> None:
    """Once-per-process deprecation.

    The stacklevel is computed, not hardcoded: the ``prov_index=`` path
    reaches here through ``__init__`` → ``_init_provenance`` while tests
    drive ``_init_provenance`` directly — a fixed level points one of the
    two at an engine-internal frame instead of the caller's
    ``ServeEngine(...)`` line.  Walking out of this module's frames
    attributes the warning to the first external call site on either
    path."""
    if key in _DEPRECATION_WARNED:
        return
    _DEPRECATION_WARNED.add(key)
    level, frame = 2, sys._getframe(1)
    while frame.f_back is not None and frame.f_globals.get("__name__") == __name__:
        frame = frame.f_back
        level += 1
    warnings.warn(message, DeprecationWarning, stacklevel=level)


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray        # (B, n_new) int32
    request_ids: np.ndarray   # (B,) provenance: emitted row -> request row
    # set when the generation was recorded into the engine's index:
    request_dataset: Optional[str] = None
    response_dataset: Optional[str] = None


class ServeEngine:
    """``ServeEngine(cfg, params, max_seq, dtype=torch.bfloat16,
    upstream=None, device=None)``: ``params`` is the port's model of
    ``cfg`` (an ``LM`` or a ``Whisper``, from ``get_model(cfg).init_params``
    or ``carry.params_from_numpy``), copied once onto ``device`` (``None``:
    the card, raising without one) in ``dtype``."""

    def __init__(self, cfg: ModelConfig, params, max_seq: int,
                 dtype=torch.bfloat16,
                 upstream=None,
                 prov_index: Optional[ProvenanceIndex] = None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = get_model(cfg)
        self.params = self.model.cast_params(cfg, params, dtype, self.device)
        self.max_seq = max_seq
        self.dtype = dtype
        self._init_provenance(f"serve:{cfg.name}", upstream=upstream,
                              prov_index=prov_index, device=self.device)

    def _decode(self, token: torch.Tensor, pos: int, cache):
        """One decode step of the whole batch (logits (B, V), cache)."""
        return self.model.decode_step(self.cfg, self.params, token, pos, cache,
                                      dtype=self.dtype)

    # -- provenance wiring ------------------------------------------------------
    def _init_provenance(self, name: str, upstream=None,
                         prov_index: Optional[ProvenanceIndex] = None,
                         device=None) -> None:
        """Build the serving index + catalog on ``device`` (``None``: the
        card, raising without one).  Split out of ``__init__`` so the
        capture path is testable without instantiating a model."""
        device = resolve_device(device)
        self._n_generations = 0
        self._upstream: Optional[Tuple[str, str]] = None  # (member, boundary ds)
        if prov_index is not None:
            if upstream is not None:
                raise ValueError(
                    "pass either upstream= (catalog attach) or the deprecated "
                    "prov_index=, not both")
            _warn_once(
                "prov_index",
                "ServeEngine(prov_index=...) is deprecated: handing the "
                "serving tier the whole data-prep index grants it record() "
                "rights over prep provenance.  Attach upstream lineage with "
                "upstream=prep_index.export(dataset_id) (a read-only "
                "BoundaryHandle) or upstream=(catalog, 'name/dataset') "
                "instead; the passed index is wrapped in a single-entry "
                "catalog for now.",
            )
            self.prov = prov_index
            self._serve_name = "serve"
            self.catalog = ProvCatalog(name, device=device)
            self.catalog.register(self._serve_name, self.prov)
            return
        self.prov = ProvenanceIndex(name, device=device)
        if upstream is None:
            self._serve_name = "serve"
            self.catalog = ProvCatalog(name, device=device)
            self.catalog.register(self._serve_name, self.prov)
        elif isinstance(upstream, BoundaryHandle):
            self._serve_name = "serve"
            self.catalog = ProvCatalog(name, device=device)
            up_name = upstream.index_name
            if not up_name or "/" in up_name or up_name == self._serve_name:
                up_name = "upstream"
            self.catalog.register(up_name, upstream)
            self.catalog.register(self._serve_name, self.prov)
            self._upstream = (up_name, upstream.boundary)
        elif (isinstance(upstream, tuple) and len(upstream) == 2
                and isinstance(upstream[0], ProvCatalog)):
            catalog, ref = upstream
            catalog.datasets[ref]   # resolve the DATASET now: a typo'd ref
                                    # must fail here, not at first generate()
            serve_name, i = "serve", 2
            while serve_name in catalog.members:
                serve_name, i = f"serve{i}", i + 1
            catalog.register(serve_name, self.prov)
            self.catalog = catalog
            self._serve_name = serve_name
            self._upstream = split_ref(ref)
        else:
            raise TypeError(
                f"upstream= takes a BoundaryHandle or (ProvCatalog, "
                f"'name/dataset'), got {type(upstream).__name__}")

    @property
    def session(self):
        """The engine's (index-shared) provenance QuerySession."""
        return self.prov.session()

    @property
    def federation(self):
        """The catalog's shared FederatedSession (cross-index lineage)."""
        return self.catalog.session()

    def _next_token(self, logits: torch.Tensor, greedy: bool,
                    gen: Optional[torch.Generator]) -> torch.Tensor:
        """Greedy: argmax (the first of equal maxima).  Otherwise a
        temperature-1 categorical draw by the Gumbel-max trick, as
        ``jax.random.categorical`` draws, from ``gen``."""
        if greedy:
            return torch.argmax(logits, dim=-1)
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return torch.argmax(logits.float() - torch.log(-torch.log(u)), dim=-1)

    @torch.no_grad()
    def generate(
        self,
        prompts: np.ndarray,           # (B, S_prompt) int32, -1 padded on the LEFT
        n_new: int,
        request_ids: Optional[np.ndarray] = None,
        greedy: bool = True,
        sample_seed: int = 0,          # greedy=False: generator seed (temperature 1)
        frames: Optional[np.ndarray] = None,   # enc-dec: stub frontend output
        record_provenance: bool = False,
        request_source: Optional[str] = None,  # existing dataset the requests
                                               # are rows of (else auto-added)
    ) -> GenerationResult:
        """The prompts are consumed token by token through ``decode_step``
        (left pads become token 0 and are not masked), then ``n_new``
        tokens are generated.  An encoder-decoder first encodes ``frames``
        (B, enc_seq, d_model) into the cache; without them it raises
        ``AssertionError``, as the reference does."""
        cfg = self.cfg
        prompts = np.asarray(prompts)
        b, sp = prompts.shape
        cache = self.model.init_cache(cfg, b, self.max_seq, dtype=self.dtype,
                                      device=self.device)
        if cfg.is_encdec:
            if frames is None:
                raise AssertionError("enc-dec serving needs frames")
            W.encode_into_cache(cfg, self.params, torch.as_tensor(
                np.asarray(frames), dtype=self.dtype, device=self.device), cache)
        toks = torch.as_tensor(np.where(prompts < 0, 0, prompts).astype(np.int64),
                               device=self.device)
        logits = None
        for t in range(sp):
            logits, cache = self._decode(toks[:, t], t, cache)

        # greedy: argmax.  greedy=False: temperature-1 sampling from a
        # SEEDED generator — deterministic for a given (params, prompts,
        # sample_seed), the reproducibility contract the provenance record
        # rests on.
        gen = None
        if not greedy:
            gen = torch.Generator(device=self.device).manual_seed(sample_seed)
        out = []
        cur = self._next_token(logits, greedy, gen)
        for i in range(n_new):
            out.append(cur.to(torch.int32).cpu().numpy())
            logits, cache = self._decode(cur, sp + i, cache)
            cur = self._next_token(logits, greedy, gen)

        request_ids_given = request_ids is not None
        if request_ids is None:
            request_ids = np.arange(b, dtype=np.int64)
        result = GenerationResult(
            tokens=np.stack(out, axis=1),
            request_ids=np.asarray(request_ids),
        )
        if record_provenance:
            self._record_generation(result, prompt_len=sp, n_new=n_new,
                                    request_source=request_source,
                                    request_ids_given=request_ids_given)
        return result

    # -- provenance capture ----------------------------------------------------
    def _record_generation(self, result: GenerationResult, prompt_len: int,
                           n_new: int, request_source: Optional[str],
                           request_ids_given: bool = True) -> None:
        """Register the (response row -> request row) HAUGMENT op.

        With ``request_source`` the responses link to rows of an EXISTING
        dataset of the serving index (``request_ids`` are row indices into
        it).  With an ``upstream=`` attach and no ``request_source``, the
        fresh request dataset is LINKED to the upstream boundary through the
        ``request_ids`` row alignment (each request row came from that
        boundary row; ``-1`` marks a request with no upstream origin) —
        lineage then continues into the data-prep pipeline across the
        federation."""
        b = result.tokens.shape[0]
        dev = self.prov.device
        # unique per INDEX, not per engine: several engines may share one
        # prov index, or the index may already hold earlier generations
        gid = self._n_generations
        while (f"responses@{gid}" in self.prov.datasets
               or f"requests@{gid}" in self.prov.datasets):
            gid += 1
        self._n_generations = gid + 1
        if request_source is None:
            upstream = self._upstream
            alignment = None
            if upstream is not None:
                # the boundary link is a lineage ASSERTION — never fabricate
                # it from the arange() default, and validate the alignment
                # BEFORE any index mutation so a bad batch can't leave an
                # orphan requests@N dataset behind
                if not request_ids_given:
                    raise ValueError(
                        "upstream-attached engines need explicit request_ids "
                        "(rows of the boundary dataset, -1 for requests with "
                        "no upstream origin) to record provenance")
                up_name, boundary = upstream
                n_up = self.catalog.datasets[qualify(up_name, boundary)].n_rows
                alignment = np.asarray(result.request_ids, np.int64)
                if alignment.size and (alignment.max() >= n_up
                                       or alignment.min() < -1):
                    raise ValueError(
                        f"request_ids must be rows of the boundary dataset "
                        f"{qualify(up_name, boundary)!r} (in [-1, {n_up})), "
                        f"got range [{alignment.min()}, {alignment.max()}]")
            req_ds = f"requests@{gid}"
            self.prov.add_source(req_ds, Table.from_columns({
                "request_id": np.asarray(result.request_ids, np.float32),
                "prompt_len": np.full(b, prompt_len, np.float32),
            }, device=dev))
            src_rows = torch.arange(b, dtype=torch.int32, device=dev)
            if alignment is not None:
                self.catalog.link(
                    qualify(up_name, boundary),
                    qualify(self._serve_name, req_ds),
                    alignment=alignment,
                )
        else:
            if request_source not in self.prov.datasets:
                raise KeyError(f"unknown request dataset {request_source!r}")
            req_ds = request_source
            src_rows = torch.as_tensor(np.asarray(result.request_ids, dtype=np.int32),
                                       device=dev)
        resp_ds = f"responses@{gid}"
        self.prov.record(
            [req_ds], resp_ds,
            Table.from_columns({
                "request_id": np.asarray(result.request_ids, np.float32),
                "n_tokens": np.full(b, n_new, np.float32),
            }, device=dev),
            CaptureInfo(op_name="generate", category=OpCategory.HAUGMENT,
                        contextual=False, n_out=b,
                        n_in=[self.prov.datasets[req_ds].n_rows],
                        src_rows=src_rows,
                        attr_maps=[AttrMap(kind="identity")],
                        params={"n_new": n_new, "prompt_len": prompt_len}),
            keep_output=True,
        )
        result.request_dataset = req_ds
        result.response_dataset = resp_ds

    # -- lineage queries (shared session / federation) ---------------------------
    def _lineage_target(self, dst: str) -> Tuple[bool, str]:
        """Resolve a lineage target dataset: ``(federated?, ref)``.

        Accepts a dataset of the serving index (local plan), a qualified
        catalog ref (``"prep/raw"``), or a bare dataset of the attached
        upstream member (auto-qualified)."""
        if dst in self.prov.datasets:
            return False, dst
        if "/" in dst and dst in self.catalog.datasets:
            return True, dst
        if self._upstream is not None:
            ref = qualify(self._upstream[0], dst)
            if ref in self.catalog.datasets:
                return True, ref
        raise KeyError(
            f"unknown lineage target {dst!r}: not a serving dataset, a "
            f"qualified catalog ref, or an upstream dataset")

    def _lineage_builder(self, result: GenerationResult, dst: str):
        from repro_torch.provenance import prov

        if result.response_dataset is None:
            raise ValueError("generation was not recorded "
                             "(generate(..., record_provenance=True))")
        federated, ref = self._lineage_target(dst)
        if not federated:
            qb = prov(self.prov).source(result.response_dataset)
            return qb.backward().to(ref), self.session
        qb = prov(self.catalog).source(
            qualify(self._serve_name, result.response_dataset))
        return qb.backward().to(ref), self.federation

    def response_lineage(self, result: GenerationResult, rows=None,
                         upstream: Optional[str] = None) -> torch.Tensor:
        """Rows of ``upstream`` (default: the request dataset) that the given
        response rows derive from, as an int64 tensor on the engine's
        device.  Serving-local targets probe ONE shared composed relation;
        upstream targets cross the boundary through the catalog's
        FederatedSession (plan split + mask stitch), so a response token
        traces to raw prep sources without the engine ever holding the prep
        index."""
        if rows is None:
            rows = np.ones(result.tokens.shape[0], dtype=bool)
        qb, sess = self._lineage_builder(
            result, upstream if upstream is not None else result.request_dataset)
        return qb.rows(rows).run(sess)

    def response_lineage_batch(self, result: GenerationResult, rows_batch,
                               upstream: Optional[str] = None) -> List[torch.Tensor]:
        """Per-request lineage for MANY probe sets in one fused pass — one
        packed probe per member segment, even across the boundary."""
        qb, sess = self._lineage_builder(
            result, upstream if upstream is not None else result.request_dataset)
        return qb.rows_batch(rows_batch).run(sess)

    def erasure_impact(self, rows, source: Optional[str] = None,
                       apply: bool = False):
        """Deletion-propagation plan for erasing ``rows`` of ``source`` —
        the serving tier's GDPR entry point.

        ``source`` defaults to the attached upstream boundary dataset;
        bare names are resolved like lineage targets (serving dataset
        first, then the upstream member).  The closure crosses every
        boundary link downstream — an upstream erasure reaches through
        request batches into recorded responses — and the returned
        :class:`~repro_torch.provenance.impact.RecomputePlan` lists affected
        datasets in execution order plus the stale composed relations.
        ``apply=True`` drops those stale entries before returning."""
        from repro_torch.provenance.impact import apply_invalidations, erasure_plan

        if source is None:
            if self._upstream is None:
                raise ValueError(
                    "no upstream provenance attached; pass source=")
            ref = qualify(*self._upstream)
        else:
            _, ref = self._lineage_target(source)
            if "/" not in ref:
                ref = qualify(self._serve_name, ref)
        plan = erasure_plan(self.catalog, ref, rows)
        if apply:
            apply_invalidations(self.catalog, plan)
        return plan

    # -- serving-tier integration -------------------------------------------------
    def as_backend(self) -> "_EngineBackend":
        """This engine as a :class:`~repro_torch.serve.tier.ServingTier`
        backend.

        Plans execute through the catalog's shared ``FederatedSession`` —
        serving-local probes delegate to the engine's own ``QuerySession``,
        upstream targets split and stitch across the boundary, and
        ``run_many`` fuses either kind across requests.  Bare (unqualified)
        refs naming serving-index datasets are qualified with the engine's
        member name in ``prepare`` so tenants can submit ``responses@0 ->
        requests@0`` probes without knowing the catalog layout — and so
        capability scopes and fuse buckets see one canonical spelling per
        dataset."""
        return _EngineBackend(self)


class _EngineBackend:
    """Tier backend adapter over one engine's federation session.  Its
    ``device`` (the catalog's) is the one the tier makes current for each
    fused pass and waits for."""

    def __init__(self, engine: ServeEngine) -> None:
        self._engine = engine
        self.device = engine.catalog.device

    def _qualify_ref(self, ref: Optional[str]) -> Optional[str]:
        if ref is None or "/" in ref:
            return ref
        if ref in self._engine.prov.datasets:
            return qualify(self._engine._serve_name, ref)
        return ref      # unknown bare ref: let the session raise its error

    def prepare(self, plan):
        refs = {r: self._qualify_ref(r) for r in plan.refs()}
        if all(k == v for k, v in refs.items()):
            return plan
        sub = lambda r: refs.get(r, r) if r is not None else None  # noqa: E731
        return dataclasses.replace(
            plan, source=sub(plan.source), target=sub(plan.target),
            via=sub(plan.via), anchor=sub(plan.anchor))

    def run_many(self, plans) -> List:
        return self._engine.federation.run_many(plans)

    def stats(self):
        return self._engine.federation.stats()
