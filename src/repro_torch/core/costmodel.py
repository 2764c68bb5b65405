"""Cost model for provenance query planning, on the H100 port.

The twin of ``repro``'s cost model; the routing it computes is the same on
the same pipelines.  It centralizes

* **per-relation statistics** (:class:`RelStats`) — rows, cols, nnz, density,
  read straight off each :class:`~repro_torch.core.provtensor.ProvTensor`'s
  slot structure or COO without materializing anything new;
* **composition cost estimates** per backend — sparse boolean matmul cost
  scaling with nnz (:func:`spmm_cost`) vs packed-bitplane word ops
  (:func:`bitplane_cost`) — and the density threshold where the packed
  backend overtakes CSR (:func:`pick_backend`);
* an **nnz-aware matrix-chain DP** (:func:`plan_chain_stats`) for einsum
  chain ordering;
* the **planner model** (:class:`CostModel`) comparing estimated walk cost
  (hops × batched gather) against amortized compose-then-probe cost, with
  per-pair demand tracking so repeated small-batch streams eventually
  amortize a composition.

Cost units are *estimated nanoseconds*; only ratios matter.  The ``C_*``
routing defaults and :data:`DENSITY_THRESHOLD` are ``repro``'s, kept so that
routing and ``explain()`` agree with it on the same pipelines.  They were
guesses against a CPU host, not timings of any device;
:mod:`repro_torch.core.calibrate` measures a replacement set on the card
and writes it to the file it is given.  The active set changes only
through :func:`set_constants`: nothing reads a calibration file
implicitly, so a set that should route every run is committed as code
and installed where a reader can see it.

The port always has its sparse backend (torch's CSR), so the backend pick
depends on density alone; ``repro``'s ``have_scipy`` switch has no
counterpart here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "RelStats",
    "Constants",
    "active_constants",
    "set_constants",
    "reset_constants",
    "constants_provenance",
    "DENSITY_THRESHOLD",
    "CROSS_FALLBACK_MIN_DEMAND",
    "compose_est",
    "spmm_cost",
    "bitplane_cost",
    "structured_cost",
    "pick_backend",
    "plan_chain_stats",
    "extend_tail_cost",
    "extend_vs_recompose",
    "relation_probe_cost",
    "cross_route_choose",
    "CostModel",
]

# -- routing defaults (estimated ns; ratios are what matters) -----------------
C_HOP_OVERHEAD = 20_000.0     # dispatch per walk hop
C_MASK_ELEM = 2.0             # per (B, n) mask-stack element scanned per hop
C_GATHER = 40.0               # per (frontier row, neighbor) pair gathered
C_SPMM_OVERHEAD = 45_000.0    # per sparse matmul call
C_SPMM_FLOP = 25.0            # per sparse boolean-semiring flop
C_WORD_OP = 3.0               # per 32-bit word op in a bitplane compose
C_PROBE_OVERHEAD = 30_000.0   # per composed-relation probe call
C_STRUCT_OVERHEAD = 20_000.0  # per closed-form (gather∘gather) compose call
C_TAKE = 1.0                  # per element of the one take it performs
C_STITCH_OVERHEAD = 15_000.0  # per link alignment stitch of a mask stack

# Legacy demand floor for federated stitched-relation composition, used only
# when per-segment relation statistics are unavailable.
CROSS_FALLBACK_MIN_DEMAND = 32

# Density above which the packed-bitplane backend out-costs CSR composition:
# csr flops ≈ 32·d_a·d_b × bitplane word ops, and a sparse flop costs ~8 word
# ops of indexing — the crossover sits near sqrt(1/(32·8)) ≈ 0.06 geometric-
# mean operand density.  Kept as one named constant so tests/docs can pin it.
DENSITY_THRESHOLD = 0.06

# Per-device-dispatch overhead (one kernel launch) — the term the fused
# batched-walk kernel pays ONCE instead of K×3 times.
C_LAUNCH_OVERHEAD = 50_000.0

# Machine roofline terms: the NVIDIA H100 SXM's published figures (NVIDIA's
# H100 data sheet, dense rates, 700 W).
PEAK_FLOPS = 989e12           # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12              # device memory bytes/s
LINK_BW = 450e9               # NVLink bytes/s each way
# 32-bit AND/OR/XOR: 64 results per clock per SM for compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput table)
# x 132 SMs x 1.98 GHz boost clock ~= 16.7e12 word ops/s; each word op
# retires 32 boolean MACs in a bitplane compose.
LOGIC_WORD_OPS = 132 * 64 * 1.98e9


@dataclasses.dataclass(frozen=True)
class Constants:
    """One coherent set of cost/roofline constants, with provenance.

    The module-level ``C_*`` literals above stay the uncalibrated defaults
    (``Constants()`` reproduces them bit-for-bit);
    :mod:`repro_torch.core.calibrate` fits a measured set on the card, and
    code installs a set via :func:`set_constants`.  Every cost function in
    this module reads the ACTIVE set, so one install re-prices the whole
    router — CostModel, ``ComposedIndex(backend="auto")`` and
    ``QuerySession._strategy`` all consume it implicitly.
    """

    c_hop_overhead: float = C_HOP_OVERHEAD
    c_mask_elem: float = C_MASK_ELEM
    c_gather: float = C_GATHER
    c_spmm_overhead: float = C_SPMM_OVERHEAD
    c_spmm_flop: float = C_SPMM_FLOP
    c_word_op: float = C_WORD_OP
    c_probe_overhead: float = C_PROBE_OVERHEAD
    c_struct_overhead: float = C_STRUCT_OVERHEAD
    c_take: float = C_TAKE
    c_stitch_overhead: float = C_STITCH_OVERHEAD
    c_launch_overhead: float = C_LAUNCH_OVERHEAD
    density_threshold: float = DENSITY_THRESHOLD
    # machine roofline terms (satellite of the calibration file)
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW
    logic_word_ops: float = LOGIC_WORD_OPS
    # provenance: where these numbers came from
    source: str = "default"       # "default" | "calibrated"
    device: str = ""              # device name the calibration ran on
    path: str = ""                # calibration file, when source=="calibrated"

    def provenance(self) -> Dict[str, object]:
        """What ``explain()`` surfaces: which constants decided the routing."""
        return {
            "source": self.source,
            "device": self.device or None,
            "path": self.path or None,
            "density_threshold": self.density_threshold,
            "c_word_op": self.c_word_op,
            "c_spmm_flop": self.c_spmm_flop,
            "c_launch_overhead": self.c_launch_overhead,
        }


_ACTIVE = Constants()


def active_constants() -> Constants:
    """The constant set every cost function in this module currently reads."""
    return _ACTIVE


def set_constants(constants: Constants) -> None:
    """Install a constant set (e.g. a calibrated one) module-wide."""
    global _ACTIVE
    _ACTIVE = constants


def reset_constants() -> None:
    """Back to the uncalibrated defaults."""
    global _ACTIVE
    _ACTIVE = Constants()


def constants_provenance() -> Dict[str, object]:
    return _ACTIVE.provenance()


@dataclasses.dataclass(frozen=True)
class RelStats:
    """Statistics of one binary relation (op step or composed accumulation).

    ``structured`` marks relations the structured layer keeps implicit —
    at most one source row per destination row (identity / selection /
    gather slots and their closed-form compositions): composing two such
    relations is one O(cols) take, and the result stores one int32
    per destination row instead of a CSR."""

    rows: int
    cols: int
    nnz: int
    structured: bool = False

    @property
    def density(self) -> float:
        cells = self.rows * self.cols
        return self.nnz / cells if cells else 0.0

    @property
    def out_degree(self) -> float:
        return self.nnz / self.rows if self.rows else 0.0

    def est_bytes(self) -> int:
        """Estimated bytes of the cheaper materialization (implicit gather
        array vs CSR indices+ptr vs packed bitplane) — the retention check
        against a cache budget."""
        csr = 8 * self.nnz + 4 * (self.rows + 1)
        bitplane = 4 * self.rows * max((self.cols + 31) // 32, 1)
        if self.structured:
            return min(4 * self.cols, csr, bitplane)
        return min(csr, bitplane)

    @staticmethod
    def from_slot(tensor, slot: int) -> "RelStats":
        """Stats of one op tensor's forward relation for one input slot —
        read off the implicit structure when the tensor has one, else an
        O(nnz) count off the COO; no CSR/bitplane materialization."""
        return RelStats(
            rows=int(tensor.n_in[slot]),
            cols=int(tensor.n_out),
            nnz=tensor.slot_nnz(slot),
            structured=tensor.slot_structure(slot) is not None,
        )

    @staticmethod
    def from_slot_range(tensor, slot: int, lo: int, hi: int) -> "RelStats":
        """Stats of one op slot restricted to output rows ``[lo, hi)`` —
        the SHARD-LOCAL relation a row-range-partitioned index composes.
        Reads ``slot_nnz_range``, so a shard's backend choice never touches
        the other shards' links."""
        lo, hi = max(int(lo), 0), min(int(hi), int(tensor.n_out))
        return RelStats(
            rows=int(tensor.n_in[slot]),
            cols=max(hi - lo, 0),
            nnz=tensor.slot_nnz_range(slot, lo, hi),
            structured=tensor.slot_structure(slot) is not None,
        )


def compose_est(a: RelStats, b: RelStats) -> RelStats:
    """Estimated stats of ``a ∘ b`` (boolean-semiring product).

    Expected path count is ``a.nnz · b.out_degree``; the union over paths
    saturates the binary relation, modeled as ``cells·(1 - exp(-paths/cells))``
    (independent-placement approximation) so density never exceeds 1.
    Gather∘gather stays a gather, so structuredness is preserved exactly.
    """
    rows, cols = a.rows, b.cols
    structured = a.structured and b.structured
    cells = rows * cols
    if cells == 0:
        return RelStats(rows, cols, 0, structured)
    paths = a.nnz * b.out_degree
    nnz = cells * -math.expm1(-paths / cells)
    return RelStats(rows, cols, int(round(nnz)), structured)


def spmm_cost(a: RelStats, b: RelStats) -> float:
    """CSR (OR,AND) matmul cost: scales with nnz, not dims."""
    return _ACTIVE.c_spmm_overhead + _ACTIVE.c_spmm_flop * a.nnz * b.out_degree


def bitplane_cost(a: RelStats, b: RelStats) -> float:
    """Packed-bitplane compose cost: dense word ops over (rows, mid, cols/32)."""
    words = a.rows * b.rows * max((b.cols + 31) // 32, 1)
    return _ACTIVE.c_word_op * words


def structured_cost(a: RelStats, b: RelStats) -> float:
    """Closed-form gather∘gather compose cost: ONE take over the
    destination dimension — nnz- and density-independent."""
    return _ACTIVE.c_struct_overhead + _ACTIVE.c_take * b.cols


def union_est(a: RelStats, b: RelStats) -> RelStats:
    """Estimated stats of ``a ∪ b`` — the sum over parallel DAG paths,
    capped at full.  A union generally breaks gather structure (two parents
    per destination), so the estimate drops the structured flag; the
    executor still keeps provably-disjoint unions (append's block split)
    structured, making this conservative."""
    cells = a.rows * a.cols
    return RelStats(a.rows, a.cols, min(cells, a.nnz + b.nnz))


def compose_cost_pair(a: RelStats, b: RelStats, backend: str) -> float:
    """Cost of one ``a ∘ b`` merge.  ``backend="auto"`` prices structured
    pairs at their closed form (one take), everything else in the
    representation :func:`pick_backend` would choose for the estimated
    result — the adaptive backend the composed hop-cache actually runs."""
    if backend == "auto":
        if a.structured and b.structured:
            return structured_cost(a, b)
        backend = pick_backend(compose_est(a, b).density)
    return spmm_cost(a, b) if backend == "csr" else bitplane_cost(a, b)


def pick_backend(density: float) -> str:
    """Backend for a relation of the given density: CSR below
    :data:`DENSITY_THRESHOLD`, packed bitplane above it."""
    return "bitplane" if density >= _ACTIVE.density_threshold else "csr"


def plan_chain_stats(stats: Sequence[RelStats], backend: str = "csr") -> List[Tuple[int, int]]:
    """nnz-aware matrix-chain DP over relation statistics.

    Same merge-order contract as :func:`repro_torch.core.compose.plan_chain`
    (``(i, k)`` merges over a working list, innermost first), but merge cost
    is the *backend's* estimate — nnz-scaled sparse matmul for ``csr``,
    per-merge :func:`pick_backend` pricing for ``auto`` — and intermediate
    stats propagate through :func:`compose_est` instead of assuming dense
    dims.  A filter-heavy 0.1%-dense segment is therefore nearly free to
    merge early, where the dims-only DP saw it as square.  (A pure
    ``bitplane`` backend prices by dims alone — its word ops are
    nnz-independent — and reduces to the classic DP.)
    """
    order, _, _ = _chain_dp(stats, backend)
    return order


def _chain_dp(stats: Sequence[RelStats], backend: str
              ) -> Tuple[List[Tuple[int, int]], float, Optional[RelStats]]:
    """The DP behind :func:`plan_chain_stats`, additionally returning the
    optimal total merge cost and the folded whole-chain estimate (what
    :func:`extend_vs_recompose` prices a recompose at)."""
    n = len(stats)
    if n == 0:
        return [], 0.0, None
    if n == 1:
        return [], 0.0, stats[0]
    # Canonical per-segment stats: est[i][j] = left-to-right fold of the
    # segment.  The true relation is associative; compose_est's saturation
    # is not, so fixing one fold order keeps the DP's optimal substructure
    # exact (segment stats must not depend on the split being considered).
    est: List[List[Optional[RelStats]]] = [[None] * n for _ in range(n)]
    for i in range(n):
        est[i][i] = stats[i]
        for j in range(i + 1, n):
            est[i][j] = compose_est(est[i][j - 1], stats[j])
    INF = float("inf")
    cost = [[0.0] * n for _ in range(n)]
    split = [[0] * n for _ in range(n)]
    for length in range(2, n + 1):
        for i in range(0, n - length + 1):
            j = i + length - 1
            cost[i][j] = INF
            for k in range(i, j):
                c = (cost[i][k] + cost[k + 1][j]
                     + compose_cost_pair(est[i][k], est[k + 1][j], backend))
                if c < cost[i][j]:
                    cost[i][j] = c
                    split[i][j] = k
    order: List[Tuple[int, int]] = []

    def emit(i: int, j: int) -> None:
        if i == j:
            return
        k = split[i][j]
        emit(i, k)
        emit(k + 1, j)
        order.append((i, k))

    emit(0, n - 1)
    return order, cost[0][n - 1], est[0][n - 1]


def extend_tail_cost(prefix: RelStats, step: RelStats) -> float:
    """Cost of extending a warm composed ``prefix`` by ONE structured
    ``step`` via the closed forms in :mod:`repro_torch.core.compose`: a
    structured prefix pays one take (:func:`structured_cost`); a dense
    prefix pays the COLUMN GATHER of ``extend_tail`` — O(nnz moved) for
    CSR, O(dense words) for bitplane — never a matmul."""
    if not step.structured:
        return compose_cost_pair(prefix, step, "auto")
    if prefix.structured:
        return structured_cost(prefix, step)
    if pick_backend(prefix.density) == "csr":
        moved = prefix.nnz * (step.nnz / max(step.rows, 1))
        return _ACTIVE.c_spmm_overhead + _ACTIVE.c_take * (moved + step.cols)
    words = prefix.rows * (max((prefix.cols + 31) // 32, 1)
                           + max((step.cols + 31) // 32, 1))
    return _ACTIVE.c_word_op * words


def extend_vs_recompose(prefix: RelStats, tail: Sequence[RelStats],
                        backend: str = "auto") -> Dict[str, object]:
    """Gate the hop-cache's streaming maintenance: when ops land on a warm
    composed ``prefix``, is it cheaper to EXTEND it step by step (the
    closed-form tail extension, left-to-right) or to RECOMPOSE — fold the
    ``tail`` by the nnz-aware chain DP in its own best order, then apply it
    to the prefix with one compose?

    Extension wins almost always for the structured tails streaming capture
    produces (each step is a take / column gather).  Recompose wins when
    the tail is DENSE and strongly row-reducing: folding a heavy tail first
    (where the DP is free to pick the cheap order) makes the single
    prefix-apply touch far fewer columns than dragging the full-width
    prefix through every hop.  Returns ``{"strategy", "extend_ns",
    "recompose_ns", "tail_order", "est"}``; a single-step tail is always
    "extend" (the two plans are the same plan).
    """
    tail = list(tail)
    if not tail:
        return {"strategy": "extend", "extend_ns": 0.0, "recompose_ns": 0.0,
                "tail_order": [], "est": prefix}
    extend_ns = 0.0
    acc = prefix
    for step in tail:
        extend_ns += extend_tail_cost(acc, step)
        acc = compose_est(acc, step)
    if len(tail) == 1:
        return {"strategy": "extend", "extend_ns": extend_ns,
                "recompose_ns": extend_ns, "tail_order": [], "est": acc}
    tail_order, tail_ns, folded = _chain_dp(tail, backend)
    # the final prefix-apply goes through the same closed forms the executor
    # uses: a structured folded tail is ONE column gather, not a matmul
    recompose_ns = tail_ns + extend_tail_cost(prefix, folded)
    strategy = "extend" if extend_ns <= recompose_ns else "recompose"
    return {"strategy": strategy, "extend_ns": extend_ns,
            "recompose_ns": recompose_ns, "tail_order": tail_order,
            "est": acc}


def relation_probe_cost(rel: Optional[RelStats], n_probes: int,
                        probe_rows: float = 1.0) -> float:
    """One batched probe of a composed relation: mask stacks in and out,
    plus the selected-row gather.  (:meth:`CostModel.probe_cost` and the
    federated cross-route gate share this one pricing.)"""
    if rel is None:
        return _ACTIVE.c_probe_overhead
    return (_ACTIVE.c_probe_overhead
            + _ACTIVE.c_mask_elem * n_probes * (rel.rows + rel.cols)
            + _ACTIVE.c_gather * n_probes * max(probe_rows, 1.0) * rel.out_degree)


def cross_route_choose(route_stats: Sequence[Optional[RelStats]],
                       member_compose_ns: float,
                       n_probes: int,
                       demand: int,
                       budget_bytes: Optional[int] = None) -> Dict[str, object]:
    """Segment-at-a-time vs stitched-relation execution for one federated
    route — the cost-model gate that replaces the blind ``cross_min_demand``
    constant.

    ``route_stats`` holds oriented :class:`RelStats` for every hop of the
    route in traversal order: each member's composed relation AND each
    link's alignment matrix (rows = traversal-from dimension).  Costs:

    * **segments** — every probe batch pays one composed-relation probe per
      member hop plus one mask stitch per link hop, forever;
    * **stitched** — one-time composition (each member's relation compose,
      ``member_compose_ns``, plus the sparse-matmul chain folding the hops
      into ONE relation) amortized over the route's cumulative probe
      ``demand``, then one probe of the stitched relation per batch.

    A stitched relation estimated not to fit ``budget_bytes`` is never
    retained, so its composition cost cannot amortize — the gate then keeps
    segment execution (mirroring :meth:`CostModel.choose`'s budget guard).
    Any ``None`` in ``route_stats`` (a member that cannot price its
    relation) falls back to the legacy demand floor
    :data:`CROSS_FALLBACK_MIN_DEMAND`.
    """
    if not route_stats or any(s is None for s in route_stats):
        compose = demand >= CROSS_FALLBACK_MIN_DEMAND
        return {"strategy": "stitched" if compose else "segments",
                "estimated": False, "demand": demand,
                "segments_ns": 0.0, "stitched_ns": 0.0, "compose_ns": 0.0,
                "retainable": True, "est": None}
    segments_ns = 0.0
    folded: Optional[RelStats] = None
    chain_ns = 0.0
    for s in route_stats:
        # links price as one stitch of the live mask stack; member hops as a
        # composed-relation probe (what segment execution actually runs)
        if s.structured:
            segments_ns += _ACTIVE.c_stitch_overhead + _ACTIVE.c_mask_elem * n_probes * (
                s.rows + s.cols)
        else:
            segments_ns += relation_probe_cost(s, n_probes)
        if folded is None:
            folded = s
        else:
            chain_ns += spmm_cost(folded, s)
            folded = compose_est(folded, s)
    compose_ns = member_compose_ns + chain_ns
    retainable = budget_bytes is None or folded.est_bytes() <= budget_bytes
    stitched_ns = (relation_probe_cost(folded, n_probes)
                   + compose_ns * (n_probes / max(demand, 1)))
    strategy = ("stitched"
                if retainable and stitched_ns < segments_ns else "segments")
    return {"strategy": strategy, "estimated": True, "demand": demand,
            "segments_ns": segments_ns, "stitched_ns": stitched_ns,
            "compose_ns": compose_ns, "retainable": retainable, "est": folded}


# ---------------------------------------------------------------------------
# The planner model
# ---------------------------------------------------------------------------
class CostModel:
    """Walk-vs-compose cost estimates over one :class:`ProvenanceIndex`.

    Chains are append-only (one producer per dataset), so per-pair chain
    statistics are computed once and cached forever.  ``choose`` additionally
    tracks cumulative probe *demand* per pair: the one-time composition cost
    is amortized over the probes seen so far, so a stream of tiny probes to
    one far pair flips from walking to composing once enough demand
    accumulates, where a batch-size threshold would walk it forever.
    """

    def __init__(self, index) -> None:
        self.index = index
        self._chains: Dict[Tuple[str, str], Optional[List[RelStats]]] = {}
        self._composed: Dict[Tuple[str, str],
                             Tuple[Optional[RelStats], float]] = {}
        self._demand: Dict[Tuple[str, str], int] = {}

    # -- chain statistics ----------------------------------------------------
    def chain_stats(self, src: str, dst: str) -> Optional[List[RelStats]]:
        """Per-op relation stats along the ``src`` → ``dst`` DAG region, in
        topological order; ``None`` when no dataflow path exists.  Multi-input
        ops aggregate their on-path slots (nnz sums; rows sum — the walk
        frontier spans every contributing input)."""
        key = (src, dst)
        if key in self._chains:
            return self._chains[key]
        if src == dst:
            self._chains[key] = []
            return []
        up_ids = {op.op_id for op in self.index.upstream_ops(dst)}
        reach = {src}
        chain: List[RelStats] = []
        found = False
        for op in self.index.downstream_ops(src):
            if op.op_id not in up_ids:
                continue
            slots = [k for k, d in enumerate(op.input_ids) if d in reach]
            if not slots:
                continue
            reach.add(op.output_id)
            per = [RelStats.from_slot(op.tensor, k) for k in slots]
            chain.append(RelStats(
                rows=sum(s.rows for s in per),
                cols=int(op.tensor.n_out),
                nnz=sum(s.nnz for s in per),
            ))
            if op.output_id == dst:
                found = True
        result = chain if found else None
        self._chains[key] = result
        return result

    # -- cost terms ----------------------------------------------------------
    def walk_cost(self, chain: List[RelStats], n_probes: int,
                  probe_rows: float) -> float:
        """Hops × batched-gather.  Per hop: one python dispatch, a scan over
        the full (B, n_out) mask stack (``neighbor_mask_many`` allocates and
        scatters it whole — the dominant term for large batches), and a
        gather proportional to (batch × frontier × out-degree); the frontier
        grows multiplicatively along the chain, clamped by each dataset
        size."""
        frontier = max(probe_rows, 1.0)
        cost = 0.0
        for s in chain:
            cost += (_ACTIVE.c_hop_overhead
                     + _ACTIVE.c_mask_elem * n_probes * s.cols
                     + _ACTIVE.c_gather * n_probes * frontier * s.out_degree)
            frontier = min(float(s.cols), frontier * max(s.out_degree, 1e-9))
            frontier = max(frontier, 1.0)
        return cost

    def composed_estimate(self, src: str, dst: str
                          ) -> Tuple[Optional[RelStats], float]:
        """(estimated composed ``src`` → ``dst`` relation stats, estimated
        one-time composition cost), accumulated over the op DAG exactly the
        way :class:`~repro_torch.core.hopcache.ComposedIndex` composes it:
        compose along each edge, UNION sibling-branch contributions at
        multi-input ops.  Linearizing parallel branches into one chain would
        multiply stats of relations whose dims don't even touch.  Cached per
        pair (append-only DAG).  ``(None, 0.0)`` when no path."""
        key = (src, dst)
        cached = self._composed.get(key)
        if cached is not None:
            return cached
        up_ids = {op.op_id for op in self.index.upstream_ops(dst)}
        rels: Dict[str, Optional[RelStats]] = {src: None}  # None = identity
        cost = 0.0
        for op in self.index.downstream_ops(src):
            if op.op_id not in up_ids:
                continue
            acc: Optional[RelStats] = None
            for k, in_id in enumerate(op.input_ids):
                if in_id not in rels:
                    continue
                step = RelStats.from_slot(op.tensor, k)
                prefix = rels[in_id]
                if prefix is None:
                    contrib = step   # the op's own relation: no compose work
                else:
                    cost += compose_cost_pair(prefix, step, "auto")
                    contrib = compose_est(prefix, step)
                acc = contrib if acc is None else union_est(acc, contrib)
            if acc is not None:
                rels[op.output_id] = acc
        rel = rels.get(dst)
        result = (rel, cost) if rel is not None else (None, 0.0)
        self._composed[key] = result
        return result

    def probe_cost(self, rel: Optional[RelStats], n_probes: int,
                   probe_rows: float) -> float:
        """One batched probe of the composed relation (see
        :func:`relation_probe_cost`)."""
        return relation_probe_cost(rel, n_probes, probe_rows)

    # -- the decision ---------------------------------------------------------
    def choose(self, src: str, dst: str, n_probes: int,
               probe_rows: float = 1.0, note: bool = True,
               budget_bytes: Optional[int] = None) -> Dict[str, object]:
        """Walk or compose-then-probe for one plan against pair (src, dst).

        Returns ``{"strategy", "walk_ns", "hopcache_ns", "compose_ns",
        "demand", "retainable"}``.  ``note=False`` (EXPLAIN) leaves demand
        untouched.  ``budget_bytes`` is the hop-cache's byte budget: a
        composed relation estimated NOT to fit is served uncached and
        recomposed on EVERY probe, so its composition cost is charged per
        plan instead of amortized over demand — without this check a
        too-small cache would flip to "hopcache" on accumulated demand and
        then recompose the whole chain per query, forever.
        """
        chain = self.chain_stats(src, dst)
        if chain is None or not chain:
            return {"strategy": "walk", "walk_ns": 0.0, "hopcache_ns": 0.0,
                    "compose_ns": 0.0, "demand": 0, "retainable": True,
                    "structured": False}
        pair = (src, dst)
        demand = self._demand.get(pair, 0) + n_probes
        if note:
            self._demand[pair] = demand
        walk = self.walk_cost(chain, n_probes, probe_rows)
        rel, compose = self.composed_estimate(src, dst)
        probe = self.probe_cost(rel, n_probes, probe_rows)
        retainable = (budget_bytes is None or rel is None
                      or rel.est_bytes() <= budget_bytes)
        # amortize the one-time compose over the demand observed so far —
        # but an unretainable relation is recomposed per plan: no amortization
        amortize = max(demand, 1) if retainable else max(n_probes, 1)
        hopcache = probe + compose * (n_probes / amortize)
        return {
            "strategy": "hopcache" if hopcache < walk else "walk",
            "walk_ns": walk,
            "hopcache_ns": hopcache,
            "compose_ns": compose,
            "demand": demand,
            "retainable": retainable,
            "structured": bool(rel is not None and rel.structured),
        }
