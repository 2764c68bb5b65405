#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card, ``nvcc`` and
PyTorch built for CUDA.  It

1. prints the environment and requires compute capability (9, 0);
2. builds every kernel from ``src/repro_torch/csrc`` (into ``build/``);
3. holds each kernel against its plain PyTorch version on the card,
   exactly (integer words, ranks, tables and counts: tolerance 0), over
   synthetic sweeps: ``batched_walk`` over hop counts (1 to 64), batch
   sizes, widths and densities, with row lists past their capacity
   (density 0.5 at 7214 and 32561 rows) and every probe block (B not a
   multiple of it); ``bitmatmul`` with K off a word boundary, bits of A
   past K, empty rows, densities 0 to 0.5, every slice width of its grid
   (M = 64 on the 2-D grid, ragged last slices) and ragged last A tiles
   at the Compas and Census composition shapes, and the attribute walk's
   shapes (A 64 x 1-4 words, B 1-104 rows x 1-4 words); ``bitset_rank`` and
   ``lineage_gather`` with Q = 1..257, degree 0 and ``max_deg`` above every
   degree, and at the redesigned kernels' edges: W at 0, 1, one and five
   tiles of 8192 words +- 1 and about 600 tiles, words 4 bytes past a
   16-byte boundary, positions at tile and line edges and past the set,
   all queries in one tile, 70,000 queries, Q = 0; ``max_deg`` 1 to 5, 8,
   33 and 130 with degree-0 rows, rows longer than ``max_deg``, queries
   outside [0, R), and Q from 1 to 100,003;
4. drives the record-level main path on the card: capture of the German,
   Compas and Census use cases at their Table VIII sizes and of a TPC-DI
   join at scale factor 20 followed by a filter, then B = 64 Q1 and Q2
   probes through ``prov(index)...run()`` on a walk session
   (``use_hopcache=False``, the fused kernel on), Q5/Q6 on German and
   Q9-Q11 on Compas.  Launch counts are zeroed just before and read just
   after; German and Compas must launch the fused kernel twice each.  Every
   answer must equal the per-op walk on the card, and German, Compas and a
   scale-factor-3 join must also equal the port run on the CPU;
5. drives the default route, the composed hop-cache (``QuerySession()``,
   backend ``"auto"``): the same Q1/Q2 on all four configurations and
   Q10/Q11 on Compas, with ``explain()`` and ``stats()``; answers equal the
   walk and, where the CPU ran, the CPU;
6. drives the hop-cache in its ``"bitplane"`` backend on German, Compas and
   Census, where every composition and every probe is a ``bitmatmul``
   launch: for a linear chain of K ops, K - 1 compositions on the first
   query and one launch per batched probe, asserted exactly; then holds the
   kernel against its plain version on the real Compas and Census
   compositions;
7. runs the per-hop baseline ``batched_walk_unfused`` against the fused
   walk on the Compas and Census Q1 and Q2 chains: byte-equal, in K x 3
   launches (``bitmatmul``, ``bitset_rank``, ``lineage_gather``) against
   1, each hop's rank and gather equal to their plain versions; then
   (``attribute``) Q3/Q4 with B = 64 probes of 8 rows and 4 attributes on
   all four configurations and Q7/Q8 on German and Compas: every attribute
   hop's ``bitmatmul`` output equals its plain version, cell rows lie in
   the record answers, and cells, hop traces and launch counts equal the
   CPU run's (German, Compas, Census, a scale-factor-3 join); then
   (``spill_hopcache``) a bitplane hop-cache with a budget of 1.5
   relations on Compas and Census, every (source, dataset) pair probed
   twice: answers equal the unbounded hop-cache's, Compas's counters the
   CPU run's; then (``spill_tensors``) ``ProvenanceIndex(spill=)`` with a
   quarter of the index's bytes on Compas, Census and the TPC-DI join:
   Q1/Q2 on the walk, the fused walk and the default session equal the
   unspilled index's, and the capture leaves less device memory allocated
   (``memory_allocated`` and the allocator's requested bytes) by at least
   the spilled payload; spill stores live under the ignored
   ``build/spill_smoke/`` and are removed after each check; then
   (``federation``) Compas and Census captured again split after their
   second op into a ``prep`` and a ``serve`` index joined by an identity
   link, the TPC-DI SF20 join split from its filter, and a 100,000-row
   diamond whose two branches cross on two links: Q1/Q2 (B = 64), Q3/Q4
   and Q6/Q7 through ``prov(catalog)`` as member segments (Compas's
   members on the fused walk, Census's on warm bitplane hop-caches) equal
   the merged index's answers, and on Compas the CPU run's answers and
   launch counts; one hot route per catalog flips to its stitched relation
   under the default cost gate and answers as the segments did, which a
   zero byte budget never stitches; then (``impact``) ``erasure_plan`` over
   a 9-op chain of 50,000 rows equals the union of per-row queries, a
   federated erasure on split Census equals the merged index's plan and
   ``apply_invalidations`` drops its stitched relation and spilled
   hop-cache payload once, and ``whatif_replay`` of 8 rows over a
   100,000-row pipeline equals the full re-run (rtol = atol = 1e-5) and
   leaves the recorded tables bit-identical; then (``chapman``) German,
   Compas, Census and the TPC-DI join at scale factors 3, 5 and 9, each
   captured once into an index and a ``ChapmanIndex`` through the record
   hook: the Chapman records equal the CPU run's byte for byte on German,
   Compas and SF3, 64 scans each way equal the index's Q1/Q2, and the
   bytes of both stores (Table IX), the capture's device bytes, capture
   seconds and scan against query ms are printed; then (``serving_tier``)
   8 client threads submit 512 mixed single-probe Q1/Q2/Q4 plans through
   a ``ServingTier`` over the Compas and Census walk sessions, Census's
   bitplane hop-cache and the federated Compas catalog, at (max_batch,
   max_wait_ms) (1, 0) and (64, 2): every answer equals ``session.run``'s,
   the Compas tier's ``batched_walk`` launches equal its ``run_many``
   lists replayed and, fused, are fewer than the per-request loop's; a
   ``BoundaryHandle`` tenant is denied an out-of-scope plan and a full
   queue sheds, then recovers; p50/p99 latency and requests per second
   against the per-request loop are printed; then (``sharded``) Compas,
   Census and TPC-DI SF20 viewed as ``ShardedProvenanceIndex`` at 2, 4 and
   8 shards: B = 64 Q1/Q2 on the view's walk and default sessions and its
   ``ShardedComposedIndex`` equal the merged index's, and Census's catalog
   of shard members at 2 shards answers so cold and on its stitched route;
   then (``lm_serving``) the LM serving path at full published width, the
   weights random from the seed: OLMo-1B in float32, whose token-by-token
   ``decode_step`` equals ``forward`` over 32 tokens (relative error under
   2e-3), and the olmo and gemma3-1b smokes, whose float32 logits equal
   the CPU port's (1e-4) with equal greedy tokens; then OLMo-1B in bf16
   behind a ``ServeEngine`` whose upstream is a Compas prep index captured
   on the card (its session on the fused walk): 64 prompts of 32 tokens
   and 16 new tokens, recorded; the responses' lineage to the raw source
   equals the prep walk's Q2 of each request's sink row and launches
   ``batched_walk``, the erasure of 4 raw rows reaches exactly the
   responses whose requests their Q1 reaches, and 512 single probes
   through a ``ServingTier`` from 8 threads equal ``response_lineage``;
   decode ms a step (median of the synchronised steps), tokens/s, the
   weight-byte bound, the prompt pass, peak memory and the tier's p50/p99
   are printed; then gemma3-1b in bf16 over 1,056 positions, where the
   local layers' 1,024-slot ring buffer wraps: the last 16 decode logits
   equal ``forward``'s (relative error under 5e-2); then (``lm_families``)
   the other families at full published width: mamba2-370m in float32,
   whose decode equals ``forward`` over (2, 512) tokens (two chunks) and a
   256-token prefill handed to decode the next 256, then in bf16 behind an
   engine over a fresh Compas prep index, lineage and erasure checked as
   OLMo-1B's; whisper-small, whose decode after ``encode_into_cache``
   equals ``forward`` over 1,500 frames in float32, then in bf16 at B = 16
   with frames; qwen3-moe-235b-a22b at full width cut to 2 layers, whose
   float32 ``moe_forward`` equals a plain loop over its 128 experts where
   choices drop (asserted) and where none can, and whose decode equals
   forward, then in bf16 at B = 64; ms a step against bounds that count
   the recurrent state (mamba2) and the cross K/V (whisper), idle share and
   peak memory; and the mamba2, jamba, qwen3-moe, dbrx and whisper smokes
   on the card against the CPU;
   then (``train``) one float32 ``train_step`` (``n_micro`` 2) of the
   olmo, gemma3-1b, mamba2, qwen3-moe and whisper smokes on the card
   against the CPU port (loss, grad norm, updated params and moments,
   1e-4), and OLMo-1B at full width trained at seq 4,096 and global batch
   8 (train_4k's 256, cut; float32 master weights, bf16 activations and
   moments, remat, ``n_micro`` 2) on batches from a ``TokenPipeline`` over
   a 20,000-document corpus on the card: ms a step, tokens/s, the model
   FLOPs (``FlopCounterMode``) against the bf16 peak, peak memory and the
   profiler's idle share; under deterministic algorithms an 8-step
   ``run_training`` with async checkpoints whose loss falls, its full
   state restored bit for bit, and a run crashed at step 6 and resumed
   from step 4 that ends on the same state bit for bit; every step's
   batch lineage (Q2) on the fused walk equals the default session's,
   4 documents' Q1 equals the inverse of those answers, and the consent
   audit flags exactly the non-consenting contributors;
   then (``mesh``) the mesh layer: at world size 1 on NCCL, Census's
   32,561 x 32,561 relation split at its first op and composed with
   ``compose_sharded`` (the local product a ``bitmatmul`` launch) equals
   ``bitmatmul`` of the whole and ``dataset_lineage``, its audit by the
   "a0" groups and its frontier equal a plain count on the card and the
   CPU port's, the collective engine at one shard answers B = 64 Q1/Q2
   on Compas, Census and SF20 as the merged index does, and OLMo-1B's
   train_4k-cut step on a (1, 1) ("data", "model") mesh, the state placed
   by ``state_pspecs``, equals the plain step bit for bit under
   deterministic algorithms, its state saved and restored with
   ``shardings=`` bit for bit; then 4 spawned ranks share the card over
   gloo with CUDA tensors: the engine at 4 shards equals the merged index
   and the sequential engine, Census's results equal world size 1's, and
   the qwen3-moe smoke's sharded step (4 MoE groups, on each rank's CPU)
   the plain one; compose, audit, Q1/Q2, step and restore ms printed;
   then (``dryrun``) the dry-run accounting: OLMo-1B's train_4k cell cut
   to global batch 8 on a (1, 1) mesh over a fake process group, whose
   argument bytes equal the card's state and batch exactly, whose dot
   FLOPs equal ``train_step_flops`` with remat off and on, and whose predicted peak is within 20% of the card's over real
   steps, its bound beside the measured ms a step; ``run_cell`` on
   OLMo-1B's four shapes on 256 fake ranks and llama3-405b's train_4k on
   512 (status, memory, FLOPs, collective bytes, bound), and ``perf``'s
   ``lowmem`` below ``base`` in temp; then (``examples``) the seven
   examples of ``examples/torch`` on the card through their ``main``, each
   printing its landmarks, ``batched_walk`` and ``bitmatmul`` launched;
8. calibrates the cost model on the card (quick grid, into a file under
   ``build/``) and prints the fitted constants, which are not installed;
9. times every kernel at the main path's shapes beside its plain version,
   its bound and, where one exists, a one-call PyTorch yardstick: device
   time (``device_ms``: the calls queued behind a device spin, so the CUDA
   events bracket device work, not the Python launch rate) and, beside
   it, the host-paced time of back-to-back calls (``event_ms``); the walk
   and the probe at 1, 8 and 64 rows per probe and a Census walk;
   ``bitset_rank`` and ``lineage_gather`` on the first hop of the Compas
   and Census Q2 baselines and at TPC-DI SF20 (the rank over the 64-probe
   Q2 frontier at the join's 2,411,006-row input, the gather of every row
   of the join's out -> in CSR), the SF20 inputs held to the plain
   versions and timed cold, rotating among copies that exceed the L2; then
   end-to-end latencies of the walk, the default hop-cache and the
   bitplane hop-cache.

Every phase prints one JSON line.  Any failure raises and the exit code is
not 0.  The last three lines are the kernel table (with each kernel's
launches per path), the card's name and power limit as ``nvidia-smi``
gives them, and ``{"ok": true, ...}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

# the train phase runs under torch.use_deterministic_algorithms(True), which
# needs cuBLAS's workspace fixed before cuBLAS first runs
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
# 32-bit AND/OR/XOR: 64 results per clock per SM, popc: 16, for compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput table), x 132 SMs x 1.98 GHz boost clock of the H100 SXM
INT_OPS_PER_S = 132 * 64 * 1.98e9
POPC_PER_S = 132 * 16 * 1.98e9
SPIN_CYCLES_PER_S = 1.98e9   # torch.cuda._sleep counts SM clocks; a first guess, doubled as needed
SEED = 1234
B = 64
DEV = torch.device("cuda", 0)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sync_time(fn, *args, **kw):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def event_ms(fn, reps: int = 50, rounds: int = 7, warmup: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def device_ms(fn, reps: int = 50, rounds: int = 7, warmup: int = 5) -> float:
    """Median over ``rounds`` of the mean DEVICE time of ``reps``
    back-to-back calls.  Each round queues a device spin
    (``torch.cuda._sleep``) before its start event, long enough that the
    host has enqueued every call before the spin ends: the events then
    bracket device work only, never the Python launch rate.  The spin
    doubles until it outlasts the enqueue; a round it does not cover is
    timed again.  ``fn`` must neither synchronise nor fill the launch
    queue (keep ``reps`` low for a function of many operations), or the
    spin never covers it and this raises."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t
    torch.cuda.synchronize()
    cycles = int(max(2.0 * enqueue_s, 2e-4) * SPIN_CYCLES_PER_S)
    times = []
    tries = 0
    while len(times) < rounds:
        spin = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        spin.record()
        torch.cuda._sleep(cycles)
        start.record()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        stop.record()
        host_s = time.perf_counter() - t
        stop.synchronize()
        if spin.elapsed_time(start) > 1.2 * host_s * 1e3:
            times.append(start.elapsed_time(stop) / reps)
        else:
            cycles *= 2
            tries += 1
            if tries > 8:
                raise RuntimeError("the spin never covered the enqueue: the function "
                                   "synchronises or fills the launch queue")
    return statistics.median(times)


def host_ms(fn, reps: int = 7) -> float:
    fn()
    times = []
    for _ in range(reps):
        _, dt = sync_time(fn)
        times.append(dt * 1e3)
    return statistics.median(times)


def word_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over 32-bit words read as unsigned, 0 iff equal."""
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    ua = a.to(torch.int64) & 0xFFFFFFFF
    ub = b.to(torch.int64) & 0xFFFFFFFF
    return int((ua - ub).abs().max())


def cells_subset_of_records(cells, records) -> bool:
    """Every probe's cell rows lie in its record-level answer."""
    return all(bool(torch.isin(c[:, 0], r).all()) for c, r in zip(cells, records))


def attr_probe_sets(rng, n_cols: int, k: int = 4):
    """B probes of ``k`` distinct attributes each."""
    return [sorted(rng.choice(n_cols, size=min(k, n_cols), replace=False).tolist())
            for _ in range(B)]


def attribute_queries(idx, src, sink, q, how: bool):
    """Q3 (forward cells) and Q4 (backward cells) of one configuration,
    through the index's default session; with ``how`` also Q7/Q8."""
    from repro_torch.provenance import prov

    out = {
        "q3": prov(idx).source(src).rows_batch(q["q1"]).attrs_batch(q["a_src"])
        .forward().to(sink).run(),
        "q4": prov(idx).source(sink).rows_batch(q["q2"]).attrs_batch(q["a_sink"])
        .backward().to(src).run(),
    }
    if how:
        out["q7"] = prov(idx).source(src).rows_batch(q["q1"][:8]).attrs_batch(q["a_src"][:8]) \
            .forward().to(sink).how().run()
        out["q8"] = prov(idx).source(sink).rows_batch(q["q2"][:8]).attrs_batch(q["a_sink"][:8]) \
            .backward().to(src).how().run()
    return out


def same_attr_answers(got, want, what: str) -> None:
    """Cells and hop traces (aligned by op position) of two runs agree."""
    check(sorted(got) == sorted(want), f"{what}: query sets differ")
    for key in got:
        check(len(got[key]) == len(want[key]), f"{what} {key}: batch size")
        for g, w in zip(got[key], want[key]):
            if isinstance(g, tuple):
                (g, gh), (w, wh) = g, w
                check([(h.op_id, h.op_name, h.category, h.n_records) for h in gh]
                      == [(h.op_id, h.op_name, h.category, h.n_records) for h in wh],
                      f"{what} {key}: hop traces differ")
            check(torch.equal(g.cpu(), w.cpu()), f"{what} {key}: cells differ")


def fresh_store(name: str) -> Path:
    """An empty spill directory under the ignored ``build/``."""
    import shutil

    root = ROOT / "build" / "spill_smoke" / name
    shutil.rmtree(root, ignore_errors=True)
    return root


def spill_hopcache_run(idx, src, budget, src_mask, op_masks, name):
    """A bitplane hop-cache with a spill tier over the linear chain ``idx``:
    every (source, dataset) pair probed forward (``src_mask``) and backward
    (``op_masks[k]`` at op k's output), twice.  Returns the hop-cache, its
    spill policy and the answers in probe order."""
    from repro_torch.core.hopcache import ComposedIndex
    from repro_torch.core.spill import SpillPolicy

    policy = SpillPolicy(path=str(fresh_store(name)))
    ci = ComposedIndex(idx, memory_budget_bytes=budget, backend="bitplane", spill=policy)
    out = []
    for _ in range(2):
        for op, mask in zip(idx.ops, op_masks):
            d = op.output_id
            out.append((ci.probe_forward(src_mask, src, d), ci.probe_backward(mask, d, src)))
    return ci, policy, out


def device_bytes(device) -> tuple:
    """(``memory_allocated``, requested bytes) on ``device``.  The caching
    allocator counts a block in ``memory_allocated`` at its size, which can
    exceed the request by up to a cached block's remainder; its requested
    bytes are what the live tensors asked for, exactly."""
    return (torch.cuda.memory_allocated(device),
            torch.cuda.memory_stats(device)["requested_bytes.all.current"])


def capture_delta(make, device, spill=None):
    """Capture one configuration into a fresh index: (index, source, sink,
    the capture's ``device_bytes`` delta).  The allocator's unused cached
    blocks are released first, so that two captures measured one after the
    other (the first one freed in between) start from the same allocator
    state: ``memory_allocated`` counts a block at its size, and a request
    served from another cached block would round differently."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = device_bytes(device)
    idx, src, sink = make(device, spill)
    gc.collect()
    torch.cuda.synchronize()
    after = device_bytes(device)
    return idx, src, sink, (after[0] - before[0], after[1] - before[1])


# -- bitset_rank and lineage_gather (phases 3, 7 and 9) ------------------------
def rank_edge_positions(w: int, device) -> torch.Tensor:
    """Positions at the rank kernel's tile and line starts and ends, at the
    ends of a W-word set and past it, and below 0."""
    from repro_torch.kernels.bitset_rank import LINE_WORDS, TILE_WORDS

    n = 32 * w
    pts = {-5, -1, 0, 1, 31, 32, n - 1, n, n + 77}
    for t in range(-(-w // TILE_WORDS) + 1):
        pts |= {32 * t * TILE_WORDS + d for d in (-33, -32, -1, 0, 1, 32)}
    for line in (1, 2, 255, 256, 257):
        pts |= {32 * LINE_WORDS * line - 1, 32 * LINE_WORDS * line}
    return torch.tensor(sorted(p for p in pts if p < n + 100), dtype=torch.int32, device=device)


def rank_sweep(rank_fn, gen, device):
    """``rank_fn`` against ``ref.bitset_rank_ref``, tolerance 0, at the
    redesigned kernel's edges: W at 0, 1, one and five tiles +- 1 and about
    600 tiles; positions at tile and line edges and past the set; 500
    queries in one tile; 70,000 queries (274 answer CTAs, more than the
    tiles); the words at a 16-byte boundary and 4 bytes past one (the
    kernels' scalar loads); and Q = 0.  Returns (cases, max error, the
    geometries run)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitset_rank import TILE_WORDS, rank_geometry

    def positions(lo, hi, q):
        return torch.randint(lo, hi, (q,), generator=gen, device=device,
                             dtype=torch.int64).to(torch.int32)

    cases, err, geometries = 0, 0, set()
    for w in (0, 1, TILE_WORDS - 1, TILE_WORDS, TILE_WORDS + 1, 5 * TILE_WORDS - 1,
              5 * TILE_WORDS + 1, 600 * TILE_WORDS + 17):
        for offset in (0, 1):
            buf = torch.randint(-(1 << 31), (1 << 31) - 1, (w + offset,), generator=gen,
                                device=device, dtype=torch.int64).to(torch.int32)
            buf[torch.rand(w + offset, generator=gen, device=device) < 0.2] = -1   # full words
            words = buf[offset:]
            sets = [rank_edge_positions(w, device), positions(-3, 32 * w + 40, 70_000)]
            if w > 2 * TILE_WORDS:
                sets.append(positions(32 * TILE_WORDS, 64 * TILE_WORDS, 500))
            for pos in sets:
                e = int((rank_fn(words, pos) - ref.bitset_rank_ref(words, pos)).abs().max())
                check(e == 0, f"bitset_rank != plain at W={w} offset={offset} Q={pos.numel()}")
                err = max(err, e)
                cases += 1
                geometries.add(rank_geometry(w, pos.numel()))
    check(rank_fn(words, positions(0, 1, 0)).numel() == 0, "bitset_rank at Q = 0")
    return cases + 1, err, geometries


def gather_sweep(gather_fn, gen, device):
    """``gather_fn`` against ``ref.lineage_gather_ref``, tolerance 0, at the
    redesigned kernel's edges: max_deg 1 to 5, 8, 33 and 130 (a thread's
    four words inside a row, across rows and across CTAs), degree-0 rows,
    rows longer than max_deg, queries outside [0, R), and Q = 1, 5 and tens
    of thousands (hundreds of CTAs).  Returns (cases, max error, the
    geometries run)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lineage_gather import gather_geometry

    cases, err, geometries = 0, 0, set()
    n_rows = 5000
    for md in (1, 2, 3, 4, 5, 8, 33, 130):
        deg = torch.randint(0, 2 * md + 2, (n_rows,), generator=gen, device=device)
        deg[::5] = 0
        deg[1::7] = md + 3
        rp = torch.zeros(n_rows + 1, dtype=torch.int32, device=device)
        rp[1:] = torch.cumsum(deg, 0)
        col = torch.randint(0, 1 << 30, (int(rp[-1]),), generator=gen, device=device,
                            dtype=torch.int64).to(torch.int32)
        for q in (1, 5, 100_003 if md <= 8 else 20_011):
            qs = torch.randint(-2, n_rows + 2, (q,), generator=gen, device=device,
                               dtype=torch.int64).to(torch.int32)
            e = int((gather_fn(qs, rp, col, md)
                     - ref.lineage_gather_ref(qs, rp, col, max_deg=md)).abs().max())
            check(e == 0, f"lineage_gather != plain at max_deg={md} Q={q}")
            err = max(err, e)
            cases += 1
            geometries.add(gather_geometry(q, md))
    return cases, err, geometries


def hop_inputs(mask, planes, device):
    """Each hop's rank and gather inputs in the per-hop baseline, built as
    ``ops.batched_walk_unfused`` builds them but from the plain versions'
    frontiers, with the table the gather must give (the frontier's set
    bits, in order)."""
    from repro_torch.kernels import ref

    b = mask.shape[0]
    cur = mask
    for plane in planes:
        cur = ref.bitmatmul_ref(cur, plane)
        fw = cur.shape[1]
        flat = cur.reshape(-1)
        ends = torch.arange(1, b + 1, dtype=torch.int32, device=device) * (fw * 32) - 1
        counts = torch.diff(ref.bitset_rank_ref(flat, ends),
                            prepend=torch.zeros(1, dtype=torch.int32, device=device))
        rp = torch.zeros(b + 1, dtype=torch.int32, device=device)
        rp[1:] = torch.cumsum(counts, 0)
        rows, col = torch.nonzero(ref.unpack_bits(cur, fw * 32), as_tuple=True)
        md = max(int(counts.max()), 1)
        table = torch.full((b, md), -1, dtype=torch.int32, device=device)
        table[rows, torch.arange(rows.numel(), device=device) - rp[rows].to(torch.int64)] = \
            col.to(torch.int32)
        yield {"flat": flat, "ends": ends, "rp": rp, "col": col.to(torch.int32),
               "md": md, "table": table}


def per_hop_baseline(name, chains, device, rank_fn, gather_fn):
    """The per-hop baseline against the fused walk on one configuration's
    Q1 and Q2 chains (``chains``: {"q1"/"q2": (packed mask, planes)}):
    byte-equal answers in 3 launches a hop against 1, then ``rank_fn`` and
    ``gather_fn`` on the inputs of every hop of both chains against their
    plain versions (tolerance 0) and each table against its frontier.
    Returns (unfused counts, fused counts, per-hop inputs, rank error,
    gather error)."""
    from repro_torch.kernels import ops, ref

    hops = sum(len(planes) for _, planes in chains.values())
    ops.reset_launch_counts()
    unfused = {q: ops.batched_walk_unfused(mask, planes) for q, (mask, planes) in chains.items()}
    torch.cuda.synchronize()
    unfused_counts = ops.launch_counts()
    check(unfused_counts == {"bitmatmul": hops, "bitset_rank": hops, "lineage_gather": hops},
          f"{name} unfused launches {unfused_counts}, expected 3 a hop over {hops} hops")
    ops.reset_launch_counts()
    fused = {q: ops.batched_walk(mask, planes) for q, (mask, planes) in chains.items()}
    torch.cuda.synchronize()
    fused_counts = ops.launch_counts()
    check(fused_counts == {"batched_walk": len(chains)},
          f"{name} fused launches {fused_counts}, expected 1 per chain")
    for q in chains:
        check(torch.equal(unfused[q][0], fused[q][0]) and torch.equal(unfused[q][1], fused[q][1]),
              f"{name} {q}: unfused != fused")
    per_hop = {q: list(hop_inputs(mask, planes, device)) for q, (mask, planes) in chains.items()}
    rank_err = gather_err = 0
    for q, hs in per_hop.items():
        for j, h in enumerate(hs):
            qs = torch.arange(h["rp"].numel() - 1, dtype=torch.int32, device=device)
            err = int((rank_fn(h["flat"], h["ends"])
                       - ref.bitset_rank_ref(h["flat"], h["ends"])).abs().max())
            check(err == 0, f"bitset_rank != plain at {name} {q} hop {j}")
            rank_err = max(rank_err, err)
            got = gather_fn(qs, h["rp"], h["col"], h["md"])
            err = int((got - ref.lineage_gather_ref(qs, h["rp"], h["col"], max_deg=h["md"]))
                      .abs().max())
            check(err == 0, f"lineage_gather != plain at {name} {q} hop {j}")
            check(torch.equal(got, h["table"]), f"lineage_gather table != frontier at {name} {q} hop {j}")
            gather_err = max(gather_err, err)
    torch.cuda.synchronize()
    return unfused_counts, fused_counts, per_hop, rank_err, gather_err


def _rotate(fn, copies):
    """A call of ``fn`` on the next of ``copies`` (argument tuples), round
    robin: with enough copies to exceed the 50 MB L2 each call meets a cold
    cache, as a caller does."""
    i = [0]

    def call():
        args = copies[i[0] % len(copies)]
        i[0] += 1
        return fn(*args)
    return call


def _bound(row, moved, ops_ms, launches):
    row.update({"bound_bytes": moved, "bytes_ms": moved / HBM_BYTES_PER_S * 1e3,
                "ops_ms": ops_ms, "launches_per_call": launches})
    row["bound_ms"] = max(row["bytes_ms"], ops_ms)
    row["bound_by"] = "bytes" if row["bytes_ms"] >= ops_ms else "operations"
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    return row


def rank_times(copies, plain_reps=5):
    """Device, host-paced and plain ms and the bound of ``bitset_rank_cuda``
    on ``copies`` ((words, positions) of one shape, rotated): every word
    read once, every position read and rank written once, one popcount a
    word and a query."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitset_rank import bitset_rank_cuda, rank_geometry

    w, q = copies[0][0].numel(), copies[0][1].numel()
    geo = rank_geometry(w, q)
    row = {"shape": {"W": w, "Q": q}, "geometry": geo._asdict(), "copies": len(copies),
           "rotated_bytes": sum(c[0].numel() * 4 for c in copies),
           "ms": device_ms(_rotate(bitset_rank_cuda, copies)),
           "host_paced_ms": event_ms(_rotate(bitset_rank_cuda, copies)),
           "plain_ms": device_ms(_rotate(ref.bitset_rank_ref, copies), reps=plain_reps),
           "library_ms": None}
    return _bound(row, (w + 2 * q) * 4, (w + q) / POPC_PER_S * 1e3, geo.launches)


def gather_times(copies, max_deg, plain_reps=5):
    """Device, host-paced and plain ms and the bound of
    ``lineage_gather_cuda`` on ``copies`` ((queries, row_ptr, col_idx) of
    one shape, rotated): queries, row pointers and the entries the table
    holds read once, the table written once."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lineage_gather import gather_geometry, lineage_gather_cuda

    qs, rp, _ = copies[0]
    q, r = qs.numel(), rp.numel() - 1
    inside = qs[(qs >= 0) & (qs < r)].to(torch.int64)
    entries = int((rp[inside + 1] - rp[inside]).clamp(max=max_deg).sum())
    row = {"shape": {"Q": q, "R": r, "nnz": copies[0][2].numel(), "max_deg": max_deg,
                     "entries": entries},
           "geometry": gather_geometry(q, max_deg)._asdict(), "copies": len(copies),
           "rotated_bytes": sum(sum(t.numel() for t in c) * 4 for c in copies),
           "ms": device_ms(_rotate(lambda a, b, c: lineage_gather_cuda(a, b, c, max_deg), copies)),
           "host_paced_ms": event_ms(
               _rotate(lambda a, b, c: lineage_gather_cuda(a, b, c, max_deg), copies)),
           "plain_ms": device_ms(_rotate(lambda a, b, c: ref.lineage_gather_ref(
               a, b, c, max_deg=max_deg), copies), reps=plain_reps),
           "library_ms": None}
    return _bound(row, (q + r + 1 + entries + q * max_deg) * 4, 0.0, 1)



def tpcdi_join(scale, device, spill=None):
    """The TPC-DI join at ``scale`` followed by a filter: (index, sink id)."""
    from repro_torch.core.pipeline import ProvenanceIndex
    from repro_torch.dataprep import usecases as U
    from repro_torch.dataprep.tracked import track

    idx = ProvenanceIndex(f"tpcdi{scale}", device=device, spill=spill)
    left, right = U.make_tpcdi_join_inputs(scale, device=device)
    lt, rt = track(left, idx, "trade"), track(right, idx, "security")
    j = lt.join(rt, on="key", how="inner")
    f = j.filter_rows(j.table.col("l0") > 0.0).mark_sink()
    return idx, f.dataset_id


# -- federation and impact (phases 7e and 7f) ----------------------------------
def split_usecase(name, cut, device):
    """Capture use case ``name`` split across a federation: ``prep`` owns
    its ops [0, cut), ``serve`` the rest over a source holding the boundary
    table, glued by an identity link.  Returns (catalog, source ref, sink
    ref, every dataset ref in op order)."""
    from repro_torch.core.pipeline import ProvenanceIndex
    from repro_torch.dataprep import usecases as U
    from repro_torch.dataprep.tracked import track
    from repro_torch.provenance import ProvCatalog
    from repro_torch.provenance.catalog import qualify

    prep = ProvenanceIndex(f"{name}_prep", device=device)
    serve = ProvenanceIndex(f"{name}_serve", device=device)
    d = track(U.USECASES[name][0](device=device), prep, f"{name}_src")
    refs = [qualify("prep", d.dataset_id)]
    for step in U.STEPS[name][:cut]:
        d = step(d)
        refs.append(qualify("prep", d.dataset_id))
    s = track(d.table, serve, "ingest")
    for step in U.STEPS[name][cut:]:
        s = step(s)
        refs.append(qualify("serve", s.dataset_id))
    s.mark_sink()
    cat = ProvCatalog(name, device=device)
    cat.register("prep", prep).register("serve", serve)
    cat.link(refs[cut], "serve/ingest")
    return cat, refs[0], refs[-1], refs


def split_join(scale, device):
    """The TPC-DI join + filter split between the join (prep) and the
    filter (serve)."""
    from repro_torch.core.pipeline import ProvenanceIndex
    from repro_torch.dataprep import usecases as U
    from repro_torch.dataprep.tracked import track
    from repro_torch.provenance import ProvCatalog
    from repro_torch.provenance.catalog import qualify

    prep = ProvenanceIndex(f"tpcdi{scale}_prep", device=device)
    serve = ProvenanceIndex(f"tpcdi{scale}_serve", device=device)
    left, right = U.make_tpcdi_join_inputs(scale, device=device)
    j = track(left, prep, "trade").join(track(right, prep, "security"), on="key", how="inner")
    s = track(j.table, serve, "ingest")
    f = s.filter_rows(s.table.col("l0") > 0.0).mark_sink()
    cat = ProvCatalog(f"tpcdi{scale}", device=device)
    cat.register("prep", prep).register("serve", serve)
    cat.link(qualify("prep", j.dataset_id), "serve/ingest")
    return cat, "prep/trade", qualify("serve", f.dataset_id), [
        "prep/trade", qualify("prep", j.dataset_id), qualify("serve", f.dataset_id)]


def diamond_worlds(n, device, seed=0):
    """``tests/pipegen.py::cross_boundary_diamond`` at ``n`` rows: a merged
    index, and the same ops split so that TWO links carry the two branches
    of one source into the serve side's join.  Returns (merged index,
    source, sink, catalog, source ref, sink ref)."""
    from repro_torch.core.pipeline import ProvenanceIndex
    from repro_torch.dataprep.table import Table
    from repro_torch.dataprep.tracked import track
    from repro_torch.provenance import ProvCatalog
    from repro_torch.provenance.catalog import qualify

    rng = np.random.default_rng(seed)
    base = {"k": np.arange(n, dtype=np.float32), "x": rng.normal(size=n).astype(np.float32)}
    keep = torch.as_tensor(rng.random(n) < 0.75, device=device)
    merged = ProvenanceIndex("diamond", device=device)
    s = track(Table.from_columns(base, device=device), merged, "src")
    j = s.filter_rows(keep).join(s.value_transform("x", "scale", factor=2.0), on="k",
                                 how="inner").mark_sink()
    prep = ProvenanceIndex("diamond_prep", device=device)
    serve = ProvenanceIndex("diamond_serve", device=device)
    ps = track(Table.from_columns(base, device=device), prep, "src")
    pa, pb = ps.filter_rows(keep), ps.value_transform("x", "scale", factor=2.0)
    sj = track(pa.table, serve, "branch_a").join(track(pb.table, serve, "branch_b"), on="k",
                                                  how="inner").mark_sink()
    cat = ProvCatalog("diamond", device=device)
    cat.register("prep", prep).register("serve", serve)
    cat.link(qualify("prep", pa.dataset_id), "serve/branch_a")
    cat.link(qualify("prep", pb.dataset_id), "serve/branch_b")
    return merged, "src", j.dataset_id, cat, "prep/src", qualify("serve", sj.dataset_id)


def lineage_queries(holder, src, sink, q, how: bool, session=None):
    """Q1/Q2 (B probes of rows), Q3/Q4 (cells) and, with ``how``, Q6
    (record how, backward) and Q7 (cells how, forward) on the first 8
    probes, over an index or a catalog."""
    from repro_torch.provenance import prov

    out = {
        "q1": prov(holder).source(src).rows_batch(q["q1"]).forward().to(sink).run(session),
        "q2": prov(holder).source(sink).rows_batch(q["q2"]).backward().to(src).run(session),
        "q3": prov(holder).source(src).rows_batch(q["q1"]).attrs_batch(q["a_src"])
        .forward().to(sink).run(session),
        "q4": prov(holder).source(sink).rows_batch(q["q2"]).attrs_batch(q["a_sink"])
        .backward().to(src).run(session),
    }
    if how:
        out["q6"] = prov(holder).source(sink).rows_batch(q["q2"][:8]).backward().to(src) \
            .how().run(session)
        out["q7"] = prov(holder).source(src).rows_batch(q["q1"][:8]).attrs_batch(q["a_src"][:8]) \
            .forward().to(sink).how().run(session)
    return out


def same_lineage(got, want, what: str) -> int:
    """Records, cells and hop traces of two runs agree; hops are compared
    by (op, category, records) with the federation's link hops left out.
    Returns the number of link hops ``got`` holds."""
    check(sorted(got) == sorted(want), f"{what}: query sets differ")
    links = 0
    for key in got:
        check(len(got[key]) == len(want[key]), f"{what} {key}: batch size")
        for g, w in zip(got[key], want[key]):
            if isinstance(g, tuple):
                (g, gh), (w, wh) = g, w
                links += sum(h.category == "link" for h in gh)
                check([(h.op_name, h.category, h.n_records) for h in gh if h.category != "link"]
                      == [(h.op_name, h.category, h.n_records) for h in wh
                          if h.category != "link"], f"{what} {key}: hop traces differ")
            check(torch.equal(g.cpu(), w.cpu()), f"{what} {key}: answers differ")
    return links


def build_whatif(src_cols, dims_cols, device, name):
    """``benchmarks/bench_impact.py::_build_whatif`` in the port: filter
    masks from a fixed rng (never from data), jitter seeds stored, so a
    re-run over a patched source is comparable to the replay."""
    from repro_torch.core.pipeline import ProvenanceIndex
    from repro_torch.dataprep.table import Table
    from repro_torch.dataprep.tracked import track

    rng = np.random.default_rng(7)
    idx = ProvenanceIndex(name, device=device)
    t = track(Table.from_columns(src_cols, device=device), idx, "src")
    dims = track(Table.from_columns(dims_cols, device=device), idx)
    t = t.value_transform("x", "scale", factor=1e-2)
    t = t.filter_rows(torch.as_tensor(rng.random(t.table.n_rows) > 0.03, device=device))
    t = t.join(dims, on="k", how="inner")
    t = t.value_transform("w", "scale", factor=2.0)
    t = t.oversample(frac=0.02, seed=5, noise=0.1)
    for i in range(5):
        t = t.value_transform("y", "scale", factor=1.0 + 0.1 * i)
    t = t.filter_rows(torch.as_tensor(rng.random(t.table.n_rows) > 0.02, device=device))
    t = t.value_transform("x", "clip", lo=-1e6, hi=1e6)
    t.mark_sink()
    return idx, t.dataset_id


def erasure_chain(n, hops, device, seed=0):
    """``benchmarks/bench_impact.py::_chain`` in the port: scale, filter and
    oversample ops in turn over one source."""
    from repro_torch.core.pipeline import ProvenanceIndex
    from repro_torch.dataprep.table import Table
    from repro_torch.dataprep.tracked import track

    rng = np.random.default_rng(seed)
    idx = ProvenanceIndex("chain", device=device)
    t = track(Table.from_columns({"k": np.arange(n, dtype=np.float32),
                                  "x": rng.normal(size=n).astype(np.float32)}, device=device),
              idx, "src")
    for i in range(hops):
        if i % 3 == 0:
            t = t.value_transform("x", "scale", factor=1.0 + i)
        elif i % 3 == 1:
            t = t.filter_rows(torch.as_tensor(rng.random(t.table.n_rows) > 0.05, device=device))
        else:
            t = t.oversample(frac=0.04, seed=i, noise=0.0)
    t.mark_sink()
    return idx, t.dataset_id


def federation_run(cat, src, sink, q, members: str, how: bool):
    """One catalog's federated run through member SEGMENTS (a session whose
    stitched-relation budget is 0, so the cost gate never stitches): member
    sessions configured as ``members`` says ("fused_walk": the walk with
    the fused kernel; "bitplane": warm bitplane hop-caches; "default").
    Launch counts are zeroed just before and read just after.  Returns
    (answers, launch counts, the session)."""
    from repro_torch.kernels import ops
    from repro_torch.provenance import FederatedSession
    from repro_torch.provenance.catalog import split_ref

    idx = {name: m._index for name, m in cat.members.items()}
    if members == "fused_walk":
        for i in idx.values():
            i.session(use_hopcache=False, fused_walk=True)
    elif members == "bitplane":
        for i in idx.values():
            i.composed(memory_budget_bytes=2 << 30, backend="bitplane")
    seg = FederatedSession(cat, cross_budget_bytes=0)
    ops.reset_launch_counts()
    if members == "bitplane":
        link = cat.links[0]
        idx["prep"].composed().relation(split_ref(src)[1], split_ref(link.up)[1])
        idx["serve"].composed().relation(split_ref(link.down)[1], split_ref(sink)[1])
    got = lineage_queries(cat, src, sink, q, how, seg)
    if cat.device.type == "cuda":
        torch.cuda.synchronize()
    return got, ops.launch_counts(), seg


# -- the Chapman baseline, the serving tier and the sharded view (7g-7i) --------
def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def settled_bytes(device) -> tuple:
    """``device_bytes`` after the garbage collector and the card are idle."""
    import gc

    gc.collect()
    sync(device)
    return device_bytes(device)


def chapman_capture(name, device):
    """Capture configuration ``name`` (a use case, or ``tpcdi_sf<k>``: the
    TPC-DI join at scale factor k) ONCE into a fresh index and, through the
    index's record hook, into a ChapmanIndex.  Returns (index, source ids,
    sink, chapman, chapman capture s, index capture s); the index's time is
    the whole capture less the hook's, so it includes running the ops."""
    from repro_torch.core.chapman import ChapmanIndex
    from repro_torch.core.pipeline import ProvenanceIndex
    from repro_torch.dataprep import usecases as U
    from repro_torch.dataprep.tracked import track

    idx = ProvenanceIndex(f"{name}_chapman", device=device)
    ch = ChapmanIndex()
    spent = [0.0]

    def hook(input_ids, output_id, out_table, info, input_tables):
        sync(device)
        t = time.perf_counter()
        ch.capture(input_ids, input_tables, output_id, out_table, info)
        sync(device)
        spent[0] += time.perf_counter() - t

    if name in U.USECASES:
        make, run = U.USECASES[name]
        table = make(device=device)
    else:
        left, right = U.make_tpcdi_join_inputs(int(name.split("_sf")[1]), device=device)
    idx.add_record_hook(hook)
    sync(device)
    t = time.perf_counter()
    if name in U.USECASES:
        sink = run(idx, table).dataset_id
        srcs = [idx.sources()[0]]
    else:
        sink = track(left, idx, "trade").join(track(right, idx, "security"), on="key",
                                               how="inner").mark_sink().dataset_id
        srcs = ["trade", "security"]
    sync(device)
    total = time.perf_counter() - t
    idx.remove_record_hook(hook)
    return idx, srcs, sink, ch, spent[0], total - spent[0]


def chapman_phase(dev, configs, cpu_configs, rng):
    """Table IX and Table XI on the card: each configuration captured once
    into both stores; bytes, the capture's device bytes and Chapman's share
    of them, capture seconds, and Chapman's O(T) scans against the index's
    Q1/Q2 on B probes each way, answer for answer (a join's scan merges its
    two inputs, so it is held to the union of both inputs' answers).  On
    ``cpu_configs`` the records equal the port's CPU run byte for byte."""
    from repro_torch.provenance import prov

    def union(per_src):
        return [torch.unique(torch.cat(parts)) for parts in zip(*per_src)]

    out = {}
    for name in configs:
        torch.cuda.empty_cache()
        before = settled_bytes(dev)
        idx, srcs, sink, ch, ch_s, idx_s = chapman_capture(name, dev)
        after = settled_bytes(dev)
        index_bytes = idx.prov_nbytes()            # before any query builds a mirror
        row = {
            "ops": len(ch.cells), "sink_rows": idx.datasets[sink].n_rows,
            "index_bytes": index_bytes, "chapman_records_bytes": ch.prov_nbytes(),
            "chapman_frames_bytes": ch.frames_nbytes(), "chapman_bytes": ch.total_nbytes(),
            "ratio": ch.total_nbytes() / index_bytes,
            "records": sum(int(c.records.shape[0]) for c in ch.cells),
            "capture_s": {"index": idx_s, "chapman": ch_s},
            "capture_device_bytes": [a - b for a, b in zip(after, before)],
        }
        if name in cpu_configs:
            c_idx, _, _, c_ch, _, _ = chapman_capture(name, "cpu")
            check(len(c_ch.cells) == len(ch.cells) and all(
                g.records.dtype == torch.int64 and torch.equal(g.records.cpu(), w.records)
                for g, w in zip(ch.cells, c_ch.cells)), f"{name}: Chapman records card != CPU")
            check((ch.prov_nbytes(), ch.frames_nbytes()) == (c_ch.prov_nbytes(),
                                                             c_ch.frames_nbytes()),
                  f"{name}: Chapman bytes card != CPU")
            check(c_idx.prov_nbytes() == index_bytes, f"{name}: index bytes card != CPU")
            row["records_equal_cpu"] = True
            del c_idx, c_ch
        ops_seq = list(range(len(ch.cells)))
        n_src = idx.datasets[srcs[0]].n_rows
        n_sink = idx.datasets[sink].n_rows
        q1 = [sorted(set(rng.integers(0, n_src, size=8).tolist())) for _ in range(B)]
        q2 = [sorted(set(rng.integers(0, n_sink, size=8).tolist())) for _ in range(B)]

        def index_q1():
            return union([prov(idx).source(s).rows_batch(q1).forward().to(sink).run()
                          for s in srcs])

        def index_q2():
            return union([prov(idx).source(sink).rows_batch(q2).backward().to(s).run()
                          for s in srcs])

        def scan_q1():
            return [ch.forward_rows(ops_seq, p) for p in q1]

        def scan_q2():
            return [ch.backward_rows(ops_seq, p) for p in q2]

        for what, got, want in (("Q1", scan_q1(), index_q1()), ("Q2", scan_q2(), index_q2())):
            check(len(got) == len(want) == B, f"{name} {what}: batch size")
            for g, w in zip(got, want):
                check(g.dtype == torch.int64 and torch.equal(g, w.to(torch.int64)),
                      f"{name} {what}: Chapman scan != index")
        row["scan_ms"] = {"q1": host_ms(scan_q1, reps=3), "q2": host_ms(scan_q2, reps=3)}
        row["index_ms"] = {"q1": host_ms(index_q1), "q2": host_ms(index_q2)}
        # the Chapman store's device bytes: what deleting it frees (it owns
        # its records and frame copies, nothing else does)
        total = ch.total_nbytes()
        before_free = settled_bytes(dev)
        del ch
        freed = [a - b for a, b in zip(before_free, settled_bytes(dev))]
        check(freed[1] >= total, f"{name}: freeing Chapman released {freed[1]} < {total} bytes")
        row["chapman_device_bytes"] = freed
        row["index_and_tables_device_bytes"] = [c - f for c, f in
                                                zip(row["capture_device_bytes"], freed)]
        out[name] = row
        del idx
    return out


class RecordingBackend:
    """A thin backend: every plan list the tier passes to ``run_many`` is
    recorded, then answered by the session (its device too)."""

    def __init__(self, session, gate=None):
        self.session = session
        self.device = session.device
        self.lists = []
        self.gate = gate

    def run_many(self, plans):
        if self.gate is not None:
            self.gate.wait(60)
        self.lists.append(list(plans))
        return self.session.run_many(plans)


def mixed_plans(holder, src, sink, n, rng):
    """Single-probe Q1 / Q2 / Q4 plans in turn (three fuse keys)."""
    from repro_torch.provenance import prov

    n_src, n_sink = holder.datasets[src].n_rows, holder.datasets[sink].n_rows
    n_cols = holder.datasets[sink].n_cols
    plans = []
    for i in range(n):
        if i % 3 == 0:
            plans.append(prov(holder).source(src).rows([int(rng.integers(n_src))])
                         .forward().to(sink).plan())
        elif i % 3 == 1:
            plans.append(prov(holder).source(sink).rows([int(rng.integers(n_sink))])
                         .backward().to(src).plan())
        else:
            plans.append(prov(holder).source(sink).rows([int(rng.integers(n_sink))])
                         .attrs([int(rng.integers(n_cols))]).backward().to(src).plan())
    return plans


def drive_tier(tier, plans, n_clients):
    """``n_clients`` threads submit ``plans`` (client c takes every
    n_clients-th) with ``submit_nowait`` as fast as they can.  Returns the
    answers, per-request latencies (submit -> future resolved) and the wall
    time from the first submission to the last resolution."""
    import threading

    n = len(plans)
    futs, sent, done = [None] * n, [0.0] * n, [None] * n

    def client(c):
        for i in range(c, n, n_clients):
            sent[i] = time.perf_counter()
            futs[i] = tier.submit_nowait(f"client{c}", plans[i])
            futs[i].add_done_callback(lambda f, i=i: done.__setitem__(i, time.perf_counter()))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
        check(not th.is_alive(), "a client thread hung")
    answers = [f.result(timeout=120) for f in futs]
    while any(d is None for d in done):
        time.sleep(0.001)
    lat = [d - s for d, s in zip(done, sent)]
    return answers, lat, max(done) - t0


def serving_phase(dev, backends, n_requests, n_clients, settings, rng, capability):
    """The serving tier over each backend: the per-request loop (each
    ``session.run`` synchronised) gives the reference answers, its time and
    its launches; then for each (max_batch, max_wait_ms) the tier under
    ``n_clients`` concurrent clients, every answer equal to the loop's.  On
    ``capability``'s backend also: the launches of the tier equal those of
    replaying the recorded ``run_many`` lists one at a time, a
    ``BoundaryHandle`` tenant's out-of-scope plan is denied at admission, and
    a full queue sheds with ``QueueFullError`` and then recovers."""
    import threading

    from repro_torch.kernels import ops
    from repro_torch.provenance import CapabilityError, prov
    from repro_torch.serve import QueueFullError, ServingTier

    out = {}
    counts_all = {}

    def add(counts):
        for k, v in counts.items():
            counts_all[k] = counts_all.get(k, 0) + v

    for name, (session, holder, src, sink) in backends.items():
        plans = mixed_plans(holder, src, sink, n_requests, rng)
        ops.reset_launch_counts()
        t = time.perf_counter()
        ref = []
        for p in plans:
            ref.append(session.run(p))
            sync(dev)
        loop_s = time.perf_counter() - t
        loop_counts = ops.launch_counts()
        row = {"backend": type(session).__name__, "requests": n_requests,
               "clients": n_clients, "loop_rps": n_requests / loop_s,
               "loop_launches": loop_counts, "tier": {}}
        for max_batch, max_wait_ms in settings:
            rec = RecordingBackend(session)
            ops.reset_launch_counts()
            with ServingTier(rec, max_batch=max_batch, max_wait_ms=max_wait_ms,
                             max_queue=2 * n_requests) as tier:
                got, lat, wall = drive_tier(tier, plans, n_clients)
                stats = tier.stats()["tier"]
            counts = ops.launch_counts()
            add(counts)
            for g, w in zip(got, ref):
                check(torch.equal(g, w), f"{name} tier ({max_batch}, {max_wait_ms}): "
                                         "answer != session.run")
            cell = {"p50_ms": statistics.median(lat) * 1e3,
                    "p99_ms": float(np.percentile(lat, 99)) * 1e3,
                    "rps": n_requests / wall, "speedup_vs_loop": (n_requests / wall) /
                    row["loop_rps"], "launches": counts,
                    "run_many_calls": len(rec.lists),
                    "batches": stats["batches"], "max_batch_seen": stats["max_batch_seen"],
                    "convoys": stats["convoys"]}
            if name == capability:
                ops.reset_launch_counts()
                for lst in rec.lists:
                    session.run_many(lst)
                sync(dev)
                replay = ops.launch_counts()
                check(replay.get("batched_walk", 0) == counts.get("batched_walk", 0),
                      f"{name}: tier launched batched_walk {counts} times, its run_many "
                      f"lists replayed {replay}")
                cell["replay_launches"] = replay
            row["tier"][f"{max_batch},{max_wait_ms:g}"] = cell
        if name == capability:
            walk_loop = loop_counts.get("batched_walk", 0)
            fused = row["tier"][f"{settings[-1][0]},{settings[-1][1]:g}"]
            check(0 < fused["launches"].get("batched_walk", 0) < walk_loop,
                  f"{name}: the fused tier launched {fused['launches']} against the "
                  f"per-request loop's {walk_loop}")
            idx = holder
            handle = idx.export(idx.ops[1].output_id)      # src .. the filter's output
            gate = threading.Event()
            rec = RecordingBackend(session, gate)
            tier = ServingTier(rec, max_batch=1, max_wait_ms=0.0, max_queue=4).start()
            try:
                tier.register_tenant("scoped", handle)
                denied = tier.submit_nowait("scoped", plans[1])      # a plan from the sink
                check(isinstance(denied.exception(timeout=30), CapabilityError),
                      f"{name}: an out-of-scope plan was not denied")
                inside = prov(idx).source(idx.ops[1].output_id).rows([0]).backward() \
                    .to(src).plan()
                held = [tier.submit_nowait("t", plans[i]) for i in range(4)]
                t0 = time.perf_counter()
                while tier.admission.pending < 4:
                    check(time.perf_counter() - t0 < 30, "the queue never filled")
                    time.sleep(0.001)
                shed = tier.submit_nowait("t", plans[4])
                check(isinstance(shed.exception(timeout=30), QueueFullError),
                      f"{name}: a full queue did not shed")
                gate.set()
                for i, f in enumerate(held):
                    check(torch.equal(f.result(timeout=60), ref[i]), f"{name}: held answer")
                check(torch.equal(tier.submit_sync("t", plans[4], timeout=60), ref[4]),
                      f"{name}: the tier did not recover after shedding")
                check(torch.equal(tier.submit_sync("scoped", inside, timeout=60),
                                  session.run(inside)), f"{name}: in-scope plan")
                adm = tier.admission.stats()
            finally:
                gate.set()
                tier.shutdown()
            check(adm["capability_denied"] == 1 and adm["rejected_queue_full"] == 1,
                  f"{name}: admission counters {adm}")
            row["admission"] = {k: adm[k] for k in ("capability_denied",
                                                     "rejected_queue_full", "admitted")}
        out[name] = row
    return out, counts_all


def sharded_phase(dev, configs, answers, queries, shard_counts, merged_walk, catalog_at):
    """Row-sharded views of the main path's indexes: B = 64 Q1/Q2 on the
    view's walk session (the fused kernel where the chain takes it), its
    default session and its ``ShardedComposedIndex`` equal the merged
    index's answers; the view's slices, blocks and times against the base.
    At ``catalog_at`` (configuration, shards) the catalog seam answers
    cold and on its hot stitched route as the merged index does."""
    from repro_torch.core.hopcache import ComposedIndex
    from repro_torch.kernels import ops
    from repro_torch.provenance import FederatedSession, QuerySession, ShardedProvenanceIndex, prov

    def mask_stack(ps, n):
        m = torch.zeros((len(ps), n), dtype=torch.bool, device=dev)
        for b, p in enumerate(ps):
            m[b, torch.tensor(p, dtype=torch.int64, device=dev)] = True
        return m

    def equal(got, want, what):
        check(len(got) == len(want), f"{what}: batch size")
        for g, w in zip(got, want):
            check(torch.equal(g, w), what)

    def nonzeros(stack):
        return [torch.nonzero(r).reshape(-1) for r in stack]

    out = {}
    counts_all = {}
    for name, (idx, src, sink) in configs.items():
        q1p, q2p = queries[name]["q1"], queries[name]["q2"]
        a1, a2 = answers[name]
        merged_rel = ComposedIndex(idx, memory_budget_bytes=8 << 30)
        merged_rel.probe_forward(mask_stack(q1p[:1], idx.datasets[src].n_rows), src, sink)
        rows = {"base_prov_bytes": idx.prov_nbytes(),
                "merged_relation_bytes": merged_rel.stats()["bytes"],
                "merged_walk_ms": {
                    "q1": host_ms(lambda: prov(idx).source(src).rows_batch(q1p).forward()
                                  .to(sink).run(merged_walk[name])),
                    "q2": host_ms(lambda: prov(idx).source(sink).rows_batch(q2p).backward()
                                  .to(src).run(merged_walk[name]))},
                "merged_default_ms": {
                    "q1": host_ms(lambda: prov(idx).source(src).rows_batch(q1p).forward()
                                  .to(sink).run()),
                    "q2": host_ms(lambda: prov(idx).source(sink).rows_batch(q2p).backward()
                                  .to(src).run())},
                "shards": {}}
        del merged_rel
        for n_shards in shard_counts:
            before = settled_bytes(dev)
            sv = ShardedProvenanceIndex(idx, n_shards)
            slices = sum(s.nbytes(include_index=False) for op in sv.ops for s in op.tensor.shards)
            view_alloc = [a - b for a, b in zip(settled_bytes(dev), before)]
            walk = QuerySession(sv, use_hopcache=False, fused_walk=True)
            default = sv.session()
            ops.reset_launch_counts()
            for sess, what in ((walk, "walk"), (default, "default")):
                equal(prov(sv).source(src).rows_batch(q1p).forward().to(sink).run(sess), a1,
                      f"{name} S={n_shards} {what} Q1 != merged")
                equal(prov(sv).source(sink).rows_batch(q2p).backward().to(src).run(sess), a2,
                      f"{name} S={n_shards} {what} Q2 != merged")
            sc = sv.composed()
            equal(nonzeros(sc.probe_forward(mask_stack(q1p, idx.datasets[src].n_rows), src,
                                            sink)), a1, f"{name} S={n_shards} blocks Q1")
            equal(nonzeros(sc.probe_backward(mask_stack(q2p, idx.datasets[sink].n_rows), sink,
                                             src)), a2, f"{name} S={n_shards} blocks Q2")
            sync(dev)
            counts = ops.launch_counts()
            for k, v in counts.items():
                counts_all[k] = counts_all.get(k, 0) + v
            entry = sc._entry(src, sink)
            cell = {
                "ranges": sv.ranges(sink), "blocks": [[b.kind, b.nbytes()] for b in entry.blocks],
                "blocks_bytes": sc.stats()["bytes"], "slice_bytes": slices,
                "view_alloc_device_bytes": view_alloc, "launches": counts,
                "fused_walk": walk.counters["fused_walk"],
                "default_strategy": default.explain(
                    prov(sv).source(sink).rows_batch(q2p).backward().to(src).plan())["strategy"],
                "walk_ms": {
                    "q1": host_ms(lambda: prov(sv).source(src).rows_batch(q1p).forward()
                                  .to(sink).run(walk)),
                    "q2": host_ms(lambda: prov(sv).source(sink).rows_batch(q2p).backward()
                                  .to(src).run(walk))},
                "default_ms": {
                    "q1": host_ms(lambda: prov(sv).source(src).rows_batch(q1p).forward()
                                  .to(sink).run(default)),
                    "q2": host_ms(lambda: prov(sv).source(sink).rows_batch(q2p).backward()
                                  .to(src).run(default))},
            }
            if (name, n_shards) == catalog_at:
                # cold: member segments only (a zero stitch budget); hot: the
                # route stitched across the seam from its first call on
                catalog = sv.as_catalog(src, sink)
                fplan = prov(catalog).source(f"root/{src}").rows_batch(q1p).forward() \
                    .to(f"gather/{sink}").plan()
                bplan = prov(catalog).source(f"gather/{sink}").rows_batch(q2p).backward() \
                    .to(f"root/{src}").plan()
                cold = FederatedSession(catalog, cross_budget_bytes=0)
                equal(cold.run(fplan), a1, f"{name} S={n_shards} catalog Q1 (cold)")
                equal(cold.run(bplan), a2, f"{name} S={n_shards} catalog Q2 (cold)")
                hot = FederatedSession(catalog, cross_budget_bytes=64 << 20, cross_min_demand=0)
                for _ in range(3):
                    equal(hot.run(fplan), a1, f"{name} S={n_shards} catalog Q1 (hot)")
                    equal(hot.run(bplan), a2, f"{name} S={n_shards} catalog Q2 (hot)")
                check(cold.counters["cross_composes"] == 0 and hot.counters["cross_composes"] >= 1
                      and hot.counters["cross_probes"] >= 1,
                      f"{name}: the catalog seam never turned hot: {hot.counters}")
                cell["catalog"] = {"members": len(catalog.members),
                                   "cold_counters": dict(cold.counters),
                                   "hot_counters": dict(hot.counters)}
                del catalog, cold, hot
            rows["shards"][n_shards] = cell
            del sv, walk, default, sc, entry
        out[name] = rows
    return out, counts_all


# -- the LM serving path (phase 7j) ---------------------------------------------
LM_FP32_REL = 2e-3    # decode against forward in float32 (tests/test_models.py's bound)
LM_BF16_REL = 5e-2    # the same in bfloat16: max |decode - forward| over max |forward|
LM_CPU_REL = 1e-4     # the card against the CPU, float32


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    return float((got.float() - want.float()).abs().max()) / (float(want.abs().max()) + 1e-9)


def weight_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in params.state_dict().values())


def timed_decode(engine, dev):
    """Wrap ``engine._decode`` so that every step is synchronised before and
    after and its host-clock seconds are appended to the returned list;
    ``del engine._decode`` restores the method."""
    inner, seconds = engine._decode, []

    def step(token, pos, cache):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = inner(token, pos, cache)
        torch.cuda.synchronize(dev)
        seconds.append(time.perf_counter() - t)
        return out

    engine._decode = step
    return seconds


def profile_calls(run, steps, step_ms):
    """``run(i)`` for i in [0, steps) under ``torch.profiler`` (the caller
    warms up first): kernels and device-busy ms a step, the device's idle
    share of an unprofiled ``step_ms`` step, the host ops that take the
    most self CPU time a step and the kernels that take the most device
    time a step.  None where the profiler saw no kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            run(i)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]
    by_kernel = {}
    for e in kernels:
        n, us = by_kernel.get(e.name, (0, 0.0))
        by_kernel[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:8]
    return {"steps": steps, "kernels_per_step": len(kernels) / steps,
            "device_busy_ms_per_step": busy_ms, "idle_share": 1.0 - busy_ms / step_ms,
            "top_self_cpu": [{"op": e.key, "calls_per_step": e.count / steps,
                              "self_cpu_ms_per_step": e.self_cpu_time_total / 1e3 / steps}
                             for e in host],
            "top_device": [{"kernel": name[:120], "calls_per_step": n / steps,
                            "device_ms_per_step": us / 1e3 / steps}
                           for name, (n, us) in top]}


def profile_decode(engine, dev, batch, s_max, step_ms, steps=4):
    """``steps`` decode steps of ``engine`` (after one warm step) under
    ``torch.profiler`` (:func:`profile_calls`)."""
    cache = engine.model.init_cache(engine.cfg, batch, s_max, dtype=engine.dtype, device=dev)
    tok = torch.zeros(batch, dtype=torch.int64, device=dev)
    engine._decode(tok, 0, cache)
    torch.cuda.synchronize(dev)
    return profile_calls(lambda i: engine._decode(tok, i + 1, cache), steps, step_ms)


def engine_lineage(engine, prep, sink, src, walk, result, request_ids, dev):
    """The response lineage of a recorded generation whose requests are
    rows of ``prep``'s ``sink``: the batch of every response alone equals
    the prep walk's Q2 of its request's sink row and launches
    ``batched_walk``, each ``response_lineage`` too, and the erasure of 4
    raw rows reaches exactly the responses whose requests their Q1 reaches.
    The launch counts are zeroed just before the batch (the references
    run first); the caller reads them after whatever else its path runs.
    Returns the record and the per-response answers."""
    from repro_torch.kernels import ops
    from repro_torch.provenance import prov
    from repro_torch.provenance.catalog import qualify

    n = len(request_ids)
    q2 = prov(prep).source(sink).rows_batch([[int(r)] for r in request_ids]) \
        .backward().to(src).run(walk)
    erase = sorted({int(a[0]) for a in q2 if a.numel()})[:4]
    check(len(erase) == 4, "fewer than 4 raw rows behind the requests")
    reached = set(prov(prep).source(src).rows(erase).forward().to(sink).run(walk).tolist())
    want_resp = [i for i, r in enumerate(request_ids.tolist()) if r in reached]
    ops.reset_launch_counts()
    got = engine.response_lineage_batch(result, [[i] for i in range(n)], upstream=src)
    sync(dev)
    lineage_counts = ops.launch_counts()
    check(lineage_counts.get("batched_walk", 0) > 0,
          f"the engine's lineage never launched batched_walk: {lineage_counts}")
    per_row = [engine.response_lineage(result, rows=[i], upstream=src) for i in range(n)]
    for i, (g, w) in enumerate(zip(got, q2)):
        check(torch.equal(g, w), f"response {i}: lineage != the prep walk's Q2")
        check(torch.equal(per_row[i], w), f"response {i}: response_lineage != Q2")
    plan = engine.erasure_impact(erase, source=src)
    by_ref = {i.ref: sorted(i.rows.tolist()) for i in plan.impacts}
    resp_ref = qualify(engine._serve_name, result.response_dataset)
    check(resp_ref == "serve/responses@0" and by_ref.get(resp_ref) == want_resp,
          f"erasure reached {by_ref.get(resp_ref)}, Q1 reaches {want_resp}")
    up = qualify(engine._upstream[0], src)
    return ({"response_ref": resp_ref, "upstream": up,
             "lineage": {"responses": n, "upstream": up, "launches": lineage_counts,
                         "federation_counters": dict(engine.federation.counters)},
             "erasure": {"raw_rows": erase, "responses": want_resp,
                         "affected": [i.ref for i in plan.impacts]}}, per_row)


def prep_engine(cfg, params, max_seq, dev):
    """A bf16 ``ServeEngine`` of ``params`` whose upstream is a Compas prep
    index captured on the card, its session on the fused walk, the engine's
    federated session pinned to the cold route (no stitched cross
    relation: the default gate stitches a 64-probe route at once, and the
    walk would never launch).  Returns the engine, the prep index, its sink
    and source, and the walk session."""
    from repro_torch.core.pipeline import ProvenanceIndex
    from repro_torch.dataprep import usecases as U
    from repro_torch.serve import ServeEngine

    make, run = U.USECASES["compas"]
    prep = ProvenanceIndex("prep", device=dev)
    sink = run(prep, make(device=dev)).dataset_id
    src = prep.sources()[0]
    walk = prep.session(use_hopcache=False, fused_walk=True)   # before any query
    engine = ServeEngine(cfg, params, max_seq=max_seq, upstream=prep.export(sink), device=dev)
    engine.catalog.session(cross_budget_bytes=0)
    return engine, prep, sink, src, walk


def lm_serving_phase(dev):
    """The LM serving path at full published width.  (c) first: OLMo-1B in
    float32, token-by-token ``decode_step`` against ``forward`` over 32
    tokens, and the olmo and gemma3-1b smokes on the card against the CPU
    (float32 logits, greedy tokens).  (a) OLMo-1B in bf16 behind a
    ``ServeEngine`` whose upstream is a Compas prep index captured on the
    card (its session on the fused walk; the engine's federated session
    never stitches): 64 prompts of 32 tokens, 16 new
    tokens, recorded; response lineage to the raw rows equals the prep
    walk's Q2 of each request's sink row, with ``batched_walk`` launched;
    the erasure of 4 raw rows reaches exactly the responses whose requests
    Q1 reaches; 512 single probes through the tier from 8 threads equal
    ``response_lineage``.  (b) gemma3-1b in bf16: 1,056 positions through
    the engine's decode step (the local layers' 1,024-slot ring wraps)
    against ``forward`` at the last 16.  Returns the results and the
    launch counts of the lineage, erasure and tier calls."""
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm as TL
    from repro_torch.provenance import prov
    from repro_torch.serve import ServeEngine, ServingTier

    out = {"allocated_at_start_bytes": torch.cuda.memory_allocated(dev)}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats(dev)

    # (c) OLMo-1B at full width in float32: decode equals forward
    cfg = get_config("olmo-1b")
    params, init_s = sync_time(TL.init_params, cfg, gen, dev)
    toks = torch.randint(0, cfg.vocab, (2, 32), generator=gen, device=dev)
    full = TL.forward(cfg, params, toks, dtype=torch.float32)
    cache = TL.init_cache(cfg, 2, 32, dtype=torch.float32, device=dev)
    dec = torch.stack([TL.decode_step(cfg, params, toks[:, i], i, cache, dtype=torch.float32)[0]
                       for i in range(32)], dim=1)
    fp32_rel = rel_err(dec[..., :cfg.vocab], full[..., :cfg.vocab])
    check(bool(torch.isfinite(full).all()), "olmo-1b float32: non-finite logits")
    check(fp32_rel < LM_FP32_REL, f"olmo-1b float32: decode != forward (rel {fp32_rel})")
    del full, dec, cache
    smokes = {}
    for arch in ("olmo-1b", "gemma3-1b"):
        scfg = get_smoke_config(arch)
        p_cpu = TL.init_params(scfg, torch.Generator().manual_seed(SEED), "cpu")
        p_dev = TL.cast_params(scfg, p_cpu, torch.float32, dev)
        stoks = torch.from_numpy(np.random.default_rng(SEED).integers(0, scfg.vocab, (4, 16)))
        err = rel_err(TL.forward(scfg, p_dev, stoks.to(dev), dtype=torch.float32).cpu(),
                      TL.forward(scfg, p_cpu, stoks, dtype=torch.float32))
        check(err < LM_CPU_REL, f"{arch} smoke: card logits != CPU (rel {err})")
        prompts = np.random.default_rng(SEED).integers(1, scfg.vocab, (4, 8)).astype(np.int32)
        tok = {d: ServeEngine(scfg, p_cpu, 16, dtype=torch.float32, device=d)
               .generate(prompts, n_new=8).tokens for d in ("cpu", dev)}
        check(np.array_equal(tok["cpu"], tok[dev]), f"{arch} smoke: greedy tokens card != CPU")
        smokes[arch] = {"logits_rel_err": err, "tokens_equal": True}

    # (a) OLMo-1B in bf16 behind the engine, upstream a Compas prep index
    # on the cold route: every probe crosses the boundary as member
    # segments and the prep segment runs on its fused walk
    engine, prep, sink, src, walk = prep_engine(cfg, params, 48, dev)
    del params
    n_params = sum(t.numel() for t in engine.params.state_dict().values())
    rng = np.random.default_rng(SEED + 9)
    engine.generate(rng.integers(1, cfg.vocab, (64, 4)).astype(np.int32), n_new=2)  # warm-up
    prompts = rng.integers(1, cfg.vocab, (64, 32)).astype(np.int32)
    request_ids = rng.integers(0, prep.datasets[sink].n_rows, 64)
    steps = timed_decode(engine, dev)
    t = time.perf_counter()
    result = engine.generate(prompts, n_new=16, request_ids=request_ids, record_provenance=True)
    generate_s = time.perf_counter() - t
    del engine._decode
    check(result.tokens.shape == (64, 16) and result.tokens.dtype == np.int32
          and 0 <= int(result.tokens.min()) and int(result.tokens.max()) < cfg.vocab,
          f"olmo-1b: tokens {result.tokens.shape} {result.tokens.dtype}")
    gen_steps = steps[32:]
    step_ms = statistics.median(gen_steps) * 1e3
    bound_ms = weight_bytes(engine.params) / HBM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated(dev)

    # the path: the batch, each response alone, the erasure and the tier
    lineage, per_row = engine_lineage(engine, prep, sink, src, walk, result, request_ids, dev)
    resp_ref = lineage["response_ref"]
    up = lineage["upstream"]
    tier_rows = rng.integers(0, 64, 512)
    plans = [prov(engine.catalog).source(resp_ref).rows([int(i)]).backward().to(up).plan()
             for i in tier_rows]
    with ServingTier(engine.as_backend(), max_batch=64, max_wait_ms=2.0,
                     max_queue=1024) as tier:
        answers, lat, wall = drive_tier(tier, plans, 8)
        tier_stats = tier.stats()["tier"]
    for i, a in zip(tier_rows, answers):
        check(torch.equal(a, per_row[i]), f"tier answer for response {i} != response_lineage")
    counts = ops.launch_counts()
    olmo_profile = profile_decode(engine, dev, 64, 48, step_ms)
    out["olmo_1b"] = {
        "dtype": "bfloat16", "n_params": n_params, "weight_bytes": weight_bytes(engine.params),
        "batch": 64, "prompt_len": 32, "n_new": 16, "init_s": init_s,
        "decode_ms_per_step": step_ms, "decode_ms_per_step_min": min(gen_steps) * 1e3,
        "decode_tokens_per_s": 64 / (step_ms / 1e3), "bound_ms": bound_ms,
        "bound_by": "bytes", "prompt_pass_ms": sum(steps[:32]) * 1e3,
        "generate_s": generate_s, "generate_tokens_per_s": 64 * 16 / generate_s,
        "max_memory_allocated_bytes": peak,
        "float32_decode_vs_forward_rel": fp32_rel,
        **lineage,
        "tier": {"requests": 512, "clients": 8, "p50_ms": statistics.median(lat) * 1e3,
                 "p99_ms": float(np.percentile(lat, 99)) * 1e3, "rps": 512 / wall,
                 "batches": tier_stats["batches"],
                 "max_batch_seen": tier_stats["max_batch_seen"]},
        "decode_profile": olmo_profile}
    del engine, prep, walk, per_row

    # (b) gemma3-1b in bf16: 1,056 positions, the local layers' ring wraps
    cfg = get_config("gemma3-1b")
    params = TL.init_params(cfg, gen, dev)
    engine = ServeEngine(cfg, params, max_seq=1056, device=dev)
    del params
    toks = torch.randint(0, cfg.vocab, (4, 1056), generator=gen, device=dev)
    cache = engine.model.init_cache(cfg, 4, 1056, dtype=engine.dtype, device=dev)
    local = [lc["k"].shape[1] for lc, s in zip(cache, cfg.layer_specs()) if s.mixer == "attn_local"]
    check(local and set(local) == {cfg.window}, f"gemma3-1b local caches {set(local)}")
    steps = timed_decode(engine, dev)
    last = [engine._decode(toks[:, i], i, cache)[0] for i in range(1056)][-16:]
    del engine._decode
    full = TL.forward(cfg, engine.params, toks, dtype=engine.dtype)[:, -16:, :cfg.vocab]
    last = [lg[:, :cfg.vocab] for lg in last]
    bf16_rel = rel_err(torch.stack(last, dim=1), full)
    check(bool(torch.isfinite(full).all()), "gemma3-1b: non-finite logits")
    check(bf16_rel < LM_BF16_REL, f"gemma3-1b bf16: decode != forward (rel {bf16_rel})")
    agree = float((torch.stack(last, dim=1).argmax(-1) == full.argmax(-1)).float().mean())
    step_ms = statistics.median(steps[-16:]) * 1e3
    out["gemma3_1b"] = {
        "dtype": "bfloat16", "n_params": sum(t.numel() for t in engine.params.state_dict().values()),
        "weight_bytes": weight_bytes(engine.params), "batch": 4, "positions": 1056,
        "window": cfg.window, "decode_ms_per_step": step_ms,
        "decode_tokens_per_s": 4 / (step_ms / 1e3),
        "bound_ms": weight_bytes(engine.params) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "decode_vs_forward_rel": bf16_rel, "argmax_agreement": agree,
        "decode_profile": profile_decode(engine, dev, 4, 1056, step_ms),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev)}
    out["smokes_card_vs_cpu"] = smokes
    out["tolerances"] = {"float32_decode": LM_FP32_REL, "bfloat16_decode": LM_BF16_REL,
                         "card_vs_cpu": LM_CPU_REL}
    del engine, cache, full, last
    torch.cuda.empty_cache()
    return out, counts


# -- every model family (phase 7k) ---------------------------------------------
MOE_FP32_REL = 1e-4   # moe_forward against the phase's plain loop over experts, float32


def plain_moe_loop(cfg, p, x):
    """An independent loop over the experts, float32: each token's top-k of
    the float32 router logits, softmaxed over the k; each expert keeps the
    first ``cap`` tokens that chose it, in token order (``cap``: the
    capacity factor times the even share, rounded up to 8, at least 8),
    and adds weight * its SwiGLU output of each.  Returns the output and
    the number of dropped choices."""
    xt = x.reshape(-1, x.shape[-1]).float()
    t = xt.shape[0]
    topw, topi = torch.topk(xt @ p.router.float(), cfg.top_k, dim=-1)
    w = torch.softmax(topw, dim=-1)
    share = t * cfg.top_k / cfg.n_experts * cfg.capacity_factor
    cap = max(int(np.ceil(share / 8.0)) * 8, 8)
    out = torch.zeros_like(xt)
    dropped = 0
    for e in range(cfg.n_experts):
        tok, j = (topi == e).nonzero(as_tuple=True)           # token order
        dropped += max(tok.numel() - cap, 0)
        tok, j = tok[:cap], j[:cap]
        g = xt[tok] @ p.wg[e].float()
        h = g * torch.sigmoid(g) * (xt[tok] @ p.wi[e].float())
        out.index_add_(0, tok, (h @ p.wo[e].float()) * w[tok, j][:, None])
    return out.reshape(x.shape), dropped


def decode_all(model, cfg, params, toks, cache, start=0):
    """Token-by-token ``decode_step`` of toks (B, S) at positions start..:
    (B, S, V) float32 logits."""
    return torch.stack([model.decode_step(cfg, params, toks[:, i], start + i, cache,
                                          dtype=torch.float32)[0]
                        for i in range(toks.shape[1])], dim=1)


def served(engine, dev, batch, prompt_len, n_new, rng, frames=None, **kw):
    """A warm-up generation, then ``batch`` prompts of ``prompt_len`` tokens
    and ``n_new`` new greedy tokens with every decode step synchronised and
    timed, and the decode profile.  Returns the result and the record (its
    peak memory: since the caller's last reset)."""
    cfg = engine.cfg
    engine.generate(rng.integers(1, cfg.vocab, (batch, 2)).astype(np.int32), n_new=2,
                    frames=frames)
    prompts = rng.integers(1, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    steps = timed_decode(engine, dev)
    t = time.perf_counter()
    result = engine.generate(prompts, n_new=n_new, frames=frames, **kw)
    generate_s = time.perf_counter() - t
    del engine._decode
    check(result.tokens.shape == (batch, n_new) and result.tokens.dtype == np.int32
          and 0 <= int(result.tokens.min()) and int(result.tokens.max()) < cfg.vocab,
          f"{cfg.name}: tokens {result.tokens.shape} {result.tokens.dtype}")
    step_ms = statistics.median(steps[prompt_len:]) * 1e3
    return result, {
        "dtype": "bfloat16", "weight_bytes": weight_bytes(engine.params),
        "n_weights": sum(t.numel() for t in engine.params.state_dict().values()),
        "batch": batch, "prompt_len": prompt_len, "n_new": n_new,
        "decode_ms_per_step": step_ms, "decode_ms_per_step_min": min(steps[prompt_len:]) * 1e3,
        "decode_tokens_per_s": batch / (step_ms / 1e3), "prompt_pass_ms": sum(steps[:prompt_len]) * 1e3,
        "generate_s": generate_s, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev),
        "decode_profile": profile_decode(engine, dev, batch, engine.max_seq, step_ms)}


def lm_families_phase(dev):
    """Every other model family through ``ServeEngine`` at full published
    width, the weights random from the seed.  (d) first: the mamba2, jamba,
    qwen3-moe, dbrx and whisper smokes on the card against the CPU (float32
    logits, greedy tokens; whisper given frames).  (a) mamba2-370m (48
    layers): float32 ``forward`` over (2, 512) tokens (two 256-token
    chunks, so the inter-chunk recurrence runs) against token-by-token
    ``decode_step``, and ``prefill`` of 256 tokens handed to decode for the
    next 256 against the same forward; then bf16 behind an engine whose
    upstream is a Compas prep index on the cold route: 64 prompts of 32
    tokens, 16 new, recorded, its lineage and erasure checked as OLMo-1B's
    (``engine_lineage``); the bound counts the float32 recurrent state each
    step reads and writes beside the weights.  (b) whisper-small (12 + 12
    layers, 1,500 frames): float32 decode after ``encode_into_cache``
    against ``forward`` over (2, 32) tokens; bf16 engine with frames at
    B = 16, 8-token prompts, 16 new; the bound adds the cross K/V each step
    reads.  (c) qwen3-moe-235b-a22b at full width, depth cut to 2 layers:
    float32 ``moe_forward`` against ``plain_moe_loop`` at 96 tokens (some
    choices drop, asserted) and 8 (none can: 8 tokens never exceed the
    capacity of 8), decode against forward on (2, 4) tokens (8 tokens: the
    forward drops nothing); then the float32 copy freed behind a bf16
    engine at B = 64, whose step reads every expert.  Returns the results
    and the launch counts of the mamba2 engine's lineage and erasure."""
    import dataclasses

    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm as TL
    from repro_torch.models import moe as TM
    from repro_torch.models import whisper as TW
    from repro_torch.models.registry import get_model
    from repro_torch.serve import ServeEngine

    out = {"allocated_at_start_bytes": torch.cuda.memory_allocated(dev)}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED + 10)

    # (d) the smokes on the card against the CPU
    smokes = {}
    for arch in ("mamba2-370m", "jamba-1.5-large-398b", "qwen3-moe-235b-a22b", "dbrx-132b",
                 "whisper-small"):
        scfg = get_smoke_config(arch)
        model = get_model(scfg)
        p_cpu = model.init_params(scfg, torch.Generator().manual_seed(SEED), "cpu")
        p_dev = model.cast_params(scfg, p_cpu, torch.float32, dev)
        srng = np.random.default_rng(SEED)
        stoks = torch.from_numpy(srng.integers(0, scfg.vocab, (4, 16)))
        fr = (srng.normal(size=(4, scfg.enc_seq, scfg.d_model)).astype(np.float32)
              if scfg.is_encdec else None)

        def logits(p, d):
            args = (stoks.to(d),) if fr is None else (torch.from_numpy(fr).to(d), stoks.to(d))
            return model.forward(scfg, p, *args, dtype=torch.float32)[..., :scfg.vocab].cpu()

        err = rel_err(logits(p_dev, dev), logits(p_cpu, "cpu"))
        check(err < LM_CPU_REL, f"{arch} smoke: card logits != CPU (rel {err})")
        prompts = srng.integers(1, scfg.vocab, (4, 8)).astype(np.int32)
        tok = {d: ServeEngine(scfg, p_cpu, 16, dtype=torch.float32, device=d)
               .generate(prompts, n_new=8, frames=fr).tokens for d in ("cpu", dev)}
        check(np.array_equal(tok["cpu"], tok[dev]), f"{arch} smoke: greedy tokens card != CPU")
        smokes[arch] = {"logits_rel_err": err, "tokens_equal": True}
    out["smokes_card_vs_cpu"] = smokes

    # (a) mamba2-370m at full size
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config("mamba2-370m")
    params = TL.init_params(cfg, gen, dev)
    toks = torch.randint(0, cfg.vocab, (2, 512), generator=gen, device=dev)
    full = TL.forward(cfg, params, toks, dtype=torch.float32)[..., :cfg.vocab]
    check(bool(torch.isfinite(full).all()), "mamba2-370m float32: non-finite logits")
    cache = TL.init_cache(cfg, 2, 512, dtype=torch.float32, device=dev)
    dec_rel = rel_err(decode_all(TL, cfg, params, toks, cache)[..., :cfg.vocab], full)
    check(dec_rel < LM_FP32_REL, f"mamba2-370m float32: decode != forward (rel {dec_rel})")
    head, cache = TL.prefill(cfg, params, toks[:, :256], dtype=torch.float32)
    rest = decode_all(TL, cfg, params, toks[:, 256:], cache, start=256)
    handoff = torch.cat([head[:, None], rest], dim=1)[..., :cfg.vocab]
    pre_rel = rel_err(handoff, full[:, 255:])
    check(pre_rel < LM_FP32_REL, f"mamba2-370m float32: prefill + decode != forward ({pre_rel})")
    del full, cache, head, rest, handoff
    fp32_peak = torch.cuda.max_memory_allocated(dev)
    engine, prep, sink, src, walk = prep_engine(cfg, params, 48, dev)
    del params
    request_ids = rng.integers(0, prep.datasets[sink].n_rows, 64)
    result, rec = served(engine, dev, 64, 32, 16, rng, request_ids=request_ids,
                         record_provenance=True)
    lineage, _ = engine_lineage(engine, prep, sink, src, walk, result, request_ids, dev)
    counts = ops.launch_counts()
    n_ssd = sum(spec.mixer == "ssd" for spec in cfg.layer_specs())
    state_bytes = n_ssd * 64 * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4  # float32
    bound_weights_ms = rec["weight_bytes"] / HBM_BYTES_PER_S * 1e3
    bound_state_ms = 2 * state_bytes / HBM_BYTES_PER_S * 1e3   # read and written each step
    out["mamba2_370m"] = {
        "n_params": cfg.n_params(), **rec,
        "state_bytes": state_bytes, "bound_weights_ms": bound_weights_ms,
        "bound_state_ms": bound_state_ms, "bound_ms": bound_weights_ms + bound_state_ms,
        "bound_by": "bytes", "float32_decode_vs_forward_rel": dec_rel,
        "float32_prefill_then_decode_rel": pre_rel, "float32_max_memory_allocated_bytes": fp32_peak,
        "seconds": time.perf_counter() - t0, **lineage}
    del engine, prep, walk, result

    # (b) whisper-small at full size
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config("whisper-small")
    params = TW.init_params(cfg, gen, dev)
    toks = torch.randint(0, cfg.vocab, (2, 32), generator=gen, device=dev)
    frames = torch.randn((2, cfg.enc_seq, cfg.d_model), generator=gen, device=dev)
    full = TW.forward(cfg, params, frames, toks, dtype=torch.float32)[..., :cfg.vocab]
    check(bool(torch.isfinite(full).all()), "whisper-small float32: non-finite logits")
    cache = TW.encode_into_cache(cfg, params, frames,
                                 TW.init_cache(cfg, 2, 32, dtype=torch.float32, device=dev))
    dec_rel = rel_err(decode_all(TW, cfg, params, toks, cache)[..., :cfg.vocab], full)
    check(dec_rel < LM_FP32_REL, f"whisper-small float32: decode != forward (rel {dec_rel})")
    del full, cache, frames
    engine = ServeEngine(cfg, params, max_seq=24, device=dev)
    del params
    frames = rng.normal(size=(16, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    enc_in = torch.as_tensor(frames, dtype=engine.dtype, device=dev)
    enc_cache = TW.init_cache(cfg, 16, 24, dtype=engine.dtype, device=dev)
    encode_ms = statistics.median(
        sync_time(TW.encode_into_cache, cfg, engine.params, enc_in, enc_cache)[1]
        for _ in range(4)) * 1e3
    cross_bytes = sum(lc[k].numel() * lc[k].element_size() for lc in enc_cache for k in ("ck", "cv"))
    del enc_in, enc_cache
    _, rec = served(engine, dev, 16, 8, 16, rng, frames=frames)
    bound_weights_ms = rec["weight_bytes"] / HBM_BYTES_PER_S * 1e3
    bound_cross_ms = cross_bytes / HBM_BYTES_PER_S * 1e3
    out["whisper_small"] = {
        "n_params": cfg.n_params(), **rec, "encoder_ms": encode_ms, "frames": cfg.enc_seq,
        "cross_kv_bytes": cross_bytes, "bound_weights_ms": bound_weights_ms,
        "bound_cross_kv_ms": bound_cross_ms, "bound_ms": bound_weights_ms + bound_cross_ms,
        "bound_by": "bytes", "float32_decode_vs_forward_rel": dec_rel,
        "seconds": time.perf_counter() - t0}
    del engine

    # (c) qwen3-moe-235b-a22b at full width, 2 of its 94 layers
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    full_cfg = get_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(full_cfg, n_layers=2)
    params = TL.init_params(cfg, gen, dev)
    moe = params.layers[0].moe
    moe_checks = {}
    for t, drops in ((96, True), (8, False)):
        x = torch.randn((2, t // 2, cfg.d_model), generator=gen, device=dev)
        want, dropped = plain_moe_loop(cfg, moe, x)
        err = rel_err(TM.moe_forward(cfg, moe, x), want)
        check(err < MOE_FP32_REL, f"qwen3-moe moe_forward at {t} tokens != plain loop ({err})")
        check((dropped > 0) == drops, f"qwen3-moe at {t} tokens: {dropped} choices dropped")
        moe_checks[t] = {"capacity": TM._capacity(cfg, t), "dropped": dropped, "rel_err": err}
    toks = torch.randint(0, cfg.vocab, (2, 4), generator=gen, device=dev)
    full = TL.forward(cfg, params, toks, dtype=torch.float32)
    cache = TL.init_cache(cfg, 2, 4, dtype=torch.float32, device=dev)
    dec_rel = rel_err(decode_all(TL, cfg, params, toks, cache), full)
    check(dec_rel < LM_FP32_REL, f"qwen3-moe float32: decode != forward (rel {dec_rel})")
    fp32_peak = torch.cuda.max_memory_allocated(dev)
    del full, cache, moe
    engine = ServeEngine(cfg, params, max_seq=24, device=dev)
    del params
    torch.cuda.empty_cache()
    _, rec = served(engine, dev, 64, 8, 16, rng)
    bound_ms = rec["weight_bytes"] / HBM_BYTES_PER_S * 1e3   # every expert is read each step
    out["qwen3_moe_2_layers"] = {
        "n_params": cfg.n_params(), **rec, "reduced": {"n_layers": [full_cfg.n_layers, 2]},
        "experts": cfg.n_experts, "top_k": cfg.top_k, "decode_capacity": TM._capacity(cfg, 64),
        "bound_ms": bound_ms, "bound_by": "bytes", "moe_forward_vs_plain": moe_checks,
        "float32_decode_vs_forward_rel": dec_rel, "float32_max_memory_allocated_bytes": fp32_peak,
        "seconds": time.perf_counter() - t0}
    out["tolerances"] = {"float32_decode": LM_FP32_REL, "card_vs_cpu": LM_CPU_REL,
                         "moe_forward_vs_plain": MOE_FP32_REL}
    del engine
    torch.cuda.empty_cache()
    return out, counts


# -- the training path (phase 7l) -----------------------------------------------
TRAIN_SMOKES = ("olmo-1b", "gemma3-1b", "mamba2-370m", "qwen3-moe-235b-a22b", "whisper-small")
TRAIN_CPU_REL = 1e-4        # one float32 step on the card against the CPU
TRAIN_SEQ = 4_096           # train_4k's sequence (repro/launch/shapes.py:42)
TRAIN_BATCH = 8             # train_4k's global batch of 256, cut to 8
TRAIN_STEPS = 8
TRAIN_CORPUS = dict(n_docs=20_000, mean_len=384)
BF16_PEAK_FLOPS = 989.4e12  # H100 SXM dense bf16 (NVIDIA data sheet)


def close_after_step(got, want, rel, what, mu=None, lr=0.0) -> float:
    """Updated tensors ``got`` against ``want`` (dicts by parameter name),
    each leaf within ``rel`` of its largest value.  Given the first moment
    ``mu`` (the gradient, scaled) the parameters are held so only where
    ``mu`` is at least 1e-3 of its leaf's largest: Adam divides a gradient
    by its own magnitude, so two smaller gradients equal within ``rel`` may
    move a parameter up to 2 x lr apart (held to 2.2 x lr).  Returns the
    largest error over leaf maxima."""
    worst = 0.0
    for n, w in want.items():
        g, w = got[n].detach().float().cpu(), w.detach().float().cpu()
        big = torch.ones_like(w, dtype=torch.bool)
        if mu is not None:
            m = mu[n].detach().float().cpu().abs()
            big = m > 1e-3 * m.max()
        scale = float(w.abs().max()) + 1e-30
        err_big = float((g - w)[big].abs().max()) if bool(big.any()) else 0.0
        err_small = float((g - w)[~big].abs().max()) if bool((~big).any()) else 0.0
        check(err_big <= rel * scale and err_small <= 2.2 * lr,
              f"{what} {n}: {err_big} of {scale} (|mu| large), {err_small} (small, lr {lr})")
        worst = max(worst, err_big / scale)
    return worst


def train_smoke_batch(cfg, seed, device):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], -np.ones((4, 1), np.int32)], axis=1)
    out = {"tokens": toks, "labels": labels}
    if cfg.is_encdec:
        out["frames"] = rng.normal(size=(4, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def train_step_flops(cfg, opt, n_micro, batch, seq, remat=False) -> int:
    """The model FLOPs of one train step (forward and backward matmuls,
    attention's S x S products included), counted by ``FlopCounterMode``
    over a step on the meta device, so nothing is allocated; with remat off
    (the default) no recompute is counted."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models.lm import LM
    from repro_torch.models.common import trainable
    from repro_torch.train import TrainState, init_opt_state, make_train_step

    cfg = dataclasses.replace(cfg, remat=remat)
    params = trainable(LM(cfg, device="meta"))
    state = TrainState(params, init_opt_state(params, opt))
    toks = torch.zeros((batch, seq), dtype=torch.int32, device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        make_train_step(cfg, opt, n_micro=n_micro)(state, {"tokens": toks, "labels": toks})
    return counter.get_total_flops()


def remat_recompute_flops(cfg, batch, seq) -> int:
    """The dot FLOPs that remat ``"nothing"`` adds to one train step of a
    dense decoder (attention and MLP layers, ``q_chunk`` 0), from the
    config alone: the backward runs each block's forward again, all but
    the block's last product (its MLP's down projection), whose output the
    backward never reads, so checkpointing stops before it."""
    specs = cfg.layer_specs()
    check(all(s.mixer in ("attn", "attn_local") and s.ffn == "mlp" for s in specs)
          and not cfg.tail and not cfg.window, f"{cfg.name}: not a dense decoder")
    t, d, hd, f = batch * seq, cfg.d_model, cfg.hd, cfg.d_ff
    attn = 2 * t * d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) \
        + 2 * 2 * batch * cfg.n_heads * seq * seq * hd
    mlp = 2 * t * d * f * (3 if cfg.gated_mlp else 2)
    return cfg.n_blocks * (len(cfg.block) * (attn + mlp) - 2 * t * f * d)


def train_phase(dev):
    """The training path.  (a) one float32 ``train_step`` (``n_micro`` 2) of
    the olmo, gemma3-1b, mamba2, qwen3-moe and whisper smokes on the card
    against the CPU port (loss, grad norm, updated params and moments).
    (b) OLMo-1B at full width (float32 master weights, bf16 activations
    and moments, remat ``"nothing"``, ``n_micro`` 2, ``q_chunk`` 0: train_4k's
    settings) at seq 4,096 and global batch 8 (train_4k's 256, cut), its
    batches from a ``TokenPipeline`` on the card over a 20,000-document
    corpus, each step's batch recorded: ms a step and tokens/s (default
    mode), the model FLOPs and their bound, the profiler's idle share, peak
    memory; then under ``torch.use_deterministic_algorithms(True)`` an
    uninterrupted 8-step ``run_training`` (async checkpoints every 4 steps
    under ``build/train_smoke/``, ``keep=1``) whose loss falls, its full
    state saved (snapshot and write timed) and restored bit for bit, and a
    run crashed at step 6 and resumed from step 4 that ends on the same
    state bit for bit.  (c) every trained step's lineage: Q2 through a walk
    session on the fused kernel equals the default session's, 4 documents'
    Q1 equals the inverse of the Q2 answers, and the consent audit flags
    exactly the non-consenting contributors.  Returns the results and the
    path's launch counts."""
    import shutil

    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.data.pipeline import CorpusConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models.common import trainable
    from repro_torch.models.registry import get_model
    from repro_torch.provenance.session import QuerySession
    from repro_torch.train import (
        AdamWConfig,
        CheckpointManager,
        LoopConfig,
        TrainState,
        init_opt_state,
        init_train_state,
        make_train_step,
        run_training,
    )
    from repro_torch.train.checkpoint import flatten_tree

    t_phase = time.perf_counter()
    out = {"allocated_at_start_bytes": torch.cuda.memory_allocated(dev)}
    ops.reset_launch_counts()      # the train path starts here

    # (a) the smokes: one float32 step on the card against the CPU
    smokes = {}
    for arch in TRAIN_SMOKES:
        cfg = get_smoke_config(arch)
        opt = AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=10, moment_dtype=torch.float32)
        cpu = init_train_state(cfg, torch.Generator().manual_seed(SEED), opt, "cpu")
        card_params = trainable(get_model(cfg).cast_params(cfg, cpu.params, torch.float32, dev))
        card = TrainState(card_params, init_opt_state(card_params, opt))
        step = make_train_step(cfg, opt, n_micro=2, dtype=torch.float32)
        cpu_new, cpu_met = step(cpu, train_smoke_batch(cfg, SEED, "cpu"))
        card_new, card_met = step(card, train_smoke_batch(cfg, SEED, dev))
        lr = float(cpu_met["lr"])
        rec = {k: rel_err(card_met[k].cpu(), cpu_met[k]) for k in ("loss", "grad_norm")}
        check(max(rec.values()) < TRAIN_CPU_REL, f"{arch} smoke: card metrics != CPU {rec}")
        check(float(card_met["lr"]) == lr, f"{arch} smoke: lr {float(card_met['lr'])} != {lr}")
        rec["params"] = close_after_step(dict(card_new.params.named_parameters()),
                                         dict(cpu_new.params.named_parameters()), TRAIN_CPU_REL,
                                         f"{arch} smoke params", mu=cpu_new.opt.mu, lr=lr)
        rec["mu"] = close_after_step(card_new.opt.mu, cpu_new.opt.mu, TRAIN_CPU_REL,
                                     f"{arch} smoke mu")
        rec["nu"] = close_after_step(card_new.opt.nu, cpu_new.opt.nu, 2 * TRAIN_CPU_REL,
                                     f"{arch} smoke nu")
        smokes[arch] = rec
    out["smokes_card_vs_cpu"] = smokes
    del cpu, card, cpu_new, card_new

    # (b) OLMo-1B at full width on the provenance-carrying data path
    cfg = get_config("olmo-1b")
    check(cfg.remat and cfg.remat_policy == "nothing" and cfg.tie_embeddings,
          f"olmo-1b: remat {cfg.remat} {cfg.remat_policy}, tied {cfg.tie_embeddings}")
    opt = AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    t = time.perf_counter()
    tp = TokenPipeline(CorpusConfig(vocab=cfg.vocab, seed=SEED, **TRAIN_CORPUS),
                       seq_len=TRAIN_SEQ, device=dev)
    pipeline_s = time.perf_counter() - t
    check(tp.n_seq >= TRAIN_STEPS * TRAIN_BATCH, f"{tp.n_seq} sequences")

    def batch_fn(s):
        b = tp.batch_at(s, TRAIN_BATCH, record_provenance=True)
        return {"tokens": b["tokens"], "labels": b["labels"]}

    step = make_train_step(cfg, opt, n_micro=2, q_chunk=0)
    flops = train_step_flops(cfg, opt, 2, TRAIN_BATCH, TRAIN_SEQ)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    state = init_train_state(cfg, gen, opt, dev)
    n_params = sum(p.numel() for p in state.params.parameters())
    state_bytes = {"params_float32": sum(p.numel() * p.element_size()
                                         for p in state.params.parameters()),
                   "grads_float32": sum(p.numel() * 4 for p in state.params.parameters()),
                   "moments_bf16": sum(t.numel() * t.element_size()
                                       for m in (state.opt.mu, state.opt.nu) for t in m.values())}
    seconds, losses = [], []
    for s in range(4):          # one warm-up, three timed
        batch = batch_fn(s)
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize(dev)
        seconds.append(time.perf_counter() - t)
    step_ms = statistics.median(seconds[1:]) * 1e3
    peak = torch.cuda.max_memory_allocated(dev)

    def one(i):
        nonlocal state
        state, _ = step(state, batch_fn(4 + i))

    profile = profile_calls(one, 2, step_ms)
    del state, one
    torch.cuda.empty_cache()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    bound_s = flops / BF16_PEAK_FLOPS
    out["olmo_1b"] = {
        "n_params": n_params, "seq": TRAIN_SEQ, "global_batch": TRAIN_BATCH, "n_micro": 2,
        "q_chunk": 0, "remat": cfg.remat_policy, "dtype": "bfloat16 activations, float32 "
        "master weights, bfloat16 moments",
        "reduced": {"global_batch": [256, TRAIN_BATCH]},
        "corpus": {**TRAIN_CORPUS, "n_seq": tp.n_seq, "build_s": pipeline_s},
        "ms_per_step": step_ms, "step_ms_all": [x * 1e3 for x in seconds],
        "tokens_per_s": tokens / (step_ms / 1e3), "model_flops_per_step": flops,
        "model_flops_per_token": flops / tokens,
        "bound_ms": bound_s * 1e3, "bound_by": "operations",
        "bound_share_of_step": bound_s * 1e3 / step_ms,
        "max_memory_allocated_bytes": peak, "state_bytes": state_bytes,
        "profile": profile, "timing_losses": losses}

    # determinism, crash and resume, the full-state checkpoint
    root = ROOT / "build" / "train_smoke"
    shutil.rmtree(root, ignore_errors=True)
    loop = LoopConfig(total_steps=TRAIN_STEPS, ckpt_every=4)
    quiet = lambda msg: None        # noqa: E731
    torch.use_deterministic_algorithms(True)
    try:
        ck_a = CheckpointManager(str(root / "a"), keep=1)
        out_a = run_training(step, init_train_state(cfg, gen.manual_seed(SEED), opt, dev),
                             batch_fn, ck_a, loop, log=quiet)
        final = out_a["final_state"]
        la = out_a["losses"]
        check(len(la) == TRAIN_STEPS and all(np.isfinite(la)), f"olmo-1b losses {la}")
        check(np.mean(la[-3:]) < np.mean(la[:3]), f"olmo-1b: the loss did not fall: {la}")
        check(ck_a.all_steps() == [TRAIN_STEPS], f"checkpoints {ck_a.all_steps()}")
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        ck_a.save(TRAIN_STEPS, final)           # the snapshot is the synchronous part
        snapshot_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        ck_a.wait()
        write_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        restored = ck_a.restore(TRAIN_STEPS, like=final, device=dev)
        torch.cuda.synchronize(dev)
        restore_ms = (time.perf_counter() - t) * 1e3
        ckpt_bytes = sum(x.numel() * x.element_size() for _, x in flatten_tree(final))
        for (k, x), (_, y) in zip(flatten_tree(final), flatten_tree(restored)):
            check(x.dtype == y.dtype and x.device == y.device and torch.equal(x, y),
                  f"restored checkpoint: {k} differs")
        del restored
        shutil.rmtree(root / "a")

        ck_b = CheckpointManager(str(root / "b"), keep=1)
        start_b = init_train_state(cfg, gen.manual_seed(SEED), opt, dev)
        crashed = None
        try:
            run_training(step, start_b, batch_fn, ck_b,
                         dataclasses.replace(loop, fail_at_step=6), log=quiet)
        except RuntimeError as e:           # the injected crash, and nothing else
            if "injected failure at step 6" not in str(e):
                raise
            crashed = str(e)
        check(crashed is not None, "the run did not crash at step 6")
        out_b = run_training(step, start_b, batch_fn, ck_b, loop, log=quiet)
        del start_b
        check(out_b["resumed_from"] == 4, f"resumed from {out_b['resumed_from']}")
        for (k, x), (_, y) in zip(flatten_tree(final), flatten_tree(out_b["final_state"])):
            check(torch.equal(x, y), f"resumed run: {k} != the uninterrupted run's")
        check(out_b["losses"] == la[4:], f"resumed losses {out_b['losses']} != {la[4:]}")
        shutil.rmtree(root)
    finally:
        torch.use_deterministic_algorithms(False)
    det_ms = statistics.median(out_a["step_times"][1:]) * 1e3
    del final, out_a, out_b
    torch.cuda.empty_cache()
    out["olmo_1b"].update({
        "losses": la, "deterministic_ms_per_step": det_ms,
        "crash_resume": {"crashed": crashed, "resumed_from": 4, "bit_equal": True},
        "checkpoint": {"bytes": ckpt_bytes, "snapshot_ms": snapshot_ms, "write_ms": write_ms,
                       "restore_ms": restore_ms, "restored_bit_equal": True}})

    # (c) every trained step's lineage on the card
    walk = QuerySession(tp.index, use_hopcache=False, fused_walk=True)
    t = time.perf_counter()
    q2 = {s: tp.batch_to_documents(s, walk) for s in range(TRAIN_STEPS)}
    walk_s = time.perf_counter() - t
    check(walk.counters["fused_walk"] == TRAIN_STEPS, f"walk session {walk.counters}")
    for s in range(TRAIN_STEPS):
        check(torch.equal(q2[s], tp.batch_to_documents(s)),
              f"step {s}: the walk's Q2 != the default session's")
    docs = sorted({int(q2[s][0]) for s in range(4)} | {int(q2[0][-1])})[:4]
    check(len(docs) == 4, f"documents {docs}")
    for d in docs:
        want = [s for s in range(TRAIN_STEPS) if bool((q2[s] == d).any())]
        check(tp.document_to_batches(d) == want and tp.document_to_batches(d, walk) == want,
              f"document {d}: Q1 != the inverse of the Q2 answers {want}")
    consent = tp.index.datasets["corpus"].table.col("consent") > 0
    non_consenting = set(torch.nonzero(~consent).reshape(-1).tolist())
    flagged = {}
    for s in range(TRAIN_STEPS):
        got = {int(d) for d in q2[s] if not bool(consent[d])}
        check(got == non_consenting & set(q2[s].tolist()), f"step {s}: consent audit")
        flagged[s] = len(got)
    torch.cuda.synchronize(dev)
    counts = ops.launch_counts()
    check(counts.get("batched_walk", 0) > 0, f"the train path never launched batched_walk {counts}")
    out["lineage"] = {"steps": TRAIN_STEPS, "docs_per_batch": [len(q2[s]) for s in q2],
                      "walk_q2_s": walk_s, "walk_counters": dict(walk.counters),
                      "default_counters": dict(tp.index.session().counters),
                      "q1_documents": docs, "non_consenting_flagged": flagged}
    out["tolerances"] = {"card_vs_cpu": TRAIN_CPU_REL}
    out["seconds"] = time.perf_counter() - t_phase
    del tp, walk
    torch.cuda.empty_cache()
    return out, counts


# -- the mesh layer (phase 7m) ---------------------------------------------------
MESH_RANKS = 4              # ranks sharing the one card over gloo
MESH_CONFIGS = ("compas", "census", "tpcdi_sf20")
MESH_SMOKE = "qwen3-moe-235b-a22b"
MESH_DEADLINE_S = 420       # the spawned ranks' own deadline
MESH_SMOKE_REL = 1e-5       # the sharded smoke step against the plain one (float32)


def mesh_indexes(dev):
    """Compas, Census and the TPC-DI SF20 join captured on ``dev`` as the
    main path captures them: each rank of a mesh builds its own copy."""
    from repro_torch.core.pipeline import ProvenanceIndex
    from repro_torch.dataprep import usecases as U

    out = {}
    for name in ("compas", "census"):
        make, run = U.USECASES[name]
        idx = ProvenanceIndex(name, device=dev)
        sink = run(idx, make(device=dev)).dataset_id
        out[name] = (idx, idx.sources()[0], sink)
    jidx, jsink = tpcdi_join(20, dev)
    out["tpcdi_sf20"] = (jidx, "trade", jsink)
    return out


def census_relations(idx, src, sink):
    """Census's src -> sink relation split at its first op: the packed
    (src -> mid), (mid -> sink) and whole relations, the "a0" group codes
    and the packed mask of the sink's first half."""
    from repro_torch.core.compose import compose_chain
    from repro_torch.kernels import ref

    mid = idx.ops[0].output_id
    a, b, whole = (compose_chain(idx, x, y) for x, y in ((src, mid), (mid, sink), (src, sink)))
    group = idx.datasets[src].table.col("a0").to(torch.int32)
    n_dst = idx.datasets[sink].n_rows
    mask = torch.zeros(n_dst, dtype=torch.bool, device=a.device)
    mask[: n_dst // 2] = True
    return a, b, whole, group, ref.pack_bits(mask[None])[0]


def mesh_relation_run(mesh, rels):
    """``compose_sharded``, ``lineage_audit_sharded`` and
    ``backward_frontier_sharded`` on Census over ``mesh``: the whole
    results (the sharded ones gathered) and their host ms (synchronised,
    median of 7; collective, so every rank times the same calls)."""
    from repro_torch.core.distributed import (
        backward_frontier_sharded,
        compose_sharded,
        gather_rows,
        lineage_audit_sharded,
        shard_relation,
    )

    a, b, whole, group, mw = rels
    n = whole.shape[0]
    sa, sb, sw, sg = (shard_relation(x, mesh) for x in (a, b, whole, group))
    n_groups = int(group.max()) + 1
    composed = compose_sharded(sa, sb)
    counts = lineage_audit_sharded(sw, sg, mw, n_groups)
    frontier = backward_frontier_sharded(sw, mw)
    out = {"composed": gather_rows(composed)[:n], "counts": counts,
           "frontier": gather_rows(frontier)[:n], "local_rows": composed.to_local().shape[0]}
    times = {"compose_ms": host_ms(lambda: compose_sharded(sa, sb)),
             "audit_ms": host_ms(lambda: lineage_audit_sharded(sw, sg, mw, n_groups)),
             "frontier_ms": host_ms(lambda: backward_frontier_sharded(sw, mw))}
    return out, times


def mesh_collective_run(indexes, queries, n_shards, mesh=None):
    """Q1/Q2 (B = 64) of each configuration through the collective engine's
    walk (``use_hopcache=False``, ``fused_walk=False``: every hop is the
    engine's): the answers and their host ms (median of 3)."""
    from repro_torch.provenance import QuerySession, ShardedProvenanceIndex, prov

    out, times = {}, {}
    for name in MESH_CONFIGS:
        idx, src, sink = indexes[name]
        sv = ShardedProvenanceIndex(idx, n_shards, engine="collective", mesh=mesh)
        check(sv.engine_name == "collective", f"{name}: engine {sv.engine_name}")
        ss = QuerySession(sv, use_hopcache=False, fused_walk=False)
        p1 = prov(sv).source(src).rows_batch(queries[name]["q1"]).forward().to(sink).plan()
        p2 = prov(sv).source(sink).rows_batch(queries[name]["q2"]).backward().to(src).plan()
        out[name] = (ss.run(p1), ss.run(p2))
        times[name] = {"q1_ms": host_ms(lambda: ss.run(p1), reps=3),
                       "q2_ms": host_ms(lambda: ss.run(p2), reps=3)}
    return out, times


def mesh_sequential(indexes, queries, n_shards):
    """The same Q1/Q2 through the sequential engine (a comparison)."""
    from repro_torch.provenance import QuerySession, ShardedProvenanceIndex, prov

    out = {}
    for name in MESH_CONFIGS:
        idx, src, sink = indexes[name]
        sv = ShardedProvenanceIndex(idx, n_shards, engine="numpy")
        ss = QuerySession(sv, use_hopcache=False, fused_walk=False)
        out[name] = (
            ss.run(prov(sv).source(src).rows_batch(queries[name]["q1"]).forward().to(sink).plan()),
            ss.run(prov(sv).source(sink).rows_batch(queries[name]["q2"]).backward().to(src)
                   .plan()))
    return out


def same_answers(got, want, what: str) -> None:
    for g_q, w_q, q in zip(got, want, ("Q1", "Q2")):
        check(len(g_q) == len(w_q), f"{what} {q}: batch size")
        for x, y in zip(g_q, w_q):
            check(torch.equal(x.cpu(), y.cpu()), f"{what} {q}: answers differ")


def mesh_smoke_step(dev, world, mesh):
    """Two float32 steps of the qwen3-moe smoke (batch 8 x 16, ``n_micro``
    2) on a (world, 1) mesh, the state placed by ``state_pspecs``,
    ``moe_groups`` = world, against the plain steps under the same policy:
    loss and grad norm within ``MESH_SMOKE_REL``, the first moment within
    1e-4 of each leaf's largest.  Returns the errors and the sharded
    step's ms."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import sharding as SD
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import pshard as PS
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    cfg = get_smoke_config(MESH_SMOKE)
    opt = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=4, moment_dtype=torch.float32)
    policy = {"dp": ("data",), "tp": "model", "moe_groups": world}
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg.vocab, (8, 16))
    batch = {"tokens": torch.from_numpy(toks).to(dev),
             "labels": torch.from_numpy(np.concatenate([toks[:, 1:], -np.ones((8, 1), np.int64)],
                                                       axis=1)).to(dev)}
    step = make_train_step(cfg, opt, n_micro=2, dtype=torch.float32)
    with PS.use_policy(policy):
        plain = init_train_state(cfg, torch.Generator(device=dev).manual_seed(SEED), opt, dev)
        plain_mets = []
        for _ in range(2):
            plain, met = step(plain, batch)
            plain_mets.append(met)
    with use_mesh(mesh), PS.use_policy(policy):
        state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(SEED), opt, dev)
        state = SD.place(state, SD.to_shardings(SD.state_pspecs(cfg, state, mesh), mesh))
        sbatch = SD.place(batch, SD.to_shardings(SD.batch_pspecs(batch, mesh), mesh))
        mets = []
        for _ in range(2):
            sync(dev)
            t = time.perf_counter()
            state, met = step(state, sbatch)
            sync(dev)
            mets.append((met, (time.perf_counter() - t) * 1e3))
    errs = {f"{k}_{i}": rel_err(torch.as_tensor(float(m[k])), torch.as_tensor(float(p[k])))
            for i, ((m, _), p) in enumerate(zip(mets, plain_mets)) for k in ("loss", "grad_norm")}
    check(max(errs.values()) <= MESH_SMOKE_REL, f"sharded smoke step vs plain: {errs}")
    full = {n: (v.full_tensor() if isinstance(v, DTensor) else v)
            for n, v in state.opt.mu.items()}
    errs["mu"] = close_after_step(full, plain.opt.mu, 1e-4, "sharded smoke mu")
    sharded = [n for n, p in state.params.named_parameters()
               if any(pl.is_shard() for pl in p.placements)]
    check(world == 1 or sharded, "no parameter is sharded")
    return {"device": str(dev), "errors": errs, "sharded_leaves": len(sharded),
            "step_ms": [ms for _, ms in mets]}


def mesh_rank(rank, world, root, queries, device_type="cuda"):
    """One of MESH_RANKS spawned ranks sharing the card over gloo (CUDA
    tensors staged through the host): the collective engine at n_shards =
    world on Compas, Census and SF20, Census's composition, audit and
    frontier (of the relations the parent saved) on a ("data",) mesh, and
    the qwen3-moe smoke's sharded step at (world, 1) on the rank's CPU.
    Saves its answers, digests, times and launch counts."""
    import hashlib

    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_world, make_local_mesh, make_mesh

    dev = torch.device(device_type, 0) if device_type == "cuda" else torch.device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_world(rank, world, store=dist.FileStore(str(Path(root) / "store"), world),
               device_type=dev.type, backend="gloo")
    try:
        print(f"mesh rank {rank}: capture", file=sys.stderr, flush=True)
        indexes = mesh_indexes(dev)
        # the parent's Census relations (four ranks composing them at once
        # would each pass through an 8 GB dense transient)
        rels = tuple(x.to(dev) for x in torch.load(Path(root) / "census.pt"))
        sync(dev)
        ops.reset_launch_counts()           # this rank's mesh path starts here
        print(f"mesh rank {rank}: collective engine", file=sys.stderr, flush=True)
        answers, q_times = mesh_collective_run(indexes, queries, world)
        print(f"mesh rank {rank}: Census relations", file=sys.stderr, flush=True)
        local = make_local_mesh(dev.type)
        rel_out, rel_times = mesh_relation_run(local, rels)
        print(f"mesh rank {rank}: smoke step", file=sys.stderr, flush=True)
        # on this rank's CPU: DTensor's all-gather (FSDP's parameters, the
        # embedding's backward) does not run on gloo with CUDA tensors in
        # torch 2.11 (``_c10d_functional.all_gather_into_tensor`` ends in a
        # segfault), and NCCL refuses two ranks on one card
        smoke = mesh_smoke_step(torch.device("cpu"), world,
                                make_mesh((world, 1), ("data", "model"), "cpu"))
        sync(dev)
        counts = ops.launch_counts()
        seq = mesh_sequential(indexes, queries, world)
        for name in MESH_CONFIGS:
            same_answers(answers[name], seq[name], f"rank {rank} {name}: collective vs sequential")
        digest = {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()
                  for k, v in rel_out.items() if isinstance(v, torch.Tensor)}
        torch.save({"answers": {n: tuple([x.cpu() for x in q] for q in a)
                                for n, a in answers.items()} if rank == 0 else None,
                    "digest": digest, "local_rows": rel_out["local_rows"],
                    "q_times": q_times, "rel_times": rel_times, "smoke": smoke,
                    "counts": counts}, Path(root) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def mesh_phase(dev, indexes, queries, answers):
    """The mesh layer.  (a) World size 1 on NCCL (a real process group):
    Census's relation composed with ``compose_sharded`` equals
    ``ops.bitmatmul`` of the whole and ``dataset_lineage``'s packed relation,
    its audit and frontier a plain count on the card and the CPU port's;
    the collective engine at n_shards 1 equals the merged index's Q1/Q2 on
    Compas, Census and SF20; OLMo-1B's train_4k-cut step on a (1, 1)
    ("data", "model") mesh, the state placed by ``state_pspecs``, equals
    the plain step bit for bit under deterministic algorithms; that state
    saved and restored with ``shardings=`` onto the mesh, bit for bit.
    (b) MESH_RANKS spawned ranks on the one card over gloo
    (``mesh_rank``): the engine's answers equal the merged index's and
    the sequential engine's, the Census results world size 1's, and the
    qwen3-moe smoke's sharded step (on each rank's CPU) the plain one.  Returns the results
    and the path's launch counts (this process's and every rank's)."""
    import hashlib
    import shutil

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.configs.registry import get_config
    from repro_torch.core.distributed import backward_frontier_sharded, lineage_audit_sharded
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import sharding as SD
    from repro_torch.launch.mesh import init_world, make_local_mesh, make_mesh, use_mesh
    from repro_torch.models import pshard as PS
    from repro_torch.train import AdamWConfig, CheckpointManager, init_train_state, make_train_step
    from repro_torch.train.checkpoint import flatten_tree

    t_phase = time.perf_counter()
    out = {}
    root = ROOT / "build" / "mesh_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    census = indexes["census"]
    rels = census_relations(*census)
    a, b, whole, group, mw = rels
    n = whole.shape[0]
    want_whole = ops.bitmatmul(a, b)                     # comparisons: before the path
    check(torch.equal(want_whole, whole), "Census: bitmatmul of the whole != dataset_lineage")
    hits = ref.popcount32(whole & mw[None, :]).sum(dim=1) > 0
    want_counts = torch.bincount(group[hits].long(), minlength=int(group.max()) + 1)
    cpu_counts = lineage_audit_sharded(whole.cpu(), group.cpu(), mw.cpu(), int(group.max()) + 1)
    cpu_frontier = backward_frontier_sharded(whole.cpu(), mw.cpu())

    # (a) world size 1, NCCL
    backend = init_world(0, 1, store=dist.HashStore(), device_type=dev.type)
    try:
        sync(dev)
        ops.reset_launch_counts()       # the mesh path starts here
        local = make_local_mesh(dev.type)
        rel_out, rel_times = mesh_relation_run(local, rels)
        coll, coll_times = mesh_collective_run(indexes, queries, 1)
        cfg = get_config("olmo-1b")
        opt = AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
        step = make_train_step(cfg, opt, n_micro=2, q_chunk=0)
        rng = np.random.default_rng(SEED)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ))).to(dev)
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
        mesh = make_mesh((1, 1), ("data", "model"), dev.type)
        policy = {"dp": ("data",), "tp": "model"}
        torch.use_deterministic_algorithms(True)
        try:
            gen = torch.Generator(device=dev)
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            plain, plain_met = step(init_train_state(cfg, gen.manual_seed(SEED), opt, dev), batch)
            sync(dev)
            t = time.perf_counter()
            plain, plain_met = step(plain, batch)
            sync(dev)
            plain_ms = (time.perf_counter() - t) * 1e3
            plain_peak = torch.cuda.max_memory_allocated(dev) - held
            # the plain state stays beside the sharded one: its steps' cached
            # blocks go back to the card first (the sharded step allocates no
            # more than the plain one, tools/olmo_mesh_step.py; the blocks the
            # earlier phases left cached did not fit its sizes)
            torch.cuda.empty_cache()
            # the sharded step's peak above what is held beside it (the plain state)
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            with use_mesh(mesh), PS.use_policy(policy):
                state = init_train_state(cfg, gen.manual_seed(SEED), opt, dev)
                sh = SD.to_shardings(SD.state_pspecs(cfg, state, mesh), mesh)
                state = SD.place(state, sh)
                sbatch = SD.place(batch, SD.to_shardings(SD.batch_pspecs(batch, mesh), mesh))
                state, met = step(state, sbatch)
                sync(dev)
                t = time.perf_counter()
                state, met = step(state, sbatch)
                sync(dev)
                sharded_ms = (time.perf_counter() - t) * 1e3
                sharded_peak = torch.cuda.max_memory_allocated(dev) - held
        finally:
            torch.use_deterministic_algorithms(False)
        sync(dev)
        counts = ops.launch_counts()
        check(float(met["loss"]) == float(plain_met["loss"]),
              f"sharded OLMo step loss {float(met['loss'])} != {float(plain_met['loss'])}")
        for (k, x), (_, y) in zip(flatten_tree(state), flatten_tree(plain)):
            check(torch.equal(x.full_tensor(), y), f"sharded OLMo step: {k} != the plain step's")
        del plain
        ck = CheckpointManager(str(root / "ckpt"), keep=1)
        t = time.perf_counter()
        ck.save(2, state, blocking=True)
        save_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        restored = ck.restore(2, like=state, device=dev, shardings=sh)
        sync(dev)
        restore_ms = (time.perf_counter() - t) * 1e3
        for (k, x), (_, y) in zip(flatten_tree(state), flatten_tree(restored)):
            check(y.placements == x.placements and torch.equal(x.full_tensor(), y.full_tensor()),
                  f"restored sharded checkpoint: {k} differs")
        ckpt_bytes = sum(x.numel() * x.element_size() for _, x in flatten_tree(state))
        del state, restored, sbatch, batch
        shutil.rmtree(root / "ckpt")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    check(torch.equal(rel_out["composed"], whole), "compose_sharded != dataset_lineage")
    check(torch.equal(rel_out["counts"].cpu(), want_counts.to(torch.int32).cpu())
          and torch.equal(rel_out["counts"].cpu(), cpu_counts), "sharded audit != plain count")
    check(torch.equal(rel_out["frontier"], hits)
          and torch.equal(rel_out["frontier"].cpu(), cpu_frontier), "sharded frontier")
    for name in MESH_CONFIGS:
        same_answers(coll[name], answers[name], f"{name}: collective engine (1 rank) vs merged")
    world1 = {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()
              for k, v in rel_out.items() if isinstance(v, torch.Tensor)}
    out["world_1"] = {
        "backend": backend, "census_bits": [n, n], "census_bytes": whole.numel() * 4,
        "census_groups": [int(x) for x in want_counts.tolist()],
        **rel_times, "collective": coll_times,
        "olmo_1b_step": {"seq": TRAIN_SEQ, "global_batch": TRAIN_BATCH, "n_micro": 2,
                         "plain_ms": plain_ms, "sharded_ms": sharded_ms,
                         "plain_peak_bytes": plain_peak, "sharded_peak_bytes": sharded_peak,
                         "loss": float(met["loss"]), "bit_equal": True,
                         "checkpoint": {"bytes": ckpt_bytes, "save_ms": save_ms,
                                        "restore_ms": restore_ms, "bit_equal": True}}}
    del rel_out, coll

    # (b) MESH_RANKS ranks on the one card, gloo with CUDA tensors
    torch.save(tuple(x.cpu() for x in rels), root / "census.pt")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ctx = mp.start_processes(mesh_rank, args=(MESH_RANKS, str(root), {
        n: queries[n] for n in MESH_CONFIGS}, dev.type), nprocs=MESH_RANKS, join=False,
        start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            check(time.perf_counter() - t < MESH_DEADLINE_S,
                  f"the {MESH_RANKS} mesh ranks still run after {MESH_DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(MESH_RANKS)]
    spawn_s = time.perf_counter() - t
    for name in MESH_CONFIGS:
        same_answers(ranks[0]["answers"][name], answers[name],
                     f"{name}: collective engine ({MESH_RANKS} ranks) vs merged")
    for r, res in enumerate(ranks):
        check(res["digest"] == world1, f"rank {r}: Census results != world size 1's")
        check(res["local_rows"] == -(-n // MESH_RANKS), f"rank {r}: {res['local_rows']} rows")
        for k, v in res["counts"].items():
            counts[k] = counts.get(k, 0) + v
    shutil.rmtree(root)
    out[f"world_{MESH_RANKS}"] = {
        "backend": "gloo (CUDA tensors through the host)", "seconds": spawn_s,
        "collective": ranks[0]["q_times"], **ranks[0]["rel_times"],
        "smoke_step": {r: res["smoke"] for r, res in enumerate(ranks)},
        "launch_counts_by_rank": [res["counts"] for res in ranks]}
    check(counts.get("bitmatmul", 0) > 0, f"the mesh path never launched bitmatmul {counts}")
    out["tolerances"] = {"smoke_step": MESH_SMOKE_REL, "smoke_mu": 1e-4, "everything_else": 0}
    out["seconds"] = time.perf_counter() - t_phase
    return out, counts


# -- the dry-run accounting (phase 7n) ------------------------------------------
DRYRUN_CELLS = [("olmo-1b", shape, "single") for shape in
                ("train_4k", "prefill_32k", "decode_32k", "long_500k")] + \
    [("llama3-405b", "train_4k", "multi")]
DRYRUN_PEAK_REL = 0.20      # predicted peak (arguments + temp) against the card's


def cell_bound_ms(stats) -> dict:
    """The card's least time for an accounted step: dot FLOPs over the bf16
    peak or traffic over the memory rate, the larger."""
    ops_ms = stats["dot_flops"] / BF16_PEAK_FLOPS * 1e3
    bytes_ms = stats["traffic_bytes"] / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def dryrun_phase(dev):
    """The dry-run accounting (``launch/{hloanal,dryrun,perf}.py``).  (a)
    OLMo-1B at train_4k's settings cut to global batch 8 (seq 4,096,
    ``n_micro`` 2) on a (1, 1) mesh over a fake process group of one rank:
    its argument bytes equal the bytes of the real ``TrainState`` and batch
    on the card, exactly; its dot FLOPs equal ``train_step_flops``'s count,
    exactly, with remat off and with remat on, where they also equal the
    remat-off count plus each block's forward less its last product
    (:func:`remat_recompute_flops`, from the config: checkpointing stops its
    recompute after the last tensor the backward needs; 1.2477x at
    OLMo-1B's widths); the
    predicted peak (arguments + temp) is within DRYRUN_PEAK_REL
    of ``max_memory_allocated`` over two real steps; the bound beside the
    measured ms a step.  (b) ``run_cell`` on OLMo-1B's four shapes on the
    single mesh (256 fake ranks) and llama3-405b's train_4k on the multi
    mesh (512): status ``ok`` or the skip ``cell_skip_reason`` gives,
    per-device memory, FLOPs, collective bytes and bound.  (c) ``perf``'s
    ``lowmem`` on OLMo-1B train_4k single: its temp below ``base``'s (the
    ``base`` record is (b)'s cell).  Returns the results and the path's
    launch counts (none: nothing here launches a kernel)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import perf as PF
    from repro_torch.launch import shapes as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step
    from repro_torch.train.checkpoint import flatten_tree

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    out = {}

    # (a) the cell the train phase runs, accounted on a (1, 1) mesh
    cfg = get_config("olmo-1b")
    opt = AdamWConfig()
    cut = dict(n_micro_override=2, global_batch=TRAIN_BATCH)
    check(SH.SHAPES["train_4k"].seq_len == TRAIN_SEQ and SH.q_chunk("olmo-1b", "train_4k") == 0,
          "train_4k is not the train phase's cell")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        on = DR.lower_cell("olmo-1b", "train_4k", mesh, **cut)
        off = DR.lower_cell("olmo-1b", "train_4k", mesh, cfg_overrides={"remat": False}, **cut)
    finally:
        dist.destroy_process_group()
    flops = train_step_flops(cfg, opt, 2, TRAIN_BATCH, TRAIN_SEQ)
    check(off.stats.dot_flops == flops,
          f"dot FLOPs with remat off {off.stats.dot_flops} != train_step_flops {flops}")
    remat_flops = train_step_flops(cfg, opt, 2, TRAIN_BATCH, TRAIN_SEQ, remat=True)
    check(on.stats.dot_flops == remat_flops,
          f"dot FLOPs with remat {on.stats.dot_flops} != FlopCounterMode's {remat_flops}")
    # the recompute itself, from the config: no count of the step can pass
    # for it if checkpointing recomputed nothing
    recompute = remat_recompute_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    check(on.stats.dot_flops == flops + recompute,
          f"dot FLOPs with remat {on.stats.dot_flops} != {flops} + the blocks' recompute "
          f"{recompute}")
    remat_ratio = on.stats.dot_flops / off.stats.dot_flops

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(SEED), opt, dev)
    toks = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(SEED))
    batch = {"tokens": toks, "labels": toks}
    real_args = sum(t.numel() * t.element_size() for _, t in flatten_tree(state)) + \
        sum(t.numel() * t.element_size() for t in batch.values())
    ma = on.memory_analysis()
    check(ma.argument_size_in_bytes == real_args,
          f"argument bytes {ma.argument_size_in_bytes} != the card's state and batch {real_args}")
    step = make_train_step(cfg, opt, n_micro=2, q_chunk=0)
    seconds = []
    for _ in range(3):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize(dev)
        seconds.append(time.perf_counter() - t)
    check(bool(torch.isfinite(met["loss"])), f"loss {met['loss']}")
    peak = torch.cuda.max_memory_allocated(dev) - base
    del state, met
    torch.cuda.empty_cache()
    predicted = ma.argument_size_in_bytes + ma.temp_size_in_bytes
    check(abs(predicted / peak - 1) <= DRYRUN_PEAK_REL,
          f"predicted peak {predicted} vs the card's {peak}")
    step_ms = statistics.median(seconds[1:]) * 1e3
    out["train_cut"] = {
        "cell": "olmo-1b train_4k", "reduced": {"global_batch": [256, TRAIN_BATCH]},
        "n_micro": on.n_micro, "remat": cfg.remat_policy, "accounting_s": [on.seconds, off.seconds],
        "memory": dataclasses.asdict(ma), "dot_flops_remat": on.stats.dot_flops,
        "dot_flops_no_remat": off.stats.dot_flops, "train_step_flops": flops,
        "remat_ratio": remat_ratio, "remat_recompute_flops": recompute,
        "traffic_bytes": on.stats.traffic_bytes,
        "real_argument_bytes": real_args, "predicted_peak_bytes": predicted,
        "max_memory_allocated_bytes": peak, "peak_ratio": predicted / peak,
        "ms_per_step": step_ms, "step_ms_all": [x * 1e3 for x in seconds],
        **cell_bound_ms(on.stats.as_dict())}

    # (b) production cells on 256 and 512 fake ranks
    cells = {}
    for mesh_name in ("single", "multi"):
        with DR.fake_production_mesh(mesh_name, "cuda") as mesh:
            for arch, shape, m in DRYRUN_CELLS:
                if m != mesh_name:
                    continue
                t = time.perf_counter()
                rec = DR.run_cell(arch, shape, mesh, mesh_name)
                rec["seconds"] = time.perf_counter() - t
                want = SH.cell_skip_reason(arch, shape)
                check(rec["status"] == ("skip" if want else "ok") and rec.get("reason") == want,
                      f"{arch} {shape} {mesh_name}: {rec['status']} {rec.get('error', '')}")
                if rec["status"] == "ok":
                    rec.update(cell_bound_ms(rec["hlo"]))
                    rec["fits_80gb"] = (rec["memory"]["argument_size_in_bytes"]
                                        + rec["memory"]["temp_size_in_bytes"]) < 80e9
                cells[f"{arch}/{shape}/{mesh_name}"] = rec
            if mesh_name == "single":
                # (c) perf's lowmem against base (the single-mesh train cell)
                t = time.perf_counter()
                lowmem = PF.run_variant("olmo-1b", "train_4k", mesh, "lowmem")
                lowmem["seconds"] = time.perf_counter() - t
    base_rec = cells["olmo-1b/train_4k/single"]
    check(lowmem["memory"]["temp_size_in_bytes"] < base_rec["memory"]["temp_size_in_bytes"],
          f"lowmem temp {lowmem['memory']} >= base {base_rec['memory']}")
    out["cells"] = cells
    out["perf"] = {"base": {"memory": base_rec["memory"], "hlo": base_rec["hlo"]},
                   "lowmem": lowmem}
    out["tolerances"] = {"argument_bytes": 0, "flops_no_remat": 0, "flops_remat": 0,
                         "peak_rel": DRYRUN_PEAK_REL}
    out["seconds"] = time.perf_counter() - t_phase
    counts = ops.launch_counts()
    return out, counts


# -- the examples (phase 7o) -----------------------------------------------------
EXAMPLES = {
    "quickstart": ([], ["Q2  output record 0 derives from", "run_many fused", "session stats"]),
    "fairness_audit": ([], ["all three methods agree",
                            "impact closure matches the composed relation"]),
    "erasure_audit": ([], ["RecomputePlan", "rebuild order:", "stale cached relations dropped:",
                           "what-if: zero ingest row 0's income",
                           "without rerunning the pipeline"]),
    "streaming_lineage": ([], ["after 40 appended ops: extends=", "spilled to disk",
                               "faulted back: rehydrations=",
                               "bounded: composed-relation residency stayed under"]),
    "federated_lineage": ([], ["capability: prep index is read-only from the serving tier",
                               "traces to raw user row", "batch trace-to-source:",
                               "federation stats:"]),
    "serve_with_lineage": ([], ["response row 2 derives from request row",
                                "session stats (shared composed relations)",
                                "federation stats (single-entry catalog)"]),
    "train_with_provenance": (["--tiny", "--steps", "4"],
                              ["corpus: 1024 docs ->", "worst-loss batch = step",
                               "consent audit:", "final provenance index:"]),
}


def examples_phase(dev):
    """The seven examples of ``examples/torch`` on the card, each through its
    ``main(argv)`` in this process (no ``--device``: the card), its output
    captured: each prints its landmarks; ``train_with_provenance`` at
    ``--tiny`` for 4 steps, its checkpoints under ``build/examples_smoke/``
    (removed after).  Returns each example's seconds and launch counts and
    the path's launch counts."""
    import contextlib
    import importlib.util
    import io
    import shutil

    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    ckpt = ROOT / "build" / "examples_smoke"
    shutil.rmtree(ckpt, ignore_errors=True)
    ops.reset_launch_counts()
    runs = {}
    for name, (argv, landmarks) in EXAMPLES.items():
        spec = importlib.util.spec_from_file_location(
            f"example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        if name == "train_with_provenance":
            argv = [*argv, "--ckpt-dir", str(ckpt)]
        before = ops.launch_counts()
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            module.main(argv)
        torch.cuda.synchronize(dev)
        text = buf.getvalue()
        missing = [m for m in landmarks if m not in text]
        check(not missing, f"examples/torch/{name}.py: no {missing} in\n{text[-2000:]}")
        after = ops.launch_counts()
        runs[name] = {"seconds": time.perf_counter() - t, "lines": text.count("\n"),
                      "launch_counts": {k: after.get(k, 0) - before.get(k, 0) for k in after}}
    shutil.rmtree(ckpt, ignore_errors=True)
    counts = ops.launch_counts()
    for k in ("batched_walk", "bitmatmul"):
        check(counts.get(k, 0) > 0, f"the examples never launched {k}: {counts}")
    return {"examples": runs, "seconds": time.perf_counter() - t_phase}, counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 2
    # routing runs on the cost model's defaults: point the calibration file
    # at a path inside the checkout that is never written
    os.environ["REPRO_TORCH_CALIBRATION"] = str(ROOT / "build" / "no_calibration.json")

    from repro_torch.core import calibrate
    from repro_torch.core.hopcache import ComposedIndex
    from repro_torch.core.pipeline import ProvenanceIndex
    from repro_torch.core.query import (
        forward_record_masks_batch,
        fused_walk_record_masks_batch,
    )
    from repro_torch.dataprep import usecases as U
    from repro_torch.dataprep.tracked import track
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.batched_walk import batched_walk_cuda, walk_geometry
    from repro_torch.kernels.bitmatmul import SLICE_WORDS, bitmatmul_cuda, bitmatmul_geometry
    from repro_torch.kernels.bitset_rank import bitset_rank_cuda
    from repro_torch.kernels.lineage_gather import lineage_gather_cuda
    from repro_torch.provenance import QuerySession, prov

    t_start = time.perf_counter()
    dev = DEV

    # -- 1. environment --------------------------------------------------------
    cap = torch.cuda.get_device_capability(dev)
    card = smi()
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(dev),
          "capability": list(cap), "count": torch.cuda.device_count(), "nvidia_smi": card})
    check(cap >= (9, 0), f"capability {cap} < (9, 0)")

    # -- 2. build ----------------------------------------------------------------
    t = time.perf_counter()
    libs = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "libs": {k: str(v.relative_to(ROOT)) for k, v in libs.items()}})
    check({"batched_walk", "bitmatmul", "bitset_rank", "lineage_gather"} <= set(libs),
          f"missing kernel libraries: {sorted(libs)}")

    # -- 3. each kernel against its plain version (synthetic sweeps) ------------
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand_bits(rows, cols, dens):
        return ref.pack_bits(torch.rand(rows, cols, generator=gen, device=dev) < dens)

    widths = (1, 31, 33, 1000, 7214)
    walk_err = 0
    n_cases = 0
    for k in (1, 3, 7):
        for b in (1, 8, 64, 257):
            for di, dens in enumerate((0.0, 1e-3, 0.05, 0.5)):
                dims = [widths[(i + k + b + di) % len(widths)] for i in range(k + 1)]
                planes = [rand_bits(dims[j], dims[j + 1], dens) for j in range(k)]
                mask = rand_bits(b, dims[0], max(dens, 0.01))
                out, cnt = batched_walk_cuda(mask, planes)
                want_out, want_cnt = ref.batched_walk_ref(mask, planes)
                torch.cuda.synchronize()
                err = max(word_err(out, want_out), int((cnt - want_cnt).abs().max()))
                check(err == 0, f"batched_walk != plain at K={k} B={b} dims={dims} density={dens}")
                walk_err = max(walk_err, err)
                n_cases += 1

    # the redesigned kernel's edges: row lists past their capacity (density
    # 0.5 at 7214 and 32561 rows: ~3600 and ~16,000 rows a probe per hop),
    # probe blocks of 2, 4 and 8 with B not a multiple of them, one and 64
    # hops, word counts that the threads of a slice do not divide
    edge_cases = [
        (64, [7214, 7214, 7214], 0.5),
        (1100, [7214, 7214, 7214], 0.5),
        (64, [32561, 32561, 32561], 0.5),
        (1100, [32561, 32561], 0.5),
        (301, [1000, 7214, 33, 6907], 0.05),
        (601, [6907, 7214, 1000], 0.05),
        (1100, [7214, 1], 0.5),
        (1100, [33, 7214], 0.05),
        (64, [widths[i % len(widths)] for i in range(65)], 0.05),
        (1100, [widths[i % 4] for i in range(65)], 0.5),
        (257, [1000, 1000], 1e-3),
    ]
    geometries = set()
    for b, dims, dens in edge_cases:
        k = len(dims) - 1
        planes = [rand_bits(dims[j], dims[j + 1], dens) for j in range(k)]
        mask = rand_bits(b, dims[0], dens)
        out, cnt = batched_walk_cuda(mask, planes)
        want_out, want_cnt = ref.batched_walk_ref(mask, planes)
        torch.cuda.synchronize()
        err = max(word_err(out, want_out), int((cnt - want_cnt).abs().max()))
        check(err == 0, f"batched_walk != plain at K={k} B={b} dims={dims[:4]} density={dens}")
        walk_err = max(walk_err, err)
        geometries.add(walk_geometry(b, max(p.shape[1] for p in [mask, *planes])))
        n_cases += 1
        del planes, mask, want_out, out
    check({g.block_b for g in geometries} == {1, 2, 4, 8} and max(g.slices for g in geometries) > 1,
          f"edge geometries {sorted(geometries)}")
    emit({"phase": "kernel_vs_plain", "kernel": "batched_walk", "cases": n_cases,
          "max_abs_err": walk_err, "tolerance": 0,
          "edge_geometries": sorted(list(g) for g in geometries)})

    bm_err = 0
    n_cases = 0
    for m in (0, 1, 8, 64, 257):
        for k in (1, 31, 33, 1000, 7214):
            for n in (1, 33, 1000, 6907):
                for dens in (0.0, 0.01, 0.5):
                    a = rand_bits(m, k, dens)
                    if m > 1:
                        a[m // 2] = 0                           # an empty row
                    if k % 32 and m:
                        a[:, -1] |= torch.tensor(-(1 << 31), dtype=torch.int32, device=dev)
                    bb = rand_bits(k, n, dens)
                    err = word_err(bitmatmul_cuda(a, bb), ref.bitmatmul_ref(a, bb))
                    check(err == 0, f"bitmatmul != plain at M={m} K={k} N={n} density={dens}")
                    bm_err = max(bm_err, err)
                    n_cases += 1

    # the redesigned kernel's edges: M = 64 on the 2-D grid (slices of 32
    # words, the last one ragged), dense tiles whose row list overflows
    # (K = 32561 at density 0.5), and ragged last A tiles at the Compas and
    # Census composition shapes with one bit per row of A
    def one_bit_rows(m, k, hit=0.9):
        cols = torch.randint(0, k, (m,), generator=gen, device=dev)
        dense = torch.zeros((m, k), dtype=torch.bool, device=dev)
        dense[torch.arange(m, device=dev), cols] = torch.rand(m, generator=gen, device=dev) < hit
        return ref.pack_bits(dense)

    bm_geometries = set()
    for m, k, n, dens in ((64, 7214, 6907, 0.0011), (64, 7214, 32561, 0.0011),
                          (64, 32561, 1000, 0.5), (257, 32561, 8193, 0.01),
                          (264, 1000, 8193, 0.05), (800, 7214, 6907, 0.01),
                          (1100, 7214, 6907, 0.01), (2113, 1000, 12000, 0.01),
                          (7214, 6907, 6907, None),
                          (7217, 6907, 6907, None), (7214, 6907, 6907, 0.01),
                          (32561, 32561, 32561, None)):
        a = one_bit_rows(m, k) if dens is None else rand_bits(m, k, dens)
        bb = rand_bits(k, n, 0.05 if dens is None else dens)
        err = word_err(bitmatmul_cuda(a, bb), ref.bitmatmul_ref(a, bb))
        torch.cuda.synchronize()
        check(err == 0, f"bitmatmul != plain at M={m} K={k} N={n} density={dens}")
        bm_err = max(bm_err, err)
        bm_geometries.add(bitmatmul_geometry(m, bb.shape[1]))
        n_cases += 1
        del a, bb
    # the attribute walk's shapes: A = B probes of 1-4 words of attributes
    # (bits past K set, an empty row), B = an attribute plane of 1-104 rows
    # and 1-4 words, its last word ragged
    attr_geometries = set()
    for k in (1, 8, 15, 24, 33, 40, 53, 60, 96, 104):
        for nw in (1, 2, 3, 4):
            for dens in (0.05, 0.5):
                a = rand_bits(B, k, dens)
                a[B // 2] = 0
                if k % 32:
                    a[:, -1] |= torch.tensor(-(1 << 31), dtype=torch.int32, device=dev)
                bb = rand_bits(k, 32 * nw - 3 * nw, dens)
                err = word_err(bitmatmul_cuda(a, bb), ref.bitmatmul_ref(a, bb))
                check(err == 0, f"bitmatmul != plain at attribute shape K={k} Nw={nw}")
                bm_err = max(bm_err, err)
                attr_geometries.add(bitmatmul_geometry(B, bb.shape[1]))
                n_cases += 1
    torch.cuda.synchronize()
    bm_geometries |= attr_geometries
    check({g.slice_words for g in bm_geometries} == set(SLICE_WORDS),
          f"edge geometries {sorted(bm_geometries)}")
    emit({"phase": "bitmatmul_vs_plain", "cases": n_cases, "max_abs_err": bm_err,
          "tolerance": 0, "edge_geometries": sorted(list(g) for g in bm_geometries),
          "attribute_geometries": sorted(list(g) for g in attr_geometries)})

    rank_err = 0
    n_cases = 0
    for w in (0, 1, 7, 8192, 8193, 14464, 100000):
        for q in (1, 2, 64, 257):
            words = torch.randint(-(1 << 31), (1 << 31) - 1, (w,), generator=gen, device=dev,
                                  dtype=torch.int64).to(torch.int32)
            pos = torch.randint(-3, 32 * w + 40, (q,), generator=gen, device=dev,
                                dtype=torch.int64).to(torch.int32)
            err = int((bitset_rank_cuda(words, pos) - ref.bitset_rank_ref(words, pos)).abs().max())
            check(err == 0, f"bitset_rank != plain at W={w} Q={q}")
            rank_err = max(rank_err, err)
            n_cases += 1
    edge_cases, edge_err, rank_geometries = rank_sweep(bitset_rank_cuda, gen, dev)
    torch.cuda.synchronize()
    rank_err = max(rank_err, edge_err)
    check({g.launches for g in rank_geometries} == {1, 2}
          and any(g.answer_ctas > g.tiles > 1 for g in rank_geometries),
          f"rank edge geometries {sorted(rank_geometries)}")
    emit({"phase": "bitset_rank_vs_plain", "cases": n_cases + edge_cases, "max_abs_err": rank_err,
          "tolerance": 0, "edge_cases": edge_cases,
          "edge_geometries": sorted(list(g) for g in rank_geometries)})

    gather_err = 0
    n_cases = 0
    for r in (1, 5, 300):
        for max_deg_hi in (1, 40):
            for md in (1, 3, 33, 100):
                for q in (1, 7, 64, 257):
                    deg = torch.randint(0, max_deg_hi, (r,), generator=gen, device=dev)
                    rp = torch.zeros(r + 1, dtype=torch.int32, device=dev)
                    rp[1:] = torch.cumsum(deg, 0)
                    col = torch.randint(0, 1000, (int(rp[-1]) + md,), generator=gen,
                                        device=dev, dtype=torch.int64).to(torch.int32)
                    qs = torch.randint(-1, r + 1, (q,), generator=gen, device=dev,
                                       dtype=torch.int64).to(torch.int32)
                    err = int((lineage_gather_cuda(qs, rp, col, md)
                               - ref.lineage_gather_ref(qs, rp, col, max_deg=md)).abs().max())
                    check(err == 0, f"lineage_gather != plain at R={r} max_deg={md} Q={q}")
                    gather_err = max(gather_err, err)
                    n_cases += 1
    edge_cases, edge_err, gather_geometries = gather_sweep(lineage_gather_cuda, gen, dev)
    torch.cuda.synchronize()
    gather_err = max(gather_err, edge_err)
    check(max(g.ctas for g in gather_geometries) > 100,
          f"gather edge geometries {sorted(gather_geometries)}")
    emit({"phase": "lineage_gather_vs_plain", "cases": n_cases + edge_cases,
          "max_abs_err": gather_err, "tolerance": 0, "edge_cases": edge_cases,
          "edge_geometries": sorted(list(g) for g in gather_geometries)})

    # -- 4. the record-level main path on the card: the walk --------------------
    rng = np.random.default_rng(SEED)
    capture_s = {}
    indexes = {}
    torch.cuda.reset_peak_memory_stats(dev)
    for name, (make, run) in U.USECASES.items():
        idx = ProvenanceIndex(name)            # device=None: the card
        table = make()
        sink, dt = sync_time(run, idx, table)
        capture_s[name] = dt
        indexes[name] = (idx, idx.sources()[0], sink.dataset_id)
        data = sink.table.data[~sink.table.null]
        check(bool(torch.isfinite(data).all()), f"{name}: non-finite sink values")

    (jidx, jsink), dt = sync_time(tpcdi_join, 20, dev)
    capture_s["tpcdi_sf20"] = dt
    check(jidx.datasets[jsink].n_rows > 0, "empty join")
    indexes["tpcdi_sf20"] = (jidx, "trade", jsink)

    def probes(n):
        return [sorted(set(rng.integers(0, n, size=8).tolist())) for _ in range(B)]

    queries = {}
    for name, (idx, src, sink) in indexes.items():
        queries[name] = {
            "q1": probes(idx.datasets[src].n_rows),
            "q2": probes(idx.datasets[sink].n_rows),
        }

    def q1(idx, src, sink, ps, session=None):
        return prov(idx).source(src).rows_batch(ps).forward().to(sink).run(session)

    def q2(idx, src, sink, ps, session=None):
        return prov(idx).source(sink).rows_batch(ps).backward().to(src).run(session)

    walk_sessions = {name: QuerySession(idx, use_hopcache=False, fused_walk=True)
                     for name, (idx, _, _) in indexes.items()}
    answers = {}
    launches = {}
    ops.reset_launch_counts()
    for name, (idx, src, sink) in indexes.items():
        before = ops.launch_counts().get("batched_walk", 0)
        a1 = q1(idx, src, sink, queries[name]["q1"], walk_sessions[name])
        a2 = q2(idx, src, sink, queries[name]["q2"], walk_sessions[name])
        torch.cuda.synchronize()
        launches[name] = ops.launch_counts().get("batched_walk", 0) - before
        answers[name] = (a1, a2)
    main_counts = ops.launch_counts()
    main_peak = torch.cuda.max_memory_allocated(dev)
    for name in ("german", "compas"):
        check(launches[name] == 2, f"{name} Q1+Q2 launched batched_walk "
                                   f"{launches[name]} times, expected 2")
    emit({"phase": "main_path", "capture_s": capture_s,
          "rows": {n: {"source": i.datasets[s].n_rows, "sink": i.datasets[t].n_rows,
                       "sink_cols": i.datasets[t].n_cols}
                   for n, (i, s, t) in indexes.items()},
          "batched_walk_launches": launches, "launch_counts": main_counts,
          "fused_walk": {n: s.counters["fused_walk"] for n, s in walk_sessions.items()}})

    # every answer equals the per-op walk on the card
    plain_walk = {}
    for name, (idx, src, sink) in indexes.items():
        walk = QuerySession(idx, use_hopcache=False, fused_walk=False)
        plain_walk[name] = (q1(idx, src, sink, queries[name]["q1"], walk),
                            q2(idx, src, sink, queries[name]["q2"], walk))
        for got, want in zip(answers[name], plain_walk[name]):
            check(len(got) == len(want) == B, f"{name}: batch size")
            for g, w in zip(got, want):
                check(torch.equal(g, w), f"{name}: fused answer != walk")

    # German, Compas and the join at scale factor 3 also equal the CPU run;
    # dataset ids come from a process-wide counter, so datasets are aligned
    # by op position, never by id
    def same(got, want, what):
        check(len(got) == len(want), f"{what}: batch size")
        for x, y in zip(got, want):
            check(torch.equal(x.cpu(), y.cpu()), what)

    def hops_key(trace):
        return [(h.op_id, h.op_name, h.category, h.n_records) for h in trace]

    cpu = {}
    cpu_answers = {}
    for name in ("german", "compas"):
        make, run = U.USECASES[name]
        idx_c = ProvenanceIndex(name, device="cpu")
        sink_c = run(idx_c, make(device="cpu"))
        src_c = idx_c.sources()[0]
        cpu[name] = (idx_c, src_c, sink_c.dataset_id)
        for og, oc in zip(indexes[name][0].ops, idx_c.ops):
            check(og.tensor.nnz == oc.tensor.nnz, f"{name}: op nnz differs")
        walk_c = QuerySession(idx_c, use_hopcache=False)
        cpu_answers[name] = (q1(idx_c, src_c, sink_c.dataset_id, queries[name]["q1"], walk_c),
                             q2(idx_c, src_c, sink_c.dataset_id, queries[name]["q2"], walk_c))
        same(answers[name][0], cpu_answers[name][0], f"{name} Q1: card != CPU")
        same(answers[name][1], cpu_answers[name][1], f"{name} Q2: card != CPU")
    jc, jc_sink = tpcdi_join(3, "cpu")
    jg, jg_sink = tpcdi_join(3, dev)
    qs3 = {"q1": probes(jc.datasets["trade"].n_rows), "q2": probes(jc.datasets[jc_sink].n_rows)}
    sf3 = {"card": {}, "cpu": {}}
    for which, (i, s) in (("card", (jg, jg_sink)), ("cpu", (jc, jc_sink))):
        ws = QuerySession(i, use_hopcache=False)
        sf3[which]["walk"] = (q1(i, "trade", s, qs3["q1"], ws), q2(i, "trade", s, qs3["q2"], ws))
        sf3[which]["hopcache"] = (q1(i, "trade", s, qs3["q1"]), q2(i, "trade", s, qs3["q2"]))
    for route in ("walk", "hopcache"):
        for k in (0, 1):
            same(sf3["card"][route][k], sf3["cpu"]["walk"][k],
                 f"tpcdi sf3 Q{k + 1} {route}: card != CPU")
    del jc, jg

    # Q5/Q6 on German, Q9-Q11 on Compas, each against the CPU run
    hows = {}
    for which, (i, s, t) in (("card", indexes["german"]), ("cpu", cpu["german"])):
        ps = queries["german"]["q1"][:8]
        hows[which] = (
            prov(i).source(s).rows_batch(ps).forward().to(t).how().run(),
            prov(i).source(t).rows_batch(ps).backward().to(s).how().run(),
        )
    for got, want in zip(hows["card"], hows["cpu"]):
        same([r for r, _ in got], [r for r, _ in want], "Q5/Q6 records: card != CPU")
        check([hops_key(h) for _, h in got] == [hops_key(h) for _, h in want],
              "Q5/Q6 hop traces: card != CPU")
        check(all(len(h) == 4 for r, h in got if r.numel()), "Q5/Q6: 4 hops per live probe")

    def co_queries(i, s, t, session):
        mid = i.ops[1].output_id                    # the filter's output
        ps = queries["compas"]["q2"][:8]
        return (
            prov(i).source(t).transformations().run(session),
            prov(i).source(mid).rows_batch(ps).co_contributory(s).run(session),
            prov(i).source(t).rows_batch(ps).co_dependency(s, mid).run(session),
            # with a named meeting dataset Q10 can route to the hop-cache
            prov(i).source(mid).rows_batch(ps).co_contributory(s, via=t).run(session),
        )

    co = {which: co_queries(i, s, t, QuerySession(i, use_hopcache=False))
          for which, (i, s, t) in (("card", indexes["compas"]), ("cpu", cpu["compas"]))}
    q9, q10, q11, q10_via = co["card"]
    check([(r["op"], r["category"]) for r in q9]
          == [(r["op"], r["category"]) for r in co["cpu"][0]] and len(q9) == 7, "Q9")
    same(q10, co["cpu"][1], "Q10: card != CPU")
    same(q11, co["cpu"][2], "Q11: card != CPU")
    same(q10_via, co["cpu"][3], "Q10 via the sink: card != CPU")
    check(any(x.numel() for x in q10) and any(x.numel() for x in q11), "Q10/Q11 empty")
    emit({"phase": "answers", "equal_fused_vs_walk": sorted(indexes),
          "equal_card_vs_cpu": ["german", "compas", "tpcdi_sf3"],
          "q5_q6_probes": len(hows["card"][0]), "q9_ops": len(q9),
          "q10_q11_probes": len(q10)})

    # -- 5. the default route: the composed hop-cache ("auto") ------------------
    ops.reset_launch_counts()
    hop = {}
    explains = {}
    for name, (idx, src, sink) in indexes.items():
        session = idx.session()                      # QuerySession(): use_hopcache=True
        plans = (prov(idx).source(src).rows_batch(queries[name]["q1"]).forward().to(sink).plan(),
                 prov(idx).source(sink).rows_batch(queries[name]["q2"]).backward().to(src).plan())
        explains[name] = [session.explain(p) for p in plans]
        hop[name] = tuple(session.run(p) for p in plans)
    co_hop = co_queries(*indexes["compas"], indexes["compas"][0].session())
    torch.cuda.synchronize()
    default_counts = ops.launch_counts()
    for name in indexes:
        for got, want in zip(hop[name], answers[name]):
            same(got, want, f"{name}: hop-cache answer != walk")
    for name in ("german", "compas"):
        for got, want in zip(hop[name], cpu_answers[name]):
            same(got, want, f"{name}: hop-cache answer != CPU")
    for j, what in ((1, "Q10"), (2, "Q11"), (3, "Q10 via the sink")):
        same(co_hop[j], co["card"][j], f"{what}: hop-cache session != walk")
        same(co_hop[j], co["cpu"][j], f"{what}: hop-cache session != CPU")
    for name, (idx, _, _) in indexes.items():
        for ex in explains[name]:
            check(ex["constants"]["source"] == "default", f"{name}: routing constants not default")
    emit({"phase": "hopcache_default", "launch_counts": default_counts,
          "compas_co_query_counters": indexes["compas"][0].session().counters,
          "stats": {n: i.session().stats() for n, (i, _, _) in indexes.items()},
          "explain": explains})

    # -- 6. the hop-cache's bitplane backend: every compose and probe a launch ---
    def mask_stack(ps, n):
        m = torch.zeros((len(ps), n), dtype=torch.bool, device=dev)
        for b, p in enumerate(ps):
            m[b, torch.tensor(p, dtype=torch.int64, device=dev)] = True
        return m

    def nonzeros(stack):
        return [torch.nonzero(r).reshape(-1) for r in stack]

    bitplane = {}
    bp_launch = {}
    bp_expected = {}
    ops.reset_launch_counts()
    for name in ("german", "compas", "census"):
        idx, src, sink = indexes[name]
        check(all(len(op.input_ids) == 1 for op in idx.ops), f"{name}: not a linear chain")
        ci = ComposedIndex(idx, memory_budget_bytes=2 << 30, backend="bitplane")
        before = ops.launch_counts().get("bitmatmul", 0)
        fwd = ci.probe_forward(mask_stack(queries[name]["q1"], idx.datasets[src].n_rows),
                               src, sink)
        bwd = ci.probe_backward(mask_stack(queries[name]["q2"], idx.datasets[sink].n_rows),
                                sink, src)
        torch.cuda.synchronize()
        bp_launch[name] = ops.launch_counts().get("bitmatmul", 0) - before
        bp_expected[name] = (len(idx.ops) - 1) + 2
        bitplane[name] = ci
        check(bp_launch[name] == bp_expected[name],
              f"{name}: bitplane hop-cache launched bitmatmul {bp_launch[name]} times, "
              f"expected {bp_expected[name]}")
        same(nonzeros(fwd), answers[name][0], f"{name}: bitplane Q1 != walk")
        same(nonzeros(bwd), answers[name][1], f"{name}: bitplane Q2 != walk")
        if name in cpu:
            same(nonzeros(fwd), cpu_answers[name][0], f"{name}: bitplane Q1 != CPU")
            same(nonzeros(bwd), cpu_answers[name][1], f"{name}: bitplane Q2 != CPU")
    bitplane_counts = ops.launch_counts()

    # -- 6b. the hop-cache's CSR backend: the arm "auto" takes for unstructured
    # relations (torch sparse CSR with int32 indices: sparse products, the
    # forward ragged gather, the backward sparse x dense product, and on the
    # diamond the union of two CSR relations); no kernel of the port runs here
    from repro_torch.dataprep.table import Table

    def diamond(n, device):
        drng = np.random.default_rng(SEED)
        idx = ProvenanceIndex(f"diamond{n}", device=device)
        t = Table.from_columns({"k": np.arange(n, dtype=np.float32),
                                "x": drng.normal(size=n).astype(np.float32)}, device=device)
        s = track(t, idx, "src")
        a = s.filter_rows(drng.random(n) < 0.75)
        b = s.value_transform("x", "scale", factor=2.0)
        return idx, "src", a.join(b, on="k", how="inner").mark_sink().dataset_id

    csr_sets = {name: indexes[name] for name in ("german", "compas", "census")}
    csr_sets["diamond"] = diamond(100_000, dev)
    csr_stats = {}
    for name, (idx, src, sink) in csr_sets.items():
        if name in queries:
            ps1, ps2 = queries[name]["q1"], queries[name]["q2"]
            want = answers[name]
        else:
            ps1, ps2 = probes(idx.datasets[src].n_rows), probes(idx.datasets[sink].n_rows)
            walk = QuerySession(idx, use_hopcache=False)
            want = (q1(idx, src, sink, ps1, walk), q2(idx, src, sink, ps2, walk))
        ci = ComposedIndex(idx, memory_budget_bytes=2 << 30, backend="csr")
        fwd = ci.probe_forward(mask_stack(ps1, idx.datasets[src].n_rows), src, sink)
        bwd = ci.probe_backward(mask_stack(ps2, idx.datasets[sink].n_rows), sink, src)
        check(ci.relation_backend(src, sink) == "csr", f"{name}: relation not in CSR")
        same(nonzeros(fwd), want[0], f"{name}: CSR hop-cache Q1 != walk")
        same(nonzeros(bwd), want[1], f"{name}: CSR hop-cache Q2 != walk")
        if name in cpu:
            same(nonzeros(fwd), cpu_answers[name][0], f"{name}: CSR hop-cache Q1 != CPU")
            same(nonzeros(bwd), cpu_answers[name][1], f"{name}: CSR hop-cache Q2 != CPU")
        if name in bitplane and name != "census":
            # the whole composed relation, densified, equals the bitplane one
            dense = ci.relation(src, sink).to_dense() > 0
            check(torch.equal(dense, ref.unpack_bits(bitplane[name].relation(src, sink),
                                                     dense.shape[1])),
                  f"{name}: CSR relation != bitplane relation")
            del dense
        rel = ci.relation(src, sink)
        check(rel.crow_indices().dtype == torch.int32 and rel.col_indices().dtype == torch.int32,
              f"{name}: CSR indices not int32")
        csr_stats[name] = ci.stats()
    check(csr_stats["diamond"]["entries_csr"] >= 3, "diamond: no CSR union composed")
    emit({"phase": "hopcache_csr", "stats": csr_stats,
          "equal_walk": sorted(csr_sets), "equal_cpu": sorted(set(csr_sets) & set(cpu)),
          "relation_equal_bitplane": ["german", "compas"]})
    del csr_sets

    # the kernel against its plain version on real compositions
    compositions = {}
    for name in ("compas", "census"):
        idx, src, sink = indexes[name]
        prefix = bitplane[name].relation(src, idx.ops[-1].input_ids[0])
        step = idx.ops[-1].tensor.bitplane_fwd(0)
        err = word_err(bitmatmul_cuda(prefix, step), ref.bitmatmul_ref(prefix, step))
        torch.cuda.synchronize()
        check(err == 0, f"bitmatmul != plain on the {name} composition")
        compositions[name] = (prefix, step)
    emit({"phase": "hopcache_bitplane", "bitmatmul_launches": bp_launch,
          "expected": bp_expected, "launch_counts": bitplane_counts,
          "stats": {n: ci.stats() for n, ci in bitplane.items()},
          "composition_shapes": {n: [list(a.shape), list(b.shape)]
                                 for n, (a, b) in compositions.items()},
          "composition_max_abs_err": 0, "tolerance": 0})

    # -- 7. the per-hop baseline against the fused walk on the Compas and
    # Census chains: byte-equal in K x 3 launches (bitmatmul, bitset_rank,
    # lineage_gather) against 1, and the rank and gather kernels on exactly
    # the inputs each hop of both chains gives them (as
    # ops.batched_walk_unfused builds them), each against its plain version
    # and each gathered table against the set bits of its frontier
    def baseline_chains(name):
        i, s_, t_ = indexes[name]
        tensors = [op.tensor for op in i.ops]
        return {"q1": (ref.pack_bits(mask_stack(queries[name]["q1"], i.datasets[s_].n_rows)),
                       [t.bitplane_fwd(0) for t in tensors]),
                "q2": (ref.pack_bits(mask_stack(queries[name]["q2"], i.datasets[t_].n_rows)),
                       [t.bitplane_bwd(0) for t in reversed(tensors)])}

    ci_idx, csrc, csink = indexes["compas"]
    chain = [op.tensor for op in ci_idx.ops]
    compas_chains = baseline_chains("compas")
    (q1_mask, compas_fwd), (q2_mask, compas_bwd) = compas_chains["q1"], compas_chains["q2"]
    baseline = {}
    unfused_counts = {}
    hops = {}
    real_rank_err = real_gather_err = 0
    for name, chains in (("compas", compas_chains), ("census", baseline_chains("census"))):
        counts, fused_counts, per_hop, r_err, g_err = per_hop_baseline(
            name, chains, dev, bitset_rank_cuda, lineage_gather_cuda)
        for k, n in counts.items():
            unfused_counts[k] = unfused_counts.get(k, 0) + n
        hops[name] = per_hop
        real_rank_err = max(real_rank_err, r_err)
        real_gather_err = max(real_gather_err, g_err)
        baseline[name] = {
            "hops_per_chain": {q: len(planes) for q, (_, planes) in chains.items()},
            "unfused_launch_counts": counts, "fused_launch_counts": fused_counts,
            "per_hop_shapes": {q: [{"W": h["flat"].numel(), "nnz": h["col"].numel(),
                                    "max_deg": h["md"]} for h in hs]
                               for q, hs in per_hop.items()}}
        del chains
    census_q2_hop0 = hops["census"]["q2"][0]
    hops = hops["compas"]
    qs = torch.arange(B, dtype=torch.int32, device=dev)
    rank_err = max(rank_err, real_rank_err)
    gather_err = max(gather_err, real_gather_err)
    emit({"phase": "unfused_vs_fused", "configurations": baseline, "byte_equal": True,
          "unfused_launch_counts": unfused_counts,
          "per_hop_rank_max_abs_err": real_rank_err, "per_hop_gather_max_abs_err": real_gather_err,
          "tolerance": 0})

    # the fused kernel against its plain version on the real Compas chain and
    # on the Census chain with the plane cap raised
    for mask, planes in ((q1_mask, compas_fwd), (q2_mask, compas_bwd)):
        out, cnt = batched_walk_cuda(mask, planes)
        want_out, want_cnt = ref.batched_walk_ref(mask, planes)
        torch.cuda.synchronize()
        check(torch.equal(out, want_out) and torch.equal(cnt, want_cnt),
              "batched_walk != plain on the Compas chain")
    si, ssrc, ssink = indexes["census"]
    n_census = si.datasets[ssrc].n_rows
    census_probe = (torch.rand(B, n_census, generator=gen, device=dev) < 0.01)
    got = fused_walk_record_masks_batch(si, ssrc, ssink, census_probe,
                                        max_plane_bytes=1 << 40)
    check(got is not None, "Census chain did not fuse under the raised cap")
    walk_masks = forward_record_masks_batch(si, ssrc, census_probe)[ssink]
    check(torch.equal(got, walk_masks), "Census fused walk != per-op walk")
    census_planes = [op.tensor.bitplane_fwd(0) for op in si.ops]
    cmask = ref.pack_bits(census_probe)
    out, cnt = batched_walk_cuda(cmask, census_planes)
    want_out, want_cnt = ref.batched_walk_ref(cmask, census_planes)
    torch.cuda.synchronize()
    check(torch.equal(out, want_out) and torch.equal(cnt, want_cnt),
          "batched_walk != plain on the Census-sized chain")
    emit({"phase": "kernel_vs_plain_real", "compas_hops": len(chain),
          "census_hops": len(census_planes), "census_rows": n_census,
          "max_abs_err": 0, "tolerance": 0})
    del want_out, out

    # -- 7b. attribute-level lineage: Q3/Q4 on every configuration, Q7/Q8 on
    # German and Compas, through the default session (cells plans walk);
    # every attribute hop is one bitmatmul launch, recorded with its inputs
    arng = np.random.default_rng(SEED + 1)
    for name, (idx, src, sink) in indexes.items():
        queries[name]["a_src"] = attr_probe_sets(arng, idx.datasets[src].n_cols)
        queries[name]["a_sink"] = attr_probe_sets(arng, idx.datasets[sink].n_cols)
    real_bitmatmul = ops.bitmatmul
    attr_hops = []

    def recording_bitmatmul(a, b):
        c = real_bitmatmul(a, b)
        attr_hops.append((a, b, c))
        return c

    attr_card = {}
    attr_launch = {}
    ops.reset_launch_counts()
    ops.bitmatmul = recording_bitmatmul
    try:
        for name, (idx, src, sink) in indexes.items():
            before = ops.launch_counts().get("bitmatmul", 0)
            attr_card[name] = attribute_queries(idx, src, sink, queries[name], how=name in cpu)
            torch.cuda.synchronize()
            attr_launch[name] = ops.launch_counts().get("bitmatmul", 0) - before
    finally:
        ops.bitmatmul = real_bitmatmul
    attr_counts = ops.launch_counts()
    check(attr_counts.get("bitmatmul", 0) == len(attr_hops) > 0,
          f"attribute launches {attr_counts} against {len(attr_hops)} recorded hops")
    attr_err = 0
    for a, b, c in attr_hops:
        attr_err = max(attr_err, word_err(c, ref.bitmatmul_ref(a, b)))
    torch.cuda.synchronize()
    check(attr_err == 0, "bitmatmul != plain on an attribute hop")
    for name in indexes:
        for key, k in (("q3", 0), ("q4", 1)):
            check(cells_subset_of_records(attr_card[name][key], answers[name][k]),
                  f"{name} {key}: a cell row outside the record answer")
            check(any(c.numel() for c in attr_card[name][key]), f"{name} {key}: no cells")

    # the CPU runs: German and Compas (phase 4's indexes), Census, and the
    # join at scale factor 3 on both devices; cells, hop traces and the
    # number of attribute hops dispatched must agree
    make, run = U.USECASES["census"]
    idx_c = ProvenanceIndex("census", device="cpu")
    sink_c = run(idx_c, make(device="cpu"))
    attr_cpu_sets = dict(cpu, census=(idx_c, idx_c.sources()[0], sink_c.dataset_id))
    attr_cpu_launch = {}
    for name, (i, s, t) in attr_cpu_sets.items():
        ops.reset_launch_counts()
        got = attribute_queries(i, s, t, queries[name], how=name in cpu)
        attr_cpu_launch[name] = ops.launch_counts().get("bitmatmul", 0)
        same_attr_answers(attr_card[name], got, f"{name}: card != CPU")
        check(attr_cpu_launch[name] == attr_launch[name],
              f"{name}: {attr_launch[name]} attribute launches on the card, "
              f"{attr_cpu_launch[name]} on the CPU")
    del idx_c, attr_cpu_sets
    jc, jc_sink = tpcdi_join(3, "cpu")
    jg, jg_sink = tpcdi_join(3, dev)
    qa3 = {"q1": probes(jc.datasets["trade"].n_rows), "q2": probes(jc.datasets[jc_sink].n_rows),
           "a_src": attr_probe_sets(arng, jc.datasets["trade"].n_cols),
           "a_sink": attr_probe_sets(arng, jc.datasets[jc_sink].n_cols)}
    sf3_launch = {}
    sf3 = {}
    for which, (i, t) in (("card", (jg, jg_sink)), ("cpu", (jc, jc_sink))):
        ops.reset_launch_counts()
        sf3[which] = attribute_queries(i, "trade", t, qa3, how=True)
        torch.cuda.synchronize()
        sf3_launch[which] = ops.launch_counts().get("bitmatmul", 0)
    same_attr_answers(sf3["card"], sf3["cpu"], "tpcdi sf3: card != CPU")
    check(sf3_launch["card"] == sf3_launch["cpu"] > 0,
          f"tpcdi sf3 attribute launches {sf3_launch}")
    del jc, jg, sf3

    attr_latency = {}
    for name, (idx, src, sink) in indexes.items():
        qn = queries[name]
        q3b = prov(idx).source(src).rows_batch(qn["q1"]).attrs_batch(qn["a_src"]) \
            .forward().to(sink)
        q4b = prov(idx).source(sink).rows_batch(qn["q2"]).attrs_batch(qn["a_sink"]) \
            .backward().to(src)
        attr_latency[name] = {"q3_ms": host_ms(q3b.run), "q4_ms": host_ms(q4b.run)}
    attr_a, attr_b, _ = max(attr_hops, key=lambda h: (h[1].numel(), h[0].numel()))
    emit({"phase": "attribute", "card": card, "B": B,
          "bitmatmul_launches": attr_launch, "cpu_bitmatmul_launches": attr_cpu_launch,
          "tpcdi_sf3_launches": sf3_launch, "launch_counts": attr_counts,
          "hops_checked": len(attr_hops), "max_abs_err": attr_err, "tolerance": 0,
          "hop_shapes": sorted({(tuple(a.shape), tuple(b.shape)) for a, b, _ in attr_hops}),
          "cells": {n: {k: sum(int(c.shape[0]) for c in (r if k in ("q3", "q4")
                                                        else [x for x, _ in r]))
                        for k, r in v.items()} for n, v in attr_card.items()},
          "equal_card_vs_cpu": ["german", "compas", "census", "tpcdi_sf3"],
          "latency": attr_latency,
          "attribute_hop": {"shape": {"A": list(attr_a.shape), "B": list(attr_b.shape)},
                            "geometry": bitmatmul_geometry(attr_a.shape[0],
                                                           attr_b.shape[1])._asdict(),
                            "device_ms": device_ms(lambda: bitmatmul_cuda(attr_a, attr_b)),
                            "host_paced_ms": event_ms(lambda: bitmatmul_cuda(attr_a, attr_b))}})
    del attr_hops, attr_card

    # -- 7c. the hop-cache's spill tier: a bitplane ComposedIndex whose budget
    # holds about 1.5 relations, every (source, dataset) pair probed twice;
    # answers equal the unbounded phase-6 hop-cache's, and on Compas the
    # counters equal the CPU run's with the same budget
    import shutil

    from repro_torch.core.spill import SpillPolicy, _TensorFault

    spill_hc = {}
    spill_hc_launch = {}
    spill_hc_counts = {}
    for name in ("compas", "census"):
        idx, src, sink = indexes[name]
        full = bitplane[name]
        rel_bytes = int(full.relation(src, sink).numel()) * 4
        budget = int(1.5 * rel_bytes)
        mrng = np.random.default_rng(SEED + 2)
        src_mask = mask_stack(queries[name]["q1"], idx.datasets[src].n_rows)
        op_masks = []
        for op in idx.ops:
            n = idx.datasets[op.output_id].n_rows
            op_masks.append(mask_stack([sorted(set(mrng.integers(0, n, 8).tolist()))
                                        for _ in range(B)], n))
        # the counts cover the spilled hop-cache's run on the card alone: the
        # unbounded index's probes and the CPU run below come after the read
        ops.reset_launch_counts()
        ci, policy, got = spill_hopcache_run(idx, src, budget, src_mask, op_masks,
                                             f"hopcache_{name}")
        torch.cuda.synchronize()
        run_counts = ops.launch_counts()
        spill_hc_launch[name] = run_counts.get("bitmatmul", 0)
        for k, n in run_counts.items():
            spill_hc_counts[k] = spill_hc_counts.get(k, 0) + n
        st = ci.stats()
        check(st["spills"] > 0 and st["rehydrations"] > 0, f"{name}: spill tier idle: {st}")
        k = 0
        for _ in range(2):
            for op, mask in zip(idx.ops, op_masks):
                d = op.output_id
                check(torch.equal(got[k][0], full.probe_forward(src_mask, src, d))
                      and torch.equal(got[k][1], full.probe_backward(mask, d, src)),
                      f"{name}: spilled hop-cache answer != unbounded at {d}")
                k += 1
        stats_keys = ("entries", "bytes", "hits", "misses", "evictions", "extends",
                      "recomposes", "spills", "rehydrations", "spilled_entries")
        store_keys = ("entries", "segments", "live_bytes", "disk_bytes", "dead_bytes",
                      "writes", "reads", "bytes_written", "bytes_read")
        row = {"relation_bytes": rel_bytes, "budget_bytes": budget,
               "stats": {k: st[k] for k in stats_keys},
               "store": {k: st["spill"][k] for k in store_keys},
               "bitmatmul_launches": spill_hc_launch[name]}
        if name == "compas":
            i_c, s_c, _ = cpu["compas"]
            ops.reset_launch_counts()
            ci_c, policy_c, got_c = spill_hopcache_run(
                i_c, s_c, budget, src_mask.cpu(), [m.cpu() for m in op_masks], "hopcache_cpu")
            cpu_launch = ops.launch_counts().get("bitmatmul", 0)
            check(cpu_launch == spill_hc_launch[name],
                  f"compas: {spill_hc_launch[name]} spilled hop-cache launches on the card, "
                  f"{cpu_launch} on the CPU")
            row["cpu_bitmatmul_launches"] = cpu_launch
            st_c = ci_c.stats()
            check({k: st_c[k] for k in stats_keys} == row["stats"]
                  and {k: st_c["spill"][k] for k in store_keys} == row["store"],
                  f"compas: spill counters card {row} != CPU {st_c}")
            for (f, b), (fc, bc) in zip(got, got_c):
                check(torch.equal(f.cpu(), fc) and torch.equal(b.cpu(), bc),
                      "compas: spilled hop-cache card != CPU")
            row["equal_cpu_counters"] = True
            policy_c.store.close()
            shutil.rmtree(policy_c.store.root, ignore_errors=True)
            del ci_c, got_c
        faults = []
        for op in idx.ops:
            d = op.output_id
            if ci.residency(src, d) == "spilled" and len(faults) < 3:
                n_bytes = idx.datasets[src].n_rows * ((idx.datasets[d].n_rows + 31) // 32) * 4
                _, dt = sync_time(ci.relation, src, d)
                faults.append({"pair": d, "bytes": n_bytes, "ms": dt * 1e3,
                               "gb_per_s": n_bytes / dt / 1e9})
        check(faults, f"{name}: no spilled pair left to fault")
        row["faults"] = faults
        spill_hc[name] = row
        policy.store.close()
        shutil.rmtree(policy.store.root, ignore_errors=True)
        del ci, got
    emit({"phase": "spill_hopcache", "card": card, "results": spill_hc,
          "launch_counts": spill_hc_counts})

    # -- 7d. op-tensor spill: ProvenanceIndex(spill=) with a budget of a
    # quarter of the unspilled index's prov_nbytes(); Q1/Q2 through the
    # walk, the fused walk and the default session, against the unspilled
    # index captured beside it
    def capture_usecase(name):
        def make(device, spill):
            idx = ProvenanceIndex(f"{name}_spill", device=device, spill=spill)
            sink = U.USECASES[name][1](idx, U.USECASES[name][0](device=device))
            return idx, idx.sources()[0], sink.dataset_id
        return make

    def capture_join20(device, spill):
        idx, sink = tpcdi_join(20, device, spill)
        return idx, "trade", sink

    spill_t = {}
    spill_t_walks = 0
    for name, make in (("compas", capture_usecase("compas")),
                       ("census", capture_usecase("census")),
                       ("tpcdi_sf20", capture_join20)):
        plain, s0, t0, plain_alloc = capture_delta(make, dev)
        prov_bytes = plain.prov_nbytes()
        budget = max(prov_bytes // 4, 1)
        policy = SpillPolicy(path=str(fresh_store(f"tensors_{name}")), budget_bytes=budget)
        # the measured unspilled capture is freed before the spilled one is
        # measured (same allocator state for both); its twin, captured after,
        # is what the queries compare with
        del plain
        sp, s1, t1, sp_alloc = capture_delta(make, dev, policy)
        plain, s0, t0 = make(dev, None)

        def within(stats):
            # the policy never spills the last resident tensor
            return stats["resident_bytes"] <= policy.high_watermark * budget \
                or stats["resident_ops"] == 1

        after_capture = sp.stats()["spill"]
        spilled_payload = sum(op.tensor.nbytes() for op in sp.ops
                              if isinstance(op.tensor, _TensorFault))
        check(within(after_capture), f"{name}: resident bytes past the watermark {after_capture}")
        for k, what in ((0, "memory_allocated"), (1, "requested bytes")):
            check(plain_alloc[k] - sp_alloc[k] >= spilled_payload,
                  f"{name}: capture kept {sp_alloc[k]} B ({what}) spilled against "
                  f"{plain_alloc[k]} B, {spilled_payload} B spilled")
        qn = queries[name]
        routes = {}
        for route, kw in (("walk", {"use_hopcache": False, "fused_walk": False}),
                          ("fused_walk", {"use_hopcache": False, "fused_walk": True}),
                          ("default", {})):
            ss, ps = QuerySession(sp, **kw), QuerySession(plain, **kw)
            ops.reset_launch_counts()
            got = (q1(sp, s1, t1, qn["q1"], ss), q2(sp, s1, t1, qn["q2"], ss))
            torch.cuda.synchronize()
            walks = ops.launch_counts().get("batched_walk", 0)
            if route == "fused_walk":
                spill_t_walks += walks
            want = (q1(plain, s0, t0, qn["q1"], ps), q2(plain, s0, t0, qn["q2"], ps))
            for k in (0, 1):
                same(got[k], want[k], f"{name} {route} Q{k + 1}: spilled != unspilled")
                same(got[k], answers[name][k], f"{name} {route} Q{k + 1}: spilled != main path")
            routes[route] = {"counters": dict(ss.counters), "batched_walk_launches": walks}
        after_queries = sp.stats()["spill"]
        check(within(after_queries), f"{name}: resident bytes past the watermark {after_queries}")
        faults = []
        for op in sp.ops:
            if isinstance(op.tensor, _TensorFault) and op.tensor.nbytes() and len(faults) < 3:
                n_bytes = op.tensor.nbytes()
                # the fault happens on the attribute access: time it too
                _, dt = sync_time(lambda: op.tensor.resident())
                faults.append({"op": op.op_id, "bytes": n_bytes, "ms": dt * 1e3,
                               "gb_per_s": n_bytes / dt / 1e9})
        spill_t[name] = {
            "prov_nbytes_after_capture": prov_bytes, "budget_bytes": budget,
            "capture_allocated_bytes": {"unspilled": plain_alloc[0], "spilled": sp_alloc[0]},
            "capture_requested_bytes": {"unspilled": plain_alloc[1], "spilled": sp_alloc[1]},
            "spilled_payload_bytes": spilled_payload, "after_capture": after_capture,
            "after_queries": {k: v for k, v in after_queries.items() if k != "store"},
            "store": {k: after_queries["store"][k]
                      for k in ("writes", "reads", "bytes_written", "bytes_read")},
            "routes": routes, "faults": faults}
        policy.store.close()
        shutil.rmtree(policy.store.root, ignore_errors=True)
        del plain, sp
    check(spill_t_walks > 0, "the fused walk never ran over a spilled index")
    check(any(v["spilled_payload_bytes"] for v in spill_t.values()), "no op tensor spilled")
    emit({"phase": "spill_tensors", "card": card, "results": spill_t,
          "batched_walk_launches": spill_t_walks})

    # -- 7e. federation: each configuration captured a second time, split
    # into a prep index and a serve index glued by an identity link (Compas
    # and Census after their second op, TPC-DI between the join and the
    # filter), and the two-link diamond at 100,000 rows.  Members run Q1-Q4
    # (and Q6/Q7 hop traces) as segments: Compas's members on the fused
    # walk, Census's on warm bitplane hop-caches, TPC-DI's and the
    # diamond's on their default sessions.  Answers equal the merged
    # index's, and on Compas the CPU run's (launch counts too).  Then one
    # hot route per catalog flips to its stitched relation under the
    # default cost gate, and its answers equal the segments'.
    from repro_torch.provenance import FederatedSession
    from repro_torch.provenance.catalog import split_ref

    fed = {}
    fed_counts = {}
    for name, members in (("compas", "fused_walk"), ("census", "bitplane"),
                          ("tpcdi_sf20", "default"), ("diamond", "default")):
        t = time.perf_counter()
        if name == "diamond":
            m_idx, m_src, m_sink, cat, fsrc, fsink = diamond_worlds(100_000, dev)
            rng_d = np.random.default_rng(SEED + 3)
            qn = {"q1": probes(m_idx.datasets[m_src].n_rows),
                  "q2": probes(m_idx.datasets[m_sink].n_rows),
                  "a_src": attr_probe_sets(rng_d, m_idx.datasets[m_src].n_cols),
                  "a_sink": attr_probe_sets(rng_d, m_idx.datasets[m_sink].n_cols)}
        else:
            m_idx, m_src, m_sink = indexes[name]
            qn = queries[name]
            if name == "tpcdi_sf20":
                cat, fsrc, fsink, _ = split_join(20, dev)
            else:
                cat, fsrc, fsink, _ = split_usecase(name, 2, dev)
        torch.cuda.synchronize()
        capture = time.perf_counter() - t
        how = name != "tpcdi_sf20"
        got, counts, seg = federation_run(cat, fsrc, fsink, qn, members, how)
        for k, n in counts.items():
            fed_counts[k] = fed_counts.get(k, 0) + n
        # the merged index on the card: the same queries through its
        # default session (Q1/Q2 also equal the main path's walk answers)
        want = lineage_queries(m_idx, m_src, m_sink, qn, how)
        links = same_lineage(got, want, f"{name}: federated != merged")
        if name in answers:
            same(got["q1"], answers[name][0], f"{name}: federated Q1 != main path")
            same(got["q2"], answers[name][1], f"{name}: federated Q2 != main path")
        check(seg.counters["segments"] > 0 and seg.counters["cross_composes"] == 0,
              f"{name}: segment session {seg.counters}")
        row = {"members": members, "capture_s": capture, "launch_counts": counts,
               "link_hops": links, "segment_counters": dict(seg.counters),
               "member_planners": {m: s["planner"] for m, s in seg.stats()["indexes"].items()}}
        if name == "compas":
            # the same split, member sessions and queries on the CPU
            cat_c, src_c, sink_c, _ = split_usecase("compas", 2, "cpu")
            got_c, counts_c, seg_c = federation_run(cat_c, src_c, sink_c, qn, members, how)
            same_lineage(got, got_c, "compas federated: card != CPU")
            check(counts_c == counts, f"compas federated launches card {counts} != CPU {counts_c}")
            check(seg_c.counters == seg.counters, "compas federated counters: card != CPU")
            row["cpu_launch_counts"] = counts_c
            del cat_c, got_c
        # timings on the segment route, before any route turns hot
        seg_ms = {}
        for k, fn in (("q1", lambda: prov(cat).source(fsrc).rows_batch(qn["q1"]).forward()
                       .to(fsink).run(seg)),
                      ("q2", lambda: prov(cat).source(fsink).rows_batch(qn["q2"]).backward()
                       .to(fsrc).run(seg)),
                      ("q3", lambda: prov(cat).source(fsrc).rows_batch(qn["q1"])
                       .attrs_batch(qn["a_src"]).forward().to(fsink).run(seg)),
                      ("q4", lambda: prov(cat).source(fsink).rows_batch(qn["q2"])
                       .attrs_batch(qn["a_sink"]).backward().to(fsrc).run(seg))):
            seg_ms[k] = host_ms(fn)
        merged_ms = {}
        for k, fn in (("q1", lambda: prov(m_idx).source(m_src).rows_batch(qn["q1"]).forward()
                       .to(m_sink).run()),
                      ("q2", lambda: prov(m_idx).source(m_sink).rows_batch(qn["q2"]).backward()
                       .to(m_src).run()),
                      ("q3", lambda: prov(m_idx).source(m_src).rows_batch(qn["q1"])
                       .attrs_batch(qn["a_src"]).forward().to(m_sink).run()),
                      ("q4", lambda: prov(m_idx).source(m_sink).rows_batch(qn["q2"])
                       .attrs_batch(qn["a_sink"]).backward().to(m_src).run())):
            merged_ms[k] = host_ms(fn)
        check(seg.counters["cross_composes"] == 0, f"{name}: a zero budget stitched")
        # the hot route: the default gate over the same catalog (the store's
        # budget back to its default); Q2's route composes on its first
        # batch, then probes the stitched relation
        hot = FederatedSession(cat, cross_budget_bytes=64 << 20)
        q2_plan = prov(cat).source(fsink).rows_batch(qn["q2"]).backward().to(fsrc).plan()
        q1_plan = prov(cat).source(fsrc).rows_batch(qn["q1"]).forward().to(fsink).plan()
        first, first_s = sync_time(hot.run, q2_plan)
        again = hot.run(q2_plan)
        fwd = hot.run(q1_plan)
        torch.cuda.synchronize()
        for g, what in ((first, "first"), (again, "second")):
            same(g, got["q2"], f"{name}: stitched Q2 ({what}) != segments")
        same(fwd, got["q1"], f"{name}: stitched Q1 != segments")
        check(hot.counters["cross_composes"] >= 1 and hot.counters["cross_probes"] >= 1,
              f"{name}: the hot route never stitched: {hot.counters}")
        route = hot._route(split_ref(fsink)[0], split_ref(fsrc)[0], reverse=True)
        _, compose_s = sync_time(hot._compose_cross, fsink, fsrc, "bwd", *route)
        row.update({
            "hot_counters": dict(hot.counters), "cross_store_bytes": cat._cross_store.nbytes,
            "cross_store_entries": len(cat._cross_store.entries),
            "stitched_compose_ms": compose_s * 1e3, "first_hot_call_ms": first_s * 1e3,
            "segments_ms": seg_ms, "merged_ms": merged_ms,
            "stitched_ms": {
                "q1": host_ms(lambda: prov(cat).source(fsrc).rows_batch(qn["q1"]).forward()
                              .to(fsink).run(hot)),
                "q2": host_ms(lambda: prov(cat).source(fsink).rows_batch(qn["q2"]).backward()
                              .to(fsrc).run(hot))}})
        fed[name] = row
        if name == "compas":
            fed_compas = (cat, fsrc, fsink)      # the serving tier's federated backend
        del got, want, seg, hot
    check(fed_counts.get("batched_walk", 0) > 0 and fed_counts.get("bitmatmul", 0) > 0,
          f"federation launches {fed_counts}")
    emit({"phase": "federation", "card": card, "B": B, "results": fed,
          "launch_counts": fed_counts,
          "equal_federated_vs_merged": sorted(fed), "equal_card_vs_cpu": ["compas"]})

    # -- 7f. impact: the erasure closure of 32 rows over a 9-op chain of
    # 50,000 rows against per-row forward queries; a federated erasure on
    # split Census against the merged index's plan, with a stitched relation
    # and a spilled hop-cache entry invalidated (idempotently); a what-if
    # replay of 8 patched rows over a 100,000-row pipeline against its full
    # re-run on the card
    from repro_torch.core.recompute import fetch_rows
    from repro_torch.core.spill import SpillPolicy
    from repro_torch.provenance import apply_invalidations, erasure_plan, whatif_replay

    chain, chain_sink = erasure_chain(50_000, 9, dev)
    erased = np.unique(np.random.default_rng(1).integers(0, 50_000, size=32))
    plan, plan_s = sync_time(erasure_plan, chain, "src", erased)
    per_row_probes = [[int(r)] for r in erased]
    for ds in chain.datasets:
        per = prov(chain).source("src").rows_batch(per_row_probes).forward().to(ds).run()
        union = torch.unique(torch.cat(per))
        imp = plan.impact(ds)
        check(torch.equal(imp.rows if imp is not None else union[:0], union),
              f"erasure closure != per-row queries at {ds}")
    impact = {"chain": {"rows": 50_000, "hops": 9, "erased": len(erased),
                        "datasets": len(plan.impacts),
                        "affected_rows": sum(i.n_affected for i in plan.impacts),
                        "first_plan_ms": plan_s * 1e3,
                        "erasure_plan_ms": host_ms(lambda: erasure_plan(chain, "src", erased))}}
    del chain

    cen_cat, cen_src, cen_sink, cen_refs = split_usecase("census", 2, dev)
    prep = cen_cat.members["prep"]._index
    rel_bytes = 3 * 4 * prep.datasets[split_ref(cen_src)[1]].n_rows   # one identity CSR relation
    store_dir = fresh_store("impact_census")
    prep.composed(memory_budget_bytes=int(1.5 * rel_bytes), backend="csr",
                  spill=SpillPolicy(path=str(store_dir)))
    hot = FederatedSession(cen_cat, cross_min_demand=0)
    hot.run(prov(cen_cat).source(cen_src).rows_batch(queries["census"]["q1"]).forward()
            .to(cen_sink).plan())
    for cref in cen_refs[1:3]:
        prep.composed().relation(split_ref(cen_src)[1], split_ref(cref)[1])
    pst = prep.composed().stats()
    check(pst["spilled_entries"] > 0 and len(cen_cat._cross_store.entries) == 1,
          f"census: nothing to invalidate: {pst}")
    payloads = pst["spill"]["entries"]
    m_idx, m_src, _ = indexes["census"]
    census_rows = np.unique(np.random.default_rng(2).integers(0, m_idx.datasets[m_src].n_rows, 32))
    fplan, fplan_s = sync_time(erasure_plan, cen_cat, cen_src, census_rows)
    mplan = erasure_plan(m_idx, m_src, census_rows)
    ref_of = dict(zip([m_src] + [op.output_id for op in m_idx.ops], cen_refs))
    got_imp = {i.ref: i for i in fplan.impacts}
    check([i.ref for i in fplan.impacts if i.ref != "serve/ingest"]
          == [ref_of[i.ref] for i in mplan.impacts], "census: federated impacts != merged")
    for i in mplan.impacts:
        g = got_imp[ref_of[i.ref]]
        check(torch.equal(g.rows, i.rows) and g.n_rows == i.n_rows
              and g.materialized == i.materialized and g.is_sink == i.is_sink,
              f"census: federated impact != merged at {i.ref}")
    check(torch.equal(got_imp["serve/ingest"].rows, got_imp[cen_refs[2]].rows),
          "census: the boundary's rows differ across the link")
    kinds = [(i.kind, i.residency) for i in fplan.invalidations]
    check(("cross", "fwd") in kinds and ("composed", "spilled") in kinds,
          f"census: invalidations {kinds}")
    dropped = apply_invalidations(cen_cat, fplan)
    pst = prep.composed().stats()
    check(dropped == len(fplan.invalidations) and not cen_cat._cross_store.entries
          and cen_cat._cross_store.nbytes == 0 and pst["entries"] == 0
          and pst["spilled_entries"] == 0 and pst["spill"]["entries"] < payloads,
          f"census: apply dropped {dropped} of {len(fplan.invalidations)}: {pst}")
    check(apply_invalidations(cen_cat, fplan) == 0, "census: a second apply dropped something")
    impact["census_federated"] = {
        "erased": len(census_rows), "impacts": len(fplan.impacts),
        "invalidations": [{"kind": i.kind, "scope": i.scope, "residency": i.residency}
                          for i in fplan.invalidations],
        "dropped": dropped, "spill_payloads": [payloads, pst["spill"]["entries"]],
        "est_total_ns": fplan.est_total_ns, "first_plan_ms": fplan_s * 1e3,
        "erasure_plan_ms": host_ms(lambda: erasure_plan(cen_cat, cen_src, census_rows)),
        "merged_erasure_plan_ms": host_ms(lambda: erasure_plan(m_idx, m_src, census_rows))}
    prep.composed()._spill_store.close()
    shutil.rmtree(store_dir, ignore_errors=True)
    del cen_cat, hot, prep

    n_wi = 100_000
    wrng = np.random.default_rng(3)
    src_cols = {"k": np.arange(n_wi, dtype=np.float32),
                "x": wrng.normal(size=n_wi).astype(np.float32),
                "y": wrng.normal(size=n_wi).astype(np.float32)}
    dims_cols = {"k": np.arange(n_wi, dtype=np.float32),
                 "w": wrng.normal(size=n_wi).astype(np.float32)}
    wi, wi_sink = build_whatif(src_cols, dims_cols, dev, "whatif")
    patched_rows = np.unique(wrng.integers(0, n_wi, size=8)).tolist()
    patch = {"x": [100.0 + i for i in range(len(patched_rows))]}
    recorded = {d: r.table for d, r in wi.datasets.items()}
    before = {d: (t.data.clone(), t.null.clone(), t.index.clone())
              for d, t in recorded.items() if t is not None}
    res, replay_s = sync_time(whatif_replay, wi, "src", patched_rows, patch, wi_sink)

    def full_rerun():
        cols = dict(src_cols, x=src_cols["x"].copy())
        cols["x"][patched_rows] = np.asarray(patch["x"], dtype=np.float32)
        ridx, rsink = build_whatif(cols, dims_cols, dev, "whatif_rerun")
        return fetch_rows(ridx, rsink, res.sink_rows)

    truth = full_rerun()
    ok = ~truth.null
    check(torch.equal(res.after.null, truth.null)
          and torch.allclose(res.after.data[ok], truth.data[ok], rtol=1e-5, atol=1e-5),
          "what-if replay != full re-run")
    check(bool(res.changed.any()), "what-if moved no sink row")
    for d, r in wi.datasets.items():
        check(r.table is recorded[d], f"what-if left another table at {d}")
        if r.table is not None:
            check(all(torch.equal(a, b) for a, b in
                      zip((r.table.data, r.table.null, r.table.index), before[d])),
                  f"what-if changed the recorded table {d}")
    impact["whatif"] = {
        "rows": n_wi, "patched": len(patched_rows), "sink_rows": wi.datasets[wi_sink].n_rows,
        "replayed_sink_rows": int(res.sink_rows.numel()), "changed": int(res.changed.sum()),
        "first_replay_ms": replay_s * 1e3,
        "whatif_replay_ms": host_ms(lambda: whatif_replay(wi, "src", patched_rows, patch,
                                                          wi_sink)),
        "full_rerun_ms": host_ms(full_rerun, reps=3),
        "tolerance": {"rtol": 1e-5, "atol": 1e-5}}
    del wi, res, truth
    emit({"phase": "impact", "card": card, "results": impact})

    # -- 7g. the Chapman baseline (Table IX, Table XI): German, Compas and
    # Census at their Table VIII sizes and the TPC-DI join at scale factors
    # 3, 5 and 9 (where the paper stops the baseline), each captured once
    # into an index and a ChapmanIndex through the record hook; records equal
    # the CPU run's on German, Compas and SF3; 64 probes each way scanned
    # against the index's Q1/Q2
    ops.reset_launch_counts()
    chapman = chapman_phase(dev, ("german", "compas", "census", "tpcdi_sf3", "tpcdi_sf5",
                                  "tpcdi_sf9"), ("german", "compas", "tpcdi_sf3"),
                            np.random.default_rng(SEED + 7))
    chapman_counts = ops.launch_counts()
    emit({"phase": "chapman", "card": card, "B": B, "results": chapman,
          "launch_counts": chapman_counts, "records_equal_cpu": ["german", "compas", "tpcdi_sf3"]})

    # -- 7h. the serving tier: 8 client threads submit 512 mixed single-probe
    # Q1/Q2/Q4 plans over the Compas and Census walk sessions (Compas on the
    # fused kernel), Census's bitplane hop-cache and the federated Compas
    # catalog of 7e, at (max_batch, max_wait_ms) (1, 0) and (64, 2); every
    # answer equals session.run's; the tier's batched_walk launches on
    # Compas equal its run_many lists replayed, and fused ones are fewer
    # than the per-request loop's
    fed_cat, fed_src, fed_sink = fed_compas
    census_bitplane = QuerySession(indexes["census"][0], bitplane["census"])
    serving_backends = {
        "compas_walk": (walk_sessions["compas"], *indexes["compas"]),
        "census_walk": (walk_sessions["census"], *indexes["census"]),
        "census_bitplane": (census_bitplane, *indexes["census"]),
        "compas_federated": (fed_cat.session(), fed_cat, fed_src, fed_sink),
    }
    serving, serving_counts = serving_phase(dev, serving_backends, 512, 8,
                                            ((1, 0.0), (64, 2.0)),
                                            np.random.default_rng(SEED + 8), "compas_walk")
    check(census_bitplane.counters["hopcache"] > 0, "the bitplane backend never probed")
    del fed_compas, fed_cat, serving_backends
    emit({"phase": "serving_tier", "card": card, "results": serving,
          "launch_counts": serving_counts})

    # -- 7i. the row-sharded view: Compas (whose chain takes the fused
    # kernel), Census and TPC-DI SF20 at 2, 4 and 8 shards; Census's seam
    # into a catalog of shard members at 2 shards
    sharded, sharded_counts = sharded_phase(
        dev, {n: indexes[n] for n in ("compas", "census", "tpcdi_sf20")}, answers, queries,
        (2, 4, 8), walk_sessions, ("census", 2))
    emit({"phase": "sharded", "card": card, "B": B, "results": sharded,
          "launch_counts": sharded_counts})

    # -- 7j. the LM serving path at full published width: OLMo-1B (float32
    # decode against forward, then bf16 behind a ServeEngine whose upstream
    # is a Compas prep index; lineage, erasure and the tier through the
    # federation) and gemma3-1b (bf16, the ring buffer wrapping); the olmo
    # and gemma3-1b smokes against the CPU
    t = time.perf_counter()
    lm_serving, lm_counts = lm_serving_phase(dev)
    emit({"phase": "lm_serving", "card": card, "seconds": time.perf_counter() - t,
          **lm_serving, "launch_counts": lm_counts})

    # -- 7k. every other model family through ServeEngine: mamba2-370m and
    # whisper-small at full size, qwen3-moe at full width with 2 layers
    # (float32 against forward and a plain MoE loop, then bf16 engines;
    # mamba2's behind a Compas prep index, its lineage and erasure
    # checked); the mamba2, jamba, qwen3-moe, dbrx and whisper smokes
    # against the CPU
    t = time.perf_counter()
    families, fam_counts = lm_families_phase(dev)
    emit({"phase": "lm_families", "card": card, "seconds": time.perf_counter() - t,
          **families, "launch_counts": fam_counts})

    # -- 7l. training: one float32 step of five smokes on the card against the
    # CPU; OLMo-1B at full width (seq 4,096, global batch 8) on a
    # TokenPipeline on the card, deterministic crash and resume, the full
    # state checkpointed and restored; every step's batch lineage on the
    # fused walk
    train, train_counts = train_phase(dev)
    emit({"phase": "train", "card": card, **train, "launch_counts": train_counts})

    # -- 7m. the mesh layer: world size 1 on NCCL (Census's sharded
    # composition, audit and frontier; the collective engine on Compas,
    # Census and SF20; OLMo-1B's step on a (1, 1) mesh bit for bit, its
    # state restored onto the mesh), then 4 ranks on the card over gloo
    # (the engine at 4 shards, Census at 4 ranks, the qwen3-moe smoke's
    # sharded step with 4 MoE groups)
    mesh_res, mesh_counts = mesh_phase(dev, indexes, queries, answers)
    emit({"phase": "mesh", "card": card, "B": B, **mesh_res, "launch_counts": mesh_counts})

    # -- 7n. the dry-run accounting: OLMo-1B's train_4k-cut cell on a (1, 1)
    # mesh against the card's state bytes, FLOPs and peak; OLMo-1B's four
    # cells on 256 fake ranks, llama3-405b's train_4k on 512; perf's lowmem
    dryrun_res, dryrun_counts = dryrun_phase(dev)
    emit({"phase": "dryrun", "card": card, **dryrun_res, "launch_counts": dryrun_counts})

    # -- 7o. the seven examples of examples/torch on the card, landmarks checked
    examples_res, examples_counts = examples_phase(dev)
    emit({"phase": "examples", "card": card, **examples_res, "launch_counts": examples_counts})

    # -- 8. calibration on the card (not installed) -----------------------------
    # twice, on grids drawn from two seeds: the two fits show how far the
    # fitted constants move between runs
    fits = []
    for cal_seed in (0, 1):
        t = time.perf_counter()
        fitted = calibrate.calibrate(path=str(ROOT / "build" / f"calibration_smoke{cal_seed}.json"),
                                     install=False, seed=cal_seed, device=dev)
        fits.append({"seed": cal_seed, "seconds": time.perf_counter() - t,
                     "path": str(Path(fitted.path).relative_to(ROOT)),
                     "density_threshold": fitted.density_threshold,
                     "constants": {k: getattr(fitted, k) for k in (
                         "c_word_op", "c_spmm_flop", "c_spmm_overhead", "c_launch_overhead",
                         "peak_flops", "hbm_bw", "link_bw", "logic_word_ops")}})
    probe_plan = prov(ci_idx).source(csink).rows_batch(queries["compas"]["q2"]).backward() \
        .to(csrc).plan()
    check(ci_idx.session().explain(probe_plan)["constants"]["source"] == "default",
          "calibration was installed")
    thr = [f["density_threshold"] for f in fits]
    emit({"phase": "calibration", "device": fitted.device, "fits": fits,
          "threshold_ratio": max(thr) / min(thr)})

    # -- 9. times -----------------------------------------------------------------
    # "ms" is device time (device_ms: the calls queued behind a device spin,
    # so the events bracket device work only); "host_paced_ms" is the same
    # calls timed back to back as the host issues them (event_ms), which for
    # a kernel shorter than its Python launcher measures the launcher
    def unpack16(words, n):
        return ref.unpack_bits(words, n).to(torch.float16)

    def bitmatmul_times(a, bb, plain_reps, plain_rounds):
        """Kernel, plain and fp16 torch.matmul times and the bound of one
        bitmatmul call; the bound counts the B rows any row of A selects
        (read once), A in and C out, and one AND and one OR per selected B
        word per row."""
        k = bb.shape[0]
        sel = ref.unpack_bits(a, k)
        rows_read = int(sel.any(dim=0).sum())
        bits = int(sel.sum())
        nw = bb.shape[1]
        moved = (a.numel() + rows_read * nw + a.shape[0] * nw) * 4
        word_ops = 2 * bits * nw
        dense_a, dense_b = unpack16(a, k), unpack16(bb, nw * 32)
        row = {
            "shape": {"A": list(a.shape), "B": list(bb.shape)},
            "geometry": bitmatmul_geometry(a.shape[0], nw)._asdict(),
            "ms": device_ms(lambda: bitmatmul_cuda(a, bb)),
            "host_paced_ms": event_ms(lambda: bitmatmul_cuda(a, bb)),
            "plain_ms": device_ms(lambda: ref.bitmatmul_ref(a, bb),
                                  reps=plain_reps, rounds=plain_rounds, warmup=1),
            "library_ms": device_ms(lambda: torch.matmul(dense_a, dense_b),
                                    reps=plain_reps, rounds=plain_rounds, warmup=1),
            "bound_bytes": moved, "bound_word_ops": word_ops,
            "bytes_ms": moved / HBM_BYTES_PER_S * 1e3,
            "ops_ms": word_ops / INT_OPS_PER_S * 1e3,
        }
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        row["bound_by"] = "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations"
        return row

    compas_rel = bitplane["compas"].relation(csrc, csink)
    bm_rows = {
        "compas_probe": bitmatmul_times(q1_mask, compas_rel, 5, 7),
        "compas_composition": bitmatmul_times(*compositions["compas"], 3, 5),
        "census_composition": bitmatmul_times(*compositions["census"], 1, 3),
        "attribute_hop": bitmatmul_times(attr_a, attr_b, 20, 7),
    }
    del compositions

    # bitset_rank and lineage_gather at three shapes each: (a) the unfused
    # Compas Q2 chain's first hop and (b) the unfused Census Q2 chain's
    # first hop, both checked against their plain versions in phase 7, and
    # (c) TPC-DI SF20: the rank over the 64-probe Q2 frontier at the join's
    # left input, packed as the per-hop baseline packs it (W = 64 x 75,344
    # words), and the gather of every row of the join's out -> in CSR, in
    # order (max_deg 1).  The SF20 inputs are first held to their plain
    # versions exactly, then copied until the copies exceed the 50 MB L2,
    # and the timed calls rotate among the copies: a cold cache, as a
    # caller meets it.
    ji, jsrc, jsink = indexes["tpcdi_sf20"]
    join_t, filter_t = ji.ops[0].tensor, ji.ops[1].tensor
    left = join_t.backward_mask_batch(0, filter_t.backward_mask_batch(
        0, mask_stack(queries["tpcdi_sf20"]["q2"], ji.datasets[jsink].n_rows)))
    check(tuple(left.shape) == (B, ji.datasets[jsrc].n_rows), f"SF20 frontier {tuple(left.shape)}")
    for b, rows in enumerate(answers["tpcdi_sf20"][1]):
        check(torch.equal(torch.nonzero(left[b]).reshape(-1), rows.to(torch.int64)),
              f"SF20 Q2 frontier row {b} != the walk's answer")
    frontier = ref.pack_bits(left)
    sf20_words = frontier.reshape(-1)
    sf20_ends = torch.arange(1, B + 1, dtype=torch.int32, device=dev) * (frontier.shape[1] * 32) - 1
    got = bitset_rank_cuda(sf20_words, sf20_ends)
    sf20_rank_err = int((got - ref.bitset_rank_ref(sf20_words, sf20_ends)).abs().max())
    check(sf20_rank_err == 0, "bitset_rank != plain at the SF20 frontier")
    check(torch.equal(torch.diff(got, prepend=got.new_zeros(1)), left.sum(dim=1).to(torch.int32)),
          "SF20 rank differences != the probes' frontier sizes")
    jcsr = join_t.bwd(0)
    sf20_queries = torch.arange(jcsr.n_rows, dtype=torch.int32, device=dev)
    check(bool((torch.diff(jcsr.row_ptr) == 1).all()), "the SF20 join's out -> in CSR is not degree 1")
    got = lineage_gather_cuda(sf20_queries, jcsr.row_ptr, jcsr.col_idx, 1)
    sf20_gather_err = int((got - ref.lineage_gather_ref(sf20_queries, jcsr.row_ptr, jcsr.col_idx,
                                                        max_deg=1)).abs().max())
    check(sf20_gather_err == 0 and torch.equal(got[:, 0], jcsr.col_idx),
          "lineage_gather != plain on the SF20 join's out -> in CSR")
    torch.cuda.synchronize()
    rank_err = max(rank_err, sf20_rank_err)
    gather_err = max(gather_err, sf20_gather_err)
    rank_copies = [(sf20_words.clone(), sf20_ends.clone()) for _ in range(8)]
    gather_copies = [(sf20_queries.clone(), jcsr.row_ptr.clone(), jcsr.col_idx.clone())
                     for _ in range(5)]
    del left, frontier, got
    c0 = census_q2_hop0
    h = hops["q2"][0]
    rank_rows = {
        "compas_q2_hop0": rank_times([(h["flat"], h["ends"])]),
        "census_q2_hop0": rank_times([(c0["flat"], c0["ends"])]),
        "tpcdi_sf20_q2_join": rank_times(rank_copies),
    }
    gather_rows = {
        "compas_q2_hop0": gather_times([(qs, h["rp"], h["col"])], h["md"], plain_reps=20),
        "census_q2_hop0": gather_times([(qs, c0["rp"], c0["col"])], c0["md"], plain_reps=20),
        "tpcdi_sf20_join_bwd": gather_times(gather_copies, 1),
    }
    del rank_copies, gather_copies
    rank_row, gather_row = rank_rows["compas_q2_hop0"], gather_rows["compas_q2_hop0"]

    walk_ms = device_ms(lambda: batched_walk_cuda(q2_mask, compas_bwd))
    walk_host_paced_ms = event_ms(lambda: batched_walk_cuda(q2_mask, compas_bwd))
    walk_plain_ms = device_ms(lambda: ref.batched_walk_ref(q2_mask, compas_bwd), reps=2)
    dense = [unpack16(p, p.shape[1] * 32) for p in compas_bwd]
    sel16 = unpack16(q2_mask, compas_bwd[0].shape[0])

    def matmul_chain():
        cur = sel16
        for plane in dense:
            cur = torch.matmul(cur[:, : plane.shape[0]], plane)
        return cur

    walk_library_ms = device_ms(matmul_chain, reps=5)
    del dense
    tiny_mask = torch.ones((1, 1), dtype=torch.int32, device=dev)
    tiny_plane = [torch.ones((1, 1), dtype=torch.int32, device=dev)]
    launch_floor_ms = device_ms(lambda: batched_walk_cuda(tiny_mask, tiny_plane))
    launch_floor_host_paced_ms = event_ms(lambda: batched_walk_cuda(tiny_mask, tiny_plane))
    unfused_ms = host_ms(lambda: ops.batched_walk_unfused(q2_mask, compas_bwd))

    # rows per probe: B = 64 probes of r random rows each, through the Compas
    # Q2 chain (walk) and against the composed Compas relation (probe); a
    # kernel that waits on each row load grows with r at one load latency a
    # row.  Timed through the entry points.
    rng_r = np.random.default_rng(SEED)

    def random_masks(r, n):
        m = torch.zeros((B, n), dtype=torch.bool, device=dev)
        for b in range(B):
            m[b, torch.as_tensor(rng_r.choice(n, r, replace=False), device=dev)] = True
        return ref.pack_bits(m)

    scaling = {}
    for r in (1, 8, 64):
        m2 = random_masks(r, ci_idx.datasets[csink].n_rows)
        m1 = random_masks(r, ci_idx.datasets[csrc].n_rows)
        scaling[r] = {"walk_ms": device_ms(lambda: ops.batched_walk(m2, compas_bwd)),
                      "probe_ms": device_ms(lambda: ops.bitmatmul(m1, compas_rel))}
    census_walk_ms = device_ms(lambda: ops.batched_walk(cmask, census_planes), reps=10)
    del census_planes

    # bound of the fused walk: the plane rows some probe selects (read once),
    # the masks in, the frontier and counts out; one AND and one OR per
    # selected word per probe
    cur = q2_mask
    plane_bytes = 0
    word_ops = 0
    for plane in compas_bwd:
        sel_bits = ref.unpack_bits(cur, plane.shape[0])
        plane_bytes += int(sel_bits.any(dim=0).sum()) * plane.shape[1] * 4
        word_ops += 2 * int(sel_bits.sum()) * plane.shape[1]
        cur = ref.bitmatmul_ref(cur, plane)
    io_bytes = (q2_mask.numel() + cur.numel() + len(compas_bwd) * B) * 4
    walk_bytes_ms = (plane_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    walk_ops_ms = word_ops / INT_OPS_PER_S * 1e3
    walk_bound_ms = max(walk_bytes_ms, walk_ops_ms)
    emit({"phase": "kernel_times", "card": card,
          "batched_walk": {
              "shape": {"K": len(compas_bwd), "B": B, "rows": [p.shape[0] for p in compas_bwd],
                        "words": [p.shape[1] for p in compas_bwd]},
              "geometry": walk_geometry(B, max(p.shape[1] for p in [q2_mask, *compas_bwd]))._asdict(),
              "ms": walk_ms, "host_paced_ms": walk_host_paced_ms, "plain_ms": walk_plain_ms,
              "library_ms": walk_library_ms,
              "library": "per-hop torch.matmul on 0/1 float16 (K calls)",
              "bound_ms": walk_bound_ms, "bound_bytes": plane_bytes + io_bytes,
              "bound_word_ops": word_ops, "launch_floor_ms": launch_floor_ms,
              "launch_floor_host_paced_ms": launch_floor_host_paced_ms,
              "unfused_host_ms": unfused_ms,
              "all_planes_bytes": sum(p.numel() * 4 for p in compas_bwd)},
          "bitmatmul": bm_rows,
          "bitmatmul_library": "one torch.matmul of the unpacked 0/1 float16 operands",
          "bitset_rank": rank_rows, "lineage_gather": gather_rows,
          "rows_per_probe": scaling, "census_walk_1pct_ms": census_walk_ms,
          "no_library": "neither bitset_rank nor lineage_gather has a one-call PyTorch "
                        "counterpart"})

    # end-to-end latency (host clock, synchronized): the walk session (fused
    # kernel on), the default hop-cache session, and the bitplane hop-cache
    latency = {}
    for name, (idx, src, sink) in indexes.items():
        qs_ = queries[name]
        q2b = prov(idx).source(sink).rows_batch(qs_["q2"]).backward().to(src)
        plan = q2b.plan()
        ws = walk_sessions[name]
        latency[name] = {
            "walk_q1_ms": host_ms(lambda: q1(idx, src, sink, qs_["q1"], ws)),
            "walk_q2_ms": host_ms(lambda: q2(idx, src, sink, qs_["q2"], ws)),
            "q2_plan_ms": host_ms(q2b.plan),
            "walk_q2_run_ms": host_ms(lambda: ws.run(plan)),
            "hopcache_q1_ms": host_ms(lambda: q1(idx, src, sink, qs_["q1"])),
            "hopcache_q2_ms": host_ms(lambda: q2(idx, src, sink, qs_["q2"])),
            "hopcache_q2_run_ms": host_ms(lambda: idx.session().run(plan)),
        }
        if name in bitplane:
            bs = QuerySession(idx, bitplane[name])    # relation composed: routes to it
            latency[name]["bitplane_q1_ms"] = host_ms(lambda: q1(idx, src, sink, qs_["q1"], bs))
            latency[name]["bitplane_q2_ms"] = host_ms(lambda: q2(idx, src, sink, qs_["q2"], bs))
            check(bs.counters["hopcache"] == bs.counters["plans"], f"{name}: bitplane session walked")
    emit({"phase": "main_path_times", "card": card, "B": B, "latency": latency,
          "capture_s": capture_s, "main_path_max_memory_allocated_bytes": main_peak,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev),
          "seconds": time.perf_counter() - t_start})

    bm = bm_rows["compas_probe"]

    def user_path_launches(k):
        return {"per_hop_baseline": unfused_counts.get(k, 0), "walk": main_counts.get(k, 0),
                "hopcache_default": default_counts.get(k, 0),
                "hopcache_bitplane": bitplane_counts.get(k, 0),
                "attribute": attr_counts.get(k, 0), "spill_hopcache": spill_hc_counts.get(k, 0),
                "federation": fed_counts.get(k, 0), "chapman": chapman_counts.get(k, 0),
                "serving_tier": serving_counts.get(k, 0), "sharded": sharded_counts.get(k, 0),
                "lm_serving": lm_counts.get(k, 0), "lm_families": fam_counts.get(k, 0),
                "train": train_counts.get(k, 0), "mesh": mesh_counts.get(k, 0),
                "dryrun": dryrun_counts.get(k, 0), "examples": examples_counts.get(k, 0)}

    def by_shape(rows):
        return {name: {key: r[key] for key in ("ms", "host_paced_ms", "plain_ms", "bound_ms",
                                               "bound_by", "share_of_bound", "launches_per_call")}
                for name, r in rows.items()}

    emit({"kernels": [
        {"name": "batched_walk", "route": "cuda", "source": "src/repro_torch/csrc/batched_walk.cu",
         "replaces": "src/repro/kernels/batched_walk.py:44",
         "launches": main_counts.get("batched_walk", 0), "max_abs_err": walk_err,
         "launches_by_path": {"walk": main_counts.get("batched_walk", 0),
                              "spill_tensors": spill_t_walks,
                              "federation": fed_counts.get("batched_walk", 0),
                              "chapman": chapman_counts.get("batched_walk", 0),
                              "serving_tier": serving_counts.get("batched_walk", 0),
                              "sharded": sharded_counts.get("batched_walk", 0),
                              "lm_serving": lm_counts.get("batched_walk", 0),
                              "lm_families": fam_counts.get("batched_walk", 0),
                              "train": train_counts.get("batched_walk", 0),
                              "mesh": mesh_counts.get("batched_walk", 0),
                              "dryrun": dryrun_counts.get("batched_walk", 0),
                              "examples": examples_counts.get("batched_walk", 0)},
         "ms": walk_ms, "plain_ms": walk_plain_ms, "bound_ms": walk_bound_ms,
         "bound_by": "bytes" if walk_bytes_ms >= walk_ops_ms else "operations",
         "library_ms": walk_library_ms},
        {"name": "bitmatmul", "route": "cuda", "source": "src/repro_torch/csrc/bitmatmul.cu",
         "replaces": "src/repro/kernels/bitmatmul.py:37",
         "launches": bitplane_counts.get("bitmatmul", 0), "max_abs_err": bm_err,
         "launches_by_path": {"hopcache_bitplane": bitplane_counts.get("bitmatmul", 0),
                              "attribute": attr_counts.get("bitmatmul", 0),
                              "spill_hopcache": spill_hc_counts.get("bitmatmul", 0),
                              "federation": fed_counts.get("bitmatmul", 0),
                              "chapman": chapman_counts.get("bitmatmul", 0),
                              "serving_tier": serving_counts.get("bitmatmul", 0),
                              "sharded": sharded_counts.get("bitmatmul", 0),
                              "lm_serving": lm_counts.get("bitmatmul", 0),
                              "lm_families": fam_counts.get("bitmatmul", 0),
                              "train": train_counts.get("bitmatmul", 0),
                              "mesh": mesh_counts.get("bitmatmul", 0),
                              "dryrun": dryrun_counts.get("bitmatmul", 0),
                              "examples": examples_counts.get("bitmatmul", 0)},
         "ms": bm["ms"], "plain_ms": bm["plain_ms"], "bound_ms": bm["bound_ms"],
         "bound_by": bm["bound_by"], "library_ms": bm["library_ms"]},
        {"name": "bitset_rank", "route": "cuda", "source": "src/repro_torch/csrc/bitset_rank.cu",
         "replaces": "src/repro/kernels/bitset_rank.py:27",
         "launches": unfused_counts.get("bitset_rank", 0), "max_abs_err": rank_err,
         "launches_by_path": user_path_launches("bitset_rank"),
         "ms": rank_row["ms"], "plain_ms": rank_row["plain_ms"], "bound_ms": rank_row["bound_ms"],
         "bound_by": rank_row["bound_by"], "library_ms": None,
         "by_shape": by_shape(rank_rows)},
        {"name": "lineage_gather", "route": "cuda",
         "source": "src/repro_torch/csrc/lineage_gather.cu",
         "replaces": "src/repro/kernels/lineage_gather.py:34",
         "launches": unfused_counts.get("lineage_gather", 0), "max_abs_err": gather_err,
         "launches_by_path": user_path_launches("lineage_gather"),
         "ms": gather_row["ms"], "plain_ms": gather_row["plain_ms"],
         "bound_ms": gather_row["bound_ms"], "bound_by": gather_row["bound_by"],
         "library_ms": None, "by_shape": by_shape(gather_rows)},
    ]})
    for k in ("bitset_rank", "lineage_gather"):
        user = {p: n for p, n in user_path_launches(k).items() if p != "per_hop_baseline"}
        check(not any(user.values()), f"{k} launched on a user path: {user}")
    for k in ("batched_walk", "bitmatmul", "bitset_rank", "lineage_gather"):
        n = {"batched_walk": main_counts, "bitmatmul": bitplane_counts}.get(k, unfused_counts)
        check(n.get(k, 0) > 0, f"{k} was not launched on its path")
    for path, n in (("attribute", attr_counts), ("spill_hopcache", spill_hc_counts),
                    ("federation", fed_counts), ("serving_tier", serving_counts),
                    ("mesh", mesh_counts), ("examples", examples_counts)):
        check(n.get("bitmatmul", 0) > 0, f"bitmatmul was not launched on the {path} path")
    for path, n in (("federation", fed_counts), ("serving_tier", serving_counts),
                    ("sharded", sharded_counts), ("lm_serving", lm_counts),
                    ("lm_families", fam_counts), ("train", train_counts),
                    ("examples", examples_counts)):
        check(n.get("batched_walk", 0) > 0, f"batched_walk was not launched on the {path} path")
    check(not any(dryrun_counts.values()), f"the dry run launched a kernel: {dryrun_counts}")
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
