#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card, ``nvcc`` and
PyTorch built for CUDA.  It

1. prints the environment and requires compute capability (9, 0);
2. builds every kernel from ``src/repro_torch/csrc`` (into ``build/``);
3. holds the ``batched_walk`` kernel against its plain PyTorch version on
   the card, exactly (integer words and counts: tolerance 0), over a sweep
   of hop counts, batch sizes, widths and densities;
4. drives the port's main path on the card: capture of the German, Compas
   and Census use cases at their Table VIII sizes and of a TPC-DI join at
   scale factor 20 followed by a filter, then B = 64 Q1 and Q2 probes
   through ``prov(index)...run()``, Q5/Q6 on German and Q9-Q11 on Compas.
   Launch counts are zeroed just before and read just after; Compas must
   launch the fused kernel.  Every answer must equal the per-op walk on the
   card, and German, Compas and a scale-factor-3 join must also equal the
   port run on the CPU.  The kernel is then held against its plain version
   on the Compas chain's real planes and on a Census-sized 5-hop chain;
5. times the kernel at the Compas Q2 shape (CUDA events, medians) beside
   its plain version, a per-hop ``torch.matmul`` yardstick and its bound,
   plus end-to-end query latencies, capture times and peak memory.

Every phase prints one JSON line.  Any failure raises and the exit code is
not 0.  The last three lines are the kernel table, the card's name and
power limit as ``nvidia-smi`` gives them, and ``{"ok": true, ...}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (published)
INT_OPS_PER_S = 67e12         # H100 SXM CUDA-core rate outside the tensor cores (published)
SEED = 1234
B = 64


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


def host_ms(fn, reps: int = 7) -> float:
    fn()
    times = []
    for _ in range(reps):
        _, dt = sync_time(fn)
        times.append(dt * 1e3)
    return statistics.median(times)


def word_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over 32-bit words read as unsigned, 0 iff equal."""
    if a.numel() == 0:
        return 0
    ua = a.to(torch.int64) & 0xFFFFFFFF
    ub = b.to(torch.int64) & 0xFFFFFFFF
    return int((ua - ub).abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 2

    from repro_torch.core.pipeline import ProvenanceIndex
    from repro_torch.core.query import (
        forward_record_masks_batch,
        fused_walk_record_masks_batch,
    )
    from repro_torch.dataprep import usecases as U
    from repro_torch.dataprep.tracked import track
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.batched_walk import batched_walk_cuda
    from repro_torch.provenance import QuerySession, prov

    # -- 1. environment --------------------------------------------------------
    dev = torch.device("cuda", 0)
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

    # -- 3. kernel against its plain version (synthetic sweep) -------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    widths = (1, 31, 33, 1000, 7214)
    max_err = 0
    n_cases = 0
    for k in (1, 3, 7):
        for b in (1, 8, 64, 257):
            for di, dens in enumerate((0.0, 1e-3, 0.05, 0.5)):
                dims = [widths[(i + k + b + di) % len(widths)] for i in range(k + 1)]
                planes = [ref.pack_bits(torch.rand(dims[j], dims[j + 1], generator=gen,
                                                   device=dev) < dens) for j in range(k)]
                mask = ref.pack_bits(torch.rand(b, dims[0], generator=gen, device=dev)
                                     < max(dens, 0.01))
                out, cnt = batched_walk_cuda(mask, planes)
                want_out, want_cnt = ref.batched_walk_ref(mask, planes)
                torch.cuda.synchronize()
                err = max(word_err(out, want_out), int((cnt - want_cnt).abs().max()))
                check(err == 0, f"kernel != plain at K={k} B={b} dims={dims} density={dens}")
                max_err = max(max_err, err)
                n_cases += 1
    emit({"phase": "kernel_vs_plain", "cases": n_cases, "max_abs_err": max_err,
          "tolerance": 0})

    # -- 4. the main path on the card ----------------------------------------------
    rng = np.random.default_rng(SEED)
    capture_s = {}
    indexes = {}
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    for name, (make, run) in U.USECASES.items():
        idx = ProvenanceIndex(name)            # device=None: the card
        table = make()
        sink, dt = sync_time(run, idx, table)
        capture_s[name] = dt
        indexes[name] = (idx, idx.sources()[0], sink.dataset_id)
        data = sink.table.data[~sink.table.null]
        check(bool(torch.isfinite(data).all()), f"{name}: non-finite sink values")

    def run_join(scale, device):
        idx = ProvenanceIndex(f"tpcdi{scale}", device=device)
        left, right = U.make_tpcdi_join_inputs(scale, device=device)
        lt, rt = track(left, idx, "trade"), track(right, idx, "security")
        j = lt.join(rt, on="key", how="inner")
        f = j.filter_rows(j.table.col("l0") > 0.0).mark_sink()
        return idx, f.dataset_id

    (jidx, jsink), dt = sync_time(run_join, 20, dev)
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

    answers = {}
    launches = {}
    for name, (idx, src, sink) in indexes.items():
        before = ops.launch_counts().get("batched_walk", 0)
        a1 = q1(idx, src, sink, queries[name]["q1"])
        a2 = q2(idx, src, sink, queries[name]["q2"])
        torch.cuda.synchronize()
        launches[name] = ops.launch_counts().get("batched_walk", 0) - before
        answers[name] = (a1, a2)
    main_launches = ops.launch_counts().get("batched_walk", 0)
    main_peak = torch.cuda.max_memory_allocated(dev)
    for name in ("german", "compas"):
        check(launches[name] == 2, f"{name} Q1+Q2 launched batched_walk "
                                   f"{launches[name]} times, expected 2")
    emit({"phase": "main_path", "capture_s": capture_s,
          "rows": {n: {"source": i.datasets[s].n_rows, "sink": i.datasets[t].n_rows,
                       "sink_cols": i.datasets[t].n_cols}
                   for n, (i, s, t) in indexes.items()},
          "batched_walk_launches": launches,
          "fused_walk": {n: i.session().counters["fused_walk"]
                         for n, (i, _, _) in indexes.items()}})

    # every answer equals the per-op walk on the card
    for name, (idx, src, sink) in indexes.items():
        walk = QuerySession(idx, fused_walk=False)
        w1 = q1(idx, src, sink, queries[name]["q1"], walk)
        w2 = q2(idx, src, sink, queries[name]["q2"], walk)
        for got, want in ((answers[name][0], w1), (answers[name][1], w2)):
            check(len(got) == len(want) == B, f"{name}: batch size")
            for g, w in zip(got, want):
                check(torch.equal(g, w), f"{name}: fused/default answer != walk")

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
    for name in ("german", "compas"):
        make, run = U.USECASES[name]
        idx_c = ProvenanceIndex(name, device="cpu")
        sink_c = run(idx_c, make(device="cpu"))
        src_c = idx_c.sources()[0]
        cpu[name] = (idx_c, src_c, sink_c.dataset_id)
        for og, oc in zip(indexes[name][0].ops, idx_c.ops):
            check(og.tensor.nnz == oc.tensor.nnz, f"{name}: op nnz differs")
        same(answers[name][0], q1(idx_c, src_c, sink_c.dataset_id, queries[name]["q1"]),
             f"{name} Q1: card != CPU")
        same(answers[name][1], q2(idx_c, src_c, sink_c.dataset_id, queries[name]["q2"]),
             f"{name} Q2: card != CPU")
    jc, jc_sink = run_join(3, "cpu")
    jg, jg_sink = run_join(3, dev)
    qs3 = {"q1": probes(jc.datasets["trade"].n_rows), "q2": probes(jc.datasets[jc_sink].n_rows)}
    same(q1(jg, "trade", jg_sink, qs3["q1"]), q1(jc, "trade", jc_sink, qs3["q1"]),
         "tpcdi sf3 Q1: card != CPU")
    same(q2(jg, "trade", jg_sink, qs3["q2"]), q2(jc, "trade", jc_sink, qs3["q2"]),
         "tpcdi sf3 Q2: card != CPU")
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
    co = {}
    for which, (i, s, t) in (("card", indexes["compas"]), ("cpu", cpu["compas"])):
        mid = i.ops[1].output_id                    # the filter's output
        ps = queries["compas"]["q2"][:8]
        co[which] = (
            prov(i).source(t).transformations().run(),
            prov(i).source(mid).rows_batch(ps).co_contributory(s).run(),
            prov(i).source(t).rows_batch(ps).co_dependency(s, mid).run(),
        )
    q9, q10, q11 = co["card"]
    check([(r["op"], r["category"]) for r in q9]
          == [(r["op"], r["category"]) for r in co["cpu"][0]] and len(q9) == 7, "Q9")
    same(q10, co["cpu"][1], "Q10: card != CPU")
    same(q11, co["cpu"][2], "Q11: card != CPU")
    check(any(x.numel() for x in q10) and any(x.numel() for x in q11), "Q10/Q11 empty")
    emit({"phase": "answers", "equal_fused_vs_walk": sorted(indexes),
          "equal_card_vs_cpu": ["german", "compas", "tpcdi_sf3"],
          "q5_q6_probes": len(hows["card"][0]), "q9_ops": len(q9),
          "q10_q11_probes": len(q10)})

    # -- 3b. kernel against its plain version on real planes ------------------------
    ci, csrc, csink = indexes["compas"]
    chain = [op.tensor for op in ci.ops]
    compas_fwd = [t.bitplane_fwd(0) for t in chain]
    compas_bwd = [t.bitplane_bwd(0) for t in reversed(chain)]
    q2_mask = ref.pack_bits(torch.stack(
        [torch.zeros(ci.datasets[csink].n_rows, dtype=torch.bool, device=dev)
         .index_fill_(0, torch.tensor(p, device=dev), True)
         for p in queries["compas"]["q2"]]))
    q1_mask = ref.pack_bits(torch.stack(
        [torch.zeros(ci.datasets[csrc].n_rows, dtype=torch.bool, device=dev)
         .index_fill_(0, torch.tensor(p, device=dev), True)
         for p in queries["compas"]["q1"]]))
    for mask, planes in ((q1_mask, compas_fwd), (q2_mask, compas_bwd)):
        out, cnt = batched_walk_cuda(mask, planes)
        want_out, want_cnt = ref.batched_walk_ref(mask, planes)
        torch.cuda.synchronize()
        check(torch.equal(out, want_out) and torch.equal(cnt, want_cnt),
              "kernel != plain on the Compas chain")
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
          "kernel != plain on the Census-sized chain")
    emit({"phase": "kernel_vs_plain_real", "compas_hops": len(chain),
          "census_hops": len(census_planes), "census_rows": n_census,
          "max_abs_err": 0, "tolerance": 0})
    del census_planes, want_out, out

    # -- 5. times -----------------------------------------------------------------
    kernel_ms = event_ms(lambda: batched_walk_cuda(q2_mask, compas_bwd))
    plain_ms = event_ms(lambda: ref.batched_walk_ref(q2_mask, compas_bwd), reps=5)
    dense = [ref.unpack_bits(p, p.shape[1] * 32).to(torch.float16) for p in compas_bwd]
    sel = ref.unpack_bits(q2_mask, compas_bwd[0].shape[0]).to(torch.float16)

    def matmul_chain():
        cur = sel
        for j, plane in enumerate(dense):
            cur = torch.matmul(cur[:, : plane.shape[0]], plane)
        return cur

    library_ms = event_ms(matmul_chain, reps=5)
    del dense
    tiny_mask = torch.ones((1, 1), dtype=torch.int32, device=dev)
    tiny_plane = [torch.ones((1, 1), dtype=torch.int32, device=dev)]
    launch_floor_ms = event_ms(lambda: batched_walk_cuda(tiny_mask, tiny_plane))

    # bound: the plane rows some probe selects (read once), the masks in,
    # the frontier and counts out; one AND and one OR per selected word per probe
    cur = q2_mask
    plane_bytes = 0
    word_ops = 0
    for plane in compas_bwd:
        sel_bits = ref.unpack_bits(cur, plane.shape[0])
        plane_bytes += int(sel_bits.any(dim=0).sum()) * plane.shape[1] * 4
        word_ops += 2 * int(sel_bits.sum()) * plane.shape[1]
        cur = ref.bitmatmul_ref(cur, plane)
    io_bytes = (q2_mask.numel() + cur.numel() + len(compas_bwd) * B) * 4
    bytes_ms = (plane_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = word_ops / INT_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    emit({"phase": "kernel_times", "card": card, "shape": {
        "K": len(compas_bwd), "B": B, "rows": [p.shape[0] for p in compas_bwd],
        "words": [p.shape[1] for p in compas_bwd]},
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library": "per-hop torch.matmul on 0/1 float16 (K calls)",
        "bound_ms": bound_ms, "bound_bytes": plane_bytes + io_bytes,
        "bound_word_ops": word_ops, "launch_floor_ms": launch_floor_ms,
        "all_planes_bytes": sum(p.numel() * 4 for p in compas_bwd)})

    # end-to-end latency (host clock, synchronized), and Q2 split into
    # compiling the plan (probe masks built on the card) and running it
    latency = {}
    for name, (idx, src, sink) in indexes.items():
        qs = queries[name]
        q2b = prov(idx).source(sink).rows_batch(qs["q2"]).backward().to(src)
        plan = q2b.plan()
        latency[name] = {
            "q1_ms": host_ms(lambda: q1(idx, src, sink, qs["q1"])),
            "q2_ms": host_ms(lambda: q2(idx, src, sink, qs["q2"])),
            "q2_plan_ms": host_ms(q2b.plan),
            "q2_run_ms": host_ms(lambda: idx.session().run(plan)),
        }
    emit({"phase": "main_path_times", "card": card, "B": B, "latency": latency,
          "capture_s": capture_s, "main_path_max_memory_allocated_bytes": main_peak,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev)})

    emit({"kernels": [{
        "name": "batched_walk", "route": "cuda",
        "source": "src/repro_torch/csrc/batched_walk.cu",
        "replaces": "src/repro/kernels/batched_walk.py:44",
        "launches": main_launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
