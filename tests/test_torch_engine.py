"""The port's ``ServeEngine`` against ``repro``'s, scenario for scenario.

Twins of the engine tests of ``tests/test_federation.py`` (the upstream
attaches, the boundary link as a lineage assertion, the deprecated
``prov_index=`` shim, cached cross relations across new links),
``tests/test_impact.py`` (``erasure_impact``) and ``tests/test_serving.py``
(generation ids, lineage against hand-built plans, the tier backend, the
deprecation's call site, seeded sampling).  Each scenario runs once in each
package on the same numpy inputs: answers, dataset names, warnings, typed
errors and counters must be equal.  Greedy ``generate`` on the olmo and
gemma3-1b smokes, with the reference's JAX initialisation carried across,
must emit the reference's tokens; sampling is held to what the reference
asserts (seeded determinism, tokens in the vocabulary), since a
``torch.Generator`` is not ``jax.random``.  The launcher runs in a
subprocess on the CPU.
"""
import ast
import os
import subprocess
import sys
import types
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as r_smoke
from repro.core.pipeline import ProvenanceIndex as RIndex
from repro.dataprep.table import Table as RTable
from repro.dataprep.tracked import track as rtrack
from repro.models.registry import get_model as r_get_model
from repro.provenance import CapabilityError as RCapabilityError
from repro.provenance import ProvCatalog as RCatalog
from repro.provenance import prov as rprov
from repro.serve import engine as r_engine
from repro.serve.tier import ServingTier as RTier
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.pipeline import ProvenanceIndex
from repro_torch.dataprep.table import Table
from repro_torch.dataprep.tracked import track
from repro_torch.models import lm as TL
from repro_torch.models.carry import lm_params_from_numpy
from repro_torch.provenance import CapabilityError, ProvCatalog, prov
from repro_torch.provenance.catalog import qualify
from repro_torch.serve import GenerationResult, ServeEngine, ServingTier
from repro_torch.serve import engine as t_engine

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]

R = types.SimpleNamespace(
    name="repro", Index=RIndex, track=rtrack, prov=rprov, Catalog=RCatalog, Tier=RTier,
    table=lambda cols: RTable.from_columns(cols), mask=lambda m: m, module=r_engine,
    Engine=r_engine.ServeEngine, Result=r_engine.GenerationResult,
    CapabilityError=RCapabilityError, init={})
T = types.SimpleNamespace(
    name="port", Index=lambda name: ProvenanceIndex(name, device=CPU), track=track, prov=prov,
    Catalog=lambda name="catalog": ProvCatalog(name, device=CPU), Tier=ServingTier,
    table=lambda cols: Table.from_columns(cols, device=CPU), mask=torch.from_numpy,
    module=t_engine, Engine=ServeEngine, Result=GenerationResult,
    CapabilityError=CapabilityError, init={"device": CPU})


def rows(x):
    """An answer (numpy array or tensor) as a list of row ids."""
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x).tolist()


def bare_engine(P, name, **kw):
    """An engine with provenance wiring and no model (``object.__new__``,
    as the reference's tests build it)."""
    e = object.__new__(P.Engine)
    e._init_provenance(name, **kw, **P.init)
    return e


def result(P, b, request_ids):
    return P.Result(tokens=np.zeros((b, 2), np.int32), request_ids=np.asarray(request_ids))


def raised(fn, *ids):
    """(exception type name, message) of ``fn()``, which must raise; the
    dataset ``ids`` (each package numbers its own) read ``<id>``."""
    with pytest.raises(Exception) as e:
        fn()
    msg = str(e.value)
    for i in ids:
        msg = msg.replace(i, "<id>")
    return type(e.value).__name__, msg


def capability_fixture(P):
    prep = P.Index("prep")
    s = P.track(P.table({"k": np.arange(8, dtype=np.float32),
                         "x": np.ones(8, np.float32)}), prep, "raw")
    exported = s.filter_rows(P.mask(np.array([1, 1, 0, 1, 1, 0, 1, 1], bool)))
    sibling = s.value_transform("x", "scale", factor=2.0)  # NOT an ancestor
    downstream = exported.value_transform("x", "scale", factor=3.0)
    return prep, exported, sibling, downstream


def both(scenario):
    """Run ``scenario`` in both packages; their observations must be equal."""
    want, got = scenario(R), scenario(T)
    assert got == want
    return got


# ===========================================================================
# Twins of tests/test_federation.py
# ===========================================================================
def test_cross_relation_survives_unrelated_links():
    def scenario(P):
        prep, exported, _, _ = capability_fixture(P)
        engine = bare_engine(P, "serve:cachetest", upstream=prep.export(exported.dataset_id))
        sess = engine.federation
        sess.cross_min_demand = 0
        r1 = result(P, 3, [0, 1, 2])
        engine._record_generation(r1, prompt_len=2, n_new=2, request_source=None)
        got1 = rows(engine.response_lineage(r1, rows=[1], upstream="raw"))
        composes = [sess.counters["cross_composes"]]
        r2 = result(P, 2, [3, 0])
        engine._record_generation(r2, prompt_len=2, n_new=2, request_source=None)
        again = rows(engine.response_lineage(r1, rows=[1], upstream="raw"))
        composes.append(sess.counters["cross_composes"])
        return got1, again, composes, sess.counters["cross_probes"] >= 2

    got1, again, composes, probed = both(scenario)
    assert again == got1 and composes == [1, 1] and probed


def test_upstream_engine_requires_explicit_request_ids():
    def scenario(P):
        prep, exported, _, _ = capability_fixture(P)
        engine = bare_engine(P, "serve:reqids", upstream=prep.export(exported.dataset_id))
        obs = [raised(lambda: engine._record_generation(
            result(P, 3, np.arange(3)), prompt_len=2, n_new=2, request_source=None,
            request_ids_given=False))]
        obs.append(raised(lambda: engine._record_generation(
            result(P, 3, [0, 1, 99]), prompt_len=2, n_new=2, request_source=None),
            exported.dataset_id))
        obs.append(sorted(engine.prov.datasets))
        obs.append(len(engine.catalog.links))
        ok = result(P, 2, [2, -1])
        engine._record_generation(ok, prompt_len=2, n_new=2, request_source=None)
        got = engine.response_lineage_batch(ok, [[0], [1]], upstream="raw")
        obs.append([rows(g) for g in got])
        return obs

    obs = both(scenario)
    assert obs[0][0] == "ValueError" and "explicit request_ids" in obs[0][1]
    assert obs[1][0] == "ValueError" and "boundary dataset" in obs[1][1]
    assert obs[2] == [] and obs[3] == 0 and obs[4] == [[3], []]


def test_upstream_tuple_attach_validates_dataset():
    def scenario(P):
        prep, exported, _, _ = capability_fixture(P)
        catalog = P.Catalog()
        catalog.register("prep", prep)
        e = object.__new__(P.Engine)
        err = raised(lambda: e._init_provenance(
            "serve:typo", upstream=(catalog, "prep/definitely-missing"), **P.init))
        engine = bare_engine(P, "serve:ok", upstream=(catalog, qualify("prep", exported.dataset_id)))
        return (err[0], engine.catalog is catalog, sorted(catalog.members),
                engine._upstream == ("prep", exported.dataset_id))

    err, same, members, upstream = both(scenario)
    assert err == "KeyError" and same and members == ["prep", "serve"] and upstream


def test_serve_engine_upstream_holds_no_prep_index():
    def scenario(P):
        prep, exported, _, _ = capability_fixture(P)
        handle = prep.export(exported.dataset_id)
        engine = bare_engine(P, "serve:captest", upstream=handle)
        obs = [all(v is not prep for v in vars(engine).values()),
               engine.catalog.member_of(prep) is None,
               engine.catalog.members["prep"] is handle]
        err = raised(lambda: engine.catalog.members["prep"].record([], "x", None, None))
        obs.append(err[0] == P.CapabilityError.__name__)
        r = result(P, 3, [0, 2, 2])
        engine._record_generation(r, prompt_len=2, n_new=2, request_source=None)
        obs.append(rows(engine.response_lineage(r, rows=[1], upstream="raw")))
        got = engine.response_lineage_batch(r, [[0], [1], [2]], upstream="prep/raw")
        obs.append([rows(g) for g in got])
        return obs

    obs = both(scenario)
    assert obs[:4] == [True] * 4 and obs[4] == [3] and obs[5] == [[0], [3], [3]]


def test_serve_engine_prov_index_shim_warns_once_and_matches():
    def scenario(P):
        prep = P.Index("prep-shim")
        s = P.track(P.table({"k": np.arange(6, dtype=np.float32),
                             "x": np.ones(6, np.float32)}), prep, "raw")
        clean = s.filter_rows(P.mask(np.array([1, 0, 1, 1, 0, 1], bool)))
        clean.mark_sink()
        P.module._DEPRECATION_WARNED.discard("prov_index")
        with pytest.warns(DeprecationWarning, match="prov_index") as rec:
            e = bare_engine(P, "serve:shim", prov_index=prep)
        obs = [[str(w.message) for w in rec], e.prov is prep, list(e.catalog.members)]
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            bare_engine(P, "serve:shim2", prov_index=prep)     # silent now
        r = result(P, 3, [0, 2, 2])
        e._record_generation(r, prompt_len=2, n_new=2, request_source=clean.dataset_id)
        obs.append(rows(e.response_lineage(r, rows=[1], upstream="raw")))
        obs.append((r.request_dataset == clean.dataset_id, r.response_dataset))
        obs.append(raised(lambda: bare_engine(P, "serve:both", upstream=prep.export("raw"),
                                              prov_index=prep)))
        return obs

    obs = both(scenario)
    assert len(obs[0]) == 1 and obs[1] and obs[2] == ["serve"]
    assert obs[3] == [3]     # response row 1 <- clean row 2 <- raw row 3
    assert obs[5][0] == "ValueError" and "not both" in obs[5][1]


# ===========================================================================
# Twin of tests/test_impact.py::test_serve_engine_erasure_impact
# ===========================================================================
def test_serve_engine_erasure_impact():
    def scenario(P):
        rng = np.random.default_rng(0)
        prep = P.Index("prep-serve")
        s = P.track(P.table({"k": np.arange(16, dtype=np.float32),
                             "x": rng.normal(size=16).astype(np.float32)}), prep, "raw")
        clean = s.value_transform("x", "scale", factor=2.0)
        clean.mark_sink()
        engine = bare_engine(P, "serve:test", upstream=prep.export(clean.dataset_id))
        req = P.table({"x": rng.normal(size=4).astype(np.float32)})
        P.track(req, engine.prov, "requests@0").mark_sink()
        up_name, boundary = engine._upstream
        engine.catalog.link(qualify(up_name, boundary),
                            qualify(engine._serve_name, "requests@0"),
                            alignment=np.array([2, 5, 7, 2]))
        plan = engine.erasure_impact([2])
        by_ref = {i.ref: rows(i.rows) for i in plan.impacts}
        bare = bare_engine(P, "serve:bare")
        return (qualify(up_name, boundary) in by_ref,
                by_ref[qualify(engine._serve_name, "requests@0")],
                raised(lambda: bare.erasure_impact([0])))

    has_boundary, req_rows, err = both(scenario)
    assert has_boundary and req_rows == [0, 3]
    assert err[0] == "ValueError" and "source=" in err[1]


# ===========================================================================
# Twins of tests/test_serving.py's engine tests
# ===========================================================================
def recorded_engine(P, b=4):
    engine = bare_engine(P, "serve:tiertest")
    r = result(P, b, np.arange(b))
    engine._record_generation(r, prompt_len=2, n_new=2, request_source=None)
    return engine, r


def test_record_gid_collision_loops_to_free_slot():
    def scenario(P):
        engine = bare_engine(P, "serve:gid")
        engine.prov.add_source("responses@0", P.table({"z": np.zeros(2, np.float32)}))
        r = result(P, 3, np.arange(3))
        engine._record_generation(r, prompt_len=1, n_new=2, request_source=None)
        r2 = result(P, 2, np.arange(2))
        engine._record_generation(r2, prompt_len=1, n_new=2, request_source=None)
        return ((r.request_dataset, r.response_dataset), r2.response_dataset,
                rows(engine.response_lineage(r, rows=[2])),
                rows(engine.response_lineage(r2, rows=[0])))

    assert both(scenario) == (("requests@1", "responses@1"), "responses@2", [2], [0])


def test_response_lineage_matches_hand_built_plans():
    def scenario(P):
        engine, r = recorded_engine(P)
        got = rows(engine.response_lineage(r, rows=[0, 2]))
        ref = rows(P.prov(engine.prov).source(r.response_dataset).rows([0, 2])
                   .backward().to(r.request_dataset).run(engine.session))
        batch = [rows(x) for x in engine.response_lineage_batch(r, [[0], [1], [2, 3]])]
        refs = [rows(x) for x in engine.session.run_many([
            P.prov(engine.prov).source(r.response_dataset).rows(rs)
            .backward().to(r.request_dataset).plan() for rs in [[0], [1], [2, 3]]])]
        return got, ref, batch, refs, rows(engine.response_lineage(r))

    got, ref, batch, refs, everything = both(scenario)
    assert got == ref == [0, 2] and batch == refs == [[0], [1], [2, 3]]
    assert everything == [0, 1, 2, 3]


def test_engine_backend_qualifies_bare_refs_through_tier():
    def scenario(P):
        engine, r = recorded_engine(P)
        backend = engine.as_backend()
        bare = (P.prov(engine.prov).source(r.response_dataset).rows([1])
                .backward().to(r.request_dataset).plan())
        prepared = backend.prepare(bare)
        qualified = (P.prov(engine.catalog)
                     .source(f"serve/{r.response_dataset}").rows([1])
                     .backward().to(f"serve/{r.request_dataset}").plan())
        with P.Tier(backend, max_batch=4, max_wait_ms=1.0) as tier:
            got_bare = rows(tier.submit_sync("a", bare, timeout=30))
            got_qual = rows(tier.submit_sync("b", qualified, timeout=30))
            st = tier.stats()
        return (prepared.source, prepared.target, got_bare, got_qual,
                rows(engine.response_lineage(r, rows=[1])), "backend" in st)

    src, dst, got_bare, got_qual, ref, has_backend = both(scenario)
    assert (src, dst) == ("serve/responses@0", "serve/requests@0")
    assert got_bare == got_qual == ref == [1] and has_backend


def test_prov_index_deprecation_attributes_callers_file():
    for P in (R, T):
        prep = P.Index("prep-warnfile")
        P.track(P.table({"k": np.arange(3, dtype=np.float32)}), prep, "raw").mark_sink()
        P.module._DEPRECATION_WARNED.discard("prov_index")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            e = object.__new__(P.Engine)
            e._init_provenance("serve:warnfile", prov_index=prep, **P.init)
        dep = [w for w in caught if issubclass(w.category, DeprecationWarning)
               and "prov_index" in str(w.message)]
        assert len(dep) == 1, P.name
        assert dep[0].filename == __file__, P.name


# ===========================================================================
# Generation with the model
# ===========================================================================
def carried_engines(arch, dtype=jnp.float32, tdtype=torch.float32, max_seq=12, **kw):
    rc, tc = r_smoke(arch), get_smoke_config(arch)
    rp = r_get_model(rc).init_params(rc, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(tc, jax.tree.map(np.asarray, rp), CPU)
    return (r_engine.ServeEngine(rc, rp, max_seq=max_seq, dtype=dtype, **kw.get("r", {})),
            ServeEngine(tc, tp, max_seq=max_seq, dtype=tdtype, device=CPU, **kw.get("t", {})))


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma3-1b"])
def test_greedy_generate_matches_reference(arch):
    """Prompts of 6 tokens, two of them left-padded with -1 (token 0, not
    masked), then 6 greedy tokens: the reference's tokens, dataset names and
    lineage.  gemma3-1b's smoke window of 8 makes its local layers' 8-slot
    caches wrap within the 12 steps."""
    re, te = carried_engines(arch)
    rng = np.random.default_rng(7)
    prompts = rng.integers(1, re.cfg.vocab, (4, 6)).astype(np.int32)
    prompts[1, :2] = -1
    prompts[3, :1] = -1
    a = re.generate(prompts, n_new=6, record_provenance=True)
    b = te.generate(prompts, n_new=6, record_provenance=True)
    assert b.tokens.dtype == np.int32 and b.tokens.shape == (4, 6)
    np.testing.assert_array_equal(b.tokens, a.tokens)
    assert (b.request_dataset, b.response_dataset) == (a.request_dataset, a.response_dataset)
    assert rows(te.response_lineage(b, rows=[3])) == rows(re.response_lineage(a, rows=[3]))


def test_bf16_engine_casts_once():
    """A bf16 engine holds bf16 weights (float32 norm scales) and emits the
    tokens of decoding with its float32 params cast at every matmul."""
    cfg = get_smoke_config("gemma3-1b")
    params = TL.init_params(cfg, torch.Generator().manual_seed(3), CPU)
    engine = ServeEngine(cfg, params, max_seq=10, device=CPU)
    assert engine.dtype == torch.bfloat16
    for name, t in engine.params.state_dict().items():
        assert t.dtype == (torch.float32 if name.endswith("scale") else torch.bfloat16), name
    prompts = np.random.default_rng(3).integers(1, cfg.vocab, (3, 5)).astype(np.int32)
    got = engine.generate(prompts, n_new=5).tokens
    cache = TL.init_cache(cfg, 3, 10, device=CPU)
    toks = torch.from_numpy(prompts).long()
    for t in range(5):
        logits, cache = TL.decode_step(cfg, params, toks[:, t], t, cache)
    want = []
    for i in range(5):
        cur = logits.argmax(-1)
        want.append(cur.numpy())
        logits, cache = TL.decode_step(cfg, params, cur, 5 + i, cache)
    np.testing.assert_array_equal(got, np.stack(want, axis=1))


def test_generate_sampling_seeded_and_in_vocab():
    """What the reference asserts of sampling, in both packages."""
    for engine in carried_engines("olmo-1b", max_seq=7):
        rng = np.random.default_rng(0)
        prompts = rng.integers(1, engine.cfg.vocab, (2, 4)).astype(np.int32)
        a = engine.generate(prompts, n_new=3, greedy=False, sample_seed=7,
                            record_provenance=True)
        b = engine.generate(prompts, n_new=3, greedy=False, sample_seed=7)
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.tokens.dtype == np.int32 and a.tokens.shape == (2, 3)
        assert int(a.tokens.min()) >= 0 and int(a.tokens.max()) < engine.cfg.vocab
        assert rows(engine.response_lineage(a, rows=[1])) == [1]
    c = engine.generate(prompts, n_new=3, greedy=False, sample_seed=8)
    d = engine.generate(np.repeat(prompts[:1], 64, axis=0), n_new=3, greedy=False)
    assert len({tuple(r) for r in d.tokens}) > 1       # draws, not argmax
    assert c.tokens.shape == (2, 3)


def test_generate_with_upstream_traces_to_raw():
    """A recorded generation on an upstream-attached engine traces each
    response to the prep rows behind its request, through the prep
    member's fused walk session, in both packages alike."""
    def run(P, engine_kw):
        prep = P.Index("prep")
        s = P.track(P.table({"k": np.arange(10, dtype=np.float32),
                             "x": np.linspace(-1, 1, 10).astype(np.float32)}), prep, "raw")
        f = s.filter_rows(P.mask(np.arange(10) % 3 != 0))
        sink = f.value_transform("x", "scale", factor=2.0).mark_sink()
        if P is T:
            prep.session(use_hopcache=False, fused_walk=True)
        engine = engine_kw(prep.export(sink.dataset_id))
        prompts = np.random.default_rng(1).integers(1, engine.cfg.vocab, (4, 3)).astype(np.int32)
        out = engine.generate(prompts, n_new=2, request_ids=np.array([0, 5, -1, 2]),
                              record_provenance=True)
        lineage = [rows(g) for g in
                   engine.response_lineage_batch(out, [[i] for i in range(4)], upstream="raw")]
        plan = engine.erasure_impact([1], source="raw")
        by_ref = {i.ref: rows(i.rows) for i in plan.impacts}
        return out.tokens, lineage, by_ref.get(f"serve/{out.response_dataset}")

    rc, tc = r_smoke("olmo-1b"), get_smoke_config("olmo-1b")
    rp = r_get_model(rc).init_params(rc, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(tc, jax.tree.map(np.asarray, rp), CPU)
    want = run(R, lambda up: r_engine.ServeEngine(rc, rp, 5, dtype=jnp.float32, upstream=up))
    got = run(T, lambda up: ServeEngine(tc, tp, 5, dtype=torch.float32, upstream=up,
                                        device=CPU))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert got[1] == [[1], [8], [], [4]]       # sink rows 0, 5, 2 <- raw 1, 8, 4
    assert got[2] == [0]                       # erasing raw row 1 reaches response 0


def test_engine_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device does not raise")
    cfg = get_smoke_config("olmo-1b")
    params = TL.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, max_seq=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        object.__new__(ServeEngine)._init_provenance("serve:x")


# ===========================================================================
# The launcher
# ===========================================================================
def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          capture_output=True, text=True, env=env, timeout=300)


@pytest.mark.parametrize("tier", [False, True])
def test_launch_serve_runs_on_the_cpu(tier):
    out = _launch("--arch", "olmo-1b", "--device", "cpu", *(["--tier"] if tier else []))
    assert out.returncode == 0, out.stderr
    assert "generated (4, 16) on cpu" in out.stdout
    assert ("tier: 64 lineage probes" in out.stdout) == tier


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-1.5-large-398b",
                                  "qwen3-moe-235b-a22b", "dbrx-132b"])
def test_launch_serve_runs_every_decoder_family(arch):
    """SSD, hybrid and MoE smokes through the launcher, with the tier
    (whisper's run is in ``tests/test_torch_whisper.py``)."""
    out = _launch("--arch", arch, "--device", "cpu", "--tier")
    assert out.returncode == 0, out.stderr
    assert "generated (4, 16) on cpu" in out.stdout and "tier: 64 lineage probes" in out.stdout


def test_launch_serve_mesh_waits_for_a14():
    """A14b is ported: ``--mesh`` prints the dry run's record of the full
    config's decode_32k cell and exits 0."""
    out = _launch("--arch", "olmo-1b", "--device", "cpu", "--mesh", "single")
    assert out.returncode == 0, out.stderr[-2000:]
    rec = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok" and rec["shape"] == "decode_32k" and rec["mesh"] == "single"
