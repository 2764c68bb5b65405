"""The port's encoder-decoder (whisper) against ``repro``'s, on the CPU.

``repro``'s JAX initialisation is carried across
(``carry.whisper_params_from_numpy``) and the same numpy-seeded frames and
tokens go through both packages: the sinusoid, the three cross-attention
functions, ``encode``, ``forward``, ``init_cache``, ``encode_into_cache``,
``prefill`` (self and cross K/V) and ``decode_step``, in float32
(rtol = atol = 1e-4) and bfloat16 (5e-2 of the largest reference value).
On the port alone decode equals forward, and a decode past the cache
raises.  Both engines emit the same greedy tokens given ``frames`` and
raise alike without them; the launcher runs ``--arch whisper-small`` in a
subprocess.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.models import common as RC
from repro.models import whisper as RW
from repro.serve import engine as r_engine
from repro_torch.configs import registry as treg
from repro_torch.models import common as C
from repro_torch.models import whisper as TW
from repro_torch.models.carry import params_from_numpy, whisper_params_from_numpy
from repro_torch.models.registry import get_model
from repro_torch.serve import ServeEngine
from test_torch_models import DTYPES, close, tokens

CPU = "cpu"
ARCH = "whisper-small"
ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 16
JIT = {"forward": jax.jit(RW.forward, static_argnums=0, static_argnames=("q_chunk", "dtype")),
       "prefill": jax.jit(RW.prefill, static_argnums=0, static_argnames=("q_chunk", "dtype")),
       "decode_step": jax.jit(RW.decode_step, static_argnums=0, static_argnames=("dtype",))}


def frames(cfg, seed=1, b=B):
    return np.random.default_rng(seed).normal(size=(b, cfg.enc_seq, cfg.d_model)) \
        .astype(np.float32)


def per_layer(cache):
    """The reference's layer-stacked cache -> one dict per decoder layer."""
    return [{k: np.asarray(v[i]) for k, v in cache.items()} for i in range(cache["k"].shape[0])]


@pytest.fixture(scope="module")
def carried():
    rc, tc = rreg.get_smoke_config(ARCH), treg.get_smoke_config(ARCH)
    rp = RW.init_params(rc, jax.random.PRNGKey(0))
    tp = whisper_params_from_numpy(tc, jax.tree.map(np.asarray, rp), CPU)
    toks, fr = tokens(rc), frames(rc)
    ref = {}
    for name, (jdt, _) in DTYPES.items():
        jt, jf = jnp.asarray(toks), jnp.asarray(fr)
        pre = JIT["prefill"](rc, rp, jf, jt, dtype=jdt)
        cache = RW.encode_into_cache(rc, rp, jf.astype(jdt), RW.init_cache(rc, B, S, dtype=jdt))
        enc_cache = per_layer(cache)
        dec = []
        for t in range(S):
            lg, cache = JIT["decode_step"](rc, rp, jt[:, t], jnp.int32(t), cache, dtype=jdt)
            dec.append(np.asarray(lg))
        ref[name] = {"encode": np.asarray(RW.encode(rc, rp, jf.astype(jdt))),
                     "forward": np.asarray(JIT["forward"](rc, rp, jf, jt, dtype=jdt)),
                     "prefill": (np.asarray(pre[0]), per_layer(pre[1])),
                     "encode_into_cache": enc_cache,
                     "decode": (np.stack(dec, axis=1), per_layer(cache))}
    return rc, tc, rp, tp, toks, fr, ref


# ===========================================================================
# Components
# ===========================================================================
@pytest.mark.parametrize("s,d", [(16, 64), (1500, 768)])
def test_sinusoid_matches_reference(s, d):
    """float32 angles pos / 10000^(2i/d), sin then cos; at whisper-small's
    1,500 frames the angles reach 1,499 rad, where one float32 ulp of the
    angle moves sin by about 1e-4 (3.1e-5 seen)."""
    got = TW._sinusoid(torch.arange(s), d, torch.float32)
    close(got, RW._sinusoid(s, d, jnp.float32), "float32")
    assert torch.equal(TW._sinusoid(torch.tensor([7]), d, torch.float32)[0], got[7])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cross_attention_matches_reference(dtype):
    """cross_attn_forward, cross_kv and cross_attn_decode; a cross layer has
    no QK scales even under QK-norm (chameleon's smoke here)."""
    jdt, tdt = DTYPES[dtype]
    for arch in (ARCH, "chameleon-34b"):
        rcfg, tcfg = rreg.get_smoke_config(arch), treg.get_smoke_config(arch)
        rp = RC.init_attn(rcfg, jax.random.PRNGKey(4), cross=True)
        tp = C.Attn(tcfg, CPU, cross=True)
        assert sorted(n for n, _ in tp.named_parameters()) == sorted(rp) == ["wk", "wo", "wq", "wv"]
        assert tcfg.qk_norm == (arch == "chameleon-34b")
        tp.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in rp.items()})
        rng = np.random.default_rng(5)
        x = rng.normal(size=(2, 3, tcfg.d_model)).astype(np.float32)
        enc = rng.normal(size=(2, 11, tcfg.d_model)).astype(np.float32)
        jx, je = jnp.asarray(x, jdt), jnp.asarray(enc, jdt)
        tx, te = torch.from_numpy(x).to(tdt), torch.from_numpy(enc).to(tdt)
        close(C.cross_attn_forward(tcfg, tp, tx, te), RC.cross_attn_forward(rcfg, rp, jx, je),
              dtype, f"{arch} forward")
        rkv, tkv = RC.cross_kv(rcfg, rp, je), C.cross_kv(tcfg, tp, te)
        for k in ("ck", "cv"):
            close(tkv[k], rkv[k], dtype, f"{arch} {k}")
        close(C.cross_attn_decode(tcfg, tp, tx, tkv), RC.cross_attn_decode(rcfg, rp, jx, rkv),
              dtype, f"{arch} decode")
    self_attn = C.init_attn(tcfg, torch.Generator().manual_seed(0), CPU)
    assert self_attn.q_scale is not None


# ===========================================================================
# The model against the reference
# ===========================================================================
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_encode_forward_prefill_match_reference(carried, dtype):
    rc, tc, _, tp, toks, fr, ref = carried
    tdt = DTYPES[dtype][1]
    t, f = torch.from_numpy(toks), torch.from_numpy(fr)
    close(TW.encode(tc, tp, f.to(tdt)), ref[dtype]["encode"], dtype, "encode")
    got = TW.forward(tc, tp, f, t, dtype=tdt)
    assert got.dtype == torch.float32 and got.shape == (B, S, tc.padded_vocab)
    close(got, ref[dtype]["forward"], dtype, "forward")
    logits, caches = TW.prefill(tc, tp, f, t, dtype=tdt)
    close(logits, ref[dtype]["prefill"][0], dtype, "prefill")
    assert len(caches) == tc.n_layers
    for i, (c, w) in enumerate(zip(caches, ref[dtype]["prefill"][1])):
        assert sorted(c) == sorted(w) == ["ck", "cv", "k", "v"]
        for k in c:
            assert c[k].dtype == tdt
            close(c[k], w[k], dtype, f"prefill layer {i} {k}")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cache_and_decode_match_reference(carried, dtype):
    """init_cache, encode_into_cache (cross K/V in the cache's dtype) and
    16 decode steps: logits and every cache entry."""
    rc, tc, _, tp, toks, fr, ref = carried
    tdt = DTYPES[dtype][1]
    cache = TW.init_cache(tc, B, S, dtype=tdt, device=CPU)
    want_shapes = {k: v.shape[1:] for k, v in RW.init_cache(rc, B, S).items()}
    assert all({k: tuple(v.shape) for k, v in lc.items()} == want_shapes for lc in cache)
    assert TW.encode_into_cache(tc, tp, torch.from_numpy(fr).to(tdt), cache) is cache
    for i, (c, w) in enumerate(zip(cache, ref[dtype]["encode_into_cache"])):
        for k in ("ck", "cv"):
            assert c[k].dtype == tdt
            close(c[k], w[k], dtype, f"layer {i} {k}")
    t = torch.from_numpy(toks)
    dec = torch.stack([TW.decode_step(tc, tp, t[:, i], i, cache, dtype=tdt)[0]
                       for i in range(S)], dim=1)
    close(dec, ref[dtype]["decode"][0], dtype, "decode")
    for i, (c, w) in enumerate(zip(cache, ref[dtype]["decode"][1])):
        for k in c:
            close(c[k], w[k], dtype, f"decode layer {i} {k}")


def test_decode_matches_forward():
    """The twin of ``tests/test_models.py::test_decode_matches_forward``
    (whisper there), with that test's inputs: its ``PRNGKey(2)`` init
    carried across, its tokens and frames; decode after
    ``encode_into_cache`` equals the float32 forward."""
    rc, tc = rreg.get_smoke_config(ARCH), treg.get_smoke_config(ARCH)
    key = jax.random.PRNGKey(2)
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, RW.init_params(rc, key)), CPU)
    toks = torch.from_numpy(np.array(jax.random.randint(key, (B, S), 0, rc.vocab)))
    fr = torch.from_numpy(np.array(
        jax.random.normal(key, (B, rc.enc_seq, rc.d_model), jnp.float32)))
    full = TW.forward(tc, tp, fr, toks, dtype=torch.float32)
    cache = TW.encode_into_cache(tc, tp, fr, TW.init_cache(tc, B, S, torch.float32, CPU))
    dec = torch.stack([TW.decode_step(tc, tp, toks[:, i], i, cache, dtype=torch.float32)[0]
                       for i in range(S)], dim=1)
    rel = float((dec - full).abs().max()) / (float(full.abs().max()) + 1e-9)
    assert rel < 2e-3, rel


def test_decode_past_the_cache_raises(carried):
    _, tc, _, tp, _, _, _ = carried
    cache = TW.init_cache(tc, 1, 4, dtype=torch.float32, device=CPU)
    with pytest.raises(ValueError, match="outside the cache"):
        TW.decode_step(tc, tp, torch.zeros(1, dtype=torch.int64), 4, cache, dtype=torch.float32)


def test_init_params_matches_reference_layout_and_scales(carried):
    _, tc, _, carried_p, _, _, _ = carried
    tp = get_model(tc).init_params(tc, torch.Generator().manual_seed(0), CPU)
    assert isinstance(tp, TW.Whisper)
    want, got = carried_p.state_dict(), tp.state_dict()
    assert list(got) == list(want)
    for name, t in got.items():
        w = want[name]
        assert t.shape == w.shape and t.dtype == torch.float32 == w.dtype, name
        if name.endswith("scale"):
            assert not t.any(), name
        else:
            assert 0.85 < float(t.std()) / float(w.std()) < 1.15, (name,)
    assert sum(t.numel() for t in got.values()) == pytest.approx(tc.n_params(), rel=0.05)


def test_cast_once_equals_cast_per_matmul(carried):
    _, tc, _, tp, toks, fr, _ = carried
    cast = TW.cast_params(tc, tp, torch.bfloat16, CPU)
    for name, t in cast.state_dict().items():
        assert t.dtype == (torch.float32 if name.endswith("scale") else torch.bfloat16), name
    t, f = torch.from_numpy(toks), torch.from_numpy(fr)
    assert torch.equal(TW.forward(tc, cast, f, t), TW.forward(tc, tp, f, t))
    caches = [TW.encode_into_cache(tc, p, f.to(torch.bfloat16), TW.init_cache(tc, B, S, device=CPU))
              for p in (cast, tp)]
    for i in range(4):
        assert torch.equal(*(TW.decode_step(tc, p, t[:, i], i, c)[0]
                             for p, c in zip((cast, tp), caches)))


def test_carry_takes_whisper_trees_strictly(carried):
    rc, tc, rp, tp, _, _, _ = carried
    tree = jax.tree.map(np.asarray, rp)
    np.testing.assert_array_equal(tp.dec_layers[1].cross.wq.numpy(),
                                  tree["dec_layers"]["cross"]["wq"][1])
    np.testing.assert_array_equal(tp.enc_norm.scale.numpy(), tree["enc_norm"]["scale"])
    missing = dict(tree, enc_layers={k: v for k, v in tree["enc_layers"].items()
                                     if k != "mlp"})
    with pytest.raises(RuntimeError, match="mlp"):
        whisper_params_from_numpy(tc, missing, CPU)
    short = dict(tree, dec_layers=jax.tree.map(lambda a: a[:1], tree["dec_layers"]))
    with pytest.raises(ValueError, match="leading axis"):
        whisper_params_from_numpy(tc, short, CPU)


# ===========================================================================
# Serving
# ===========================================================================
def test_greedy_generate_with_frames_matches_reference(carried):
    """Both engines (float32) given the same frames: 6-token prompts, one
    left-padded, 6 greedy tokens, recorded; the reference's tokens and
    dataset names.  A bf16 engine emits the tokens of its float32 weights
    cast per use."""
    rc, tc, rp, tp, _, _, _ = carried
    rng = np.random.default_rng(7)
    prompts = rng.integers(1, rc.vocab, (4, 6)).astype(np.int32)
    prompts[1, :2] = -1
    fr = frames(rc, seed=8, b=4)
    a = r_engine.ServeEngine(rc, rp, max_seq=12, dtype=jnp.float32).generate(
        prompts, n_new=6, frames=fr, record_provenance=True)
    engine = ServeEngine(tc, tp, max_seq=12, dtype=torch.float32, device=CPU)
    assert isinstance(engine.params, TW.Whisper)
    b = engine.generate(prompts, n_new=6, frames=fr, record_provenance=True)
    np.testing.assert_array_equal(b.tokens, a.tokens)
    assert (b.request_dataset, b.response_dataset) == (a.request_dataset, a.response_dataset)
    bf = ServeEngine(tc, tp, max_seq=12, device=CPU)
    cache = TW.encode_into_cache(tc, tp, torch.from_numpy(fr).to(torch.bfloat16),
                                 TW.init_cache(tc, 4, 12, device=CPU))
    toks = torch.from_numpy(np.where(prompts < 0, 0, prompts)).long()
    for i in range(6):
        logits, _ = TW.decode_step(tc, tp, toks[:, i], i, cache)
    want = []
    for i in range(6):
        cur = logits.argmax(-1)
        want.append(cur.numpy())
        logits, _ = TW.decode_step(tc, tp, cur, 6 + i, cache)
    np.testing.assert_array_equal(bf.generate(prompts, n_new=6, frames=fr).tokens,
                                  np.stack(want, axis=1))


def test_generate_without_frames_raises_as_reference(carried):
    rc, tc, rp, tp, _, _, _ = carried
    prompts = np.ones((2, 3), np.int32)
    with pytest.raises(AssertionError) as er:
        r_engine.ServeEngine(rc, rp, max_seq=8, dtype=jnp.float32).generate(prompts, n_new=2)
    with pytest.raises(AssertionError) as et:
        ServeEngine(tc, tp, max_seq=8, dtype=torch.float32, device=CPU).generate(prompts, n_new=2)
    assert str(et.value) == str(er.value) == "enc-dec serving needs frames"


def test_launch_serve_whisper_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
                          "--device", "cpu"], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "generated (4, 16) on cpu" in out.stdout


def test_registry_serves_the_encoder_decoder():
    m = get_model(treg.get_smoke_config(ARCH))
    assert (m.init_params, m.forward, m.prefill, m.decode_step, m.init_cache, m.cast_params) == \
        (TW.init_params, TW.forward, TW.prefill, TW.decode_step, TW.init_cache, TW.cast_params)
    assert dataclasses.asdict(treg.get_config(ARCH)) == dataclasses.asdict(rreg.get_config(ARCH))
