"""The port's Mamba2 SSD mixer and SSD LMs against ``repro``'s, on the CPU.

``repro``'s JAX initialisation is carried across (``carry``) and the same
numpy-seeded inputs go through both packages: the causal conv, the gated
norm, the chunked ``ssd_forward`` with its decode handoff, the recurrent
``ssd_decode`` and its cache, and the mamba2 smoke's ``forward``,
``prefill`` and ``decode_step``, in float32 (rtol = atol = 1e-4) and
bfloat16 (5e-2 of the largest reference value).  The masked exponent of
the within-chunk mask must stay finite where its upper triangle
overflows.  On the port alone, decode equals forward for mamba2 and jamba
(whose forward drops no MoE choice, asserted), and a prefill handed to
decode continues the forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.models import lm as RL
from repro.models import ssd as RS
from repro.serve import engine as r_engine
from repro_torch.configs import registry as treg
from repro_torch.models import lm as TL
from repro_torch.models import ssd as TS
from repro_torch.models.carry import lm_params_from_numpy
from repro_torch.serve import ServeEngine
from test_torch_models import DTYPES, JIT, close, tokens, unstack_cache
from test_torch_moe import Routes, n_dropped

CPU = "cpu"
ARCH = "mamba2-370m"
B, S = 2, 16


def carried_ssd(seed=0, **over):
    """The reference's SSD params (with ``over`` replacing leaves) and the
    port's module holding them."""
    rc, tc = rreg.get_smoke_config(ARCH), treg.get_smoke_config(ARCH)
    rp = dict(RS.init_ssd(rc, jax.random.PRNGKey(seed)), **over)
    tp = TS.SSD(tc, CPU)
    tp.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in rp.items()})
    return rc, tc, rp, tp


def inputs(tc, seed=1, b=B, s=S, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(b, s, tc.d_model)) * scale).astype(np.float32)


# ===========================================================================
# The mixer
# ===========================================================================
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_conv_and_gated_norm_match_reference(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    w, b = rng.normal(size=(4, 24)).astype(np.float32), rng.normal(size=24).astype(np.float32)
    x = rng.normal(size=(2, 9, 24)).astype(np.float32)
    close(TS._causal_conv(*(torch.from_numpy(a).to(tdt) for a in (w, b, x))),
          RS._causal_conv(*(jnp.asarray(a, jdt) for a in (w, b, x))), dtype, "conv")
    z, scale = rng.normal(size=(2, 9, 24)).astype(np.float32), rng.normal(size=24).astype(np.float32)
    close(TS._gated_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(z).to(tdt),
                         torch.from_numpy(scale)),
          RS._gated_norm(jnp.asarray(x, jdt), jnp.asarray(z, jdt), jnp.asarray(scale)),
          dtype, "gated norm")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_forward_matches_reference(dtype):
    """Two chunks of 8, so the inter-chunk recurrence runs; the output,
    the final state (float32) and the raw conv tail of the handoff."""
    jdt, tdt = DTYPES[dtype]
    rc, tc, rp, tp = carried_ssd(dt_bias=np.full(8, 0.5, np.float32),
                                 A_log=np.linspace(-1, 1, 8).astype(np.float32))
    x = inputs(tc)
    want, wcache = RS.ssd_forward(rc, rp, jnp.asarray(x, jdt), return_cache=True)
    got, cache = TS.ssd_forward(tc, tp, torch.from_numpy(x).to(tdt), return_cache=True)
    assert got.dtype == tdt and cache["state"].dtype == torch.float32
    assert cache["conv"].dtype == tdt and cache["conv"].shape == (B, tc.ssm_conv - 1, 160)
    close(got, want, dtype, "out")
    close(cache["state"], wcache["state"], dtype, "state")
    close(cache["conv"], wcache["conv"], dtype, "conv tail")
    close(TS.ssd_forward(tc, tp, torch.from_numpy(x).to(tdt)), want, dtype, "no cache")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_decode_matches_reference(dtype):
    """16 steps from a zero cache: each output and the cache after the
    last, updated in place."""
    jdt, tdt = DTYPES[dtype]
    rc, tc, rp, tp = carried_ssd(dt_bias=np.full(8, -0.5, np.float32))
    x = inputs(tc, seed=2)
    rcache = RS.init_ssd_cache(rc, B, jdt)
    tcache = TS.init_ssd_cache(tc, B, tdt, CPU)
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in rcache.items()}
    state = tcache["state"]
    for t in range(S):
        ro, rcache = RS.ssd_decode(rc, rp, jnp.asarray(x[:, t:t + 1], jdt), rcache)
        to, out_cache = TS.ssd_decode(tc, tp, torch.from_numpy(x[:, t:t + 1]).to(tdt), tcache)
        assert out_cache is tcache and tcache["state"] is state
        close(to, ro, dtype, f"step {t}")
    close(tcache["state"], rcache["state"], dtype, "state")
    close(tcache["conv"], rcache["conv"], dtype, "conv")


def test_prefill_handoff_continues_the_forward():
    """ssd_forward over 8 tokens with its cache, then 8 ssd_decode steps,
    equals ssd_forward over all 16 (port), and the reference's."""
    rc, tc, rp, tp = carried_ssd()
    x = torch.from_numpy(inputs(tc, seed=3))
    full = TS.ssd_forward(tc, tp, x)
    head, cache = TS.ssd_forward(tc, tp, x[:, :8], return_cache=True)
    steps = [TS.ssd_decode(tc, tp, x[:, t:t + 1], cache)[0] for t in range(8, S)]
    got = torch.cat([head] + steps, dim=1)
    torch.testing.assert_close(got, full, rtol=1e-4, atol=1e-4)
    close(got, RS.ssd_forward(rc, rp, jnp.asarray(x.numpy())), "float32")


def test_masked_exponent_is_inf_safe():
    """dt ~ 30 and A = -e^3: the segment sums above the diagonal reach
    +4,000 and exp() overflows to inf there; the where() keeps the output
    finite and equal to the reference's (a multiply by the mask would give
    inf * 0 = NaN)."""
    rc, tc, rp, tp = carried_ssd(dt_bias=np.full(8, 30.0, np.float32),
                                 A_log=np.full(8, 3.0, np.float32))
    x = inputs(tc, seed=4)
    dA = 30.0 * -np.exp(3.0)
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(np.float32(-dA * (tc.ssm_chunk - 1))))
    got = TS.ssd_forward(tc, tp, torch.from_numpy(x))
    assert bool(torch.isfinite(got).all())
    close(got, RS.ssd_forward(rc, rp, jnp.asarray(x)), "float32")


def test_ssd_forward_needs_whole_chunks():
    rc, tc, rp, tp = carried_ssd()
    x = inputs(tc, s=12)
    with pytest.raises(AssertionError) as er:
        RS.ssd_forward(rc, rp, jnp.asarray(x))
    with pytest.raises(AssertionError) as et:
        TS.ssd_forward(tc, tp, torch.from_numpy(x))
    assert str(et.value) == str(er.value)


def test_init_ssd_layout_and_scales():
    rc, tc, rp, _ = carried_ssd()
    tp = TS.init_ssd(tc, torch.Generator().manual_seed(0), CPU)
    for name, t in tp.state_dict().items():
        w = np.asarray(rp[name])
        assert tuple(t.shape) == w.shape and t.dtype == torch.float32, name
        if w.std() == 0:
            assert torch.equal(t, torch.from_numpy(np.array(w))), name
        else:
            assert 0.8 < float(t.std()) / float(w.std()) < 1.25, name


# ===========================================================================
# The mamba2 smoke LM
# ===========================================================================
@pytest.fixture(scope="module")
def carried():
    rc, tc = rreg.get_smoke_config(ARCH), treg.get_smoke_config(ARCH)
    rp = RL.init_params(rc, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(tc, jax.tree.map(np.asarray, rp), CPU)
    toks = tokens(rc)
    ref = {}
    for name, (jdt, _) in DTYPES.items():
        jt = jnp.asarray(toks)
        pre = JIT["prefill"](rc, rp, jt, dtype=jdt)
        cache = RL.init_cache(rc, B, S, dtype=jdt)
        dec = []
        for t in range(S):
            lg, cache = JIT["decode_step"](rc, rp, jt[:, t], jnp.int32(t), cache, dtype=jdt)
            dec.append(np.asarray(lg))
        ref[name] = {"forward": np.asarray(JIT["forward"](rc, rp, jt, dtype=jdt)),
                     "prefill": (np.asarray(pre[0]), unstack_cache(rc, pre[1])),
                     "decode": (np.stack(dec, axis=1), unstack_cache(rc, cache))}
    return rc, tc, rp, tp, toks, ref


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lm_matches_reference(carried, dtype):
    """forward, prefill (logits and each layer's state and conv tail) and
    token-by-token decode_step (logits and caches)."""
    _, tc, _, tp, toks, ref = carried
    tdt = DTYPES[dtype][1]
    t = torch.from_numpy(toks)
    close(TL.forward(tc, tp, t, dtype=tdt), ref[dtype]["forward"], dtype, "forward")
    logits, caches = TL.prefill(tc, tp, t, dtype=tdt)
    close(logits, ref[dtype]["prefill"][0], dtype, "prefill")
    for i, (c, w) in enumerate(zip(caches, ref[dtype]["prefill"][1])):
        assert sorted(c) == sorted(w) == ["conv", "state"], i
        assert c["state"].dtype == torch.float32 and c["conv"].dtype == tdt
        for k in c:
            close(c[k], w[k], dtype, f"prefill layer {i} {k}")
    cache = TL.init_cache(tc, B, S, dtype=tdt, device=CPU)
    dec = torch.stack([TL.decode_step(tc, tp, t[:, i], i, cache, dtype=tdt)[0]
                       for i in range(S)], dim=1)
    close(dec, ref[dtype]["decode"][0], dtype, "decode")
    for i, (c, w) in enumerate(zip(cache, ref[dtype]["decode"][1])):
        for k in c:
            close(c[k], w[k], dtype, f"decode layer {i} {k}")


@pytest.mark.parametrize("arch", [ARCH, "jamba-1.5-large-398b"])
def test_decode_matches_forward(arch, monkeypatch):
    """The twin of ``tests/test_models.py::test_decode_matches_forward``
    (mamba2 and jamba there), on the port with that test's inputs (its
    ``PRNGKey(2)`` init carried across, its tokens): decode equals the
    float32 forward.  jamba's forward drops no MoE choice there (asserted:
    decode's 2 tokens a call never drop, so equality needs that; another
    seed's forward can drop, and then decode differs)."""
    cfg = treg.get_smoke_config(arch)
    key = jax.random.PRNGKey(2)
    rp = RL.init_params(rreg.get_smoke_config(arch), key)
    tp = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, rp), CPU)
    toks = torch.from_numpy(np.array(jax.random.randint(key, (B, S), 0, cfg.vocab)))
    routes = Routes(monkeypatch)
    full = TL.forward(cfg, tp, toks, dtype=torch.float32)
    assert all(n_dropped(cfg, lg.reshape(B * S, -1)) == 0 for lg in routes.port)
    cache = TL.init_cache(cfg, B, S, dtype=torch.float32, device=CPU)
    dec = torch.stack([TL.decode_step(cfg, tp, toks[:, i], i, cache, dtype=torch.float32)[0]
                       for i in range(S)], dim=1)
    rel = float((dec - full).abs().max()) / (float(full.abs().max()) + 1e-9)
    assert rel < 2e-3, rel


def test_prefill_then_decode_matches_forward(carried):
    """prefill of 8 tokens (one chunk), its caches handed to decode for the
    next 8: the forward's logits at every position, and the reference's."""
    _, tc, _, tp, toks, ref = carried
    t = torch.from_numpy(toks)
    full = TL.forward(tc, tp, t, dtype=torch.float32)
    logits, cache = TL.prefill(tc, tp, t[:, :8], dtype=torch.float32)
    dec = [logits] + [TL.decode_step(tc, tp, t[:, i], i, cache, dtype=torch.float32)[0]
                      for i in range(8, S)]
    got = torch.stack(dec, dim=1)
    torch.testing.assert_close(got, full[:, 7:], rtol=1e-4, atol=1e-4)
    close(got, ref["float32"]["forward"][:, 7:], "float32")


def test_cast_once_equals_cast_per_matmul(carried):
    """bf16 weights cast once give bit-identical logits to float32 weights
    cast at every use; ``A_log``, ``dt_bias`` and the norm scales stay
    float32 (the reference computes with them in float32)."""
    _, tc, _, tp, toks, _ = carried
    cast = TL.cast_params(tc, tp, torch.bfloat16, CPU)
    for name, t in cast.state_dict().items():
        keep = name.endswith(("scale", "A_log", "dt_bias"))
        assert t.dtype == (torch.float32 if keep else torch.bfloat16), name
    t = torch.from_numpy(toks)
    assert torch.equal(TL.forward(tc, cast, t), TL.forward(tc, tp, t))
    c1, c2 = TL.init_cache(tc, B, S, device=CPU), TL.init_cache(tc, B, S, device=CPU)
    for i in range(4):
        assert torch.equal(TL.decode_step(tc, cast, t[:, i], i, c1)[0],
                           TL.decode_step(tc, tp, t[:, i], i, c2)[0])


def test_carry_takes_ssd_trees_strictly(carried):
    rc, tc, rp, tp, _, _ = carried
    tree = jax.tree.map(np.asarray, rp)
    np.testing.assert_array_equal(tp.layers[1].ssd.conv_w.numpy(),
                                  tree["blocks"]["l0"]["ssd"]["conv_w"][1])
    assert not hasattr(tp.layers[0], "attn") and not hasattr(tp.layers[0], "post_norm")
    bad = jax.tree.map(lambda a: a, tree)
    del bad["blocks"]["l0"]["ssd"]["A_log"]
    with pytest.raises(RuntimeError, match="A_log"):
        lm_params_from_numpy(tc, bad, CPU)
    extra = jax.tree.map(lambda a: a, tree)
    extra["blocks"]["l0"]["ssd"]["B_log"] = tree["blocks"]["l0"]["ssd"]["A_log"]
    with pytest.raises(RuntimeError, match="B_log"):
        lm_params_from_numpy(tc, extra, CPU)


def test_greedy_generate_matches_reference(carried):
    """The mamba2 smoke behind both engines (float32): 6-token prompts, one
    left-padded, 6 greedy tokens, the reference's tokens."""
    rc, tc, rp, tp, _, _ = carried
    prompts = np.random.default_rng(7).integers(1, rc.vocab, (4, 6)).astype(np.int32)
    prompts[1, :2] = -1
    a = r_engine.ServeEngine(rc, rp, max_seq=12, dtype=jnp.float32).generate(prompts, n_new=6)
    b = ServeEngine(tc, tp, max_seq=12, dtype=torch.float32, device=CPU).generate(prompts, n_new=6)
    np.testing.assert_array_equal(b.tokens, a.tokens)
