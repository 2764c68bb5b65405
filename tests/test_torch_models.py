"""The port's configs and dense LM against ``repro``'s, on the CPU; every
family serving through the uniform interface.

Every config (full and smoke) must equal the reference's field by field,
with equal parameter counts.  For the dense smoke configs the reference's
JAX initialisation is carried into the port (``lm_params_from_numpy``) and
the same seeded tokens go through both packages: ``forward``, ``prefill``
(with and without ``q_chunk``, logits and K/V) and token-by-token
``decode_step`` must agree within rtol = atol = 1e-4 in float32, and within
a relative max error of 5e-2 in bfloat16 (max |port - ref| over max |ref|:
about a dozen bf16 rounding steps, 2^-8 each, for matmuls that accumulate in
another order; the largest seen on these configs is 2.4e-2).  The port's own
decode must equal its forward (the twin of ``tests/test_models.py``'s
decode test), and gemma3's sliding-window layers must wrap their ring
buffer.  All ten smoke configs (dense, SSD, MoE, hybrid and
encoder-decoder) must init, cache, prefill, decode and generate through
``get_model`` and ``ServeEngine``; ``tests/test_torch_{ssd,moe,whisper}.py``
hold those families to ``repro``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as rarchs
from repro.configs import registry as rreg
from repro.models import common as RC
from repro.models import lm as RL
from repro_torch.configs import registry as treg
from repro_torch.models import common as C
from repro_torch.models import lm as TL
from repro_torch.models.carry import lm_params_from_numpy
from repro_torch.models.registry import get_model
from repro_torch.serve import ServeEngine

CPU = "cpu"
ALL_ARCHS = list(rarchs.ARCHS)
DENSE = ["olmo-1b", "gemma3-1b", "gemma3-12b", "llama3-405b", "chameleon-34b"]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16_REL = 5e-2
B, S = 2, 16
# the reference's entry points, jitted as its engine jits its step (the
# config, chunk and dtype are static)
JIT = {"forward": jax.jit(RL.forward, static_argnums=0, static_argnames=("q_chunk", "dtype")),
       "prefill": jax.jit(RL.prefill, static_argnums=0, static_argnames=("q_chunk", "dtype")),
       "decode_step": jax.jit(RL.decode_step, static_argnums=0, static_argnames=("dtype",))}


def close(port, ref, dtype: str, what: str = "") -> None:
    port = np.asarray(port.float() if isinstance(port, torch.Tensor) else port, np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    if dtype == "float32":
        np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-4, err_msg=what)
    else:
        rel = np.abs(port - ref).max() / (np.abs(ref).max() + 1e-9)
        assert rel < BF16_REL, (what, rel)


def unstack_cache(cfg, cache):
    """The reference's cache tree -> one {"k", "v"} dict per layer."""
    out = [None] * cfg.n_layers
    per = len(cfg.block)
    for i in range(per):
        lc = cache["blocks"][f"l{i}"]
        for j in range(cfg.n_blocks):
            out[j * per + i] = {k: np.asarray(v[j]) for k, v in lc.items()}
    for i in range(len(cfg.tail)):
        out[cfg.n_blocks * per + i] = {k: np.asarray(v) for k, v in cache[f"tail{i}"].items()}
    return out


def tokens(cfg, seed=0, b=B, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


# ===========================================================================
# Configs
# ===========================================================================
@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_equals_reference(arch, which):
    get_r = rreg.get_config if which == "full" else rreg.get_smoke_config
    get_t = treg.get_config if which == "full" else treg.get_smoke_config
    r, t = get_r(arch), get_t(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    assert [dataclasses.astuple(s) for s in t.layer_specs()] == \
        [dataclasses.astuple(s) for s in r.layer_specs()]
    for prop in ("padded_vocab", "hd", "n_blocks", "d_inner", "ssm_heads", "is_encdec"):
        assert getattr(t, prop) == getattr(r, prop), prop
    assert t.n_params() == r.n_params()
    assert t.n_active_params() == r.n_active_params()


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_per_arch_modules_and_registry(arch):
    import importlib

    mod = arch.replace("-", "_").replace(".", "_")
    r = importlib.import_module(f"repro.configs.{mod}")
    t = importlib.import_module(f"repro_torch.configs.{mod}")
    assert t.ARCH_ID == r.ARCH_ID == arch
    assert dataclasses.asdict(t.CONFIG) == dataclasses.asdict(r.CONFIG)
    assert dataclasses.asdict(t.SMOKE) == dataclasses.asdict(r.SMOKE)
    import repro_torch.configs as tconfigs
    assert tconfigs.get_config(arch) is treg.ARCHS[arch]


def test_unknown_arch_raises_as_reference():
    for get_r, get_t in ((rreg.get_config, treg.get_config),
                         (rreg.get_smoke_config, treg.get_smoke_config)):
        with pytest.raises(KeyError) as er:
            get_r("nope")
        with pytest.raises(KeyError) as et:
            get_t("nope")
        assert str(et.value) == str(er.value)


def test_gemma3_1b_smoke_keeps_its_tail():
    cfg = treg.get_smoke_config("gemma3-1b")
    assert len(cfg.tail) == 2 and cfg.n_layers == 14 and cfg.n_blocks == 2


# ===========================================================================
# The dense LM: logits and caches against the reference
# ===========================================================================
@pytest.fixture(scope="module")
def carried():
    """Per dense smoke arch: the reference's params, the port's carried
    copy, and the reference's outputs on seeded tokens, for both dtypes."""
    out = {}

    def get(arch):
        if arch in out:
            return out[arch]
        rc, tc = rreg.get_smoke_config(arch), treg.get_smoke_config(arch)
        rp = RL.init_params(rc, jax.random.PRNGKey(0))
        tp = lm_params_from_numpy(tc, jax.tree.map(np.asarray, rp), CPU)
        toks = tokens(rc)
        ref = {}
        for name, (jdt, _) in DTYPES.items():
            jt = jnp.asarray(toks)
            fwd = JIT["forward"](rc, rp, jt, dtype=jdt)
            pre = JIT["prefill"](rc, rp, jt, dtype=jdt)
            pre_chunked = JIT["prefill"](rc, rp, jt, q_chunk=4, dtype=jdt)
            cache = RL.init_cache(rc, B, S, dtype=jdt)
            dec = []
            for t in range(S):
                lg, cache = JIT["decode_step"](rc, rp, jt[:, t], jnp.int32(t), cache, dtype=jdt)
                dec.append(np.asarray(lg))
            ref[name] = {"forward": np.asarray(fwd),
                         "prefill": (np.asarray(pre[0]), unstack_cache(rc, pre[1])),
                         "prefill_chunked": (np.asarray(pre_chunked[0]),
                                             unstack_cache(rc, pre_chunked[1])),
                         "decode": (np.stack(dec, axis=1), unstack_cache(rc, cache))}
        out[arch] = (tc, rp, tp, toks, ref)
        return out[arch]

    return get


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(carried, arch, dtype):
    cfg, _, tp, toks, ref = carried(arch)
    got = TL.forward(cfg, tp, torch.from_numpy(toks), dtype=DTYPES[dtype][1])
    assert got.dtype == torch.float32 and got.shape == (B, S, cfg.padded_vocab)
    close(got, ref[dtype]["forward"], dtype, "forward")


@pytest.mark.parametrize("q_chunk", [0, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_reference(carried, arch, dtype, q_chunk):
    cfg, _, tp, toks, ref = carried(arch)
    logits, caches = TL.prefill(cfg, tp, torch.from_numpy(toks), q_chunk=q_chunk,
                                dtype=DTYPES[dtype][1])
    want_logits, want_caches = ref[dtype]["prefill_chunked" if q_chunk else "prefill"]
    close(logits, want_logits, dtype, "prefill logits")
    assert len(caches) == cfg.n_layers
    for i, (c, w) in enumerate(zip(caches, want_caches)):
        for k in ("k", "v"):
            assert c[k].dtype == DTYPES[dtype][1]
            close(c[k], w[k], dtype, f"layer {i} {k}")
    # chunked and unchunked prefill agree in the port as in the reference
    close(logits, ref[dtype]["prefill"][0], dtype, "chunked vs unchunked")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_matches_reference(carried, arch, dtype):
    cfg, _, tp, toks, ref = carried(arch)
    tdt = DTYPES[dtype][1]
    cache = TL.init_cache(cfg, B, S, dtype=tdt, device=CPU)
    outs = []
    for t in range(S):
        logits, cache = TL.decode_step(cfg, tp, torch.from_numpy(toks[:, t]), t, cache,
                                       dtype=tdt)
        outs.append(logits)
    want_logits, want_cache = ref[dtype]["decode"]
    close(torch.stack(outs, dim=1), want_logits, dtype, "decode logits")
    for i, (c, w) in enumerate(zip(cache, want_cache)):
        for k in ("k", "v"):
            close(c[k], w[k], dtype, f"layer {i} cache {k}")


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(carried, arch):
    """The twin of ``tests/test_models.py::test_decode_matches_forward``,
    on the port alone: token-by-token decode equals the full forward."""
    cfg, _, tp, toks, _ = carried(arch)
    t = torch.from_numpy(toks)
    full = TL.forward(cfg, tp, t, dtype=torch.float32)
    cache = TL.init_cache(cfg, B, S, dtype=torch.float32, device=CPU)
    dec = torch.stack([TL.decode_step(cfg, tp, t[:, i], i, cache, dtype=torch.float32)[0]
                       for i in range(S)], dim=1)
    rel = float((dec - full).abs().max()) / (float(full.abs().max()) + 1e-9)
    assert rel < 2e-3, rel


def test_gemma3_ring_buffer_wraps(carried):
    """gemma3's smoke window is 8: over 16 decode steps each local layer's
    8-slot cache wraps once and ends holding positions 8..15 at slot
    ``pos mod 8``, equal to the reference's; the global layers hold all 16."""
    cfg, _, tp, toks, ref = carried("gemma3-1b")
    assert cfg.window == 8
    cache = TL.init_cache(cfg, B, S, dtype=torch.float32, device=CPU)
    for t in range(S):
        TL.decode_step(cfg, tp, torch.from_numpy(toks[:, t]), t, cache, dtype=torch.float32)
    _, pre = TL.prefill(cfg, tp, torch.from_numpy(toks), dtype=torch.float32)
    specs = cfg.layer_specs()
    assert {s.mixer for s in specs} == {"attn", "attn_local"}
    for i, spec in enumerate(specs):
        k = cache[i]["k"]
        if spec.mixer == "attn_local":
            assert k.shape[1] == cfg.window
            want = torch.empty_like(k)
            for pos in range(cfg.window, S):        # the last 8 positions
                want[:, pos % cfg.window] = pre[i]["k"][:, pos]
            torch.testing.assert_close(k, want, rtol=1e-4, atol=1e-4)
        else:
            assert k.shape[1] == S
        close(k, ref["float32"]["decode"][1][i]["k"], "float32", f"layer {i}")


@pytest.mark.parametrize("window,s_max", [(4, 12), (8, 6)])
def test_attn_decode_local_branches_match_reference(window, s_max):
    """A local layer over a cache longer than its window (the masked
    branch) and one within it (the ring), step by step against JAX's
    ``attn_decode``, caches included."""
    rcfg = dataclasses.replace(rreg.get_smoke_config("gemma3-1b"), window=window)
    tcfg = dataclasses.replace(treg.get_smoke_config("gemma3-1b"), window=window)
    rp = RC.init_attn(rcfg, jax.random.PRNGKey(5))
    tp = C.Attn(tcfg, CPU)
    tp.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in rp.items()})
    x = np.random.default_rng(5).normal(size=(2, 12, tcfg.d_model)).astype(np.float32)
    shape = (2, s_max, tcfg.n_kv_heads, tcfg.hd)
    rcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tcache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    steps = 12 if s_max <= window else s_max
    for pos in range(steps):
        ro, rcache = RC.attn_decode(rcfg, rp, jnp.asarray(x[:, pos:pos + 1]), rcache,
                                    jnp.int32(pos), kind="local")
        to, tcache = C.attn_decode(tcfg, tp, torch.from_numpy(x[:, pos:pos + 1]), tcache,
                                   pos, kind="local")
        close(to, ro, "float32", f"pos {pos}")
    close(tcache["k"], rcache["k"], "float32", "k")
    close(tcache["v"], rcache["v"], "float32", "v")


def test_decode_past_the_cache_raises():
    cfg = treg.get_smoke_config("olmo-1b")
    tp = TL.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    cache = TL.init_cache(cfg, 1, 4, dtype=torch.float32, device=CPU)
    with pytest.raises(ValueError, match="outside the cache"):
        TL.decode_step(cfg, tp, torch.zeros(1, dtype=torch.int64), 4, cache,
                       dtype=torch.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_components_match_reference(dtype):
    """rmsnorm (1 + scale in float32), the non-parametric LN (variance over
    N), RoPE (concatenated halves) and both MLP forms, elementwise."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32) * 3
    scale = rng.normal(size=16).astype(np.float32)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    close(C.rmsnorm(tx, torch.from_numpy(scale)), RC.rmsnorm(jx, jnp.asarray(scale)), dtype)
    close(C.nonparam_ln(tx), RC.nonparam_ln(jx), dtype)
    pos = np.arange(5)[None, :] * 37
    close(C.rope(tx, torch.from_numpy(pos), 1e6), RC.rope(jx, jnp.asarray(pos), 1e6), dtype)
    for arch in ("olmo-1b", "whisper-small"):         # SwiGLU, and GELU 2-matrix
        rcfg, tcfg = rreg.get_smoke_config(arch), treg.get_smoke_config(arch)
        rp = RC.init_mlp(rcfg, jax.random.PRNGKey(1))
        tp = C.MLP(tcfg, CPU)
        tp.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in rp.items()})
        h = rng.normal(size=(2, 3, tcfg.d_model)).astype(np.float32)
        close(C.mlp_forward(tp, torch.from_numpy(h).to(tdt)),
              RC.mlp_forward(rp, jnp.asarray(h, jdt)), dtype, arch)


# ===========================================================================
# Init, casting, carrying, and what is not ported
# ===========================================================================
@pytest.mark.parametrize("arch", DENSE)
def test_init_params_matches_reference_layout_and_scales(carried, arch):
    cfg, _, carried_p, _, _ = carried(arch)
    tp = TL.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    want = carried_p.state_dict()
    got = tp.state_dict()
    assert list(got) == list(want)
    for name, t in got.items():
        w = want[name]
        assert t.shape == w.shape and t.dtype == torch.float32 == w.dtype, name
        assert not t.requires_grad
        if name.endswith("scale"):
            assert not t.any(), name
        else:
            ratio = float(t.std()) / float(w.std())
            assert 0.85 < ratio < 1.15, (name, ratio)
    again = TL.init_params(cfg, torch.Generator().manual_seed(0), CPU).state_dict()
    assert all(torch.equal(again[k], got[k]) for k in got)
    assert sum(t.numel() for t in got.values()) == pytest.approx(cfg.n_params(), rel=0.05)


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma3-1b", "llama3-405b"])
def test_cast_once_equals_cast_per_matmul(carried, arch):
    """Weights cast to bf16 once give bit-identical logits to float32
    weights cast at every matmul; the norm scales stay float32."""
    cfg, _, tp, toks, _ = carried(arch)
    cast = TL.cast_params(cfg, tp, torch.bfloat16, CPU)
    for name, t in cast.state_dict().items():
        assert t.dtype == (torch.float32 if name.endswith("scale") else torch.bfloat16), name
    t = torch.from_numpy(toks)
    assert torch.equal(TL.forward(cfg, cast, t), TL.forward(cfg, tp, t))
    c1 = TL.init_cache(cfg, B, S, device=CPU)
    c2 = TL.init_cache(cfg, B, S, device=CPU)
    for i in range(4):
        a, _ = TL.decode_step(cfg, cast, t[:, i], i, c1)
        b, _ = TL.decode_step(cfg, tp, t[:, i], i, c2)
        assert torch.equal(a, b)


def test_carry_rejects_a_tree_that_does_not_fit(carried):
    cfg, rp, _, _, _ = carried("llama3-405b")
    tree = jax.tree.map(np.asarray, rp)
    missing = dict(tree)
    del missing["lm_head"]
    with pytest.raises(RuntimeError, match="lm_head"):
        lm_params_from_numpy(cfg, missing, CPU)
    short = dict(tree, blocks=jax.tree.map(lambda a: a[:1], tree["blocks"]))
    with pytest.raises(ValueError, match="leading axis"):
        lm_params_from_numpy(cfg, short, CPU)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_family_serves(arch):
    """get_model's init_params, init_cache, prefill and decode_step, then a
    bf16 ServeEngine's generate, on each smoke config: the shapes, finite
    logits, tokens in the vocabulary; none raises."""
    cfg = treg.get_smoke_config(arch)
    model = get_model(cfg)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    toks = torch.from_numpy(tokens(cfg, s=8))
    fr = torch.from_numpy(np.random.default_rng(0).normal(size=(B, cfg.enc_seq, cfg.d_model))
                          .astype(np.float32)) if cfg.is_encdec else None
    args = (fr, toks) if cfg.is_encdec else (toks,)
    logits, caches = model.prefill(cfg, params, *args, dtype=torch.float32)
    assert logits.shape == (B, cfg.padded_vocab) and len(caches) == cfg.n_layers
    assert bool(torch.isfinite(logits[:, :cfg.vocab]).all())
    cache = model.init_cache(cfg, B, 8, dtype=torch.float32, device=CPU)
    if cfg.is_encdec:
        from repro_torch.models import whisper as TW
        TW.encode_into_cache(cfg, params, fr, cache)
    step, _ = model.decode_step(cfg, params, toks[:, 0], 0, cache, dtype=torch.float32)
    assert step.shape == (B, cfg.padded_vocab) and bool(torch.isfinite(step).all())
    out = ServeEngine(cfg, params, max_seq=8, device=CPU).generate(
        tokens(cfg, s=4), n_new=4, frames=None if fr is None else fr.numpy())
    assert out.tokens.shape == (B, 4) and 0 <= out.tokens.min() and out.tokens.max() < cfg.vocab


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device does not raise")
    cfg = treg.get_smoke_config("olmo-1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.init_cache(cfg, 1, 4)
