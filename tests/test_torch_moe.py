"""The port's MoE FFN and MoE LMs against ``repro``'s, on the CPU.

``repro``'s JAX initialisation is carried across (``carry``) and the same
numpy-seeded inputs go through both packages.  Float32 is held to
rtol = atol = 1e-4.  bfloat16 is held to 5e-2 of the largest reference
value under the ROUTING RULE:

* the router's logits are float32 in both packages, but of bf16
  activations that differ between the packages after a few layers (another
  accumulation order).  Where the k-th and (k+1)-th experts of a token are
  nearly tied, that drift can swap them: a NEAR TIE is a token whose chosen
  experts differ between the packages, and the test asserts that the gap
  between the reference's k-th and (k+1)-th logits is within twice the
  largest difference of that token's logits (a swap needs no more);
* both packages' routes are captured per MoE call, each token's KEPT
  experts derived from them with the capacity rule (:func:`kept_sets`,
  independent of either package), and a position is compared only when
  every token of its row up to it kept the same experts in every call (a
  different expert changes the token's output, which later positions of
  the row attend to; a different kept set elsewhere changes no other row's
  output).  Positions excluded so are counted and printed, and some must
  remain.  The qwen3-moe and dbrx smokes exclude none; jamba's smoke, whose
  eight MoE layers route bf16 activations that have drifted by about 0.03
  of a logit, keeps about half of its forward and a sixth of its decode.

The capacity drop rule is checked against an independent loop over tokens
(:func:`plain_moe`), in a case where the reference drops tokens.  A decode
step routes B tokens and a forward B * S, so their capacities differ:
decode equals forward only where the forward drops nothing, which the
tests that compare them assert.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.models import lm as RL
from repro.models import moe as RM
from repro.serve import engine as r_engine
from repro_torch.configs import registry as treg
from repro_torch.models import lm as TL
from repro_torch.models import moe as TM
from repro_torch.models.carry import lm_params_from_numpy
from repro_torch.serve import ServeEngine
from test_torch_models import BF16_REL, DTYPES, JIT, close, tokens, unstack_cache

CPU = "cpu"
MOE_ARCHS = ["qwen3-moe-235b-a22b", "dbrx-132b", "jamba-1.5-large-398b"]
B, S = 2, 16


# ===========================================================================
# The routing rule
# ===========================================================================
def chosen(logits: np.ndarray, k: int) -> np.ndarray:
    """(T, k) top-k expert ids, the lower id first among equal logits (as
    ``jax.lax.top_k``)."""
    return np.argsort(-logits, axis=-1, kind="stable")[:, :k]


def kept_sets(topi: np.ndarray, cap: int):
    """Each token's kept experts: slots ``token * k + j`` in order, an
    expert keeping its first ``cap`` slots (the reference's drop rule)."""
    seen = {}
    out = []
    for row in topi:
        keep = set()
        for e in row.tolist():
            if seen.get(e, 0) < cap:
                keep.add(e)
            seen[e] = seen.get(e, 0) + 1
        out.append(frozenset(keep))
    return out


def n_dropped(cfg, logits: np.ndarray) -> int:
    """Choices dropped by the capacity rule in one call of T tokens."""
    topi = chosen(logits, cfg.top_k)
    kept = kept_sets(topi, TM._capacity(cfg, len(logits)))
    return int(topi.size - sum(len(s) for s in kept))


class Routes:
    """Each MoE call's float32 router logits, in call order, in both
    packages: ``moe_forward`` of each wrapped to record them (the
    reference's through an ordered ``jax.debug.callback``, so that it
    records under ``jit`` and ``lax.scan`` too; a function jitted before
    the wrap would not record)."""

    def __init__(self, monkeypatch):
        self.ref, self.port = [], []
        r_orig, t_orig = RM.moe_forward, TM.moe_forward

        def r_wrap(cfg, p, x):
            jax.debug.callback(lambda lg: self.ref.append(np.asarray(lg)),
                               x.astype(jnp.float32) @ p["router"], ordered=True)
            return r_orig(cfg, p, x)

        def t_wrap(cfg, p, x):
            self.port.append((x.float() @ p.router.float()).numpy())
            return t_orig(cfg, p, x)

        monkeypatch.setattr(RM, "moe_forward", r_wrap)
        monkeypatch.setattr(TM, "moe_forward", t_wrap)

    def clear(self):
        self.ref.clear()
        self.port.clear()

    def agree(self, cfg, b: int, positions) -> np.ndarray:
        """(b, n) bool: position j of each row (``positions[call]`` maps a
        call's token i to its (row, position)) is comparable — every token
        of the row at or before it kept the same experts in every call."""
        jax.effects_barrier()
        assert len(self.ref) == len(self.port) > 0
        n = max(p for call in positions for _, p in call) + 1
        bad = np.zeros((b, n), bool)
        for lr, lt, pos in zip(self.ref, self.port, positions):
            lr = lr.reshape(-1, lr.shape[-1])
            lt = lt.reshape(-1, lt.shape[-1])
            cr, ct = chosen(lr, cfg.top_k), chosen(lt, cfg.top_k)
            cap = TM._capacity(cfg, len(lr))
            for i, (a, c) in enumerate(zip(kept_sets(cr, cap), kept_sets(ct, cap))):
                if set(cr[i]) != set(ct[i]):        # a near tie: the swap is explained
                    top = np.sort(lr[i])[::-1]
                    gap = top[cfg.top_k - 1] - top[cfg.top_k]
                    assert gap <= 2 * np.abs(lr[i] - lt[i]).max() + 1e-6, (i, gap)
                if a != c:
                    bad[pos[i]] = True
        return ~np.logical_or.accumulate(bad, axis=1)


def forward_positions(b, s, n_calls):
    return [[(i // s, i % s) for i in range(b * s)]] * n_calls


def report(what, ok: np.ndarray) -> None:
    print(f"{what}: {int(ok.sum())} of {ok.size} positions compared, "
          f"{int(ok.size - ok.sum())} excluded after a routing difference")
    assert ok.any(), what


def close_where(port, ref, ok: np.ndarray, what: str) -> None:
    """bf16: max |port - ref| over the comparable positions (leading axes of
    ``ok``'s shape), relative to the largest reference value there."""
    port = np.asarray(port.float() if isinstance(port, torch.Tensor) else port, np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    if not ok.any():
        return
    rel = np.abs(port - ref)[ok].max() / (np.abs(ref[ok]).max() + 1e-9)
    assert rel < BF16_REL, (what, rel)


# ===========================================================================
# The FFN alone
# ===========================================================================
def carried_moe(arch="qwen3-moe-235b-a22b", seed=0):
    rc, tc = rreg.get_smoke_config(arch), treg.get_smoke_config(arch)
    rp = RM.init_moe(rc, jax.random.PRNGKey(seed))
    tp = TM.MoE(tc, CPU)
    tp.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in rp.items()})
    return rc, tc, rp, tp


def skewed_input(rp, b, s, seed, skew=3.0):
    """Tokens leaning toward expert 0 (its router column added), so that
    more of them choose it than its capacity holds."""
    rng = np.random.default_rng(seed)
    col = np.asarray(rp["router"])[:, 0]
    x = rng.normal(size=(b, s, col.size)) + skew * col / np.linalg.norm(col) * math.sqrt(col.size)
    return x.astype(np.float32)


def plain_moe(cfg, p, x: np.ndarray) -> np.ndarray:
    """An independent float64 loop: each token's top-k of the float32
    router logits, softmaxed; per expert its first ``cap`` choosing tokens
    in token order; out[t] = sum of weight * SwiGLU expert of x[t]."""
    xt = x.reshape(-1, x.shape[-1])
    logits = np.asarray(jnp.asarray(xt, jnp.float32) @ p["router"])
    topi = chosen(logits, cfg.top_k)
    kept = kept_sets(topi, TM._capacity(cfg, len(xt)))
    wi, wg, wo = (np.asarray(p[n], np.float64) for n in ("wi", "wg", "wo"))
    out = np.zeros(xt.shape, np.float64)
    for t, (row, keep) in enumerate(zip(topi, kept)):
        top = logits[t, row].astype(np.float64)
        w = np.exp(top - top.max())
        w /= w.sum()
        for e, we in zip(row.tolist(), w):
            if e in keep:
                g = xt[t] @ wg[e]
                out[t] += we * ((g / (1 + np.exp(-g)) * (xt[t] @ wi[e])) @ wo[e])
    return out.reshape(x.shape)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_matches_reference(arch):
    rc, tc = rreg.get_smoke_config(arch), treg.get_smoke_config(arch)
    full_r, full_t = rreg.get_config(arch), treg.get_config(arch)
    for n in (1, 2, 7, 8, 32, 64, 100, 512, 4096):
        assert TM._capacity(tc, n) == RM._capacity(rc, n)
        assert TM._capacity(full_t, n) == RM._capacity(full_r, n)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_reference(arch, dtype, monkeypatch):
    """Gaussian tokens, 2 x 32: float32 to 1e-4; bf16 under the routing
    rule (the router sees the same bf16 inputs in both packages, so only
    float32 accumulation order can swap a near tie)."""
    rc, tc, rp, tp = carried_moe(arch, seed=1)
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(2).normal(size=(2, 32, tc.d_model)).astype(np.float32)
    routes = Routes(monkeypatch)
    want = RM.moe_forward(rc, rp, jnp.asarray(x, jdt))
    got = TM.moe_forward(tc, tp, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and got.shape == x.shape
    if dtype == "float32":
        close(got, want, dtype)
        return
    ok = routes.agree(tc, 2, forward_positions(2, 32, 1))
    report(f"{arch} moe_forward bf16", ok)
    close_where(got, want, ok, "moe_forward")


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "dbrx-132b"])
def test_moe_drops_as_reference(arch):
    """Tokens skewed toward expert 0, so that the reference drops choices:
    the port equals the reference (float32) and both equal the plain loop,
    which keeps each expert's first ``cap`` tokens; without the drop the
    output would differ."""
    rc, tc, rp, tp = carried_moe(arch, seed=3)
    x = skewed_input(rp, 2, 32, seed=4)
    logits = np.asarray(jnp.asarray(x.reshape(64, -1)) @ rp["router"])
    assert n_dropped(tc, logits) > 0
    want = np.asarray(RM.moe_forward(rc, rp, jnp.asarray(x)))
    got = TM.moe_forward(tc, tp, torch.from_numpy(x))
    close(got, want, "float32", "port vs reference")
    plain = plain_moe(tc, rp, x)
    np.testing.assert_allclose(want, plain, rtol=1e-4, atol=1e-4)
    no_cap = plain_moe(dataclasses.replace(tc, capacity_factor=float(tc.n_experts)), rp, x)
    assert np.abs(no_cap - plain).max() > 1e-2       # the drop is visible


def test_moe_stable_dispatch_follows_token_order():
    """Every token picks expert 0 first: the kept tokens are the first
    ``cap`` in token order, the later ones get only their other experts."""
    rc, tc, rp, tp = carried_moe()
    x = skewed_input(rp, 1, 48, seed=5, skew=30.0)
    logits = np.asarray(jnp.asarray(x[0]) @ rp["router"])
    topi = chosen(logits, tc.top_k)
    assert (topi[:, 0] == 0).all()
    cap = TM._capacity(tc, 48)
    kept = kept_sets(topi, cap)
    assert [0 in s for s in kept] == [True] * cap + [False] * (48 - cap)
    got = TM.moe_forward(tc, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), plain_moe(tc, rp, x), rtol=1e-4, atol=1e-4)
    close(got, RM.moe_forward(rc, rp, jnp.asarray(x)), "float32")


def test_moe_routes_to_multiple_experts():
    """The twin of ``tests/test_models.py::test_moe_routes_to_multiple_experts``:
    finite, the input's shape, more than one expert used, zero in -> zero out."""
    rc, tc, rp, tp = carried_moe()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 32, tc.d_model))
                         .astype(np.float32))
    y = TM.moe_forward(tc, tp, x)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert len(np.unique(chosen((x.reshape(64, -1) @ tp.router).numpy(), tc.top_k))) > 1
    assert float(TM.moe_forward(tc, tp, torch.zeros_like(x)).abs().max()) < 1e-5


def test_init_moe_layout_and_scales():
    rc, tc, rp, _ = carried_moe()
    tp = TM.init_moe(tc, torch.Generator().manual_seed(0), CPU)
    for name, t in tp.state_dict().items():
        w = np.asarray(rp[name])
        assert tuple(t.shape) == w.shape and t.dtype == torch.float32, name
        assert 0.8 < float(t.std()) / float(w.std()) < 1.25, name


# ===========================================================================
# MoE LMs: qwen3-moe, dbrx, jamba
# ===========================================================================
@pytest.fixture(scope="module")
def carried():
    """Per arch: the port's carried LM, the reference's params, seeded
    tokens and the reference's float32 outputs (jitted)."""
    out = {}

    def get(arch):
        if arch not in out:
            rc, tc = rreg.get_smoke_config(arch), treg.get_smoke_config(arch)
            rp = RL.init_params(rc, jax.random.PRNGKey(0))
            tp = lm_params_from_numpy(tc, jax.tree.map(np.asarray, rp), CPU)
            toks = tokens(rc)
            jt = jnp.asarray(toks)
            fwd = JIT["forward"](rc, rp, jt, dtype=jnp.float32)
            pre = JIT["prefill"](rc, rp, jt, dtype=jnp.float32)
            cache = RL.init_cache(rc, B, S, dtype=jnp.float32)
            dec = []
            for t in range(S):
                lg, cache = JIT["decode_step"](rc, rp, jt[:, t], jnp.int32(t), cache,
                                               dtype=jnp.float32)
                dec.append(np.asarray(lg))
            ref = {"forward": np.asarray(fwd),
                   "prefill": (np.asarray(pre[0]), unstack_cache(rc, pre[1])),
                   "decode": (np.stack(dec, axis=1), unstack_cache(rc, cache))}
            out[arch] = (rc, tc, rp, tp, toks, ref)
        return out[arch]

    return get


def port_decode(cfg, tp, toks, dtype):
    cache = TL.init_cache(cfg, B, S, dtype=dtype, device=CPU)
    t = torch.from_numpy(toks)
    logits = [TL.decode_step(cfg, tp, t[:, i], i, cache, dtype=dtype)[0] for i in range(S)]
    return torch.stack(logits, dim=1), cache


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_float32_matches_reference(carried, arch):
    """forward, prefill (logits and every layer's cache) and token-by-token
    decode_step (logits and caches), float32, to 1e-4."""
    rc, tc, rp, tp, toks, ref = carried(arch)
    t = torch.from_numpy(toks)
    close(TL.forward(tc, tp, t, dtype=torch.float32), ref["forward"], "float32", "forward")
    logits, caches = TL.prefill(tc, tp, t, dtype=torch.float32)
    close(logits, ref["prefill"][0], "float32", "prefill")
    for i, (c, w) in enumerate(zip(caches, ref["prefill"][1])):
        assert sorted(c) == sorted(w), i
        for k in c:
            close(c[k], w[k], "float32", f"prefill layer {i} {k}")
    dec, cache = port_decode(tc, tp, toks, torch.float32)
    close(dec, ref["decode"][0], "float32", "decode")
    for i, (c, w) in enumerate(zip(cache, ref["decode"][1])):
        for k in c:
            close(c[k], w[k], "float32", f"decode layer {i} {k}")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bfloat16_matches_reference_where_routing_agrees(carried, arch, monkeypatch):
    """forward, prefill and decode in bf16 under the routing rule; the
    reference's entry points are jitted afresh, after the routes' wrap."""
    rc, tc, rp, tp, toks, _ = carried(arch)
    n_moe = sum(s.ffn == "moe" for s in tc.layer_specs())
    routes = Routes(monkeypatch)
    jt, t = jnp.asarray(toks), torch.from_numpy(toks)
    bf = jnp.bfloat16
    r_forward = jax.jit(lambda p, x: RL.forward(rc, p, x, dtype=bf))
    r_prefill = jax.jit(lambda p, x: RL.prefill(rc, p, x, dtype=bf))
    r_decode = jax.jit(lambda p, x, i, c: RL.decode_step(rc, p, x, i, c, dtype=bf))

    want = r_forward(rp, jt)
    got = TL.forward(tc, tp, t, dtype=torch.bfloat16)
    ok = routes.agree(tc, B, forward_positions(B, S, n_moe))
    report(f"{arch} forward", ok)
    close_where(got, want, ok, "forward")

    routes.clear()
    want, want_cache = r_prefill(rp, jt)
    got, got_cache = TL.prefill(tc, tp, t, dtype=torch.bfloat16)
    ok = routes.agree(tc, B, forward_positions(B, S, n_moe))
    close_where(got, want, ok[:, -1], "prefill logits")
    for i, (c, w) in enumerate(zip(got_cache, unstack_cache(rc, want_cache))):
        for k in c:
            if c[k].dim() > 3 and k in ("k", "v"):
                close_where(c[k], w[k], ok, f"prefill layer {i} {k}")
            else:
                close_where(c[k], w[k], ok[:, -1], f"prefill layer {i} {k}")

    routes.clear()
    cache = RL.init_cache(rc, B, S, dtype=bf)
    want = []
    for i in range(S):
        lg, cache = r_decode(rp, jt[:, i], jnp.int32(i), cache)
        want.append(np.asarray(lg, np.float32))
    got, _ = port_decode(tc, tp, toks, torch.bfloat16)
    ok = routes.agree(tc, B, [[(b, i) for b in range(B)]
                              for i in range(S) for _ in range(n_moe)])
    report(f"{arch} decode", ok)
    close_where(got, np.stack(want, axis=1), ok, "decode")


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "dbrx-132b"])
def test_prefill_matches_forward_last_position(carried, arch):
    """The twin of ``tests/test_models.py::test_prefill_matches_forward_last_position``
    (qwen3-moe there), on the port alone: the same tokens in one call, so
    the same capacity and the same drops."""
    _, tc, _, tp, toks, _ = carried(arch)
    t = torch.from_numpy(toks)
    full = TL.forward(tc, tp, t, dtype=torch.float32)
    logits, _ = TL.prefill(tc, tp, t, dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(), rtol=2e-3, atol=2e-3)


def test_decode_matches_forward_where_forward_drops_nothing(carried, monkeypatch):
    """qwen3-moe: decode (B = 2 tokens a call, capacity 8) equals forward
    on a prompt whose forward drops nothing (asserted per MoE call); on the
    seeded 16-token prompts the forward drops, and decode differs there."""
    _, tc, _, tp, toks, _ = carried("qwen3-moe-235b-a22b")
    routes = Routes(monkeypatch)
    short = toks[:, :4]                        # B * S = 8 <= the capacity of 8
    full = TL.forward(tc, tp, torch.from_numpy(short), dtype=torch.float32)
    assert routes.port and all(n_dropped(tc, lg.reshape(8, -1)) == 0 for lg in routes.port)
    cache = TL.init_cache(tc, B, 4, dtype=torch.float32, device=CPU)
    dec = torch.stack([TL.decode_step(tc, tp, torch.from_numpy(short[:, i]), i, cache,
                                      dtype=torch.float32)[0] for i in range(4)], dim=1)
    rel = float((dec - full).abs().max()) / float(full.abs().max())
    assert rel < 2e-3, rel
    routes.clear()
    TL.forward(tc, tp, torch.from_numpy(toks), dtype=torch.float32)
    assert sum(n_dropped(tc, lg.reshape(B * S, -1)) for lg in routes.port) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cast_once_equals_cast_per_matmul(carried, arch):
    """bf16 weights cast once give bit-identical logits to float32 weights
    cast at every use; the router, the norm scales and (jamba) ``A_log`` /
    ``dt_bias`` stay float32."""
    _, tc, _, tp, toks, _ = carried(arch)
    cast = TL.cast_params(tc, tp, torch.bfloat16, CPU)
    keep = ("scale", "router", "A_log", "dt_bias")
    for name, t in cast.state_dict().items():
        assert t.dtype == (torch.float32 if name.endswith(keep) else torch.bfloat16), name
    assert any(n.endswith("router") for n in cast.state_dict())
    t = torch.from_numpy(toks)
    assert torch.equal(TL.forward(tc, cast, t), TL.forward(tc, tp, t))
    c1 = TL.init_cache(tc, B, S, device=CPU)
    c2 = TL.init_cache(tc, B, S, device=CPU)
    for i in range(4):
        assert torch.equal(TL.decode_step(tc, cast, t[:, i], i, c1)[0],
                           TL.decode_step(tc, tp, t[:, i], i, c2)[0])


def test_carry_takes_moe_trees_strictly(carried):
    """Expert leaves (expert axis after the block axis) land on each
    layer's ``moe``; a tree without the router is refused."""
    rc, tc, rp, tp, _, _ = carried("qwen3-moe-235b-a22b")
    tree = jax.tree.map(np.asarray, rp)
    np.testing.assert_array_equal(tp.layers[1].moe.wi.numpy(), tree["blocks"]["l0"]["moe"]["wi"][1])
    assert tp.layers[0].moe.wo.shape == (tc.n_experts, tc.d_ff, tc.d_model)
    bad = jax.tree.map(lambda a: a, tree)
    del bad["blocks"]["l0"]["moe"]["router"]
    with pytest.raises(RuntimeError, match="router"):
        lm_params_from_numpy(tc, bad, CPU)


def test_greedy_generate_matches_reference():
    """The qwen3-moe smoke behind both engines (float32): 6-token prompts,
    one left-padded, 6 greedy tokens, the reference's tokens."""
    rc, tc = rreg.get_smoke_config("qwen3-moe-235b-a22b"), treg.get_smoke_config(
        "qwen3-moe-235b-a22b")
    rp = RL.init_params(rc, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(tc, jax.tree.map(np.asarray, rp), CPU)
    prompts = np.random.default_rng(7).integers(1, rc.vocab, (4, 6)).astype(np.int32)
    prompts[1, :2] = -1
    a = r_engine.ServeEngine(rc, rp, max_seq=12, dtype=jnp.float32).generate(prompts, n_new=6)
    b = ServeEngine(tc, tp, max_seq=12, dtype=torch.float32, device=CPU).generate(prompts, n_new=6)
    np.testing.assert_array_equal(b.tokens, a.tokens)
