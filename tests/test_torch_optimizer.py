"""The port's AdamW against ``repro``'s, on the CPU.

The learning-rate schedule over warmup, the cosine and past its end is
computed in float32 in both packages: bit for bit equal during warmup and
past the end, and on the cosine within lr_peak * 2^-23, one float32 ulp
of the cosine scaled by the peak (neither XLA's nor PyTorch's float32
cosine is correctly rounded, and they differ in the last bit on about 5%
of arguments).

Two steps of ``adamw_update`` on the olmo smoke's parameter tree
(``repro``'s JAX init; each stacked leaf of the reference is one entry of
the port's tree, so both packages see the same leaves; gradients drawn
with numpy) must give the reference's parameters, moments, residuals and
metrics, with float32 and bf16 moments, compression off and int8, and
global-norm clipping active and inactive.  (In training the port's leaves
are single layers where the reference's stack a block position's layers
over the blocks, so its int8 scale is per layer there.)  Elementwise
float32 work in another library may round an operation differently, so
float32 results are held to 1e-6 (a few float32 ulps) of the element or of
the leaf's largest value; a bf16 moment may then round to the
neighbouring bf16 value, so bf16 moments are held to one bf16 ulp (2^-7)
of the same.  int8 fake quantization rounds exact halves to even in both
packages, and the error-feedback residual stays within half a bucket.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.models import lm as RL
from repro.train import optimizer as RO
from repro_torch.train import optimizer as TO

F32_RTOL = 1e-6
BF16_RTOL = 2.0 ** -7
ARCH = "olmo-1b"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The smoke tensors are tiny: one intra-op thread runs them about three
    times faster than eight, and several test workers then do not contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ropt(**kw):
    if kw.get("moment_dtype") == "float32":
        kw["moment_dtype"] = jnp.float32
    return RO.AdamWConfig(**kw)


def topt(**kw):
    if kw.get("moment_dtype") == "float32":
        kw["moment_dtype"] = torch.float32
    return TO.AdamWConfig(**kw)


def flat(tree):
    """The reference's tree as {path: numpy array}, one entry per leaf
    (bf16 as float32, exactly)."""
    return {jax.tree_util.keystr(p): np.asarray(jnp.asarray(x, jnp.float32)
                                                if x.dtype == jnp.bfloat16 else x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def to_port(tree, dtype=None):
    """{path: tensor} of the reference's tree, cast to ``dtype`` where given."""
    out = {k: torch.from_numpy(v) for k, v in flat(tree).items()}
    return {k: v.to(dtype) for k, v in out.items()} if dtype else out


def same_leaves(port, ref, rtol, what):
    ref = flat(ref)
    assert list(port) == list(ref), what
    for k, r in ref.items():
        p = port[k].detach()
        p = (p.float() if p.dtype == torch.bfloat16 else p).numpy()
        np.testing.assert_allclose(p, r, rtol=rtol, atol=rtol * float(np.abs(r).max()),
                                   err_msg=f"{what} {k}")


def test_config_defaults_match_reference():
    r, t = RO.AdamWConfig(), TO.AdamWConfig()
    for f in dataclasses.fields(r):
        if f.name in ("moment_dtype", "accum_dtype"):
            continue
        assert getattr(t, f.name) == getattr(r, f.name), f.name
    assert t.moment_dtype == torch.bfloat16 and r.moment_dtype == jnp.bfloat16
    assert t.accum_dtype == torch.float32 and r.accum_dtype == jnp.float32


@pytest.mark.parametrize("warmup,total", [(10, 40), (0, 5), (1, 1), (7, 3)])
def test_lr_schedule_equals_reference(warmup, total):
    kw = dict(lr_peak=3e-4, warmup_steps=warmup, total_steps=total)
    r, t = ropt(**kw), topt(**kw)
    for step in range(0, max(total, warmup) + 6):
        want = np.asarray(RO.lr_schedule(r, jnp.int32(step)))
        got = TO.lr_schedule(t, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        if step < warmup or step >= total:
            assert got.numpy().tobytes() == want.tobytes(), (step, float(got), float(want))
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=kw["lr_peak"] * 2.0 ** -23)


@pytest.fixture(scope="module")
def carried():
    """The olmo smoke's reference params and seeded gradients (large
    enough that clipping bites at clip_norm 1)."""
    rc = rreg.get_smoke_config(ARCH)
    rp = jax.tree.map(np.asarray, RL.init_params(rc, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.05).astype(np.float32), rp)
    return rp, grads


@pytest.mark.parametrize("clip", [1e9, 1.0])
@pytest.mark.parametrize("bits", [0, 8])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_equals_reference(carried, moments, bits, clip):
    rp, grads = carried
    kw = dict(lr_peak=1e-2, warmup_steps=1, total_steps=10, clip_norm=clip,
              grad_compress_bits=bits, weight_decay=0.1)
    if moments == "float32":
        kw["moment_dtype"] = "float32"
    r, t = ropt(**kw), topt(**kw)
    mom_rtol = F32_RTOL if moments == "float32" else BF16_RTOL
    rstate = RO.init_opt_state(rp, r)
    tp = to_port(rp)
    tstate = TO.init_opt_state(tp, t)
    assert (tstate.err is None) == (bits == 0)
    assert {v.dtype for v in tstate.mu.values()} == {t.moment_dtype}
    rng = np.random.default_rng(5)
    # two steps: the second starts from non-zero moments and residuals
    for k in range(2):
        rgrads = grads if k == 0 else jax.tree.map(
            lambda a: (rng.normal(size=a.shape) * 0.05).astype(np.float32), grads)
        rp_new, rstate_new, rmet = RO.adamw_update(rp, rgrads, rstate, r)
        tp_new, tstate_new, tmet = TO.adamw_update(tp, to_port(rgrads), tstate, t)
        same_leaves(tp_new, rp_new, F32_RTOL, f"step {k} params")
        same_leaves(tstate_new.mu, rstate_new.mu, mom_rtol, f"step {k} mu")
        same_leaves(tstate_new.nu, rstate_new.nu, mom_rtol, f"step {k} nu")
        if bits:
            same_leaves(tstate_new.err, rstate_new.err, 1e-5, f"step {k} err")
        assert int(tstate_new.step) == int(rstate_new.step) == k + 1
        assert {v.dtype for v in tstate_new.mu.values()} == {t.moment_dtype}
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(rmet["grad_norm"]),
                                   rtol=F32_RTOL)
        assert float(tmet["lr"]) == float(rmet["lr"])
        if clip == 1.0:
            assert float(rmet["grad_norm"]) > 1.0      # the clip is active
        # both continue from the reference's parameters and state
        rp, rstate = jax.tree.map(np.asarray, rp_new), rstate_new
        tp = to_port(rp)
        tstate = TO.OptState(torch.tensor(k + 1, dtype=torch.int32),
                             to_port(rstate.mu, t.moment_dtype),
                             to_port(rstate.nu, t.moment_dtype),
                             to_port(rstate.err) if bits else None)


def test_update_returns_new_tensors(carried):
    rp, grads = carried
    tp, tg = to_port(rp), to_port(grads)
    t = topt()
    before = {n: p.clone() for n, p in tp.items()}
    state = TO.init_opt_state(tp, t)
    new_p, new_state, _ = TO.adamw_update(tp, tg, state, t)
    for n in tp:
        assert torch.equal(tp[n], before[n]) and new_p[n] is not tp[n]
        assert not state.mu[n].any()
    assert int(state.step) == 0 and int(new_state.step) == 1


def test_fake_quant_int8_rounds_halves_to_even():
    halves = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5, -126.5], np.float32)
    err = np.zeros_like(halves)
    rdeq, rres = RO._fake_quant_int8(jnp.asarray(halves), jnp.asarray(err))
    tdeq, tres = TO._fake_quant_int8(torch.from_numpy(halves), torch.from_numpy(err))
    np.testing.assert_array_equal(tdeq.numpy(), np.asarray(rdeq))
    np.testing.assert_array_equal(tres.numpy(), np.asarray(rres))
    np.testing.assert_array_equal(tdeq.numpy(), [127, 0, 2, 2, -0.0, -2, -2, 4, 126, -126])
    # residuals carried in: g + err straddles buckets the same way
    g = np.linspace(-1, 1, 33).astype(np.float32)
    e = np.random.default_rng(0).normal(size=33).astype(np.float32) * 1e-2
    rdeq, rres = RO._fake_quant_int8(jnp.asarray(g), jnp.asarray(e))
    tdeq, tres = TO._fake_quant_int8(torch.from_numpy(g), torch.from_numpy(e))
    np.testing.assert_allclose(tdeq.numpy(), np.asarray(rdeq), rtol=F32_RTOL)
    np.testing.assert_allclose(tres.numpy(), np.asarray(rres), rtol=1e-5, atol=1e-9)


def test_grad_compression_error_feedback():
    """The twin of ``tests/test_trainer.py::test_grad_compression_error_feedback``,
    whose residual must also equal the reference's."""
    kw = dict(grad_compress_bits=8, clip_norm=1e9, weight_decay=0.0, lr_peak=1.0,
              warmup_steps=0, total_steps=1, moment_dtype="float32")
    params = {"w": torch.zeros((4, 4), dtype=torch.float32)}
    opt = topt(**kw)
    state = TO.init_opt_state(params, opt)
    assert state.err is not None
    g = {"w": torch.full((4, 4), 0.333e-3, dtype=torch.float32)
         + torch.arange(16, dtype=torch.float32).reshape(4, 4) * 1e-6}
    _, state2, _ = TO.adamw_update(params, g, state, opt)
    # residual is bounded by one quantization bucket
    scale = float(g["w"].abs().max()) / 127.0
    assert float(state2.err["w"].abs().max()) <= scale * 0.5 + 1e-12
    # and is carried (nonzero somewhere, because values straddle buckets)
    assert float(state2.err["w"].abs().max()) > 0
    r = ropt(**kw)
    rparams = {"w": jnp.zeros((4, 4), jnp.float32)}
    _, rstate2, _ = RO.adamw_update(rparams, {"w": jnp.asarray(g["w"].numpy())},
                                    RO.init_opt_state(rparams, r), r)
    np.testing.assert_allclose(state2.err["w"].numpy(), np.asarray(rstate2.err["w"]),
                               rtol=1e-5, atol=1e-12)


def test_global_norm_is_per_leaf_float32_sums_in_order(carried):
    rp, grads = carried
    tg = to_port(grads)
    want = float(RO._global_norm(grads))
    got = TO._global_norm(tg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=F32_RTOL)
    by_hand = torch.zeros((), dtype=torch.float32)
    for g in tg.values():
        by_hand = by_hand + (g.float() ** 2).sum()
    assert float(got) == float(torch.sqrt(by_hand))
