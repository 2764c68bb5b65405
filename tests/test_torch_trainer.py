"""The port's training step against ``repro``'s, and the training substrate,
on the CPU.

With ``repro``'s JAX init carried across (``carry.params_from_numpy``)
and the same numpy-seeded tokens, labels (some masked) and frames:

* the float32 loss and every parameter's gradient equal the reference's
  ``jax.value_and_grad`` of ``forward(..., dtype=float32)`` for the olmo,
  gemma3-1b, mamba2, qwen3-moe and whisper smokes, within 1e-4 of each
  leaf's largest reference gradient (the MoE router's included);
* one float32 ``train_step`` at ``n_micro`` 1 and 2 equals the reference's
  ``make_train_step`` given the float32 forward (loss, grad norm, lr,
  updated params and float32 moments, 1e-4 of each leaf's largest value;
  a parameter whose gradient is under 1e-3 of its leaf's largest within
  2.2 x lr, since Adam's first step divides a gradient by its magnitude);
* a bf16 step agrees loosely: loss and grad norm within 2e-2 relative (the
  forward's bf16 matmuls accumulate in another order), and every updated
  parameter within 2.2 x lr of the reference's (one Adam step moves it by
  about lr, so 2 x lr apart when the two gradients disagree in sign);
* ``cross_entropy`` equals the reference's with masked labels, and on a
  padded vocabulary the padding's logits and embedding rows get a zero
  gradient;
* remat (``"nothing"`` and ``"dots"``) gives the gradients of no remat bit
  for bit while saving fewer tensors; the SSD's masked exponent keeps the
  gradient finite at dt ~ 30, where the reference's is NaN.

And the twin of ``tests/test_models.py::test_one_train_step`` over all ten
smokes on the port alone.  ``tests/test_torch_train_loop.py`` holds the
loop, the checkpoints and the launcher.
"""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as rarchs
from repro.configs import registry as rreg
from repro.models import ssd as RS
from repro.models.registry import get_model as rget
from repro.train import optimizer as RO
from repro.train import trainer as RT
from repro_torch.configs import registry as treg
from repro_torch.models import common as C
from repro_torch.models import ssd as TS
from repro_torch.models.carry import params_from_numpy, params_to_numpy
from repro_torch.models.common import trainable
from repro_torch.models.registry import get_model as tget
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.trainer import (
    TrainState,
    cross_entropy,
    init_train_state,
    make_loss_fn,
    make_train_step,
)
from test_torch_ssd import carried_ssd, inputs

CPU = "cpu"
ALL_ARCHS = list(rarchs.ARCHS)
FIVE = ["olmo-1b", "gemma3-1b", "mamba2-370m", "qwen3-moe-235b-a22b", "whisper-small"]
GRAD_REL = 1e-4
B, S = 4, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The smoke tensors are tiny: one intra-op thread runs them about three
    times faster than eight, and several test workers then do not contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves_close(port_tree, ref_tree, rel, what):
    """Every leaf within ``rel`` of its largest reference value."""
    ref = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, ref_tree))
    port = jax.tree.leaves(port_tree)
    assert len(port) == len(ref), what
    for (path, r), p in zip(ref, port):
        r = np.asarray(jnp.asarray(r, jnp.float32))
        np.testing.assert_allclose(p, r, rtol=0, atol=rel * float(np.abs(r).max()) + 1e-30,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def params_close(port_tree, ref_tree, ref_mu, lr):
    """Updated parameters within 1e-4 of each leaf's largest value, except
    where the gradient is within 1e-3 of its leaf's largest: Adam divides
    the gradient by its own magnitude, so two gradients equal within 1e-4
    of the leaf's largest may move such a parameter by up to 2 x lr apart
    (held to 2.2 x lr)."""
    ref = jax.tree.leaves(jax.tree.map(np.asarray, ref_tree))
    mus = jax.tree.leaves(jax.tree.map(np.asarray, ref_mu))
    for p, r, m in zip(jax.tree.leaves(port_tree), ref, mus):
        big = np.abs(m) > 1e-3 * np.abs(m).max()
        np.testing.assert_allclose(p[big], r[big], rtol=0, atol=GRAD_REL * np.abs(r).max())
        np.testing.assert_allclose(p[~big], r[~big], rtol=0, atol=2.2 * lr)


def make_batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], -np.ones((b, 1), np.int32)], axis=1)
    labels[0, 3] = -1                      # a masked label inside the sequence
    out = {"tokens": toks, "labels": labels}
    if cfg.is_encdec:
        out["frames"] = rng.normal(size=(b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def ref_forward_f32(rc):
    """The reference's model with its forward pinned to float32."""
    m = rget(rc)
    return m._replace(forward=functools.partial(m.forward, dtype=jnp.float32))


@pytest.fixture(scope="module")
def carried():
    """Per arch: configs, the reference's params (numpy) and a batch."""
    out = {}

    def get(arch):
        if arch not in out:
            rc, tc = rreg.get_smoke_config(arch), treg.get_smoke_config(arch)
            rp = jax.tree.map(np.asarray, rget(rc).init_params(rc, jax.random.PRNGKey(0)))
            out[arch] = (rc, tc, rp, make_batch(rc))
        return out[arch]
    return get


def port_state(tc, rp, opt):
    params = trainable(params_from_numpy(tc, rp, CPU))
    return TrainState(params, init_opt_state(params, opt))


def port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ===========================================================================
# The loss and its gradient
# ===========================================================================
def test_cross_entropy_equals_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[rng.random((3, 7)) < 0.3] = -1
    for lab in (labels, np.full_like(labels, -1)):     # the all-masked batch too
        rl, rd = RT.cross_entropy(jnp.asarray(logits), jnp.asarray(lab))
        tl, td = cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab))
        np.testing.assert_allclose(float(tl), float(rl), rtol=1e-6)
        assert float(td) == float(rd) and tl.dtype == torch.float32


def test_padded_vocab_gets_no_gradient():
    rc = dataclasses.replace(rreg.get_smoke_config("olmo-1b"), vocab=250)
    tc = dataclasses.replace(treg.get_smoke_config("olmo-1b"), vocab=250)
    assert tc.padded_vocab == 256 and rc.padded_vocab == 256
    rp = jax.tree.map(np.asarray, rget(rc).init_params(rc, jax.random.PRNGKey(0)))
    batch = make_batch(rc)
    with mock.patch.object(RT, "get_model", ref_forward_f32):
        rloss_fn = RT.make_loss_fn(rc)
    rl, rg = jax.jit(jax.value_and_grad(rloss_fn))(rp, jax.tree.map(jnp.asarray, batch))
    params = trainable(params_from_numpy(tc, rp, CPU))
    logits = tget(tc).forward(tc, params, torch.from_numpy(batch["tokens"]), dtype=torch.float32)
    logits.retain_grad()
    loss = cross_entropy(logits, torch.from_numpy(batch["labels"]))[0]
    loss.backward()
    assert bool((logits.grad[..., tc.vocab:] == 0).all())
    assert bool((params.embed.grad[tc.vocab:] == 0).all())      # tied: the head's padding
    assert bool((params.embed.grad[:tc.vocab] != 0).any())
    np.testing.assert_allclose(float(loss), float(rl), rtol=1e-5)
    leaves_close(params_to_numpy(tc, {n: p.grad for n, p in params.named_parameters()}),
                 rg, GRAD_REL, "padded-vocab grads")


@pytest.mark.parametrize("arch", FIVE)
def test_value_and_grad_float32_equals_reference(carried, arch):
    rc, tc, rp, batch = carried(arch)
    with mock.patch.object(RT, "get_model", ref_forward_f32):
        rloss_fn = RT.make_loss_fn(rc)
    rl, rg = jax.jit(jax.value_and_grad(rloss_fn))(rp, jax.tree.map(jnp.asarray, batch))
    params = trainable(params_from_numpy(tc, rp, CPU))
    loss = make_loss_fn(tc, dtype=torch.float32)(params, port_batch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(rl), rtol=1e-5)
    named = dict(params.named_parameters())
    assert all(p.grad is not None for p in named.values())
    leaves_close(params_to_numpy(tc, {n: p.grad for n, p in named.items()}), rg, GRAD_REL,
                 f"{arch} grads")
    if arch == "qwen3-moe-235b-a22b":     # the gradient reaches the float32 router
        router = named["layers.0.moe.router"].grad
        assert router.dtype == torch.float32 and bool(router.abs().max() > 0)


# ===========================================================================
# The step
# ===========================================================================
OPT_KW = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10)


# n_micro 2 on all five, 1 on all but gemma3-1b (its 14 layers are the
# slowest to jit; its value and gradient are held above)
@pytest.mark.parametrize("arch,n_micro", [(a, 2) for a in FIVE]
                         + [(a, 1) for a in FIVE if a != "gemma3-1b"])
def test_train_step_float32_equals_reference(carried, arch, n_micro):
    rc, tc, rp, batch = carried(arch)
    ropt = RO.AdamWConfig(**OPT_KW, moment_dtype=jnp.float32)
    topt = AdamWConfig(**OPT_KW, moment_dtype=torch.float32)
    with mock.patch.object(RT, "get_model", ref_forward_f32):
        rstep = jax.jit(RT.make_train_step(rc, ropt, n_micro=n_micro))
    rstate = RT.TrainState(jax.tree.map(jnp.asarray, rp), RO.init_opt_state(rp, ropt))
    rnew, rmet = rstep(rstate, jax.tree.map(jnp.asarray, batch))
    state = port_state(tc, rp, topt)
    new, met = make_train_step(tc, topt, n_micro=n_micro, dtype=torch.float32)(
        state, port_batch(batch))
    np.testing.assert_allclose(float(met["loss"]), float(rmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]), float(rmet["grad_norm"]), rtol=1e-4)
    assert float(met["lr"]) == float(rmet["lr"])
    assert int(new.opt.step) == int(rnew.opt.step) == 1
    params_close(params_to_numpy(tc, new.params), rnew.params, rnew.opt.mu, float(met["lr"]))
    leaves_close(params_to_numpy(tc, new.opt.mu), rnew.opt.mu, GRAD_REL, "mu")
    leaves_close(params_to_numpy(tc, new.opt.nu), rnew.opt.nu, 2 * GRAD_REL, "nu")
    # the step is functional: the old state is untouched and keeps no gradient
    for (n, p), r in zip(state.params.named_parameters(),
                         params_from_numpy(tc, rp, CPU).parameters()):
        assert torch.equal(p, r) and p.grad is None, n
    assert int(state.opt.step) == 0
    assert all(p.requires_grad for p in new.params.parameters())


def test_train_step_bf16_loosely_equals_reference(carried):
    rc, tc, rp, batch = carried("olmo-1b")
    ropt, topt = RO.AdamWConfig(**OPT_KW), AdamWConfig(**OPT_KW)
    rstep = jax.jit(RT.make_train_step(rc, ropt, n_micro=2))
    rnew, rmet = rstep(RT.TrainState(jax.tree.map(jnp.asarray, rp), RO.init_opt_state(rp, ropt)),
                       jax.tree.map(jnp.asarray, batch))
    new, met = make_train_step(tc, topt, n_micro=2)(port_state(tc, rp, topt), port_batch(batch))
    np.testing.assert_allclose(float(met["loss"]), float(rmet["loss"]), rtol=2e-2)
    np.testing.assert_allclose(float(met["grad_norm"]), float(rmet["grad_norm"]), rtol=2e-2)
    lr = float(met["lr"])
    for p, r in zip(jax.tree.leaves(params_to_numpy(tc, new.params)),
                    jax.tree.leaves(rnew.params)):
        np.testing.assert_allclose(p, np.asarray(r), rtol=0, atol=2.2 * lr)
    assert {v.dtype for v in new.opt.mu.values()} == {torch.bfloat16}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_one_train_step(arch):
    """The twin of ``tests/test_models.py::test_one_train_step``."""
    cfg = treg.get_smoke_config(arch)
    opt = AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=10)
    state = init_train_state(cfg, torch.Generator().manual_seed(1), opt, CPU)
    step = make_train_step(cfg, opt, n_micro=2)
    before = {n: p.detach().clone() for n, p in state.params.named_parameters()}
    new_state, metrics = step(state, port_batch(make_batch(cfg, seed=1)))
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    assert int(new_state.opt.step) == 1
    moved = max(float((p - before[n]).abs().max())
                for n, p in new_state.params.named_parameters())
    assert moved > 0


def test_step_rejects_bad_batches_and_dtypes():
    cfg = treg.get_smoke_config("olmo-1b")
    opt = AdamWConfig()
    state = init_train_state(cfg, torch.Generator().manual_seed(0), opt, CPU)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, opt, n_micro=3)(state, port_batch(make_batch(cfg)))
    bf16 = TrainState(C.rebind(state.params, {n: p.detach().bfloat16() for n, p in
                                              state.params.named_parameters()}), state.opt)
    with pytest.raises(ValueError, match="accumulate"):
        make_train_step(cfg, opt)(bf16, port_batch(make_batch(cfg)))


# ===========================================================================
# Remat and the SSD's masked exponent
# ===========================================================================
def _grads_and_saved(cfg, params, batch):
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(1) or t, lambda t: t):
        loss = make_loss_fn(cfg, dtype=torch.float32)(params, batch)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in params.named_parameters()}
    for p in params.parameters():
        p.grad = None
    return grads, len(saved)


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-370m", "qwen3-moe-235b-a22b",
                                  "whisper-small"])
def test_remat_gives_equal_gradients(carried, arch, monkeypatch):
    rc, tc, rp, batch = carried(arch)
    params = trainable(params_from_numpy(tc, rp, CPU))
    batch = port_batch(batch)
    assert not tc.remat
    base, n_base = _grads_and_saved(tc, params, batch)
    decisions = []
    policy = C._dots_policy
    monkeypatch.setattr(C, "_dots_policy",
                        lambda ctx, op, *a, **k: decisions.append(op) or policy(ctx, op, *a, **k))
    for pol in ("nothing", "dots"):
        cfg = dataclasses.replace(tc, remat=True, remat_policy=pol)
        grads, n_saved = _grads_and_saved(cfg, params, batch)
        assert n_saved < n_base, (pol, n_saved, n_base)
        for n in base:
            assert torch.equal(grads[n], base[n]), (pol, n)
    if tc.is_encdec:          # the encoder-decoder always saves nothing
        assert not decisions
    else:                     # the LM's blocks take the policy; the mm outputs are kept
        assert torch.ops.aten.mm.default in decisions
        with pytest.raises(ValueError, match="remat policy"):
            make_loss_fn(dataclasses.replace(tc, remat=True, remat_policy="most"))(params, batch)


def test_ssd_masked_exponent_gradient_is_finite():
    """dt ~ 30 (dt_bias 30, A = -1): above the diagonal the segment sums
    reach +210 in a chunk of 8 and exp() overflows.  The reference's
    where(tril, exp(seg), 0) then has a NaN gradient (0 * inf); the port's
    exp(where(tril, seg, -inf)) gives the same values bit for bit and a
    finite gradient, equal to the reference's wherever that is finite, and
    to it everywhere at a small dt."""
    for dt_bias, overflow in ((30.0, True), (0.0, False)):
        rc, tc, rp, tp = carried_ssd(dt_bias=np.full(8, dt_bias, np.float32))
        x = inputs(tc, seed=4)
        rg = np.asarray(jax.jit(jax.grad(lambda x: RS.ssd_forward(rc, rp, x).sum()))(
            jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_(True)
        out = TS.ssd_forward(tc, trainable(tp), xt)
        out.sum().backward()
        tg = xt.grad.numpy()
        assert np.isfinite(tg).all() and bool(torch.isfinite(tp.dt_bias.grad).all())
        assert np.isnan(rg).any() == overflow
        ok = np.isfinite(rg)
        if ok.any():
            np.testing.assert_allclose(tg[ok], rg[ok], rtol=1e-4,
                                       atol=1e-4 * np.abs(rg[ok]).max())
    # the two masks give the same values bit for bit, overflow included
    seg = torch.tensor([[0.0, 210.0, 400.0], [-3.0, 0.0, 95.0], [-7.5, -4.0, 0.0]])
    tril = torch.ones(3, 3, dtype=torch.bool).tril()
    assert torch.equal(torch.exp(torch.where(tril, seg, float("-inf"))),
                       torch.where(tril, torch.exp(seg), 0.0))
