"""The port's activation hints and the MoE's groups against ``repro``'s.

* ``hint`` is the identity without a policy, without an active mesh, and
  for a plain tensor; with both it checks the rank (the reference's
  ``ValueError``) and redistributes a DTensor to the resolved placements,
  its divisibility guard included.  These run in this process on a
  one-rank gloo world over a ``HashStore`` (no spawn), torn down after.
* The MoE under ``use_policy({"moe_groups": 4})`` against ``repro``'s
  ``moe_forward`` under the same policy (the reference's hints are no-ops
  without a mesh, so it runs G = 4 on one CPU device): the qwen3-moe and
  dbrx smokes in float32 with their JAX init carried across, on 8 x 32
  tokens skewed toward expert 0 so that the groups drop choices.  Outputs within
  rtol = atol = 1e-4 (``test_torch_moe``'s float32 tolerance); the tokens
  whose output the group capacity changed (those differing from the
  no-drop output) are exactly the same set in both packages, and differ
  from G = 1's.
"""
import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro.models import moe as RM
from repro.models import pshard as RPS
from repro_torch.launch.mesh import current_mesh, init_world, make_mesh, use_mesh
from repro_torch.models import moe as TM
from repro_torch.models import pshard as PS
from test_torch_moe import carried_moe, skewed_input

POLICY = {"dp": ("data",), "tp": "model"}


@pytest.fixture(scope="module")
def mesh():
    init_world(0, 1, store=dist.HashStore(), device_type="cpu")
    try:
        yield make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def test_hint_is_identity_without_policy_or_mesh(mesh):
    x = torch.randn(4, 3, 2)
    assert PS.policy() is None and current_mesh() is None
    assert PS.hint(x, "dp", None, None) is x                  # no policy
    with PS.use_policy(POLICY):
        assert PS.hint(x, "dp", None) is x                    # no mesh: not even the rank
    d = distribute_tensor(x, mesh, [Shard(0), Replicate()])
    with use_mesh(mesh):
        assert PS.hint(d, "dp", None, None) is d              # no policy
    with use_mesh(mesh), PS.use_policy(POLICY):
        assert PS.hint(x, "dp", None, None) is x              # a plain (local) tensor
    assert PS.policy() is None and current_mesh() is None     # both scopes restored


def test_hint_rank_error(mesh):
    """Twin of the reference's: a policy and a mesh, the wrong number of
    names."""
    x = torch.zeros(4, 3)
    with use_mesh(mesh), PS.use_policy(POLICY):
        with pytest.raises(ValueError, match="2 names for rank-3"):
            PS.hint(torch.zeros(4, 3, 2), "dp", None)
        with pytest.raises(ValueError, match="3 names for rank-2"):
            PS.hint(x, "dp", None, None)


def test_hint_redistributes_a_dtensor(mesh):
    """Placements resolve per mesh axis; an axis of size 1 guards to
    Replicate, as ``_guard`` does (n > 1 required)."""
    d = distribute_tensor(torch.randn(4, 6), mesh, [Shard(0), Shard(1)])
    with use_mesh(mesh), PS.use_policy(POLICY):
        out = PS.hint(d, "dp", "tp")
    assert isinstance(out, DTensor)
    assert tuple(out.placements) == (Replicate(), Replicate())
    torch.testing.assert_close(out.full_tensor(), d.full_tensor(), rtol=0, atol=0)


@pytest.mark.parametrize("t", [1, 4, 6, 64, 96])
@pytest.mark.parametrize("groups", [None, 1, 4, 16])
def test_n_groups_equals_reference(t, groups):
    pol = None if groups is None else {"moe_groups": groups}
    with PS.use_policy(pol), RPS.use_policy(pol):
        assert TM._n_groups(t) == RM._n_groups(t)


def _changed(out, no_drop):
    """Tokens whose output the capacity changed."""
    d = np.abs(np.asarray(out) - np.asarray(no_drop)).reshape(-1, out.shape[-1]).max(axis=1)
    return set(np.flatnonzero(d > 1e-3).tolist())


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "dbrx-132b"])
def test_moe_groups_equal_reference(arch):
    import dataclasses

    rc, tc, rp, tp = carried_moe(arch, seed=3)
    x = skewed_input(rp, 8, 32, seed=4, skew=6.0)     # 99 choices drop at G = 4, 96 at 1
    wide_r = dataclasses.replace(rc, capacity_factor=float(rc.n_experts))
    wide_t = dataclasses.replace(tc, capacity_factor=float(tc.n_experts))
    changed = {}
    for groups in (4, 1):
        pol = {"moe_groups": groups}
        with PS.use_policy(pol), RPS.use_policy(pol):
            assert TM._n_groups(256) == groups
            # jitted under the policy: G is read while tracing
            want = np.asarray(jax.jit(functools.partial(RM.moe_forward, rc))(rp, x))
            got = TM.moe_forward(tc, tp, torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            no_drop_r = np.asarray(jax.jit(functools.partial(RM.moe_forward, wide_r))(rp, x))
            no_drop_t = TM.moe_forward(wide_t, tp, torch.from_numpy(x)).numpy()
        changed[groups] = _changed(got, no_drop_t)
        assert changed[groups] == _changed(want, no_drop_r)   # the same drops
        assert changed[groups]                                # and some
    assert changed[4] != changed[1]                           # per-group capacity
