"""The port's sharded train step on gloo meshes of CPU ranks.

One module fixture spawns three gloo jobs at once (``torch_spawn``; 1, 2
and 4 ranks on ("data", "model") meshes (1, 1), (2, 1) and (4, 1), the
model axis kept at 1 as ``tests/test_integration_sharded.py`` keeps it;
one deadline of 240 s).  In each, every rank places the float32 state
of the olmo-1b, qwen3-moe and jamba smokes by ``state_pspecs`` and a batch
of 8 x 16 tokens by ``batch_pspecs`` (8 rows: each of the two microbatches
splits over 4 data ranks) and takes two steps under the policy
``{"dp": ("data",), "tp": "model", "moe_groups": <data ranks>}``; rank 0
also takes them without a mesh under the same policy (the MoE grouped
alike).

* Twin of ``test_sharded_train_step_runs``: two steps, finite, ``step``
  1 then 2, every leaf kept on its placements.
* Against the unsharded step: the loss and grad norm of both steps within
  rtol 1e-5; after the first step the float32 first moment (the clipped
  gradient) within 1e-4 of each leaf's largest value (``test_torch_trainer``'s
  gradient tolerance: jamba's SSD gradients reorder their float32 sums by
  up to 1.6e-5 of the leaf) and the parameters within 1e-5 of it plus
  1e-4 x lr (Adam's step is about lr times g / |g|, so a gradient held to
  1e-4 moves a parameter by up to 1e-4 x lr), except parameters whose
  gradient is under 1e-3 of their leaf's largest or under 1000 x Adam's
  eps (1e-5), held to 2.2 x lr (Adam's first step divides a gradient by its own
  magnitude, so float noise in a tiny gradient moves it by up to 2 x lr);
  after the second step every parameter within 2.2 x lr (the second
  step's ratio of moments amplifies the sharded sums' reordering where
  two gradients nearly cancel).
* Twin of ``tests/test_trainer.py::test_elastic_restore_new_sharding``:
  the olmo state a 2-step ``run_training`` on (world, 1) checkpointed,
  restored onto (1, world) with ``shardings=``, bit for bit, on the new
  placements.
* A resume through ``run_training(state_shardings=)``: two steps against
  a run crashed at step 1 and resumed, losses and state bit for bit, the
  state back on its placements.
"""
import numpy as np
import pytest

from torch_spawn import run_jobs

WORLDS = [1, 2, 4]
ARCHS = ["olmo-1b", "qwen3-moe-235b-a22b", "jamba-1.5-large-398b"]
LR = 1e-3
REL = 1e-5
GRAD_REL = 1e-4     # test_torch_trainer's gradient tolerance


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    specs = []
    for w in WORLDS:
        root = tmp_path_factory.mktemp(f"train{w}")
        specs.append(("train", w, root, {"archs": ARCHS, "root": str(root)}))
    return dict(zip(WORLDS, run_jobs(specs, deadline=240)))


def _params_close(got, want, mu, lr_tol_only=False):
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        # mu = 0.1 g after one step: |g| over 1e-3 of the leaf's largest
        # and over 1000 x Adam's eps, where g / (|g| + eps) is scale-free
        big = (np.abs(mu[name]) > 1e-3 * np.abs(mu[name]).max()) & (np.abs(mu[name]) > 1e-6)
        if not lr_tol_only:
            np.testing.assert_allclose(g[big], w[big], rtol=0,
                                       atol=REL * np.abs(w).max() + GRAD_REL * LR, err_msg=name)
        np.testing.assert_allclose(g, w, rtol=0, atol=2.2 * LR, err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_runs(jobs, arch, world):
    res = jobs[world][0][arch]
    s1, s2 = res["sharded"]
    assert np.isfinite(s1["loss"]) and np.isfinite(s2["loss"])
    assert (s1["step"], s2["step"]) == (1, 2)
    placed, after1, after2 = res["placements"]
    assert placed == after1 == after2 == res["specs"]     # the layout survives the steps
    if world > 1:       # something is really sharded over "data"
        assert any(p[0].startswith("S(") for p in placed.values())
    u1, u2 = res["unsharded"]
    for got, want in ((s1, u1), (s2, u2)):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=REL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=REL)
    for name, w in u1["mu"].items():
        np.testing.assert_allclose(s1["mu"][name], w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max() + 1e-30, err_msg=name)
    _params_close(s1["params"], u1["params"], u1["mu"])
    _params_close(s2["params"], u2["params"], u2["mu"], lr_tol_only=True)


@pytest.mark.parametrize("world", WORLDS)
def test_elastic_restore_new_sharding(jobs, world):
    for res in (r["elastic"] for r in jobs[world]):      # every rank
        assert res["restored_mesh"] == ["data", "model"]
        assert res["restored_placements"] == res["want_placements"]
        assert res["saved"].keys() == res["restored"].keys()
        for k, v in res["saved"].items():
            assert res["restored"][k].dtype == v.dtype
            np.testing.assert_array_equal(res["restored"][k], v, err_msg=k)
    if world > 1:       # the new layout really differs: model-sharded now
        want = jobs[world][0]["elastic"]["want_placements"]
        assert any(p[1].startswith("S(") for p in want.values())


@pytest.mark.parametrize("world", WORLDS)
def test_resume_through_state_shardings(jobs, world):
    for res in (r["elastic"] for r in jobs[world]):
        assert res["resumed_from"] == 1
        assert len(res["losses_a"]) == 2 and res["losses_b"] == res["losses_a"][1:]
        for k, v in res["final_a"].items():
            np.testing.assert_array_equal(res["final_b"][k], v, err_msg=k)
        assert res["final_b_placements"] == res["placed_placements"]
