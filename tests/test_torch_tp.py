"""The tensor-parallel regions (``repro_torch.models.tp``) on a (2, 2)
("data", "model") mesh of four gloo CPU ranks, against the same calls
without a mesh.

One spawned job (``torch_spawn``, deadline 240 s) runs, for smokes that
reach every region (dense attention with a tied head, one K/V head split
over two ranks, MoE expert parallelism, the SSD's gathered projection and
split gated norm, the encoder-decoder's cross-attention, an untied head),
a float32 train step under the launcher's policy (``moe_groups`` 2, two
microbatches of four rows), a float32 prefill of four rows and a decode
step of eight over a cache placed by ``cache_pspecs``; rank 0 runs the
same calls unsharded under the same policy.

* The train step: loss and grad norm within rtol 1e-5, the first moment
  (the clipped gradient) within 1e-4 of each leaf's largest value
  (``test_torch_mesh_train``'s tolerances).
* Prefill and decode: logits and every cache tensor within 1e-5 of the
  largest absolute value (float32 sums reordered across ranks).
"""
import numpy as np
import pytest

from torch_spawn import run_jobs

ARCHS = ["olmo-1b", "gemma3-1b", "qwen3-moe-235b-a22b", "mamba2-370m", "whisper-small",
         "llama3-405b"]
REL = 1e-5
GRAD_REL = 1e-4


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    return run_jobs([("tp", 4, root, {"archs": ARCHS})], deadline=240)[0][0]


def _close(got, want, rel, what):
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=rel * np.abs(w).max() + 1e-30,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_2x2_equals_plain(job, arch):
    got, want = job[arch]["sharded"], job[arch]["plain"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=REL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=REL)
    _close(got["mu"], want["mu"], GRAD_REL, "mu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("what", ["prefill", "prefill_cache", "decode", "decode_cache"])
def test_serving_on_2x2_equals_plain(job, arch, what):
    _close(job[arch]["serve"][what], job[arch]["plain_serve"][what], REL, what)
