"""The batch-1 long-context decode on a (2, 2) ("data", "model") mesh of
four gloo CPU ranks, against the same steps unsharded; and the split
decode attention's two functions against the whole-cache one.

One spawned job (``torch_spawn``, deadline 240 s) decodes each of four
smokes (gemma3-1b: local layers with one K/V head, their ring of 8 slots;
gemma3-12b: two K/V heads split over "model"; mamba2-370m: SSD only;
jamba-1.5-large: SSD, attention and MoE) at batch 1 for six steps at the
last positions of a 64-position cache filled from a seed, every tensor
placed by the launcher's rules: the cache's sequence over ("data",
"model") jointly, the residual stream's features over "data".  Rank 0
runs the same steps without a mesh.

* Logits within 1e-5 of the largest absolute value (float32 sums
  reordered across ranks), after every step.
* The cache after every step: every slot no step has written so far
  exactly the unsharded one (nothing else was written), the written slots
  and the SSD state and conv tail within 1e-5 of the largest value (their
  projections are sums over the ranks' features, reordered);
  the cache stays split over its sequence (no gathered copy).
* On one process: ``partial_decode_attn`` over 1, 2 and 16 runs merged by
  ``merge_partials`` equals ``attn_decode`` (1e-5 in float32), a run that
  is wholly masked gives l = 0, m = -1e30 and o = 0, and merges to
  nothing.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import common as C
from repro_torch.models import lm
from torch_mesh_jobs import LONG_S, LONG_STEPS
from torch_spawn import run_jobs

ARCHS = ["gemma3-1b", "gemma3-12b", "mamba2-370m", "jamba-1.5-large-398b"]
REL = 1e-5


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_long")
    return run_jobs([("long", 4, root, {"archs": ARCHS})], deadline=240)[0][0]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max() + 1e-30,
                               err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch1_decode_logits_on_2x2_equal_plain(job, arch):
    got, want = job[arch]["sharded"], job[arch]["plain"]
    assert len(got) == len(want) == LONG_STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g["logits"], w["logits"], f"step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_batch1_decode_cache_on_2x2_equals_plain(job, arch):
    cfg = get_smoke_config(arch)
    specs = cfg.layer_specs()
    for i, (g, w) in enumerate(zip(job[arch]["sharded"], job[arch]["plain"])):
        pos = LONG_S - LONG_STEPS + i
        assert g["cache"].keys() == w["cache"].keys()
        for key, want in w["cache"].items():
            got = g["cache"][key]
            layer, name = key.split("/")
            if name in ("k", "v"):
                kind = lm._KIND[specs[int(layer)].mixer]
                written = np.zeros(want.shape[1], bool)
                written[[C._slot(cfg, kind, q, want.shape[1])
                         for q in range(LONG_S - LONG_STEPS, pos + 1)]] = True
                np.testing.assert_array_equal(got[:, ~written], want[:, ~written], err_msg=key)
                _close(got[:, written], want[:, written], f"step {i} {key}")
            else:
                _close(got, want, f"step {i} {key}")
        if arch != "mamba2-370m":       # every K/V cache split over its sequence
            assert g["placements"] and all(p == "(Shard(dim=1), Shard(dim=1))"
                                           for p in g["placements"]), g["placements"]


def _attn_case(kind, s_max, pos, seed=0):
    cfg = get_smoke_config("gemma3-12b")
    gen = torch.Generator().manual_seed(seed)
    p = C.init_attn(cfg, gen, "cpu")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32))
    shape = (2, s_max, cfg.n_kv_heads, cfg.hd)
    cache = {n: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
             for n in ("k", "v")}
    return cfg, p, x, cache


@pytest.mark.parametrize("chunks", [1, 2, 16])
@pytest.mark.parametrize("kind,s_max,pos", [("causal", 64, 63), ("causal", 64, 5),
                                            ("local", 64, 40), ("local", 8, 29)])
def test_merged_partials_equal_attn_decode(chunks, kind, s_max, pos):
    cfg, p, x, cache = _attn_case(kind, s_max, pos)
    whole = {n: t.clone() for n, t in cache.items()}
    want, _ = C.attn_decode(cfg, p, x, whole, pos, kind)
    got, _ = C.attn_decode_chunked(cfg, p, x, cache, pos, kind, n_chunks=chunks)
    for n in ("k", "v"):
        torch.testing.assert_close(cache[n], whole[n], rtol=0, atol=0)
    _close(got.numpy(), want.numpy(), f"{kind} {s_max} {pos} {chunks}")


def test_a_wholly_masked_run_merges_to_nothing():
    cfg, p, x, cache = _attn_case("causal", 64, 5)
    q = torch.randn(2, 1, cfg.n_heads, cfg.hd, generator=torch.Generator().manual_seed(1))
    none = torch.zeros(32, dtype=torch.bool)
    m, l, o = C.partial_decode_attn(q, cache["k"][:, 32:], cache["v"][:, 32:], none)
    assert torch.all(m == C.NEG_INF) and torch.all(l == 0) and torch.all(o == 0)
    mask = torch.arange(32) <= 5
    parts = [C.partial_decode_attn(q, cache["k"][:, :32], cache["v"][:, :32], mask),
             (m, l, o)]
    got = C.merge_partials(*(torch.stack(t) for t in zip(*parts)))
    mine = C.partial_decode_attn(q, cache["k"][:, :32], cache["v"][:, :32], mask)
    want = mine[2] / mine[1][..., None]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
