"""The port's sharded prefill step and the attention merge.

* ``launch.steps.shard_prefill_step`` on a (2, 4) ("data", "model") mesh
  of 8 gloo ranks (``tests/shard_serve_common.py``) for the reduced
  gemma2-2b and qwen3-moe-30b-a3b (expert-parallel) at (8, 32) tokens:
  each rank's logits are its (B / dp, S, V / model) slice, and the
  gathered logits are within 2e-5 of the reference's jitted prefill;
* ``sharding.collectives.merge_pieces``'s arithmetic without collectives:
  ``models.layers.partial_attention`` over R in {1, 2, 8, 256} pieces of
  a cache (GQA, softcap, unequal pieces, pieces with no key and pieces
  whose keys are all masked) merged, against the port's whole-cache
  ``_sdpa`` within 1e-6 of its largest entry (f32 sums in another order)
  and the reference's within 2e-6 (the two packages' whole-cache f32
  attentions differ by up to 8e-7 here); a piece with no valid key has
  lse -inf and adds nothing, and rows with no valid key in any piece come
  out 0, not NaN.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.models import layers as L
from repro_torch.sharding import collectives as coll

import shard_serve_common as C

ARCHS = ("gemma2-2b", "qwen3-moe-30b-a3b")


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return C.run_ranks(tmp_path_factory.mktemp("shard_prefill"),
                       prefill=ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_prefill_step_matches_reference(sharded, arch):
    shape, logits = sharded[("prefill", arch)]
    B, S = C.PREFILL
    V = C.port_cfg(arch).vocab_size
    (dp, tp) = C.MESH[1]
    assert shape == (B // dp, S, V // tp)
    want = C.ref_prefill(arch)
    assert logits.shape == want.shape
    assert C.rel(logits, want) <= 2e-5


def _cuts(T, R, rng):
    """R piece boundaries over T keys: unequal pieces, some empty."""
    inner = np.sort(rng.integers(0, T + 1, R - 1))
    return [0, *inner.tolist(), T]


@pytest.mark.parametrize("R", [1, 2, 8, 256])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_merge_pieces_equals_whole_cache_attention(R, softcap):
    rng = np.random.default_rng(R)
    B, S, Hq, Hkv, hd, T = 2, 3, 8, 2, 16, 1024
    q = rng.standard_normal((B, S, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    mask = rng.random((B, S, T)) < 0.3
    cuts = _cuts(T, R, rng)
    if R > 1:             # a piece whose keys are all masked
        lo, hi = cuts[R // 2], cuts[R // 2 + 1]
        mask[:, :, lo:hi] = False
    mask[1, 2] = False                     # a row with no key anywhere
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    outs, lses = [], []
    for lo, hi in zip(cuts, cuts[1:]):
        o, lse = L.partial_attention(tq, tk[:, lo:hi], tv[:, lo:hi],
                                     tm[:, :, lo:hi], softcap)
        empty = ~tm[:, :, lo:hi].any(-1)                       # (B, S)
        assert torch.isneginf(lse[empty]).all()
        outs.append(o)
        lses.append(lse)
    got = coll.merge_pieces(torch.stack(outs), torch.stack(lses))
    assert torch.isfinite(got).all()
    assert torch.equal(got[1, 2], torch.zeros_like(got[1, 2]))
    want = torch.from_numpy(np.array(RL._sdpa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        softcap)))
    whole = L._sdpa(tq, tk, tv, tm, softcap)
    keep = tm.any(-1)                                          # (B, S)
    assert C.rel(got[keep], whole[keep]) <= 1e-6
    assert C.rel(got[keep], want[keep]) <= 2e-6
