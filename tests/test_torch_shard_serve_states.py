"""The port's sharded serve step on 8 gloo ranks against the reference's
jitted serve step, for the states that are not caches and the MoE: the
reduced xlstm-1.3b (the mLSTM's C, n, m and the sLSTM's h, c, n, m, each
split over "model" along its width: gathered for the layer, the rank's
slice written back) and qwen3-moe-30b-a3b (4 experts over "model": the
expert-parallel layer at batch 8, the fallback at batch 1; decode is
lossless, so a rank's capacity and the reference's agree), each at batch
8 and 1, with the limits and checks of ``test_torch_shard_serve.py``.
"""
import pytest

import shard_serve_common as C

CASES = [(a, b) for a in ("xlstm-1.3b", "qwen3-moe-30b-a3b") for b in (8, 1)]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return C.run_ranks(tmp_path_factory.mktemp("shard_states"), serve=CASES)


@pytest.mark.parametrize("arch,batch", CASES)
def test_shard_serve_step_matches_reference(sharded, arch, batch):
    C.check_serve(sharded[("serve", arch, batch)], arch, batch)
