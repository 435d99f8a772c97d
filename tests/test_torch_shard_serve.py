"""The port's sharded serve step (``launch.steps.shard_serve_step``) on a
(2, 4) ("data", "model") mesh of 8 gloo ranks against the reference's
jitted serve step, for the attention caches: the reduced gemma2-2b (local
ring of 64 and global layers, softcaps; 4 kv heads, which divide over
"model") and recurrentgemma-2b (MQA: one kv head, which does not; RG-LRU
states split along their width), each at batch 8 (over "data") and 1.
The four cache rules of ``decode_state_specs`` are all here: kv heads over
"model" (gemma2, batch 8), the sequence over "model" (recurrentgemma,
batch 8), the sequence over "data" and the heads over "model" (gemma2,
batch 1), the sequence over ("data", "model") (recurrentgemma, batch 1).
And gemma2-2b's int8 cache at batch 1: its int8 keys and values split
as the cache is, their scales whole on every rank (``decode_state_specs``
shards them over the batch only).

``STEPS`` = 80 teacher-forced steps into a cache of 128 (the local ring
wraps): the gathered logits within 2e-5 of the reference's at every step,
the gathered state after the last step within 1e-5 of its largest entry,
leaf by leaf; every rank's state leaves have their spec's local shape and
no rank holds a whole cache; at batch 1 every data rank's logits are the
same bits.  ``tests/shard_serve_common.py`` runs the ranks.
"""
import pytest

import shard_serve_common as C

CASES = [(a, b) for a in ("gemma2-2b", "recurrentgemma-2b") for b in (8, 1)]
CASES.append(("gemma2-2b" + C.INT8, 1))


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return C.run_ranks(tmp_path_factory.mktemp("shard_serve"), serve=CASES)


@pytest.mark.parametrize("arch,batch", CASES)
def test_shard_serve_step_matches_reference(sharded, arch, batch):
    C.check_serve(sharded[("serve", arch, batch)], arch, batch)
