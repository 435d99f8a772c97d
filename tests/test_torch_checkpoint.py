"""Disk interop of the flat checkpoint store, both directions.

A run directory written by the reference ``CheckpointStore`` (full,
partial and trainer events; two runs chained through ``CURRENT``) loads
in the port, and one written by the port (from torch tensors) loads in
the reference: images and the trainer tree bit for bit.  This pins the
jax-compatible leaf order of the port's tree helpers.
"""
import numpy as np
import pytest
import torch

from repro.core import checkpoint as rck
from repro_torch import tree
from repro_torch.core import checkpoint as tck

SIZES = (40, 17, 5)
D = 8


def _state(seed):
    rng = np.random.default_rng(seed)
    tables = [rng.normal(size=(n, D)).astype(np.float32) for n in SIZES]
    accs = [rng.uniform(size=n).astype(np.float32) for n in SIZES]
    trainer = {"top": [{"w": rng.normal(size=(6, 1)).astype(np.float32),
                        "b": rng.normal(size=(1,)).astype(np.float32)}],
               "bottom": [{"w": rng.normal(size=(3, 4)).astype(np.float32),
                           "b": rng.normal(size=(4,)).astype(np.float32)},
                          {"w": rng.normal(size=(4, D)).astype(np.float32),
                           "b": rng.normal(size=(D,)).astype(np.float32)}]}
    return tables, accs, trainer


def _as_torch(x):
    return tree.tree_map(torch.tensor, x)


def _write(mod, directory, convert):
    """Two chained runs: run-1 full + partial, run-2 partial + trainer."""
    spec = mod.EmbShardSpec(SIZES, 4)
    t0, a0, tr0 = _state(0)
    run1 = mod.CheckpointStore(convert(t0), convert(a0), spec, convert(tr0),
                               directory=directory)
    t1, a1, tr1 = _state(1)
    run1.save_full(convert(t1), convert(a1), convert(tr1), step=3)
    rows = np.array([0, 7, 39])
    run1.save_rows(0, rows, t1[0][rows] + 1, a1[0][rows] + 1, step=4)
    run2 = mod.CheckpointStore(convert(t0), convert(a0), spec, convert(tr0),
                               directory=directory)
    t2, a2, tr2 = _state(2)
    rows = np.array([1, 16])
    run2.save_rows(1, rows, t2[1][rows], a2[1][rows], step=6)
    run2.save_trainer(convert(tr2), step=6)
    return spec, t0, a0, tr0


def _load_both(directory, t0, a0, tr0, spec_r, spec_t):
    ref = rck.CheckpointStore.load_latest(directory, t0, a0, spec_r,
                                          trainer_state=tr0)
    port = tck.CheckpointStore.load_latest(directory, _as_torch(t0),
                                           _as_torch(a0), spec_t,
                                           trainer_state=_as_torch(tr0))
    return ref, port


def _assert_same(ref, port):
    for a, b in zip(ref.image_tables + ref.image_accs,
                    port.image_tables + port.image_accs):
        assert a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()
    r_leaves = tree.leaves(ref.trainer_image)
    p_leaves = tree.leaves(port.trainer_image)
    assert len(r_leaves) == len(p_leaves) == 6
    for a, b in zip(r_leaves, p_leaves):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_run_directory_loads_bit_for_bit_across_packages(tmp_path, writer):
    d = str(tmp_path / "ckpt")
    if writer == "reference":
        spec, t0, a0, tr0 = _write(rck, d, lambda x: x)
    else:
        spec, t0, a0, tr0 = _write(tck, d, _as_torch)
    ref, port = _load_both(d, t0, a0, tr0, rck.EmbShardSpec(SIZES, 4),
                           tck.EmbShardSpec(SIZES, 4))
    _assert_same(ref, port)
    # the chain really replayed: run-2's partial over run-1's full
    t1 = _state(1)[0]
    t2 = _state(2)[0]
    np.testing.assert_array_equal(port.image_tables[1][[1, 16]],
                                  t2[1][[1, 16]])
    np.testing.assert_array_equal(port.image_tables[2], t1[2])
    assert tree.leaves(port.trainer_image)[0].tobytes() == \
        tree.leaves(_state(2)[2])[0].tobytes()


def test_tree_leaf_order_is_jax_order():
    import jax
    t = _state(0)[2]
    assert [a.tobytes() for a in tree.leaves(t)] == \
        [a.tobytes() for a in jax.tree.leaves(t)]
    back = tree.unflatten(t, tree.leaves(t))
    assert list(back) == list(t) and len(back["bottom"]) == 2


def test_snapshots_never_alias_cpu_tensors():
    t = torch.zeros(4, 2)
    snap = tck.host_copy(t)
    t += 1
    assert snap.sum() == 0
    spec = tck.EmbShardSpec((4,), 2)
    store = tck.CheckpointStore([t], [torch.zeros(4)], spec)
    t += 1
    assert store.image_tables[0].sum() == 8     # the image kept its copy


def test_restore_shards_writes_in_place():
    spec = tck.EmbShardSpec((10,), 2)
    t = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    a = torch.zeros(10)
    store = tck.CheckpointStore([t], [a], spec)
    t += 100
    a += 5
    out_t, out_a = store.restore_shards([t], [a], [1])
    assert out_t[0] is t
    assert torch.equal(t[5:], torch.arange(10, 20, dtype=torch.float32)
                       .reshape(5, 2))
    assert float(t[0, 0]) == 100 and float(a[0]) == 5 and float(a[9]) == 0
