"""The port's ``row_hash`` and its copy of the wire spec, on the CPU.

``row_hash``: through ``repro_torch.kernels.ops.row_hash`` on CPU tensors
(the plain version), bit for bit against both numpy hashes of the JAX
package — ``repro.kernels.ref.row_hash`` and
``repro.core.sharded_checkpoint.row_hash``.  The reference's Pallas
``row_hash`` is not an oracle here: it imports ``enable_x64`` from
``jax.experimental``, which this jax no longer has.  The kernel itself is
held against the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

The spec: every frame kind, direction, arity, field and state of the
port's copy equals the reference's, and ``violation`` answers alike on
good and bad frames.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.analysis.protocol import spec as rspec
from repro.core.sharded_checkpoint import row_hash as ref_ledger_hash
from repro.kernels.ref import row_hash as ref_oracle_hash
from repro_torch.analysis.protocol import spec as tspec
from repro_torch.kernels import LAUNCHES, ops

# the reference's shape sweep (tests/test_kernels.py) plus a ragged f32
# width (36-byte rows) and a wide bf16-friendly one
SHAPES = [(1, 1), (7, 3), (257, 5), (1000, 16), (5, 0), (9, 9)]


def _rows(n, d, dtype, seed=0):
    """(values tensor, acc tensor, values as numpy bytes, acc numpy)."""
    rng = np.random.default_rng(seed + n * 31 + d)
    v = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    a = torch.from_numpy(rng.random(n).astype(np.float32))
    if dtype == "bf16":
        v = v.to(torch.bfloat16)
        v_np = v.view(torch.int16).numpy()       # the same bytes
    else:
        v_np = v.numpy()
    return v, a, v_np, a.numpy()


def _bits(h: torch.Tensor) -> np.ndarray:
    assert h.dtype == torch.int64
    return h.numpy().view(np.uint64)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,d", SHAPES)
def test_plain_row_hash_is_bit_exact_with_both_numpy_hashes(n, d, dtype):
    v, a, v_np, a_np = _rows(n, d, dtype)
    before = LAUNCHES["row_hash"]
    got = _bits(ops.row_hash(v, a))
    assert LAUNCHES["row_hash"] == before      # CPU tensors: no launch
    want = ref_oracle_hash(v_np, a_np)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref_ledger_hash(v_np, a_np))


@pytest.mark.parametrize("case", ["no rows", "zero-byte rows",
                                  "zero-byte values", "1-D values",
                                  "unaligned view"])
def test_row_hash_edge_cases(case):
    if case == "no rows":
        v, a = torch.zeros((0, 16)), torch.zeros(0)
    elif case == "zero-byte rows":
        v, a = torch.zeros((4, 0)), torch.zeros((4, 0))
    elif case == "zero-byte values":
        v, a = torch.zeros((6, 0)), torch.arange(6, dtype=torch.float32)
    elif case == "1-D values":
        v, a = torch.arange(5, dtype=torch.int64), torch.ones(5)
    else:   # rows starting 4 bytes past an 8-byte boundary
        v = torch.arange(4 * 33, dtype=torch.float32)[1:4 * 32 + 1].view(32, 4)
        a = torch.arange(32, dtype=torch.float32)
    got = _bits(ops.row_hash(v, a))
    want = ref_oracle_hash(v.numpy(), a.numpy())
    assert got.shape == want.shape == (v.shape[0],)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref_ledger_hash(v.numpy(), a.numpy()))
    if case == "zero-byte rows":           # the offset basis, as the ref
        assert (got == np.uint64(14695981039346656037)).all()


def test_row_hash_int64_holds_the_offset_basis_bits():
    from repro_torch.kernels import ref
    assert np.int64(ref.FNV_OFFSET).view(np.uint64) == \
        np.uint64(14695981039346656037)
    assert ref.FNV_OFFSET == -3750763034362895579


# --------------------------------------------------------------- spec ----

def _as_dict(f):
    return dataclasses.asdict(f)


def test_spec_copy_declares_the_reference_frames():
    assert tspec.MAX_FRAME_BYTES == rspec.MAX_FRAME_BYTES
    assert tspec.STATES == rspec.STATES
    assert (tspec.C2W, tspec.W2C, tspec.BOTH) == \
        (rspec.C2W, rspec.W2C, rspec.BOTH)
    assert set(tspec.KINDS) == set(rspec.KINDS)
    assert tspec.FRAMES.keys() == rspec.FRAMES.keys()
    for key, f in rspec.FRAMES.items():
        g = tspec.FRAMES[key]
        assert (g.min_arity, g.max_arity) == (f.min_arity, f.max_arity), key
        assert _as_dict(g) == _as_dict(f), key
    assert tspec.render_wire_table() == rspec.render_wire_table()


GOOD = [("drain", 3, "tok"), ("ping", 0, None), ("close", 5),
        ("mx", 0, ("ping", 1, "t")),
        ("parity", 1, 2, 3, "full", 0, None, None),
        ("parity", 1, 2, 3, "delta", 0, 4, [0], None, None),
        ("rows", 1, 2, 3, 0, None, None, None),
        ("hello", 0, {"codec_level": 1})]
BAD = [["drain", 3, "tok"], (), (7, 1), ("nope", 1), ("drain",),
       ("drain", "3", "tok"), ("drain", True, "tok"),
       ("close", 1, 2, 3, 4), ("parity", 1, 2, 3, "sideways", 0),
       ("ack", 7, {}), ("hello", 0, {}, "extra")]


@pytest.mark.parametrize("direction", ["c2w", "w2c"])
def test_spec_copy_violation_answers_as_the_reference(direction):
    for msg in GOOD + BAD:
        for state in (None, "start", "serving"):
            assert tspec.violation(msg, direction, state) == \
                rspec.violation(msg, direction, state), (msg, state)
    assert all(rspec.violation(m) is None for m in GOOD)
    assert all(rspec.violation(m) is not None for m in BAD)
