"""The port's sharding rules (``repro_torch.sharding``) against the
reference's (``repro.sharding``), leaf for leaf: parameter, optimizer,
input, decode-state and DLRM specs of every architecture at full size on
four meshes, and ``guard`` and the activation policy's choice of spec over a
grid of shapes and kinds.

The reference's rules read only a mesh's axis names and device-array shape,
so a stand-in mesh runs them on the CPU's one device; its structs come from
``jax.eval_shape``, the port's from fake tensors (nothing is allocated).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.configs.dlrm import DLRM_KAGGLE as REF_DLRM
from repro.launch import steps as RST
from repro.models import dlrm as ref_dlrm
from repro.models import transformer as RT
from repro.optim.optimizers import get_optimizer as ref_optimizer
from repro.sharding import ctx as RC
from repro.sharding import specs as RS
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.configs.dlrm import DLRM_KAGGLE
from repro_torch.launch import steps as ST
from repro_torch.models import dlrm as port_dlrm
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.sharding import ctx as C
from repro_torch.sharding import specs as S
from repro_torch.tree import leaves, tree_map_with_path

MESHES = {
    "1x1": (("data", "model"), (1, 1)),
    "2x4": (("data", "model"), (2, 4)),
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
}
OPTIMIZERS = ("adam", "sgd", "rowwise_adagrad")
DECODE = (("decode_32k", 128), ("long_500k", 1))


def ref_mesh(name):
    names, shape = MESHES[name]
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


def port_mesh(name):
    return S.MeshShape(*MESHES[name])


def norm(entries):
    """A spec's entries as jax normalizes them (a one-axis tuple is the
    axis)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p),
             norm(tuple(s))) for p, s in flat]


def port_flat(tree):
    out = []
    tree_map_with_path(lambda p, s: out.append((p, norm(tuple(s)))), tree)
    return out


def ref_shapes(tree):
    return [tuple(a.shape) for a in jax.tree_util.tree_leaves(tree)]


def port_shapes(tree):
    return [tuple(a.shape) for a in leaves(tree)]


def assert_same(ref_specs, port_specs, what):
    r, p = ref_flat(ref_specs), port_flat(port_specs)
    assert len(r) == len(p), what
    for (rp, rs), (pp, ps) in zip(r, p):
        assert rp == pp, (what, rp, pp)
        assert rs == ps, (what, rp, rs, ps)


@pytest.mark.parametrize("arch", list_archs())
def test_param_and_optimizer_specs_match_reference(arch):
    rcfg, cfg = ref_config(arch), get_config(arch)
    r_st = RST.param_structs(rcfg)
    p_st = ST.param_structs(cfg)
    assert ref_shapes(r_st) == port_shapes(p_st)
    opts = {name: (jax.eval_shape(ref_optimizer(name, 1e-3).init, r_st),
                   get_optimizer(name, 1e-3).init(p_st))
            for name in OPTIMIZERS}
    for m in MESHES:
        r_sp = RS.lm_param_specs(r_st, rcfg, ref_mesh(m))
        p_sp = S.lm_param_specs(p_st, cfg, port_mesh(m))
        assert_same(r_sp, p_sp, (arch, m))
        for name, (r_o, p_o) in opts.items():
            assert_same(RST._opt_specs(r_o, r_sp), ST._opt_specs(p_o, p_sp),
                        (arch, m, name))


@pytest.mark.parametrize("arch", list_archs())
def test_input_and_decode_state_specs_match_reference(arch):
    rcfg, cfg = ref_config(arch), get_config(arch)
    for shape in INPUT_SHAPES:
        r_b = RST.batch_struct(rcfg, shape)
        p_b = ST.batch_struct(cfg, shape)
        assert ref_shapes(r_b) == port_shapes(p_b)
        for m in MESHES:
            assert_same(RS.lm_input_specs(r_b, ref_mesh(m)),
                        S.lm_input_specs(p_b, port_mesh(m)), (arch, shape, m))
    if not cfg.supports_decode:
        return
    for shape, batch in DECODE:
        seq = REF_SHAPES[shape].seq_len
        r_s = jax.eval_shape(lambda: RT.init_decode_state(rcfg, batch, seq,
                                                          jnp.bfloat16))
        with ST._fake_mode():
            p_s = T.init_decode_state(cfg, batch, seq, torch.bfloat16, "cpu")
        assert ref_shapes(r_s) == port_shapes(p_s)
        for m in MESHES:
            assert_same(RS.decode_state_specs(r_s, rcfg, ref_mesh(m), batch),
                        S.decode_state_specs(p_s, cfg, port_mesh(m), batch),
                        (arch, shape, m))


def test_dlrm_specs_match_reference():
    r_p = jax.eval_shape(lambda k: ref_dlrm.init_dlrm(REF_DLRM, k),
                         jax.ShapeDtypeStruct((2,), jnp.uint32))
    with ST._fake_mode():
        p_p = port_dlrm.init_dlrm(DLRM_KAGGLE, torch.Generator(), "cpu")
    assert ref_shapes(r_p) == port_shapes(p_p)
    r_acc = jax.eval_shape(ref_optimizer("rowwise_adagrad", 0.1).init, r_p)
    p_acc = get_optimizer("rowwise_adagrad", 0.1).init(p_p)
    for m in MESHES:
        assert_same(RS.dlrm_param_specs(r_p, ref_mesh(m)),
                    S.dlrm_param_specs(p_p, port_mesh(m)), m)
        assert_same(RS.dlrm_param_specs(r_acc, ref_mesh(m)),
                    S.dlrm_param_specs(p_acc, port_mesh(m)), m)


SHAPES = [(8,), (16, 32), (256, 4096, 2304), (1, 1, 7), (3, 16, 16),
          (128, 16, 256), (60, 5, 64), (12, 10), (32, 512, 256000),
          (4, 2, 8, 8)]
KINDS = ("activation", "logits", "tokens_flat", "residual", "moe_dispatch",
         "moe_flat", "other")
GUARD_SPECS = [("data",), (("data", "model"),), (None, "model"),
               ("model", "data", None), ((("pod", "data")), None, "model")]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_guard_and_constrain_spec_match_reference(mesh, monkeypatch):
    rm, pm = ref_mesh(mesh), port_mesh(mesh)
    axes = set(MESHES[mesh][0])
    for shape in SHAPES:
        for entries in GUARD_SPECS:
            used = {a for e in entries if e for a in S.axes_of(e)}
            if not used <= axes:
                continue
            got = S.guard(pm, shape, S.P(*entries))
            want = RS.guard(rm, shape, PartitionSpec(*entries))
            assert norm(tuple(got)) == norm(tuple(want)), (shape, entries)

    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(spec) or x)
    for ep in (True, False):
        with RC.activation_sharding(rm, moe_expert_parallel=ep), \
                C.activation_sharding(pm, moe_expert_parallel=ep):
            for shape in SHAPES:
                for kind in KINDS:
                    seen.clear()
                    x = types.SimpleNamespace(shape=shape, ndim=len(shape))
                    RC.constrain(x, kind)
                    got = C.constrain_spec(shape, kind)
                    if not seen:
                        assert got is None, (shape, kind)
                    else:
                        assert norm(tuple(got)) == norm(tuple(seen[0])), \
                            (shape, kind, got, seen[0])
    assert C.current_policy() is None and RC.current_policy() is None
    assert C.constrain_spec((8, 16), "activation") is None


def test_policy_readers():
    """``mlstm_forward`` runs the whole sequence as one chunk under
    ``probe_full_blocks`` (as the reference's does); without a policy, or
    with one model rank, ``apply_moe_auto`` is ``apply_moe``."""
    from repro.models import xlstm as RX
    from repro_torch.models import moe as PM
    from repro_torch.models import xlstm as PX
    from repro_torch.tree import params_from_jax
    d, H, S_ = 64, 4, 512
    rp = RX.init_mlstm(jax.random.PRNGKey(0), d, H)
    x = np.random.default_rng(0).standard_normal((2, S_, d)).astype(
        np.float32)
    p, xt = params_from_jax(rp, "cpu"), torch.tensor(x)
    with C.activation_sharding(port_mesh("1x1"), probe_full_blocks=True):
        got = PX.mlstm_forward(p, xt, H)
    assert torch.equal(got, PX.mlstm_forward(p, xt, H, chunk=S_))
    assert not torch.equal(got, PX.mlstm_forward(p, xt, H))   # 2 chunks
    with RC.activation_sharding(ref_mesh("1x1"), probe_full_blocks=True):
        want = RX.mlstm_forward(rp, jnp.asarray(x), H)
    want = torch.tensor(np.asarray(want))
    assert float((got - want).abs().max()) <= 2e-5 * float(want.abs().max())

    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    layer = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    mp = {k: v[0] for k, v in layer["stages"][0]["moe"].items()}
    xm = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    want = PM.apply_moe(mp, xm, cfg.moe)
    for ctx in (None, port_mesh("1x1")):
        if ctx is None:
            got = PM.apply_moe_auto(mp, xm, cfg.moe)
        else:
            with C.activation_sharding(ctx):
                got = PM.apply_moe_auto(mp, xm, cfg.moe)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
