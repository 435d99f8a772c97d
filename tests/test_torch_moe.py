"""The port's MoE layer (``repro_torch.models.moe.apply_moe``) on the CPU
against the reference's ``repro.models.moe.apply_moe``.

Parameters come from the reference's ``init_moe`` through
``params_from_jax``, inputs from numpy with a seed; everything is f32.
Configs: the reduced qwen2-moe (4 experts, top 2, one shared expert behind
its sigmoid gate) and qwen3-moe (no shared expert).  Tolerances: the
output within 1e-5 of its largest entry and the aux loss within 1e-6
relative (f32 router products and means summed in another order);
gradients within 1e-4 of each leaf's largest entry.  Where the capacity
drops assignments, the kept (token, expert) pairs must be the same set.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import moe as RM
from repro_torch.configs import get_config
from repro_torch.models import moe as M
from repro_torch.tree import leaves, params_from_jax, unflatten

ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"]


def _setup(arch, seed=0, **changes):
    """(reference moe config, port moe config, reference params, port
    params, d) of the reduced ``arch``."""
    ref_moe = dataclasses.replace(ref_config(arch).reduced().moe, **changes)
    port_moe = dataclasses.replace(get_config(arch).reduced().moe, **changes)
    d = ref_config(arch).reduced().d_model
    tree = RM.init_moe(jax.random.PRNGKey(seed), d, ref_moe)
    tree = jax.tree.map(np.asarray, tree)
    return ref_moe, port_moe, tree, params_from_jax(tree, "cpu"), d


def _x(shape, seed, offset=0.0):
    return (np.random.default_rng(seed).normal(size=shape) + offset
            ).astype(np.float32)


def _close_to_largest(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, tol)


def _kept_pairs_reference(tree, x, m, C):
    """The (token, expert) pairs the reference's ``apply_moe`` keeps at
    capacity C (its own routing and dispatch steps, in jnp), and how many
    it drops."""
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    probs = jax.nn.softmax((xt @ tree["router"]).astype(jnp.float32), -1)
    _, top_e = jax.lax.top_k(probs, m.top_k)
    flat_e = top_e.reshape(-1)
    flat_tok = jnp.repeat(jnp.arange(xt.shape[0]), m.top_k)
    order = jnp.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_tok[order]
    rank = jnp.arange(se.size) - jnp.searchsorted(
        se, jnp.arange(m.num_experts))[se]
    keep = np.asarray(rank < C)
    pairs = set(zip(np.asarray(st)[keep].tolist(),
                    np.asarray(se)[keep].tolist()))
    return pairs, int((~keep).sum())


def _kept_pairs_port(params, x, m, C):
    xt = torch.tensor(x.reshape(-1, x.shape[-1]))
    _, _, top_e = M.route(params, xt, m)
    order, slot = M.dispatch(top_e, C, m.num_experts)
    keep = slot < m.num_experts * C
    return set(zip((order // m.top_k)[keep].tolist(),
                   top_e.reshape(-1)[order][keep].tolist()))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(2, 64), (4, 1)], ids=["prefill",
                                                          "decode"])
def test_apply_moe_matches_the_reference(arch, shape):
    """Output and aux loss at S = 64 (capacity 4.0, reduced(): nothing
    dropped) and at decode (S = 1: capacity T, lossless)."""
    ref_moe, port_moe, tree, params, d = _setup(arch)
    x = _x(shape + (d,), seed=1)
    want, want_aux = RM.apply_moe(tree, jnp.asarray(x), ref_moe)
    got, aux = M.apply_moe(params, torch.tensor(x), port_moe)
    assert got.shape == x.shape and aux.dtype == torch.float32
    _close_to_largest(got, want, 1e-5)
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_the_reference_s_assignments(arch):
    """capacity_factor 1.25 at T = 256 tokens, inputs with a common offset
    (the router then prefers some experts): the reference drops
    assignments, and the port keeps the same (token, expert) pairs and
    gives the same output."""
    ref_moe, port_moe, tree, params, d = _setup(arch, capacity_factor=1.25)
    x = _x((2, 128, d), seed=2, offset=0.5)
    C = M.expert_capacity(port_moe, 256, 128)
    assert C == int(1.25 * 256 * ref_moe.top_k / ref_moe.num_experts)
    want_pairs, dropped = _kept_pairs_reference(tree, x, ref_moe, C)
    assert dropped > 0
    assert _kept_pairs_port(params, x, port_moe, C) == want_pairs
    assert len(want_pairs) == 256 * ref_moe.top_k - dropped
    want, want_aux = RM.apply_moe(tree, jnp.asarray(x), ref_moe)
    got, aux = M.apply_moe(params, torch.tensor(x), port_moe)
    _close_to_largest(got, want, 1e-5)
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [4.0, 1.25])
def test_apply_moe_gradients_match_jax(arch, capacity_factor):
    """d(sum(out * g) + aux) by every parameter and by x, through autograd
    against ``jax.grad``, with and without drops."""
    ref_moe, port_moe, tree, params, d = _setup(
        arch, capacity_factor=capacity_factor)
    x = _x((2, 128, d), seed=3, offset=0.5)
    g = _x((2, 128, d), seed=4)

    def f(p, x):
        out, aux = RM.apply_moe(p, x, ref_moe)
        return jnp.sum(out * g) + aux

    want_p, want_x = jax.grad(f, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    live = [t.requires_grad_(True) for t in leaves(params)]
    xt = torch.tensor(x, requires_grad=True)
    out, aux = M.apply_moe(unflatten(params, live), xt, port_moe)
    (torch.sum(out * torch.tensor(g)) + aux).backward()
    want_leaves = jax.tree.leaves(want_p)
    assert len(want_leaves) == len(live)
    for t, w in zip(live, want_leaves):
        assert t.grad is not None and t.grad.shape == w.shape
        _close_to_largest(t.grad, w, 1e-4)
    _close_to_largest(xt.grad, want_x, 1e-4)


def test_routing_ties_go_to_the_lower_expert():
    """Equal router probabilities: the top-k are the lowest expert ids, in
    ``jax.lax.top_k``'s order."""
    m = get_config("qwen3-moe-30b-a3b").reduced().moe
    p = {"router": torch.zeros((8, m.num_experts))}
    probs, w, e = M.route(p, torch.randn(5, 8), m)
    assert e.tolist() == [list(range(m.top_k))] * 5
    assert torch.equal(w, torch.full((5, m.top_k), 1.0 / m.top_k))
    _, want = jax.lax.top_k(jnp.asarray(probs.numpy()), m.top_k)
    assert np.asarray(want).tolist() == e.tolist()


def test_capacity_is_the_reference_s():
    m = get_config("qwen2-moe-a2.7b").moe
    assert M.expert_capacity(m, 8192, 4096) == 682       # the prefill
    assert M.expert_capacity(m, 4, 1) == 4               # decode: T
    assert M.expert_capacity(m, 2, 2) == 1               # "or 1"


def _example():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_moe_expert_cpr.py"
    spec = importlib.util.spec_from_file_location("torch_moe_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_moe_expert_example_step_matches_the_reference():
    """``examples/torch_moe_expert_cpr.py``'s first step against the
    reference example's step (Adam on ``lm_loss``, then the updated first
    MoE layer's router hits into the MFU counts) on the same parameters and
    batch: the hit counts equal, the loss within 1e-5 relative."""
    from repro.core import trackers as RK
    from repro.data.synthetic import TokenDataset
    from repro.models import transformer as RT
    from repro.optim.optimizers import apply_updates, get_optimizer
    from repro_torch.optim.optimizers import get_optimizer as port_optimizer
    ex = _example()
    cfg_ref = ref_config("qwen3-moe-30b-a3b").reduced()
    assert dataclasses.asdict(ex.CFG) == dataclasses.asdict(cfg_ref)
    E = cfg_ref.moe.num_experts
    tree = RT.init_model(cfg_ref, jax.random.PRNGKey(0))
    batch = next(TokenDataset(cfg_ref.vocab_size, num_tokens=200_000,
                              seed=0).batches(ex.BATCH, ex.SEQ))
    opt = get_optimizer("adam", 1e-3)
    (want_loss, _), grads = jax.value_and_grad(
        lambda p: RT.lm_loss(p, batch, cfg_ref), has_aux=True)(tree)
    u, _ = opt.update(grads, opt.init(tree), tree)
    new = apply_updates(tree, u)
    x, _ = RT.embed_inputs(new, batch, cfg_ref)
    router = new["stages"][0]["moe"]["router"][0]
    logits = (x.reshape(-1, cfg_ref.d_model) @ router).astype(jnp.float32)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, -1), cfg_ref.moe.top_k)
    want_counts = RK.mfu_update(RK.mfu_init(E), top_e)

    params = params_from_jax(jax.tree.map(np.asarray, tree), "cpu")
    popt = port_optimizer("adam", 1e-3)
    _, _, counts, loss = ex.step(params, popt.init(params),
                                 torch.zeros(E, dtype=torch.int32),
                                 torch.from_numpy(batch["tokens"]), popt)
    assert counts.tolist() == np.asarray(want_counts).tolist()
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
