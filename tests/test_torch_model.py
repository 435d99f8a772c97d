"""The port's DLRM and optimizers against the reference, same parameters.

The reference's ``init_dlrm`` output crosses over through
``params_from_jax``; logits, loss and every gradient are held against
``jax.value_and_grad(dlrm_loss)`` (``use_kernel=False``) at f32 rtol 1e-5,
atol 1e-6, and so is one step of each optimizer.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dlrm import DLRM_KAGGLE as R_KAGGLE
from repro.configs.dlrm import scaled as r_scaled
from repro.data.synthetic import ClickLogDataset
from repro.models import dlrm as RD
from repro.optim import optimizers as ROPT
from repro_torch.configs.dlrm import DLRM_KAGGLE, scaled
from repro_torch.models import dlrm as TD
from repro_torch.optim import optimizers as TOPT
from repro_torch.tree import leaves

TOL = dict(rtol=1e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _reference(multi_hot):
    """Config, batch, parameters and (jit-compiled) loss/grads of the
    reference; cached across the tests of one multi_hot."""
    rcfg = dataclasses.replace(r_scaled(R_KAGGLE, 2000), multi_hot=multi_hot)
    ds = ClickLogDataset(rcfg.table_sizes, num_samples=64, multi_hot=multi_hot,
                         seed=1)
    batch = next(ds.batches(64))
    rparams = jax.jit(RD.init_dlrm, static_argnums=0)(
        rcfg, jax.random.PRNGKey(0))
    (rloss, rlogits), rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: RD.dlrm_loss(p, b, rcfg, False), has_aux=True))(
            rparams, batch)
    return rcfg, batch, rparams, rloss, rlogits, rgrads


def _setup(multi_hot):
    rcfg, batch, rparams, rloss, rlogits, rgrads = _reference(multi_hot)
    tcfg = dataclasses.replace(scaled(DLRM_KAGGLE, 2000), multi_hot=multi_hot)
    tparams = TD.params_from_jax(jax.tree.map(np.asarray, rparams), "cpu")
    return rcfg, tcfg, batch, rparams, tparams


def _assert_tree_close(t_tree, j_tree):
    t_leaves = leaves(t_tree)
    j_leaves = jax.tree.leaves(j_tree)
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


def test_config_copy_matches_reference():
    for name in ("num_dense", "table_sizes", "emb_dim", "bottom_mlp",
                 "top_mlp", "interaction_dim"):
        assert getattr(DLRM_KAGGLE, name) == getattr(R_KAGGLE, name)
    assert scaled(DLRM_KAGGLE, 777).table_sizes == \
        r_scaled(R_KAGGLE, 777).table_sizes


@pytest.mark.parametrize("multi_hot", [1, 3])
def test_dlrm_logits_loss_and_grads_match_reference(multi_hot):
    rcfg, tcfg, batch, rparams, tparams = _setup(multi_hot)
    _, _, _, rloss, rlogits, rgrads = _reference(multi_hot)
    live = [p.requires_grad_(True) for p in leaves(tparams)]
    tloss, tlogits = TD.dlrm_loss(tparams, TD.batch_to(batch, "cpu"), tcfg)
    tgrads = torch.autograd.grad(tloss, live)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(rlogits),
                               **TOL)
    np.testing.assert_allclose(float(tloss.detach()), float(rloss), **TOL)
    for g, rg in zip(tgrads, jax.tree.leaves(rgrads)):
        assert tuple(g.shape) == rg.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), **TOL)


@pytest.mark.parametrize("name,kw", [("rowwise_adagrad", {}), ("sgd", {}),
                                     ("sgd", {"momentum": 0.9}),
                                     ("adam", {}),
                                     ("adam", {"weight_decay": 0.01})])
def test_one_optimizer_step_matches_reference(name, kw):
    rcfg, tcfg, batch, rparams, tparams = _setup(1)
    rgrads = _reference(1)[-1]
    tgrads = TD.params_from_jax(jax.tree.map(np.asarray, rgrads), "cpu")
    ropt, topt = ROPT.get_optimizer(name, 0.02, **kw), \
        TOPT.get_optimizer(name, 0.02, **kw)
    rstate, tstate = ropt.init(rparams), topt.init(tparams)

    @jax.jit
    def rstep(params, grads, state):
        upd, state = ropt.update(grads, state, params)
        return ROPT.apply_updates(params, upd), state

    rnew, rstate = rstep(rparams, rgrads, rstate)
    tupd, tstate = topt.update(tgrads, tstate, tparams)
    tnew = TOPT.apply_updates(tparams, tupd)
    _assert_tree_close(tnew, rnew)
    if name == "rowwise_adagrad":
        _assert_tree_close(tstate["acc"], rstate["acc"])
        assert tstate["acc"]["tables"][2].shape == (tcfg.table_sizes[2],)


def test_init_dlrm_draws_the_reference_distributions():
    cfg = scaled(DLRM_KAGGLE, 2000)
    p = TD.init_dlrm(cfg, torch.Generator().manual_seed(0), "cpu")
    for t, n in zip(p["tables"], cfg.table_sizes):
        assert t.shape == (n, cfg.emb_dim)
        assert float(t.abs().max()) <= 1.0 / np.sqrt(n)
    w0 = p["bottom"][0]["w"]
    assert w0.shape == (13, 512) and float(w0.abs().max()) <= 1 / np.sqrt(13)
    assert all(float(layer["b"].abs().max()) == 0.0
               for layer in p["bottom"] + p["top"])
    back = TD.params_to_numpy(p)
    back["tables"][0][0, 0] += 1.0              # a copy, never an alias
    assert float(p["tables"][0][0, 0]) != back["tables"][0][0, 0]
