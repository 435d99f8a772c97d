"""Two checks of the port's LM training driver on the CPU.

The LM example's configuration (``CFG_100M``: 12 gemma2-style f32 layers,
~81 M parameters, window 256) trained by the port's driver against the
reference's driver, from the reference's initial parameters over the same
tokens.  The example's loss climbs over its first tens of steps in both
packages (``PERF.md``); this holds that the port takes the reference's
steps there.  Its leaves of millions of entries also hold the gradient
clip's norm to the reference's: an f32 norm that drifts by 1e-3 on such a
leaf moves every update, and the losses part by 1e-3 within 4 steps.

``benchmarks_torch.lm_train_spread``, the trace that ``chip_smoke.py``
phase 7 (c)'s limit comes from, at two CPU thread counts: the same saves
and restores, losses within rounding.
"""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch import train as ref_train
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.launch import train as port_train
from repro_torch.models import transformer as T
from test_torch_train import assert_losses_close, assert_policy_identical

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))       # the harnesses are top-level packages
from benchmarks_torch import lm_train_spread  # noqa: E402


def _example_cfg(name):
    spec = importlib.util.spec_from_file_location(
        name[:-3], ROOT / "examples" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CFG_100M


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_lm_100m_trains_as_the_reference_does():
    cfg_ref = _example_cfg("train_lm_with_cpr.py")
    cfg = _example_cfg("torch_train_lm_with_cpr.py")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_ref)
    init = jax.tree.map(np.asarray,
                        RT.init_model(cfg_ref, jax.random.PRNGKey(0)))
    run = dict(steps=5, batch=1, seq=64, mode="cpr-mfu", n_failures=2,
               log_every=1, tracker_backend="host")
    _, ref = ref_train.train(cfg_ref, **run)
    _, port = port_train.train(cfg, device="cpu", params=init, **run)
    assert_policy_identical(ref["report"], port["report"])
    assert port["report"]["n_failures"] == 2
    assert_losses_close(ref, port)


def test_lm_train_spread_traces_the_same_saves_and_restores():
    cfg = get_config("recurrentgemma-2b").reduced()
    init = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    a, b = (lm_train_spread.trace(cfg, init, "cpu", threads, 0.0, 5,
                                  "cpr-mfu", "kernel") for threads in (2, 1))
    kinds = [e[0] for e in a["log"]]
    assert kinds == [e[0] for e in b["log"]] and "failure" in kinds
    for ea, eb in zip(a["log"], b["log"]):
        rows = 6 if ea[0] == "save" else 4
        assert len(ea[rows]) and np.array_equal(ea[rows], eb[rows])
        assert lm_train_spread.share(ea[2], eb[2]) <= 1e-5
    for x, y in zip(a["loss"], b["loss"]):
        assert abs(x - y) <= 1e-5 * abs(y)
    assert len(a["grads"]) == 5
