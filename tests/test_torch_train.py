"""The port's LM training driver (``repro_torch.launch.train``) on the CPU
against the reference's (``repro.launch.train``).

Both start from the reference's ``init_model`` parameters (the port takes
them as ``params=``) and read the same ``TokenDataset`` tokens; the
reference's step is jitted jnp (attention with ``use_flash=False``), the
port's runs the plain forwards and the written-out backwards.  Over 6
steps with 2 failures, losses agree within 1e-4 relative (f32 sums in
another order, through Adagrad's row scaling) and the policy fields are
identical; in ``cpr-ssu`` the keep-scores come from each package's own
generator, so only the policy is compared there.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.data.synthetic import TokenDataset as RefTokens
from repro.launch import train as ref_train
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.data.synthetic import TokenDataset
from repro_torch.launch import train as port_train

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
RUN = dict(steps=6, batch=2, seq=64, n_failures=2, log_every=1,
           tracker_backend="host")


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs test files in parallel
    processes, and these files' torch work would crowd the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs():
    return (ref_config("recurrentgemma-2b").reduced(),
            get_config("recurrentgemma-2b").reduced())


def _init(cfg_ref, seed=0):
    """The reference's initial parameters for seed ``seed``, as numpy."""
    return jax.tree.map(np.asarray,
                        RT.init_model(cfg_ref, jax.random.PRNGKey(seed)))


def run_both(mode, **kw):
    cfg_ref, cfg = _configs()
    _, ref = ref_train.train(cfg_ref, mode=mode, **{**RUN, **kw})
    _, port = port_train.train(cfg, mode=mode, device="cpu",
                               params=_init(cfg_ref), **{**RUN, **kw})
    return ref, port


def assert_policy_identical(a, b, with_bytes=True):
    keys = ("save", "load", "lost", "resched") if with_bytes else \
        ("load", "lost", "resched")
    for k in keys:
        assert b["overheads"][k] == a["overheads"][k], k
    for k in ("mode", "measured_pls", "n_failures", "T_save",
              "effective_mode", "expected_pls", "save_interval",
              "pls_by_shard"):
        assert b[k] == a[k], k
    if with_bytes:
        assert b["bytes_written"] == a["bytes_written"]


def assert_losses_close(ref, port):
    assert [s for s, _ in port["loss"]] == [s for s, _ in ref["loss"]]
    for (_, a), (_, b) in zip(ref["loss"], port["loss"]):
        assert np.isfinite(b) and abs(b - a) <= LOSS_RTOL * abs(a), (a, b)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_token_dataset_equals_the_reference(seed):
    a, b = RefTokens(512, num_tokens=5001, seed=seed), \
        TokenDataset(512, num_tokens=5001, seed=seed)
    assert np.array_equal(a.tokens, b.tokens)
    for x, y in zip(a.batches(4, 64), b.batches(4, 64)):
        assert np.array_equal(x["tokens"], y["tokens"])
    assert sum(1 for _ in b.batches(4, 64)) == 5001 // 256


@pytest.mark.parametrize("mode", ["full", "partial", "cpr-mfu"])
def test_train_matches_the_reference(mode):
    ref, port = run_both(mode)
    assert_policy_identical(ref["report"], port["report"])
    assert port["report"]["n_failures"] == 2
    assert_losses_close(ref, port)
    assert [e[:2] for e in port["events"]] == [e[:2] for e in ref["events"]]
    assert len(port["step_s"]) == RUN["steps"]


def test_train_cpr_ssu_policy_matches_the_reference():
    ref, port = run_both("cpr-ssu")
    assert_policy_identical(ref["report"], port["report"], with_bytes=False)
    assert all(np.isfinite(l) for _, l in port["loss"])


def test_entry_points_refuse_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    _, cfg = _configs()
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        port_train.train(cfg, steps=1, batch=1, seq=8)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for args in (["-m", "repro_torch.launch.train", "--reduced",
                  "--steps", "1"],
                 [str(ROOT / "examples" / "torch_train_lm_with_cpr.py"),
                  "--steps", "1"]):
        r = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert "pass device='cpu'" in r.stderr
