"""The port's serving example (``examples/torch_serve.py``) on the CPU: it
runs as a process and prints the reference example's lines, and its loop,
given the reference's initial parameters and the same prompts, continues
them with the ids of the reference example's jitted decode loop, from
logits within 2e-5 (the serving limit: f32 sums in another order)."""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "torch_serve.py"
TOL = 2e-5


def _example():
    spec = importlib.util.spec_from_file_location("torch_serve", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(args):
    # one intra-op thread: the suite runs test files in parallel processes
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, str(EXAMPLE), *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def reference_loop(cfg, tree, prompts, tokens):
    """``examples/serve.py``'s loop: prefill by teacher-forcing through
    the jitted ``decode_step``, then greedy decode.  The ids and the
    logits each was taken from."""
    B, P = prompts.shape
    max_len = P + tokens
    state = RT.init_decode_state(cfg, B, max_len, jnp.float32)
    step = jax.jit(lambda p, s, t, i: RT.decode_step(p, s, t, i, cfg))
    for i in range(P):
        logits, state = step(tree, state, jnp.asarray(prompts[:, i]),
                             jnp.int32(i))
    tok = jnp.argmax(logits, -1)
    out, seen = [tok], [logits]
    for i in range(P, max_len - 1):
        logits, state = step(tree, state, tok, jnp.int32(i))
        tok = jnp.argmax(logits, -1)
        out.append(tok)
        seen.append(logits)
    return np.stack(out, 1), np.stack(seen)


@pytest.mark.parametrize("arch", ["gemma2-2b", "recurrentgemma-2b"])
def test_continuations_equal_the_reference_example(arch):
    cfg_ref, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    tree = RT.init_model(cfg_ref, jax.random.PRNGKey(0))
    params = T.params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 8))
    want_ids, want_logits = reference_loop(cfg_ref, tree, prompts, 10)
    ids, logits, _, _ = _example().generate(cfg, params, prompts, 10,
                                            torch.device("cpu"))
    assert ids.shape == (3, 10)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=TOL,
                               atol=TOL)


def test_torch_serve_runs_on_the_cpu():
    r = _run(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
              "--tokens", "6"])
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert re.fullmatch(r"prefill: 8 steps in \d+\.\d\ds \(incl\. the "
                        r"kernels' first use\)", lines[0])
    assert re.fullmatch(r"decode: 12 tokens in \d+\.\d\ds -> \d+\.\d tok/s "
                        r"\(batch=2, arch=\S+, device=cpu\)", lines[1])
    assert re.fullmatch(r"sample continuation ids: \[\d+(, \d+){5}\]",
                        lines[2])


def test_torch_serve_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    r = _run(["--tokens", "2"])
    assert r.returncode != 0
    assert "pass device='cpu'" in r.stderr
