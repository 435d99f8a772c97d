"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, recurrent gating).

The port of ``repro.models.xlstm``, plain tensor code as the reference's
is plain jnp (it has no Pallas kernel).  mLSTM train/prefill uses the
chunkwise-parallel form with the stabilized exponential gating, each
chunk recomputed in the backward (``torch.utils.checkpoint`` where the
reference uses ``jax.checkpoint``); decode uses the recurrent form with a
carried (C, n, m) state.  sLSTM is sequential: a Python loop over time.

Dtypes follow the reference: the mLSTM's projections run in the
activation dtype and its gating and memory in f32; the sLSTM's gate
projections run in f32 against the f32 weights, only its output
projection in the activation dtype.  States are f32 whatever the model's
dtype.

Two deliberate differences in the sLSTM's order of work (the same dot
products, summed in the same way): the four input projections of every
step are one (B*S, d) x (d, 4d) product before the loop, the bias added
there; and the four block-diagonal recurrent products of a step are one
batched product against an (H, hd, 4*hd) stack built once a forward.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import dense_init
from repro_torch.sharding.ctx import current_policy

GATES = ("z", "i", "f", "o")


# ---------------------------------------------------------------- mLSTM ----
def init_mlstm(generator, d, num_heads, device=None):
    def dense(shape):
        return dense_init(generator, shape, device=device)

    def full(value):
        return torch.full((num_heads,), value, dtype=torch.float32,
                          device=device)

    return {"wq": dense((d, d)), "wk": dense((d, d)), "wv": dense((d, d)),
            "wi": dense((d, num_heads)), "bi": full(0.0),
            "wf": dense((d, num_heads)),
            "bf": full(3.0),                    # open forget gates
            "wog": dense((d, d)), "wout": dense((d, d))}


def _mlstm_chunk(C0, n0, m0, qt, kt, vt, it, ft, tri):
    """One chunk of the chunkwise form.  (C0, n0, m0): the carried state
    (B,H,hd,hd), (B,H,hd), (B,H); qt, kt, vt (B,c,H,hd), it, ft (B,c,H),
    all f32.  Returns (h (B,c,H,hd), C, n, m) at the chunk's end."""
    Fc = torch.cumsum(ft, dim=1)                               # inclusive
    g = Fc + m0[:, None, :]                                    # (B,c,H)
    Dtil = Fc[:, :, None, :] - Fc[:, None, :, :] + it[:, None, :, :]
    Dtil = torch.where(tri[None, :, :, None], Dtil, -math.inf)
    # amax splits a tie's gradient evenly, as jnp.max does
    m = torch.maximum(g, torch.amax(Dtil, dim=2))              # (B,c,H)
    D = torch.exp(Dtil - m[:, :, None, :])                     # (B,c,c,H)
    Cmat = torch.einsum("bshd,bthd->bsth", qt, kt) * D
    inter = torch.exp(g - m)[..., None]                        # (B,c,H,1)
    num = torch.einsum("bsth,bthd->bshd", Cmat, vt) + \
        inter * torch.einsum("bhde,bshe->bshd", C0, qt)
    nvec = torch.einsum("bsth,bthd->bshd", D, kt) + inter * n0[:, None]
    den = torch.maximum(torch.einsum("bshd,bshd->bsh", nvec, qt).abs(),
                        torch.exp(-m))
    h = num / den[..., None]
    mc = m[:, -1]                                              # (B,H)
    w_end = torch.exp(Fc[:, -1:, :] - Fc + it - mc[:, None])   # (B,c,H)
    decay = torch.exp(Fc[:, -1] + m0 - mc)                     # (B,H)
    C = decay[..., None, None] * C0 + torch.einsum(
        "bthd,bthe->bhde", w_end[..., None] * vt, kt)
    n = decay[..., None] * n0 + torch.einsum("bth,bthd->bhd", w_end, kt)
    return h, C, n, mc


def _mlstm_in(p, x, B, S, H, hd):
    """The projections in x's dtype -> f32 (q, k, v, itil, logf) and the
    output gate in x's dtype."""
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, H, hd).float()
    k = (x @ p["wk"].to(dt)).reshape(B, S, H, hd).float() / math.sqrt(hd)
    v = (x @ p["wv"].to(dt)).reshape(B, S, H, hd).float()
    og = torch.sigmoid(x @ p["wog"].to(dt))
    itil = (x @ p["wi"].to(dt)).float() + p["bi"]              # (B,S,H)
    logf = F.logsigmoid((x @ p["wf"].to(dt)).float() + p["bf"])
    return q, k, v, itil, logf, og


def mlstm_forward(p, x, num_heads, chunk=256):
    """Chunkwise-parallel form (exactly matches the recurrent form).

    x: (B, S, d).  Runs over chunks of length ``chunk`` carrying the
    (C, n, m) state; within a chunk the (c, c) decay matrix is
    materialized, and only the carries are kept for the backward.  Under
    an activation policy with ``probe_full_blocks`` (the dry run's probes)
    the whole sequence is one chunk, as in the reference.
    """
    pol = current_policy()
    if pol and pol.get("probe_full_blocks"):
        chunk = x.shape[1]
    B, S, d = x.shape
    H, hd = num_heads, d // num_heads
    c = min(chunk, S)
    assert S % c == 0, (S, c)
    q, k, v, itil, logf, og = _mlstm_in(p, x, B, S, H, hd)
    tri = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    state = init_mlstm_state(d, H, B, x.device)
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    # split, not slices: its backward is one concatenation, where each
    # slice's would be a zero tensor of the full size
    for qt, kt, vt, it, ft in zip(*(t.split(c, dim=1)
                                    for t in (q, k, v, itil, logf))):
        h, C, n, m = checkpoint(_mlstm_chunk, C, n, m, qt, kt, vt, it, ft,
                                tri, use_reentrant=False)
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(B, S, d).to(x.dtype) * og
    return h @ p["wout"].to(x.dtype)


def init_mlstm_state(d, num_heads, batch, device=None):
    hd = d // num_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, num_heads, hd, hd), **f32),
            "n": torch.zeros((batch, num_heads, hd), **f32),
            "m": torch.full((batch, num_heads), -1e30, **f32)}


def mlstm_decode(p, x, state, num_heads):
    """Recurrent form, one step. x: (B, 1, d) -> (y, new state)."""
    B, _, d = x.shape
    H, hd = num_heads, d // num_heads
    q, k, v, itil, logf, og = _mlstm_in(p, x, B, 1, H, hd)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                        # (B,H,hd)
    itil, logf, og = itil[:, 0], logf[:, 0], og[:, 0]
    logf_m = logf + state["m"]
    m_new = torch.maximum(logf_m, itil)
    fprime = torch.exp(logf_m - m_new)
    iprime = torch.exp(itil - m_new)
    C = fprime[..., None, None] * state["C"] + iprime[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", v, k)
    n = fprime[..., None] * state["n"] + iprime[..., None] * k
    num = torch.einsum("bhde,bhe->bhd", C, q)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n, q).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, d).to(x.dtype) * og
    y = (h @ p["wout"].to(x.dtype))[:, None]
    return y, {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------- sLSTM ----
def init_slstm(generator, d, num_heads, device=None):
    hd = d // num_heads
    p = {}
    for g in GATES:
        p[f"w{g}"] = dense_init(generator, (d, d), device=device)
        # block-diagonal recurrent weights: (H, hd, hd)
        p[f"r{g}"] = dense_init(generator, (num_heads, hd, hd), in_axis=1,
                                device=device).mul_(0.1)
        p[f"b{g}"] = torch.full((d,), 2.0 if g == "f" else 0.0,
                                dtype=torch.float32, device=device)
    p["wout"] = dense_init(generator, (d, d), device=device)
    return p


def init_slstm_state(d, num_heads, batch, device=None):
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **f32),
            "n": torch.ones((batch, d), **f32),
            "h": torch.zeros((batch, d), **f32),
            "m": torch.zeros((batch, d), **f32)}


def _slstm_weights(p):
    """(the four gates' input weights (d, 4d), their biases (4d,), their
    recurrent weights stacked (H, hd, 4*hd)), gate-major in GATES order."""
    return (torch.cat([p[f"w{g}"] for g in GATES], dim=1),
            torch.cat([p[f"b{g}"] for g in GATES]),
            torch.cat([p[f"r{g}"] for g in GATES], dim=2))


def _slstm_cell(pre, r, state, floor):
    """One step from the step's input projections plus biases ``pre``
    (B, 4d), f32.  state: (B, d) tensors; r: (H, hd, 4*hd)."""
    B, d = state["h"].shape
    H, hd = r.shape[:2]
    rec = torch.bmm(state["h"].view(B, H, hd).transpose(0, 1), r)  # (H,B,4hd)
    gates = pre.view(B, 4, H, hd) + rec.view(H, B, 4, hd).permute(1, 2, 0, 3)
    z = torch.tanh(gates[:, 0])
    itil = gates[:, 1]
    logf = F.logsigmoid(gates[:, 2])
    o = torch.sigmoid(gates[:, 3])
    logf_m = logf + state["m"].view(B, H, hd)
    m_new = torch.maximum(logf_m, itil)
    iprime = torch.exp(itil - m_new)
    fprime = torch.exp(logf_m - m_new)
    c = fprime * state["c"].view(B, H, hd) + iprime * z
    # maximum splits a tie's gradient, as jnp.maximum does (clamp_min
    # would pass all of it)
    n = torch.maximum(fprime * state["n"].view(B, H, hd) + iprime, floor)
    h = o * c / n
    return {"c": c.reshape(B, d), "n": n.reshape(B, d),
            "h": h.reshape(B, d), "m": m_new.reshape(B, d)}


def _floor(device):
    return torch.full((), 1e-6, dtype=torch.float32, device=device)


def _slstm_step(p, state, xt, num_heads):
    """xt: (B, d) raw input -> the new state."""
    w, b, r = _slstm_weights(p)
    return _slstm_cell(xt.float() @ w + b, r, state, _floor(xt.device))


def slstm_forward(p, x, num_heads):
    """x: (B, S, d), sequential over time."""
    B, _, d = x.shape
    w, b, r = _slstm_weights(p)
    # one product over every row in memory order (a strided row order sent
    # it to a slow batched path on the card), then unbound into the steps'
    # (B, 4d) views: unbind's backward is one stack, where indexing step t
    # would build a zero tensor of the full size for each step
    pre = (x.float() @ w + b).unbind(1)
    state = init_slstm_state(d, num_heads, B, x.device)
    floor = _floor(x.device)
    hs = []
    for pre_t in pre:
        state = _slstm_cell(pre_t, r, state, floor)
        hs.append(state["h"])
    h = torch.stack(hs, dim=1).to(x.dtype)
    return h @ p["wout"].to(x.dtype)


def slstm_decode(p, x, state, num_heads):
    new = _slstm_step(p, state, x[:, 0], num_heads)
    y = (new["h"].to(x.dtype) @ p["wout"].to(x.dtype))[:, None]
    return y, new
