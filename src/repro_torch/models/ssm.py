"""Attention-free sequence mixers: RWKV6 (Finch) and Mamba2 (SSD), the
reference's ``src/repro/models/ssm.py`` in PyTorch.

Both use the *chunked* linear-attention form: the sequence is cut into
chunks of L tokens; within a chunk everything is dense products, and a
loop over the chunks carries the recurrent state (the reference's
``lax.scan``).  A decode step (a state given and S <= 4) runs the exact
recurrence instead.  The chunked form raises when S is not a multiple of
the chunk, as the reference's does.

Numerics are the reference's: the state and the decays in float32; RWKV's
within-chunk factors clamped to exp(+-30); Mamba2's above-diagonal decays
masked to -inf *before* ``exp`` (unmasked they are positive and overflow);
RWKV's per-head group norm (eps 1e-5) and Mamba2's gated RMSNorm (eps
1e-6) in the reference's order.  No kernel: the reference has none here.

Each mixer's work between its input and output projections runs inside
the profiler range :data:`SCAN_RANGE`, which a device-time breakdown reads.

Under a ``tp`` or plain ``sp`` recipe (:class:`repro_torch.models.sharding.Placement`)
each rank runs :func:`rwkv6_mix_placed` / :func:`mamba2_mix_placed`: where
the mixer's heads divide the ``model`` axis, its block of the heads (their
projections, scan, norm and recurrent state), with its float32 partial of
the output projection summed over ``model``; Mamba2's gated RMSNorm, which
spans the whole inner width, sums its per-row sum of squares over
``model`` first.  Elsewhere every rank runs the whole mixer on weights and
state gathered over ``model`` and keeps its block of the new state.  On a
``model`` axis of one rank both are the plain mixer.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .module import pspec
from .sharding import partial_product

__all__ = ["rwkv6_specs", "RWKVState", "rwkv6_mix", "rwkv6_mix_placed", "mamba2_specs",
           "MambaState", "mamba2_mix", "mamba2_mix_placed", "SCAN_RANGE"]

SCAN_RANGE = "ssm.scan"  # the profiler range around a mixer's recurrent work

# ================================================================= RWKV6 ====


def rwkv6_specs(d_model: int, n_heads: int, *, decay_rank: int = 64, mix_rank: int = 32,
                dtype=torch.float32):
    del n_heads, mix_rank  # the reference declares them and uses neither
    d = d_model
    return {
        # token-shift mixing coefficients (one per stream r, k, v, g, w)
        "mix": pspec(("p", 5), ("m", d), dtype=dtype, init="zeros"),
        "wr": pspec(("m", d), ("a", d), dtype=dtype, fan_in=("m",)),
        "wk": pspec(("m", d), ("a", d), dtype=dtype, fan_in=("m",)),
        "wv": pspec(("m", d), ("a", d), dtype=dtype, fan_in=("m",)),
        "wg": pspec(("m", d), ("a", d), dtype=dtype, fan_in=("m",)),
        "wo": pspec(("a", d), ("m", d), dtype=dtype, fan_in=("a",)),
        # data-dependent decay: w_t = exp(-exp(w0 + tanh(x A) B))
        "w0": pspec(("a", d), dtype=dtype, init="zeros", scale=None),
        "wA": pspec(("m", d), ("r", decay_rank), dtype=dtype, fan_in=("m",)),
        "wB": pspec(("r", decay_rank), ("a", d), dtype=dtype, scale=0.01),
        "u": pspec(("a", d), dtype=dtype, init="zeros"),  # bonus, per channel
        "ln_w": pspec(("a", d), dtype=dtype, init="ones"),  # group-norm weight
    }


class RWKVState(NamedTuple):
    wkv: torch.Tensor  # (B, H, K, V) float32 matrix state
    shift: torch.Tensor  # (B, m) previous token's input


def _rwkv_streams(p, x, x_prev):
    """Token-shift interpolation and projections; x, x_prev (B, L, m)."""
    dt = x.dtype
    mix = p["mix"].to(dt)  # (5, m)
    xs = [x + (x_prev - x) * mix[i] for i in range(5)]
    r = xs[0] @ p["wr"].to(dt)
    k = xs[1] @ p["wk"].to(dt)
    v = xs[2] @ p["wv"].to(dt)
    g = xs[3] @ p["wg"].to(dt)
    dlow = torch.tanh(xs[4] @ p["wA"].to(dt))
    logw = -torch.exp(p["w0"].float() + (dlow @ p["wB"].to(dt)).float())  # (B, L, a) < 0
    return r, k, v, g, logw


def _heads(x, H: int):
    B, L, A = x.shape
    return x.reshape(B, L, H, A // H).transpose(1, 2)  # (B, H, L, hd)


def rwkv6_mix(p, x, *, n_heads: int, chunk: int = 64, state: RWKVState | None = None):
    """x (B, S, m) -> (y, new_state); a ``state`` with S <= 4 runs the exact
    recurrence (decode)."""
    prev = state.shift[:, None] if state is not None else torch.zeros_like(x[:, :1])
    x_prev = torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)
    r, k, v, g, logw = _rwkv_streams(p, x, x_prev)
    with record_function(SCAN_RANGE):
        o, st = _rwkv_scan(p, r, k, v, g, logw, state, n_heads, chunk)
    y = o @ p["wo"].to(x.dtype)
    return y, RWKVState(wkv=st, shift=x[:, -1])


# the RWKV6 weights whose ``a`` dim a recipe may cut over ``model``, by that dim
_RWKV_A_DIMS = {"wr": 1, "wk": 1, "wv": 1, "wg": 1, "wo": 0, "w0": 0, "wB": 1, "u": 0, "ln_w": 0}


def _heads_split(place, H: int) -> bool:
    """Whether the ``model`` ranks split a mixer's H heads between them."""
    return place.M > 1 and H % place.M == 0


def rwkv6_mix_placed(p, x, *, place, n_heads: int, chunk: int = 64,
                     state: RWKVState | None = None):
    """This rank's part of :func:`rwkv6_mix` under a ``tp``/``sp`` recipe.

    ``x`` (Bl, S, m) is this rank's rows, whole over ``model``; ``p`` the
    layer's weights with ``m`` gathered, their ``a`` dim cut over ``model``
    where the recipe binds it; ``state`` this rank's block of the decode
    state (``decode_state_shardings``: the wkv state's heads over ``model``
    where they divide it, else its value columns).  Returns ``(y (Bl, S,
    m), new_state)``, ``y`` the same on every ``model`` rank and the new
    state this rank's block.  The group norm is per head, so it stays
    local."""
    A, H = x.shape[-1], n_heads
    hd = A // H
    if not _heads_split(place, H):
        pw = {**p, **{k: place.block(p[k], d, 0, A, A, split=False)
                      for k, d in _RWKV_A_DIMS.items()}}
        cut = state is not None and state.wkv.shape[-1] != hd
        if cut:
            state = state._replace(wkv=place.gather_model(state.wkv, 3))
        y, new = rwkv6_mix(pw, x, n_heads=H, chunk=chunk, state=state)
        if cut:
            vl = hd // place.M
            new = new._replace(wkv=new.wkv.narrow(3, place.mr * vl, vl))
        return y, new
    hl = H // place.M
    a0 = place.mr * hl * hd
    pl = {k: place.block(p[k], d, a0, hl * hd, A, split=True) for k, d in _RWKV_A_DIMS.items()}
    pl["mix"], pl["wA"] = place.enter_model(p["mix"]), place.enter_model(p["wA"])
    xn = place.enter_model(x)
    prev = state.shift[:, None] if state is not None else torch.zeros_like(xn[:, :1])
    x_prev = torch.cat([prev.to(x.dtype), xn[:, :-1]], dim=1)
    r, k, v, g, logw = _rwkv_streams(pl, xn, x_prev)
    with record_function(SCAN_RANGE):
        o, st = _rwkv_scan(pl, r, k, v, g, logw, state, hl, chunk)
    y = place.sum_model(partial_product(o, pl["wo"])).to(x.dtype)
    return y, RWKVState(wkv=st, shift=x[:, -1])


def _rwkv_scan(p, r, k, v, g, logw, state, H: int, chunk: int):
    """The wkv recurrence (exact, or chunked), the group norm and the gate:
    (B, S, a) in the activation dtype, and the new wkv state."""
    B, S, m = r.shape
    hd = m // H
    u = p["u"].float().reshape(H, hd)
    rh, kh, vh = _heads(r, H).float(), _heads(k, H).float(), _heads(v, H).float()
    wh = _heads(logw, H)  # (B, H, S, hd) log decays, float32

    st = state.wkv if state is not None else torch.zeros((B, H, hd, hd), dtype=torch.float32,
                                                         device=r.device)
    if state is not None and S <= 4:  # exact recurrence (decode)
        outs = []
        for t in range(S):
            rt, kt, vt = rh[:, :, t], kh[:, :, t], vh[:, :, t]
            at = st + (u[None] * kt)[..., None] * vt[..., None, :]
            outs.append(torch.einsum("bhk,bhkv->bhv", rt, at))
            st = st * torch.exp(wh[:, :, t])[..., None] + kt[..., None] * vt[..., None, :]
        o = torch.stack(outs, dim=2)  # (B, H, S, hd)
    else:  # chunked parallel form
        if S % chunk:
            raise ValueError(f"seq {S} must be a multiple of chunk {chunk}")
        nC = S // chunk
        rc, kc, vc, wc = (t.reshape(B, H, nC, chunk, hd) for t in (rh, kh, vh, wh))
        cum = torch.cumsum(wc, dim=3)  # inclusive cumulative log decay
        cum_prev = cum - wc  # exclusive (W_{t-1})
        tot = cum[:, :, :, -1]  # (B, H, nC, hd) chunk total log decay
        a_q = rc * torch.exp(torch.clamp(cum_prev, -30.0, 0.0))  # query side
        b_k = kc * torch.exp(torch.clamp(-cum, -30.0, 30.0))  # key side
        k_out = kc * torch.exp(torch.clamp(tot[..., None, :] - cum, -30.0, 0.0))  # state update

        scores = a_q @ b_k.transpose(-1, -2)  # (B, H, nC, t, s)
        tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32, device=r.device), -1)
        diag = (rc * u[None, :, None, None, :] * kc).sum(-1)  # u-bonus on the diagonal
        intra = (scores * tri) @ vc + diag[..., None] * vc

        inters = []
        for c in range(nC):
            inters.append(a_q[:, :, c] @ st)
            st = (st * torch.exp(tot[:, :, c])[..., None]
                  + k_out[:, :, c].transpose(-1, -2) @ vc[:, :, c])
        o = (intra + torch.stack(inters, dim=2)).reshape(B, H, S, hd)

    # group norm per head, gate
    oh = o.transpose(1, 2)  # (B, S, H, hd)
    mean = oh.mean(dim=-1, keepdim=True)
    var = oh.var(dim=-1, unbiased=False, keepdim=True)
    oh = (oh - mean) * torch.rsqrt(var + 1e-5)
    o = (oh.reshape(B, S, m) * p["ln_w"].float()).to(r.dtype)
    return o * F.silu(g), st


# ================================================================ Mamba2 ====


def mamba2_specs(d_model: int, *, d_state: int = 64, head_dim: int = 64, expand: int = 2,
                 n_groups: int = 1, conv_width: int = 4, dtype=torch.float32):
    d_inner = expand * d_model
    H = d_inner // head_dim
    return {
        "w_in": pspec(("m", d_model), ("i", 2 * d_inner + 2 * n_groups * d_state + H),
                      dtype=dtype, fan_in=("m",)),
        "conv": pspec(("w", conv_width), ("c", d_inner + 2 * n_groups * d_state), dtype=dtype,
                      scale=0.3),
        "A_log": pspec(("h", H), dtype=dtype, init="zeros"),
        "D": pspec(("h", H), dtype=dtype, init="ones"),
        "dt_bias": pspec(("h", H), dtype=dtype, init="zeros"),
        "norm_w": pspec(("i", d_inner), dtype=dtype, init="ones"),
        "w_out": pspec(("i", d_inner), ("m", d_model), dtype=dtype, fan_in=("i",)),
    }


class MambaState(NamedTuple):
    ssm: torch.Tensor  # (B, H, P, N) float32
    conv: torch.Tensor  # (B, W-1, conv_channels) trailing inputs


def _causal_conv(x, w, state):
    """x (B, S, C), w (W, C); returns the conv output and the new trailing
    window."""
    S, W = x.shape[1], w.shape[0]
    xin = torch.cat([state.to(x.dtype), x], dim=1)  # (B, W-1+S, C)
    out = sum(xin[:, i:i + S] * w[i] for i in range(W))
    return F.silu(out), xin[:, -(W - 1):]


def mamba2_mix(p, x, *, d_state: int = 64, head_dim: int = 64, expand: int = 2,
               n_groups: int = 1, conv_width: int = 4, chunk: int = 64,
               state: MambaState | None = None):
    """Mamba2 SSD block. x (B, S, m) -> (y, new_state)."""
    d_inner = expand * x.shape[-1]
    H = d_inner // head_dim
    P, N, G = head_dim, d_state, n_groups

    zxbcdt = x @ p["w_in"].to(x.dtype)
    with record_function(SCAN_RANGE):
        y, new_state = _mamba_scan(p, zxbcdt, state, d_inner, H, P, N, G, conv_width, chunk)
    return y @ p["w_out"].to(x.dtype), new_state


def _mamba_dims(d_model: int, head_dim: int, expand: int, n_groups: int, d_state: int):
    """``(d_inner, H, i, c)``: the inner width, the heads, and the fused
    ``[z | x | B | C | dt]`` and ``[x | B | C]`` widths of ``w_in`` and the
    conv."""
    d_inner = expand * d_model
    H = d_inner // head_dim
    return d_inner, H, 2 * d_inner + 2 * n_groups * d_state + H, d_inner + 2 * n_groups * d_state


def mamba2_mix_placed(p, x, *, place, d_state: int = 64, head_dim: int = 64, expand: int = 2,
                      n_groups: int = 1, conv_width: int = 4, chunk: int = 64,
                      state: MambaState | None = None):
    """This rank's part of :func:`mamba2_mix` under a ``tp``/``sp`` recipe.

    ``x`` (Bl, S, m) is this rank's rows, whole over ``model``; ``p`` the
    layer's weights with ``m`` gathered, ``w_in``'s fused ``i`` dim, the
    conv's ``c``, the heads' ``h`` and ``d_inner`` cut over ``model``
    where the recipe binds them (cuts that straddle the fused segments);
    ``state`` this rank's block of the decode state (the SSM state's heads
    over ``model`` where they divide it, else its head dim P; the conv
    window whole).  Returns ``(y (Bl, S, m), new_state)``, ``y`` the same on
    every ``model`` rank.

    Where the heads divide ``model``, the rank projects only its heads'
    ``z``, ``x`` and ``dt`` columns and every group's ``B``/``C`` (from
    ``w_in`` gathered over ``model``), convolves those channels, scans its
    heads, and sums its float32 sum of squares over ``model`` for the gated
    RMSNorm, whose mean spans the whole ``d_inner``; its partial of the
    output projection is summed over ``model``.  Given a ``state`` the new
    conv window is put together over ``model`` (it is whole on every
    rank); without one the new state holds only the rank's channels."""
    d_inner, H, i_full, c_full = _mamba_dims(x.shape[-1], head_dim, expand, n_groups, d_state)
    P, GN = head_dim, n_groups * d_state
    cuts = {"w_in": (1, i_full), "conv": (1, c_full), "A_log": (0, H), "D": (0, H),
            "dt_bias": (0, H), "norm_w": (0, d_inner), "w_out": (0, d_inner)}
    kw = dict(d_state=d_state, head_dim=head_dim, expand=expand, n_groups=n_groups,
              conv_width=conv_width, chunk=chunk)
    if not _heads_split(place, H):
        pw = {k: place.block(p[k], d, 0, f, f, split=False) for k, (d, f) in cuts.items()}
        # the state's dim the recipe cut (heads, or P where they do not divide)
        cut = next((d for d in (1, 2) if state is not None
                    and state.ssm.shape[d] != (H, P)[d - 1]), None)
        if cut is not None:
            n = state.ssm.shape[cut]
            state = state._replace(ssm=place.gather_model(state.ssm, cut))
        y, new = mamba2_mix(pw, x, state=state, **kw)
        if cut is not None:
            new = new._replace(ssm=new.ssm.narrow(cut, place.mr * n, n))
        return y, new
    hl = H // place.M
    h0 = place.mr * hl
    c0, cl = h0 * P, hl * P  # this rank's channels of d_inner
    w_in = place.block(p["w_in"], 1, 0, i_full, i_full, split=True)
    w_in = torch.cat([w_in[:, c0:c0 + cl], w_in[:, d_inner + c0:d_inner + c0 + cl],
                      w_in[:, 2 * d_inner:2 * d_inner + 2 * GN],
                      w_in[:, 2 * d_inner + 2 * GN + h0:2 * d_inner + 2 * GN + h0 + hl]], dim=1)
    conv = place.block(p["conv"], 1, 0, c_full, c_full, split=True)
    pl = {"conv": torch.cat([conv[:, c0:c0 + cl], conv[:, d_inner:]], dim=1),
          **{k: place.block(p[k], 0, h0, hl, H, split=True) for k in ("A_log", "D", "dt_bias")},
          **{k: place.block(p[k], 0, c0, cl, d_inner, split=True) for k in ("norm_w", "w_out")}}
    if state is not None:
        conv_state = torch.cat([state.conv[..., c0:c0 + cl], state.conv[..., d_inner:]], dim=-1)
        state = MambaState(ssm=state.ssm, conv=conv_state)
    zxbcdt = place.enter_model(x) @ w_in.to(x.dtype)
    with record_function(SCAN_RANGE):
        y, new = _mamba_scan(pl, zxbcdt, state, cl, hl, P, d_state, n_groups, conv_width, chunk,
                             heads=(h0, H),
                             sum_sq=lambda ss: place.sum_model_stat(ss) / d_inner)
    if state is not None:
        conv_x = place.gather_model(new.conv[..., :cl], new.conv.ndim - 1)
        new = new._replace(conv=torch.cat([conv_x, new.conv[..., cl:]], dim=-1))
    return place.sum_model(partial_product(y, pl["w_out"])).to(x.dtype), new


def _mamba_scan(p, zxbcdt, state, d_inner, H, P, N, G, conv_width, chunk, *, heads=None,
                sum_sq=None):
    """The causal conv, the SSD recurrence (exact, or chunked) and the gated
    RMSNorm: (B, S, d_inner) in the activation dtype, and the new state.

    ``heads`` ``(h0, n_heads)``: the H heads are ``[h0, h0 + H)`` of the
    mixer's ``n_heads`` (each reads group ``h // (n_heads / G)``), and
    ``sum_sq`` maps the float32 sum of squares of these heads' columns to
    the norm's mean over the whole inner width; both ``None``: the whole
    mixer."""
    act, dev = zxbcdt.dtype, zxbcdt.device
    B, S, _ = zxbcdt.shape
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * G * N, H], dim=-1)
    conv_state = state.conv if state is not None else torch.zeros(
        (B, conv_width - 1, xbc.shape[-1]), dtype=act, device=dev)
    xbc, new_conv = _causal_conv(xbc, p["conv"].to(act), conv_state)
    xs, Bc, Cc = torch.split(xbc, [d_inner, G * N, G * N], dim=-1)
    xs = xs.reshape(B, S, H, P)
    if heads is None:
        rep = H // G
        Bh = torch.repeat_interleave(Bc.reshape(B, S, G, N), rep, dim=2).float()  # (B, S, H, N)
        Ch = torch.repeat_interleave(Cc.reshape(B, S, G, N), rep, dim=2).float()
    else:
        group = torch.arange(heads[0], heads[0] + H, device=dev) // (heads[1] // G)
        Bh, Ch = (t.reshape(B, S, G, N)[:, :, group].float() for t in (Bc, Cc))

    dt = torch.logaddexp(dt.float() + p["dt_bias"].float(), torch.zeros((), device=dev))
    A = -torch.exp(p["A_log"].float())  # (H,) negative
    loga = dt * A  # (B, S, H) log decay per step, <= 0
    xdt = xs.float() * dt[..., None]  # dt-weighted input

    st = state.ssm if state is not None else torch.zeros((B, H, P, N), dtype=torch.float32,
                                                        device=dev)
    if state is not None and S <= 4:  # exact recurrence (decode)
        ys = []
        for t in range(S):
            st = (st * torch.exp(loga[:, t])[..., None, None]
                  + xdt[:, t][..., None] * Bh[:, t][..., None, :])
            ys.append(torch.einsum("bhpn,bhn->bhp", st, Ch[:, t]))
        y = torch.stack(ys, dim=1).reshape(B, S, H * P)
    else:  # chunked parallel form
        if S % chunk:
            raise ValueError(f"seq {S} must be a multiple of chunk {chunk}")
        nC = S // chunk

        def heads_first(t):  # (B, S, H, ...) -> (B, H, nC, L, ...)
            t = t.reshape(B, nC, chunk, *t.shape[2:])
            return t.permute(0, 3, 1, 2, *range(4, t.ndim))

        xc, bc, cc, lc = heads_first(xdt), heads_first(Bh), heads_first(Ch), heads_first(loga)
        cum = torch.cumsum(lc, dim=-1)  # inclusive, (B, H, nC, L)
        tot = cum[..., -1]  # (B, H, nC)

        # intra-chunk: scores_ts = exp(cum_t - cum_s) * (C_t . B_s), s <= t
        decay = cum[..., :, None] - cum[..., None, :]  # <= 0 on and below the diagonal
        tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
        # mask BEFORE exp: above-diagonal entries are positive and would overflow
        sc = (cc @ bc.transpose(-1, -2)) * torch.exp(
            torch.where(tri, decay, torch.full_like(decay, float("-inf"))))
        intra = sc @ xc

        q_in = cc * torch.exp(cum)[..., None]  # queries against the incoming state
        k_out = bc * torch.exp(tot[..., None, None] - cum[..., None])  # into the outgoing state
        inters = []
        for c in range(nC):
            inters.append(q_in[:, :, c] @ st.transpose(-1, -2))
            st = (st * torch.exp(tot[:, :, c])[..., None, None]
                  + xc[:, :, c].transpose(-1, -2) @ k_out[:, :, c])
        y = (intra + torch.stack(inters, dim=2)).permute(0, 2, 3, 1, 4).reshape(B, S, H * P)

    y = y + (p["D"].float()[None, None, :, None] * xs.float()).reshape(B, S, H * P)
    # gated RMSNorm
    y = y.to(act) * F.silu(z)
    if sum_sq is None:
        var = y.float().square().mean(dim=-1, keepdim=True)
    else:
        var = sum_sq(y.float().square().sum(dim=-1, keepdim=True))
    y = (y * torch.rsqrt(var + 1e-6)).to(act) * p["norm_w"].to(act)
    return y, MambaState(ssm=st, conv=new_conv)
