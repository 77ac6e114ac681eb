"""State-space blocks: Mamba1 (falcon-mamba) and Mamba2/SSD (the zamba2
trunk).  The port of ``repro/models/ssm.py``.

Scan strategies, as the reference's:

* ``linear_scan_ref`` — the per-timestep recurrence (the oracle; O(S)
  steps, a Python loop over S here as the reference's ``lax.scan``);
* Mamba1 chunked — a scan inside fixed-size chunks with a sequential carry
  across chunks (bounds the (B, Q, dI, N) working set).  The reference
  used ``lax.associative_scan`` inside a chunk, which has no eager PyTorch
  counterpart; the port computes the same recurrence ``h_t = a_t h_{t-1} +
  b_t`` by Hillis-Steele doubling (log2 Q passes of ``(a, b) <- (a *
  a_shift, b + a * b_shift)``), then adds ``pa * h_prev``.  The rounding
  differs from jax's scan tree but stays within float32 tolerance;
* Mamba2 SSD — the matrix ("attention-like") chunk form: intra-chunk by
  (Q x Q) decay-masked score products, inter-chunk by a carried state.
  The decay exponentiates the causal log-decay differences only (the
  others are set to -inf first): the reference masks after ``exp``, whose
  non-causal entries overflow to inf once a chunk's decay passes e^88
  (128 steps of dt ~ 0.8 do), and its backward then multiplies 0 by inf,
  so its gradient at a full chunk is NaN.  The forward values are the
  same.

Both carry exact single-step ``*_decode`` updates for serving (O(1)
state).  The decode functions return the new state; ``serving`` writes it
into the cache in place.

Parameters keep the reference's dict layout and dtypes: the projections
in ``cfg.dtype``, the conv, ``dt_proj``, ``dt_bias``, ``a_log`` and
``d_skip`` in float32.  The casts are the reference's to the letter (the
conv runs in float32 and its output goes back to ``x.dtype`` before
``x_proj``; ``b``, ``c`` and ``dt`` are float32; ``y`` goes to ``x.dtype``
before ``out_proj``).  ``*_init`` draws every weight with the caller's
``torch.Generator`` on its device, stacked over a leading ``lead`` shape
(the layer axis of ``lm``'s parameter-stacked layout).  No hand-written
kernel runs here: the reference's scan is plain jnp outside any Pallas
kernel.  The activation-sharding constraints (``dist.constrain``) sit at
the reference's sites and act on DTensors only.  On DTensors the causal
conv and the scans run on each device's shards
(``dist.act_sharding.on_shards``): batch over the data-parallel axes,
channels (Mamba1) or heads (Mamba2) over "model" where it divides them;
both are independent across those dims.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.act_sharding import (constrain, linear, on_shards,
                                           sharded)
from repro_torch.dist.sharding import reshape

from .layers import dense_init, rmsnorm, rmsnorm_init, torch_dtype

Params = Dict[str, object]

SSM_CHUNK = 128


# --- causal depthwise conv (K taps) -------------------------------------------

def conv1d_causal(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """x: (B,S,C), w: (C,K), b: (C,).  y_t = sum_k w[:,k] x_{t-K+1+k}."""
    if not sharded(x, w, b):
        return _conv1d_causal(x, w, b)
    chan = ("dp", None, "tp")
    return on_shards(_conv1d_causal, (x, w, b), (chan, ("tp", None), ("tp",)),
                     chan, {"dp": x.shape[0], "tp": x.shape[2]})


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    k = w.shape[1]
    out = x * w[None, None, :, -1]
    for i in range(k - 1):
        shift = k - 1 - i
        xs = F.pad(x, (0, 0, shift, 0))[:, :x.shape[1]]
        out = out + xs * w[None, None, :, i]
    return out + b[None, None, :]


def conv1d_step(window: torch.Tensor, xt: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """window: (B,K-1,C) past inputs; xt: (B,C) new input.
    Returns (y (B,C), new window)."""
    if not sharded(window, xt, w, b):
        return _conv1d_step(window, xt, w, b)
    chan = ("dp", None, "tp")
    return on_shards(_conv1d_step, (window, xt, w, b),
                     (chan, ("dp", "tp"), ("tp", None), ("tp",)),
                     (("dp", "tp"), chan),
                     {"dp": xt.shape[0], "tp": xt.shape[1]})


def _conv1d_step(window, xt, w, b):
    full = torch.cat([window, xt[:, None, :]], dim=1)      # (B,K,C)
    y = torch.einsum("bkc,ck->bc", full, w) + b[None, :]
    return y, full[:, 1:]


# --- linear recurrence h_t = a_t h_{t-1} + b_t ----------------------------------

def linear_scan_ref(a: torch.Tensor, b: torch.Tensor,
                    h0: torch.Tensor) -> torch.Tensor:
    """Oracle: a,b (B,S,...), h0 (B,...) -> h (B,S,...), step by step."""
    h = h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def _doubling_scan(a: torch.Tensor,
                   b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the affine maps ``h -> a_t h + b_t`` along axis 1
    by Hillis-Steele doubling: returns ``(pa, pb)`` with ``h_t = pa_t h_{-1}
    + pb_t``."""
    q = a.shape[1]
    d = 1
    while d < q:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, b


def linear_scan_chunked(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                        chunk: int = SSM_CHUNK) -> torch.Tensor:
    """Chunked scan; exact (same recurrence, float32).  Falls back to the
    stepwise form when ``S % chunk != 0``, as the reference's does."""
    s = a.shape[1]
    if s % chunk != 0:
        return linear_scan_ref(a, b, h0)
    h = h0
    hs = []
    for c0 in range(0, s, chunk):
        pa, pb = _doubling_scan(a[:, c0:c0 + chunk], b[:, c0:c0 + chunk])
        hc = pb + pa * h[:, None]
        h = hc[:, -1]
        hs.append(hc)
    return torch.cat(hs, dim=1)


# =============================================================================
# Mamba1
# =============================================================================

def mamba1_init(gen: torch.Generator, cfg,
                lead: Tuple[int, ...] = ()) -> Params:
    d, di, n, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dtr
    dt, dev, f32 = torch_dtype(cfg), gen.device, torch.float32
    a_log = torch.log(torch.arange(1, n + 1, dtype=f32, device=dev))
    return {
        "in_proj": dense_init(gen, lead + (d, 2 * di), dt),
        "conv_w": torch.randn(lead + (di, cfg.d_conv), generator=gen,
                              device=dev, dtype=f32).mul_(0.2),
        "conv_b": torch.zeros(lead + (di,), dtype=f32, device=dev),
        "x_proj": dense_init(gen, lead + (di, dtr + 2 * n), dt),
        "dt_proj": dense_init(gen, lead + (dtr, di), f32),
        "dt_bias": torch.full(lead + (di,), -4.6, dtype=f32, device=dev),
        "a_log": a_log.expand(lead + (di, n)).clone(),
        "d_skip": torch.ones(lead + (di,), dtype=f32, device=dev),
        "out_proj": dense_init(gen, lead + (di, d), dt),
    }


def _mamba1_front(p: Params, cfg, x: torch.Tensor):
    """The pre-conv input (for the decode window) and the scan inputs
    ``(a, b, c_in, z, xin)``."""
    n, dtr = cfg.ssm_state, cfg.dtr
    xin_raw, z = linear(x, p["in_proj"]).chunk(2, dim=-1)  # (B,S,dI) each
    xin = F.silu(conv1d_causal(xin_raw.float(), p["conv_w"],
                               p["conv_b"])).to(x.dtype)
    proj = linear(xin, p["x_proj"])                        # (B,S,dtr+2N)
    dt_raw = proj[..., :dtr]
    b_in = proj[..., dtr:dtr + n].float()
    c_in = proj[..., dtr + n:].float()
    dt = F.softplus(linear(dt_raw.float(), p["dt_proj"])
                    + p["dt_bias"])                        # (B,S,dI)
    a_mat = -torch.exp(p["a_log"])                         # (dI,N)
    a = torch.exp(dt[..., None] * a_mat[None, None])       # (B,S,dI,N)
    b = (dt * xin.float())[..., None] * b_in[..., None, :]
    return xin_raw, (a, b, c_in, z, xin)


def _mamba1_scan_inputs(p: Params, cfg, x: torch.Tensor):
    """Shared front end: returns (a, b, c_t, z, xin) for the recurrence."""
    return _mamba1_front(p, cfg, x)[1]


def mamba1_apply(p: Params, cfg, x: torch.Tensor, chunked: bool = True,
                 return_state: bool = False):
    bsz = x.shape[0]
    di, n = cfg.d_inner, cfg.ssm_state
    xin_raw, (a, b, c_in, z, xin) = _mamba1_front(p, cfg, x)
    a = constrain(a, "dp", None, "tp", None)
    b = constrain(b, "dp", None, "tp", None)
    h0 = constrain(x.new_zeros((bsz, di, n), dtype=torch.float32),
                   "dp", "tp", None)
    per_chan = ("dp", None, "tp", None)
    ys, h_last = on_shards(
        functools.partial(_mamba1_scan, chunked=chunked),
        (a, b, h0, c_in),
        (per_chan, per_chan, ("dp", "tp", None), ("dp", None, None)),
        (("dp", None, "tp"), ("dp", "tp", None)), {"dp": bsz, "tp": di})
    y = ys + p["d_skip"][None, None] * xin.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = linear(y, p["out_proj"])
    if return_state:
        # copies, not views: a view of the last step would keep the whole
        # (B,S,dI,N) history alive as long as the cache
        k = cfg.d_conv - 1
        window = xin_raw[:, -k:].float().clone()           # (B,K-1,dI)
        return out, {"conv": window, "h": h_last}
    return out


def _mamba1_scan(a, b, h0, c_in, chunked: bool):
    """The recurrence's read-out ``sum_n h·c`` (B,S,dI) and its last
    state (a copy, not a view: a view would keep the whole (B,S,dI,N)
    history alive as long as the cache)."""
    h = (linear_scan_chunked if chunked else linear_scan_ref)(a, b, h0)
    return torch.einsum("bsdn,bsn->bsd", h, c_in), h[:, -1].clone()


def _read_out(eq: str, h: torch.Tensor, c_in: torch.Tensor) -> torch.Tensor:
    """A decode step's ``sum_n h·c`` (``eq``: the state (B, C, ..., N)
    against ``c_in`` (B, N)), on each device's batch rows and channels."""
    if not sharded(h, c_in):
        return torch.einsum(eq, h, c_in)
    state = ("dp", "tp") + (None,) * (h.dim() - 2)
    return on_shards(functools.partial(torch.einsum, eq), (h, c_in),
                     (state, ("dp", None)), state[:-1],
                     {"dp": h.shape[0], "tp": h.shape[1]})


def mamba1_init_cache(cfg, batch: int, device=None) -> Params:
    di, n = cfg.d_inner, cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, di),
                            dtype=torch.float32, device=device),
        "h": torch.zeros((batch, di, n), dtype=torch.float32,
                         device=device),
    }


def mamba1_decode(p: Params, cfg, x: torch.Tensor, cache: Params):
    """x: (B,1,d) -> (out (B,1,d), new cache).  Exact one-step
    recurrence."""
    n, dtr = cfg.ssm_state, cfg.dtr
    xin, z = linear(x[:, 0], p["in_proj"]).chunk(2, dim=-1)  # (B,dI)
    xc, conv = conv1d_step(cache["conv"], xin.float(), p["conv_w"],
                           p["conv_b"])
    xc = F.silu(xc)
    proj = linear(xc.to(x.dtype), p["x_proj"])
    dt_raw = proj[..., :dtr]
    b_in = proj[..., dtr:dtr + n].float()
    c_in = proj[..., dtr + n:].float()
    dt = F.softplus(linear(dt_raw.float(), p["dt_proj"])
                    + p["dt_bias"])                        # (B,dI)
    a_mat = -torch.exp(p["a_log"])
    a = torch.exp(dt[..., None] * a_mat[None])             # (B,dI,N)
    b = (dt * xc)[..., None] * b_in[:, None, :]
    h = a * cache["h"] + b
    y = _read_out("bdn,bn->bd", h, c_in) + p["d_skip"][None] * xc
    y = (y * F.silu(z.float())).to(x.dtype)
    return linear(y, p["out_proj"])[:, None], {"conv": conv, "h": h}


# =============================================================================
# Mamba2 (SSD)
# =============================================================================

def mamba2_init(gen: torch.Generator, cfg,
                lead: Tuple[int, ...] = ()) -> Params:
    """Projections for z / x / B / C / dt are separate weights (not one
    concatenated in_proj), as the reference's."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h = cfg.n_ssm_heads
    dt, dev, f32 = torch_dtype(cfg), gen.device, torch.float32

    def conv_w(c):
        return torch.randn(lead + (c, cfg.d_conv), generator=gen,
                           device=dev, dtype=f32).mul_(0.2)

    def zeros(c):
        return torch.zeros(lead + (c,), dtype=f32, device=dev)

    p = {
        "in_z": dense_init(gen, lead + (d, di), dt),
        "in_x": dense_init(gen, lead + (d, di), dt),
        "in_b": dense_init(gen, lead + (d, n), dt),
        "in_c": dense_init(gen, lead + (d, n), dt),
        "in_dt": dense_init(gen, lead + (d, h), dt),
    }
    p.update({
        "conv_w_x": conv_w(di), "conv_b_x": zeros(di),
        "conv_w_b": conv_w(n), "conv_b_b": zeros(n),
        "conv_w_c": conv_w(n), "conv_b_c": zeros(n),
        "dt_bias": zeros(h),
        "a_log": zeros(h),                                 # A = -exp(0) = -1
        "d_skip": torch.ones(lead + (h,), dtype=f32, device=dev),
        "norm": rmsnorm_init(di, lead, dev),
        "out_proj": dense_init(gen, lead + (di, d), dt),
    })
    return p


def _mamba2_front(p: Params, cfg, x: torch.Tensor):
    z = linear(x, p["in_z"])
    dt_raw = linear(x, p["in_dt"])                         # (B,S,H)
    xin = F.silu(conv1d_causal(linear(x, p["in_x"]).float(), p["conv_w_x"],
                               p["conv_b_x"]))
    b_in = F.silu(conv1d_causal(linear(x, p["in_b"]).float(), p["conv_w_b"],
                                p["conv_b_b"]))
    c_in = F.silu(conv1d_causal(linear(x, p["in_c"]).float(), p["conv_w_c"],
                                p["conv_b_c"]))
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = torch.exp(-torch.exp(p["a_log"])[None, None] * dt)  # (B,S,H) decay
    return xin, b_in, c_in, dt, a, z


def _mamba2_out(p: Params, cfg, x: torch.Tensor, y: torch.Tensor,
                xh: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The skip, the gate, the norm and the output projection."""
    bsz, s = x.shape[:2]
    y = y + p["d_skip"][None, None, :, None] * xh
    y = reshape(y, bsz, s, -1)
    y = y * F.silu(z.float())
    y = rmsnorm(p["norm"], y.to(x.dtype), cfg.norm_eps)
    return linear(y, p["out_proj"])


def mamba2_apply(p: Params, cfg, x: torch.Tensor, chunk: int = SSM_CHUNK,
                 return_state: bool = False):
    """SSD matrix-form chunked scan."""
    bsz, s, _ = x.shape
    nh, pdim, n = cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    xin, b_in, c_in, dt, a, z = _mamba2_front(p, cfg, x)
    xin = constrain(xin, "dp", None, "tp")
    xh = reshape(xin, bsz, s, nh, pdim)                    # (B,S,H,P)
    xdt = xh * dt[..., None]                               # dt-scaled input
    if s % chunk != 0:
        chunk = s                                          # single chunk
    la = torch.log(torch.clamp(a, min=1e-30))
    h = constrain(x.new_zeros((bsz, nh, pdim, n), dtype=torch.float32),
                  "dp", "tp", None, None)
    per_head = ("dp", None, "tp", None)
    y, h = on_shards(functools.partial(_ssd, chunk=chunk),
                     (xdt, b_in, c_in, la, h),
                     (per_head, ("dp", None, None), ("dp", None, None),
                      ("dp", None, "tp"), ("dp", "tp", None, None)),
                     (per_head, ("dp", "tp", None, None)),
                     {"dp": bsz, "tp": nh})
    out = _mamba2_out(p, cfg, x, y, xh, z)
    if return_state:
        k = cfg.d_conv - 1
        return out, {
            "conv_x": linear(x[:, -k:], p["in_x"]).float(),
            "conv_b": linear(x[:, -k:], p["in_b"]).float(),
            "conv_c": linear(x[:, -k:], p["in_c"]).float(),
            "h": h,
        }
    return out


def _ssd(xdt, b_in, c_in, la, h, chunk: int):
    """The SSD chunk loop: (y (B,S,H,P), the last state (B,H,P,N))."""
    s = xdt.shape[1]
    qi = torch.arange(chunk, device=xdt.device)
    mask = (qi[:, None] >= qi[None, :])[None, :, :, None]
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        xd, bb, cc = xdt[:, sl], b_in[:, sl], c_in[:, sl]
        lac = torch.cumsum(la[:, sl], dim=1)               # (B,Q,H) inclusive
        # intra-chunk
        scores = torch.einsum("bin,bjn->bij", cc, bb)      # (B,Q,Q)
        # exp of the causal differences only (B,Q,Q,H): above the diagonal
        # they are positive and pass float32's ~88 in a chunk of 128 steps
        # of dt ~ 0.8, and the reference's where(mask, exp(d), 0) then
        # back-propagates 0 * inf = NaN; the values are the same
        diff = lac[:, :, None] - lac[:, None, :, :]
        decay = torch.exp(diff.masked_fill(~mask, float("-inf")))
        y_intra = torch.einsum("bij,bijh,bjhp->bihp", scores, decay, xd)
        # inter-chunk (contribution of the carried state)
        y_inter = torch.einsum("bin,bih,bhpn->bihp", cc, torch.exp(lac), h)
        # chunk summary -> next carry
        tail = torch.exp(lac[:, -1:, :] - lac)             # (B,Q,H)
        s_c = torch.einsum("bjn,bjh,bjhp->bhpn", bb, tail, xd)
        h = h * torch.exp(lac[:, -1])[..., None, None] + s_c
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h                         # (B,S,H,P)


def mamba2_apply_ref(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Stepwise-oracle SSD (same front end, per-token recurrence)."""
    bsz, s, _ = x.shape
    nh, pdim, n = cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    xin, b_in, c_in, dt, a, z = _mamba2_front(p, cfg, x)
    xh = xin.reshape(bsz, s, nh, pdim)
    xdt = xh * dt[..., None]
    b_full = b_in[:, :, None, None, :] * xdt[..., None]    # (B,S,H,P,N)
    a_full = a[..., None, None].expand(bsz, s, nh, pdim, n)
    h = linear_scan_ref(a_full, b_full,
                        torch.zeros((bsz, nh, pdim, n), dtype=torch.float32,
                                    device=x.device))
    y = torch.einsum("bshpn,bsn->bshp", h, c_in)
    return _mamba2_out(p, cfg, x, y, xh, z)


def mamba2_init_cache(cfg, batch: int, device=None) -> Params:
    di, n = cfg.d_inner, cfg.ssm_state
    k = cfg.d_conv - 1

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {
        "conv_x": zeros(batch, k, di),
        "conv_b": zeros(batch, k, n),
        "conv_c": zeros(batch, k, n),
        "h": zeros(batch, cfg.n_ssm_heads, cfg.ssm_headdim, n),
    }


def mamba2_decode(p: Params, cfg, x: torch.Tensor, cache: Params):
    bsz = x.shape[0]
    nh, pdim = cfg.n_ssm_heads, cfg.ssm_headdim
    xt = x[:, 0]
    z = linear(xt, p["in_z"])
    dt_raw = linear(xt, p["in_dt"])
    xr, conv_x = conv1d_step(cache["conv_x"], linear(xt, p["in_x"]).float(),
                             p["conv_w_x"], p["conv_b_x"])
    br, conv_b = conv1d_step(cache["conv_b"], linear(xt, p["in_b"]).float(),
                             p["conv_w_b"], p["conv_b_b"])
    cr, conv_c = conv1d_step(cache["conv_c"], linear(xt, p["in_c"]).float(),
                             p["conv_w_c"], p["conv_b_c"])
    xin = reshape(F.silu(xr), bsz, nh, pdim)
    b_in = F.silu(br)
    c_in = F.silu(cr)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])          # (B,H)
    a = torch.exp(-torch.exp(p["a_log"])[None] * dt)        # (B,H)
    xdt = xin * dt[..., None]
    h = cache["h"] * a[..., None, None] \
        + b_in[:, None, None, :] * xdt[..., None]
    y = _read_out("bhpn,bn->bhp", h, c_in) \
        + p["d_skip"][None, :, None] * xin
    y = reshape(y, bsz, -1)
    y = y * F.silu(z.float())
    y = rmsnorm(p["norm"], y.to(x.dtype), cfg.norm_eps)
    return linear(y, p["out_proj"])[:, None], {
        "conv_x": conv_x, "conv_b": conv_b, "conv_c": conv_c, "h": h}
