"""SSM mixers: RWKV-6 ("Finch") time-mix and Mamba-1 selective SSM.

The port of the reference's ``models/ssm.py``, the same functions under the
same names. Both are linear-recurrence mixers with O(1) decode state, which
the decode cache carries.

RWKV-6 (arXiv:2404.05892), per head h with head_dim n:
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (S: n x n)
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with data-dependent decay w_t = exp(-exp(x_t W_w lora)) and token-shift mixing
on all branch inputs.

Mamba-1 (selective scan), d_inner = expand*d:
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;  y_t = C_t h_t + D x_t
with causal depthwise conv + SiLU in front and a SiLU gate behind.

The recurrences are plain PyTorch: the reference has no kernel for them (its
scans are ``lax.scan``). Each runs a Python loop over time whose step
launches only what depends on the state, two kernels a token: everything else
(RWKV's bonus term ``r (u k^T v)`` and its outer products ``k^T v``, Mamba's
discretised ``exp(dt A)`` and ``dt B x``) is formed outside the loop, a chunk
of ``TIME_CHUNK`` steps at a time, so that no (S, ..., n, n) tensor is held
whole. The casts follow the reference's step by step (the states and the scan
in f32, the outputs cast back to the compute dtype where it casts them);
only the order of a few f32 sums differs.

Autograd refuses those loops' ``out=`` writes. A forward that autograd
records (training) steps the same two products out of place instead, a
``TIME_CHUNK`` of steps inside one ``torch.utils.checkpoint``, so that the
backward pass keeps only the state at each chunk's start and recomputes the
chunk: the reference's ``_chunked_time_scan``, which gives the same values
as a plain scan.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec, recomputed, records


def _sigmoid(x):
    """The logistic as ``1 / (1 + exp(-x))``, each op in ``x``'s dtype: in
    bf16 the reference's ``jax.nn.sigmoid``/``silu`` round there on XLA's
    CPU (bit for bit), and RWKV's output norm amplifies a one-ulp difference
    in its gate ``g`` at every layer."""
    return 1 / (1 + torch.exp(-x))


def _silu(x):
    return x * _sigmoid(x)


# ================================================================== RWKV-6

RWKV_LORA = 64  # decay/mix lora rank (7B scale)
TIME_CHUNK = 256  # steps whose state-free terms are formed at once (bounds their memory)


def rwkv6_specs(cfg: ModelConfig, prefix=()) -> dict:
    d, h, n = cfg.d_model, cfg.n_heads, cfg.head_dim
    ax = tuple(prefix)
    return {
        "mix": ParamSpec((5, d), ax + (None, "embed"), init="small"),  # r,k,v,w,g shifts
        "wr": ParamSpec((d, h, n), ax + ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, h, n), ax + ("embed", "heads", "head_dim")),
        "wv": ParamSpec((d, h, n), ax + ("embed", "heads", "head_dim")),
        "wg": ParamSpec((d, h, n), ax + ("embed", "heads", "head_dim")),
        "w_decay_a": ParamSpec((d, RWKV_LORA), ax + ("embed", "lora"), init="small"),
        "w_decay_b": ParamSpec((RWKV_LORA, d), ax + ("lora", "embed"), init="small"),
        "decay_base": ParamSpec((h, n), ax + ("heads", "head_dim"), init="zeros"),
        "bonus_u": ParamSpec((h, n), ax + ("heads", "head_dim"), init="small"),
        "wo": ParamSpec((h, n, d), ax + ("heads", "head_dim", "embed")),
        "ln_x": ParamSpec((d,), ax + ("embed",), init="ones"),
    }


def _token_shift(x, prev):
    """Shift by one: position t sees t-1; position 0 sees `prev` (decode carry)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _rwkv6_inputs(params, x, prev, cfg):
    b, s, d = x.shape
    h, n = cfg.n_heads, cfg.head_dim
    xx = _token_shift(x, prev)
    mix = params["mix"]  # (5, d)
    xr, xk, xv, xw, xg = (x + mix[i] * (xx - x) for i in range(5))
    r = torch.einsum("bsd,dhn->bshn", xr, params["wr"])
    k = torch.einsum("bsd,dhn->bshn", xk, params["wk"])
    v = torch.einsum("bsd,dhn->bshn", xv, params["wv"])
    g = _silu(torch.einsum("bsd,dhn->bshn", xg, params["wg"]))
    # data-dependent decay in (0, 1): exp(-exp(.)), the sum taken in the compute dtype
    dd = torch.tanh(xw @ params["w_decay_a"]) @ params["w_decay_b"]  # (b, s, d)
    w = torch.exp(-torch.exp((params["decay_base"].reshape(1, 1, h, n) + dd.reshape(b, s, h, n)).float()))
    return r, k, v, g, w


def _wkv_scan(r, k, v, w, u, state):
    """Linear recurrence over time. Shapes: (B,S,H,N) f32; state (B,H,N,N) f32
    (not written: the scan steps a copy). Returns (outs (B,S,H,N), state).

    The reference's step reads ``r_t (S_{t-1} + u k_t^T v_t)``; here its two
    terms are taken apart: the bonus ``(r_t . u k_t) v_t`` for every step at
    once, and in the loop ``r_t S_{t-1}`` (one batched product) and the
    update ``k_t^T v_t + w_t S_{t-1}`` (one ``addcmul`` over a chunk's outer
    products)."""
    b, s, h, n = r.shape
    bonus = (r * u * k).sum(-1, keepdim=True) * v  # (B,S,H,N)
    rt = r.permute(1, 0, 2, 3).reshape(s, b * h, 1, n)  # time-major rows
    kt = k.permute(1, 0, 2, 3).reshape(s, b * h, n, 1)
    vt = v.permute(1, 0, 2, 3).reshape(s, b * h, 1, n)
    wt = w.permute(1, 0, 2, 3).reshape(s, b * h, n, 1)
    if records(r, k, v, w, state):
        st, chunks = state.reshape(b * h, n, n), []
        for c0 in range(0, s, TIME_CHUNK):
            c1 = min(s, c0 + TIME_CHUNK)
            o, st = recomputed(_wkv_steps, st, rt[c0:c1], kt[c0:c1], vt[c0:c1], wt[c0:c1])
            chunks.append(o)
        outs = torch.cat(chunks).reshape(s, b, h, n).permute(1, 0, 2, 3) + bonus
        return outs, st.reshape(b, h, n, n)
    st = state.reshape(b * h, n, n).clone()
    outs = torch.empty((s, b * h, 1, n), dtype=torch.float32, device=r.device)
    for c0 in range(0, s, TIME_CHUNK):
        c1 = min(s, c0 + TIME_CHUNK)
        kv = kt[c0:c1] * vt[c0:c1]  # (chunk, B*H, N, N) outer products
        for t in range(c0, c1):
            torch.bmm(rt[t], st, out=outs[t])
            torch.addcmul(kv[t - c0], wt[t], st, out=st)
    outs = outs.reshape(s, b, h, n).permute(1, 0, 2, 3) + bonus
    return outs, st.reshape(b, h, n, n)


def _wkv_steps(st, rt, kt, vt, wt):
    """The served loop's two products a step, out of place: returns (outs
    (chunk, B*H, 1, N), the state after the chunk)."""
    kv = kt * vt
    outs = []
    for t in range(rt.shape[0]):
        outs.append(torch.bmm(rt[t], st))
        st = torch.addcmul(kv[t], wt[t], st)
    return torch.stack(outs), st


def rwkv6_apply(params, x, cfg: ModelConfig, state=None, prev_x=None):
    """Full-sequence time-mix. Returns (out, (new_state, last_x))."""
    b, s, d = x.shape
    h, n = cfg.n_heads, cfg.head_dim
    if prev_x is None:
        prev_x = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    if state is None:
        state = torch.zeros((b, h, n, n), dtype=torch.float32, device=x.device)
    r, k, v, g, w = _rwkv6_inputs(params, x, prev_x, cfg)
    u = params["bonus_u"].float()
    outs, state = _wkv_scan(r.float(), k.float(), v.float(), w, u, state)
    o = (outs.to(x.dtype) * g).reshape(b, s, h * n)
    # group-norm-ish output norm (ln_x), then project
    o = o * torch.rsqrt((o.float() ** 2).mean(-1, keepdim=True) + 1e-5).to(x.dtype)
    o = o * params["ln_x"]
    out = torch.einsum("bshn,hnd->bsd", o.reshape(b, s, h, n), params["wo"])
    return out, (state, x[:, -1, :])


def rwkv6_decode(params, x, cache, cfg: ModelConfig):
    """x: (B, 1, d). cache: {"state": (B,H,N,N) f32, "prev_x": (B,d)}, written
    in place (the reference returns a new cache). Returns (out, cache)."""
    out, (state, last_x) = rwkv6_apply(params, x, cfg, cache["state"], cache["prev_x"])
    cache["state"].copy_(state)
    cache["prev_x"].copy_(last_x)
    return out, cache


def rwkv6_cache_spec(cfg: ModelConfig, batch: int, dtype):
    h, n, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    return {
        "state": ((batch, h, n, n), ("batch", "heads", None, None), torch.float32),
        "prev_x": ((batch, d), ("batch", None), dtype),
    }


# ================================================================== Mamba-1


def mamba_d_inner(cfg: ModelConfig) -> int:
    return cfg.mamba_expand * cfg.d_model


def mamba_specs(cfg: ModelConfig, prefix=()) -> dict:
    d = cfg.d_model
    di = mamba_d_inner(cfg)
    ns, nc = cfg.mamba_d_state, cfg.mamba_d_conv
    dt_rank = max(16, d // 16)
    ax = tuple(prefix)
    return {
        "w_in": ParamSpec((d, 2 * di), ax + ("embed", "mlp")),
        "conv_w": ParamSpec((nc, di), ax + (None, "mlp"), init="small"),
        "conv_b": ParamSpec((di,), ax + ("mlp",), init="zeros"),
        "w_x": ParamSpec((di, dt_rank + 2 * ns), ax + ("mlp", None)),
        "w_dt": ParamSpec((dt_rank, di), ax + ("lora", "mlp"), init="small"),
        "dt_bias": ParamSpec((di,), ax + ("mlp",), init="small"),
        "a_log": ParamSpec((di, ns), ax + ("mlp", None), init="small"),
        "d_skip": ParamSpec((di,), ax + ("mlp",), init="ones"),
        "w_out": ParamSpec((di, d), ax + ("mlp", "embed")),
    }


def _mamba_conv_full(xz, conv_w, conv_b, prev):
    """Causal depthwise conv over time. xz: (B,S,di); prev: (B,nc-1,di). The
    taps are summed in order 0..nc-1 in the compute dtype, then the bias."""
    nc = conv_w.shape[0]
    s = xz.shape[1]
    xpad = torch.cat([prev, xz], dim=1)  # (B, S+nc-1, di)
    out = xpad[:, 0:s, :] * conv_w[0][None, None, :]
    for i in range(1, nc):
        out = out + xpad[:, i:i + s, :] * conv_w[i][None, None, :]
    return out + conv_b, xpad[:, -(nc - 1):, :]


def _mamba_core(params, u, cfg, h0):
    """u: (B,S,di) post-conv post-silu; h0 (B,di,ns) f32 (not written).
    Returns (y, h_final).

    The reference discretises inside its step; here ``exp(dt_t A)`` and
    ``dt_t B_t u_t`` (f32, the same products in the same order) are formed a
    chunk of steps at a time, and the loop runs ``h = da_t h + dbu_t`` (one
    ``addcmul``) and ``y_t = h C_t`` (one batched product)."""
    b, s, di = u.shape
    ns = cfg.mamba_d_state
    dt_rank = params["w_dt"].shape[0]
    proj = torch.einsum("bsd,de->bse", u, params["w_x"])
    dt_in, b_in, c_in = proj[..., :dt_rank], proj[..., dt_rank:dt_rank + ns], proj[..., dt_rank + ns:]
    dt = F.softplus(torch.einsum("bsr,rd->bsd", dt_in, params["w_dt"]) + params["dt_bias"])
    a = -torch.exp(params["a_log"].float())  # (di, ns)
    dtt = dt.float().permute(1, 0, 2)[..., None]  # (S,B,di,1), time-major
    bt = b_in.float().permute(1, 0, 2)[:, :, None, :]  # (S,B,1,ns)
    ut = u.float().permute(1, 0, 2)[..., None]  # (S,B,di,1)
    ct = c_in.float().permute(1, 0, 2)[..., None].contiguous()  # (S,B,ns,1)
    if records(dtt, bt, ut, ct, a, h0):
        h, chunks = h0, []
        for c0 in range(0, s, TIME_CHUNK):
            c1 = min(s, c0 + TIME_CHUNK)
            y, h = recomputed(_mamba_steps, h, a, dtt[c0:c1], bt[c0:c1], ut[c0:c1], ct[c0:c1])
            chunks.append(y)
        y = torch.cat(chunks)[..., 0].permute(1, 0, 2).to(u.dtype) + u * params["d_skip"]
        return y, h
    h = h0.clone()
    ys = torch.empty((s, b, di, 1), dtype=torch.float32, device=u.device)
    for c0 in range(0, s, TIME_CHUNK):
        c1 = min(s, c0 + TIME_CHUNK)
        da = torch.exp(dtt[c0:c1] * a)  # (chunk,B,di,ns)
        dbu = dtt[c0:c1] * bt[c0:c1] * ut[c0:c1]
        for t in range(c0, c1):
            torch.addcmul(dbu[t - c0], da[t - c0], h, out=h)
            torch.bmm(h, ct[t], out=ys[t])
    y = ys[..., 0].permute(1, 0, 2).to(u.dtype) + u * params["d_skip"]
    return y, h


def _mamba_steps(h, a, dtt, bt, ut, ct):
    """The served loop's discretisation and two products a step, out of
    place: returns (ys (chunk, B, di, 1), h after the chunk)."""
    da = torch.exp(dtt * a)
    dbu = dtt * bt * ut
    ys = []
    for t in range(dtt.shape[0]):
        h = torch.addcmul(dbu[t], da[t], h)
        ys.append(torch.bmm(h, ct[t]))
    return torch.stack(ys), h


def mamba_apply(params, x, cfg: ModelConfig, cache=None):
    """Full-sequence Mamba mixer. Returns (out, new_cache); ``cache`` is not
    written (see :func:`mamba_decode`)."""
    b, s, d = x.shape
    di = mamba_d_inner(cfg)
    nc = cfg.mamba_d_conv
    if cache is None:
        cache = {
            "h": torch.zeros((b, di, cfg.mamba_d_state), dtype=torch.float32, device=x.device),
            "conv": torch.zeros((b, nc - 1, di), dtype=x.dtype, device=x.device),
        }
    xz = x @ params["w_in"]
    xi, z = xz[..., :di], xz[..., di:]
    u, conv_state = _mamba_conv_full(xi, params["conv_w"], params["conv_b"], cache["conv"])
    u = _silu(u)
    y, h_f = _mamba_core(params, u, cfg, cache["h"])
    out = (y * _silu(z)) @ params["w_out"]
    return out, {"h": h_f, "conv": conv_state}


def mamba_decode(params, x, cache, cfg: ModelConfig):
    """x: (B, 1, d): the reference's ``mamba_apply`` on the cache, the new
    ``h`` and ``conv`` written into ``cache`` in place. Returns (out, cache)."""
    out, new = mamba_apply(params, x, cfg, cache)
    cache["h"].copy_(new["h"])
    cache["conv"].copy_(new["conv"])
    return out, cache


def mamba_cache_spec(cfg: ModelConfig, batch: int, dtype):
    di = mamba_d_inner(cfg)
    return {
        "h": ((batch, di, cfg.mamba_d_state), ("batch", "mlp", None), torch.float32),
        "conv": ((batch, cfg.mamba_d_conv - 1, di), ("batch", None, "mlp"), dtype),
    }


# ----------------------------------------------- RWKV-6 channel mix (FFN)


def rwkv6_cmix_specs(cfg: ModelConfig, prefix=()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    ax = tuple(prefix)
    return {
        "mix": ParamSpec((2, d), ax + (None, "embed"), init="small"),  # k, r shifts
        "wk": ParamSpec((d, f), ax + ("embed", "mlp")),
        "wv": ParamSpec((f, d), ax + ("mlp", "embed")),
        "wr": ParamSpec((d, d), ax + ("embed", "embed_out")),
    }


def rwkv6_cmix_apply(params, x, cfg: ModelConfig, prev_x=None):
    """Receptance-gated squared-relu FFN with token shift.

    Returns (out, last_x) — last_x feeds the decode-time token shift.
    """
    b, s, d = x.shape
    if prev_x is None:
        prev_x = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    xx = _token_shift(x, prev_x)
    xk = x + params["mix"][0] * (xx - x)
    xr = x + params["mix"][1] * (xx - x)
    k = torch.square(F.relu(xk @ params["wk"]))
    r = _sigmoid(xr @ params["wr"])
    return r * (k @ params["wv"]), x[:, -1, :]
