"""Full epsilon-rule LRP for ISTVT (counterpart of
istvt_tpu/interpret/full_lrp.py): relevance propagated from a one-hot at
the target logit backward through every module of the DSTTr with
conservation rules.

  generic z-rule   R_x = x * df/dx^T [R / (f(x) + eps * sign)]
    (Linear / LayerNorm-affine: the epsilon rule; residual adds split R
    by each summand's share; GELU / softmax: the gradient rule)
  bilinear split   z = A V and q k^T hand R to each operand; both halves
    are taken, so sum R_A + sum R_V = sum R_out.

The per-layer relevance of each post-softmax map, R_A, is combined with
the map's gradient as the tfe engine's transformer_attribution does,
cam_l = E_h[(grad A * R_A)+], and rolled out as interpret/lrp.py does.

Two GELUs, as in JAX: the relevance walk runs exact-erf GELU
(full_lrp.py:44,231,266); the map gradients come from
attention_maps_and_grads, whose feed-forward is fused_ff (tanh-GELU,
kernel #22) when the model's cfg has use_pallas. Everything here is plain
torch: the JAX module runs outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from istvt_tpu_torch.interpret.lrp import bias_grads, cams, eval_mode
from istvt_tpu_torch.nn.attention import self_subtract
from istvt_tpu_torch.nn.layers import gelu, linear

_EPS = 1e-9


def _safe_div(r, z):
    return r / (z + _EPS * torch.where(z >= 0, 1.0, -1.0))


def _ln_detached(norm, x, eps: float = 1e-5):
    """LayerNorm with mean and variance DETACHED: forward-identical, but
    under the z-rule it relprops as the affine map x -> (x - mu) g / s + b
    (full LayerNorm is 0-homogeneous, so the raw rule would annihilate all
    relevance; Ali et al. 2022)."""
    mu = x.mean(dim=-1, keepdim=True).detach()
    var = (x - mu).square().mean(dim=-1, keepdim=True).detach()
    return (x - mu) * torch.rsqrt(var + eps) * norm.weight + norm.bias


def zrule(f, inputs: Tuple, r_out, split: bool = False):
    """Generic relprop: R_i = x_i * vjp_f(R / (f(x) + eps))_i, the vjp by
    torch.autograd.grad of f at the saved inputs. split=True halves each
    operand's relevance (bilinear ops)."""
    xs = [x.detach().requires_grad_(True) for x in inputs]
    with torch.enable_grad():
        z = f(*xs)
        cs = torch.autograd.grad(z, xs, grad_outputs=_safe_div(r_out,
                                                               z.detach()))
    scale = 0.5 if split else 1.0
    rs = tuple(x.detach() * c * scale for x, c in zip(xs, cs))
    return rs if len(rs) > 1 else rs[0]


def _vjp(f, x, cotangents):
    """d f(x) / d x^T applied to the cotangents (f returns a tuple)."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        zs = f(x)
        (c,) = torch.autograd.grad(zs, x, grad_outputs=cotangents(zs))
    return c


def _heads(u, b, t1, s, heads):
    return u.reshape(b, t1, s, heads, -1)


def _einsums(temporal: bool):
    """(scores, PV) einsum strings of a branch."""
    if temporal:
        return "bishd,bjshd->bshij", "bshij,bjshd->bishd"
    return "btihd,btjhd->bthij", "bthij,btjhd->btihd"


def _f32_einsum(eq, a, b):
    """jnp.einsum(preferred_element_type=float32): f32 sums of the
    operands' products."""
    return torch.einsum(eq, a.float(), b.float())


def _attention_forward(fn, hn, heads, s, temporal: bool):
    """One decomposed attention branch on the normalised stream hn:
    (out, saved) with every relprop intermediate."""
    b, n, _ = hn.shape
    t1 = n // s
    qk_eq, pv_eq = _einsums(temporal)
    if temporal:
        qk = linear(hn, fn.to_qk.weight)
        v = linear(hn, fn.to_v.weight)
        inner = v.shape[-1]
        qk_sub = self_subtract(qk.reshape(b, t1, s, 2 * inner))
        q, k = qk_sub.reshape(b, n, 2 * inner).chunk(2, dim=-1)
    else:
        q, k, v = linear(hn, fn.to_qkv.weight).chunk(3, dim=-1)
        inner = v.shape[-1]
    q, k, v4 = (_heads(u, b, t1, s, heads) for u in (q, k, v))
    dots = _f32_einsum(qk_eq, q, k) * q.shape[-1] ** -0.5
    attn = dots.softmax(dim=-1)
    ctx = _f32_einsum(pv_eq, attn, v4)
    merged = ctx.reshape(b, n, inner)
    lin = fn.to_out[0]
    out = linear(merged, lin.weight, lin.bias)
    saved = {"hn": hn, "q": q, "k": k, "v4": v4, "dots": dots,
             "attn": attn, "ctx": ctx, "merged": merged}
    return out, saved


def _attention_relprop(fn, saved, r_out, heads, s, temporal: bool):
    """Relevance through one attention branch: (R_hn, R_A)."""
    hn = saved["hn"]
    b, n, _ = hn.shape
    t1 = n // s
    qk_eq, pv_eq = _einsums(temporal)
    lin = fn.to_out[0]
    r_merged = zrule(lambda m: linear(m, lin.weight, lin.bias),
                     (saved["merged"],), r_out)
    r_ctx = r_merged.reshape(saved["ctx"].shape)
    r_attn, r_v4 = zrule(lambda a, vv: _f32_einsum(pv_eq, a, vv),
                         (saved["attn"], saved["v4"]), r_ctx, split=True)
    r_dots = zrule(lambda dd: dd.softmax(dim=-1), (saved["dots"],), r_attn)
    scale = saved["q"].shape[-1] ** -0.5
    r_q, r_k = zrule(lambda qq, kk: _f32_einsum(qk_eq, qq, kk) * scale,
                     (saved["q"], saved["k"]), r_dots, split=True)

    if temporal:
        def qk_path(h):
            qk = linear(h, fn.to_qk.weight)
            qs = self_subtract(qk.reshape(b, t1, s, -1)).reshape(b, n, -1)
            return tuple(_heads(u, b, t1, s, heads)
                         for u in qs.chunk(2, dim=-1))

        def v_path(h):
            return (_heads(linear(h, fn.to_v.weight), b, t1, s, heads),)

        c_qk = _vjp(qk_path, hn, lambda z: (_safe_div(r_q, z[0].detach()),
                                            _safe_div(r_k, z[1].detach())))
        c_v = _vjp(v_path, hn, lambda z: (_safe_div(r_v4, z[0].detach()),))
        r_hn = hn * (c_qk + c_v)
    else:
        def qkv_path(h):
            return tuple(_heads(u, b, t1, s, heads) for u in
                         linear(h, fn.to_qkv.weight).chunk(3, dim=-1))

        c = _vjp(qkv_path, hn, lambda z: tuple(
            _safe_div(r, zi.detach()) for r, zi in zip((r_q, r_k, r_v4), z)))
        r_hn = hn * c
    return r_hn, r_attn


@torch.no_grad()
def dsttr_full_lrp(vit, feats, index: int = 0):
    """Instrumented DSTTr forward + epsilon-rule relevance walk.

    vit: the port's DSTTr; feats (B, T, h, w, C). Returns (rel_attns
    {'t': [...], 's': [...]} per-layer relevance of each post-softmax map
    in the public (B, H, S, T+1, T+1) / (B, H, T+1, S, S) orders, logits,
    and the per-stage relevance sums for conservation checks)."""
    b, t = feats.shape[:2]
    x, s, _ = vit.tokens(feats, pad=False)
    d = x.shape[-1]
    heads = vit.cfg.heads
    layers = vit.transformer.layers

    saved_layers = []
    for pt, ps, pf in layers:
        hn_t = _ln_detached(pt.norm, x)
        out_t, sv_t = _attention_forward(pt.fn, hn_t, heads, s, True)
        hn_s = _ln_detached(ps.norm, out_t)
        out_s, sv_s = _attention_forward(ps.fn, hn_s, heads, s, False)
        x_attn = out_s + x
        hn_f = _ln_detached(pf.norm, x_attn)
        fc1, fc2 = pf.fn.net[0], pf.fn.net[3]
        h1 = linear(hn_f, fc1.weight, fc1.bias)
        g1 = gelu(h1)
        f_out = linear(g1, fc2.weight, fc2.bias)
        saved_layers.append({
            "x_in": x, "hn_t": hn_t, "out_t": out_t, "sv_t": sv_t,
            "hn_s": hn_s, "out_s": out_s, "sv_s": sv_s, "x_attn": x_attn,
            "hn_f": hn_f, "h1": h1, "g1": g1, "f_out": f_out})
        x = f_out + x_attn

    norm, (head_norm, head_fc) = vit.transformer.norm, vit.mlp_head
    x_fin = _ln_detached(norm, x)
    grid = x_fin.reshape(b, t + 1, s, d)
    cls = grid[:, 0, 0]
    head_n = _ln_detached(head_norm, cls)
    logits = linear(head_n, head_fc.weight, head_fc.bias)

    r_logit = torch.zeros_like(logits)
    r_logit[:, index] = 1.0
    r = zrule(lambda h: linear(h, head_fc.weight, head_fc.bias), (head_n,),
              r_logit)
    r = zrule(lambda c: _ln_detached(head_norm, c), (cls,), r)
    r = zrule(lambda g: g[:, 0, 0], (grid,), r)
    r = r.reshape(b, (t + 1) * s, d)
    r = zrule(lambda u: _ln_detached(norm, u), (x,), r)

    rel_attns: Dict[str, List[torch.Tensor]] = {"t": [], "s": []}
    sums = [r.sum()]
    for (pt, ps, pf), sv in zip(reversed(layers), reversed(saved_layers)):
        fc1, fc2 = pf.fn.net[0], pf.fn.net[3]
        r_f, r_xa = zrule(lambda a, c: a + c, (sv["f_out"], sv["x_attn"]),
                          r)
        r_g1 = zrule(lambda u: linear(u, fc2.weight, fc2.bias), (sv["g1"],),
                     r_f)
        r_h1 = zrule(gelu, (sv["h1"],), r_g1)
        r_hnf = zrule(lambda u: linear(u, fc1.weight, fc1.bias),
                      (sv["hn_f"],), r_h1)
        r_xa = r_xa + zrule(lambda u: _ln_detached(pf.norm, u),
                            (sv["x_attn"],), r_hnf)
        r_outs, r_xin = zrule(lambda a, c: a + c, (sv["out_s"], sv["x_in"]),
                              r_xa)
        r_hns, r_as = _attention_relprop(ps.fn, sv["sv_s"], r_outs, heads,
                                         s, temporal=False)
        rel_attns["s"].append(r_as.transpose(1, 2))
        r_outt = zrule(lambda u: _ln_detached(ps.norm, u), (sv["out_t"],),
                       r_hns)
        r_hnt, r_at = _attention_relprop(pt.fn, sv["sv_t"], r_outt, heads,
                                         s, temporal=True)
        rel_attns["t"].append(r_at.transpose(1, 2))
        r = r_xin + zrule(lambda u: _ln_detached(pt.norm, u), (sv["x_in"],),
                          r_hnt)
        sums.append(r.sum())

    rel_attns["t"].reverse()
    rel_attns["s"].reverse()
    return rel_attns, logits, torch.stack(sums)


def generate_full_lrp(model, clips, index: int = 0,
                      from_features: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full epsilon-rule LRP cams: (cam_s (B, T, hw), cam_t (B, T, hw)).

    model: the port's ISTVT, run in eval mode whatever its mode (and given
    back in it). from_features=True treats `clips`
    as the (B, T, h, w, C) Xception feature grid (stem skipped; the map
    gradients come from the DSTTr's own forward)."""
    with eval_mode(model):
        if from_features:
            feats = clips
            _, grads, _ = bias_grads(model.vit, feats, index, feats.device)
        else:
            with torch.no_grad():
                feats = model.features(clips)
            _, grads, _ = bias_grads(model, clips, index, clips.device)
        rel_attns, _, _ = dsttr_full_lrp(model.vit, feats, index)
    abars = {k: [(g * r).clamp_min(0.0).mean(dim=1)
                 for g, r in zip(grads[k], rel_attns[k])] for k in "ts"}
    return cams(abars["s"], abars["t"])
