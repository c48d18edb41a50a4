"""ISTVT (counterpart of istvt_tpu/models/istvt.py): Xception stem + DSTTr.

  clips (B, T, H, W, 3) NHWC
    -> Xception low_level_features per frame -> (B, T, 19, 19, 728)
    -> tokens: spatial CLS per frame, learned pos-embedding, a temporal-CLS
       frame -> (B, T+1, 362, 728), padded to S = 368 (n_valid = 362)
    -> 12 ST layers, either
       int8 serving (quantize='int8'), as ISTVTConfig.q8_ff / q8_attn
       choose (models/istvt.py:258-350; kernels/quant.py):
         q8_ff='full', q8_attn='ingest' (the default), three kernels:
           a_t = ln_qkv_q8_temporal_attention(x)
           a_s = mm_q8_ln_qkv_q8_spatial_attention(a_t)
           x   = matmul_q8_res_ln_ff_q8_full(a_s, x)
         q8_ff='full', q8_attn='layer', one kernel:
           x   = st_layer_q8(x)
         q8_ff='full', any other q8_attn ('boundary'):
           a_t = temporal_attention_packed(ln_matmul_q8(x))
           a_s = spatial_attention_packed(matmul_q8_ln_matmul_q8(a_t))
           x   = matmul_q8_res_ln_ff_q8_full(a_s, x)
         any other q8_ff, whatever q8_attn is:
           o_t = temporal_block_q8(x), x = spatial_block_q8(o_t) + x
           (nn/attention.py: ln_matmul_q8 -> packed core ->
           matmul_q8_bias_residual), then by q8_ff x =
           ln_ff_residual_q8(x) ('mixed': int8 fc1, fc2 in x's dtype),
           kernels/mlp.ln_ff_residual(x) ('bf16') or, for any other
           value, ln_ff_residual_q8_full(x) (both GEMMs int8)
       or float fused (quantize='none'), five kernels (nn/attention.py,
       kernels/mlp.py):
         o_t = ln_matmul -> temporal_attention_packed -> matmul_bias_residual
         x   = ln_matmul -> spatial_attention_packed -> matmul_bias_residual
               (+ x)
         x   = ln_ff_residual(x)
    -> LayerNorm, mlp_head (LayerNorm + Linear) on the (temporal-CLS,
       spatial-CLS) token -> logits.

Ported: the eval forward with `use_pallas=True`, in two forms: int8 W8A8
serving (`quantize='int8'`, every q8_ff / q8_attn mode above; stem_store
'f8' or 'bf16') and float fused (`quantize='none'`, in the parameters'
dtype, f32 or bf16; the stem stores nothing in f8); the train forward
(`model.train()`, train-mode BatchNorm in the stem; train/step.py drives
it) of the float fused path, every ST-layer kernel differentiable
through its backward kernel, and with dropout > 0 the feed-forward in
plain torch with its dropout (models/istvt.py:366-376), and of the
XLA-math path (`use_pallas=False`: the unfused layer below under
autograd, no kernel), either with `remat` (torch.utils.checkpoint a
layer); and the unfused layer of models/istvt.py:378-394, which the
attention-map path (`forward(clips, return_attn=True)` or
`attn_bias=...`; interpret/ drives it in eval mode, the
attention-transfer loss of train/losses.py in train mode, where the maps
keep their autograd graph and the feed-forward its dropout masks) and the
XLA-math forward run:

    o = temporal_residual_attention(LN x)    (nn/attention.py, plain
    x = spatial_only_attention(LN o) + x      torch)
    x = feed_forward(LN x) + x               (fused_ff, kernel #22, with
                                              use_pallas in eval; else
                                              linear -> exact-erf GELU ->
                                              dropout -> linear -> dropout)

at S = 362, unpadded (the maps and the bias are 362 wide). Every other
configuration raises NotImplementedError naming its ROADMAP.md item; none
falls back silently.

Module and state_dict names are the reference's (network/vivit/vivit.py,
module.py), so `istvt_tpu.compat.torch_import.istvt_from_torch` loads a
port state_dict; the int8 copies are extra buffers (`qkv_wq`, ...) that
`quantize_params` attaches, beside each its K-major copy for the int8
GEMM (`qkv_wk`, ...: non-persistent, rebuilt by `quantize_params` and by
every state_dict load), and the float path's (in, out) weight copies
are non-persistent buffers (`qkv_w`, ...) that `pack_params` attaches for
eval (the int8 modes q8_ff='mixed' and 'bf16' read the feed-forward's
too; every other int8 mode reads the int8 copies only). Train mode never
reads those copies (an optimizer step would leave them stale): it builds
them from the parameters inside every forward.
"""
from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from istvt_tpu_torch.core.config import ISTVTConfig
from istvt_tpu_torch.kernels import quant
from istvt_tpu_torch.kernels.attention import (spatial_attention_packed,
                                               temporal_attention_packed)
from istvt_tpu_torch.kernels.mlp import fused_ff, ln_ff_residual
from istvt_tpu_torch.models import xception
from istvt_tpu_torch.nn.attention import (spatial_block_fused,
                                          spatial_block_q8,
                                          spatial_only_attention,
                                          temporal_block_fused,
                                          temporal_block_q8,
                                          temporal_residual_attention)
from istvt_tpu_torch.nn.layers import (dropout, dropout_mask, gelu,
                                       layernorm, linear)

_ROADMAP = "ROADMAP.md queue 1"


class _ServingBuffers(nn.Module):
    """Optional serving copies of the weights, held as buffers (None until
    filled): the int8 copies, which quantize_params or a state_dict that
    carries them fills; the int8 GEMM's K-major copies of those
    (kernels/quant.kmajor), built from them there and held by no
    state_dict; and the float path's (in, out) copies, which pack_params
    fills and no state_dict holds."""

    q8_names: tuple = ()
    kmajor_names: tuple = ()    # (K-major copy, its int8 weight) pairs
    packed_names: tuple = ()

    def _register_copies(self):
        for n in self.q8_names:
            self.register_buffer(n, None)
        for n, _ in self.kmajor_names:
            self.register_buffer(n, None, persistent=False)
        for n in self.packed_names:
            self.register_buffer(n, None, persistent=False)

    def build_kmajor(self):
        """(Re)build the K-major copy of each int8 weight, on its device."""
        for n, src in self.kmajor_names:
            setattr(self, n, quant.kmajor(getattr(self, src)))

    def has_q8(self) -> bool:
        return all(getattr(self, n) is not None for n in self.q8_names)

    def has_packed(self) -> bool:
        return all(getattr(self, n) is not None for n in self.packed_names)

    def io_sources(self):
        """The nn.Linear modules of each (in, out) copy, in packed_names
        order."""
        raise NotImplementedError

    def io_weights(self):
        """The (in, out) weights the float kernels take, in packed_names
        order: in train mode built from the current parameters on every
        call (differentiable, never stale); in eval mode the copies
        pack_params attached."""
        if self.training:
            return tuple(_io(*ls) for ls in self.io_sources())
        return tuple(getattr(self, n) for n in self.packed_names)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        dev = next(self.parameters()).device
        for n in self.q8_names:
            v = state_dict.get(prefix + n)
            if v is not None and getattr(self, n) is None:
                setattr(self, n, torch.empty_like(v, device=dev))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
        if self.has_q8():
            with torch.no_grad():
                self.build_kmajor()


def _io(*linears):
    """The (in, out) weight of nn.Linear modules, concatenated over out."""
    return torch.cat([m.weight.t() for m in linears], dim=1).contiguous()


class TemporalAttention(_ServingBuffers):
    """Self-subtract temporal attention (reference module.py:174-208)."""

    q8_names = ("qkv_wq", "qkv_ws", "out_wq", "out_ws")
    kmajor_names = (("qkv_wk", "qkv_wq"), ("out_wk", "out_wq"))
    packed_names = ("qkv_w", "out_w")

    def __init__(self, dim, inner, device=None):
        super().__init__()
        self.to_qk = nn.Linear(dim, inner * 2, bias=False, device=device)
        self.to_v = nn.Linear(dim, inner, bias=False, device=device)
        self.to_out = nn.Sequential(nn.Linear(inner, dim, device=device),
                                    nn.Dropout(0.0))
        self._register_copies()

    def io_sources(self):
        return (self.to_qk, self.to_v), (self.to_out[0],)


class SpatialAttention(_ServingBuffers):
    """Per-frame spatial attention (reference module.py:66-93)."""

    q8_names = ("qkv_wq", "qkv_ws", "out_wq", "out_ws")
    kmajor_names = (("qkv_wk", "qkv_wq"), ("out_wk", "out_wq"))
    packed_names = ("qkv_w", "out_w")

    def __init__(self, dim, inner, device=None):
        super().__init__()
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False, device=device)
        self.to_out = nn.Sequential(nn.Linear(inner, dim, device=device),
                                    nn.Dropout(0.0))
        self._register_copies()

    def io_sources(self):
        return (self.to_qkv,), (self.to_out[0],)


class FeedForward(_ServingBuffers):
    """GELU MLP dim -> hidden -> dim (reference module.py:23-34)."""

    q8_names = ("w1q", "w1s", "w2q", "w2s")
    kmajor_names = (("w1k", "w1q"), ("w2k", "w2q"))
    packed_names = ("w1", "w2")

    def __init__(self, dim, hidden, device=None):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, hidden, device=device),
                                 nn.GELU(), nn.Dropout(0.0),
                                 nn.Linear(hidden, dim, device=device),
                                 nn.Dropout(0.0))
        self._register_copies()

    def io_sources(self):
        return (self.net[0],), (self.net[3],)


class PreNorm(nn.Module):
    def __init__(self, dim, fn, device=None):
        super().__init__()
        self.norm = nn.LayerNorm(dim, device=device)
        self.fn = fn


class Transformer(nn.Module):
    def __init__(self, cfg: ISTVTConfig, device=None):
        super().__init__()
        d, inner = cfg.dim, cfg.inner_dim
        self.layers = nn.ModuleList([
            nn.ModuleList([
                PreNorm(d, TemporalAttention(d, inner, device), device),
                PreNorm(d, SpatialAttention(d, inner, device), device),
                PreNorm(d, FeedForward(d, d * cfg.mlp_ratio, device), device),
            ]) for _ in range(cfg.depth)])
        self.norm = nn.LayerNorm(d, device=device)


class DSTTr(nn.Module):
    """Decomposed spatial-temporal transformer (reference vivit.py:103-148)."""

    def __init__(self, cfg: ISTVTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, n1 = cfg.dim, cfg.tokens_per_frame
        self.pos_embedding = nn.Parameter(
            torch.empty(1, cfg.num_frames, n1, d, device=device))
        self.space_token = nn.Parameter(torch.empty(1, 1, d, device=device))
        self.temporal_token = nn.Parameter(torch.empty(1, 1, d, device=device))
        self.transformer = Transformer(cfg, device)
        self.mlp_head = nn.Sequential(
            nn.LayerNorm(d, device=device),
            nn.Linear(d, cfg.num_classes, device=device))

    def tokens(self, feats, pad: bool = True):
        """(B, T, h, w, D) -> stream (B, (T+1) * S, D), S, n_valid.

        With `pad` (the fused kernels' path) S is the token count per frame
        padded to a multiple of 8; the pad tokens are zeros, masked out of
        the spatial-attention keys and isolated everywhere else (per-token
        LN/FF, per-location temporal attention), as models/istvt.py:220-254
        pads for its kernels. Without it S = n_valid = h * w + 1."""
        b, t, hh, ww, d = feats.shape
        s = hh * ww + 1
        x = feats.reshape(b, t, hh * ww, d)
        cls_space = self.space_token.to(x.dtype).expand(b, t, 1, d)
        x = torch.cat([cls_space, x], dim=2)
        x = x + self.pos_embedding[:, :t, :s].to(x.dtype)
        cls_t = self.temporal_token.to(x.dtype)[:, :, None, :]
        x = torch.cat([cls_t.expand(b, 1, s, d), x], dim=1)
        extra = (-s) % 8 if pad else 0
        if extra:
            x = F.pad(x, (0, 0, 0, extra))
        return x.reshape(b, (t + 1) * (s + extra), d), s + extra, s

    def run_layer(self, layer, x, s: int, n_valid: int, masks=()):
        """One ST layer: x = attn_s(attn_t(x)) + x; x = ff(x) + x, as an
        int8 chain (models/istvt.py:258-356, by q8_ff and q8_attn) or the
        float fused one (:357-376): in train mode with dropout > 0 its
        feed-forward is feed_forward's, with `masks`, on LN x."""
        pt, ps, pf = layer
        at, asp, ff = pt.fn, ps.fn, pf.fn
        cfg = self.cfg
        heads = cfg.heads
        given = quant.kmajor_given      # the int8 GEMM's K-major copies
        if cfg.quantize != "int8":
            out_t = temporal_block_fused(pt, x, heads, s)
            x = spatial_block_fused(ps, out_t, heads, s, residual=x,
                                    n_valid=n_valid)
            if self._dropout_ff():
                h = layernorm(x, pf.norm.weight, pf.norm.bias)
                return self.feed_forward(ff, h, masks) + x
            w1, w2 = ff.io_weights()
            return ln_ff_residual(x, pf.norm.weight, pf.norm.bias, w1,
                                  ff.net[0].bias, w2, ff.net[3].bias)
        if cfg.q8_ff != "full":
            out_t = temporal_block_q8(pt, x, heads, s)
            x = spatial_block_q8(ps, out_t, heads, s, residual=x,
                                 n_valid=n_valid)
            if cfg.q8_ff == "mixed":
                return quant.ln_ff_residual_q8(
                    x, pf.norm.weight, pf.norm.bias, ff.w1q, ff.w1s,
                    ff.net[0].bias, ff.w2, ff.net[3].bias,
                    wk=given(ff.w1k))
            if cfg.q8_ff == "bf16":
                return ln_ff_residual(x, pf.norm.weight, pf.norm.bias, ff.w1,
                                      ff.net[0].bias, ff.w2, ff.net[3].bias)
            # any other value: the fully-int8 FF (models/istvt.py:350-356)
            return quant.ln_ff_residual_q8_full(
                x, pf.norm.weight, pf.norm.bias, ff.w1q, ff.w1s,
                ff.net[0].bias, ff.w2q, ff.w2s, ff.net[3].bias,
                wk=given(ff.w1k, ff.w2k))
        bq, nq, d = x.shape
        t1 = nq // s
        inner = at.qkv_wq.shape[1] // 3
        if cfg.q8_attn == "layer":
            # the whole layer in one kernel (models/istvt.py:275-282)
            x = quant.st_layer_q8(
                x.reshape(bq, t1, s, d), pt.norm.weight, pt.norm.bias,
                at.qkv_wq, at.qkv_ws, at.out_wq, at.out_ws, at.to_out[0].bias,
                ps.norm.weight, ps.norm.bias, asp.qkv_wq, asp.qkv_ws,
                asp.out_wq, asp.out_ws, asp.to_out[0].bias, pf.norm.weight,
                pf.norm.bias, ff.w1q, ff.w1s, ff.net[0].bias, ff.w2q, ff.w2s,
                ff.net[3].bias, heads, n_valid,
                wk=given(at.qkv_wk, at.out_wk, asp.qkv_wk, asp.out_wk, ff.w1k,
                         ff.w2k))
            return x.reshape(bq, nq, d)
        if cfg.q8_attn == "ingest":
            a_t = quant.ln_qkv_q8_temporal_attention(
                x.reshape(bq, t1, s, d), pt.norm.weight, pt.norm.bias,
                at.qkv_wq, at.qkv_ws, heads, wk=given(at.qkv_wk))
            a_s = quant.mm_q8_ln_qkv_q8_spatial_attention(
                a_t.reshape(bq * t1, s, inner), at.out_wq, at.out_ws,
                at.to_out[0].bias, ps.norm.weight, ps.norm.bias,
                asp.qkv_wq, asp.qkv_ws, heads, n_valid,
                wk=given(at.out_wk, asp.qkv_wk))
        else:
            qkv_t = quant.ln_matmul_q8(x, pt.norm.weight, pt.norm.bias,
                                       at.qkv_wq, at.qkv_ws,
                                       wk=given(at.qkv_wk))
            a_t = temporal_attention_packed(
                qkv_t.reshape(bq, t1, s, 3 * inner), heads)
            qkv_s = quant.matmul_q8_ln_matmul_q8(
                a_t.reshape(bq, nq, inner), at.out_wq, at.out_ws,
                at.to_out[0].bias, ps.norm.weight, ps.norm.bias,
                asp.qkv_wq, asp.qkv_ws, wk=given(at.out_wk, asp.qkv_wk))
            a_s = spatial_attention_packed(
                qkv_s.reshape(bq * t1, s, 3 * inner), heads, n_valid)
        return quant.matmul_q8_res_ln_ff_q8_full(
            a_s.reshape(bq, nq, inner), x, asp.out_wq, asp.out_ws,
            asp.to_out[0].bias, pf.norm.weight, pf.norm.bias,
            ff.w1q, ff.w1s, ff.net[0].bias, ff.w2q, ff.w2s, ff.net[3].bias,
            wk=given(asp.out_wk, ff.w1k, ff.w2k))

    def run_layer_unfused(self, layer, x, s: int, bias_t=None, bias_s=None,
                          need_attn: bool = False, masks=()):
        """One ST layer on the unpadded stream (models/istvt.py:378-394):
        x = attn_s(LN attn_t(LN x)) + x; x = ff(LN x) + x, the attention on
        the XLA-math branches, the feed-forward's dropout with `masks`.
        Returns (x, map_t, map_s); the maps are None unless need_attn."""
        pt, ps, pf = layer
        heads = self.cfg.heads
        res_t = temporal_residual_attention(
            pt.fn, layernorm(x, pt.norm.weight, pt.norm.bias), heads, s,
            return_attn=need_attn, attn_bias=bias_t)
        out_t, a_t = res_t if need_attn else (res_t, None)
        res_s = spatial_only_attention(
            ps.fn, layernorm(out_t, ps.norm.weight, ps.norm.bias), heads, s,
            return_attn=need_attn, attn_bias=bias_s)
        out_s, a_s = res_s if need_attn else (res_s, None)
        x = out_s + x
        f = self.feed_forward(pf.fn, layernorm(x, pf.norm.weight,
                                               pf.norm.bias), masks)
        return f + x, a_t, a_s

    def _dropout_ff(self) -> bool:
        """Whether the feed-forward is the dropout form (train mode with
        dropout > 0), whether or not masks are drawn, as in JAX."""
        return self.training and self.cfg.dropout > 0.0

    def feed_forward(self, ff, h, masks=()):
        """The feed-forward of models/istvt.py:166-185: kernel #22
        (fused_ff, tanh-GELU) with use_pallas unless it is the dropout
        form, else linear -> exact-erf GELU -> dropout -> linear ->
        dropout, with the keep masks `masks` (none: no dropout). Reads the
        nn.Linear parameters (JAX reads p['fc1']['w']), never the
        pack_params copies."""
        fc1, fc2 = ff.net[0], ff.net[3]
        if self.cfg.use_pallas and not self._dropout_ff():
            return fused_ff(h, fc1.weight.t(), fc1.bias, fc2.weight.t(),
                            fc2.bias)
        m1, m2 = masks or (None, None)
        rate, train = self.cfg.dropout, self.training
        h = dropout(gelu(linear(h, fc1.weight, fc1.bias)), rate, train, m1)
        return dropout(linear(h, fc2.weight, fc2.bias), rate, train, m2)

    def ff_masks(self, layer, x, rng):
        """One layer's two feed-forward keep masks, over the stream x as
        the layer sees it (padded on the fused path, as JAX draws them):
        (B, N, hidden) then (B, N, D), drawn in that order."""
        rate, hidden = self.cfg.dropout, layer[2].fn.net[0].out_features
        return (dropout_mask(x.shape[:-1] + (hidden,), rate, rng, x.device),
                dropout_mask(x.shape, rate, rng, x.device))

    def head(self, x):
        """Stream -> logits from the (temporal-CLS, spatial-CLS) token; LN is
        per token, so normalising that token alone equals the reference's
        LN over the whole stream."""
        tr, (hn, fc) = self.transformer, self.mlp_head
        cls = layernorm(x[:, 0], tr.norm.weight, tr.norm.bias)
        return linear(layernorm(cls, hn.weight, hn.bias), fc.weight, fc.bias)

    def forward(self, feats, return_attn: bool = False, attn_bias=None,
                rng=None):
        """(B, T, h, w, D) features -> logits (B, num_classes) (the
        counterpart of models/istvt.dsttr_apply); with
        return_attn (logits, {'t': [L x (B, H, S, T+1, T+1)], 's': [L x
        (B, H, T+1, S, S)]}). attn_bias ({'t': [...], 's': [...]} in the
        same orders, or None) is added to every post-softmax map.

        The fused kernels run when use_pallas is set and no map is asked
        for; otherwise the unfused layer at S = h * w + 1, unpadded.

        In train mode with dropout > 0, `rng` (a torch.Generator on the
        stream's device, or a callable that hands out given masks, see
        nn/layers.dropout_mask) gives each layer's two feed-forward masks,
        drawn layer by layer before the layer runs; None runs no dropout.
        With cfg.remat each layer is recomputed in the backward pass
        (torch.utils.checkpoint) unless maps are asked for; its masks are
        its inputs, so the recompute applies the same ones."""
        need_attn = return_attn or attn_bias is not None
        fused = self.cfg.use_pallas and not need_attn
        if self.cfg.quantize == "int8" and not fused:
            # loud, not silent (models/istvt.py:238-248): a config that
            # claims int8 serving but runs float would mislabel every
            # measurement made with it
            warnings.warn("cfg.quantize='int8' but running FLOAT: the "
                          "fused-kernel path is off (use_pallas/attn-map)",
                          stacklevel=2)
        x, s, n_valid = self.tokens(feats, pad=fused)
        attns = {"t": [], "s": []}
        draw = self._dropout_ff() and rng is not None
        remat = (self.cfg.remat and not need_attn
                 and torch.is_grad_enabled())
        for i, layer in enumerate(self.transformer.layers):
            if not need_attn:
                masks = self.ff_masks(layer, x, rng) if draw else ()

                def run(x, *masks, layer=layer):
                    if fused:
                        return self.run_layer(layer, x, s, n_valid, masks)
                    return self.run_layer_unfused(layer, x, s,
                                                  masks=masks)[0]

                x = (checkpoint(run, x, *masks, use_reentrant=False)
                     if remat else run(x, *masks))
                continue
            bias = ((None, None) if attn_bias is None
                    else (attn_bias["t"][i], attn_bias["s"][i]))
            masks = self.ff_masks(layer, x, rng) if draw else ()
            x, a_t, a_s = self.run_layer_unfused(layer, x, s, *bias,
                                                 need_attn=need_attn,
                                                 masks=masks)
            attns["t"].append(a_t)
            attns["s"].append(a_s)
        logits = self.head(x)
        return (logits, attns) if return_attn else logits


class ISTVT(nn.Module):
    """XceptionVidTr (reference vivit.py:193-208): the eval forward, and the
    train forward of the float fused path."""

    name = "istvt"

    def __init__(self, cfg: ISTVTConfig = ISTVTConfig(), device=None):
        super().__init__()
        self.xcep = xception.TransferModel(device=device)
        self.vit = DSTTr(cfg, device=device)

    @property
    def cfg(self) -> ISTVTConfig:
        """The model's configuration, the one its DSTTr reads: assigning
        it reconfigures both."""
        return self.vit.cfg

    @cfg.setter
    def cfg(self, cfg: ISTVTConfig):
        self.vit.cfg = cfg

    def _check_path(self, need_attn: bool = False):
        cfg = self.cfg
        if self.training:
            self._check_train()
            return
        if cfg.quantize not in ("int8", "none"):
            raise ValueError(f"quantize={cfg.quantize!r}")
        if need_attn or not cfg.use_pallas:
            return          # the unfused layer (DSTTr.forward)
        layer = self.vit.transformer.layers[0]
        if cfg.quantize == "none":
            if not all(m.fn.has_packed() for m in layer):
                raise RuntimeError("the float fused path needs the (in, out) "
                                   "weight copies: run pack_params(model)")
            return
        if cfg.stem_store not in ("f8", "bf16"):
            raise ValueError(f"stem_store={cfg.stem_store!r}")
        if not all(m.fn.has_q8() for m in layer):
            raise RuntimeError("cfg.quantize='int8' but the model carries no "
                               "int8 weights: run quantize_params(model)")
        # every int8 mode runs (DSTTr.run_layer); only the 'mixed' and
        # 'bf16' feed-forwards read float (in, out) copies
        ff = layer[2].fn
        if cfg.q8_ff in ("mixed", "bf16") and (ff.w2 is None or (
                cfg.q8_ff == "bf16" and ff.w1 is None)):
            raise RuntimeError(f"q8_ff={cfg.q8_ff!r} needs the feed-forward's "
                               f"(in, out) weight copies: run "
                               f"pack_params(model)")

    def _check_train(self):
        """Train mode runs the float model: the fused path with
        use_pallas, else the unfused XLA-math layer, with any dropout and
        remat; with attention maps the unfused layer (DSTTr.forward); not
        the int8 path."""
        cfg = self.cfg
        if cfg.quantize != "none":
            raise NotImplementedError(
                f"train mode with quantize={cfg.quantize!r} (the JAX package "
                f"runs its float layers then) is not ported; train with "
                f"quantize='none' ({_ROADMAP}, 'Training')")

    def forward(self, clips, return_attn: bool = False, attn_bias=None,
                rng=None):
        """clips (B, T, H, W, 3) NHWC -> logits (B, num_classes); with
        return_attn (logits, {'t': [...], 's': [...]}), every layer's maps
        (DSTTr.forward), in train mode too, where they keep their autograd
        graph. attn_bias is added to every post-softmax map. In train
        mode the stem's BN running statistics
        are updated in place, and `rng` gives the dropout masks
        (DSTTr.forward)."""
        self._check_path(return_attn or attn_bias is not None)
        return self.vit(self.features(clips), return_attn=return_attn,
                        attn_bias=attn_bias, rng=rng)

    def features(self, clips):
        """Per-frame stem: (B, T, H, W, 3) -> (B, T, h, w, 728)."""
        b, t, hh, ww, c = clips.shape
        # int8 serving stores inter-conv stem tensors as f8 e4m3
        # (models/istvt.py:549-557)
        store = (torch.float8_e4m3fn if self.cfg.quantize == "int8"
                 and self.cfg.stem_store == "f8" else None)
        feats = self.xcep.model.low_level_features(
            clips.reshape(b * t, hh, ww, c), store_dtype=store)
        fh, fw = feats.shape[1], feats.shape[2]
        return feats.reshape(b, t, fh, fw, feats.shape[-1])


@torch.no_grad()
def init(cfg: ISTVTConfig, generator: torch.Generator,
         device=None) -> ISTVT:
    """A randomly initialised ISTVT with the JAX package's distributions
    (models/istvt.dsttr_init, models/xception.init): Linear/Conv
    U(+-1/sqrt(fan_in)), LayerNorm/BN identity, tokens and pos-embedding
    N(0, 1). Draws from `generator` on the CPU, then moves to `device`."""
    model = ISTVT(cfg, device="meta").to_empty(device="cpu")
    xception.init_(model, generator)
    for m in model.modules():
        if isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for p in (model.vit.pos_embedding, model.vit.space_token,
              model.vit.temporal_token):
        p.normal_(generator=generator)
    return model.to(device).eval()


@torch.no_grad()
def quantize_params(model: ISTVT) -> ISTVT:
    """Attach the int8 serving weights in place (models/istvt.quantize_params):
    per-output-column int8 copies of every ST layer's projection and FF
    weights, in the JAX (in, out) layout; the temporal q|k and v weights
    are packed into one (D, 3I) matrix; and the int8 GEMM's K-major copy of
    each (kernels/quant.kmajor). Float weights stay."""
    for pt, ps, pf in model.vit.transformer.layers:
        at, asp, ff = pt.fn, ps.fn, pf.fn
        packed = torch.cat([at.to_qk.weight.t(), at.to_v.weight.t()], dim=1)
        at.qkv_wq, at.qkv_ws = quant.quantize_weight(packed)
        at.out_wq, at.out_ws = quant.quantize_weight(at.to_out[0].weight.t())
        asp.qkv_wq, asp.qkv_ws = quant.quantize_weight(asp.to_qkv.weight.t())
        asp.out_wq, asp.out_ws = quant.quantize_weight(
            asp.to_out[0].weight.t())
        ff.w1q, ff.w1s = quant.quantize_weight(ff.net[0].weight.t())
        ff.w2q, ff.w2s = quant.quantize_weight(ff.net[3].weight.t())
        for m in (at, asp, ff):
            m.build_kmajor()
    return model


@torch.no_grad()
def pack_params(model: ISTVT) -> ISTVT:
    """Attach the float fused path's weights in place (the int8 modes
    q8_ff='mixed' and 'bf16' read the feed-forward's): every ST layer's
    projection and FF weight in the JAX (in, out) layout the kernels take,
    contiguous, in the parameters' dtype; the temporal q|k and v weights
    packed into one (D, 3I) matrix. Run it after any cast or load of the
    parameters: the copies do not follow them."""
    for layer in model.vit.transformer.layers:
        for m in layer:
            for name, linears in zip(m.fn.packed_names, m.fn.io_sources()):
                setattr(m.fn, name, _io(*linears))
    return model


# feature-grid side per input size (models/istvt._FEAT_HW); other sizes
# run a shape-only pass through the stem on the meta device
_FEAT_HW = {300: 19, 299: 19, 256: 16, 224: 14, 75: 5, 72: 5, 56: 4, 48: 3}


def infer_feat_hw(image_size: int) -> int:
    hw = _FEAT_HW.get(image_size)
    if hw is None:
        stem = xception.Xception(xception.XceptionConfig(num_classes=2),
                                 device="meta").eval()
        x = torch.empty(1, image_size, image_size, 3, device="meta")
        hw = _FEAT_HW[image_size] = int(stem.low_level_features(x).shape[1])
    return hw
