"""Relevance attribution for ISTVT (counterpart of
istvt_tpu/interpret/lrp.py): Chefer-style transformer attribution.

The gradients come from a zero-valued `attn_bias` built into the model
(models/istvt.DSTTr.forward): it is added after every softmax, so
d logit / d bias == d logit / d A. The rollout
R <- N(Abar + I) R, Abar = mean_h[(grad * A)+], runs twice, as ISTVT's
decomposition asks:
  * spatial  - per frame row, S x S maps (S = hw + 1);
               cam_s[b, t] = R's spatial-CLS row over the patch tokens;
  * temporal - per location, (T+1) x (T+1) maps;
               cam_t[b, :, s] = R's temporal-CLS row over the frame rows.
Both come back as (B, T, hw).

The functions take the port's ISTVT and run it as its `cfg` says: with
use_pallas the unfused layer's feed-forward is kernel #22 (fused_ff), and
generate_feature_relevance differentiates the fused forward (its backward
kernels run in eval mode); without it every layer is plain torch.

Each entry point (attention_maps_and_grads and so generate_lrp,
generate_feature_relevance, full_lrp.generate_full_lrp) runs the model in
eval mode, as JAX applies train=False (interpret/lrp.py:74, :141;
full_lrp.py:310), and gives it back in the
mode each of its modules came in (`eval_mode`), also when it raises: a
model left in train mode by a train step gets the eval maps and keeps
its BatchNorm statistics.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch


@contextlib.contextmanager
def eval_mode(model):
    """Run the block with `model` in eval mode, then restore every
    module's own training flag."""
    modes = [(m, m.training) for m in model.modules()]
    model.eval()
    try:
        yield model
    finally:
        for m, training in modes:
            m.training = training


def _head_agg(attn, grad):
    """Abar = E_h[(grad * A)+] (Chefer rule 6)."""
    return (grad * attn).clamp_min(0.0).mean(dim=1)


def _rollout(abars):
    """R = N(Abar_L + I) ... N(Abar_1 + I), N normalising the rows
    (compute_rollout_attention). abars: (..., N, N)."""
    n = abars[0].shape[-1]
    eye = torch.eye(n, dtype=abars[0].dtype, device=abars[0].device)
    r = None
    for a in abars:
        m = a + eye
        m = m / m.sum(dim=-1, keepdim=True)
        r = m if r is None else m @ r
    return r


def zero_bias(cfg, b: int, t: int, device) -> Dict[str, List[torch.Tensor]]:
    """Zero f32 attention biases that require grad, in the public orders:
    't' (B, H, S, T+1, T+1) and 's' (B, H, T+1, S, S) per layer."""
    s, h = cfg.tokens_per_frame, cfg.heads
    return {
        "t": [torch.zeros(b, h, s, t + 1, t + 1, device=device,
                          requires_grad=True) for _ in range(cfg.depth)],
        "s": [torch.zeros(b, h, t + 1, s, s, device=device,
                          requires_grad=True) for _ in range(cfg.depth)],
    }


def detached(module) -> Dict[str, torch.Tensor]:
    """The module's parameters without grad, for torch.func.functional_call:
    the relevance gradients flow only to the biases (or the clips), as
    jax.grad differentiates only its argument."""
    return {n: p.detach() for n, p in module.named_parameters()}


def bias_grads(module, inputs, index: int, device):
    """(attns, grads, logits) of module(inputs, return_attn=True,
    attn_bias=zero) with grads = d logits[:, index].sum() / d bias. module:
    the ISTVT on clips or its DSTTr on features."""
    b, t = inputs.shape[0], inputs.shape[1]
    bias = zero_bias(module.cfg, b, t, device)
    with torch.enable_grad():
        logits, attns = torch.func.functional_call(
            module, detached(module), (inputs,),
            {"return_attn": True, "attn_bias": bias})
        leaves = bias["t"] + bias["s"]
        g = torch.autograd.grad(logits[:, index].sum(), leaves)
    depth = len(bias["t"])
    grads = {"t": list(g[:depth]), "s": list(g[depth:])}
    attns = {k: [a.detach() for a in v] for k, v in attns.items()}
    return attns, grads, logits.detach()


def attention_maps_and_grads(model, clips, index: int = 0):
    """Forward + backward: (attns, grads, logits) with attns / grads
    {'t': [L x (B, H, S, T+1, T+1)], 's': [L x (B, H, T+1, S, S)]}.
    model: the port's ISTVT, run in eval mode (eval_mode); clips (B, T, H,
    W, 3)."""
    with eval_mode(model):
        return bias_grads(model, clips, index, clips.device)


def cams(abars_s, abars_t) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both rollouts -> (cam_s, cam_t), each (B, T, hw)."""
    cam_s = _rollout(abars_s)[:, 1:, 0, 1:]
    cam_t = _rollout(abars_t)[:, 1:, 0, 1:].transpose(1, 2)
    return cam_s, cam_t


def generate_lrp(model, clips, index: int = 0,
                 method: str = "transformer_attribution"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (cam_s (B, T, hw), cam_t (B, T, hw)), hw = feat_hw^2.

    method:
      'transformer_attribution' - gradient-weighted rollout (the
        reference's method string, visualize_rel.py:257);
      'rollout' - plain attention rollout (no gradients);
      'last_layer' - final layer's CLS attention only.

    Gradient-weighted maps keep only POSITIVE evidence for logit `index`:
    a clip the model scores as real gives near-zero cams. cam_s needs
    depth >= 2 to attribute real frames (interpret/lrp.py:99-108)."""
    if method not in ("transformer_attribution", "rollout", "last_layer"):
        raise ValueError(f"method={method!r}")
    attns, grads, _ = attention_maps_and_grads(model, clips, index)
    if method == "rollout":
        abars_s = [a.mean(dim=1) for a in attns["s"]]
        abars_t = [a.mean(dim=1) for a in attns["t"]]
    elif method == "last_layer":
        abars_s = [_head_agg(attns["s"][-1], grads["s"][-1])]
        abars_t = [_head_agg(attns["t"][-1], grads["t"][-1])]
    else:
        abars_s = [_head_agg(a, g) for a, g in zip(attns["s"], grads["s"])]
        abars_t = [_head_agg(a, g) for a, g in zip(attns["t"], grads["t"])]
    return cams(abars_s, abars_t)


def generate_feature_relevance(model, clips, index: int = 0):
    """Gradient x input relevance on the clip pixels, summed over the
    channels: (B, T, H, W) (the analog of the reference's feature-map
    dumps, visualize_feat_map.py:228-236). With use_pallas the eval-mode
    fused forward is differentiated (pack_params must have run)."""
    x = clips.detach().requires_grad_(True)
    with eval_mode(model), torch.enable_grad():
        logits = torch.func.functional_call(model, detached(model), (x,))
        (g,) = torch.autograd.grad(logits[:, index].sum(), x)
    return (g * clips).abs().sum(dim=-1)
