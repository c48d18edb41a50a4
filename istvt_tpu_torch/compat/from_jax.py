"""JAX (params, state) trees -> port state_dict
(counterpart of istvt_tpu/compat/torch_import.py, in the other direction),
and the BatchNorm running statistics back (`state_to_jax`), so a training
run's state is compared in either form.

The JAX trees arrive as numpy arrays (`jax.device_get` or `np.asarray` of
each leaf); this module never imports jax. Layouts (JAX -> torch):
  conv   HWIO (kH, kW, I/g, O) -> (O, I/g, kH, kW)
  linear (in, out)             -> (out, in)
  BN     scale/bias, mean/var  -> weight/bias, running_mean/running_var
  q8     int8 (D, K), f32 (K,) -> buffers of the same layout
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from istvt_tpu_torch.models.xception import BLOCK_SPECS


def _t(a) -> torch.Tensor:
    """numpy leaf -> tensor. bfloat16 leaves (ml_dtypes) go through float32,
    which is exact, since torch.from_numpy refuses them."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _conv(w) -> torch.Tensor:
    return _t(np.asarray(w).transpose(3, 2, 0, 1))


def _lin(w) -> torch.Tensor:
    return _t(np.asarray(w).T)


def _bn(sd, prefix, p, s):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _sep(sd, prefix, p):
    sd[f"{prefix}.conv1.weight"] = _conv(p["dw"]["w"])
    sd[f"{prefix}.pointwise.weight"] = _conv(p["pw"]["w"])


def block_state_dict(bp, bs, spec, prefix: str = ""):
    """models/xception.block_init params/state of one block with `spec`
    (a BLOCK_SPECS entry) -> the keys of the port's xception.Block."""
    sd: Dict[str, torch.Tensor] = {}
    off = 1 if spec[4] else 0   # rep index shift of the leading ReLU
    for i, unit in enumerate(bp["rep"]):
        _sep(sd, f"{prefix}rep.{3 * i + off}", unit["sep"])
        _bn(sd, f"{prefix}rep.{3 * i + 1 + off}", unit["bn"],
            bs["rep"][i]["bn"])
    if "skip" in bp:
        sd[f"{prefix}skip.weight"] = _conv(bp["skip"]["w"])
        _bn(sd, f"{prefix}skipbn", bp["skipbn"], bs["skipbn"])
    return sd


def xception_state_dict(p, s, prefix: str = "") -> Dict[str, torch.Tensor]:
    """models/xception params/state -> reference Xception keys."""
    sd: Dict[str, torch.Tensor] = {}
    sd[f"{prefix}conv1.weight"] = _conv(p["conv1"]["w"])
    _bn(sd, f"{prefix}bn1", p["bn1"], s["bn1"])
    sd[f"{prefix}conv2.weight"] = _conv(p["conv2"]["w"])
    _bn(sd, f"{prefix}bn2", p["bn2"], s["bn2"])
    for b, spec in enumerate(BLOCK_SPECS, start=1):
        sd.update(block_state_dict(p[f"block{b}"], s[f"block{b}"], spec,
                                   f"{prefix}block{b}."))
    _sep(sd, f"{prefix}conv3", p["conv3"])
    _bn(sd, f"{prefix}bn3", p["bn3"], s["bn3"])
    _sep(sd, f"{prefix}conv4", p["conv4"])
    _bn(sd, f"{prefix}bn4", p["bn4"], s["bn4"])
    sd[f"{prefix}fc.weight"] = _lin(p["fc"]["w"])
    sd[f"{prefix}fc.bias"] = _t(p["fc"]["b"])
    return sd


def dsttr_state_dict(p, prefix: str = "") -> Dict[str, torch.Tensor]:
    """models/istvt.dsttr_init tree (with optional 'q8' leaves) -> reference
    DSTTr keys plus the port's int8 buffers."""
    sd: Dict[str, torch.Tensor] = {}
    for k in ("pos_embedding", "space_token", "temporal_token"):
        sd[prefix + k] = _t(p[k])

    def ln(key, q):
        sd[f"{key}.weight"] = _t(q["scale"])
        sd[f"{key}.bias"] = _t(q["bias"])

    def lin(key, q):
        sd[f"{key}.weight"] = _lin(q["w"])
        if "b" in q:
            sd[f"{key}.bias"] = _t(q["b"])

    def q8(key, q):
        for name, v in (q or {}).items():
            sd[f"{key}.{name}"] = _t(v)

    for i, layer in enumerate(p["layers"]):
        pre = f"{prefix}transformer.layers.{i}"
        at, asp, ff = layer["attn_t"], layer["attn_s"], layer["ff"]
        ln(f"{pre}.0.norm", at["norm"])
        lin(f"{pre}.0.fn.to_qk", at["to_qk"])
        lin(f"{pre}.0.fn.to_v", at["to_v"])
        lin(f"{pre}.0.fn.to_out.0", at["to_out"])
        q8(f"{pre}.0.fn", at.get("q8"))
        ln(f"{pre}.1.norm", asp["norm"])
        lin(f"{pre}.1.fn.to_qkv", asp["to_qkv"])
        lin(f"{pre}.1.fn.to_out.0", asp["to_out"])
        q8(f"{pre}.1.fn", asp.get("q8"))
        ln(f"{pre}.2.norm", ff["norm"])
        lin(f"{pre}.2.fn.net.0", ff["fc1"])
        lin(f"{pre}.2.fn.net.3", ff["fc2"])
        q8(f"{pre}.2.fn", ff.get("q8"))
    ln(f"{prefix}transformer.norm", p["norm"])
    ln(f"{prefix}mlp_head.0", p["mlp_head"]["norm"])
    lin(f"{prefix}mlp_head.1", p["mlp_head"]["fc"])
    return sd


def params_from_jax(params: Any, state: Any) -> Dict[str, torch.Tensor]:
    """JAX `istvt.init` (+ `quantize_params`) trees -> the port ISTVT's
    state_dict: weights, BN buffers and, when present, the q8 buffers."""
    sd = xception_state_dict(params["xcep"], state["xcep"], "xcep.model.")
    sd.update(dsttr_state_dict(params["vit"], "vit."))
    return sd


def state_to_jax(sd: Dict[str, torch.Tensor],
                 prefix: str = "xcep.model.") -> Dict[str, Any]:
    """The port's BatchNorm running statistics -> JAX `istvt.init`'s state
    tree {'xcep': {'bn1': {'mean', 'var'}, ..., 'block{b}': {'rep':
    [{'bn': ...}], 'skipbn': ...}}}, as numpy arrays (the inverse of the
    state half of params_from_jax)."""
    def bn(key):
        return {"mean": sd[f"{prefix}{key}.running_mean"].cpu().numpy(),
                "var": sd[f"{prefix}{key}.running_var"].cpu().numpy()}

    st: Dict[str, Any] = {k: bn(k) for k in ("bn1", "bn2", "bn3", "bn4")}
    for b, spec in enumerate(BLOCK_SPECS, start=1):
        off = 1 if spec[4] else 0
        blk: Dict[str, Any] = {"rep": [
            {"bn": bn(f"block{b}.rep.{3 * i + 1 + off}")}
            for i in range(spec[2])]}
        if spec[0] != spec[1] or spec[3] != 1:
            blk["skipbn"] = bn(f"block{b}.skipbn")
        st[f"block{b}"] = blk
    return {"xcep": st}
