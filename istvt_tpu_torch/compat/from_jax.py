"""JAX (params, state) trees <-> port state_dict
(counterpart of istvt_tpu/compat/torch_import.py), and a JAX TrainState
(params, model_state, optax opt_state, step) <-> the port's model and
optimizer, so one run's state moves between the packages either way: a
JAX checkpoint resumes in the port, and the port's in JAX.

The JAX trees arrive as numpy arrays (`jax.device_get` or `np.asarray` of
each leaf) and leave as numpy arrays; this module never imports jax.
Layouts (JAX -> torch):
  conv   HWIO (kH, kW, I/g, O) -> (O, I/g, kH, kW)
  linear (in, out)             -> (out, in)
  BN     scale/bias, mean/var  -> weight/bias, running_mean/running_var
  q8     int8 (D, K), f32 (K,) -> buffers of the same layout
Each leaf's place in both is one entry of a table (`_xception_entries`,
`_dsttr_entries`): (tree, path in the JAX tree, state_dict key, layout),
read one way by params_from_jax and the other by params_to_jax. optax's
adamw moments mu / nu and sgd's trace take their parameters' layout
changes; its update count becomes torch's per-parameter `step`.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from istvt_tpu_torch.models.xception import BLOCK_SPECS

# (tree 'p' (params) or 's' (state), JAX path, state_dict key, layout
# 'conv' / 'lin' / '' (as is))
Entry = Tuple[str, tuple, str, str]


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


_TO_TORCH = {"conv": _conv, "lin": _lin, "": _t}
_TO_JAX = {"conv": lambda a: a.transpose(2, 3, 1, 0),
           "lin": lambda a: a.T, "": lambda a: a}


def _bn(key, path) -> List[Entry]:
    return [("p", path + ("scale",), f"{key}.weight", ""),
            ("p", path + ("bias",), f"{key}.bias", ""),
            ("s", path + ("mean",), f"{key}.running_mean", ""),
            ("s", path + ("var",), f"{key}.running_var", "")]


def _sep(key, path) -> List[Entry]:
    return [("p", path + ("dw", "w"), f"{key}.conv1.weight", "conv"),
            ("p", path + ("pw", "w"), f"{key}.pointwise.weight", "conv")]


def _block_entries(spec, prefix: str = "", path: tuple = ()) -> List[Entry]:
    """A block of models/xception.block_init with `spec` (a BLOCK_SPECS
    entry): the keys of the port's xception.Block."""
    off = 1 if spec[4] else 0   # rep index shift of the leading ReLU
    out: List[Entry] = []
    for i in range(spec[2]):
        out += _sep(f"{prefix}rep.{3 * i + off}", path + ("rep", i, "sep"))
        out += _bn(f"{prefix}rep.{3 * i + 1 + off}", path + ("rep", i, "bn"))
    if spec[0] != spec[1] or spec[3] != 1:
        out.append(("p", path + ("skip", "w"), f"{prefix}skip.weight",
                    "conv"))
        out += _bn(f"{prefix}skipbn", path + ("skipbn",))
    return out


def _xception_entries(prefix: str = "", path: tuple = ()) -> List[Entry]:
    """models/xception params/state -> reference Xception keys."""
    out: List[Entry] = [("p", path + ("conv1", "w"), f"{prefix}conv1.weight",
                         "conv")]
    out += _bn(f"{prefix}bn1", path + ("bn1",))
    out.append(("p", path + ("conv2", "w"), f"{prefix}conv2.weight", "conv"))
    out += _bn(f"{prefix}bn2", path + ("bn2",))
    for b, spec in enumerate(BLOCK_SPECS, start=1):
        out += _block_entries(spec, f"{prefix}block{b}.",
                              path + (f"block{b}",))
    for i in (3, 4):
        out += _sep(f"{prefix}conv{i}", path + (f"conv{i}",))
        out += _bn(f"{prefix}bn{i}", path + (f"bn{i}",))
    out += [("p", path + ("fc", "w"), f"{prefix}fc.weight", "lin"),
            ("p", path + ("fc", "b"), f"{prefix}fc.bias", "")]
    return out


def _dsttr_entries(depth: int, prefix: str = "",
                   path: tuple = ()) -> List[Entry]:
    """models/istvt.dsttr_init's float leaves -> reference DSTTr keys."""
    out: List[Entry] = [("p", path + (k,), prefix + k, "")
                        for k in ("pos_embedding", "space_token",
                                  "temporal_token")]

    def ln(key, p):
        return [("p", p + ("scale",), f"{key}.weight", ""),
                ("p", p + ("bias",), f"{key}.bias", "")]

    def lin(key, p, bias=True):
        return ([("p", p + ("w",), f"{key}.weight", "lin")]
                + ([("p", p + ("b",), f"{key}.bias", "")] if bias else []))

    for i in range(depth):
        pre, lp = f"{prefix}transformer.layers.{i}", path + ("layers", i)
        at, asp, ff = lp + ("attn_t",), lp + ("attn_s",), lp + ("ff",)
        out += (ln(f"{pre}.0.norm", at + ("norm",))
                + lin(f"{pre}.0.fn.to_qk", at + ("to_qk",), bias=False)
                + lin(f"{pre}.0.fn.to_v", at + ("to_v",), bias=False)
                + lin(f"{pre}.0.fn.to_out.0", at + ("to_out",))
                + ln(f"{pre}.1.norm", asp + ("norm",))
                + lin(f"{pre}.1.fn.to_qkv", asp + ("to_qkv",), bias=False)
                + lin(f"{pre}.1.fn.to_out.0", asp + ("to_out",))
                + ln(f"{pre}.2.norm", ff + ("norm",))
                + lin(f"{pre}.2.fn.net.0", ff + ("fc1",))
                + lin(f"{pre}.2.fn.net.3", ff + ("fc2",)))
    out += (ln(f"{prefix}transformer.norm", path + ("norm",))
            + ln(f"{prefix}mlp_head.0", path + ("mlp_head", "norm"))
            + lin(f"{prefix}mlp_head.1", path + ("mlp_head", "fc")))
    return out


def _istvt_entries(depth: int) -> List[Entry]:
    return (_xception_entries("xcep.model.", ("xcep",))
            + _dsttr_entries(depth, "vit.", ("vit",)))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _to_state_dict(entries, trees) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for tree, path, key, layout in entries:
        sd[key] = _TO_TORCH[layout](_get(trees[tree], path))
        if key.endswith(".running_var"):
            sd[key[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0)
    return sd


def block_state_dict(bp, bs, spec, prefix: str = ""):
    """models/xception.block_init params/state of one block with `spec`
    (a BLOCK_SPECS entry) -> the keys of the port's xception.Block."""
    return _to_state_dict(_block_entries(spec, prefix), {"p": bp, "s": bs})


def xception_state_dict(p, s, prefix: str = "") -> Dict[str, torch.Tensor]:
    """models/xception params/state -> reference Xception keys."""
    return _to_state_dict(_xception_entries(prefix), {"p": p, "s": s})


def dsttr_state_dict(p, prefix: str = "") -> Dict[str, torch.Tensor]:
    """models/istvt.dsttr_init tree (with optional 'q8' leaves) -> reference
    DSTTr keys plus the port's int8 buffers."""
    sd = _to_state_dict(_dsttr_entries(len(p["layers"]), prefix), {"p": p})
    for i, layer in enumerate(p["layers"]):
        for j, name in enumerate(("attn_t", "attn_s", "ff")):
            for k, v in (layer[name].get("q8") or {}).items():
                sd[f"{prefix}transformer.layers.{i}.{j}.fn.{k}"] = _t(v)
    return sd


def params_from_jax(params: Any, state: Any) -> Dict[str, torch.Tensor]:
    """JAX `istvt.init` (+ `quantize_params`) trees -> the port ISTVT's
    state_dict: weights, BN buffers and, when present, the q8 buffers."""
    sd = xception_state_dict(params["xcep"], state["xcep"], "xcep.model.")
    sd.update(dsttr_state_dict(params["vit"], "vit."))
    return sd


def _depth(sd) -> int:
    layer = re.compile(r"^vit\.transformer\.layers\.(\d+)\.")
    return 1 + max(int(m.group(1)) for m in map(layer.match, sd) if m)


def _listify(tree):
    """Nested dicts with int keys 0..n-1 -> lists, as JAX's trees hold
    'layers' and 'rep'."""
    if not isinstance(tree, dict):
        return tree
    if tree and all(isinstance(k, int) for k in tree):
        return [_listify(tree[i]) for i in range(len(tree))]
    return {k: _listify(v) for k, v in tree.items()}


def params_to_jax(sd: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """The port ISTVT's float state_dict -> JAX `istvt.init`'s (params,
    state) trees as numpy arrays (the inverse of params_from_jax without
    q8 leaves)."""
    trees: Dict[str, Dict] = {"p": {}, "s": {}}
    for tree, path, key, layout in _istvt_entries(_depth(sd)):
        node = trees[tree]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _TO_JAX[layout](sd[key].detach().cpu().numpy())
    return _listify(trees["p"]), _listify(trees["s"])


# ---------------------------------------------------------------------------
# TrainState


def _field(ts, name):
    return ts[name] if isinstance(ts, dict) else getattr(ts, name)


def train_state_from_jax(jax_ts, model: torch.nn.Module,
                         opt: torch.optim.Optimizer) -> int:
    """Load a JAX TrainState (numpy leaves: params, model_state, opt_state
    of optax.adamw or optax.sgd with momentum, step; a dataclass or a dict)
    into the port's model and its AdamW / SGD optimizer, in place. Returns
    the step. adamw's mu / nu become exp_avg / exp_avg_sq and its count
    every parameter's `step`; sgd's trace becomes momentum_buffer."""
    params, mstate = _field(jax_ts, "params"), _field(jax_ts, "model_state")
    model.load_state_dict(params_from_jax(params, mstate))
    names = [n for n, _ in model.named_parameters()]
    osd = opt.state_dict()
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    for part in _field(jax_ts, "opt_state"):
        if hasattr(part, "mu"):
            mu = params_from_jax(part.mu, mstate)
            nu = params_from_jax(part.nu, mstate)
            count = torch.tensor(float(np.asarray(part.count)))
            state = {i: {"step": count.clone(), "exp_avg": mu[n],
                         "exp_avg_sq": nu[n]} for i, n in enumerate(names)}
        elif hasattr(part, "trace"):
            tr = params_from_jax(part.trace, mstate)
            state = {i: {"momentum_buffer": tr[n]}
                     for i, n in enumerate(names)}
    osd["state"] = state
    opt.load_state_dict(osd)
    return int(np.asarray(_field(jax_ts, "step")))


def train_state_to_jax(model: torch.nn.Module, opt: torch.optim.Optimizer,
                       step: int) -> Dict[str, Any]:
    """The port's model, AdamW / SGD optimizer and step -> {'params',
    'model_state', 'opt_state', 'step'} as numpy trees in JAX's layout;
    'opt_state' is {'count', 'mu', 'nu'} (adamw: the count of the
    ScaleByAdamState and of the schedule's state) or {'trace'} (sgd), for
    the caller to put into optax's state tuple."""
    sd = model.state_dict()
    params, mstate = params_to_jax(sd)
    names = [n for n, _ in model.named_parameters()]
    ostate = opt.state_dict()["state"]

    def moment(key):
        return params_to_jax({**sd, **{
            n: ostate[i][key] if i in ostate and key in ostate[i]
            else torch.zeros_like(sd[n]) for i, n in enumerate(names)}})[0]

    if isinstance(opt, torch.optim.SGD):
        opt_state = {"trace": moment("momentum_buffer")}
    else:
        count = int(ostate[0]["step"]) if 0 in ostate else 0
        opt_state = {"count": np.int32(count), "mu": moment("exp_avg"),
                     "nu": moment("exp_avg_sq")}
    return {"params": params, "model_state": mstate, "opt_state": opt_state,
            "step": np.int32(step)}
