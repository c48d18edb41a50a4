"""The forward kernels of the serving paths as dispatcher ops.

Each op is `torch.library.custom_op("istvt::<wrapper name>")`, with three
implementations chosen by the dispatcher from the device of its tensors:

  CUDA   the wrapper's card path (`_<name>_cuda` in its module): operand
         checks, workspace, the hand-written kernels of csrc/ and one count
         in _lib.LAUNCHES, wherever the op runs, a loaded torch.export
         program included; where the K-major int8 copies are missing it
         builds them and counts them in _lib.KMAJOR_BUILDS;
  CPU    the plain PyTorch version beside the wrapper (its result made
         contiguous, as the kernels' are);
  fake   the output's shape and dtype from the inputs' (no data touched),
         so that torch.export traces a model through the op with a
         symbolic batch and the program carries the op, as JAX's exported
         StableHLO carries its Pallas kernels as tpu_custom_call.

The wrappers in kernels/{quant,attention,linear,mlp}.py call these ops
(the float ones from their autograd.Functions' forward too). An int8
wrapper's `wk` (the K-major copies, or None) is the op's tensor list, empty
where none is given. Registered here, by PERF.md's kernel number:

  #1 ln_qkv_q8_temporal_attention    #11 temporal_attention_packed
  #2 mm_q8_ln_qkv_q8_spatial_attention  #10 spatial_attention_packed
  #3 matmul_q8_res_ln_ff_q8_full     #18 ln_matmul
  #4 ln_matmul_q8                    #20 matmul_bias_residual (r optional)
  #5 matmul_q8_bias_residual         #21 ln_ff_residual
  #6 ln_ff_residual_q8
  #7 ln_ff_residual_q8_full
  #8 matmul_q8_ln_matmul_q8
  #9 st_layer_q8 (its phase stamps stay outside the op)

Not ops (still called directly): the backward kernels #12, #13, #19, #23,
#21's h1-stash forward, fused_ff (#22) and the kernel API (#14-#17, #24).
Importing this module (the package's __init__ does) registers the ops;
serve_export.load_artifact needs them registered before it loads a program.
"""
from typing import Dict, List, Optional

import torch
from torch import Tensor

from istvt_tpu_torch.kernels import attention, linear, mlp, quant

_NS = "istvt"


def _custom(fn):
    """fn as the op istvt::<fn's name>, fn being its CPU implementation."""
    return torch.library.custom_op(f"{_NS}::{fn.__name__}", fn,
                                   mutates_args=(), device_types="cpu")


def _like(x, last: Optional[int] = None):
    """A fake output with x's leading shape and dtype, its last dim `last`
    (x's by default)."""
    return x.new_empty(x.shape if last is None else x.shape[:-1] + (last,))


# ---------------------------------------------------------------------------
# the int8 ingest chain (q8_ff='full', q8_attn='ingest'): #1, #2, #3


@_custom
def ln_qkv_q8_temporal_attention(x: Tensor, s: Tensor, b: Tensor, wq: Tensor,
                                 ws: Tensor, heads: int,
                                 wk: List[Tensor]) -> Tensor:
    return quant.ln_qkv_q8_temporal_plain(x, s, b, wq, ws,
                                          heads).contiguous()


@_custom
def mm_q8_ln_qkv_q8_spatial_attention(a: Tensor, woq: Tensor, wos: Tensor,
                                      bo: Tensor, s: Tensor, b: Tensor,
                                      wq: Tensor, ws: Tensor, heads: int,
                                      n_valid: int,
                                      wk: List[Tensor]) -> Tensor:
    return quant.mm_q8_ln_qkv_q8_spatial_plain(a, woq, wos, bo, s, b, wq, ws,
                                               heads, n_valid).contiguous()


@_custom
def matmul_q8_res_ln_ff_q8_full(a: Tensor, r: Tensor, wqo: Tensor,
                                wso: Tensor, bo: Tensor, s: Tensor, b: Tensor,
                                w1q: Tensor, w1s: Tensor, b1: Tensor,
                                w2q: Tensor, w2s: Tensor, b2: Tensor,
                                wk: List[Tensor]) -> Tensor:
    return quant.matmul_q8_res_ln_ff_q8_full_plain(
        a, r, wqo, wso, bo, s, b, w1q, w1s, b1, w2q, w2s, b2).contiguous()


ln_qkv_q8_temporal_attention.register_kernel("cuda")(
    quant._ln_qkv_q8_temporal_cuda)
mm_q8_ln_qkv_q8_spatial_attention.register_kernel("cuda")(
    quant._mm_q8_ln_qkv_q8_spatial_cuda)
matmul_q8_res_ln_ff_q8_full.register_kernel("cuda")(
    quant._matmul_q8_res_ln_ff_q8_full_cuda)


@ln_qkv_q8_temporal_attention.register_fake
def _(x, s, b, wq, ws, heads, wk):
    return _like(x, wq.shape[1] // 3)


@mm_q8_ln_qkv_q8_spatial_attention.register_fake
def _(a, woq, wos, bo, s, b, wq, ws, heads, n_valid, wk):
    return _like(a, wq.shape[1] // 3)


@matmul_q8_res_ln_ff_q8_full.register_fake
def _(a, r, wqo, wso, bo, s, b, w1q, w1s, b1, w2q, w2s, b2, wk):
    return _like(a, wqo.shape[1])


# ---------------------------------------------------------------------------
# the int8 A/B modes: #4, #5, #8, #6, #7, #9


@_custom
def ln_matmul_q8(x: Tensor, s: Tensor, b: Tensor, wq: Tensor, ws: Tensor,
                 wk: List[Tensor]) -> Tensor:
    return quant.ln_matmul_q8_plain(x, s, b, wq, ws).contiguous()


@_custom
def matmul_q8_bias_residual(x: Tensor, wq: Tensor, ws: Tensor, b: Tensor,
                            r: Optional[Tensor],
                            wk: List[Tensor]) -> Tensor:
    return quant.matmul_q8_bias_residual_plain(x, wq, ws, b, r).contiguous()


@_custom
def matmul_q8_ln_matmul_q8(a: Tensor, wq1: Tensor, ws1: Tensor, b1: Tensor,
                           s: Tensor, b: Tensor, wq2: Tensor, ws2: Tensor,
                           wk: List[Tensor]) -> Tensor:
    return quant.matmul_q8_ln_matmul_q8_plain(a, wq1, ws1, b1, s, b, wq2,
                                              ws2).contiguous()


@_custom
def ln_ff_residual_q8(x: Tensor, s: Tensor, b: Tensor, w1q: Tensor,
                      w1s: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
                      wk: List[Tensor]) -> Tensor:
    return quant.ln_ff_residual_q8_plain(x, s, b, w1q, w1s, b1, w2,
                                         b2).contiguous()


@_custom
def ln_ff_residual_q8_full(x: Tensor, s: Tensor, b: Tensor, w1q: Tensor,
                           w1s: Tensor, b1: Tensor, w2q: Tensor, w2s: Tensor,
                           b2: Tensor, wk: List[Tensor]) -> Tensor:
    return quant.ln_ff_residual_q8_full_plain(x, s, b, w1q, w1s, b1, w2q,
                                              w2s, b2).contiguous()


@_custom
def st_layer_q8(x: Tensor, st: Tensor, bt: Tensor, wqt: Tensor, wst: Tensor,
                wot: Tensor, sot: Tensor, bot: Tensor, ss: Tensor, bs: Tensor,
                wqs: Tensor, wss: Tensor, wos: Tensor, sos: Tensor,
                bos: Tensor, sf: Tensor, bf: Tensor, w1q: Tensor, w1s: Tensor,
                b1: Tensor, w2q: Tensor, w2s: Tensor, b2: Tensor, heads: int,
                n_valid: int, wk: List[Tensor]) -> Tensor:
    if wk:      # the copies are checked on any device (quant.st_layer_q8)
        quant._kmajor_of(wk, wqt, wot, wqs, wos, w1q, w2q)
    return quant.st_layer_q8_plain(
        x, st, bt, wqt, wst, wot, sot, bot, ss, bs, wqs, wss, wos, sos, bos,
        sf, bf, w1q, w1s, b1, w2q, w2s, b2, heads, n_valid).contiguous()


ln_matmul_q8.register_kernel("cuda")(quant._ln_matmul_q8_cuda)
matmul_q8_bias_residual.register_kernel("cuda")(
    quant._matmul_q8_bias_residual_cuda)
matmul_q8_ln_matmul_q8.register_kernel("cuda")(
    quant._matmul_q8_ln_matmul_q8_cuda)
ln_ff_residual_q8.register_kernel("cuda")(quant._ln_ff_residual_q8_cuda)
ln_ff_residual_q8_full.register_kernel("cuda")(
    quant._ln_ff_residual_q8_full_cuda)
st_layer_q8.register_kernel("cuda")(quant._st_layer_q8_cuda)


@ln_matmul_q8.register_fake
def _(x, s, b, wq, ws, wk):
    return _like(x, wq.shape[1])


@matmul_q8_bias_residual.register_fake
def _(x, wq, ws, b, r, wk):
    return _like(x, wq.shape[1])


@matmul_q8_ln_matmul_q8.register_fake
def _(a, wq1, ws1, b1, s, b, wq2, ws2, wk):
    return _like(a, wq2.shape[1])


@ln_ff_residual_q8.register_fake
def _(x, s, b, w1q, w1s, b1, w2, b2, wk):
    return _like(x)


@ln_ff_residual_q8_full.register_fake
def _(x, s, b, w1q, w1s, b1, w2q, w2s, b2, wk):
    return _like(x)


@st_layer_q8.register_fake
def _(x, *args):
    return _like(x)


# ---------------------------------------------------------------------------
# the float fused path: #11, #10, #18, #20, #21


@_custom
def temporal_attention_packed(qkv: Tensor, heads: int) -> Tensor:
    return attention.temporal_packed_plain(qkv, heads).contiguous()


@_custom
def spatial_attention_packed(qkv: Tensor, heads: int,
                             n_valid: int) -> Tensor:
    return attention.spatial_packed_plain(qkv, heads, n_valid).contiguous()


@_custom
def ln_matmul(x: Tensor, s: Tensor, b: Tensor, w: Tensor) -> Tensor:
    return linear.ln_matmul_plain(x, s, b, w).contiguous()


@_custom
def matmul_bias_residual(x: Tensor, w: Tensor, b: Tensor,
                         r: Optional[Tensor]) -> Tensor:
    return linear.matmul_bias_residual_plain(x, w, b, r).contiguous()


@_custom
def ln_ff_residual(x: Tensor, s: Tensor, bn: Tensor, w1: Tensor, b1: Tensor,
                   w2: Tensor, b2: Tensor) -> Tensor:
    return mlp.ln_ff_residual_plain(x, s, bn, w1, b1, w2, b2).contiguous()


temporal_attention_packed.register_kernel("cuda")(attention._temporal_cuda)
spatial_attention_packed.register_kernel("cuda")(attention._spatial_cuda)
ln_matmul.register_kernel("cuda")(linear._ln_matmul_cuda)
matmul_bias_residual.register_kernel("cuda")(
    linear._matmul_bias_residual_cuda)
ln_ff_residual.register_kernel("cuda")(mlp._ln_ff_residual_cuda)


@temporal_attention_packed.register_fake
def _(qkv, heads):
    return _like(qkv, qkv.shape[-1] // 3)


@spatial_attention_packed.register_fake
def _(qkv, heads, n_valid):
    return _like(qkv, qkv.shape[-1] // 3)


@ln_matmul.register_fake
def _(x, s, b, w):
    return _like(x, w.shape[1])


@matmul_bias_residual.register_fake
def _(x, w, b, r):
    return _like(x, w.shape[1])


@ln_ff_residual.register_fake
def _(x, s, bn, w1, b1, w2, b2):
    return _like(x)


# op name -> its kernel's number in PERF.md's table of the TPU kernels
OPS: Dict[str, int] = {
    "ln_qkv_q8_temporal_attention": 1,
    "mm_q8_ln_qkv_q8_spatial_attention": 2,
    "matmul_q8_res_ln_ff_q8_full": 3,
    "ln_matmul_q8": 4,
    "matmul_q8_bias_residual": 5,
    "ln_ff_residual_q8": 6,
    "ln_ff_residual_q8_full": 7,
    "matmul_q8_ln_matmul_q8": 8,
    "st_layer_q8": 9,
    "spatial_attention_packed": 10,
    "temporal_attention_packed": 11,
    "ln_matmul": 18,
    "matmul_bias_residual": 20,
    "ln_ff_residual": 21,
}


def op_counts(graph) -> Dict[str, int]:
    """{op name: calls} of the istvt:: ops in an fx graph (a torch.export
    program's `graph`), by name without the namespace; 0 for none."""
    counts = dict.fromkeys(OPS, 0)
    for node in graph.nodes:
        t = node.target
        if node.op == "call_function" and isinstance(
                t, torch._ops.OpOverload) and t.namespace == _NS:
            name = t._schema.name.split("::", 1)[1]
            counts[name] = counts.get(name, 0) + 1
    return counts
