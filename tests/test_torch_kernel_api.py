"""The port's kernel API (istvt_tpu_torch.kernels and kernels/conv.py)
against the JAX package's (istvt_tpu.kernels, istvt_tpu.kernels.conv) on
the CPU: the unpacked attention entries #13 (fused_frame_attention_bwd),
#14, #15, #16, #17, the differentiable spatial_attention_pallas /
temporal_attention_pallas, and the fused sepconv + BN #24. On the CPU the
port runs its plain versions; JAX runs its Pallas kernels in interpret mode
and, for gradients, its custom_vjp's non-TPU branch (jax.vjp of the XLA
reference), under HIGHEST precision. Inputs are numpy arrays from a seed,
at the sizes of tests/test_kernels.py.

Tolerances: f32 forward outputs and kernel-vs-kernel backward outputs at
atol = rtol = 1e-5 (summation order only); gradients against jax.vjp /
jax.grad of the references at atol = rtol = 2e-4 (JAX's own bound in
tests/test_kernels.py). #16 and #17 in bf16 follow _temporal_kernel's and
_temporal_bwd_kernel's roundings op for op. XLA on the CPU skips some of
those roundings by default (xla_allow_excess_precision: a fusion of bf16
operations keeps its intermediates in f32), so the JAX side is compiled
twice: with excess precision off, the kernel's own roundings, where the
port must agree to rel-L2 <= 4e-3 with at least 99% of the elements equal
bit for bit (measured: all of them, rel-L2 0); and as JAX compiles it by
default, at rel-L2 <= 1e-2 (measured 2.9e-3 for #16, 4.3e-3 for #17's dq,
with 74% and 50% of the elements bit-equal: the skipped roundings are the
whole difference). The bit-equal shares are printed.

None of these entry points is on a model path, in either package.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import istvt_tpu.kernels as jkernels
from istvt_tpu.core import precision as jprecision
from istvt_tpu.kernels import attention as ja
from istvt_tpu.kernels import conv as jc
from istvt_tpu.models import xception as jx
import istvt_tpu_torch.kernels as tkernels
from istvt_tpu_torch.compat.from_jax import block_state_dict
from istvt_tpu_torch.core import precision as tprecision
from istvt_tpu_torch.kernels import _lib
from istvt_tpu_torch.kernels import conv as tc
from istvt_tpu_torch.models import xception as tx
from istvt_tpu_torch.nn.layers import batchnorm_eval, separable_conv2d

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this file: the suite runs its files
    in parallel workers, where torch's default of a thread per core
    oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a, dt="f32"):
    """numpy f32 -> (torch, jax) in the dtype (bf16 rounded once, the same
    on both sides)."""
    tdt, jdt = DTYPES[dt]
    t = torch.from_numpy(a).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(jdt)


def _np(x):
    return (x.detach().float().numpy() if torch.is_tensor(x)
            else np.asarray(jnp.asarray(x, jnp.float32)))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _bf16_close(got, want, what, rel_l2=4e-3, share=0.99):
    g, w = _np(got), _np(want)
    rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
    same = float(np.mean(g == w))
    print(f"{what}: bf16 rel-L2 {rel:.3e}, bit-equal share {same:.4f}")
    assert rel <= rel_l2 and same >= share, (what, rel, same)


def _jax_both(fn, *args):
    """fn(*args) as XLA compiles it by default and, for bf16 inputs, also
    without excess precision (every bf16 rounding the kernel makes):
    (exact, default); in f32 the two are one."""
    lowered = jax.jit(fn).lower(*args)
    default = lowered.compile()(*args)
    if args[0].dtype != jnp.bfloat16:
        return default, default
    exact = lowered.compile(
        compiler_options={"xla_allow_excess_precision": False})
    return exact(*args), default


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def test_fused_frame_attention_matches_jax():
    """#14 on (6, 27, 16)."""
    rng = np.random.RandomState(0)
    (q, jq), (k, jk), (v, jv) = (_pair(_randn(rng, 6, 27, 16))
                                 for _ in range(3))
    with jprecision.highest():
        want = ja.fused_frame_attention(jq, jk, jv, interpret=True)
    _close(tkernels.fused_frame_attention(q, k, v), want)


def test_fused_frame_attention_mh_matches_jax():
    """#15 on (3, 26, 2 x 16)."""
    rng = np.random.RandomState(1)
    (q, jq), (k, jk), (v, jv) = (_pair(_randn(rng, 3, 26, 32))
                                 for _ in range(3))
    with jprecision.highest():
        want = ja.fused_frame_attention_mh(jq, jk, jv, heads=2,
                                           interpret=True)
    _close(tkernels.fused_frame_attention_mh(q, k, v, 2), want)


@pytest.mark.parametrize("n_valid", [-1, 20])
def test_fused_frame_attention_bwd_matches_jax(n_valid):
    """#13's unpacked entry at #15's shapes, unmasked and masked."""
    rng = np.random.RandomState(2)
    ins = [_pair(_randn(rng, 3, 26, 32)) for _ in range(4)]
    with jprecision.highest():
        want = ja.fused_frame_attention_bwd(*(j for _, j in ins), heads=2,
                                            n_valid=n_valid, interpret=True)
    got = tkernels.fused_frame_attention_bwd(*(t for t, _ in ins), 2,
                                             n_valid)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("dt", DTYPES)
def test_fused_temporal_attention_matches_jax(dt):
    """#16 on (2, 4, 9, 2 x 16), f32 and bf16 (its own rounding order)."""
    rng = np.random.RandomState(3)
    (q, jq), (k, jk), (v, jv) = (_pair(_randn(rng, 2, 4, 9, 32), dt)
                                 for _ in range(3))
    got = tkernels.fused_temporal_attention(q, k, v, 2)
    assert got.dtype == q.dtype
    with jprecision.highest():
        want, want_xla = _jax_both(
            lambda a, b, c: ja.fused_temporal_attention(a, b, c, heads=2,
                                                        interpret=True),
            jq, jk, jv)
    if dt == "f32":
        _close(got, want)
    else:
        _bf16_close(got, want, "#16")
        _bf16_close(got, want_xla, "#16 (XLA default)", 1e-2, 0.0)


@pytest.mark.parametrize("dt", DTYPES)
def test_fused_temporal_attention_bwd_matches_jax(dt):
    """#17 on (2, 4, 9, 2 x 16) against the Pallas kernel (f32, bf16) and,
    in f32, against jax.vjp of _temporal_reference."""
    rng = np.random.RandomState(4)
    ins = [_pair(_randn(rng, 2, 4, 9, 32), dt) for _ in range(4)]
    jq, jk, jv, jg = (j for _, j in ins)
    with jprecision.highest():
        want, want_xla = _jax_both(
            lambda *t: ja.fused_temporal_attention_bwd(*t, heads=2,
                                                       interpret=True),
            jq, jk, jv, jg)
        _, vjp = jax.vjp(lambda a, b, c: ja._temporal_reference(a, b, c, 2),
                         jq, jk, jv)
        want_ref = vjp(jg)
    got = tkernels.fused_temporal_attention_bwd(*(t for t, _ in ins), 2)
    for name, g, w, wx, r in zip("qkv", got, want, want_xla, want_ref):
        assert g.dtype == ins[0][0].dtype
        if dt == "f32":
            _close(g, w)
            _close(g, r, 2e-4)
        else:
            _bf16_close(g, w, f"#17 d{name}")
            _bf16_close(g, wx, f"#17 d{name} (XLA default)", 1e-2, 0.0)


def _grads(fn, ins, g):
    leaves = [t.clone().requires_grad_() for t in ins]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, g)


def test_spatial_attention_pallas_matches_jax():
    """Forward (#15) and gradients (autograd through _spatial_reference on
    the CPU, JAX's non-TPU _spatial_bwd) on (2, 3, 10, 2, 16)."""
    rng = np.random.RandomState(5)
    ins = [_pair(_randn(rng, 2, 3, 10, 2, 16)) for _ in range(4)]
    (q, jq), (k, jk), (v, jv), (g, jg) = ins
    with jprecision.highest():
        want, vjp = jax.vjp(ja.spatial_attention_pallas, jq, jk, jv)
        want_grads = vjp(jg)
    _lib.reset_launches()
    with tprecision.highest():
        out, grads = _grads(tkernels.spatial_attention_pallas, (q, k, v), g)
    assert not any(_lib.LAUNCHES.values())
    _close(out, want)
    for gt, gw in zip(grads, want_grads):
        _close(gt, gw, 2e-4)
    _close(tkernels.spatial_attention_pallas(q, k, v), want)


def test_temporal_attention_pallas_matches_jax():
    """Forward (#16) and gradients (autograd through _temporal_reference on
    the CPU, JAX's non-TPU _temporal_bwd) on (2, 3, 10, 2 x 16)."""
    rng = np.random.RandomState(6)
    ins = [_pair(_randn(rng, 2, 3, 10, 32)) for _ in range(4)]
    (q, jq), (k, jk), (v, jv), (g, jg) = ins
    with jprecision.highest():
        want, vjp = jax.vjp(
            lambda a, b, c: ja.temporal_attention_pallas(a, b, c, 2),
            jq, jk, jv)
        want_grads = vjp(jg)
    with tprecision.highest():
        out, grads = _grads(
            lambda a, b, c: tkernels.temporal_attention_pallas(a, b, c, 2),
            (q, k, v), g)
    _close(out, want)
    for gt, gw in zip(grads, want_grads):
        _close(gt, gw, 2e-4)


def _sepconv_inputs(rng, n, h, w, cin, cout):
    x = _randn(rng, n, h, w, cin)
    dw = _randn(rng, 9, cin) * 0.2
    pw = _randn(rng, cin, cout) * 0.2
    bn = (rng.rand(cout).astype(np.float32) + 0.5,
          _randn(rng, cout) * 0.1, _randn(rng, cout) * 0.05,
          rng.rand(cout).astype(np.float32) + 0.5)
    return x, dw, pw, bn


@pytest.mark.parametrize("relu_in", [False, True])
def test_sepconv_bn_matches_jax(relu_in):
    """#24 on (2, 13, 11, 16 -> 24) with a folded BN against JAX's kernel
    and its _sepconv_bn_reference; the affine as (1, Cout) and (1, 1,
    Cout)."""
    rng = np.random.RandomState(7)
    x, dw, pw, bn = _sepconv_inputs(rng, 2, 13, 11, 16, 24)
    a, b = tc.fold_bn(*map(torch.from_numpy, bn))
    ja_, jb = jc.fold_bn(*map(jnp.asarray, bn))
    with jprecision.highest():
        want = jc.sepconv_bn(jnp.asarray(x), jnp.asarray(dw), jnp.asarray(pw),
                             ja_.reshape(1, -1), jb.reshape(1, -1), relu_in)
        want_ref = jc._sepconv_bn_reference(
            jnp.asarray(x), jnp.asarray(dw), jnp.asarray(pw),
            ja_.reshape(1, -1), jb.reshape(1, -1), relu_in)
    _close(a, ja_)
    with tprecision.highest():
        for shape in ((1, -1), (1, 1, -1)):
            got = tc.sepconv_bn(torch.from_numpy(x), torch.from_numpy(dw),
                                torch.from_numpy(pw), a.reshape(shape),
                                b.reshape(shape), relu_in)
            _close(got, want)
            _close(got, want_ref)
        ref = tc._sepconv_bn_reference(
            torch.from_numpy(x), torch.from_numpy(dw), torch.from_numpy(pw),
            a.reshape(1, -1), b.reshape(1, -1), relu_in)
    _close(ref, want_ref)


def test_sepconv_bn_gradient_matches_jax():
    """The backward (autograd through _sepconv_bn_reference) against
    jax.grad of JAX's sepconv_bn, for x and every weight
    (tests/test_kernels.py:452-470's shapes)."""
    rng = np.random.RandomState(2)
    x = _randn(rng, 1, 8, 8, 8)
    dw = _randn(rng, 9, 8) * 0.2
    pw = _randn(rng, 8, 8) * 0.2
    a, b = _randn(rng, 1, 8) + 1.0, _randn(rng, 1, 8) * 0.1
    ins = [x, dw, pw, a, b]
    with jprecision.highest():
        want = jax.grad(lambda *t: jnp.sum(jc.sepconv_bn(*t, True) ** 2),
                        argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, ins))
    leaves = [torch.from_numpy(t).requires_grad_() for t in ins]
    with tprecision.highest():
        loss = (tc.sepconv_bn(*leaves, relu_in=True) ** 2).sum()
        got = torch.autograd.grad(loss, leaves)
    for g, w in zip(got, want):
        _close(g, w, 2e-4)


def test_sepconv_bn_on_a_real_xception_unit():
    """A real Xception unit: JAX's block_init(PRNGKey(0), BLOCK_SPECS[0])
    carried into the port's Block (compat.from_jax.block_state_dict); its
    first unit (64 -> 128, no pre-ReLU) at 24^2 through sepconv_bn with the
    unit's BN folded, against JAX's sepconv_bn on the same weights and the
    port's own stem composition (cuDNN's convs on the card, separable_conv2d
    then batchnorm_eval)."""
    p, s = jx.block_init(jax.random.PRNGKey(0), jx.BLOCK_SPECS[0])
    p, s = jax.tree_util.tree_map(np.asarray, (p, s))
    block = tx.Block(tx.BLOCK_SPECS[0]).eval()
    block.load_state_dict(block_state_dict(p, s, tx.BLOCK_SPECS[0]))
    sep, bn = block.units()[0]
    x = np.random.RandomState(1).randn(2, 24, 24, 64).astype(np.float32) * 0.5
    unit, bns = p["rep"][0], s["rep"][0]["bn"]
    ja_, jb = jc.fold_bn(unit["bn"]["scale"], unit["bn"]["bias"],
                         bns["mean"], bns["var"])
    with jprecision.highest():
        want = jc.sepconv_bn(jnp.asarray(x),
                             unit["sep"]["dw"]["w"].reshape(9, 64),
                             unit["sep"]["pw"]["w"].reshape(64, -1),
                             ja_.reshape(1, -1), jb.reshape(1, -1), False)
    a, b = tc.fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var)
    xt = torch.from_numpy(x)
    with torch.no_grad(), tprecision.highest():
        got = tc.sepconv_bn(xt, sep.conv1.weight.reshape(64, 9).t(),
                            sep.pointwise.weight.reshape(128, 64).t(),
                            a.reshape(1, -1), b.reshape(1, -1), False)
        stem = batchnorm_eval(
            separable_conv2d(xt.permute(0, 3, 1, 2), sep.conv1.weight,
                             sep.pointwise.weight),
            bn.weight, bn.bias, bn.running_mean, bn.running_var)
    assert tuple(got.shape) == (2, 24, 24, 128)
    _close(got, want)
    _close(got, stem.permute(0, 2, 3, 1))


def test_kernel_api_surface():
    """istvt_tpu_torch.kernels exports every function istvt_tpu.kernels
    exports, and no module of the port imports jax or the JAX package."""
    names = {n for n, v in vars(jkernels).items()
             if not n.startswith("_") and callable(v)}
    assert names == {
        "fused_frame_attention", "fused_frame_attention_bwd",
        "fused_frame_attention_mh", "fused_temporal_attention",
        "fused_temporal_attention_bwd", "spatial_attention_pallas",
        "temporal_attention_pallas", "fused_ff"}
    assert all(callable(getattr(tkernels, n, None)) for n in names)
    assert callable(tc.sepconv_bn) and callable(tc.fold_bn)
    bad = []
    for path in Path(tkernels.__file__).parents[1].rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {m}" for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "istvt_tpu")]
    assert not bad, bad
