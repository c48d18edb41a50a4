"""How the one-kernel int8 ST layer (#9, kernels/quant.st_layer_q8) departs
from its plain version, and what it costs against the chain it replaces,
on one NVIDIA GPU.

    python3 tools/q8_layer_diag.py [--seeds 0 1]

At the serving slice (kernels/selfcheck.SLICE: 2 clips, 7 x 368 tokens,
362 valid, 8 heads x 64) and each seed, in f32 with TF32 off:
  * #3 and #7 (the fully-int8 FF) against their plain versions, and #3
    against a plain version whose row scale is `amax / 127.0` (a CUDA
    tensor divided by a Python number, which PyTorch multiplies by the
    reciprocal instead): max|diff|;
  * #9 against its plain version: max|diff|, rel-L2, rows off by more
    than 2e-3; its temporal attention output a_t (#1's, which #9 runs)
    against the plain one's, and how many int8 codes of a_t differ;
  * #9 against #1 -> #2 -> #3 on the card, f32 and bf16: bit for bit?
then in bf16 the median ms of #9 and of the #1 -> #2 -> #3 chain, in
turns (layer, chain, layer, chain), CUDA events. Prints one line each and
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from istvt_tpu_torch.core.precision import highest  # noqa: E402
from istvt_tpu_torch.kernels import quant, selfcheck  # noqa: E402


def _chain(args, wk):
    """#1 -> #2 -> #3 (the ingest chain's wrappers) on #9's arguments and
    its six K-major weight copies."""
    (x, st, bt, wqt, wst, wot, sot, bot, ss, bs, wqs, wss, wos, sos, bos, sf,
     bf, w1q, w1s, b1, w2q, w2s, b2, heads, n_valid) = args
    kqt, kot, kqs, kos, k1, k2 = wk
    b, t1, s, d = x.shape
    a_t = quant.ln_qkv_q8_temporal_attention(x, st, bt, wqt, wst, heads,
                                             wk=(kqt,))
    a_s = quant.mm_q8_ln_qkv_q8_spatial_attention(
        a_t.reshape(b * t1, s, -1), wot, sot, bot, ss, bs, wqs, wss, heads,
        n_valid, wk=(kot, kqs))
    out = quant.matmul_q8_res_ln_ff_q8_full(
        a_s.reshape(b, t1 * s, -1), x.reshape(b, t1 * s, d), wos, sos, bos,
        sf, bf, w1q, w1s, b1, w2q, w2s, b2, wk=(kos, k1, k2))
    return out.reshape(x.shape), a_t


def _median_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[len(times) // 2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the GPU")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for seed in args.seeds:
        cases = selfcheck.slice_cases(dev, seed=seed)
        with highest():
            for name in ("matmul_q8_res_ln_ff_q8_full",
                         "ln_ff_residual_q8_full"):
                kern, plain, make = cases[name]
                a = make(torch.float32)
                got = kern(*a)
                line = (f"seed {seed} {name}: f32 max|diff| "
                        f"{(got - plain(*a)).abs().max().item():.3e}")
                if name == "matmul_q8_res_ln_ff_q8_full":
                    exact, quant._div127 = quant._div127, lambda t: t / 127.0
                    try:
                        recip = plain(*a)
                    finally:
                        quant._div127 = exact
                    line += (f"; against a plain version with amax / 127.0: "
                             f"{(got - recip).abs().max().item():.3e}")
                print(line, flush=True)
            kern, plain, make = cases["st_layer_q8"]
            a = make(torch.float32)
            got, want = kern(*a), plain(*a)
            rows = (~torch.isclose(got, want, atol=2e-3, rtol=2e-3)
                    ).reshape(-1, got.shape[-1]).any(dim=1)
            at_plain = quant.ln_qkv_q8_temporal_plain(*a[:5], a[23])
        for dt in (torch.float32, torch.bfloat16):
            a = make(dt)
            with highest():
                chain, at_card = _chain(a, kern.keywords["wk"])
                same = torch.equal(kern(*a), chain)
            if dt == torch.float32:
                inner = at_card.shape[-1]
                flips = int((quant._quant_rows(at_card.reshape(-1, inner))[0]
                             != quant._quant_rows(
                                 at_plain.reshape(-1, inner))[0]).sum())
                print(f"seed {seed} st_layer_q8: f32 max|diff| "
                      f"{(got - want).abs().max().item():.3e}, rel-L2 "
                      f"{((got - want).norm() / want.norm()).item():.3e}, "
                      f"{int(rows.sum())} of {rows.numel()} rows off by more "
                      f"than 2e-3; a_t max|diff| "
                      f"{(at_card - at_plain).abs().max().item():.3e}, "
                      f"{flips} of {at_card.numel()} int8 codes of a_t "
                      f"differ", flush=True)
            print(f"seed {seed} st_layer_q8 {dt}: equals #1 -> #2 -> #3 bit "
                  f"for bit: {same}", flush=True)
    kern, _, make = selfcheck.slice_cases(dev)["st_layer_q8"]
    a, wk = make(torch.bfloat16), kern.keywords["wk"]
    ms = [_median_ms(lambda: kern(*a)), _median_ms(lambda: _chain(a, wk)),
          _median_ms(lambda: kern(*a)), _median_ms(lambda: _chain(a, wk))]
    print(f"bf16 slice median ms: st_layer_q8 {ms[0]:.4f} / {ms[2]:.4f}, "
          f"#1 -> #2 -> #3 {ms[1]:.4f} / {ms[3]:.4f}", flush=True)


if __name__ == "__main__":
    main()
