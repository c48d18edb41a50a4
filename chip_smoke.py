"""Smoke run of the PyTorch / CUDA port (istvt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile PATH]

Drives the port's ISTVT serving paths (int8, float in bf16 and in f32),
the int8 path's five A/B modes, its training path and its
interpretability path at the paper geometry (300^2 x 6 frames, depth 12,
8 heads x 64, dim 728, FF 2912) with random weights from a seed: the int8
W8A8 path (`cli/serve.py --int8`, q8_ff='full', q8_attn='ingest'), then
on the same weights the modes that ISTVTConfig.q8_ff / q8_attn choose (no
CLI flag chooses them, as in the JAX package): ('full', 'boundary'),
('mixed', 'ingest'), ('bf16', 'ingest'), ('full', 'layer') (one kernel a
layer) and ('int8', 'ingest') (the fully-int8 FF); the float fused path
in bf16 (`cli/serve.py --bf16`) and in f32 (`cli/serve.py`), training on
the float fused path in bf16 over f32 masters (`cli/train.py --dataset
synthetic --use_pallas --bf16 --dropout 0`), the reference's default
training recipe (`cli/train.py --dataset synthetic`: f32, dropout 0.5,
the XLA-math path; with --use_pallas and --remat), a checkpointed run
resumed, recalibrated, served and explained from its checkpoint, the
data path from disk (a frame tree scored by `cli/score.py --int8` and
trained on by `cli/train.py --dataset ff++`), and the LRP relevance maps
(`interpret/`, `cli/visualize.py`) in f32, then the kernel API
(`istvt_tpu_torch.kernels`, `kernels/conv.py`), which no model path
reaches, distillation (`cli/train.py --distill_from`) and the recipe's
certification (`cli/certify.py`), the serving artifact, and last the bench
CLI (`cli/bench.py`) and the tooling (`utils/`). In phases; any failure
raises and exits non-zero:

  1. device   - a CUDA device is required; prints nvidia-smi's name and
                power limit and the torch / CUDA versions
  2. build    - nvcc builds every kernel from istvt_tpu_torch/kernels/csrc;
                from cuobjdump -sass of the library, every bf16
                instantiation of the kernels that run the spatial attention
                core or its backward (#2 and #10's spatial_attn_kernel,
                #14 / #15's frame_attn_kernel, #9's st_layer_q8_kernel,
                both passes of #13) has tensor-core instructions (HMMA /
                HGMMA), every instantiation of the bf16 float GEMM
                (gemm_bf16_wgmma_kernel: #6's fc2, #18-#23) has wgmma
                (HGMMA), every instantiation of the f32 float GEMM
                (gemm_f32_wgmma_kernel: the same callers in f32) has TF32
                wgmma (HGMMA.64x128x8.F32.TF32), every instantiation of the
                int8 GEMM (gemm_q8_wgmma_kernel: #1-#8) and of the
                one-launch layer (st_layer_q8_kernel: #9, whose GEMM phases
                run the same body) has int8 wgmma (IGMMA) and no int8
                mma.sync (IMMA), and every f32 instantiation of those
                attention kernels and of #9 TF32 mma.sync
                (HMMA.1688.F32.TF32: the f32 tile's three TF32 products)
                (selfcheck.tensor_core_check); from ptxas's report
                (build/build.log), the f32 GEMM holds exactly 168 registers
                and those int8 kernels at most 168, with no byte spilled
                (selfcheck.wgmma_register_rows), no f32 instantiation of
                the spatial attention kernels spills
                (selfcheck.SPATIAL_KERNELS; the bf16 ones' spills are
                printed), ptxas's notes that it
                serialized a kernel's wgmma are printed, and every head
                layout of
                the temporal core #11 and its backward #12 is built (17
                and 18 instantiations, selfcheck.TEMPORAL_KERNELS), and of
                their general lanes' kernels for T1 > 8 (17 and 18), with
                none spilled
  3. kernels  - each of the 24 kernels (kernels/selfcheck.CASES: one case
                per launch counter -- #20 and #5 with and without their
                residual; the training slice's four backward kernels and
                the h1-stash forward; fused_ff at the attention-map path's
                5,068 unpadded rows; the kernel API's #13 unpacked entry,
                #14-#17 and #24 -- and #16, #17 at S = 362, #11, #12 at
                the B=16 forward's and step's 16 clips and #24 at the
                stem's other stride-1 units; and at the geometries past the
                paper's, selfcheck.GEOMETRY_VARIANTS: #11 at T1 = 9, 17,
                33 and #12 at 9, 17 (16 clips: the general lanes), #10 and
                #13 at S = 408 and 792 (16 clips), #1 at T1 = 9, #2 and
                #15, #13's unpacked entry at S = 408, #9 at T1 = 9 and S =
                408, #16 / #17 at T1 = 9) vs its plain PyTorch version
                on the card at the slice's shapes (2 clips, T+1 = 7, S =
                368, n_valid = 362; #24 12 frames): f32 at atol = rtol =
                2e-3 (int8 kernels) or
                1e-5 (float kernels; backward kernels max|diff| <= 1e-5
                max|plain| per output; the whole layer #9 as a
                free-running chain, rel-L2 < 1e-2 and max|diff| < 0.02
                max|plain|: kernels/selfcheck.py says why), bf16 at
                rel-L2 < 1e-2 and max|diff| < 0.02 max|plain| (#16, #17:
                and the share of bf16 elements equal bit for bit); median
                kernel / plain / library-call ms and the card's least time
                (bound), and for the kernels that a CLI path or the kernel
                API phase runs in f32 (F32_PATH) the f32 kernel / plain /
                library-call ms (under highest(), TF32 off) and bound too
                (the f32 GEMM's, spatial attention's and #24's pointwise
                products as three TF32 products, the FMA pipes' time
                beside it); for #24 also its composition yardstick's ms in
                both dtypes (selfcheck.sepconv_cudnn: the stem's cuDNN
                route);
                then the float GEMM alone (kernels/linear.gemm) at each of
                its callers' shapes at the slice (selfcheck.gemm_shapes:
                #18, #20 and its backward, #21 / #6 / #22 fc1 and fc2, #19,
                #23's four) with bf16 inputs vs its plain f32 version by
                the bf16 criterion, with its device ms
                (tools/kernel_ms.device_ms), TFLOP/s, the bound and
                torch.matmul's device ms on the same operands; then the
                same table with f32 inputs (three TF32 products) vs the
                plain f32 product by selfcheck.gemm_f32_close (nn, nt atol
                = rtol = 1e-5; tn max|diff| <= 1e-5 max|plain|), its share
                of the TF32 bound and of the FMA pipes' time, and
                torch.matmul in f32 with TF32 off;
                then the int8 GEMM alone (kernels/quant.gemm_q8) at each
                int8 caller's shape at the slice (selfcheck.gemm_q8_shapes:
                #1-#8's QKV, out-projections, fc1 and fc2 with their
                epilogues) vs its plain version (the exact int8 dot, the
                same f32 epilogue): bit for bit without GELU, atol = rtol
                = 2e-3 with it; device ms, TOP/s and share of the int8
                peak, the bound, and torch._int_mm's device ms on the same
                codes (a yardstick the port never calls)
  then for each serving path, int8 first, then float in bf16 and f32:
  4. serving  - the model behind the HTTP ServeDaemon: float32 and uint8
                POSTs, a 16-clip batch and two concurrent requests, all
                HTTP 200 with finite logits; counted from 0 just before,
                each kernel of the path must have launched exactly its
                launches per forward times the forwards, every other 0,
                and no int8 wrapper built a K-major weight copy in a call
                (the model holds them: _lib.KMAJOR_BUILDS 0; so in every
                counted phase below)
  5. e2e      - 1-clip logits on the card (kernels, bf16 or f32) vs the
                same model on the CPU (plain versions, f32): |dlogit| <=
                5e-2
  6. timing   - B=16 forward, median ms and clips/s
                (tools/torch_forward_ms.forward_times: CUDA events, a
                distinct input per iteration, in the path's input dtype),
                counted from 0: each kernel exactly its launches per
                forward times the forwards, every other 0
  after the int8 path, for each A/B mode on its weights (quantize_params
  as cli/serve.py --int8 runs it, then pack_params for 'mixed' / 'bf16'):
  4m. launches - one counted B=16 forward: each kernel exactly its
                launches per forward (MODE_PER_LAYER x depth), every other
                0; for 'boundary' and 'layer', its 16 logits vs the
                'ingest' logits of the same clips within atol = rtol =
                2e-2 (tests/test_quant.py:245-270), and whether they are
                equal bit for bit; for 'layer', the CUDA kernels of one
                profiled B=16 forward by name: #9's persistent kernel
                exactly once a layer, none of the row, GEMM or attention
                kernels of the #1-#3 chain it replaces
  5m, 6m      - phases 5 and 6 for the mode
  then training, through cli/train.py's code path (check_args, build,
  the Trainer's step):
  7. train    - B=16 steps at depth 12, bf16: median ms/step and peak
                device memory; counted from 0 over the timed steps, every
                kernel must have launched exactly its launches per step
                (TRAIN_PER_LAYER x depth) times the steps, every other 0;
                then the same steps fed by device_feed (informative)
  8. train e2e - one step at depth 2 (full width, 300^2, B=2): the card
                (kernels, bf16) vs the CPU (plain versions, f32) from the
                same weights and batch: |dloss| <= 5e-2, gradient cosine
                >= 0.99
  8b. train dropout - the default recipe at depth 12, B=8, f32, dropout
                0.5, for each of DROPOUT_RECIPES (without --use_pallas,
                with --remat, with --use_pallas, with both): median ms a
                step of 3 after a warm-up, peak device memory, losses;
                counted: exactly dropout_launches (none without
                --use_pallas; with it the attention blocks' kernels
                forward and backward, DROPOUT_PER_LAYER, the forward ones
                twice with --remat), every other 0
  8c. train dropout e2e - one depth-2 B=2 step of each of
                DROPOUT_RECIPES, card (f32) vs CPU (plain, f32), the same
                weights, batch and dropout masks: |dloss| <= 5e-2, gradient
                cosine >= 0.99 (the train gate), and the f32 limits
                |dloss| <= 1e-5, cosine >= 0.99999; cuDNN deterministic,
                each --remat step's loss and gradients on the card equal,
                bit for bit, those of the same step without --remat
  8d. checkpoint - depth 2, B=2, --use_pallas --dropout 0.5, one step an
                epoch, cuDNN deterministic: a Trainer saves two epochs, a
                fresh one restores and takes the third step (then
                recalibrate_bn over one batch, counted: one step's and two
                forwards' launches), vs three uninterrupted steps:
                parameters max|d| / max|p| <= 1e-6 (stated in advance;
                whether bit-equal is printed); recalibrate_bn on the card
                vs the CPU on the same weights and batch (each running
                statistic rel-L2 <= 1e-4); cli/serve --checkpoint_dir's
                logits vs the trained model's eval logits (|d| <= 1e-5);
                cli/visualize --model_path writes its 18 PNGs
  8e. data - from disk (data/, native/, cli/score.py): what the machine has
                (PIL, cv2, the clipdecode / videodecode builds, CPUs); an
                FF++ frame tree (hq / lq x the 5 methods x 4 videos x 12
                JPEG frames of 320^2; PNGs of interpret/heatmap.png_bytes
                without PIL); cli/score.py --int8 -bs 16 over 32 hq clips
                at depth 12, counted: exactly #1-#3 x 12 a forward, every
                other 0; one JSON line a clip; the clips the card scored
                equal the CPU dataset's items bit for bit; the first two
                clips' logits vs the CPU's plain versions (|d| <= 5e-2);
                cli/train.py --dataset ff++ --use_pallas (the default
                recipe, f32, dropout 0.5) B=8 over 16 clips, counted: the
                2 steps' DROPOUT_PER_LAYER and the val pass's float
                forwards, a val dict with acc_type_0..4, --test_mode's hq
                and lq lines; device_feed's card batch equal to the host
                batch, device_normalize of a raw_uint8 batch on the card
                vs the host f32 normalize (1e-6); figures (informative):
                the loader alone (8 workers) in clips/s, per decoder and
                for raw_uint8 clips, the int8 B=16 forward alone, the score
                pipeline (disk -> loader -> device_feed -> int8 forward) in
                clips/s with the device's busy share under torch.profiler;
                one ff++video RawVideoDataset item where cv2 or videodecode
                is there
  then the interpretability path, B=1, f32 with TF32 off:
  9. interpret - generate_lrp for each method, with use_pallas (counted
                from 0: fused_ff exactly 12 launches per call, every other
                counter 0) and without (every counter 0); generate_full_lrp
                (finite, non-negative cams); generate_feature_relevance
                through the fused forward and its backward kernels in eval
                mode (exactly a train step's launches per layer x 12 per
                call); each a warm-up then 3 timed calls: ms per call and
                peak device memory; the
                visualize CLI (`cli/visualize.main`, --dataset synthetic
                --max_clips 1): 18 PNGs (12 overlays of 304^2, 6 frames of
                300^2), every counter 0
 10. interpret e2e - depth 2: the card (kernels) vs the CPU (plain
                versions) from the same weights and clip: cam_s, cam_t of
                transformer_attribution at rel-L2 <= 1e-3, |dlogit| <= 1e-4
 11. kernel api - f32, counted from 0: spatial_attention_pallas and
                temporal_attention_pallas forward and backward at (2, 7,
                368, 8 x 64), fused_frame_attention at (112, 368, 64),
                sepconv_bn forward and backward on block2's first unit of
                the stem (12 x 74^2 x 128 -> 256, eval BN folded by
                fold_bn): exactly one launch of each kernel-API counter
                (API_LAUNCHES), every other 0; every earlier counted phase
                held those six at 0 (no model path reaches them, as in the
                JAX package); the outputs and gradients vs the plain
                versions (max|diff| <= 1e-5 max|plain|) and vs autograd of
                JAX's XLA references (2e-4), sepconv_bn vs the stem's own
                cuDNN composition (atol = rtol = 1e-5, its gradient 1e-5
                max)
 12. distill - distillation and certification (train/distill.py,
                train/certify.py), counted: `cli/train.py --distill_from` a
                seed-0 300^2 / depth-12 checkpoint (--teacher_input_size
                300, -is 224 --depth 6 --use_pallas --dropout 0 --bf16), 2
                steps of B=8 and one val pass, exactly the teacher's float
                forward x 12 a batch, the student's train step x 6 a step
                and each val forward x 6, and the step time with and
                without the teacher hook; one depth-2 B=2 distill step at
                224^2 card (f32) vs CPU (plain, f32), logit-only with
                use_pallas and with attention transfer (attn_weight 2,
                XLA-math): |dloss| <= 1e-5, gradient cosine >= 0.99999; the
                teacher hook at 300^2 / depth 2 with cams, resized to
                224^2, card vs CPU: logits 1e-4, cams rel-L2 1e-3, the
                antialiased resize 1e-4 (max|d|); `cli/certify.py` at
                300^2/d12 -> 224^2/d6 on a reduced budget (1 + 1 epochs,
                16 + 16 clips):
                CERT_RECIPE.json's keys and criteria (less the export's),
                the int8 leg exactly #1-#3 x 6, each leg's wall time and
                peak memory, and a second run restoring the teacher from
                --teacher_ckpt with the same teacher_auc
 13. artifact - the serving artifact (serve_export.py; the forward
                kernels as istvt:: dispatcher ops, kernels/ops.py), for the
                int8, the bf16 float and the f32 float path in turn:
                `cli/export.py --batch_sizes 1 16 --selftest` at depth 12
                (ARTIFACT_DEPTH), 300^2 x 6 (export and load seconds, the
                directory's size, the selftest within 1e-3); the program
                holds exactly the path's ops (SERVE_PER_LAYER x depth, #20's
                two counters one op) and no other istvt:: op; 16 clips
                through the loaded artifact and the live Predictor on the
                same weights, each counted: exactly the path's launches a
                forward, every other 0, no K-major copy built; their
                logits within 1e-3 (whether bit for bit is printed); the
                B=16 forward median of the artifact and of the live model
                (both from f32 clips, cast inside), in turns, counted, with
                the interpreter's garbage collections over them; then
                for the int8 and the f32 artifact `cli/serve.py --artifact
                DIR` as a subprocess: one HTTP request whose logit matches
                the artifact's own in this process (1e-3; bit equality
                printed), the daemon under 16 client threads of 8
                one-clip requests (clips/s, p50 / p99 and batches from
                /v1/stats) and 50 sequential one-clip requests (median and
                p99 ms, client side), all informative
 14. bench    - the bench CLI and the tooling: `cli/bench.main` in this
                process at 300^2 x 6, depth 12 (BENCH_RUNS): --quantize
                int8 -bs 16 --chained, -bs 16 and -bs 1 per call in bf16,
                --train_step -bs 16 --grad_accum 2 and with --remat,
                --pipeline -bs 16 over a synthetic 300^2 JPEG tree (uint8,
                --f32_ingest, --f32_ingest --no_native): each JSON line has
                the keys of JAX's CLI for its mode (BENCH_KEYS) and platform
                'gpu'; counted from 0, each kernel exactly its launches a
                forward or a microbatch's step x the run's forwards or steps
                (bench_launches), every other 0; utils/debug.debug_nans on a
                depth-2 B=2 bf16 fused step (cli/train.py's build, cuDNN
                deterministic): loss and gradient norm bit-equal to the
                same step's without the mode (parameters: printed), the
                host ms a step with and without it, one NaN pixel raises
                FloatingPointError, and the mode is gone after; one B=16
                bf16 train step at depth 12 inside utils/profiling.trace,
                summarized by utils/trace_summary: device time by the
                operator that launched it, the port's (istvt::) apart, the
                top 25 rows, copies and memsets apart
 15. geometry - the fused paths at geometries past the paper's that the
                JAX package runs (GEOMETRIES: --seq_len 8 and 16 at 300^2,
                T1 = 9 and 17; -is 320 and 448 at --seq_len 6, S = 408 and
                792), depth 2, B=2, full width: the int8 (`ingest`), bf16
                and f32 float forwards (cli/serve.build_predictor) vs the
                same model on the CPU (plain versions, f32): |dlogit| <=
                5e-2 (the f32 maximum printed), counted: exactly the path's
                launches a forward, every other 0; at --seq_len 8 the
                `layer` mode's logits vs `ingest`'s (atol = rtol = 2e-2),
                counted; one f32 --use_pallas train step at --seq_len 8,
                -is 320 (#11, #12, #10, #13 at T1 = 9, S = 408), card vs
                CPU from the same weights and batch: |dloss| <= 1e-5,
                gradient cosine >= 0.99999, counted; then, informative, the
                B=16 depth-12 int8 and bf16 forwards at --seq_len 8 and at
                -is 320, counted

The line before the last is the kernels' JSON record (`launches`: each
kernel's launches over every counted run above; a kernel that no counted
run launched fails the script; a kernel's cases at other shapes under
`variants`); the last line is {"ok": true, "device":
{...}}. With --profile PATH, torch.profiler tables of one B=16 forward of
each serving path and int8 mode, of one B=16 train step, of one B=1
generate_lrp call with and without use_pallas and of one B=16 forward of
each serving artifact and its live model are written to PATH, each with
its device time summed by kernel family.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import http.client
import io
import json
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

_ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tools")]

from istvt_tpu_torch import native  # noqa: E402
from istvt_tpu_torch.cli import score as cli_score  # noqa: E402
from istvt_tpu_torch.cli import serve as cli_serve  # noqa: E402
from istvt_tpu_torch.cli import train as cli_train  # noqa: E402
from istvt_tpu_torch.cli import visualize as cli_visualize  # noqa: E402
from istvt_tpu_torch.core import tree  # noqa: E402
from istvt_tpu_torch.core.config import ISTVTConfig  # noqa: E402
from istvt_tpu_torch.core.device import require_cuda  # noqa: E402
from istvt_tpu_torch.core.precision import highest  # noqa: E402
from istvt_tpu_torch.data import (  # noqa: E402
    ClipLoader, Transform, VideoSeqDataset, device_feed, device_normalize)
from istvt_tpu_torch.data.manifest import FFPP_METHODS  # noqa: E402
from istvt_tpu_torch.interpret import (  # noqa: E402
    generate_feature_relevance, generate_full_lrp, generate_lrp)
from istvt_tpu_torch.interpret.heatmap import png_bytes  # noqa: E402
from istvt_tpu_torch.kernels import _lib, selfcheck  # noqa: E402
from istvt_tpu_torch.models import istvt  # noqa: E402
from istvt_tpu_torch.serve_daemon import ServeDaemon  # noqa: E402
from istvt_tpu_torch.cli import bench as cli_bench  # noqa: E402
from istvt_tpu_torch.cli import certify as cli_certify  # noqa: E402
from istvt_tpu_torch.cli import export as cli_export  # noqa: E402
from istvt_tpu_torch.kernels import ops as kernel_ops  # noqa: E402
from istvt_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from istvt_tpu_torch.train import distill as D  # noqa: E402
from istvt_tpu_torch.train import losses as L  # noqa: E402
from istvt_tpu_torch.train import step as S  # noqa: E402
from istvt_tpu_torch.utils import trace_summary  # noqa: E402
from istvt_tpu_torch.utils.debug import (  # noqa: E402
    debug_nans, nan_check_active)
from istvt_tpu_torch.utils.profiling import trace  # noqa: E402
from torch_forward_ms import INT8_MODES as TOOL_MODES  # noqa: E402
from torch_forward_ms import (ITERS, PACKED, PATH_FLAGS,  # noqa: E402
                              WARMUP, alloc_counters, forward_times,
                              gc_pauses, input_dtype, set_mode)
from torch_train_ms import (TRAIN_BATCH, build_trainer,  # noqa: E402
                            kernel_families, paper_trainer, train_times,
                            warm_up)
from kernel_ms import gemm_q8_rows, gemm_rows, median_ms  # noqa: E402

# the serving paths, by their cli/serve.py flags (int8, float in bf16, float
# in f32), at the CLI's default paper geometry (300^2 x 6, depth 12)
PATHS = PATH_FLAGS
PAPER = ISTVTConfig()
DEPTH = PAPER.depth
CLIP = (PAPER.num_frames, PAPER.image_size, PAPER.image_size, 3)
_CSRC = "istvt_tpu_torch/kernels/csrc/"

# kernel (launch-count name): (source, TPU kernel it replaces)
KERNELS = {
    "ln_qkv_q8_temporal_attention": (
        _CSRC + "q8_attention.cu", "istvt_tpu/kernels/quant.py:559"),
    "mm_q8_ln_qkv_q8_spatial_attention": (
        _CSRC + "q8_attention.cu", "istvt_tpu/kernels/quant.py:635"),
    "matmul_q8_res_ln_ff_q8_full": (
        _CSRC + "q8_rows_gemm.cu", "istvt_tpu/kernels/quant.py:422"),
    "ln_matmul_q8": (
        _CSRC + "q8_rows_gemm.cu", "istvt_tpu/kernels/quant.py:70"),
    "matmul_q8_ln_matmul_q8": (
        _CSRC + "q8_rows_gemm.cu", "istvt_tpu/kernels/quant.py:348"),
    "matmul_q8_bias_residual": (
        _CSRC + "q8_rows_gemm.cu", "istvt_tpu/kernels/quant.py:130"),
    "matmul_q8_bias_residual/no_r": (
        _CSRC + "q8_rows_gemm.cu", "istvt_tpu/kernels/quant.py:130"),
    "ln_ff_residual_q8": (
        _CSRC + "q8_rows_gemm.cu", "istvt_tpu/kernels/quant.py:205"),
    "st_layer_q8": (
        _CSRC + "q8_layer.cu", "istvt_tpu/kernels/quant.py:838"),
    "ln_ff_residual_q8_full": (
        _CSRC + "q8_rows_gemm.cu", "istvt_tpu/kernels/quant.py:273"),
    "temporal_attention_packed": (
        _CSRC + "q8_attention.cu", "istvt_tpu/kernels/attention.py:324"),
    "spatial_attention_packed": (
        _CSRC + "q8_attention.cu", "istvt_tpu/kernels/attention.py:190"),
    "ln_matmul": (
        _CSRC + "float_gemm.cu", "istvt_tpu/kernels/linear.py:82"),
    "matmul_bias_residual": (
        _CSRC + "float_gemm.cu", "istvt_tpu/kernels/linear.py:248"),
    "matmul_bias_residual/no_r": (
        _CSRC + "float_gemm.cu", "istvt_tpu/kernels/linear.py:248"),
    "ln_ff_residual": (
        _CSRC + "float_gemm.cu", "istvt_tpu/kernels/mlp.py:102"),
    # the training slice
    "temporal_attention_packed/bwd": (
        _CSRC + "attention_bwd.cu", "istvt_tpu/kernels/attention.py:440"),
    "spatial_attention_packed/bwd": (
        _CSRC + "attention_bwd.cu", "istvt_tpu/kernels/attention.py:842"),
    "ln_matmul/bwd": (
        _CSRC + "float_gemm.cu", "istvt_tpu/kernels/linear.py:165"),
    "ln_ff_residual/h1": (
        _CSRC + "float_gemm.cu", "istvt_tpu/kernels/mlp.py:150"),
    "ln_ff_residual/bwd": (
        _CSRC + "float_gemm.cu", "istvt_tpu/kernels/mlp.py:270"),
    # the interpretability slice (the attention-map forward's feed-forward)
    "fused_ff": (
        _CSRC + "float_gemm.cu", "istvt_tpu/kernels/mlp.py:35"),
    # the kernel API (on no model path, as in the JAX package)
    "fused_frame_attention": (
        _CSRC + "q8_attention.cu", "istvt_tpu/kernels/attention.py:114"),
    "fused_frame_attention_mh": (
        _CSRC + "q8_attention.cu", "istvt_tpu/kernels/attention.py:141"),
    "fused_frame_attention_bwd": (
        _CSRC + "attention_bwd.cu", "istvt_tpu/kernels/attention.py:842"),
    "fused_temporal_attention": (
        _CSRC + "temporal_unpacked.cu", "istvt_tpu/kernels/attention.py:553"),
    "fused_temporal_attention_bwd": (
        _CSRC + "temporal_unpacked.cu", "istvt_tpu/kernels/attention.py:662"),
    "sepconv_bn": (
        _CSRC + "sepconv_bn.cu", "istvt_tpu/kernels/conv.py:67"),
}

# launches per layer of one serving forward, by path; every counter not
# listed stays 0
SERVE_PER_LAYER = {
    "int8": {"ln_qkv_q8_temporal_attention": 1,
             "mm_q8_ln_qkv_q8_spatial_attention": 1,
             "matmul_q8_res_ln_ff_q8_full": 1},
    "float": {"ln_matmul": 2, "temporal_attention_packed": 1,
              "spatial_attention_packed": 1, "matmul_bias_residual": 1,
              "matmul_bias_residual/no_r": 1, "ln_ff_residual": 1},
}
SERVE_PER_LAYER["float32"] = SERVE_PER_LAYER["float"]
# the int8 A/B modes after the int8 path: (q8_ff, q8_attn)
# (torch_forward_ms.INT8_MODES, 'ingest' being the int8 path itself) and
# launches per layer of one forward (models/istvt.py:258-356)
INT8_MODES = {m: v for m, v in TOOL_MODES.items() if m != "ingest"}
_Q8_BLOCKS = {"ln_matmul_q8": 2, "temporal_attention_packed": 1,
              "spatial_attention_packed": 1, "matmul_q8_bias_residual": 1,
              "matmul_q8_bias_residual/no_r": 1}
MODE_PER_LAYER = {
    "boundary": {"ln_matmul_q8": 1, "temporal_attention_packed": 1,
                 "matmul_q8_ln_matmul_q8": 1, "spatial_attention_packed": 1,
                 "matmul_q8_res_ln_ff_q8_full": 1},
    "mixed": {**_Q8_BLOCKS, "ln_ff_residual_q8": 1},
    "bf16_ff": {**_Q8_BLOCKS, "ln_ff_residual": 1},
    "layer": {"st_layer_q8": 1},
    "ff_int8": {**_Q8_BLOCKS, "ln_ff_residual_q8_full": 1},
}
# the modes whose logits must match the 'ingest' chain's (the same
# quantization points), and the CUDA kernels (by name) that a 'layer'
# forward must not launch: those of the #1-#3 chain that #9 replaces
SAME_AS_INGEST = ("boundary", "layer")
CHAIN_KERNELS = ("quant_rows_kernel", "gemm_q8_wgmma_kernel",
                 "temporal_attn_kernel", "spatial_attn_kernel")

# launches per layer of one float fused train step (dropout 0): the
# forward's kernels, except that the FF branch runs its h1-stash variant,
# and the backward kernels; every other counter stays 0
TRAIN_PER_LAYER = {
    "ln_matmul": 2, "temporal_attention_packed": 1,
    "spatial_attention_packed": 1, "matmul_bias_residual": 1,
    "matmul_bias_residual/no_r": 1, "ln_ff_residual/h1": 1,
    "temporal_attention_packed/bwd": 1, "spatial_attention_packed/bwd": 1,
    "ln_matmul/bwd": 2, "ln_ff_residual/bwd": 1,
}

# launches per layer of one f32 train step of the reference's default recipe
# (--dropout 0.5) with --use_pallas: the attention blocks' kernels forward
# and backward; the feed-forward with its dropout is plain torch
# (models/istvt.py:366-376), so neither #21 variant nor #23 runs. Without
# --use_pallas no kernel runs (the XLA-math path). With --remat each layer's
# forward kernels run again in the backward pass.
DROPOUT_PER_LAYER = {n: k for n, k in TRAIN_PER_LAYER.items()
                     if not n.startswith("ln_ff_residual")}
FORWARD_PER_LAYER = {n: k for n, k in DROPOUT_PER_LAYER.items()
                     if not n.endswith("/bwd")}
# the default recipe's timed variants: extra cli/train.py flags
DROPOUT_RECIPES = {"xla-math": [], "xla-math --remat": ["--remat"],
                   "fused": ["--use_pallas"],
                   "fused --remat": ["--use_pallas", "--remat"]}
DROPOUT_BATCH, DROPOUT_STEPS = 8, 3


def dropout_launches(flags, steps, depth):
    """{kernel: launches} of `steps` dropout train steps of a depth-`depth`
    model with these extra flags."""
    if "--use_pallas" not in flags:
        return {}
    per = {n: k + (FORWARD_PER_LAYER.get(n, 0) if "--remat" in flags else 0)
           for n, k in DROPOUT_PER_LAYER.items()}
    return {n: k * steps * depth for n, k in per.items()}


# kernels that a path runs in f32 (float serving and training without --bf16,
# the interpretability path; the kernel API phase's spatial entries and
# sepconv_bn): phase 3 times them in f32 as well as in bf16
F32_PATH = ({*SERVE_PER_LAYER["float"], *TRAIN_PER_LAYER}
            | {"fused_ff", "sepconv_bn", "fused_frame_attention",
               "fused_frame_attention_mh", "fused_frame_attention_bwd"})
# the kernel API phase: launches of one call of each entry point (forward
# and backward of the differentiable ones)
API_LAUNCHES = {"fused_frame_attention_mh": 1, "fused_frame_attention_bwd": 1,
                "fused_temporal_attention": 1,
                "fused_temporal_attention_bwd": 1, "fused_frame_attention": 1,
                "sepconv_bn": 1}



def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


# launches of each kernel over every counted run (the serving forwards, the
# modes' counted forwards, the timed train steps and LRP calls): the
# kernels line's `launches`
TOTAL = dict.fromkeys(KERNELS, 0)


def _tally(want_nonzero):
    """SystemExit unless every launch counter equals want_nonzero's entry
    (0 where it has none) and no int8 wrapper built a K-major weight copy
    in a call; else add the counts to TOTAL."""
    counts = dict(_lib.LAUNCHES)
    want = {n: want_nonzero.get(n, 0) for n in counts}
    if counts != want:
        raise SystemExit(f"launches {counts}, want {want}")
    if _lib.KMAJOR_BUILDS["q8_kmajor"]:
        raise SystemExit(f"a model path built {_lib.KMAJOR_BUILDS} K-major "
                         f"weight copies in its calls")
    for n, k in counts.items():
        TOTAL[n] += k
    return counts


# ---------------------------------------------------------------------------
# 3. kernels vs plain


def check_kernels(dev):
    """Every case vs its plain version in f32 and bf16, then bf16 times.
    Returns {case: JSON fields}."""
    rows = {}
    for name, (kern, plain, make) in selfcheck.slice_cases(dev).items():
        counter = selfcheck.counter(name)
        args = make(torch.float32)
        with highest():
            got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        ok32, err32 = selfcheck.f32_close(name, got, want)
        args16 = make(torch.bfloat16)
        out16 = kern(*args16)
        want16 = plain(*args16)
        ok16, rel, mx, scale = selfcheck.bf16_close(out16, want16)
        extra = {}
        if counter in selfcheck.BITWISE_CASES:
            extra["bf16_bit_equal"] = selfcheck.bit_equal_share(out16,
                                                                want16)
        torch.cuda.synchronize()
        ms_plain_a = median_ms(lambda: plain(*args16))
        ms_kern_a = median_ms(lambda: kern(*args16))
        ms_kern_b = median_ms(lambda: kern(*args16))
        ms_plain_b = median_ms(lambda: plain(*args16))
        ms, plain_ms = min(ms_kern_a, ms_kern_b), min(ms_plain_a, ms_plain_b)
        lib = selfcheck.library_call(counter, args16)
        lib_ms = None if lib is None else median_ms(lib)
        bound_ms, bound_by = selfcheck.case_bound_ms(counter, args16, out16)
        if counter == "sepconv_bn":
            extra["cudnn_ms"] = median_ms(selfcheck.sepconv_cudnn(args16))
        if counter in F32_PATH:
            # a path runs it in f32: time that too, with its yardstick
            with highest():
                f32_ms = [median_ms(lambda: kern(*args)),
                          median_ms(lambda: plain(*args))]
                lib32 = selfcheck.library_call(counter, args)
                lib32_ms = None if lib32 is None else median_ms(lib32)
                cudnn32 = ({"cudnn_ms": median_ms(
                    selfcheck.sepconv_cudnn(args))}
                    if counter == "sepconv_bn" else {})
            b32, by32 = selfcheck.case_bound_ms(counter, args, got,
                                                torch.float32)
            extra["f32"] = {"ms": f32_ms[0], "plain_ms": f32_ms[1],
                            "bound_ms": b32, "bound_by": by32,
                            "library_ms": lib32_ms, **cudnn32}
            fma = ""
            if counter in selfcheck.TF32_CASES:
                # the same products on the FMA pipes: a reading for the
                # text only, not a measurement, so not in the kernels line
                fma_ms = 1e3 * selfcheck.case_ops(counter, args).get(
                    "bf16", 0) / selfcheck.PEAK_OPS["f32"]
                fma = f", FMA pipes {fma_ms:.4f}"
            phase("kernels", f"{name}: f32 median ms kernel {f32_ms[0]:.4f} "
                  f"plain {f32_ms[1]:.4f} library {lib32_ms} bound "
                  f"{b32:.4f} ({by32}{fma})"
                  + "".join(f"; {k} {v:.4f}" for k, v in cudnn32.items()))
        crit = ("rel-L2 < " if counter in selfcheck.FREE_RUNNING_CASES
                else "") + str(selfcheck.f32_tol(name))
        phase("kernels", f"{name}: f32 max|diff| {err32:.3e} "
              f"({'ok' if ok32 else 'FAIL'} at {crit}); "
              f"bf16 rel-L2 {rel:.3e} "
              f"max|diff| {mx:.3e} vs max|plain| {scale:.3e} "
              f"({'ok' if ok16 else 'FAIL'}); bf16 median ms kernel "
              f"{ms_kern_a:.4f}/{ms_kern_b:.4f} plain "
              f"{ms_plain_a:.4f}/{ms_plain_b:.4f} library {lib_ms} "
              f"bound {bound_ms:.4f} ({bound_by})"
              + "".join(f"; {k} {v:.4f}" for k, v in extra.items()
                        if k != "f32"))
        if not (ok32 and ok16):
            raise SystemExit(f"kernel {name} disagrees with its plain version")
        rows[name] = {"max_abs_err": err32, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": lib_ms, **extra}
    return rows


def gemm_phase(dev):
    """Phase 3's GEMM tables: kernels/linear.gemm at every float caller's
    shape at the slice (selfcheck.gemm_shapes), with bf16 inputs against
    its plain f32 version by the bf16 criterion, then with f32 inputs (three
    TF32 products) by selfcheck.gemm_f32_close; its device ms, torch.matmul's
    on the same operands (TF32 off; a yardstick the port never calls), the
    bound (selfcheck.gemm_bound_ms) and the share of it, in f32 also the
    share of the FMA pipes' time."""
    for dtype in (torch.bfloat16, torch.float32):
        for name, layout, m, n, k, ms, mm, tflops, (bound, by, fma), ops, _ \
                in gemm_rows(selfcheck, dev, dtype=dtype):
            with highest():
                want = selfcheck.gemm_plain(ops)
            got = selfcheck.gemm_results(ops)
            torch.cuda.synchronize()
            if dtype == torch.float32:
                ok, err = selfcheck.gemm_f32_close(ops, got, want)
                crit = (f"{'max|diff| / max|plain|' if layout == 'tn' else 'max|diff|'}"
                        f" {err:.3e} ({'ok' if ok else 'FAIL'} at "
                        f"{selfcheck.F32_TOL_FLOAT}); FMA pipes {fma:.4f} ms "
                        f"({fma / ms:.1%} of it)")
            else:
                ok, rel, mx, scale = selfcheck.bf16_close(got, want)
                crit = (f"rel-L2 {rel:.3e} max|diff| {mx:.3e} of max|plain| "
                        f"{scale:.3e} ({'ok' if ok else 'FAIL'})")
            phase("gemm", f"{name}: {str(dtype)[6:]} {layout} {m} x {n} x {k}"
                  f" -> {ops['out'].dtype}: device ms {ms:.4f} ({tflops:.1f} "
                  f"TFLOP/s), torch.matmul {mm:.4f}, bound {bound:.4f} ({by},"
                  f" {bound / ms:.1%} of it); vs plain {crit}")
            if not ok:
                raise SystemExit(f"GEMM {name} in {dtype} disagrees with its "
                                 f"plain version")


def gemm_q8_phase(dev):
    """Phase 3's int8 GEMM table: kernels/quant.gemm_q8 at every int8
    caller's shape at the slice (selfcheck.gemm_q8_shapes) against its
    plain version (bit for bit without GELU, 2e-3 with), its device ms,
    TOP/s and share of the int8 peak, the bound, and torch._int_mm's
    device ms on the same codes and weight, the faster of its row- and
    column-major layouts (tools/kernel_ms.gemm_q8_rows)."""
    tol = selfcheck.F32_TOL_INT8
    for name, (m, n, k, out_dt, res_dt, _, gelu), ms, (lib_ms, lib_layout), \
            tops, bound, ops in gemm_q8_rows(selfcheck, dev):
        want = selfcheck.gemm_q8_plain(ops)
        got = ops["out"]
        torch.cuda.synchronize()
        same = selfcheck.bit_equal_share(got, want)
        ok = (torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
              if gelu else same == 1.0)
        phase("gemm_q8", f"{name}: {m} x {n} x {k} -> {out_dt}"
              + (f" + r {res_dt}" if res_dt is not None else "")
              + f": device ms {ms:.4f} ({tops:.1f} TOP/s, "
              f"{tops / (selfcheck.PEAK_OPS['int8'] / 1e12):.1%} of peak), "
              f"torch._int_mm {lib_ms} (weight {lib_layout}), bound "
              f"{bound:.4f}; vs plain: "
              f"bit-equal share {same:.6f} ({'ok' if ok else 'FAIL'}: "
              f"{'2e-3' if gelu else 'all equal'} wanted)")
        if not ok:
            raise SystemExit(f"int8 GEMM {name} disagrees with its plain "
                             f"version")


# ---------------------------------------------------------------------------
# 4. serving through the HTTP daemon


def _post(port, arr):
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/v1/predict", body=buf.getvalue(),
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _expect(status, body, n, what):
    if status != 200:
        raise SystemExit(f"{what}: HTTP {status} {body}")
    logits = np.asarray(body["logits"], np.float64)
    if logits.shape != (n,) or not np.all(np.isfinite(logits)):
        raise SystemExit(f"{what}: bad logits {body['logits']}")
    phase("serving", f"{what}: HTTP 200, logits {np.round(logits, 5).tolist()}")


def serve_phase(path, predictor):
    """HTTP requests through ServeDaemon; returns the launches they made."""
    rng = np.random.RandomState(0)
    for b in predictor.batch_sizes:                       # warm every bucket
        predictor.predict(np.zeros((b,) + CLIP, np.float32))
    torch.cuda.synchronize()
    _lib.reset_launches()
    predictor.n_forwards = 0
    daemon = ServeDaemon(predictor, CLIP, host="127.0.0.1", port=0,
                         max_batch=16, max_wait_ms=5.0).start()
    try:
        _expect(*_post(daemon.port, rng.randn(*CLIP).astype(np.float32)), 1,
                "1 float32 clip")
        _expect(*_post(daemon.port, rng.randint(0, 256, (3,) + CLIP)
                       .astype(np.uint8)), 3, "3 uint8 clips")
        _expect(*_post(daemon.port, rng.randn(16, *CLIP).astype(np.float32)),
                16, "16-clip batch")
        singles = [rng.randn(*CLIP).astype(np.float32) for _ in range(2)]
        replies = [None, None]

        def client(i):
            replies[i] = _post(daemon.port, singles[i])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            if t.is_alive():
                raise SystemExit("concurrent request did not finish")
        for i, r in enumerate(replies):
            _expect(*r, 1, f"concurrent clip {i}")
    finally:
        daemon.close()
    torch.cuda.synchronize()
    counts = _tally({n: k * DEPTH * predictor.n_forwards
                     for n, k in SERVE_PER_LAYER[path].items()})
    phase("serving", f"{path}: {predictor.n_forwards} card forwards; "
          f"launches {counts}")


def e2e_phase(path, predictor):
    """Card (kernels, in the path's dtype) vs CPU (plain versions, f32) on
    one clip."""
    clip = np.random.RandomState(1).randn(1, *CLIP).astype(np.float32)
    card_logit = predictor.predict(clip)["logits"]
    cpu_model = tree.cast(copy.deepcopy(predictor.model).to("cpu"),
                          torch.float32)
    if path in PACKED:
        istvt.pack_params(cpu_model)   # the (in, out) copies, now in f32
    t0 = time.perf_counter()
    with highest(), torch.inference_mode():
        cpu_logit = cpu_model(torch.from_numpy(clip)).reshape(-1).numpy()
    delta = float(np.abs(card_logit - cpu_logit).max())
    phase("e2e", f"{path}: card {card_logit.tolist()} vs CPU plain f32 "
          f"{cpu_logit.tolist()}: |dlogit| {delta:.3e} (limit 5e-2; CPU "
          f"forward {time.perf_counter() - t0:.1f} s)")
    if not delta <= 5e-2:
        raise SystemExit(f"{path}: card logits disagree with the CPU "
                         f"reference")


def _write_profile(prof, title, profile, rows=40):
    """Append a profile's table and its device time by kernel family
    (torch_train_ms.kernel_families) to the file `profile`."""
    fam = kernel_families(prof)
    with open(profile, "a") as f:
        f.write(title + "\n")
        f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=rows) + "\n")
        f.write(f"device ms, all kernels and copies: {sum(fam.values()):.3f}; "
                f"by family: " + json.dumps(
                    {k: round(v, 3) for k, v in sorted(
                        fam.items(), key=lambda kv: -kv[1])}) + "\n")


def timing_phase(path, model, dev, card, profile):
    """B=16 forward (tools/torch_forward_ms.forward_times) in the path's
    input dtype, counted: each kernel exactly its launches per forward (the
    path's SERVE_PER_LAYER or the mode's MODE_PER_LAYER entry x depth)
    times the forwards; optional profile of one more."""
    dtype = input_dtype(path)
    per_layer = SERVE_PER_LAYER.get(path) or MODE_PER_LAYER[path]
    _lib.reset_launches()
    times = forward_times(model, CLIP, dtype)
    _tally({n: k * DEPTH * (WARMUP + ITERS) for n, k in per_layer.items()})
    ms = float(np.median(times))
    phase("timing", f"{path}: B=16 forward median {ms:.3f} ms = "
          f"{16e3 / ms:.2f} clips/s on {card}; launches exactly "
          f"{WARMUP + ITERS} forwards' (informative)")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        x = torch.randn(16, *CLIP, device=dev).to(dtype)
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            with torch.inference_mode():
                model(x)
            torch.cuda.synchronize()
        _write_profile(prof, f"{card}, {path} path, B=16 forward", profile)
        phase("timing", f"{path}: profile table appended to {profile}")


def _chain_launches(model, dev):
    """CUDA kernel launches by name in one profiled B=16 forward:
    (#9's st_layer_q8_kernel, each kernel of the #1-#3 chain)."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    x = torch.randn(16, *CLIP, device=dev).to(torch.bfloat16)
    with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode():
            model(x)
        torch.cuda.synchronize()
    events = prof.key_averages()

    def count(name):
        return sum(e.count for e in events if name in e.key)

    return count("st_layer_q8_kernel"), {n: count(n) for n in CHAIN_KERNELS}


def mode_phases(predictor, dev, card, profile):
    """Phases 4m-6m: each A/B mode on the int8 path's weights."""
    clips = np.random.RandomState(5).randn(16, *CLIP).astype(np.float32)
    model = predictor.model
    ingest = predictor.predict(clips)["logits"]
    for mode, (q8_ff, q8_attn) in INT8_MODES.items():
        set_mode(model, mode)
        predictor.predict(clips)                               # warm-up
        torch.cuda.synchronize()
        _lib.reset_launches()
        predictor.n_forwards = 0
        logits = predictor.predict(clips)["logits"]
        torch.cuda.synchronize()
        counts = _tally({n: k * DEPTH * predictor.n_forwards
                         for n, k in MODE_PER_LAYER[mode].items()})
        if not np.isfinite(logits).all():
            raise SystemExit(f"{mode}: non-finite logits {logits}")
        phase("modes", f"{mode} (q8_ff={q8_ff!r}, q8_attn={q8_attn!r}): "
              f"{predictor.n_forwards} B=16 forward; launches {counts}")
        if mode in SAME_AS_INGEST:
            gap = np.abs(logits - ingest)
            ok = bool((gap <= 2e-2 + 2e-2 * np.abs(ingest)).all())
            phase("modes", f"{mode} vs ingest logits, 16 clips: max|d| "
                  f"{gap.max():.3e} ({'ok' if ok else 'FAIL'} at atol = "
                  f"rtol = 2e-2); bit for bit equal: "
                  f"{bool(np.array_equal(logits, ingest))}")
            if not ok:
                raise SystemExit(f"the {mode} path disagrees with the "
                                 f"ingest chain")
        if mode == "layer":
            n9, chain = _chain_launches(model, dev)
            phase("modes", f"layer: CUDA launches in one profiled B=16 "
                  f"forward: st_layer_q8_kernel {n9} (want {DEPTH}); the "
                  f"#1-#3 chain's kernels {chain} (want 0)")
            if n9 != DEPTH or any(chain.values()):
                raise SystemExit("the layer path did not run one #9 launch "
                                 "per layer and nothing of the chain")
        e2e_phase(mode, predictor)
        timing_phase(mode, model, dev, card, profile)


# ---------------------------------------------------------------------------
# 7-8. training through cli/train.py's code path


# a temporary directory for the run's checkpoints and PNGs (set by main)
WORK = None


def _workdir(name):
    path = os.path.join(WORK, name)
    os.makedirs(path, exist_ok=True)
    return path


def _trainer(flags, bf16=True):
    return build_trainer(cli_train, flags, _workdir("train"), bf16)


def _profile_step(trainer, ts, batch, card, profile):
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        float(trainer.step_fn(ts, batch)["loss"])
        torch.cuda.synchronize()
    _write_profile(prof, f"{card}, float fused path, B={TRAIN_BATCH} bf16 "
                   f"train step", profile, rows=50)
    phase("train", f"profile table appended to {profile}")


def train_phase(card, profile):
    """TRAIN_STEPS timed B=16 steps after one warm-up step, counted
    (tools/torch_train_ms.train_times)."""
    t0 = time.perf_counter()
    trainer, ts, batches = paper_trainer(cli_train, _workdir("train"))
    phase("train", f"model + {len(batches)} synthetic batches built in "
          f"{time.perf_counter() - t0:.1f} s")
    warm_up(trainer, ts, batches[0])
    _lib.reset_launches()
    times, losses = train_times(trainer, ts, batches[1:])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    depth = trainer.model.cfg.depth
    counts = _tally({n: k * depth * len(times)
                     for n, k in TRAIN_PER_LAYER.items()})
    ms = float(np.median(times))
    phase("train", f"B={TRAIN_BATCH} bf16 steps (ms) "
          f"{[round(t, 3) for t in times]}: median {ms:.3f} ms = "
          f"{TRAIN_BATCH * 1e3 / ms:.2f} clips/s; peak device memory "
          f"{peak:.2f} GiB; losses {[round(v, 5) for v in losses]} on "
          f"{card} (informative)")
    phase("train", f"launches over {len(times)} steps {counts}")
    fed, _ = _fed_train_times(trainer, ts, batches[1:])
    fed_ms = float(np.median(fed))
    phase("train", f"the same steps fed by data/loader.device_feed (pinned "
          f"copies on a side stream, one batch ahead; each step's host "
          f"clock from the loss read before it): "
          f"{[round(t, 3) for t in fed]}: median {fed_ms:.3f} ms vs "
          f"{ms:.3f} ms with the copy in the step, on {card} (informative)")
    _lib.reset_launches()
    if profile:
        _profile_step(trainer, ts, batches[1], card, profile)


def _fed_train_times(trainer, ts, batches):
    """(ms per step, losses) of one step per batch handed over by
    device_feed, as a fitting Trainer takes them: the host clock from one
    loss read to the next (the feed's hand-over included)."""
    times, losses = [], []
    dev = next(trainer.model.parameters()).device
    t0 = time.perf_counter()
    for batch in device_feed(batches, dev):
        m = trainer.step_fn(ts, batch)
        losses.append(float(m["loss"]))
        t1 = time.perf_counter()
        times.append(1e3 * (t1 - t0))
        t0 = t1
    return times, losses


def train_e2e_phase():
    """One depth-2 B=2 step: card (kernels, bf16) vs CPU (plain, f32)."""
    flags = ["--depth", "2", "--batch_size", "2", "--dataset_len", "2",
             "--epochs", "1"]
    card_tr, loader, _ = _trainer(flags)
    cpu_tr, _, _ = _trainer(flags + ["--device", "cpu"], bf16=False)
    batch = next(iter(loader))
    out = []
    t0 = time.perf_counter()
    for tr in (card_tr, cpu_tr):
        ts = tr.init_state()
        with highest():
            m = tr.step_fn(ts, batch)
        out.append((float(m["loss"]), torch.cat([
            p.grad.double().cpu().ravel() for p in tr.model.parameters()])))
    (l_card, g_card), (l_cpu, g_cpu) = out
    cos = float(F.cosine_similarity(g_card, g_cpu, dim=0))
    phase("train e2e", f"depth 2, B=2: loss card {l_card:.6f} vs CPU plain "
          f"f32 {l_cpu:.6f} (|d| {abs(l_card - l_cpu):.3e}, limit 5e-2); "
          f"gradient cosine {cos:.6f} (limit 0.99; "
          f"{time.perf_counter() - t0:.1f} s)")
    if not (abs(l_card - l_cpu) <= 5e-2 and cos >= 0.99):
        raise SystemExit("the card's train step disagrees with the CPU "
                         "reference")


def _recipe_trainer(flags, tag):
    """cli/train.py's build of the reference's default recipe (f32,
    --dropout 0.5, no --use_pallas) with extra flags, checkpoints under a
    fresh work directory `tag`."""
    args = cli_train.build_parser().parse_args(
        ["--dataset", "synthetic", "--dropout", "0.5", "-o",
         _workdir(tag)] + flags)
    cli_train.check_args(args)
    trainer, loader, _ = cli_train.build(args)
    return trainer, loader


def dropout_train_phase(card):
    """Phase 8b: the default recipe at depth 12, B=DROPOUT_BATCH, f32, for
    each of DROPOUT_RECIPES: DROPOUT_STEPS timed steps after a warm-up,
    counted (dropout_launches)."""
    for name, extra in DROPOUT_RECIPES.items():
        t0 = time.perf_counter()
        trainer, loader = _recipe_trainer(
            ["--batch_size", str(DROPOUT_BATCH), "--epochs", "1",
             "--dataset_len", str(DROPOUT_BATCH * (DROPOUT_STEPS + 1))]
            + extra, "dropout")
        ts, batches = trainer.init_state(), list(loader)
        built = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        warm_up(trainer, ts, batches[0])
        _lib.reset_launches()
        times, losses = train_times(trainer, ts, batches[1:])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = _tally(dropout_launches(extra, len(times), DEPTH))
        ms = float(np.median(times))
        phase("train dropout", f"{name}, depth {DEPTH}, B={DROPOUT_BATCH} "
              f"f32, dropout 0.5: steps (ms) "
              f"{[round(t, 3) for t in times]}: median {ms:.3f} ms = "
              f"{DROPOUT_BATCH * 1e3 / ms:.2f} clips/s; peak device memory "
              f"{peak:.2f} GiB; losses {[round(v, 5) for v in losses]} on "
              f"{card} (informative; built in {built:.1f} s)")
        phase("train dropout", f"{name}: launches over {len(times)} steps "
              f"{ {n: k for n, k in counts.items() if k} } (every other "
              f"counter 0)")
        del trainer, ts, batches
        torch.cuda.empty_cache()


def _given_masks(seed, rate=0.5):
    """A mask source (nn/layers.dropout_mask) drawing on the CPU from a
    seeded generator and handing the mask to the device asked for: the
    card and the CPU get the same masks."""
    gen = torch.Generator().manual_seed(seed)
    return lambda shape, dev: (torch.rand(shape, generator=gen)
                               < 1.0 - rate).to(dev)


def dropout_e2e_phase():
    """Phase 8c: one depth-2 B=2 step of the default recipe for each of
    DROPOUT_RECIPES: the card (f32) vs the CPU (plain, f32) from the same
    weights, batch and masks, under the train gate and the f32 limits; on
    the card, a --remat step equals the step without it bit for bit (the
    recompute runs the same deterministic kernels on the masks drawn before
    the checkpointed call)."""
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    on_card = {}
    try:
        for name, extra in DROPOUT_RECIPES.items():
            flags = ["--depth", "2", "--batch_size", "2", "--dataset_len",
                     "2", "--epochs", "1"] + extra
            card_tr, loader = _recipe_trainer(flags, "dropout_e2e")
            cpu_tr, _ = _recipe_trainer(flags + ["--device", "cpu"],
                                        "dropout_e2e")
            batch = next(iter(loader))
            out = []
            t0 = time.perf_counter()
            for tr in (card_tr, cpu_tr):
                ts = tr.init_state()
                with highest():
                    m = S.make_train_step(rng=_given_masks(5))(ts, batch)
                out.append((float(m["loss"]), torch.cat([
                    p.grad.double().cpu().ravel()
                    for p in tr.model.parameters()])))
            (l_card, g_card), (l_cpu, g_cpu) = out
            cos = float(F.cosine_similarity(g_card, g_cpu, dim=0))
            dl = abs(l_card - l_cpu)
            phase("train dropout e2e", f"{name}, depth 2, B=2, dropout 0.5, "
                  f"the same masks: loss card {l_card:.6f} vs CPU plain f32 "
                  f"{l_cpu:.6f} (|d| {dl:.3e}, limits 5e-2 and f32 1e-5); "
                  f"gradient cosine {cos:.8f} (limits 0.99 and f32 "
                  f"0.99999; {time.perf_counter() - t0:.1f} s)")
            if not (dl <= 5e-2 and cos >= 0.99):
                raise SystemExit(f"the card's {name} dropout step disagrees "
                                 f"with the CPU reference")
            if not (dl <= 1e-5 and cos >= 0.99999):
                raise SystemExit(f"the card's {name} dropout step is off the "
                                 f"CPU reference by more than f32 allows")
            on_card[name] = (l_card, g_card)
            if "--remat" in extra:
                base = name.replace(" --remat", "")
                l_base, g_base = on_card[base]
                diff = float((g_card - g_base).abs().max())
                same = l_card == l_base and torch.equal(g_card, g_base)
                phase("train dropout e2e", f"{name} vs {base} on the card: "
                      f"loss {l_card!r} vs {l_base!r}, gradients max|d| "
                      f"{diff:.3e}: equal bit for bit {same}")
                if not same:
                    raise SystemExit(f"{name} does not give the gradients "
                                     f"of {base} on the card")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = prev


def checkpoint_phase(dev, card):
    """Phase 8d: depth 2, B=2, f32, --use_pallas --dropout 0.5, one step an
    epoch (the reference schedule, which does not depend on the epoch
    count): 2 epochs, a fresh Trainer that restores and takes the third
    step (+ --recal_bn 1, counted), vs 3 uninterrupted steps; cuDNN
    deterministic (the port's kernels use no atomics). Then
    recalibrate_bn card vs CPU, serve and visualize from the checkpoint."""
    flags = ["--use_pallas", "--depth", "2", "--batch_size", "2",
             "--dataset_len", "2", "--reference_schedule"]
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    t0 = time.perf_counter()
    try:
        full, loader = _recipe_trainer(flags + ["--epochs", "3"], "ck_full")
        ts_full = full.fit(loader)
        cut, loader = _recipe_trainer(flags + ["--epochs", "2"], "ck")
        cut.fit(loader)
        resumed, loader = _recipe_trainer(
            flags + ["--epochs", "3", "--recal_bn", "1"], "ck")
        _lib.reset_launches()
        ts = resumed.fit(loader)
        # depth 2: one step, then two forwards of recalibrate_bn
        counts = _tally({n: 2 * (k + 2 * FORWARD_PER_LAYER.get(n, 0))
                         for n, k in DROPOUT_PER_LAYER.items()})
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = prev
    got = torch.cat([p.detach().double().cpu().ravel()
                     for p in ts.model.parameters()])
    want = torch.cat([p.detach().double().cpu().ravel()
                      for p in ts_full.model.parameters()])
    rel = float((got - want).abs().max() / want.abs().max())
    steps = resumed.ckpt.all_steps()
    phase("checkpoint", f"depth 2, B=2: 2 epochs, save, fresh Trainer, "
          f"restore, step 3 vs 3 uninterrupted steps: parameters max|d| / "
          f"max|p| {rel:.3e} (bound 1e-6), bit-equal {bool(rel == 0)}; "
          f"steps saved {steps}; the resumed fit's launches (1 step + "
          f"recalibrate_bn's 2 forwards) "
          f"{ {n: k for n, k in counts.items() if k} } "
          f"({time.perf_counter() - t0:.1f} s)")
    if ts.step != 3 or rel > 1e-6 or steps != [1, 2, 3, 4]:
        raise SystemExit(f"resume disagrees with the uninterrupted run "
                         f"(step {ts.step}, steps {steps})")

    # recalibrate_bn on the card vs the CPU, same weights and batch
    loader.set_epoch(7)
    batches = [next(iter(loader))]
    cpu_model = copy.deepcopy(ts.model).to("cpu")
    t0 = time.perf_counter()
    with highest():
        on_card = S.recalibrate_bn(ts.model, batches)
        on_cpu = S.recalibrate_bn(cpu_model, batches)
    rels = [float((on_card[n].double().cpu() - v.double()).norm()
                  / v.double().norm().clamp_min(1e-30))
            for n, v in on_cpu.items()]
    phase("checkpoint", f"recalibrate_bn card vs CPU plain f32: {len(rels)} "
          f"running statistics, rel-L2 max {max(rels):.3e} (limit 1e-4; "
          f"{time.perf_counter() - t0:.1f} s)")
    if max(rels) > 1e-4:
        raise SystemExit("recalibrate_bn on the card disagrees with the CPU")
    del cpu_model

    # serve and visualize from the checkpoint directory
    ck = _workdir("ck")
    predictor = cli_serve.build_predictor(cli_serve.build_parser().parse_args(
        ["--depth", "2", "--max_batch", "2", "-o", ck]), dev)
    resumed.model.load_state_dict(
        resumed.ckpt.restore(map_location=dev)["model"])
    clips = batches[0]["clips"]
    served = np.asarray(predictor.predict(clips)["logits"], np.float64)
    want = S.make_eval_step()(resumed.model, batches[0])["logits"]
    dlogit = float(np.abs(served.ravel() - want.double().cpu().numpy()).max())
    phase("checkpoint", f"cli/serve --checkpoint_dir: logits "
          f"{np.round(served.ravel(), 5).tolist()} vs the trained model's "
          f"eval logits (|d| {dlogit:.3e}, limit 1e-5)")
    if not dlogit <= 1e-5:
        raise SystemExit("serving from the checkpoint disagrees with the "
                         "trained model")
    del predictor
    out = _workdir("visualize")
    written = cli_visualize.main(["--dataset", "synthetic", "--max_clips",
                                  "1", "--depth", "2", "--model_path", ck,
                                  "--out_dir", out])
    t = PAPER.num_frames
    if len(written) != 3 * t or not all(os.path.getsize(p) for p in written):
        raise SystemExit(f"visualize --model_path wrote {written}")
    phase("checkpoint", f"cli/visualize --model_path: {len(written)} PNGs "
          f"on {card}")


# ---------------------------------------------------------------------------
# 8e. from disk: the frame tree, the loader, the feed, score.py, training


TREE_VIDEOS, TREE_FRAMES, TREE_SIDE = 4, 12, 320
SCORE_CLIPS, SCORE_BATCH = 32, 16
DISK_BATCH, DISK_CLIPS = 8, 16
FIGURE_CLIPS = 256           # the loader figure's clips (dataset_len)
PIPELINE_BATCHES = 8         # the score pipeline figure's B=16 batches


def _frame(rng, t):
    """A smooth 320^2 frame with a drifting bright blob and mild noise
    (JPEG sizes closer to face crops than white noise gives)."""
    side = TREE_SIDE
    low = rng.rand(9, 9, 3)
    up = np.kron(low, np.ones((side // 8 + 1, side // 8 + 1, 1)))[:side,
                                                                    :side]
    yy, xx = np.mgrid[:side, :side]
    blob = np.exp(-((yy - 140 - 2 * t) ** 2 + (xx - 160 - 3 * t) ** 2)
                  / 3000.0)[..., None]
    img = 60 + 120 * up + 70 * blob + rng.randn(side, side, 3) * 6
    return np.clip(img, 0, 255).astype(np.uint8)


def _write_tree(root, pil):
    """FF++ layout: hq / lq x FFPP_METHODS x TREE_VIDEOS videos x
    TREE_FRAMES frames, JPEG through PIL or PNG through png_bytes."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = list(enumerate((q, m, v) for q in ("hq", "lq")
                          for m in FFPP_METHODS for v in range(TREE_VIDEOS)))

    def video(job):
        seed, (q, m, v) = job
        d = os.path.join(root, q, m, f"{v:03d}")
        os.makedirs(d, exist_ok=True)
        rng = np.random.RandomState(seed)
        for t in range(TREE_FRAMES):
            img = _frame(rng, t)
            if pil:
                from PIL import Image
                Image.fromarray(img).save(os.path.join(d, f"{t:04d}.jpg"),
                                          quality=90)
            else:
                with open(os.path.join(d, f"{t:04d}.png"), "wb") as f:
                    f.write(png_bytes(img))

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(video, jobs))
    return len(jobs) * TREE_FRAMES


def _probe_machine():
    """{what: bool} of the data path's host dependencies, printed."""
    have = {}
    for mod in ("PIL", "cv2"):
        try:
            __import__(mod)
            have[mod] = True
        except Exception:
            have[mod] = False
    t0 = time.perf_counter()
    have["clipdecode"] = native.available()
    have["videodecode"] = native.video_available()
    phase("data", f"machine: PIL {have['PIL']}, cv2 {have['cv2']}, "
          f"clipdecode (g++, libjpeg, libpng) built {have['clipdecode']}, "
          f"videodecode (g++, libavformat / libavcodec / libswscale) built "
          f"{have['videodecode']} ({time.perf_counter() - t0:.1f} s), "
          f"os.cpu_count() {os.cpu_count()}")
    return have


def _busy_ms(prof):
    """ms of the union of the CUDA kernels' and copies' intervals in a
    torch.profiler run: the time the device was busy."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -float("inf")
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy / 1e3


def _score_args(root, out, extra=()):
    return cli_score.build_parser().parse_args(
        ["--int8", "--data_root", root, "-bs", str(SCORE_BATCH),
         "--max_clips", str(SCORE_CLIPS), "--out", out, *extra])


def score_disk_phase(root, dev, card):
    """cli/score.py --int8 on the tree, counted; its clips vs the CPU
    dataset's, its first logits vs the CPU's plain versions. Returns the
    predictor for the figures."""
    args = _score_args(root, os.path.join(WORK, "scores.jsonl"))
    t0 = time.perf_counter()
    predictor, loader = cli_score.build(args)
    built = time.perf_counter() - t0
    seen = []
    predict = predictor.predict

    def recording(clips):
        seen.append(clips.cpu().numpy())
        return predict(clips)

    predictor.predict = recording
    predictor.n_forwards = 0
    torch.cuda.synchronize()
    _lib.reset_launches()
    native.reset_clips()
    summary = cli_score.score(predictor, loader, args.out)
    torch.cuda.synchronize()
    counts = _tally({n: k * DEPTH * predictor.n_forwards
                     for n, k in SERVE_PER_LAYER["int8"].items()})
    predictor.predict = predict
    rows = [json.loads(ln) for ln in open(args.out)]
    phase("data", f"cli/score.py --int8 -bs {SCORE_BATCH} over "
          f"{SCORE_CLIPS} hq clips, depth {DEPTH}: {predictor.n_forwards} "
          f"forwards, {len(rows)} JSON lines, summary {summary}; clips by "
          f"decoder {dict(native.CLIPS)}; launches "
          f"{ {n: k for n, k in counts.items() if k} } (every other 0; "
          f"model built in {built:.1f} s)")
    if predictor.n_forwards != SCORE_CLIPS // SCORE_BATCH or \
            [r["index"] for r in rows] != list(range(SCORE_CLIPS)):
        raise SystemExit(f"score.py wrote {len(rows)} lines in "
                         f"{predictor.n_forwards} forwards")
    ds = loader.dataset
    host = np.stack([ds[i]["clips"] for i in range(SCORE_CLIPS)])
    fed = np.concatenate(seen)
    equal = fed.dtype == host.dtype and np.array_equal(fed, host)
    phase("data", f"clips the card scored vs the CPU dataset's items: "
          f"{fed.shape} {fed.dtype}, equal bit for bit {equal}")
    if not equal:
        raise SystemExit("the card scored other clips than the dataset's")
    cpu_model = tree.cast(copy.deepcopy(predictor.model).to("cpu"),
                          torch.float32)
    t0 = time.perf_counter()
    with highest(), torch.inference_mode():
        cpu_logit = cpu_model(torch.from_numpy(host[:2])).reshape(-1).numpy()
    del cpu_model
    card_logit = np.array([r["logit"] for r in rows[:2]])
    delta = float(np.abs(card_logit - cpu_logit).max())
    phase("data", f"first two clips: card {card_logit.tolist()} vs CPU "
          f"plain f32 {cpu_logit.tolist()}: |dlogit| {delta:.3e} (limit "
          f"5e-2; CPU forward {time.perf_counter() - t0:.1f} s)")
    if not delta <= 5e-2:
        raise SystemExit("score.py's card logits disagree with the CPU")
    return predictor


def train_disk_phase(root, card):
    """cli/train.py --dataset ff++ --use_pallas (the default recipe at depth
    12, f32, dropout 0.5) from the tree, counted; then --test_mode."""
    flags = ["--dataset", "ff++", "--data_root", root, "--use_pallas",
             "-bs", str(DISK_BATCH), "--dataset_len", str(DISK_CLIPS),
             "--epochs", "1", "--num_workers", "8", "-o", _workdir("disk")]
    args = cli_train.build_parser().parse_args(flags)
    cli_train.check_args(args)
    t0 = time.perf_counter()
    trainer, train_loader, val_loader = cli_train.build(args)
    logged = []
    trainer.log = logged.append
    steps = len(train_loader)
    val_fwd = len(val_loader)
    torch.cuda.synchronize()
    _lib.reset_launches()
    native.reset_clips()
    trainer.fit(train_loader, val_loader)
    torch.cuda.synchronize()
    want = {n: k * DEPTH * steps for n, k in DROPOUT_PER_LAYER.items()}
    for n, k in SERVE_PER_LAYER["float"].items():
        want[n] = want.get(n, 0) + k * DEPTH * val_fwd
    counts = _tally(want)
    val = [ln for ln in logged if ln.startswith("epoch 0: val")]
    phase("data", f"cli/train.py --dataset ff++ --use_pallas, depth {DEPTH}, "
          f"f32, dropout 0.5, B={DISK_BATCH} over {DISK_CLIPS} clips: "
          f"{steps} steps and {val_fwd} val forwards in "
          f"{time.perf_counter() - t0:.1f} s (build included); clips by "
          f"decoder {dict(native.CLIPS)}; {val}; launches "
          f"{ {n: k for n, k in counts.items() if k} } (every other 0)")
    types = [f"acc_type_{i}" for i in range(len(FFPP_METHODS))]
    if not val or not all(f"'{t}'" in val[0] for t in types):
        raise SystemExit(f"the val dict lacks a per-type accuracy: {logged}")
    del trainer
    torch.cuda.empty_cache()
    out = io.StringIO()
    import contextlib
    with contextlib.redirect_stdout(out):
        cli_train.main(flags + ["--test_mode"])
    lines = [ln for ln in out.getvalue().splitlines()
             if ln.startswith(("hq {", "lq {"))]
    phase("data", f"cli/train.py --test_mode: {lines}")
    if [ln[:2] for ln in lines] != ["hq", "lq"]:
        raise SystemExit(f"--test_mode printed {out.getvalue()}")
    _lib.reset_launches()


def feed_phase(root, dev):
    """device_feed's card batch vs the host batch; device_normalize of a
    raw_uint8 batch on the card vs the host f32 normalize."""
    kw = dict(root=root, quality="hq", size=PAPER.image_size, mode="Test",
              seq_len=PAPER.num_frames)
    loader = ClipLoader(VideoSeqDataset(transform=Transform(PAPER.image_size),
                                        **kw), batch_size=4, shuffle=False)
    host = next(iter(loader))
    fed = next(iter(device_feed(loader, dev)))
    same = all(torch.equal(fed[k].cpu(), torch.from_numpy(host[k]))
               for k in ("clips", "labels"))
    u8 = ClipLoader(VideoSeqDataset(transform=Transform(
        PAPER.image_size, raw_uint8=True), **kw), batch_size=4,
        shuffle=False)
    raw = next(iter(device_feed(u8, dev)))["clips"]
    norm = device_normalize(raw).cpu().numpy()
    err = float(np.abs(norm - host["clips"]).max())
    phase("data", f"device_feed: the card batch {tuple(fed['clips'].shape)} "
          f"{fed['clips'].device} equals the host batch bit for bit {same}; "
          f"device_normalize of the raw_uint8 batch ({raw.dtype}) on the "
          f"card vs the host f32 normalize: max|d| {err:.3e} (limit 1e-6)")
    if not same or not err <= 1e-6:
        raise SystemExit("the feed or device_normalize is off the host")


def _loader_rate(root, use_native, raw_uint8=False):
    ds = VideoSeqDataset(root=root, quality="hq", size=PAPER.image_size,
                         mode="Train", seq_len=PAPER.num_frames,
                         transform=Transform(PAPER.image_size,
                                             raw_uint8=raw_uint8),
                         dataset_len=FIGURE_CLIPS, use_native=use_native)
    loader = ClipLoader(ds, batch_size=SCORE_BATCH, num_workers=8)
    for _ in loader:                            # warm the page cache
        pass
    native.reset_clips()
    t0 = time.perf_counter()
    n = sum(len(b["labels"]) for b in loader)
    sec = time.perf_counter() - t0
    return n / sec, dict(native.CLIPS)


def _host_cpus():
    """What the host gives this process, read before each loader figure:
    its CPU affinity, the cgroup's CPU quota where the file is there, and
    the 1 / 5 / 15 min load averages."""
    try:
        with open("/sys/fs/cgroup/cpu.max") as f:
            quota = f.read().strip()
    except OSError:
        quota = "not readable"
    return (f"{len(os.sched_getaffinity(0))} CPUs in affinity of "
            f"os.cpu_count() {os.cpu_count()}, cgroup cpu.max {quota!r}, "
            f"load average {os.getloadavg()}")


def figures_phase(root, predictor, card, have):
    """Informative: the loader alone, the int8 forward alone, the score
    pipeline end to end with the device's busy share."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    for use_native, raw in ((False, False), (True, False), (False, True)):
        if use_native and not have["clipdecode"]:
            phase("data", "figure: loader with --use_native_decode: not "
                  "measured (clipdecode did not build on this machine)")
            continue
        host = _host_cpus()
        rate, by = _loader_rate(root, use_native, raw)
        phase("data", f"figure: loader alone, 8 workers, B={SCORE_BATCH}, "
              f"{FIGURE_CLIPS} clips of {PAPER.num_frames} frames "
              f"{TREE_SIDE}^2 -> {PAPER.image_size}^2 (warm page cache), "
              f"use_native={use_native}, "
              f"{'raw_uint8' if raw else 'f32'} clips: {rate:.1f} clips/s "
              f"(decoders {by}) on {card}; host before it: {host} "
              f"(informative)")
    times = forward_times(predictor.model, CLIP, torch.bfloat16)
    fwd = float(np.median(times))
    phase("data", f"figure: int8 B={SCORE_BATCH} forward alone: median "
          f"{fwd:.3f} ms = {SCORE_BATCH * 1e3 / fwd:.1f} clips/s on {card} "
          f"(informative)")
    n = SCORE_BATCH * PIPELINE_BATCHES
    args = _score_args(root, os.path.join(WORK, "pipeline.jsonl"),
                       ["--max_clips", str(n)])
    loader = ClipLoader(cli_score.make_dataset(args),
                        batch_size=SCORE_BATCH, shuffle=False)
    cli_score.score(predictor, loader, args.out)       # warm-up pass
    torch.cuda.synchronize()
    host = _host_cpus()
    t0 = time.perf_counter()
    cli_score.score(predictor, loader, args.out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cli_score.score(predictor, loader, args.out)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    busy = _busy_ms(prof)
    phase("data", f"figure: score.py pipeline (disk -> {loader.num_workers} "
          f"loader threads -> device_feed -> int8 B={SCORE_BATCH} forward), "
          f"{n} clips: {n / wall:.1f} clips/s ({wall:.3f} s); under "
          f"torch.profiler {n / pwall:.1f} clips/s, device busy "
          f"{busy:.1f} ms of {pwall * 1e3:.1f} ms = "
          f"{100 * busy / (pwall * 1e3):.1f}% on {card}; host before it: "
          f"{host} (informative)")
    _lib.reset_launches()


def video_phase(have):
    """One ff++video item where cv2 or videodecode is there."""
    if not (have["cv2"] or have["videodecode"]):
        phase("data", "ff++video: not run (neither cv2 nor a videodecode "
              "build on this machine)")
        return
    from istvt_tpu_torch.data.video_frontend import RawVideoDataset
    root = _workdir("videos")
    d = os.path.join(root, "hq", "original")
    os.makedirs(d, exist_ok=True)
    import cv2
    wtr = cv2.VideoWriter(os.path.join(d, "vid0.mp4"),
                          cv2.VideoWriter_fourcc(*"mp4v"), 25, (320, 240))
    rng = np.random.RandomState(0)
    for t in range(16):
        img = (rng.rand(240, 320, 3) * 40).astype(np.uint8)
        cv2.ellipse(img, (160 + t, 120), (40, 55), 0, 0, 360,
                    (140, 160, 220), -1)
        wtr.write(img)
    wtr.release()
    use_native = have["videodecode"]
    t0 = time.perf_counter()
    item = RawVideoDataset(root, quality="hq", seq_len=PAPER.num_frames,
                           size=PAPER.image_size, mode="Test",
                           use_native=use_native)[0]
    clip = item["clips"]
    ok = clip.shape == CLIP and bool(np.isfinite(clip).all())
    phase("data", f"ff++video: one RawVideoDataset item through "
          f"{'videodecode' if use_native else 'cv2'}: {clip.shape} "
          f"{clip.dtype}, finite {ok} ({time.perf_counter() - t0:.2f} s)")
    if not ok:
        raise SystemExit("the ff++video item is malformed")


def data_phase(dev, card):
    """Phase 8e."""
    t_all = time.perf_counter()
    have = _probe_machine()
    tree_root = _workdir("frames")
    t0 = time.perf_counter()
    n = _write_tree(tree_root, have["PIL"])
    phase("data", f"frame tree: {n} {'JPEG' if have['PIL'] else 'PNG'} "
          f"frames of {TREE_SIDE}^2 (hq / lq x {len(FFPP_METHODS)} methods x "
          f"{TREE_VIDEOS} videos x {TREE_FRAMES}) in "
          f"{time.perf_counter() - t0:.1f} s")
    predictor = score_disk_phase(tree_root, dev, card)
    feed_phase(tree_root, dev)
    figures_phase(tree_root, predictor, card, have)
    del predictor
    torch.cuda.empty_cache()
    train_disk_phase(tree_root, card)
    torch.cuda.empty_cache()
    video_phase(have)
    phase("data", f"phase 8e took {time.perf_counter() - t_all:.1f} s")


# ---------------------------------------------------------------------------
# 9-10. the interpretability path


METHODS = ("transformer_attribution", "rollout", "last_layer")
LRP_CALLS = 3       # timed calls per (use_pallas, method), after a warm-up




def _png_size(path):
    """(width, height) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise SystemExit(f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def _timed_calls(fn, per_call):
    """A warm-up call, then LRP_CALLS timed ones (host clock, each ending
    in a synchronize), counted from 0: every launch counter must equal
    per_call's entry times the calls (0 where it has none). Returns (the
    last output, ms per call, peak device memory GiB, the counts)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    times = []
    for _ in range(LRP_CALLS):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    counts = _tally({n: k * LRP_CALLS for n, k in per_call.items()})
    return (out, times, torch.cuda.max_memory_allocated() / 2 ** 30,
            counts)


def _ms(times):
    return (f"ms per call {[round(t, 3) for t in times]} (median "
            f"{float(np.median(times)):.3f})")


def _profile_lrp(model, clip, card, profile):
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        generate_lrp(model, clip)
        torch.cuda.synchronize()
    _write_profile(prof, f"{card}, generate_lrp B=1 f32, use_pallas="
                   f"{model.cfg.use_pallas}", profile)


def lrp_phase(model, clip, card, profile):
    """generate_lrp per method, with and without use_pallas."""
    hw = PAPER.feat_hw ** 2
    for up in (True, False):
        model.cfg = dataclasses.replace(PAPER, use_pallas=up)
        for method in METHODS:
            (cam_s, cam_t), times, peak, counts = _timed_calls(
                lambda: generate_lrp(model, clip, method=method),
                {"fused_ff": DEPTH} if up else {})
            for cam in (cam_s, cam_t):
                if (cam.shape != (1, PAPER.num_frames, hw)
                        or not torch.isfinite(cam).all()):
                    raise SystemExit(f"generate_lrp {method}: bad cam "
                                     f"{tuple(cam.shape)}")
            phase("interpret", f"generate_lrp {method}, use_pallas={up}: "
                  f"{_ms(times)}; peak device memory {peak:.3f} GiB; "
                  f"fused_ff launches {counts['fused_ff']} over "
                  f"{LRP_CALLS} calls, every other counter 0 on {card}")
        if profile:
            _profile_lrp(model, clip, card, profile)
            phase("interpret", f"profile table appended to {profile}")


def interpret_phase(dev, card, profile):
    """Phase 9 at the paper geometry, B=1, f32."""
    t0 = time.perf_counter()
    model = istvt.init(PAPER, torch.Generator().manual_seed(0), dev)
    clip = torch.from_numpy(np.random.RandomState(2).randn(1, *CLIP).astype(
        np.float32)).to(dev)
    phase("interpret", f"model built in {time.perf_counter() - t0:.1f} s")
    with highest():
        lrp_phase(model, clip, card, profile)

        model.cfg = dataclasses.replace(PAPER, use_pallas=True)
        cams, times, peak, _ = _timed_calls(
            lambda: generate_full_lrp(model, clip), {"fused_ff": DEPTH})
        for cam in cams:
            if not (torch.isfinite(cam).all() and (cam >= 0).all()):
                raise SystemExit("generate_full_lrp: cams not finite and "
                                 "non-negative")
        phase("interpret", f"generate_full_lrp, use_pallas=True: "
              f"{_ms(times)}; peak device memory {peak:.3f} GiB; fused_ff "
              f"{DEPTH} launches per call; cams finite, >= 0")

        istvt.pack_params(model)
        rel, times, peak, counts = _timed_calls(
            lambda: generate_feature_relevance(model, clip),
            {n: k * DEPTH for n, k in TRAIN_PER_LAYER.items()})
        if (rel.shape != (1,) + CLIP[:3]) or not torch.isfinite(rel).all():
            raise SystemExit(f"generate_feature_relevance: bad output "
                             f"{tuple(rel.shape)}")
        phase("interpret", f"generate_feature_relevance, use_pallas=True: "
              f"{_ms(times)}; peak device memory {peak:.3f} GiB; launches "
              f"over {LRP_CALLS} calls {counts} (a train step's per layer "
              f"x {DEPTH} per call); finite")
        del model
        torch.cuda.empty_cache()

        with tempfile.TemporaryDirectory() as out:
            _lib.reset_launches()
            t0 = time.perf_counter()
            written = cli_visualize.main(["--dataset", "synthetic",
                                          "--max_clips", "1",
                                          "--out_dir", out])
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            _tally({})
            sizes = sorted(_png_size(p) for p in written)
            side, t = PAPER.feat_hw * 16, PAPER.num_frames
            want = sorted([(side, side)] * (2 * t)
                          + [(PAPER.image_size,) * 2] * t)
            if sizes != want or len(os.listdir(out)) != 3 * t:
                raise SystemExit(f"visualize wrote {sizes}")
        phase("interpret", f"cli/visualize --dataset synthetic --max_clips "
              f"1: {3 * t} PNGs ({2 * t} of {side}^2, {t} of "
              f"{PAPER.image_size}^2) in {sec:.1f} s (model build "
              f"included); every counter 0")


def interpret_e2e_phase(dev):
    """Phase 10: depth 2, card (kernels) vs CPU (plain versions), f32."""
    cfg = dataclasses.replace(PAPER, depth=2, use_pallas=True)
    cpu = istvt.init(cfg, torch.Generator().manual_seed(3))
    card = copy.deepcopy(cpu).to(dev)
    clip = np.random.RandomState(4).randn(1, *CLIP).astype(np.float32)
    out = []
    t0 = time.perf_counter()
    with highest():
        for model in (card, cpu):
            x = torch.from_numpy(clip).to(next(model.parameters()).device)
            with torch.no_grad():
                logit, _ = model(x, return_attn=True)
            cams = generate_lrp(model, x)
            out.append((logit.double().cpu(),
                        [c.double().cpu() for c in cams]))
    (l_card, c_card), (l_cpu, c_cpu) = out
    dlogit = float((l_card - l_cpu).abs().max())
    rel = [float((a - b).norm() / b.norm().clamp_min(1e-30))
           for a, b in zip(c_card, c_cpu)]
    phase("interpret e2e", f"depth 2, B=1: logit card {l_card.tolist()} vs "
          f"CPU plain f32 {l_cpu.tolist()} (|d| {dlogit:.3e}, limit 1e-4); "
          f"transformer_attribution cam_s / cam_t rel-L2 {rel[0]:.3e} / "
          f"{rel[1]:.3e} (limit 1e-3; {time.perf_counter() - t0:.1f} s)")
    if not (dlogit <= 1e-4 and max(rel) <= 1e-3):
        raise SystemExit("the card's relevance maps disagree with the CPU "
                         "reference")


# ---------------------------------------------------------------------------
# 11. the kernel API


def _max_rel(got, want):
    """max|diff| / max|want| over the outputs."""
    return max(float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
               for g, w in zip(got, want))


def kernel_api_phase(dev):
    """The kernel API's entry points (istvt_tpu_torch.kernels, kernels/conv)
    at the slice's attention geometry and on one Xception unit of the
    stem, f32, counted from 0: each entry exactly its API_LAUNCHES; then
    the results against the plain versions and references."""
    from istvt_tpu_torch.kernels import attention, conv
    from istvt_tpu_torch.models import xception
    from istvt_tpu_torch.nn.layers import batchnorm_eval, separable_conv2d

    gen = torch.Generator().manual_seed(6)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    heads, dh = PAPER.heads, PAPER.dim_head
    s_q = [rn(2, PAPER.num_frames + 1, 368, heads, dh) for _ in range(4)]
    t_q = [rn(2, PAPER.num_frames + 1, 368, heads * dh) for _ in range(4)]
    f_q = [rn(2 * (PAPER.num_frames + 1) * heads, 368, dh) for _ in range(3)]
    # a unit of the stem as it is built: block2's first (74^2 x 128 ->
    # 256, pre-ReLU), its BN with running statistics as after training
    block = xception.init_(xception.Block(xception.BLOCK_SPECS[1]),
                           gen).to(dev).eval()
    sep, bn = block.units()[0]
    with torch.no_grad():
        bn.running_mean.copy_(rn(256, scale=0.1))
        bn.running_var.copy_(torch.rand(256, generator=gen).to(dev) + 0.5)
        bn.weight.copy_(torch.rand(256, generator=gen).to(dev) + 0.5)
        bn.bias.copy_(rn(256, scale=0.1))
    a, b = conv.fold_bn(bn.weight.detach(), bn.bias.detach(),
                        bn.running_mean, bn.running_var)
    dw = sep.conv1.weight.detach().reshape(128, 9).t()
    pw = sep.pointwise.weight.detach().reshape(256, 128).t()
    x = rn(12, 74, 74, 128, scale=0.5)
    g_x = rn(12, 74, 74, 256)

    def with_grads(fn, ins, g):
        leaves = [t.clone().requires_grad_() for t in ins]
        out = fn(*leaves)
        return out.detach(), torch.autograd.grad(out, leaves, g)

    t0 = time.perf_counter()
    with highest():
        torch.cuda.synchronize()
        _lib.reset_launches()
        s_out, s_grads = with_grads(attention.spatial_attention_pallas,
                                    s_q[:3], s_q[3])
        t_out, t_grads = with_grads(
            lambda *u: attention.temporal_attention_pallas(*u, heads),
            t_q[:3], t_q[3])
        f_out = attention.fused_frame_attention(*f_q)
        c_out, (c_grad,) = with_grads(
            lambda u: conv.sepconv_bn(u, dw, pw, a, b, True), [x], g_x)
        torch.cuda.synchronize()
        counts = _tally(API_LAUNCHES)
        sec = time.perf_counter() - t0

        fold = attention._fold
        checks = {
            "spatial_attention_pallas fwd vs #15 plain": _max_rel(
                [s_out], [attention.fused_frame_attention_mh_plain(
                    *map(fold, s_q[:3]), heads).reshape(s_out.shape)]),
            "its grads vs #13 plain": _max_rel(
                [u.reshape(-1) for u in s_grads],
                [u.reshape(-1) for u in attention
                 .fused_frame_attention_bwd_plain(*map(fold, s_q), heads)]),
            "its grads vs autograd of _spatial_reference": _max_rel(
                s_grads, attention._reference_grads(
                    attention._spatial_reference, s_q[:3], s_q[3])),
            "temporal_attention_pallas fwd vs #16 plain": _max_rel(
                [t_out],
                [attention.fused_temporal_attention_plain(*t_q[:3], heads)]),
            "its grads vs #17 plain": _max_rel(
                t_grads, attention.fused_temporal_attention_bwd_plain(
                    *t_q, heads)),
            "its grads vs autograd of _temporal_reference": _max_rel(
                t_grads, attention._reference_grads(
                    lambda *u: attention._temporal_reference(*u, heads),
                    t_q[:3], t_q[3])),
            "fused_frame_attention vs #14 plain": _max_rel(
                [f_out], [attention.fused_frame_attention_plain(*f_q)]),
        }

        def stem(u):                 # the stem's cuDNN composition
            y = separable_conv2d(u.permute(0, 3, 1, 2).clamp_min(0),
                                 sep.conv1.weight.detach(),
                                 sep.pointwise.weight.detach())
            return batchnorm_eval(y, bn.weight.detach(), bn.bias.detach(),
                                  bn.running_mean,
                                  bn.running_var).permute(0, 2, 3, 1)

        want, (want_grad,) = with_grads(stem, [x], g_x)
        unit_err = float((c_out - want).abs().max())
        unit_ok = bool(torch.allclose(c_out, want, atol=1e-5, rtol=1e-5))
        checks["sepconv_bn grad vs the stem's autograd"] = _max_rel(
            [c_grad], [want_grad])
    limits = {n: 2e-4 if "autograd" in n and "sepconv" not in n else 1e-5
              for n in checks}
    bad = [n for n, e in checks.items() if not e <= limits[n]]
    phase("kernel api", f"spatial_attention_pallas (2, 7, 368, 8, 64), "
          f"temporal_attention_pallas (2, 7, 368, 512), fused_frame_attention "
          f"(112, 368, 64), sepconv_bn on block2's first unit (12 x 74^2 x "
          f"128 -> 256, eval BN folded by fold_bn), forward and backward, "
          f"f32, in {sec:.2f} s: launches {counts}")
    for n, e in checks.items():
        phase("kernel api", f"{n}: max|diff| / max|ref| {e:.3e} (limit "
              f"{limits[n]:g})")
    phase("kernel api", f"sepconv_bn vs the stem's cuDNN composition "
          f"(separable_conv2d, batchnorm_eval): max|diff| {unit_err:.3e} "
          f"({'ok' if unit_ok else 'FAIL'} at atol = rtol = 1e-5)")
    if bad or not unit_ok:
        raise SystemExit(f"kernel API results disagree: {bad or 'sepconv'}")


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# 12. distillation and certification


STUDENT_SIZE, STUDENT_DEPTH = 224, 6
# cli/train.py --distill_from at the serving recipe's geometry: 2 steps of
# B=8 from a 300^2 / depth-12 teacher, and one val pass (16 clips)
DISTILL_FLAGS = ["--dataset", "synthetic", "--teacher_depth", str(DEPTH),
                 "--teacher_input_size", str(PAPER.image_size),
                 "--input_size", str(STUDENT_SIZE), "--depth",
                 str(STUDENT_DEPTH), "--use_pallas", "--dropout", "0",
                 "--bf16", "--batch_size", "8", "--dataset_len", "16",
                 "--epochs", "1"]
HOOK_TIMED = 4       # timed steps with and without the teacher hook
# cli/certify.py at the production geometry on a reduced budget; the second
# run restores the teacher and stops after its AUC and the student leg
CERT_FLAGS = ["--teacher_epochs", "1", "--distill_epochs", "1",
              "--train_clips", "16", "--val_clips", "16", "--batch_size", "8"]
CERT_RESTORE = ["--no_int8", "--no_lrp", "--distill_epochs", "0"]


def _per(per_layer, layers):
    return {n: k * layers for n, k in per_layer.items()}


def _sum(*counts):
    out = {}
    for c in counts:
        for n, k in c.items():
            out[n] = out.get(n, 0) + k
    return out


def _grad_vector(model):
    return torch.cat([p.grad.double().cpu().ravel()
                      for p in model.parameters()])


def distill_train_phase(card):
    """12a: cli/train.py --distill_from at 300^2/d12 -> 224^2/d6, counted
    exactly; then the step time with and without the teacher hook."""
    t0 = time.perf_counter()
    teacher_dir = _workdir("distill_teacher")
    teacher = istvt.init(PAPER, torch.Generator().manual_seed(0))
    CheckpointManager(teacher_dir).save(0, {"model": teacher.state_dict(),
                                            "step": 0})
    del teacher
    args = cli_train.build_parser().parse_args(
        DISTILL_FLAGS + ["--distill_from", teacher_dir, "-o",
                         _workdir("distill_student")])
    cli_train.check_args(args)
    trainer, loader, val_loader = cli_train.build(args)
    phase("distill", f"seed-0 teacher saved and the trainer built in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    t0 = time.perf_counter()
    ts = trainer.fit(loader, val_loader)
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps, n_val = ts.step, len(val_loader)
    fwd = SERVE_PER_LAYER["float"]
    counts = _tally(_sum(_per(fwd, DEPTH * steps),
                         _per(TRAIN_PER_LAYER, STUDENT_DEPTH * steps),
                         _per(fwd, STUDENT_DEPTH * n_val)))
    phase("distill", f"cli/train.py --distill_from (teacher {PAPER.image_size}"
          f"^2/d{DEPTH} f32, student {STUDENT_SIZE}^2/d{STUDENT_DEPTH} bf16, "
          f"B=8): {steps} steps + {n_val} val forwards in {fit_s:.1f} s, "
          f"peak device memory {peak:.2f} GiB; launches (exact: the "
          f"teacher's float forward x {DEPTH} a batch, the student's step x "
          f"{STUDENT_DEPTH} a step, each val forward x {STUDENT_DEPTH}) "
          f"{ {n: k for n, k in counts.items() if k} }")
    dev = trainer.dev
    raw = [{k: torch.as_tensor(v).to(dev) for k, v in b.items()}
           for b in loader]
    pre = [trainer.batch_hook(b) for b in raw]

    def step_ms(batch_of):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        float(trainer.step_fn(ts, batch_of())["loss"])
        return 1e3 * (time.perf_counter() - t1)

    # in turns, with and without the hook; the first pair warms up
    hooked, plain = [], []
    for i in range(HOOK_TIMED + 1):
        k = i % len(raw)
        pair = (step_ms(lambda: trainer.batch_hook(raw[k])),
                step_ms(lambda: pre[k]))
        if i:
            hooked.append(pair[0])
            plain.append(pair[1])
    _lib.reset_launches()
    phase("distill", f"B=8 step with the teacher hook (ms) "
          f"{[round(t, 3) for t in hooked]}: median "
          f"{float(np.median(hooked)):.3f} ms; on hooked batches, in turns "
          f"{[round(t, 3) for t in plain]}: median "
          f"{float(np.median(plain)):.3f} ms, on {card} (informative)")
    del trainer, ts, raw, pre


def distill_step_e2e_phase(dev):
    """12b: one depth-2 B=2 distill step at 224^2, card (f32) vs CPU
    (plain, f32), from the same weights, batch and teacher signal:
    logit-only with use_pallas (counted: the step's kernels x 2 layers),
    and with attention transfer on the XLA-math path (no kernel)."""
    from istvt_tpu_torch.core.config import TrainConfig
    from istvt_tpu_torch.train.schedule import cosine_schedule
    rng = np.random.RandomState(9)
    t, hw = PAPER.num_frames, istvt.infer_feat_hw(STUDENT_SIZE)
    batch = {"clips": rng.randn(2, t, STUDENT_SIZE, STUDENT_SIZE, 3).astype(
                 np.float32),
             "labels": np.array([1, 0], np.int32),
             "teacher_logits": rng.randn(2, 1).astype(np.float32),
             "teacher_cam_s": rng.dirichlet(np.ones(hw * hw), (2, t)).astype(
                 np.float32),
             "teacher_cam_t": rng.dirichlet(np.ones(t), 2).astype(np.float32),
             "cam_s_mask": np.ones(2, np.float32)}
    for name, use_pallas, attn_weight in (
            ("logit-only, use_pallas", True, 0.0),
            ("attention transfer (attn_weight 2), XLA-math", False, 2.0)):
        cfg = dataclasses.replace(PAPER, image_size=STUDENT_SIZE, feat_hw=hw,
                                  depth=2, use_pallas=use_pallas)
        cpu = istvt.init(cfg, torch.Generator().manual_seed(5))
        out = []
        t0 = time.perf_counter()
        for model in (copy.deepcopy(cpu).to(dev), cpu):
            ts = S.create_train_state(model, S.make_optimizer(
                TrainConfig(checkpoint_dir=""), cosine_schedule(1e-4, 100)))
            step = S.make_train_step(
                loss_fn=L.make_distill_loss(0.5, 2.0, attn_weight))
            _lib.reset_launches()
            with highest():
                m = step(ts, batch)
            loss = float(m["loss"])
            if model is not cpu:
                counts = _tally(_per(TRAIN_PER_LAYER, 2) if use_pallas
                                else {})
            out.append((loss, _grad_vector(model)))
        (l_card, g_card), (l_cpu, g_cpu) = out
        cos = float(F.cosine_similarity(g_card, g_cpu, dim=0))
        dl = abs(l_card - l_cpu)
        phase("distill e2e", f"{name}, depth 2, B=2, {STUDENT_SIZE}^2: loss "
              f"card {l_card:.6f} vs CPU plain f32 {l_cpu:.6f} (|d| "
              f"{dl:.3e}, limit 1e-5); gradient cosine {cos:.8f} (limit "
              f"0.99999); launches "
              f"{ {n: k for n, k in counts.items() if k} } "
              f"({time.perf_counter() - t0:.1f} s)")
        if not (dl <= 1e-5 and cos >= 0.99999):
            raise SystemExit(f"the card's {name} distill step disagrees with "
                             f"the CPU reference")


def teacher_hook_e2e_phase(dev):
    """12c: the teacher hook with cams at 300^2 / depth 2 (use_pallas, as
    cli/train.py builds its teacher), resizing to 224^2 / 14^2, card vs
    CPU (plain), counted: the float forward x 2 and fused_ff x 2."""
    cfg = dataclasses.replace(PAPER, depth=2, use_pallas=True)
    cpu = istvt.init(cfg, torch.Generator().manual_seed(6))
    clips = np.random.RandomState(10).randn(2, *CLIP).astype(np.float32)
    out = []
    t0 = time.perf_counter()
    for model in (copy.deepcopy(cpu).to(dev), cpu):
        hook = D.augment_with_teacher(
            D.make_teacher_fn(model, cam_cfg=model.cfg),
            student_size=STUDENT_SIZE,
            student_feat_hw=istvt.infer_feat_hw(STUDENT_SIZE))
        x = torch.from_numpy(clips).to(next(model.parameters()).device)
        _lib.reset_launches()
        with highest():
            got = hook({"clips": x})
        if model is not cpu:
            counts = _tally(_sum(_per(SERVE_PER_LAYER["float"], 2),
                                 {"fused_ff": 2}))
        out.append({k: v.double().cpu() for k, v in got.items()})
    card_out, cpu_out = out
    dlogit = float((card_out["teacher_logits"]
                    - cpu_out["teacher_logits"]).abs().max())
    rel = {k: float((card_out[k] - cpu_out[k]).norm()
                    / cpu_out[k].norm().clamp_min(1e-30))
           for k in ("teacher_cam_s", "teacher_cam_t")}
    dclip = float((card_out["clips"] - cpu_out["clips"]).abs().max())
    x = torch.from_numpy(clips)
    dres = float((D.resize_bilinear(x.to(dev), STUDENT_SIZE).cpu()
                  - D.resize_bilinear(x, STUDENT_SIZE)).abs().max())
    phase("distill hook", f"depth 2, B=2, {PAPER.image_size}^2 -> "
          f"{STUDENT_SIZE}^2: teacher_logits |d| {dlogit:.3e} (limit 1e-4); "
          f"teacher_cam_s / teacher_cam_t rel-L2 {rel['teacher_cam_s']:.3e} "
          f"/ {rel['teacher_cam_t']:.3e} (limit 1e-3); resized clips max|d| "
          f"{dclip:.3e}, resize_bilinear (CUDA antialiased bilinear vs CPU) "
          f"max|d| {dres:.3e} (limit 1e-4, the CPU test's 300 -> 224 bound "
          f"against jax.image.resize); launches "
          f"{ {n: k for n, k in counts.items() if k} } "
          f"({time.perf_counter() - t0:.1f} s)")
    if not (dlogit <= 1e-4 and max(rel.values()) <= 1e-3
            and max(dclip, dres) <= 1e-4):
        raise SystemExit("the card's teacher hook disagrees with the CPU "
                         "reference")


def _certify(argv):
    """cli/certify.py main(argv), its '[certify]' log lines printed as
    phase lines (the JSON goes to --out); (exit code, result)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_certify.main(argv)
    for ln in buf.getvalue().splitlines():
        if ln.startswith("[certify]"):
            phase("certify", ln[len("[certify] "):])
    with open(argv[argv.index("--out") + 1]) as f:
        return rc, json.load(f)


def certify_phase(card):
    """12d: cli/certify.py at the production geometry on a reduced budget,
    counted (the int8 leg's one forward of the 16 val clips: #1-#3 x
    STUDENT_DEPTH; no other leg runs a kernel, as in JAX), then a second
    run restoring the teacher."""
    with open(os.path.join(_ROOT, "CERT_RECIPE.json")) as f:
        rec = json.load(f)
    want_keys = (set(rec) - {"export_dir", "artifact_max_logit_delta"}) \
        | {"legs"}
    want_crit = set(rec["criteria"]) - {"artifact_matches"}
    work = _workdir("certify")
    ckpt, out = os.path.join(work, "teacher.pt"), os.path.join(work, "c.json")
    argv = CERT_FLAGS + ["--teacher_ckpt", ckpt, "--out", out]
    _lib.reset_launches()
    t0 = time.perf_counter()
    rc, res = _certify(argv)
    wall = time.perf_counter() - t0
    counts = _tally(_per(SERVE_PER_LAYER["int8"], STUDENT_DEPTH))
    if set(res) != want_keys or set(res["criteria"]) != want_crit:
        raise SystemExit(f"cli/certify.py keys {sorted(res)} / criteria "
                         f"{sorted(res['criteria'])}, want {sorted(want_keys)}"
                         f" / {sorted(want_crit)}")
    phase("certify", f"300^2/d12 -> 224^2/d6, budget {res['budget']}: exit "
          f"{rc}, pass {res['pass']}, criteria {res['criteria']}; "
          f"CERT_RECIPE.json's keys and criteria (less the export's); "
          f"{wall:.1f} s on {card}; int8 leg launches "
          f"{ {n: k for n, k in counts.items() if k} } (exact)")
    for leg, v in res["legs"].items():
        phase("certify", f"leg {leg}: {v['wall_s']:.1f} s, peak device "
              f"memory {v['peak_gib']:.2f} GiB")
    _lib.reset_launches()
    t0 = time.perf_counter()
    _, again = _certify(argv + CERT_RESTORE)
    _tally({})
    phase("certify", f"second run, teacher restored from --teacher_ckpt: "
          f"teacher_auc {again['teacher_auc']!r} vs {res['teacher_auc']!r} "
          f"({time.perf_counter() - t0:.1f} s)")
    if again["teacher_auc"] != res["teacher_auc"]:
        raise SystemExit("the restored teacher gives another teacher_auc")


def distill_phase(dev, card):
    t0 = time.perf_counter()
    distill_train_phase(card)
    torch.cuda.empty_cache()
    distill_step_e2e_phase(dev)
    torch.cuda.empty_cache()
    teacher_hook_e2e_phase(dev)
    torch.cuda.empty_cache()
    certify_phase(card)
    phase("distill", f"phase 12 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 13. the serving artifact


ARTIFACT_DEPTH = {"int8": DEPTH, "float": DEPTH, "float32": DEPTH}
ARTIFACT_BUCKETS = ["1", "16"]
LATENCY_PATHS = ("int8", "float32")   # served by cli/serve.py --artifact
LOAD_THREADS, LOAD_REQUESTS, SEQUENTIAL = 16, 8, 50


def artifact_ops(path, depth):
    """{istvt::op: calls} of a path's serving program at `depth`: its
    launch counters a layer, #20's two (with and without r) one op."""
    out = {}
    for n, k in SERVE_PER_LAYER[path].items():
        op = f"istvt::{n.split('/')[0]}"
        out[op] = out.get(op, 0) + k * depth
    return out


def _counted(path, depth, forwards, fn):
    """fn() counted from 0: exactly the path's launches a forward x
    forwards, every other counter 0, no K-major copy built."""
    torch.cuda.synchronize()
    _lib.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = _tally({n: k * depth * forwards()
                     for n, k in SERVE_PER_LAYER[path].items()})
    return out, counts


def _get(port, route):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("GET", route)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


class _ServeProcess:
    """`python -m istvt_tpu_torch.cli.serve --artifact DIR --port 0` from
    the checkout, its output read on a thread; the port from its
    'serving ... on http://host:port' line. Stopped on exit."""

    def __init__(self, artifact, timeout=600):
        import queue
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "istvt_tpu_torch.cli.serve", "--artifact",
             artifact, "--port", "0"], cwd=_ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.lines = queue.Queue()
        self.log = []
        threading.Thread(target=self._read, daemon=True).start()
        deadline = time.monotonic() + timeout
        while True:
            try:
                ln = self.lines.get(timeout=max(deadline - time.monotonic(),
                                                0.1))
            except queue.Empty:
                ln = None
            if ln is None:
                self.close()
                raise SystemExit("cli/serve.py --artifact did not come up:\n"
                                 + "".join(self.log[-40:]))
            if ln.startswith("serving ") and " on http://" in ln:
                self.port = int(ln.split(" on http://", 1)[1].split()[0]
                                .rsplit(":", 1)[1])
                return

    def _read(self):
        for ln in self.proc.stdout:
            self.log.append(ln)
            self.lines.put(ln)
        self.lines.put(None)

    def close(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def _load_figures(port, clip_of):
    """16 client threads of 8 one-clip requests each: (clips/s over the
    wall time, /v1/stats after them)."""
    errors = []

    def client(i):
        for j in range(LOAD_REQUESTS):
            status, body = _post(port, clip_of(i * LOAD_REQUESTS + j))
            if status != 200 or not np.all(np.isfinite(body["logits"])):
                errors.append((status, body))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(LOAD_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise SystemExit(f"the artifact daemon under load: {errors[:3]}")
    status, stats = _get(port, "/v1/stats")
    if status != 200:
        raise SystemExit(f"/v1/stats: HTTP {status}")
    return LOAD_THREADS * LOAD_REQUESTS / wall, stats


def artifact_daemon_phase(path, out_dir, scorer, card):
    """cli/serve.py --artifact as a subprocess: one request against the
    artifact's own logit, the daemon under load, 1-clip latency."""
    rng = np.random.RandomState(14)
    clips = rng.randn(LOAD_THREADS * LOAD_REQUESTS + 1, *CLIP).astype(
        np.float32)
    t0 = time.perf_counter()
    server = _ServeProcess(out_dir)
    try:
        up = time.perf_counter() - t0
        status, body = _post(server.port, clips[0])
        _expect(status, body, 1, f"{path} artifact daemon, 1 clip")
        own = scorer.predict(clips[:1])["logits"]
        got = np.asarray(body["logits"], np.float32)
        d = float(np.abs(got - own).max())
        phase("artifact", f"{path}: cli/serve.py --artifact up in {up:.1f} "
              f"s; its logit {got.tolist()} vs the artifact's own "
              f"{own.tolist()}: |d| {d:.3e} (limit 1e-3), bit-equal "
              f"{bool(np.array_equal(got, own))}")
        if not d <= 1e-3:
            raise SystemExit(f"{path}: the artifact daemon's logit differs "
                             f"from the artifact's")
        rate, stats = _load_figures(server.port, lambda i: clips[1 + i])
        lat = stats["latency_ms"]
        phase("artifact", f"{path}: daemon under {LOAD_THREADS} client "
              f"threads x {LOAD_REQUESTS} one-clip requests: "
              f"{rate:.2f} clips/s; /v1/stats: p50 {lat['p50']:.3f} ms, "
              f"p99 {lat['p99']:.3f} ms, {stats['batches']} batches, "
              f"occupancy {stats['batch_occupancy']} (requests "
              f"{stats['requests']}, the first one above included) on "
              f"{card} (informative)")
        ms = []
        for i in range(SEQUENTIAL):
            t1 = time.perf_counter()
            status, body = _post(server.port, clips[i % len(clips)])
            ms.append((time.perf_counter() - t1) * 1e3)
            if status != 200:
                raise SystemExit(f"{path}: HTTP {status} {body}")
        phase("artifact", f"{path}: 1-clip HTTP latency over {SEQUENTIAL} "
              f"sequential requests: median {np.median(ms):.3f} ms, p99 "
              f"{np.percentile(ms, 99):.3f} ms, min {min(ms):.3f} on {card} "
              f"(informative)")
    finally:
        server.close()


def _write_pyprofile(fn, x, title, profile, rows=30):
    """cProfile's statistics of one call fn(x) (after a warm-up one), the
    Python functions by their own time, appended to `profile`."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    with torch.inference_mode():
        fn(x)
        torch.cuda.synchronize()
        prof.enable()
        fn(x)
        torch.cuda.synchronize()
        prof.disable()
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(rows)
    with open(profile, "a") as f:
        f.write(f"{title}, cProfile\n{buf.getvalue()}\n")


def _host_state(after):
    """The host as a run left it: load average, Python's trace and profile
    hooks, torch's intra-op threads, the ns of a pure-Python call (os.getenv,
    20,000 times) and the busiest processes (ps)."""
    t0 = time.perf_counter()
    for _ in range(20000):
        os.getenv("ISTVT_UNSET")
    ns = (time.perf_counter() - t0) / 20000 * 1e9
    ps = subprocess.run(["ps", "-eo", "pid,pcpu,etime,comm", "--sort=-pcpu"],
                        capture_output=True, text=True).stdout.splitlines()
    return (f"after {after}: loadavg {os.getloadavg()}, trace "
            f"{sys.gettrace()}, profile {sys.getprofile()}, torch threads "
            f"{torch.get_num_threads()}, os.getenv {ns:.0f} ns a call; ps "
            f"{ps[:6]}")


def _op_call_costs(model, profile, calls=100):
    """Host us a call of #1 on layer 0's weights at B=1, called through its
    op's overload (as a program calls it), its overload packet (as the
    wrapper does) and its CUDA implementation directly; appended to
    `profile` and printed."""
    from istvt_tpu_torch.kernels import quant
    pt = model.vit.transformer.layers[0][0]
    at = pt.fn
    x = torch.randn(1, CLIP[0] + 1, 368, PAPER.dim, device="cuda",
                    dtype=torch.bfloat16)
    args = (x, pt.norm.weight, pt.norm.bias, at.qkv_wq, at.qkv_ws,
            PAPER.heads, [at.qkv_wk])
    ways = {"overload": torch.ops.istvt.ln_qkv_q8_temporal_attention.default,
            "packet": torch.ops.istvt.ln_qkv_q8_temporal_attention,
            "direct": quant._ln_qkv_q8_temporal_cuda}
    us = {}
    with torch.inference_mode():
        for name, fn in ways.items():
            fn(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(*args)
            host = time.perf_counter() - t0
            torch.cuda.synchronize()
            us[name] = round(host / calls * 1e6, 1)
    _lib.reset_launches()
    phase("artifact", f"int8: host us a call of #1 at B=1: {us}")
    with open(profile, "a") as f:
        f.write(f"host us a call of #1 at B=1: {us}\n")


def artifact_phase(path, card, profile=None):
    """13 for one path: export through cli/export.py, the program's ops,
    the artifact vs the live Predictor (logits, launches, B=16 time; with
    `profile`, a profiled B=16 forward of each)."""
    depth = ARTIFACT_DEPTH[path]
    out_dir = _workdir(f"artifact_{path}")
    argv = PATHS[path] + ["--depth", str(depth), "--batch_sizes",
                          *ARTIFACT_BUCKETS, "--selftest", "--out", out_dir]
    t0 = time.perf_counter()
    res = cli_export.export(cli_export.build_parser().parse_args(argv))
    wall = time.perf_counter() - t0
    live, scorer, man = res["predictor"], res["scorer"], res["manifest"]
    phase("artifact", f"{path}: cli/export.py {' '.join(argv[:-2])} (depth "
          f"{depth}, {CLIP[1]}^2 x {CLIP[0]}): export {res['export_s']:.1f} "
          f"s, load {res['load_s']:.1f} s, {res['bytes']} bytes "
          f"({', '.join(sorted(os.listdir(out_dir)))}); selftest max|d| "
          f"{res['delta']:.3e} over {res['n_clips']} clips (limit 1e-3); "
          f"the command {wall:.1f} s, model build included, on {card}")
    if not res["delta"] <= 1e-3:
        raise SystemExit(f"{path}: the artifact's selftest failed")
    want = artifact_ops(path, depth)
    held = {f"istvt::{n}": k
            for n, k in kernel_ops.op_counts(scorer.program.graph).items()
            if k}
    phase("artifact", f"{path}: the program's istvt:: ops {held} (manifest "
          f"{man['custom_ops']}; want exactly {want})")
    if held != want or man["custom_ops"] != want:
        raise SystemExit(f"{path}: the program holds other ops than the "
                         f"path's kernels")
    clips = np.random.RandomState(13).randn(16, *CLIP).astype(np.float32)
    scorer.n_forwards = live.n_forwards = 0
    got, c_art = _counted(path, depth, lambda: scorer.n_forwards,
                          lambda: scorer.predict(clips)["logits"])
    want_l, c_live = _counted(path, depth, lambda: live.n_forwards,
                              lambda: live.predict(clips)["logits"])
    d = float(np.abs(got - want_l).max())
    phase("artifact", f"{path}: 16 clips, artifact vs live Predictor on the "
          f"same weights: max|d| {d:.3e} (limit 1e-3), bit-equal "
          f"{bool(np.array_equal(got, want_l))}; launches, artifact "
          f"{ {n: k for n, k in c_art.items() if k} }, live "
          f"{ {n: k for n, k in c_live.items() if k} } (exact; K-major "
          f"copies built 0)")
    if not d <= 1e-3:
        raise SystemExit(f"{path}: the artifact's logits differ from the "
                         f"live model's")
    dt = live.compute_dtype or live.input_dtype or torch.float32
    runs = {"artifact": lambda x: scorer._fn(x),
            "live": lambda x: live.model(x.to(dt))}
    med = {n: [] for n in runs}
    gcs = {n: [] for n in runs}       # the interpreter's collections
    allocs = {n: dict.fromkeys(alloc_counters(), 0) for n in runs}
    free, total = torch.cuda.mem_get_info()
    threads = sorted(t.name for t in threading.enumerate())
    for _ in range(2):
        for name, fn in runs.items():
            before = alloc_counters()
            with gc_pauses() as pauses:
                times, _ = _counted(path, depth, lambda: WARMUP + ITERS,
                                    lambda fn=fn: forward_times(
                                        fn, CLIP, torch.float32))
            med[name].append(float(np.median(times)))
            gcs[name] += pauses
            for k, v in alloc_counters().items():
                allocs[name][k] += v - before[k]
    gc_line = {n: f"{len(p)} ({sum(g == 2 for g, _ in p)} of generation "
                  f"2), {sum(ms for _, ms in p):.1f} ms"
               for n, p in gcs.items()}
    phase("artifact", f"{path}: B=16 forward median ms, in turns (artifact, "
          f"live, artifact, live), f32 clips cast inside: artifact "
          f"{med['artifact']}, live {med['live']} on {card}; launches "
          f"exactly {WARMUP + ITERS} forwards' each; over the 44 forwards "
          f"of each: garbage collections {gc_line}, the caching "
          f"allocator's driver calls {allocs}; the card's memory free "
          f"before {free / 2**30:.2f} of {total / 2**30:.2f} GiB; threads "
          f"{threads} (informative)")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        x = torch.randn(16, *CLIP, device="cuda")
        for name, fn in runs.items():
            with torch.inference_mode():
                for _ in range(3):
                    fn(x)
            phase("artifact", f"{path} {name}: " + _host_state(
                "3 B=16 forwards"))
            with prof_ctx(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                with torch.inference_mode():
                    fn(x)
                torch.cuda.synchronize()
            _write_profile(prof, f"{card}, {path} {name}, B=16 forward",
                           profile)
            _write_pyprofile(fn, x, f"{card}, {path} {name}, B=16 forward",
                             profile)
        if path == "int8":
            _op_call_costs(live.model, profile)
            n = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                one = {name: float(np.median(forward_times(
                    fn, CLIP, torch.float32))) for name, fn in runs.items()}
            finally:
                torch.set_num_threads(n)
            _lib.reset_launches()
            phase("artifact", f"int8: B=16 forward median ms with torch's "
                  f"intra-op threads at 1 (from {n}): {one}")
        phase("artifact", f"{path}: profile tables appended to {profile}")
    if path in LATENCY_PATHS:
        artifact_daemon_phase(path, out_dir, scorer, card)


def artifact_phases(card, profile=None):
    t0 = time.perf_counter()
    for path in PATHS:
        artifact_phase(path, card, profile)
        torch.cuda.empty_cache()
    phase("artifact", f"phase 13 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 14. the bench CLI and the tooling

# cli/bench.py runs (arguments beside the CLI's defaults: the paper model,
# 300^2 x 6, depth 12, bf16 on the card); --iters small enough for the
# phase's budget
BENCH_RUNS = {
    "int8 chained": ["--quantize", "int8", "-bs", "16", "--chained",
                     "--iters", "10"],
    "bf16 B=16": ["-bs", "16", "--iters", "10"],
    "bf16 B=1": ["-bs", "1", "--iters", "20"],
    "train grad_accum 2": ["--train_step", "-bs", "16", "--grad_accum", "2",
                           "--iters", "3"],
    "train remat": ["--train_step", "-bs", "16", "--remat", "--iters", "2"],
    # 12 batches: at 4 the loader's prefetch covers most of the e2e leg
    "pipeline uint8": ["--pipeline", "-bs", "16", "--iters", "12"],
    "pipeline f32": ["--pipeline", "-bs", "16", "--f32_ingest",
                     "--iters", "12"],
    "pipeline f32 no_native": ["--pipeline", "-bs", "16", "--f32_ingest",
                               "--no_native", "--iters", "12"],
}
# the JSON keys, in order, of each mode of the JAX package's CLI
# (istvt_tpu/cli/bench.py:393-400, 368-377, 337-348, 225-250)
BENCH_KEYS = {
    "forward": ["model", "mode", "batch", "median_ms", "items_per_sec",
                "platform"],
    "forward_chained": ["model", "mode", "batch", "input_size", "quantize",
                        "mean_ms", "items_per_sec", "platform"],
    "train_step": ["model", "mode", "batch", "grad_accum", "remat",
                   "mean_ms", "items_per_sec", "platform"],
    "pipeline": ["mode", "model", "batch", "batches", "platform",
                 "native_decode", "ingest", "h2d_mb_per_batch",
                 "num_workers", "host_decode_clips_per_sec",
                 "h2d_transfer_clips_per_sec", "device_clips_per_sec",
                 "e2e_clips_per_sec", "overlap_fraction"],
}
TRACE_TOP = 25
# the trace's rows outside the port, by the operators that launched them
# (and AdamW's: every aten::_foreach_* / aten::_fused_adam*)
TRACE_GROUPS = {
    "convolutions": ("aten::conv2d", "aten::convolution",
                     "aten::convolution_backward"),
    "casts and copies": ("aten::to", "aten::_to_copy", "aten::copy_"),
    "pooling": ("aten::max_pool2d", "aten::max_pool2d_with_indices",
                "aten::max_pool2d_with_indices_backward"),
}


def _trace_group(prefix):
    if prefix.startswith(("aten::_foreach_", "aten::_fused_adam")):
        return "optimizer"
    return next((g for g, ops in TRACE_GROUPS.items() if prefix in ops),
                "other aten")


def bench_launches(argv):
    """{kernel: launches} of one cli/bench.py run: per forward (the
    path's SERVE_PER_LAYER) or per microbatch of a train step
    (TRAIN_PER_LAYER, the forward kernels twice with --remat) x depth x the
    forwards or steps the mode runs (a warm-up + --iters forwards; two
    untimed + --iters steps; the pipeline's 2 max(--iters, 4) forwards at
    the paper depth)."""
    a = cli_bench.build_parser().parse_args(argv)
    if a.pipeline:
        return _per(SERVE_PER_LAYER["int8"], DEPTH * 2 * max(a.iters, 4))
    if a.train_step:
        per = {n: k * (2 if a.remat and not n.endswith("/bwd") else 1)
               for n, k in TRAIN_PER_LAYER.items()}
        return _per(per, a.depth * (a.iters + 2) * a.grad_accum)
    path = "int8" if a.quantize == "int8" else "float"
    return _per(SERVE_PER_LAYER[path], a.depth * (a.iters + 1))


def bench_runs():
    """Each BENCH_RUNS entry through cli/bench.main in this process,
    counted from 0: its JSON line's keys are JAX's for its mode and its
    platform 'gpu'; every kernel launched exactly bench_launches, every
    other counter 0."""
    tree_root = cli_bench._ensure_frame_tree(_workdir("bench_tree"),
                                             PAPER.image_size)
    for name, argv in BENCH_RUNS.items():
        if "--pipeline" in argv:
            argv = argv + ["--data_root", tree_root]
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        _lib.reset_launches()
        out = cli_bench.main(argv)
        torch.cuda.synchronize()
        counts = _tally(bench_launches(argv))
        if list(out) != BENCH_KEYS[out["mode"]] or out["platform"] != "gpu":
            raise SystemExit(f"bench {name}: keys {list(out)}, platform "
                             f"{out['platform']}; want "
                             f"{BENCH_KEYS[out['mode']]} on 'gpu'")
        phase("bench", f"{name} ({' '.join(argv)}): JAX's keys; launches "
              f"{ {n: k for n, k in counts.items() if k} } exactly (every "
              f"other counter 0); {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()


def _nan_steps(card):
    """One depth-2 B=2 bf16 fused step (--use_pallas, cli/train.py's build)
    of two models from one seed, one inside utils/debug.debug_nans: loss
    and gradient norm bit-equal, counted; the host ms of two more steps
    each, in turns; then one NaN pixel raises FloatingPointError inside the
    mode, and the mode is gone after."""
    flags = ["--depth", "2", "--batch_size", "2", "--dataset_len", "2",
             "--epochs", "1"]
    built = [_trainer(flags) for _ in range(2)]
    trainers = [tr for tr, _, _ in built]
    dev = next(trainers[0].model.parameters()).device
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in next(iter(built[0][1])).items()}
    states = [tr.init_state() for tr in trainers]
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        def step(i, checked):
            t0 = time.perf_counter()
            with debug_nans(checked):
                m = trainers[i].step_fn(states[i], batch)
                m = {k: float(v) for k, v in m.items()}
            return m, 1e3 * (time.perf_counter() - t0)

        torch.cuda.synchronize()
        _lib.reset_launches()
        (plain, _), (checked, _) = step(0, False), step(1, True)
        counts = _tally(_per(TRAIN_PER_LAYER, 2 * 2))
        same_params = all(torch.equal(p, q) for p, q in zip(
            trainers[0].model.parameters(), trainers[1].model.parameters()))
        phase("debug_nans", f"depth 2, B=2 bf16 fused step: without the "
              f"mode {plain}, inside it {checked}: loss and gradient norm "
              f"bit-equal {plain == checked}; parameters after the step "
              f"bit-equal {same_params}; launches "
              f"{ {n: k for n, k in counts.items() if k} } exactly (2 steps, "
              f"every other counter 0)")
        if plain["loss"] != checked["loss"] or \
                plain["grad_norm"] != checked["grad_norm"]:
            raise SystemExit("debug_nans changed a clean step")
        ms = {False: [], True: []}
        for checked_ in (False, True, True, False):
            ms[checked_].append(step(int(checked_), checked_)[1])
        phase("debug_nans", f"host ms a step without the mode "
              f"{[round(t, 3) for t in ms[False]]}, inside it "
              f"{[round(t, 3) for t in ms[True]]} on {card} (informative)")
        batch["clips"][0, 0, 0, 0, 0] = float("nan")
        try:
            step(1, True)
        except FloatingPointError as e:
            phase("debug_nans", f"one NaN pixel: FloatingPointError: {e}")
        else:
            raise SystemExit("debug_nans let a NaN pixel through")
        if nan_check_active() or torch.is_anomaly_enabled():
            raise SystemExit("debug_nans left its mode on")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = prev
        _lib.reset_launches()


def _trace_step(card):
    """One B=16 depth-12 bf16 train step (phase 7's trainer) inside
    utils/profiling.trace, summarized by utils/trace_summary: device time by
    the operator that launched it, the port's (istvt::) apart from the
    rest, copies apart."""
    trainer, ts, batches = paper_trainer(cli_train, _workdir("train"))
    warm_up(trainer, ts, batches[0])
    t0 = time.perf_counter()
    with trace(_workdir("trace")) as log_dir:
        float(trainer.step_fn(ts, batches[1])["loss"])
    wall = 1e3 * (time.perf_counter() - t0)
    path = trace_summary.find_traces(log_dir)[-1]
    rows = trace_summary.aggregate(trace_summary.parse_file(path))
    busy = [r for r in rows if not r.asynchronous]
    port = sum(r.total_ms for r in busy if r.prefix.startswith("istvt::"))
    total = sum(r.total_ms for r in busy)
    phase("trace", f"B={TRAIN_BATCH} bf16 train step at depth {DEPTH} on "
          f"{card}: host {wall:.3f} ms under the profiler; kernels "
          f"{total:.3f} ms, the port's (istvt::) {port:.3f}, outside them "
          f"{total - port:.3f}; by launching operator (top {TRACE_TOP}):\n"
          + trace_summary.format_table(busy, top=TRACE_TOP))
    groups = {}
    for r in busy:
        if r.prefix.startswith("istvt::"):
            continue
        g = _trace_group(r.prefix)
        ms, n = groups.get(g, (0.0, 0))
        groups[g] = (ms + r.total_ms, n + r.count)
    phase("trace", "outside the port, every row grouped: " + "; ".join(
        f"{g} {ms:.3f} ms ({n} kernels)" for g, (ms, n) in sorted(
            groups.items(), key=lambda kv: -kv[1][0])))
    phase("trace", "copies and memsets (not busy time):\n"
          + trace_summary.format_table(
              [r for r in rows if r.asynchronous], top=TRACE_TOP))
    del trainer, ts, batches


def bench_phase(card):
    """Phase 14."""
    t0 = time.perf_counter()
    bench_runs()
    _nan_steps(card)
    torch.cuda.empty_cache()
    _trace_step(card)
    torch.cuda.empty_cache()
    phase("bench", f"phase 14 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 15. geometries past the paper's

# (seq_len, input_size) of the fused paths' other geometries: longer clips
# (T1 = 9, 17: the temporal cores' general lanes) and larger frames (a
# 20 x 20 and a 28 x 28 feature grid: S = 408, 792)
GEOMETRIES = {"--seq_len 8": (8, 300), "--seq_len 16": (16, 300),
              "-is 320": (6, 320), "-is 448": (6, 448)}
GEOMETRY_DEPTH, GEOMETRY_BATCH = 2, 2


def _geometry_predictor(path, seq_len, size, depth, dev):
    args = cli_serve.build_parser().parse_args(
        PATHS[path] + ["-sl", str(seq_len), "-is", str(size), "--depth",
                       str(depth)])
    return cli_serve.build_predictor(args, dev)


def _counted_predict(predictor, clips, per_layer, depth):
    """The predictor's logits of clips, counted from 0: exactly per_layer x
    depth launches a forward."""
    _lib.reset_launches()
    predictor.n_forwards = 0
    logits = predictor.predict(clips)["logits"]
    torch.cuda.synchronize()
    _tally({n: k * depth * predictor.n_forwards
            for n, k in per_layer.items()})
    return logits


def _cpu_logits(path, model, clips):
    """The same model on the CPU in f32 (plain versions)."""
    cpu_model = tree.cast(copy.deepcopy(model).to("cpu"), torch.float32)
    if path in PACKED:
        istvt.pack_params(cpu_model)
    with highest(), torch.inference_mode():
        return cpu_model(torch.from_numpy(clips)).reshape(-1).numpy()


def geometry_phase(dev, card):
    """Phase 15: the serving paths, the layer mode and an f32 train step
    at GEOMETRIES, card vs CPU; then B=16 depth-12 forwards there."""
    t_all = time.perf_counter()
    worst = {}
    for name, (seq_len, size) in GEOMETRIES.items():
        clips = np.random.RandomState(seq_len + size).randn(
            GEOMETRY_BATCH, seq_len, size, size, 3).astype(np.float32)
        for path in PATHS:
            t0 = time.perf_counter()
            pred = _geometry_predictor(path, seq_len, size, GEOMETRY_DEPTH,
                                       dev)
            got = _counted_predict(pred, clips, SERVE_PER_LAYER[path],
                                   GEOMETRY_DEPTH)
            t1 = time.perf_counter()
            want = _cpu_logits(path, pred.model, clips)
            t2 = time.perf_counter()
            delta = float(np.abs(got - want).max())
            worst[path] = max(worst.get(path, 0.0), delta)
            phase("geometry", f"{name} (T1 = {seq_len + 1}, "
                  f"{istvt.infer_feat_hw(size)}^2 + 1 tokens), {path}, depth "
                  f"{GEOMETRY_DEPTH}, B={GEOMETRY_BATCH}: card "
                  f"{np.round(got, 5).tolist()} vs CPU plain f32 "
                  f"{np.round(want, 5).tolist()}: |dlogit| {delta:.3e} "
                  f"(limit 5e-2); launches exact (card {t1 - t0:.1f} s, CPU "
                  f"{t2 - t1:.1f} s)")
            if not (np.isfinite(got).all() and delta <= 5e-2):
                raise SystemExit(f"{name}, {path}: card logits disagree "
                                 f"with the CPU reference")
            if path == "int8" and seq_len == 8:
                set_mode(pred.model, "layer")
                layer = _counted_predict(pred, clips,
                                         MODE_PER_LAYER["layer"],
                                         GEOMETRY_DEPTH)
                gap = np.abs(layer - got)
                ok = bool((gap <= 2e-2 + 2e-2 * np.abs(got)).all())
                phase("geometry", f"{name}: layer vs ingest logits: max|d| "
                      f"{gap.max():.3e} ({'ok' if ok else 'FAIL'} at atol = "
                      f"rtol = 2e-2); bit for bit equal: "
                      f"{bool(np.array_equal(layer, got))}; launches exact")
                if not ok:
                    raise SystemExit(f"{name}: the layer path disagrees with "
                                     f"the ingest chain")
            del pred
            torch.cuda.empty_cache()
    phase("geometry", f"largest |dlogit| by path: "
          + ", ".join(f"{p} {d:.3e}" for p, d in worst.items())
          + " (f32: the float path in f32 against the same f32 math)")
    t0 = time.perf_counter()
    _geometry_train_step()
    phase("geometry", f"train step phase {time.perf_counter() - t0:.1f} s")
    for name in ("--seq_len 8", "-is 320"):
        seq_len, size = GEOMETRIES[name]
        for path in ("int8", "float"):
            pred = _geometry_predictor(path, seq_len, size, DEPTH, dev)
            _lib.reset_launches()
            times = forward_times(pred.model, (seq_len, size, size, 3),
                                  input_dtype(path))
            _tally({n: k * DEPTH * (WARMUP + ITERS)
                    for n, k in SERVE_PER_LAYER[path].items()})
            ms = float(np.median(times))
            phase("geometry", f"{name}, {path}: B=16 depth-{DEPTH} forward "
                  f"median {ms:.3f} ms = {16e3 / ms:.2f} clips/s on {card}; "
                  f"launches exact (informative)")
            del pred
            torch.cuda.empty_cache()
    phase("geometry", f"phase 15 took {time.perf_counter() - t_all:.1f} s")


def _geometry_train_step():
    """One f32 --use_pallas step at --seq_len 8, -is 320, depth 2, B=2:
    the card (kernels) vs the CPU (plain) from the same weights and batch,
    at the f32 limits."""
    flags = ["--depth", str(GEOMETRY_DEPTH), "--batch_size",
             str(GEOMETRY_BATCH), "--dataset_len", str(GEOMETRY_BATCH),
             "--epochs", "1", "--seq_len", "8", "--input_size", "320"]
    card_tr, loader, _ = _trainer(flags, bf16=False)
    cpu_tr, _, _ = _trainer(flags + ["--device", "cpu"], bf16=False)
    batch = next(iter(loader))
    out = []
    for tr in (card_tr, cpu_tr):
        ts = tr.init_state()
        _lib.reset_launches()
        with highest():
            m = tr.step_fn(ts, batch)
        out.append((float(m["loss"]), torch.cat([
            p.grad.double().cpu().ravel() for p in tr.model.parameters()])))
        if tr is card_tr:
            torch.cuda.synchronize()
            _tally({n: k * GEOMETRY_DEPTH for n, k in TRAIN_PER_LAYER.items()})
    (l_card, g_card), (l_cpu, g_cpu) = out
    cos = float(F.cosine_similarity(g_card, g_cpu, dim=0))
    phase("geometry", f"--seq_len 8 -is 320, f32 --use_pallas step, depth "
          f"{GEOMETRY_DEPTH}, B={GEOMETRY_BATCH}: loss card {l_card:.7f} vs "
          f"CPU plain f32 {l_cpu:.7f} (|d| {abs(l_card - l_cpu):.3e}, limit "
          f"1e-5); gradient cosine {cos:.7f} (limit 0.99999); launches "
          f"exact")
    if not (abs(l_card - l_cpu) <= 1e-5 and cos >= 0.99999):
        raise SystemExit("the card's train step at --seq_len 8 -is 320 "
                         "disagrees with the CPU reference")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default=None,
                    help="write torch.profiler tables of a B=16 forward of "
                         "each serving path and int8 mode, a B=16 train "
                         "step, a B=1 generate_lrp call with and "
                         "without use_pallas and a B=16 forward of each "
                         "serving artifact and its live model here")
    args = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke needs an NVIDIA GPU")
    dev = require_cuda()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    phase("device", f"{kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # 2. build
    t0 = time.perf_counter()
    _lib.load()
    phase("build", f"nvcc sm_90a build + load {time.perf_counter() - t0:.1f} s "
          f"(log: {os.path.relpath(_lib.BUILD_DIR / 'build.log')})")
    sass = _lib.sass_text()
    igmma = [ln.strip() for ln in sass.splitlines()
             if selfcheck.INT8_WGMMA_OP in ln]
    phase("build", f"int8 wgmma in the SASS: {len(igmma)} instructions, "
          f"e.g. {igmma[0] if igmma else None}")
    imma = _lib.tensor_ops_of_sass(sass, (selfcheck.INT8_MMA_SYNC_OP,))
    for kernel, dtype, found, ok in selfcheck.tensor_core_check(
            _lib.tensor_ops_of_sass(sass),
            _lib.tensor_ops_of_sass(sass, ("HGMMA.",)),
            _lib.tensor_ops_of_sass(sass, (selfcheck.INT8_WGMMA_OP,)), imma,
            _lib.tensor_ops_of_sass(sass, (selfcheck.TF32_WGMMA_OP,)),
            _lib.tensor_ops_of_sass(sass, (selfcheck.TF32_MMA_OP,))):
        what = ("HGMMA" if kernel in selfcheck.WGMMA_KERNELS
                else "TF32 HGMMA" if kernel in selfcheck.TF32_WGMMA_KERNELS
                else "TF32 HMMA" if dtype == "f32"
                else "IGMMA" if dtype == "int8" else "tensor-core")
        phase("build", f"{kernel} {dtype}: {what} instructions "
              f"{sorted(found.values())}"
              + (f", IMMA {sum(imma.get(n, 0) for n in found)}"
                 if dtype == "int8" else "")
              + f" ({'ok' if ok else 'FAIL'}: each wanted"
              + (", no IMMA" if dtype == "int8" else "") + ")")
        if not ok:
            raise SystemExit(f"{kernel} in {dtype} is not on the pipes it "
                             f"should be")
    # the wgmma kernels at the launch budget with nothing spilled
    log = (_lib.BUILD_DIR / "build.log").read_text()
    report = _lib.ptxas_report(log)
    for kernel, regs, off in selfcheck.wgmma_register_rows(report):
        phase("build", f"{kernel}: ptxas, {len(regs)} instantiations, "
              f"registers {sorted(regs.values())}, off budget {len(off)} "
              f"(ok: none wanted: no spill, "
              f"{'exactly' if kernel in selfcheck.TF32_WGMMA_KERNELS else 'at most'}"
              f" {selfcheck.WGMMA_REGISTERS})")
        if not regs or off:
            raise SystemExit(f"{kernel} spills or is off its register "
                             f"budget: {off}")
    # the spatial attention kernels: no f32 instantiation spilled
    for kernel, regs, spilled in selfcheck.spill_rows(
            report, selfcheck.SPATIAL_KERNELS):
        f32 = [n for n in spilled if f"{len(kernel)}{kernel}If" in n]
        phase("build", f"{kernel}: ptxas, {len(regs)} instantiations, "
              f"registers {sorted(regs.values())}, spilled: f32 {len(f32)} "
              f"(ok: none wanted), bf16 {len(spilled) - len(f32)}")
        if not regs or f32:
            raise SystemExit(f"{kernel}: f32 instantiations spill: {f32}")
    serialized = [ln.strip() for ln in log.splitlines()
                  if "wgmma" in ln and "serialized" in ln]
    phase("build", f"ptxas notes of serialized wgmma: {len(serialized)}"
          + "".join(f"\n  {ln}" for ln in serialized))
    # the temporal cores: every head layout's instantiation, none spilled
    for kernel, regs, spilled in selfcheck.spill_rows(
            report, selfcheck.TEMPORAL_KERNELS):
        want = selfcheck.TEMPORAL_KERNELS[kernel]
        phase("build", f"{kernel}: ptxas, {len(regs)} instantiations (want "
              f"{want}), registers {sorted(regs.values())}, spilled "
              f"{len(spilled)} (ok: none wanted)")
        if len(regs) != want or spilled:
            raise SystemExit(f"{kernel}: {len(regs)} instantiations, spilled "
                             f"{spilled}")

    # 3. kernels, then the float and the int8 GEMM alone at their callers'
    # shapes
    rows = check_kernels(dev)
    gemm_phase(dev)
    gemm_q8_phase(dev)
    if args.profile:
        open(args.profile, "w").close()

    # 4-6 per path, at the paper geometry; after the int8 path, its modes
    for path in PATHS:
        t0 = time.perf_counter()
        predictor = cli_serve.build_predictor(
            cli_serve.build_parser().parse_args(PATHS[path]), dev)
        phase("serving", f"{path}: model built in "
              f"{time.perf_counter() - t0:.1f} s")
        serve_phase(path, predictor)
        e2e_phase(path, predictor)
        timing_phase(path, predictor.model, dev, card, args.profile)
        if path == "int8":
            mode_phases(predictor, dev, card, args.profile)
        del predictor
        torch.cuda.empty_cache()

    # 7-8 training
    train_phase(card, args.profile)
    torch.cuda.empty_cache()
    train_e2e_phase()
    torch.cuda.empty_cache()
    # 8b-8d the reference's default recipe, checkpoints and resume
    dropout_train_phase(card)
    dropout_e2e_phase()
    torch.cuda.empty_cache()
    checkpoint_phase(dev, card)
    torch.cuda.empty_cache()
    # 8e from disk
    data_phase(dev, card)
    torch.cuda.empty_cache()

    # 9-10 the interpretability path
    interpret_phase(dev, card, args.profile)
    torch.cuda.empty_cache()
    interpret_e2e_phase(dev)
    torch.cuda.empty_cache()

    # 11 the kernel API
    kernel_api_phase(dev)
    torch.cuda.empty_cache()

    # 12 distillation and certification
    distill_phase(dev, card)
    torch.cuda.empty_cache()

    # 13 the serving artifact
    artifact_phases(card, args.profile)

    # 14 the bench CLI and the tooling
    bench_phase(card)
    torch.cuda.empty_cache()

    # 15 geometries past the paper's
    geometry_phase(dev, card)

    idle = [n for n, k in TOTAL.items() if k == 0]
    if idle:
        raise SystemExit(f"kernels never launched on a counted path: {idle}")
    variants = {n: [{"case": c, **r} for c, r in rows.items()
                    if c != n and selfcheck.counter(c) == n]
                for n in KERNELS}
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": KERNELS[n][0],
         "replaces": KERNELS[n][1], "launches": TOTAL[n], **rows[n],
         **({"variants": variants[n]} if variants[n] else {})}
        for n in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as WORK:
        main()
