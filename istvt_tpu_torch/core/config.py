"""ISTVT geometry and compute knobs, and the training run's settings.

Copies of `istvt_tpu.core.config.ISTVTConfig`, `DataConfig` and
`TrainConfig`: importing the JAX package's config pulls in `jax`
(`istvt_tpu/core/__init__.py` imports the mesh module), so the port keeps
its own dataclasses. tests/test_torch_scaffold.py and
tests/test_torch_train_step.py hold their fields and defaults equal to
the JAX ones.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ISTVTConfig:
    """Geometry of the ISTVT model (reference network/vivit/vivit.py:103-208).

    Defaults reproduce the paper model: 6-frame 300x300 clips, Xception entry
    flow to a 19x19x728 feature map, 12 decomposed spatial-temporal layers,
    8 heads x 64 dim_head, one output logit.
    """

    num_frames: int = 6
    image_size: int = 300
    feat_hw: int = 19
    dim: int = 728
    depth: int = 12
    heads: int = 8
    dim_head: int = 64
    mlp_ratio: int = 4
    num_classes: int = 1
    dropout: float = 0.0
    use_pallas: bool = False       # fused kernels (CUDA here)
    quantize: str = "none"         # 'int8': W8A8 ST-layer GEMMs for serving
    q8_ff: str = "full"            # 'full' | 'mixed' | 'bf16'; any other
    #                                value runs the q8 blocks then the
    #                                fully-int8 FF (kernels/quant #7)
    stem_store: str = "f8"         # int8-serving stem storage: 'f8' | 'bf16'
    q8_attn: str = "ingest"        # 'ingest' | 'boundary' | 'layer'
    remat: bool = False

    @property
    def tokens_per_frame(self) -> int:
        return self.feat_hw * self.feat_hw + 1

    @property
    def inner_dim(self) -> int:
        return self.heads * self.dim_head


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Run-level data settings the Trainer reads (core/config.DataConfig)."""

    root: str = ""
    quality: str = "hq"             # 'hq' | 'lq'
    seq_len: int = 6
    input_size: int = 300
    batch_size: int = 16
    dataset: str = "ff++"           # 'ff++' | 'celeb' | 'oulu' |
                                    # 'synthetic' | 'ff++video'
    dataset_len: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule and run settings (core/config.TrainConfig)."""

    model_name: str = "istvt"
    num_epochs: int = 40
    base_lr: float = 5e-4           # reference train_CNN.py:209-211
    optimizer: str = "adamw"        # 'adamw' | 'sgd'
    weight_decay: float = 0.01
    momentum: float = 0.9
    seed: int = 0
    warmup_epochs: int = 20
    checkpoint_dir: str = "./output"
    log_every: int = 1000
    debug_nans: bool = False
    compute_dtype: str = "float32"  # 'bfloat16': bf16 forward/backward
                                    # against f32 master params
