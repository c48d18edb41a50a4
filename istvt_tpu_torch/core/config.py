"""ISTVT geometry and compute knobs.

A copy of `istvt_tpu.core.config.ISTVTConfig`: importing the JAX package's
config pulls in `jax` (`istvt_tpu/core/__init__.py` imports the mesh
module), so the port keeps its own dataclass. tests/test_torch_scaffold.py
holds its fields and defaults equal to the JAX one.
"""
from __future__ import annotations

import dataclasses


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
    q8_ff: str = "full"            # 'full' | 'mixed' | 'bf16'
    stem_store: str = "f8"         # int8-serving stem storage: 'f8' | 'bf16'
    q8_attn: str = "ingest"        # 'ingest' | 'boundary' | 'layer'
    remat: bool = False

    @property
    def tokens_per_frame(self) -> int:
        return self.feat_hw * self.feat_hw + 1

    @property
    def inner_dim(self) -> int:
        return self.heads * self.dim_head
