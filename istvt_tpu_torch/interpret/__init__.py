"""Interpretability (counterpart of istvt_tpu/interpret): LRP-style
relevance rollout, full epsilon-rule LRP, and saliency rendering."""
from istvt_tpu_torch.interpret.lrp import (  # noqa: F401
    attention_maps_and_grads,
    generate_feature_relevance,
    generate_lrp,
)
from istvt_tpu_torch.interpret.full_lrp import generate_full_lrp  # noqa: F401
from istvt_tpu_torch.interpret.heatmap import (  # noqa: F401
    bilinear_upsample,
    jet,
    minmax,
    render_saliency,
    save_png,
    show_cam_on_image,
)
