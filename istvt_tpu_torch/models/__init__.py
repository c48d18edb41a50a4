from istvt_tpu_torch.models.registry import (  # noqa: F401
    available_models,
    model_selection,
)
