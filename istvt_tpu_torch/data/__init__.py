"""Host-side data pipeline (counterpart of istvt_tpu/data): frame-tree
manifests, transforms, the clip datasets, the prefetching loader and its
feed to the card, and the raw-video front end."""
from istvt_tpu_torch.data.transforms import (  # noqa: F401
    Transform,
    select_transform,
    xception_default_data_transforms,
    xception_default_data_transforms_256,
    xception_default_data_transforms_300,
    data_transform_aug,
    data_transforms_shuffle,
)
from istvt_tpu_torch.data.manifest import (  # noqa: F401
    FFPP_METHODS,
    VideoEntry,
    scan_ffpp,
    scan_binary_tree,
    split_train_val,
)
from istvt_tpu_torch.data.video_dataset import (  # noqa: F401
    Celeb,
    ClipDataset,
    MixedVideoDataset,
    OULU,
    SyntheticVideoDataset,
    VideoSeqDataset,
)
from istvt_tpu_torch.data.loader import (  # noqa: F401
    ClipLoader,
    collate,
    device_feed,
    device_normalize,
)
from istvt_tpu_torch.data.video_frontend import (  # noqa: F401
    BoxManifest,
    RawVideoDataset,
    decode_clip,
    extract_frames,
    face_box,
)
