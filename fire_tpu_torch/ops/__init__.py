"""Tensor ops of the batched path: image resampling, alignment,
boxes/NMS, anchors, gallery matching and the K1 kernel wrapper."""

from fire_tpu_torch.ops.image import (  # noqa: F401
    bgr_to_rgb,
    rgb_to_bgr,
    normalize_01,
    resize_bilinear,
    letterbox,
    crop_and_resize,
)
from fire_tpu_torch.ops.affine import (  # noqa: F401
    affine_from_3pts,
    invert_affine,
    warp_affine,
    align_faces_160,
)
from fire_tpu_torch.ops.boxes import (  # noqa: F401
    xywh_to_xyxy,
    xyxy_to_xywh,
    iou_matrix,
    nms,
)
from fire_tpu_torch.ops.gallery_match import cosine_topk  # noqa: F401
