"""End-to-end paper workloads (counterpart of ``repro.workloads``)."""

from repro_torch.workloads.postprocess import (DetectConfig, VOC_CLASSES,
                                               decode_yolo, detect_head,
                                               detections_to_dicts,
                                               iou_matrix, nms_fixed,
                                               topk_head)
from repro_torch.workloads.preprocess import (as_server_hook,
                                              center_crop_resize, letterbox,
                                              letterbox_boxes,
                                              letterbox_params,
                                              unletterbox_boxes)
from repro_torch.workloads.workload import (Workload, WorkloadEngine,
                                            checkpoint_params, get, names,
                                            register)

__all__ = [
    "DetectConfig", "VOC_CLASSES", "Workload", "WorkloadEngine",
    "as_server_hook", "center_crop_resize", "checkpoint_params",
    "decode_yolo", "detect_head", "detections_to_dicts", "get",
    "iou_matrix", "letterbox", "letterbox_boxes", "letterbox_params",
    "names", "nms_fixed", "register", "topk_head", "unletterbox_boxes",
]
