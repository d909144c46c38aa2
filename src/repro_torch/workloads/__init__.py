"""End-to-end paper workloads (counterpart of ``repro.workloads``)."""

from repro_torch.workloads.postprocess import (DetectConfig, VOC_CLASSES,
                                               decode_yolo, detect_head,
                                               iou_matrix, nms_fixed,
                                               topk_head)
from repro_torch.workloads.preprocess import (as_server_hook,
                                              center_crop_resize, letterbox,
                                              letterbox_params)
from repro_torch.workloads.workload import (Workload, WorkloadEngine,
                                            checkpoint_params, get, names,
                                            register)

__all__ = [
    "DetectConfig", "VOC_CLASSES", "Workload", "WorkloadEngine",
    "as_server_hook", "center_crop_resize", "checkpoint_params",
    "decode_yolo", "detect_head", "get", "iou_matrix", "letterbox",
    "letterbox_params", "names", "nms_fixed", "register", "topk_head",
]
