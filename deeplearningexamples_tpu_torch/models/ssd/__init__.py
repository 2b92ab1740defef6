"""SSD300: the model, its boxes, the MultiBox task and COCO mAP.

Port of ``deeplearningexamples_tpu/models/ssd/__init__.py``, with the same
names."""

from .boxes import DefaultBoxes, dboxes300_coco, decode_batch, encode, nms_single
from .model import SSD300, SSDResNetBackbone
from .task import SSDTask, multibox_loss

__all__ = ["DefaultBoxes", "SSD300", "SSDResNetBackbone", "SSDTask",
           "dboxes300_coco", "decode_batch", "encode", "multibox_loss",
           "nms_single"]
