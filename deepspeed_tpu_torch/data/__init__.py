"""Data pipeline (port of ``deepspeed_tpu/data``; ref:
deepspeed/runtime/dataloader.py, data_pipeline/)."""

from deepspeed_tpu_torch.data.loader import DataLoader, RepeatingLoader
from deepspeed_tpu_torch.data.packing import PackedDataLoader, pack_documents

__all__ = ["DataLoader", "RepeatingLoader", "PackedDataLoader",
           "pack_documents"]
