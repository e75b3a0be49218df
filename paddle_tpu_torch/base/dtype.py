"""Name -> ``torch.dtype`` map (counterpart of ``paddle_tpu/base/dtype.py``,
limited to the types the serving slice uses)."""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["to_torch_dtype"]

_BY_NAME = {
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "fp16": torch.float16, "half": torch.float16,
    "float32": torch.float32, "fp32": torch.float32, "float": torch.float32,
    "float64": torch.float64, "fp64": torch.float64, "double": torch.float64,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}


def to_torch_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _BY_NAME[str(dtype).lower()]
    except KeyError:
        raise ValueError(
            f"unsupported dtype {dtype!r}; expected one of "
            f"{sorted(_BY_NAME)}") from None
