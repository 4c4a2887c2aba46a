"""Stand-ins for every model input on the ``meta`` device: shapes and
dtypes, no memory (the dry run's contract).

The port of ``repro/launch/specs.py``, whose ``ShapeDtypeStruct``s and
``jax.eval_shape`` allocate nothing.  Here a stand-in is a tensor on
``meta``; :func:`params_shape` builds the family's module through
``models.common.MetaGenerator``, whose init helpers draw nothing, so not
one parameter byte is allocated on the host or the card at any width
(arctic-480b's 1.9 TB of fp32 weights included).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..models.common import MetaGenerator
from ..models.model import ModelApi

META = torch.device("meta")


def batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Training / prefill batch stand-ins.

    [audio]/[vlm] archs get precomputed frame/patch embeddings (stub
    frontend), in the compute dtype.
    """
    b, s = shape.global_batch, shape.seq_len
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32, device=META)}
    if cfg.family == "encdec":
        batch["frames"] = torch.empty((b, s, cfg.d_model), dtype=dt,
                                      device=META)
    if cfg.modality == "vision":
        batch["patches"] = torch.empty((b, cfg.frontend_len, cfg.d_model),
                                       dtype=dt, device=META)
    return batch


def params_shape(api: ModelApi) -> torch.nn.Module:
    """The family's module with every parameter on ``meta``."""
    return api.init(MetaGenerator())


def cache_shape(api: ModelApi, cfg: ArchConfig, shape: ShapeConfig) -> Any:
    """The decode cache of ``shape`` on ``meta``."""
    b = shape.global_batch
    if cfg.family == "encdec":
        return api.init_cache(b, shape.seq_len, device=META,
                              enc_len=cfg.frontend_len)
    return api.init_cache(b, shape.seq_len, device=META)


def decode_inputs(cfg: ArchConfig, shape: ShapeConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens, pos) stand-ins for one decode step."""
    return (torch.empty((shape.global_batch, 1), dtype=torch.int32,
                        device=META),
            torch.empty((), dtype=torch.int32, device=META))

