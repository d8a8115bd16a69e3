"""Abstract stand-ins and shardings for every dry-run cell: the port of
``repro.launch.specs``.

``input_specs(cfg, shape_name)`` returns the abstract batch for the
cell's step function; ``abstract_params`` / ``abstract_train_state``
and ``decode_specs``' cache build the weight / optimizer / cache
stand-ins.  Nothing here allocates memory: every stand-in is a tensor
on the ``meta`` device, with the shape and dtype the reference's
``jax.ShapeDtypeStruct`` / ``jax.eval_shape`` give, which is what lets
140B-parameter cells be laid out on a host.  Placements are
``parallel.sharding.NamedSharding`` s (a mesh and a ``P``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs import SHAPES
from repro_torch.models import init_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM
from repro_torch.parallel.sharding import NamedSharding, P
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.steps import TrainState

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A stand-in of ``shape`` and ``dtype`` (``jax.ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict:
    """Abstract batch for one (arch x shape) cell."""
    seq, gbatch, kind = SHAPES[shape_name]
    if kind == "decode":
        return decode_specs(cfg, shape_name)
    batch: Dict = {}
    if cfg.input_kind == "embeds":
        batch["embeds"] = sds((gbatch, seq, cfg.d_model), torch.bfloat16)
    else:
        batch["tokens"] = sds((gbatch, seq), torch.int32)
    batch["labels"] = sds((gbatch, seq), torch.int32)
    if cfg.family == "vlm":
        batch["mrope_positions"] = sds((3, gbatch, seq), torch.int32)
    return batch


def decode_specs(cfg: ModelConfig, shape_name: str) -> Dict:
    seq, gbatch, _ = SHAPES[shape_name]
    if cfg.input_kind == "embeds":
        tokens = sds((gbatch, 1, cfg.d_model), torch.bfloat16)
    else:
        tokens = sds((gbatch, 1), torch.int32)
    cache = init_cache(cfg, gbatch, seq, device=META)
    return {"tokens": tokens, "cache": cache,
            "pos": sds((), torch.int32)}


def _dp_size(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        n *= mesh.shape.get(a, 1)
    return n


def batch_shardings(mesh, batch: Dict) -> Dict:
    """Placements of a batch dict's tensors: the leading batch dim over
    ('pod', 'data'); the mrope positions' batch dim is axis 1."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.shape)

    def shard(name, leaf):
        if name == "mrope_positions":
            return NamedSharding(mesh, P(None, dp, None))
        if leaf.ndim >= 1 and leaf.shape[0] % _dp_size(mesh) == 0 \
                and leaf.shape[0] > 1:
            return NamedSharding(mesh, P(dp) if leaf.ndim == 1
                                 else P(dp, *([None] * (leaf.ndim - 1))))
        return NamedSharding(mesh, P())

    return {k: shard(k, v) for k, v in batch.items()}


def cache_shardings(mesh, cfg: ModelConfig, cache) -> Dict:
    """KV caches: batch dim over dp; prefer sharding KV heads over
    'model' when divisible, else shard the sequence dim (context
    parallelism for the cache)."""
    tp = mesh.shape.get("model", 1)
    dp = tuple(a for a in ("pod", "data") if a in mesh.shape)

    def shard(name, leaf):
        if name in ("k", "v"):                 # (L, B, S, KV, hd)
            _, B, S, KV, _ = leaf.shape
            spec = [None, dp if B % _dp_size(mesh) == 0 else None,
                    None, None, None]
            if KV % tp == 0:
                spec[3] = "model"
            elif S % tp == 0:
                spec[2] = "model"
            return NamedSharding(mesh, P(*spec))
        if name == "pos_ids":                  # (L, S)
            return NamedSharding(mesh, P())
        # recurrent states: (L|L/2, B, ...) -- shard batch, then the
        # widest state dim over model if divisible
        spec = [None] * leaf.ndim
        if leaf.ndim >= 2 and leaf.shape[1] % _dp_size(mesh) == 0:
            spec[1] = dp
        if leaf.ndim >= 3 and leaf.shape[2] % tp == 0:
            spec[2] = "model"
        return NamedSharding(mesh, P(*spec))

    return {k: shard(k, v) for k, v in cache.items()}


def abstract_params(cfg: ModelConfig) -> LM:
    """The model with every master and compute copy on ``meta``."""
    return LM(cfg, META).cast_()


def abstract_train_state(cfg: ModelConfig, bits8: bool = False
                         ) -> TrainState:
    params = abstract_params(cfg)
    return TrainState(params, adamw_init(params, bits8=bits8), None)
