"""Two-tower retrieval [Yi et al., RecSys'19]: the serving path of
``repro.models.recsys`` in PyTorch.

Each tower mean-pools its multi-hot id fields through ``bag_lookup`` (the
``embedding_bag`` CUDA kernel on the card), runs an f32 ReLU MLP and
L2-normalises; ``serve_score`` dots a user with an item, and
``score_candidates`` one user with a precomputed corpus of item
embeddings. Params are a dict laid out as the JAX package's pytree
(``params_from_jax`` carries one across). Training (``loss_fn`` and the
bag's backward) comes with the recsys training slice, ROADMAP A18.2.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.state import resolve_device
from repro_torch.kernels.embedding_bag.ops import bag_lookup
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.models import layers as L

# rows of a table drawn per step of init_params: at the full vocabulary an
# f32 copy of a whole table (51.5 GB) does not fit beside the other table
_INIT_CHUNK_ROWS = 1 << 20


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_mlp: tuple = (1024, 512, 256)
    user_vocab: int = 50_331_648   # ≈50M, multiple of 512 (even row shards)
    item_vocab: int = 50_331_648
    user_fields: int = 8     # multi-hot categorical fields per user
    item_fields: int = 4
    field_slots: int = 8     # ids per field (bag size, -1 padded)
    temperature: float = 0.05
    dtype: str = "float32"

    @property
    def table_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def _table(generator, vocab: int, d: int, dtype, dev) -> torch.Tensor:
    """N(0, 0.01²) rows, drawn in f32 a chunk of rows at a time and stored
    straight in ``dtype``."""
    table = torch.empty((vocab, d), dtype=dtype, device=dev)
    for r in range(0, vocab, _INIT_CHUNK_ROWS):
        n = min(_INIT_CHUNK_ROWS, vocab - r)
        rows = torch.randn((n, d), generator=generator, device=dev)
        table[r:r + n].copy_(rows * 0.01)
    return table


def init_params(cfg: TwoTowerConfig, *, generator: torch.Generator,
                device=None) -> dict:
    """Random params on ``device`` (None: the CUDA card) from ``generator``,
    which must live on that device. Tables in ``cfg.dtype``, towers f32."""
    dev = resolve_device(device)
    d = cfg.embed_dim
    return {
        "user_table": _table(generator, cfg.user_vocab, d, cfg.table_dtype, dev),
        "item_table": _table(generator, cfg.item_vocab, d, cfg.table_dtype, dev),
        "user_tower": L.mlp_init(generator, [cfg.user_fields * d, *cfg.tower_mlp],
                                 device=dev),
        "item_tower": L.mlp_init(generator, [cfg.item_fields * d, *cfg.tower_mlp],
                                 device=dev),
    }


def param_specs(cfg: TwoTowerConfig) -> dict:
    """{leaf path: (shape, dtype)} of the params ``init_params`` makes."""
    d = cfg.embed_dim
    specs = {"user_table": ((cfg.user_vocab, d), cfg.table_dtype),
             "item_table": ((cfg.item_vocab, d), cfg.table_dtype)}
    for tower, fields in (("user_tower", cfg.user_fields),
                          ("item_tower", cfg.item_fields)):
        dims = [fields * d, *cfg.tower_mlp]
        for i in range(len(dims) - 1):
            specs[f"{tower}/l{i}/w"] = ((dims[i], dims[i + 1]), torch.float32)
    return specs


def params_from_jax(np_params: dict, cfg: TwoTowerConfig, device) -> dict:
    """The port's params from a JAX ``init_params`` pytree with numpy
    leaves (bf16 tables included). Weights keep the JAX layout
    (d_in, d_out), so nothing is transposed."""
    return L.params_from_numpy(np_params, param_specs(cfg), cfg.name,
                               resolve_device(device))


def _tower(table, tower_p, ids, n_fields: int, use_kernel: bool):
    """ids (B, F, S) multi-hot → (B, out) L2-normalised tower embedding.
    ``use_kernel=False`` takes the plain bag on any device (the reference
    the card's kernel path is checked against)."""
    b = ids.shape[0]
    flat = ids.reshape(b * n_fields, -1)
    if use_kernel:
        bags = bag_lookup(table, flat, "mean")               # (B*F, d)
    else:
        bags = embedding_bag_ref(table, flat, mode="mean")
    x = bags.reshape(b, -1)                                  # (B, F*d)
    x = L.mlp_apply(tower_p, x, act=torch.relu)
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=1e-6)


def user_embed(params, batch, cfg: TwoTowerConfig, use_kernel=True):
    return _tower(params["user_table"], params["user_tower"],
                  batch["user_ids"], cfg.user_fields, use_kernel)


def item_embed(params, batch, cfg: TwoTowerConfig, use_kernel=True):
    return _tower(params["item_table"], params["item_tower"],
                  batch["item_ids"], cfg.item_fields, use_kernel)


def loss_fn(params, batch, cfg: TwoTowerConfig):
    raise NotImplementedError(
        "the two-tower training loss (in-batch sampled softmax with logQ "
        "correction) comes with the recsys training slice, ROADMAP A18.2")


def score_candidates(params, batch, cfg: TwoTowerConfig, use_kernel=True):
    """Retrieval scoring: one/many queries × many candidate items.

    batch: user_ids (B, F, S), cand_item_emb (Nc, d) [precomputed corpus
    embeddings, the standard serving layout]. → (B, Nc) scores."""
    u = user_embed(params, batch, cfg, use_kernel)
    return u @ batch["cand_item_emb"].T / cfg.temperature


def serve_score(params, batch, cfg: TwoTowerConfig, use_kernel=True):
    """Online inference: score B (user, item) pairs."""
    u = user_embed(params, batch, cfg, use_kernel)
    v = item_embed(params, batch, cfg, use_kernel)
    return torch.sum(u * v, dim=-1) / cfg.temperature


def make_batch(cfg: TwoTowerConfig, batch: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "user_ids": rng.integers(
            -1, cfg.user_vocab, (batch, cfg.user_fields, cfg.field_slots)
        ).astype(np.int32),
        "item_ids": rng.integers(
            -1, cfg.item_vocab, (batch, cfg.item_fields, cfg.field_slots)
        ).astype(np.int32),
        "log_q": rng.standard_normal(batch).astype(np.float32) * 0.1,
    }
