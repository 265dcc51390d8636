"""The port's recsys serving slice against the JAX package on the same
inputs: the embedding_bag plain version against JAX's oracle and the
Pallas kernel (interpret mode on the CPU, as tests/test_kernels.py runs
it), bit for bit; make_batch; and the two-tower serving functions with the
JAX params carried across, at the tolerance of tests/test_recsys.py. Every
check runs on the CPU, where each wrapper runs its plain version; the
kernel-vs-plain checks on the card live in tests/test_torch_gpu.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.kernels.embedding_bag.embedding_bag import (
    embedding_bag as jembedding_bag,
)
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jbag_ref
from repro.models import recsys as JRS
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.kernels.embedding_bag.embedding_bag import embedding_bag
from repro_torch.kernels.embedding_bag.ops import bag_lookup
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.launch import serve, train
from repro_torch.models import layers as L
from repro_torch.models import recsys as RS

# (V, D, B, L, mode): tests/test_kernels.py's embedding_bag shapes
BAG_SHAPES = [(10, 8, 4, 1, "sum"), (50, 24, 12, 5, "sum"),
              (50, 24, 12, 5, "mean"), (100, 130, 7, 9, "sum"),
              (30, 256, 3, 4, "mean")]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
RTOL, ATOL = 1e-4, 1e-5      # tests/test_recsys.py's tower tolerance


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bag_inputs(v, d, b, l, jdtype, seed):
    rng = np.random.default_rng(seed)
    table = jnp.asarray(rng.standard_normal((v, d)).astype(np.float32),
                        dtype=jdtype)
    idx = rng.integers(-1, v, (b, l)).astype(np.int32)
    idx[0] = -1                                   # an all-padding bag
    idx[1:, 0] = np.where(rng.random(b - 1) < 0.3, -1, idx[1:, 0])
    return table, idx


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("v,d,b,l,mode", BAG_SHAPES)
def test_embedding_bag_plain_matches_jax_and_pallas(v, d, b, l, mode, dtype):
    jdtype, tdtype = DTYPES[dtype]
    table, idx = _bag_inputs(v, d, b, l, jdtype, seed=v * 100 + b)
    want = np.asarray(jbag_ref(table, jnp.asarray(idx), mode=mode))
    pallas = np.asarray(jembedding_bag(table, jnp.asarray(idx), mode=mode,
                                       block_d=64))
    t_table = _to_torch(table)
    assert t_table.dtype == tdtype
    got = embedding_bag_ref(t_table, torch.from_numpy(idx), mode=mode)
    assert got.dtype == torch.float32 and got.shape == (b, d)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)
    # the wrapper and bag_lookup run the plain version for CPU tensors,
    # and count no launch
    before = embedding_bag.launches
    for out in (embedding_bag(t_table, torch.from_numpy(idx), mode=mode),
                bag_lookup(t_table, torch.from_numpy(idx), mode)):
        assert torch.equal(out, got)
    assert embedding_bag.launches == before


def test_embedding_bag_all_padding_and_bad_mode():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([[-1, -1], [3, -1], [0, 2]], dtype=torch.int32)
    mean = embedding_bag(table, idx, mode="mean")
    assert torch.equal(mean, torch.tensor([[0., 0., 0.], [9., 10., 11.],
                                           [3., 4., 5.]]))
    assert torch.equal(embedding_bag(table, idx, mode="sum")[2],
                       torch.tensor([6., 8., 10.]))
    with pytest.raises(ValueError, match="mode"):
        embedding_bag(table, idx, mode="max")


def test_make_batch_matches_jax():
    for cfg in (ARCHS["two-tower-retrieval"].smoke_config,
                ARCHS["two-tower-retrieval"].config):
        want = JRS.make_batch(cfg, 16, seed=7)
        got = RS.make_batch(cfg, 16, seed=7)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_configs_match_jax():
    jarch, arch = JARCHS["two-tower-retrieval"], get_arch("two-tower-retrieval")
    assert (arch.arch_id, arch.family, arch.source) == \
        (jarch.arch_id, jarch.family, jarch.source)
    for a, b in ((arch.config, jarch.config),
                 (arch.smoke_config, jarch.smoke_config)):
        assert vars(a) == vars(b)
    assert {k: vars(s) for k, s in RECSYS_SHAPES.items()} == \
        {k: vars(s) for k, s in jarch.shapes.items()}
    full = serve.serving_config(arch, full=True)
    assert full.dtype == "bfloat16"
    assert vars(full) == dict(vars(arch.config), dtype="bfloat16")


@pytest.fixture(scope="module", params=sorted(DTYPES))
def carried(request):
    """JAX params at the smoke config (f32 or bf16 tables), a B = 16 batch
    and 64 candidate embeddings, each with its port twin on the CPU."""
    jcfg = dataclasses.replace(JARCHS["two-tower-retrieval"].smoke_config,
                               dtype=request.param)
    cfg = dataclasses.replace(ARCHS["two-tower-retrieval"].smoke_config,
                              dtype=request.param)
    jparams = JRS.init_params(jax.random.PRNGKey(3), jcfg)
    params = RS.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    batch_np = RS.make_batch(cfg, 16, seed=5)
    cand = np.random.default_rng(9).standard_normal(
        (64, cfg.tower_mlp[-1])).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    jbatch["cand_item_emb"] = jnp.asarray(cand)
    batch = serve.request_tensors(batch_np, "cpu")
    batch["cand_item_emb"] = torch.from_numpy(cand)
    return jcfg, jparams, jbatch, cfg, params, batch


def test_params_from_jax_carries_leaves(carried):
    _, jparams, _, cfg, params, _ = carried
    assert params["user_table"].dtype == cfg.table_dtype
    for key in ("user_table", "item_table"):
        np.testing.assert_array_equal(
            params[key].float().numpy(),
            np.asarray(jparams[key].astype(jnp.float32)))
    np.testing.assert_array_equal(params["user_tower"]["l1"]["w"].numpy(),
                                  np.asarray(jparams["user_tower"]["l1"]["w"]))
    bad = dict(jax.tree.map(np.asarray, jparams))
    bad["item_table"] = bad["item_table"][:-1]
    with pytest.raises(ValueError, match="do not fit"):
        RS.params_from_jax(bad, cfg, "cpu")


def test_tower_bags_bit_equal_to_jax(carried):
    jcfg, jparams, jbatch, cfg, params, batch = carried
    for table, ids, fields in (("user_table", "user_ids", cfg.user_fields),
                               ("item_table", "item_ids", cfg.item_fields)):
        flat = jbatch[ids].reshape(16 * fields, -1)
        want = np.asarray(jbag_ref(jparams[table], flat, mode="mean"))
        pallas = np.asarray(jembedding_bag(jparams[table], flat, mode="mean"))
        got = bag_lookup(params[table], batch[ids].reshape(16 * fields, -1),
                         "mean").numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_serving_functions_match_jax(carried, use_kernel):
    """user_embed, item_embed, serve_score and score_candidates against JAX
    with its jnp bag (use_kernel False) and its Pallas bag (True)."""
    jcfg, jparams, jbatch, cfg, params, batch = carried
    ju = JRS.user_embed(jparams, jbatch, jcfg, use_kernel=use_kernel)
    jv = JRS.item_embed(jparams, jbatch, jcfg, use_kernel=use_kernel)
    want = {
        "user_embed": ju, "item_embed": jv,
        "serve_score": jnp.sum(ju * jv, axis=-1) / jcfg.temperature,
        "score_candidates": ju @ jbatch["cand_item_emb"].T / jcfg.temperature,
    }
    if not use_kernel:      # JAX's own serving functions take the jnp bag
        np.testing.assert_array_equal(
            np.asarray(JRS.serve_score(jparams, jbatch, jcfg)),
            np.asarray(want["serve_score"]))
        np.testing.assert_array_equal(
            np.asarray(JRS.score_candidates(jparams, jbatch, jcfg)),
            np.asarray(want["score_candidates"]))
    got = {name: getattr(RS, name)(params, batch, cfg) for name in want}
    assert got["serve_score"].shape == (16,)
    assert got["score_candidates"].shape == (16, 64)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
        # the port's plain bag path (the card's reference) gives the same
        again = getattr(RS, name)(params, batch, cfg, use_kernel=False)
        assert torch.equal(again, got[name]), name


def test_init_params_shapes_and_chunked_tables(monkeypatch):
    monkeypatch.setattr(RS, "_INIT_CHUNK_ROWS", 1000)   # 5 chunks of rows
    for dtype in sorted(DTYPES):
        cfg = dataclasses.replace(ARCHS["two-tower-retrieval"].smoke_config,
                                  dtype=dtype)
        gen = torch.Generator().manual_seed(0)
        params = RS.init_params(cfg, generator=gen, device="cpu")
        specs = {k: (tuple(t.shape), t.dtype) for k, t in L.leaves(params)}
        assert specs == RS.param_specs(cfg)
        table = params["user_table"].float()
        assert torch.isfinite(table).all()
        assert 0.008 < float(table.std()) < 0.012
        assert not torch.equal(table[:1000], table[1000:2000])
        again = RS.init_params(cfg, generator=torch.Generator().manual_seed(0),
                               device="cpu")
        assert torch.equal(again["item_table"], params["item_table"])


def test_serve_cli_on_cpu(capsys):
    assert serve.main(["--arch", "two-tower-retrieval", "--device", "cpu",
                       "--requests", "3", "--slots", "5"]) == 0
    out = capsys.readouterr().out
    assert "scored 15 (user,item) pairs" in out


def test_no_device_means_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ARCHS["two-tower-retrieval"].smoke_config
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RS.init_params(cfg, generator=torch.Generator(), device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "two-tower-retrieval", "--requests", "1"])


def test_unported_archs_and_training_raise(monkeypatch, tmp_path):
    """Nothing is left unported: the registry holds all ten of the JAX
    package's archs, and a GNN arch trains (A18.5); the MoE LMs serve."""
    assert sorted(ARCHS) == sorted(JARCHS)
    for arch_id in JARCHS:
        assert get_arch(arch_id).family == JARCHS[arch_id].family
    assert train.main(["--arch", "pna", "--device", "cpu", "--steps", "2",
                       "--ckpt-interval", "100", "--ckpt-dir",
                       str(tmp_path)]) == 0
    # the MoE LMs serve; llama4's full CONFIG does not fit one 80 GB card
    # (the device's memory stands at 80 GB, so nothing is allocated)
    assert serve.main(["--arch", "moonshot-v1-16b-a3b", "--device", "cpu",
                       "--requests", "2", "--gen", "2"]) == 0
    serve.check_fits(ARCHS["moonshot-v1-16b-a3b"].config, 80 * 10 ** 9)
    monkeypatch.setattr(serve, "device_bytes", lambda device: 80 * 10 ** 9)
    with pytest.raises(ValueError, match="203.5 GB"):
        serve.main(["--arch", "llama4-scout-17b-a16e", "--full",
                    "--device", "cpu"])
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")
