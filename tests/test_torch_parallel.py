"""``multimodal_moe_torch.parallel`` against ``multimodal_moe_tpu.parallel``
(CPU).

* ``create_mesh``: the same shapes and the same ``ValueError``s as JAX's
  over worlds of 1 to 8.
* ``batch_slice``: rank ``r``'s rows equal the rows JAX's
  ``batch_sharding`` puts on mesh device ``(d, e)`` with ``r = d·n_e + e``
  (``addressable_shards`` on the 8-device CPU mesh of ``conftest.py``),
  for 8×1, 4×2 and 2×4.
* ``shard_params`` / ``gather_params``' layout: each rank's expert rows
  equal JAX's ``shard_params`` shard on its device; other tensors whole.
* ``prefetch_to_device(mesh=)``: a single-process loader's global batch
  gives each rank its ``batch_slice`` rows; a loader of the mesh's
  processes passes through when its index is the rank and raises
  otherwise. ``ResidentDetectionLoader(mesh=)`` (the ``rgb`` store) holds
  the rank's process shard: its batches equal those of the loader built
  with ``process_index`` / ``process_count``; a disagreeing shard raises.
* ``maybe_initialize_distributed``: two gloo processes form a cluster from
  the ``MMOE_*`` variables (a second call is a no-op), all-reduce,
  ``loader_shard``, and the data and expert groups of 2×1 and 1×2; on a
  single process it is a no-op, and NCCL with more ranks than cards
  raises before any rendezvous.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data import MAX_BOXES, H, W, assert_batches_equal, to_numpy, write_corpus
from _torch_parity import load_flax
from multimodal_moe_torch.data import pipeline as tpipe
from multimodal_moe_torch.data import resident as tres
from multimodal_moe_torch.models import moe as tm
from multimodal_moe_torch.parallel import distributed as tdist
from multimodal_moe_torch.parallel import mesh as tmesh
from multimodal_moe_tpu.parallel import mesh as jmesh

WORKER = Path(__file__).with_name("_torch_rank_worker.py")
LAYOUTS = ((8, 1), (4, 2), (2, 4))


def _jax_mesh(nd, ne):
    return jmesh.create_mesh(nd, ne, devices=jax.devices()[:nd * ne])


def _raised(fn):
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return None


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("num_data,num_expert", [(None, 1), (None, 2), (None, 3), (None, 4),
                                                 (2, 2), (1, 4), (4, 1), (3, 1)])
def test_create_mesh_matches_jax(n, num_data, num_expert):
    want_err = _raised(lambda: jmesh.create_mesh(num_data, num_expert,
                                                 devices=jax.devices()[:n]))
    got_err = _raised(lambda: tmesh.create_mesh(num_data, num_expert, world_size=n))
    assert got_err == want_err
    if want_err is None:
        want = dict(jmesh.create_mesh(num_data, num_expert, devices=jax.devices()[:n]).shape)
        got = tmesh.create_mesh(num_data, num_expert, world_size=n)
        assert got.shape == want and got.size == n
        assert got.world_group is None   # a layout: no process group of that size here


def _device_coords(mesh):
    """Each device of a JAX mesh → its (d, e)."""
    arr = np.asarray(mesh.devices)
    return {arr[d, e]: (d, e) for d in range(arr.shape[0]) for e in range(arr.shape[1])}


@pytest.mark.parametrize("nd,ne", LAYOUTS)
def test_batch_slice_matches_jax_batch_sharding(nd, ne):
    b = 16
    x = np.arange(b * 3, dtype=np.float32).reshape(b, 3)
    jm = _jax_mesh(nd, ne)
    shards = jax.device_put(jnp.asarray(x), jmesh.batch_sharding(jm)).addressable_shards
    coords = _device_coords(jm)
    assert len(shards) == nd * ne
    for shard in shards:
        d, e = coords[shard.device]
        rank = d * ne + e
        mesh = tmesh.create_mesh(nd, ne, world_size=nd * ne, rank=rank)
        assert (mesh.d, mesh.e) == (d, e)
        np.testing.assert_array_equal(x[tmesh.batch_slice(mesh, b)], np.asarray(shard.data))
    with pytest.raises(ValueError):
        tmesh.batch_slice(tmesh.create_mesh(nd, ne, world_size=nd * ne), 12 if nd * ne == 8
                          else 7)


@pytest.mark.parametrize("nd,ne", LAYOUTS)
def test_shard_params_matches_jax(nd, ne):
    rng = np.random.default_rng(3)
    d, e, h = 16, 8, 32
    params = {"router": {"router_kernel": rng.normal(size=(d, e)).astype(np.float32),
                         "context_bias": rng.normal(size=(6, e)).astype(np.float32)},
              "experts_w1": rng.normal(size=(e, d, h)).astype(np.float32),
              "experts_b1": rng.normal(size=(e, 1, h)).astype(np.float32),
              "experts_w2": rng.normal(size=(e, h, d)).astype(np.float32),
              "experts_b2": rng.normal(size=(e, 1, d)).astype(np.float32)}
    sd = load_flax(tm.MoEFFN(d, e), {"params": params}).state_dict()
    jm = _jax_mesh(nd, ne)
    placed = jmesh.shard_params(jax.tree.map(jnp.asarray, params), jm)
    coords = _device_coords(jm)
    leaves = {"router.router_kernel": placed["router"]["router_kernel"],
              "router.context_bias": placed["router"]["context_bias"],
              **{k: v for k, v in placed.items() if k.startswith("experts")}}
    for rank in range(nd * ne):
        mesh = tmesh.create_mesh(nd, ne, world_size=nd * ne, rank=rank)
        mine = tmesh.shard_params(sd, mesh)
        assert set(mine) == set(leaves)
        for name, arr in leaves.items():
            (shard,) = [s for s in arr.addressable_shards if coords[s.device] == (mesh.d, mesh.e)]
            np.testing.assert_array_equal(mine[name].numpy(), np.asarray(shard.data), err_msg=name)
            assert (tmesh.is_expert(name) and ne > 1) == (mine[name].shape != sd[name].shape)


def test_single_process_is_a_no_op(monkeypatch):
    for name in ("MMOE_COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS", "MMOE_NUM_PROCESSES",
                 "JAX_NUM_PROCESSES", "MMOE_PROCESS_ID", "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert tdist.maybe_initialize_distributed() is False
    assert tdist.loader_shard() == (0, 1)
    mesh = tmesh.create_mesh()
    assert mesh.shape == {"data": 1, "expert": 1} and mesh.rank == 0
    with tmesh.use_mesh(mesh):
        assert tmesh.active_mesh() is None      # 1×1: every function is the one-process one
    with tmesh.use_mesh(tmesh.create_mesh(2, 1, world_size=2)):
        assert tmesh.active_mesh() is not None
    assert tmesh.active_mesh() is None


def test_nccl_refuses_more_ranks_than_cards(monkeypatch):
    args = dict(coordinator_address="127.0.0.1:1", num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="nccl backend runs ranks on the card"):
        tdist.maybe_initialize_distributed(backend="nccl", device="cpu", **args)
    # a host with one card: two NCCL ranks raise before any rendezvous
    monkeypatch.setattr(tdist, "rank_device", lambda device=None: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="NCCL takes one rank a card: 2 ranks asked for"):
        tdist.maybe_initialize_distributed(**args)     # the card's default backend is nccl


def test_two_process_cluster(tmp_path):
    tdist.run_ranks([sys.executable, str(WORKER), "cluster", str(tmp_path)], 2,
                    env={"OMP_NUM_THREADS": "2"}, timeout=300)
    got = [torch.load(tmp_path / f"cluster_rank{r}.pt", weights_only=False) for r in range(2)]
    for rank, g in enumerate(got):
        assert g["again"] is True
        assert g["psum"] == 3.0
        assert g["shard"] == (rank, 2)
        # 2×1: one data group of both ranks, expert groups of one.
        assert g["meshes"]["2x1"]["coords"] == (rank, 0)
        assert g["meshes"]["2x1"]["data_sum"] == 1.0
        assert g["meshes"]["2x1"]["expert_gather"] == [10.0 * rank + i for i in range(3)]
        # 1×2: data groups of one, one expert group of both ranks.
        assert g["meshes"]["1x2"]["coords"] == (0, rank)
        assert g["meshes"]["1x2"]["data_sum"] == float(rank)
        assert g["meshes"]["1x2"]["expert_gather"] == [0.0, 1.0, 2.0, 10.0, 11.0, 12.0]


def _host_batch(b=8):
    rng = np.random.default_rng(5)
    return {"image": rng.integers(0, 256, (b, 4, 6, 3)).astype(np.uint8),
            "gt_boxes": rng.normal(size=(b, 3, 4)).astype(np.float32),
            "batch_valid": np.ones(b, bool)}


@pytest.mark.parametrize("nd,ne", LAYOUTS)
def test_prefetch_to_device_takes_the_rank_rows(nd, ne):
    batch = _host_batch()
    for rank in range(nd * ne):
        mesh = tmesh.create_mesh(nd, ne, world_size=nd * ne, rank=rank)
        (got,) = tpipe.prefetch_to_device(iter([batch]), device="cpu", mesh=mesh)
        rows = tmesh.batch_slice(mesh, 8)
        for k, v in batch.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v[rows], err_msg=k)
        # a loader of the mesh's processes already yields the rank's rows
        (same,) = tpipe.prefetch_to_device(iter([batch]), device="cpu", mesh=mesh,
                                           shard=(rank, nd * ne))
        np.testing.assert_array_equal(same["image"].numpy(), batch["image"])
        with pytest.raises(ValueError, match="a loader of process"):
            list(tpipe.prefetch_to_device(iter([batch]), device="cpu", mesh=mesh,
                                          shard=((rank + 1) % (nd * ne), nd * ne)))


def test_resident_loader_on_a_mesh_holds_the_rank_shard(tmp_path):
    corpus = write_corpus(tmp_path, 10, seed=6)
    ds = tpipe.ZODMoEVisionDataset(tpipe.ZODMoEDataConfig(
        frames_parquet=str(corpus["parquet"]), split_csv=str(corpus["train"]), img_h=H,
        img_w=W, max_boxes=MAX_BOXES))
    kw = dict(batch_size=2, shuffle=True, seed=3, store="rgb", num_workers=1, device="cpu")
    for rank in range(2):
        mesh = tmesh.create_mesh(2, 1, world_size=2, rank=rank)
        on_mesh = tres.ResidentDetectionLoader(ds, mesh=mesh, **kw)
        assert (on_mesh.process_index, on_mesh.process_count) == (rank, 2)
        plain = tres.ResidentDetectionLoader(ds, process_index=rank, process_count=2, **kw)
        got, want = [to_numpy(b) for b in on_mesh], [to_numpy(b) for b in plain]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert_batches_equal(g, w)
        with pytest.raises(ValueError, match="on rank"):
            tres.ResidentDetectionLoader(ds, mesh=mesh, process_index=1 - rank,
                                         process_count=2, **kw)
