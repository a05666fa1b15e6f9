"""One rank of the port's multi-process CPU tests (gloo), launched by
``parallel.distributed.run_ranks`` from a module fixture:

    python tests/_torch_rank_worker.py <case> <work dir>

Each case reads its inputs from the work dir (written by the test with
numpy and torch only) and writes ``<case>_rank<r>.pt``; the tests compare
those files with JAX and with the port's one-process step. Torch runs two
intra-op threads a rank. Cases:

* ``cluster`` -- ``maybe_initialize_distributed`` from the ``MMOE_*``
  variables, twice; an all-reduce; ``loader_shard``; the meshes' groups.
* ``moe`` -- ``MoEFFN`` on ``moe_in.pt``'s problem under ``use_mesh``:
  ``sweep``, ``sparse``, ``gmm`` and ``dense`` on 2 × 2 with the experts
  sharded, ``dense`` and ``auto`` on 4 × 1; the loss ``Σ out² / T + aux`` through
  the trainer's rule (each rank differentiates ``L / ranks``, gradients
  summed once by ``reduce_gradients``, expert shards gathered); each
  rank's routing as the expert functions receive it.
* ``train`` -- two ``DetectionTrainer`` steps of YOLO-n on a 2 × 1 mesh
  over ``train_in.pt``'s global batches; RT-DETR on the mesh raising
  ``NotImplementedError``; a 2-rank ``fit`` with an early pause and a
  resume, checkpoints in the one-process layout.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from multimodal_moe_torch.parallel import mesh as pm  # noqa: E402
from multimodal_moe_torch.parallel.distributed import (  # noqa: E402
    loader_shard,
    maybe_initialize_distributed,
)


def case_cluster(work: Path, rank: int, world: int) -> dict:
    again = maybe_initialize_distributed()          # a second call: a no-op
    x = torch.tensor([float(rank + 1)])
    total = pm.all_reduce(x, None)
    meshes = {}
    for nd, ne in ((world, 1), (1, world)):
        m = pm.create_mesh(nd, ne)
        rows = torch.arange(3.0) + 10 * rank
        meshes[f"{nd}x{ne}"] = {
            "coords": (m.d, m.e),
            "data_sum": float(m.all_reduce(torch.tensor([float(rank)]), pm.DATA_AXIS)),
            "expert_gather": m.gather(rows, pm.EXPERT_AXIS).tolist(),
        }
    return {"again": again, "psum": float(total), "shard": loader_shard(), "meshes": meshes}


class _RoutingRecord:
    """Wraps the expert functions of ``models/moe.py``: each call's kept
    (token, expert) pairs over the expert group's tokens, in global expert
    ids, and every ``resolve_dispatch`` answer."""

    def __init__(self, tm, first_expert: int, num_local: int):
        self.tm, self.first, self.num_local = tm, first_expert, num_local
        self.kept, self.resolved = [], []
        self.real = {n: getattr(tm, n) for n in ("sweep_combine", "moe_apply_gmm",
                                                 "moe_apply_sparse", "resolve_dispatch")}

    def _keep(self, idx, mask):
        self.kept.append({"idx": idx.detach().clone(), "mask": mask.detach().clone()})

    def __enter__(self):
        tm, real, first, n = self.tm, self.real, self.first, self.num_local

        def sweep_combine(x, comb, *a, **kw):
            t = comb.shape[0]
            idx = torch.arange(first, first + n).expand(t, n)
            self._keep(idx, comb > 0)
            return real["sweep_combine"](x, comb, *a, **kw)

        def moe_apply_gmm(x, idx, gates, *a, first_expert=0, **kw):
            self._keep(idx, (idx >= first) & (idx < first + n))
            return real["moe_apply_gmm"](x, idx, gates, *a, first_expert=first_expert, **kw)

        def moe_apply_sparse(x, decision, *a, **kw):
            self._keep(decision.expert_idx + first, decision.valid)
            return real["moe_apply_sparse"](x, decision, *a, **kw)

        def resolve_dispatch(mode, t, e):
            out = real["resolve_dispatch"](mode, t, e)
            self.resolved.append((mode, t, out))
            return out

        for name, fn in (("sweep_combine", sweep_combine), ("moe_apply_gmm", moe_apply_gmm),
                         ("moe_apply_sparse", moe_apply_sparse),
                         ("resolve_dispatch", resolve_dispatch)):
            setattr(tm, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.tm, name, fn)


# (case, dispatch, num_data, num_expert)
MOE_CASES = (("sweep", "sweep", 2, 2), ("sparse", "sparse", 2, 2), ("gmm", "gmm", 2, 2),
             ("dense", "dense", 4, 1), ("auto", "auto", 4, 1), ("dense_2x2", "dense", 2, 2))


def case_moe(work: Path, rank: int, world: int) -> dict:
    from multimodal_moe_torch.models import moe as tm

    spec = torch.load(work / "moe_in.pt", weights_only=True)
    tokens, ctx, sd = spec["tokens"], spec["ctx"], spec["state_dict"]
    t, d = tokens.shape
    e = sd["experts_w1"].shape[0]
    meshes = {}
    for _, _, nd, ne in MOE_CASES:   # every rank makes the groups in one order
        if (nd, ne) not in meshes:
            meshes[(nd, ne)] = pm.create_mesh(nd, ne)
    out = {}
    for case, mode, nd, ne in MOE_CASES:
        mesh = meshes[(nd, ne)]
        ffn = tm.MoEFFN(d, e, k=2, dispatch=mode)
        ffn.load_state_dict(sd, strict=True)
        pm.shard_module(ffn, mesh)
        rows = pm.batch_slice(mesh, t)
        local = pm.expert_rows(mesh, e)
        with pm.use_mesh(mesh), _RoutingRecord(tm, local.start, local.stop - local.start) as rec:
            y, aux = ffn(tokens[rows], ctx[rows])
            loss = mesh.all_reduce((y * y).sum()) / t + aux["moe_aux_loss"]
            names, params = zip(*ffn.named_parameters())
            grads = torch.autograd.grad(loss / mesh.size, params)
        grads = pm.gather_params(pm.reduce_gradients(dict(zip(names, grads)), mesh), mesh)
        out[case] = {"out": mesh.gather(y.detach()), "loss": float(loss),
                     "aux": float(aux["moe_aux_loss"]), "load": aux["expert_load"].detach(),
                     "grads": grads, "kept": rec.kept, "resolved": rec.resolved,
                     "group_tokens": (mesh.d * (t // nd), (mesh.d + 1) * (t // nd))}
    return out


def yolo_template(seed: int = 0):
    """YOLO-n, random weights from ``seed`` (the test builds the same)."""
    from multimodal_moe_torch.models.yolo import YoloDetector

    return YoloDetector(num_classes=1, variant="n", generator=torch.Generator().manual_seed(seed))


def fit_template(seed: int = 0):
    """MoE-YOLO-n with 2 experts on ``auto`` (``dense`` at the fit's size),
    random weights from ``seed``."""
    from multimodal_moe_torch.models.moe_yolo import MoEYoloDetector

    return MoEYoloDetector(num_classes=1, variant="n", num_experts=2,
                           generator=torch.Generator().manual_seed(seed))


class ShardLoader:
    """``fit``'s loader contract (``len``, batches of numpy arrays) over
    this process's strided shard of a global dataset, as
    ``DetectionLoader`` shards it (``process_index``/``process_count``)."""

    def __init__(self, data: dict, local_batch: int, rank: int, world: int):
        self.process_index, self.process_count = rank, world
        self.data, self.local_batch = data, local_batch
        self.idx = list(range(len(data["image"])))[rank::world]

    def __len__(self):
        return len(self.idx) // self.local_batch

    def __iter__(self):
        for i in range(len(self)):
            sel = self.idx[i * self.local_batch:(i + 1) * self.local_batch]
            yield {k: v[sel] for k, v in self.data.items()}


def case_train(work: Path, rank: int, world: int) -> dict:
    from multimodal_moe_torch.models.moe_yolo import moe_yolo_loss
    from multimodal_moe_torch.models.rtdetr import RTDETRDetector
    from multimodal_moe_torch.train.detection import DetectionTrainer, DetTrainConfig
    from multimodal_moe_torch.train.state import CheckpointManager, one_process_state_dict

    spec = torch.load(work / "train_in.pt", weights_only=False)
    cpu = torch.device("cpu")
    out = {}

    # Two YOLO-n steps on 2 × 1 over the global batches (each rank its rows).
    mesh = pm.create_mesh(world, 1)
    trainer = DetectionTrainer(yolo_template(), DetTrainConfig(**spec["cfg"]), steps_per_epoch=1,
                               mesh=mesh, device=cpu)
    state = trainer.init_state()
    metrics = []
    for batch in spec["batches"]:
        state, m = trainer.train_step(state, trainer._to_device(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    out["yolo"] = {"state": one_process_state_dict(state, mesh), "metrics": metrics}

    # RT-DETR's batch reductions are not global yet: it refuses the mesh.
    try:
        DetectionTrainer(RTDETRDetector(hidden_dim=32, num_queries=10, num_decoder_layers=1,
                                        backbone_depths=(1, 1, 1, 1)),
                         DetTrainConfig(**spec["cfg"]), mesh=mesh, device=cpu)
        out["rtdetr_raises"] = None
    except NotImplementedError as exc:
        out["rtdetr_raises"] = str(exc)

    # fit on a 1 × 2 mesh (experts sharded): a pause after one epoch, then
    # the resume, each rank feeding its process shard.
    mesh = pm.create_mesh(1, world)
    run_dir = work / "fit_run"
    fit_cfg = DetTrainConfig(**spec["fit_cfg"])
    loader = ShardLoader(spec["fit_data"], spec["fit_local_batch"], rank, world)
    trainer = DetectionTrainer(fit_template(), fit_cfg, loss_fn=moe_yolo_loss, mesh=mesh,
                               device=cpu)
    state, first = trainer.fit(loader, run_dir=run_dir, max_epochs_this_run=1, log_every=1)
    step_after_pause = state.step
    trainer = DetectionTrainer(fit_template(), fit_cfg, loss_fn=moe_yolo_loss, mesh=mesh,
                               device=cpu)
    state, second = trainer.fit(loader, run_dir=run_dir, resume=True, log_every=1)
    replicated = sum(float(p.double().sum()) for k, p in state.model.named_parameters()
                     if not pm.is_expert(k))
    final = one_process_state_dict(state, mesh)

    # A checkpoint without optimizer state (tools/orbax_to_torch.py's form)
    # read on the mesh: each rank gets its expert rows.
    converted = work / "converted"
    if rank == 0:
        (converted / "last").mkdir(parents=True)
        torch.save({"step": final["step"], "model": final["model"],
                    "ema_params": final["ema_params"]}, converted / "last" / "state.pt")
    pm.barrier(mesh)
    CheckpointManager(converted, mesh=mesh).restore_eval("last", state)
    rows = pm.expert_rows(mesh, 2)
    eval_rows_ok = all(torch.equal(p, final["model"][k][rows] if pm.is_expert(k) else
                                   final["model"][k])
                       for k, p in state.model.named_parameters())
    out["fit"] = {"first": {k: v for k, v in first.items() if k != "train_wall_time_s"},
                  "second": {k: v for k, v in second.items() if k != "train_wall_time_s"},
                  "step_after_pause": step_after_pause, "step": state.step,
                  "replicated_checksum": replicated, "state": final,
                  "local_expert_shape": tuple(state.model.moe_level0.experts_w1.shape),
                  "restore_eval_rows": eval_rows_ok}
    return out


CASES = {"cluster": case_cluster, "moe": case_moe, "train": case_train}


def main() -> None:
    case, work = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(2)
    assert maybe_initialize_distributed(device="cpu") is True
    rank, world = loader_shard()
    result = CASES[case](work, rank, world)
    torch.save(result, work / f"{case}_rank{rank}.pt")
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
