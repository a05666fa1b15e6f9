"""``cli/train_vision_baseline.py`` on two gloo ranks (CPU), against the
one-process step on the same global batch.

The ranks run the CLI's ``main`` (``tests/_torch_rank_worker.py vision``,
started by ``parallel.distributed.run_ranks``) on the data tests' corpus:
8 frames at 32x32, ``--batch 4`` a rank (a global batch of 8), one
epoch of one step, one plot path. The one-process CLI runs here with
``--batch 8``. Each run's first step is recorded around
``loss_and_grads``. Checked:

* the ranks' first batches together are the one-process run's first batch
  (the same frames and labels): the loaders' strided shards of one epoch
  order;
* both ranks hold the same loss, accuracy, reduced gradients and BatchNorm
  running statistics, bitwise (every rank takes the same step), and print
  the same epoch line; rank 0 alone writes the plot;
* the ranks' first step against the one-process ``loss_and_grads`` on the
  global batch in the ranks' row order, from the same weights: the loss,
  the accuracy, the whole gradient (the norm of the difference over the
  gradient's norm) and each BatchNorm's running statistics (means in units
  of the running standard deviation, variances relative). The one-process
  step itself moves when only the order of the batch's rows changes (Flax's
  fast variance E[x²] − E[x]² in float32, through ResNet-50's 53
  BatchNorms at random init: the whole gradient by 1-2 %, measured), so
  the mesh's errors are held to 3x the larger of two such controls, the
  reversed order and the one-process CLI's own order, with floors; a
  gradient left unsummed over the ranks (half of it) or local BatchNorm
  statistics fail by far more.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

from _torch_data import write_corpus
from _torch_rank_worker import recording_first_step
from multimodal_moe_torch.cli import train_vision_baseline as cli
from multimodal_moe_torch.models.resnet import resnet50
from multimodal_moe_torch.parallel.distributed import run_ranks

REPO = Path(__file__).resolve().parents[1]
RANKS, LOCAL_B, FRAMES, SEED = 2, 4, 8, 1   # one step a rank
NOISE_FACTOR = 3.0
FLOORS = {"loss": 1e-5, "grads": 1e-5, "mean": 1e-6, "var": 1e-6}


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def cli_args(corpus: dict, batch: int, plot: Path) -> list:
    return ["--parquet", str(corpus["parquet"]), "--split-csv", str(corpus["train"]),
            "--epochs", "1", "--batch", str(batch), "--subset", str(FRAMES), "--img-size", "32",
            "--seed", str(SEED), "--workers", "1", "--plot-path", str(plot)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("vision_mesh")
    corpus = write_corpus(work / "corpus", FRAMES, seed=6)
    (work / "vision_args.json").write_text(json.dumps(cli_args(corpus, LOCAL_B, work / "plot.png")))
    run_ranks([sys.executable, str(REPO / "tests" / "_torch_rank_worker.py"), "vision", str(work)],
              RANKS, env={"MMOE_PLATFORM": "cpu", "OMP_NUM_THREADS": "2"}, timeout=300)
    ranks = [torch.load(work / f"vision_rank{r}.pt", weights_only=False) for r in range(RANKS)]
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("MMOE_PLATFORM", "cpu")
        mp.setattr(cli, "loss_and_grads", cli.loss_and_grads)   # restored after the record
        one = recording_first_step(cli)
        cli.main(cli_args(corpus, LOCAL_B * RANKS, work / "one" / "plot.png"))
    finally:
        mp.undo()
    return {"ranks": ranks, "one": one, "work": work}


def one_process_step(images, labels) -> dict:
    """``loss_and_grads`` on one process from the CLI's initial weights."""
    model = resnet50(num_classes=2, generator=torch.Generator().manual_seed(SEED)).train()
    loss, acc, grads = cli.loss_and_grads(model, images, labels)
    return {"loss": float(loss), "acc": float(acc), "grads": grads,
            "stats": {k: b.clone() for k, b in model.named_buffers()
                      if k.endswith(("running_mean", "running_var"))}}


def errors(got: dict, ref: dict) -> dict:
    flat = lambda g: torch.cat([v.reshape(-1) for v in g.values()])  # noqa: E731
    out = {"loss": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
           "grads": float((flat(got["grads"]) - flat(ref["grads"])).norm()
                          / flat(ref["grads"]).norm()),
           "mean": 0.0, "var": 0.0}
    for k, s in ref["stats"].items():
        if k.endswith("running_mean"):
            sd = (ref["stats"][k[:-len("mean")] + "var"] + 1e-5).sqrt()
            out["mean"] = max(out["mean"], float(((got["stats"][k] - s).abs() / sd).max()))
        else:
            out["var"] = max(out["var"], float(((got["stats"][k] - s).abs() / (s + 1e-5)).max()))
    return out


def rows(images, labels) -> list:
    return sorted((bytes(im.numpy().tobytes()), int(lb)) for im, lb in zip(images, labels))


def test_ranks_form_the_one_process_global_batch(runs):
    ranks, one = runs["ranks"], runs["one"]
    assert [r["mesh"] for r in ranks] == [(RANKS, 1)] * RANKS and one["mesh"] is None
    assert all(r["images"].shape[0] == LOCAL_B for r in ranks)
    images = torch.cat([r["images"] for r in ranks])
    labels = torch.cat([r["labels"] for r in ranks])
    assert rows(images, labels) == rows(one["images"], one["labels"])


def test_ranks_take_the_same_step(runs):
    r0, r1 = runs["ranks"]
    assert r0["loss"] == r1["loss"] and r0["acc"] == r1["acc"]
    for name in ("grads", "stats"):
        assert r0[name].keys() == r1[name].keys()
        assert all(torch.equal(r0[name][k], r1[name][k]) for k in r0[name])
    epoch = [[line for line in r["stdout"].splitlines() if line.startswith("epoch ")]
             for r in (r0, r1)]
    assert epoch[0] == epoch[1] and len(epoch[0]) == 1
    assert "plot" not in r1["stdout"]
    assert ("Saved plot ->" in r0["stdout"]) == (runs["work"] / "plot.png").exists()


def test_first_step_matches_one_process_step(runs):
    ranks, one = runs["ranks"], runs["one"]
    images = torch.cat([r["images"] for r in ranks])
    labels = torch.cat([r["labels"] for r in ranks])
    ref = one_process_step(images, labels)
    flipped = one_process_step(images.flip(0), labels.flip(0))
    assert ranks[0]["acc"] == ref["acc"] == one["acc"]
    noise = {k: max(errors(flipped, ref)[k], errors(one, ref)[k]) for k in FLOORS}
    got = errors(ranks[0], ref)
    for k, floor in FLOORS.items():
        assert got[k] <= max(NOISE_FACTOR * noise[k], floor), (k, got, noise)
