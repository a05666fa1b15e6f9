"""``cli/analyze_moe_routing.py`` against ``scripts/analyze_moe_routing.py``
on the CPU, on the same weights and frames.

A JAX run dir of MoE-YOLO-n (4 experts), written by the JAX package's
``CheckpointManager`` from numpy weights (no init compile): the EMA
parameters with the routers and context biases spread (tests/test_torch_moe_yolo.py's
``_spread_routers``: every token's top-2 well defined, so the two
frameworks route alike), the live parameters half of them (so reading the
wrong set shows). ``tools/orbax_to_torch.py`` converts it. JAX's script
runs in process (``main`` with its ``DetectionTrainer.init_state`` giving
the written trees in place of a jitted init: ``restore`` replaces every
leaf), the port's CLI through ``main(argv)``, both over the data tests'
synthetic corpus at 64×128 (14 frames, every solar label twice and an
unknown one) with ``--per-context 2``. The two ``routing_by_context.json``
have the same keys, bins and layout, their numbers within 1e-6 (a load
is a share of a level's tokens: one token routed otherwise moves it by at
least 1/256, the P3 tokens of two frames), and the reports the same
lines.
"""

import importlib.util
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_data import write_corpus
from _torch_parity import numpy_variables
from multimodal_moe_torch.cli import analyze_moe_routing as cli
from multimodal_moe_tpu.models.moe_yolo import MoEYoloDetector as JaxMoEYolo
from multimodal_moe_tpu.train import detection as jdetection
from multimodal_moe_tpu.train.state import CheckpointManager as JaxCheckpointManager
from multimodal_moe_tpu.train.state import TrainState, make_optimizer
from test_torch_moe_yolo import _spread_routers
from test_torch_orbax_convert import load_tool

REPO = Path(__file__).resolve().parents[1]
H, W = 64, 128
CFG = {"family": "moe", "variant": "n", "num_experts": 4}
PER_CONTEXT = 2
STEP = 5


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def jax_script():
    """``scripts/analyze_moe_routing.py`` as a module."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        spec = importlib.util.spec_from_file_location("jax_analyze_moe_routing",
                                                      REPO / "scripts" / "analyze_moe_routing.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        sys.path.remove(str(REPO / "scripts"))


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("routing")
    corpus = write_corpus(root / "corpus", 14, seed=4)
    variables = numpy_variables(JaxMoEYolo(variant="n", num_experts=4, dispatch="dense"),
                                jnp.zeros((1, H, W, 3)), train=False, seed=6)
    ema = _spread_routers(variables, seed=7)["params"]
    params = jax.tree.map(lambda a: np.asarray(a) * np.float32(0.5), ema)
    stats = variables["batch_stats"]
    jrun = root / "jax" / "run"
    jrun.mkdir(parents=True)
    (jrun / "model_config.json").write_text(json.dumps(CFG))
    opt_state = optax.tree_utils.tree_set(make_optimizer().init(params),
                                          count=jnp.asarray(STEP, jnp.int32))
    JaxCheckpointManager(jrun / "weights").save("best", TrainState(
        step=jnp.asarray(STEP, jnp.int32), params=params, batch_stats=stats,
        opt_state=opt_state, ema_params=ema))
    prun = root / "port" / "run"
    load_tool().convert_run(jrun, prun)

    common = ["--parquet", str(corpus["parquet"]), "--splits-dir", str(corpus["root"]),
              "--split", "train", "--img-h", str(H), "--img-w", str(W),
              "--per-context", str(PER_CONTEXT)]
    template = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                          opt_state=opt_state, ema_params=params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMOE_XLA_CACHE", "")
        mp.delenv("MMOE_PLATFORM", raising=False)
        script = jax_script()
        mp.setattr(jdetection.DetectionTrainer, "init_state", lambda self, rng=None: template)
        mp.setattr(sys, "argv", ["analyze_moe_routing.py", "--weights", str(jrun), *common,
                                 "--out-dir", str(root / "jax_out")])
        script.main()
        mp.setenv("MMOE_PLATFORM", "cpu")
        cli.main(["--weights", str(prun), *common, "--out-dir", str(root / "port_out")])
    read = lambda d: (json.loads((d / "routing_by_context.json").read_text()),  # noqa: E731
                      (d / "routing_report.md").read_text())
    return {"jax": read(root / "jax_out"), "port": read(root / "port_out"),
            "jrun": jrun, "prun": prun}


def _assert_close(got, want, path="root"):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-6, (path, got, want)
    else:
        assert got == want, path


def test_json_matches_jax(outputs):
    (got, _), (want, _) = outputs["port"], outputs["jax"]
    assert got["run"] == str(outputs["prun"]) and want["run"] == str(outputs["jrun"])
    _assert_close({k: v for k, v in got.items() if k != "run"},
                  {k: v for k, v in want.items() if k != "run"})
    bins = list(want["expert_load_by_context"])
    assert len(bins) == 6 and "day" not in bins   # every real bin and "missing", twice each
    assert len(want["l1_divergence_per_level"]) == 15
    assert len(want["counterfactual_ctx_shift_per_level"]) == 5
    assert any(x > 0 for v in want["counterfactual_ctx_shift_per_level"].values() for x in v)


def test_loads_are_top2_shares_per_level(outputs):
    got, _ = outputs["port"]
    for load in got["expert_load_by_context"].values():
        load = np.asarray(load)
        assert load.shape == (3, 4)
        np.testing.assert_allclose(load.sum(-1), 2.0, rtol=1e-6)


def test_report_has_jax_lines(outputs):
    (_, got), (_, want) = outputs["port"], outputs["jax"]
    assert got.splitlines()[0] == want.splitlines()[0] == "# MoE routing by context — run"
    strip = lambda text: [re.sub(r"[-\d.e]+", "#", line) for line in text.splitlines()]  # noqa
    assert strip(got) == strip(want)
