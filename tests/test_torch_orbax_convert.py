"""``tools/orbax_to_torch.py`` (CPU): run dirs written by the JAX package's
own ``CheckpointManager`` (Orbax) — YOLO-n, MoE-YOLO-n and an RT-DETR of
hidden 64, 20 queries and 2 decoder layers (trunk depths (1, 1, 1, 1), as
in every RT-DETR parity test: ``small_rtdetr_trunk``) — converted and
loaded by the port.

Weights are made with numpy at the shapes of the Flax init (no init
compile); ``ema_params`` and ``batch_stats`` lie away from ``params`` and
from an init, so the EMA choice and the running statistics are both
seen. The port's ``load_detector(device="cpu", use_ema=...)`` forward is
held to JAX's ``load_detector`` + ``apply`` within the detector
tolerances: YOLO-family logits within 1e-4 and boxes within 5e-3 px
(tests/test_torch_yolo.py), RT-DETR's within ``_torch_parity``'s after
its query selection is shown well defined. JAX's ``load_detector`` runs
with ``DetectionTrainer.init_state`` giving the written variables in place
of a jitted init: ``restore_eval`` replaces every leaf it reads, and the
init would only cost its compile.

Also: ``best`` and ``last`` with their steps and the ``int8_quant*.npz``
files carried over unchanged, an unknown or a missing leaf raising, and the
port's ``CheckpointManager.restore`` refusing the converted checkpoint
(no optimizer state) while ``restore_eval`` reads it."""

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (RTDETR_BOX_TOL, RTDETR_LOGIT_TOL, RTDETR_PIXEL_TOL,
                           assert_rtdetr_selection_well_defined, numpy_variables,
                           rtdetr_numpy_variables)
from multimodal_moe_torch import loading as tload
from multimodal_moe_torch.models.rtdetr import anchors_for
from multimodal_moe_torch.train.detection import DetectionTrainer, DetTrainConfig
from multimodal_moe_torch.train.state import CheckpointManager
from multimodal_moe_tpu import loading as jload
from multimodal_moe_tpu.train import detection as jdetection
from multimodal_moe_tpu.train.state import CheckpointManager as JaxCheckpointManager
from multimodal_moe_tpu.train.state import TrainState, make_optimizer
from test_torch_moe_yolo import _spread_routers

REPO = Path(__file__).resolve().parents[1]
H, W = 64, 128
CONFIGS = {
    "yolo": {"family": "yolo", "variant": "n"},
    "moe": {"family": "moe", "variant": "n", "num_experts": 4},
    "rtdetr": {"family": "rtdetr", "hidden_dim": 64, "num_queries": 20,
               "num_decoder_layers": 2},
}
STEPS = {"best": 7, "last": 9}
YOLO_LOGIT_TOL, YOLO_BOX_TOL = 1e-4, 5e-3


def load_tool():
    """``tools/orbax_to_torch.py`` as a module (``tools/`` is no package)."""
    spec = importlib.util.spec_from_file_location("orbax_to_torch", REPO / "tools" / "orbax_to_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: the suite runs several pytest workers side by
    side, and more threads each only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


SMALL_DEPTHS = (1, 1, 1, 1)


@pytest.fixture(autouse=True, scope="module")
def small_rtdetr_trunk():
    """Both packages' ``build_detector`` give RT-DETR the trunk depths
    (1, 1, 1, 1) of every RT-DETR parity test (``model_config.json`` has no
    key for them; the leaf kinds the converter maps are those of r50vd,
    whose layout tests/test_torch_loading.py holds to JAX's)."""
    from multimodal_moe_torch.models.rtdetr import RTDETRDetector as TorchRTDETR

    jax_build, port_build = jload.build_detector, tload.build_detector

    def jax_small(cfg, **kw):
        family, model = jax_build(cfg, **kw)
        return family, model.clone(backbone_depths=SMALL_DEPTHS) if family == "rtdetr" else model

    def port_small(cfg, **kw):
        if cfg.get("family") != "rtdetr" or kw:
            return port_build(cfg, **kw)
        return "rtdetr", TorchRTDETR(num_classes=cfg.get("num_classes", 1),
                                     hidden_dim=cfg["hidden_dim"], num_queries=cfg["num_queries"],
                                     num_decoder_layers=cfg["num_decoder_layers"],
                                     backbone_depths=SMALL_DEPTHS)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jload, "build_detector", jax_small)
        mp.setattr(tload, "build_detector", port_small)
        yield


def jax_variables(cfg: dict, seed: int):
    """Flax variables for ``cfg``'s model made with numpy (norms randomised;
    MoE routers spread so routing is well defined; RT-DETR's sampling
    offsets and class prior as Flax initialises them)."""
    _, jmodel = jload.build_detector(cfg)
    if cfg["family"] == "rtdetr":
        return rtdetr_numpy_variables(jmodel, H, W, seed=seed)
    variables = numpy_variables(jmodel, jnp.zeros((1, H, W, 3)), seed=seed)
    return _spread_routers(variables, seed=seed + 1) if cfg["family"] == "moe" else variables


def perturbed(tree, rng, scale: float):
    """Each leaf plus ``scale`` times its own spread (or ``scale``) of noise."""
    def leaf(a):
        a = np.asarray(a)
        return (a + scale * max(float(a.std()), 1e-2) * rng.normal(size=a.shape)).astype(a.dtype)
    return jax.tree.map(leaf, tree)


def write_jax_run(root: Path, cfg: dict, seed: int = 0, names=("best", "last"),
                  variables=None) -> "tuple[Path, dict]":
    """A JAX run dir: ``model_config.json`` and ``weights/<name>`` for each
    of ``names``, saved by the JAX package's ``CheckpointManager`` with an
    SGD ``opt_state``; ``batch_stats`` perturbed, ``ema_params`` 10 % of
    each leaf's spread away from ``params`` (``last``: ``params`` halved);
    an ``int8_quant_best.npz`` beside them. ``variables`` replaces the
    ones made from ``seed``. Returns the run dir and the variables of
    ``best``."""
    run = root / cfg["family"]
    run.mkdir(parents=True)
    (run / "model_config.json").write_text(json.dumps(cfg))
    variables = jax_variables(cfg, seed) if variables is None else variables
    rng = np.random.default_rng(seed + 50)
    params = variables["params"]
    stats = perturbed(variables["batch_stats"], rng, 0.05)
    opt_state = make_optimizer().init(params)
    ckpt = JaxCheckpointManager(run / "weights")
    for name in names:
        p = params if name == "best" else jax.tree.map(lambda a: np.asarray(a) * 0.5, params)
        ckpt.save(name, TrainState(step=jnp.asarray(STEPS[name], jnp.int32), params=p,
                                   batch_stats=stats, opt_state=opt_state,
                                   ema_params=perturbed(p, rng, 0.1)))
    np.savez(run / "weights" / "int8_quant_best.npz", marker=np.arange(5, dtype=np.int32))
    return run, {"params": params, "batch_stats": stats}


def jax_loaded(run: Path, checkpoint: str, use_ema: bool, template: dict):
    """JAX's ``load_detector``, its ``DetectionTrainer.init_state`` giving
    ``template``'s trees in place of a jitted init (``restore_eval``
    replaces each of them from the checkpoint)."""
    state = TrainState(step=jnp.zeros((), jnp.int32), params=template["params"],
                       batch_stats=template["batch_stats"], opt_state=None,
                       ema_params=template["params"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdetection.DetectionTrainer, "init_state", lambda self, rng=None: state)
        return jload.load_detector(run, checkpoint=checkpoint, img_h=H, img_w=W, use_ema=use_ema)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per family: the JAX run dir (``best`` only but for YOLO-n), its
    conversion, the variables written and the test images."""
    tool = load_tool()
    cache = {}

    def get(family):
        if family not in cache:
            root = tmp_path_factory.mktemp(f"orbax_{family}")
            names = ("best", "last") if family == "yolo" else ("best",)
            jrun, variables = write_jax_run(root / "jax", CONFIGS[family], seed=len(cache) + 3,
                                            names=names)
            written = tool.convert_run(jrun, root / "port" / family)
            images = np.random.default_rng(11).integers(0, 256, (2, H, W, 3), dtype=np.uint8)
            cache[family] = SimpleNamespace(jrun=jrun, prun=root / "port" / family,
                                            written=written, variables=variables, images=images,
                                            apply=jax_apply(family))
        return cache[family]

    return get


def port_outputs(run: Path, checkpoint: str, use_ema: bool, images, ctx=None):
    loaded = tload.load_detector(run, checkpoint=checkpoint, img_h=H, img_w=W,
                                 use_ema=use_ema, device="cpu")
    captured = []
    hook = (loaded.model.enc_score.register_forward_hook(
        lambda m, i, o: captured.append(o.numpy())) if loaded.family == "rtdetr" else None)
    kwargs = {} if ctx is None else {"context_ids": torch.from_numpy(ctx)}
    with torch.inference_mode():
        out = loaded.model(torch.from_numpy(images).float() / 255.0, **kwargs)
    if hook is not None:
        hook.remove()
    out = {k: v.numpy() for k, v in out.items() if isinstance(v, torch.Tensor)}
    return loaded, out, captured[0] if captured else None


def jax_apply(family: str):
    """JAX's jitted apply for ``family`` (RT-DETR: with its encoder scores;
    MoE-YOLO: with context ids), numpy in and out."""
    _, jmodel = jload.build_detector(CONFIGS[family])
    if family == "rtdetr":
        fn = jax.jit(lambda v, x: jmodel.apply(
            v, x, train=False, mutable=["intermediates"],
            capture_intermediates=lambda mdl, _: mdl.name == "enc_score"))

        def apply(variables, x, ctx=None):
            out, state = jax.device_get(fn(variables, x))
            return out, np.asarray(state["intermediates"]["enc_score"]["__call__"][0])
        return apply
    fn = jax.jit(lambda v, x, c: jmodel.apply(
        v, x, train=False, **({} if c is None else {"context_ids": c})))
    return lambda variables, x, ctx=None: (jax.device_get(fn(variables, x, ctx)), None)


@pytest.mark.parametrize("family", list(CONFIGS))
def test_converted_run_gives_jax_outputs(runs, family):
    """With the EMA parameters and without: the port's forward on the
    converted run within the detector tolerances of JAX's on the JAX run,
    and the two weight sets give other outputs."""
    r = runs(family)
    ctx = np.array([1, 4], np.int32) if family == "moe" else None
    key = "pred_logits" if family == "rtdetr" else "cls_logits"
    seen = []
    for use_ema in (True, False):
        jl = jax_loaded(r.jrun, "best", use_ema, r.variables)
        ref, enc = r.apply(jl.variables, jnp.asarray(r.images, jnp.float32) / 255.0, ctx)
        loaded, got, port_enc = port_outputs(r.prun, "best", use_ema, r.images, ctx)
        assert loaded.family == family and loaded.model_cfg == CONFIGS[family]
        if family == "rtdetr":
            assert_rtdetr_selection_well_defined(
                SimpleNamespace(cfg=CONFIGS[family], port_enc=port_enc, jax_enc=enc),
                anchors_for([(H // s, W // s) for s in (8, 16, 32)])[1])
            np.testing.assert_allclose(got["pred_logits"], ref["pred_logits"],
                                       rtol=RTDETR_LOGIT_TOL, atol=RTDETR_LOGIT_TOL)
            np.testing.assert_allclose(got["pred_boxes"], ref["pred_boxes"], rtol=0,
                                       atol=RTDETR_BOX_TOL)
            np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=0, atol=RTDETR_PIXEL_TOL)
        else:
            for k in ("cls_logits", "box_logits"):
                np.testing.assert_allclose(got[k], ref[k], rtol=YOLO_LOGIT_TOL,
                                           atol=YOLO_LOGIT_TOL, err_msg=f"{k} ema={use_ema}")
            np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=0, atol=YOLO_BOX_TOL)
        seen.append(got[key])
    assert np.abs(seen[0] - seen[1]).max() > 100 * YOLO_LOGIT_TOL


def test_best_last_config_and_npz_carried_over(runs):
    r = runs("yolo")
    assert [p.name for p in r.written] == ["best", "last"]
    assert (r.prun / "model_config.json").read_bytes() == (r.jrun / "model_config.json").read_bytes()
    npz = "int8_quant_best.npz"
    assert (r.prun / "weights" / npz).read_bytes() == (r.jrun / "weights" / npz).read_bytes()
    raws = {n: torch.load(r.prun / "weights" / n / CheckpointManager.FILE, weights_only=True)
            for n in ("best", "last")}
    kernel = np.asarray(r.variables["params"]["head"]["cls0_pred"]["kernel"]).transpose(3, 2, 0, 1)
    for name, raw in raws.items():
        assert set(raw) == {"step", "model", "ema_params"} and raw["step"] == STEPS[name]
        scale = 1.0 if name == "best" else 0.5
        np.testing.assert_array_equal(raw["model"]["head.cls0_pred.weight"].numpy(),
                                      (kernel * np.float32(scale)))
    # the port loads ``last`` with JAX's running statistics and EMA
    jl = jax_loaded(r.jrun, "last", True, r.variables)
    loaded = tload.load_detector(r.prun, checkpoint="last", img_h=H, img_w=W, device="cpu")
    bn = jl.variables["batch_stats"]["backbone"]["SpaceToDepthStem_0"]["ConvBNAct_0"]["bn"]
    prefix = "backbone.SpaceToDepthStem_0.ConvBNAct_0.bn."
    for leaf, name in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_array_equal(loaded.variables[prefix + name].numpy(), np.asarray(bn[leaf]))
    ema = np.asarray(jl.variables["params"]["head"]["cls0_pred"]["kernel"]).transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(loaded.variables["head.cls0_pred.weight"].numpy(), ema)


def _extra_leaf(raw):
    return {**raw, "params": {**raw["params"],
                              "bogus": {"kernel": np.zeros((3, 3, 4, 4), np.float32)}}}


def _missing_leaf(raw):
    head = dict(raw["params"]["head"])
    del head["cls0_pred"]
    return {**raw, "params": {**raw["params"], "head": head}}


def _odd_leaf(raw):
    head = {**raw["params"]["head"], "odd": np.zeros((2, 2, 2), np.float32)}
    return {**raw, "params": {**raw["params"], "head": head}}


def _missing_ema_leaf(raw):
    head = dict(raw["ema_params"]["head"])
    del head["cls0_pred"]
    return {**raw, "ema_params": {**raw["ema_params"], "head": head}}


@pytest.fixture(scope="module")
def yolo_raw(runs):
    """The raw restore of the YOLO-n run's ``best``, as the tool makes it."""
    import orbax.checkpoint as ocp

    return ocp.StandardCheckpointer().restore((runs("yolo").jrun / "weights" / "best").resolve())


@pytest.mark.parametrize("edit,error,match", [
    (_extra_leaf, RuntimeError, "Unexpected key"),
    (_missing_leaf, RuntimeError, "Missing key"),
    (_odd_leaf, ValueError, "unsupported parameter"),
    (_missing_ema_leaf, ValueError, "EMA keys differ"),
], ids=["extra", "missing", "unknown-kind", "missing-ema"])
def test_unknown_or_missing_leaf_raises(runs, yolo_raw, edit, error, match):
    """The restored tree edited (Orbax's restore patched to return it)."""
    import orbax.checkpoint as ocp

    edited = edit(yolo_raw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ocp.StandardCheckpointer, "restore", lambda self, *a, **k: edited)
        with pytest.raises(error, match=match):
            load_tool().convert_checkpoint(runs("yolo").jrun / "weights" / "best",
                                           CONFIGS["yolo"])


def test_restore_refuses_converted_checkpoint(runs):
    r = runs("yolo")
    _, template = tload.build_detector(CONFIGS["yolo"])
    trainer = DetectionTrainer(template, DetTrainConfig(variant="n", img_h=H, img_w=W),
                               steps_per_epoch=1, device="cpu")
    manager = CheckpointManager(r.prun / "weights")
    with pytest.raises(ValueError, match="orbax_to_torch"):
        manager.restore("best", trainer.init_state())
    state = manager.restore_eval("best", trainer.init_state())
    raw = torch.load(r.prun / "weights" / "best" / CheckpointManager.FILE, weights_only=True)
    for name, t in raw["ema_params"].items():
        assert torch.equal(state.ema_params[name], t), name


def test_tool_main_prints_each_checkpoint(runs, tmp_path, capsys):
    r = runs("moe")
    assert load_tool().main(["--weights", str(r.jrun), "--out", str(tmp_path / "out")]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [Path(line.split()[-1]).name for line in lines] == ["best"]
    with pytest.raises(FileNotFoundError):
        load_tool().convert_run(tmp_path / "nowhere", tmp_path / "out2")
