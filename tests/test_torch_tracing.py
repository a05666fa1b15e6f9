"""The port's spans (``multimodal_moe_torch/utils/profiler.py:annotate``) on
the CPU: the primitive, and the span trees of the serving step, the NMS
tail, every single-process MoE dispatch and the train step.

* With no profiler active ``annotate`` records nothing. Under
  ``torch.profiler.profile`` a span is a host operation of the trace
  (``is_user_annotation`` False: no device-side annotation on the card)
  and one entry of the log, with its parent on the same thread and its
  counts.
* The toy YOLO-n and MoE-YOLO-n serving steps give ``serve.step`` ›
  ``serve.forward`` / ``serve.tail`` › ``nms.*``, each MoE level
  ``moe.level`` › ``moe.route`` / ``moe.experts`` with the rows the experts
  ran; a toy train step the ``train.*`` tree.
* Outputs with the profiler on are bitwise those with it off.

The card's side (CUDA event pairs, no span among the device operations)
is ``test_spans_on_the_card``, marked ``cuda``."""

import threading

import numpy as np
import pytest
import torch

from multimodal_moe_torch.models import moe as tm
from multimodal_moe_torch.models.moe_yolo import MoEYoloDetector, moe_yolo_loss
from multimodal_moe_torch.models.yolo import YoloDetector
from multimodal_moe_torch.quant import QT
from multimodal_moe_torch.serving import make_serving_step
from multimodal_moe_torch.train.detection import DetectionTrainer, DetTrainConfig
from multimodal_moe_torch.utils.profiler import annotate, clear_spans, spans

H, W, B = 64, 128, 2
T, D, E, K = 96, 16, 4, 2


@pytest.fixture(autouse=True)
def empty_log():
    clear_spans()
    yield
    clear_spans()


def profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def tree(log):
    """{(name, parent), ...} of a span log."""
    return {(s["name"], s["parent"]) for s in log}


def names(log, name):
    return [s for s in log if s["name"] == name]


# -- the primitive ---------------------------------------------------------------
def test_annotate_records_nothing_without_a_profiler():
    with annotate("outer", rows=3):
        with annotate("inner"):
            torch.ones(4).sum()
    assert spans() == []
    assert annotate("x") is annotate("y")   # the one shared no-op context


def test_a_span_is_a_host_op_with_its_parent_and_counts():
    with profiled() as prof:
        with annotate("outer", rows=3, slots=7):
            for _ in range(2):
                with annotate("inner"):
                    torch.ones(4).sum()
    log = spans()
    assert [s["name"] for s in log] == ["inner", "inner", "outer"]   # in the order they ended
    assert tree(log) == {("outer", None), ("inner", "outer")}
    outer = names(log, "outer")[0]
    assert outer["counts"] == {"rows": 3, "slots": 7}
    assert all(s["counts"] == {} for s in names(log, "inner"))
    assert {s["thread"] for s in log} == {threading.current_thread().name}
    assert all(s["device_ms"] is None for s in log)    # no card in this process
    for s in names(log, "inner"):
        assert outer["start_ns"] <= s["start_ns"] <= s["end_ns"] <= outer["end_ns"]
        assert s["host_ms"] == (s["end_ns"] - s["start_ns"]) / 1e6
    ops = [e for e in prof.events() if e.name in ("outer", "inner")]
    assert sorted(e.name for e in ops) == ["inner", "inner", "outer"]
    for e in ops:
        assert str(e.device_type).endswith("CPU")
        assert e.is_user_annotation is False


def test_spans_of_each_thread_keep_their_own_parents():
    def work():
        with annotate("worker.outer"):
            with annotate("worker.inner"):
                pass

    with profiled():
        with annotate("main.outer"):
            thread = threading.Thread(target=work, name="span-worker")
            thread.start()
            thread.join(timeout=60)
            assert not thread.is_alive()
    log = spans()
    assert tree(log) == {("main.outer", None), ("worker.outer", None),
                         ("worker.inner", "worker.outer")}
    assert names(log, "worker.inner")[0]["thread"] == "span-worker"


def test_a_span_that_raises_is_logged_and_unwinds():
    with profiled():
        with pytest.raises(ValueError):
            with annotate("fails"):
                raise ValueError("x")
        with annotate("after"):
            pass
    assert tree(spans()) == {("fails", None), ("after", None)}


def test_clear_spans_and_a_span_outliving_its_profiler():
    with profiled():
        span = annotate("crosses")
        span.__enter__()
    span.__exit__(None, None, None)
    assert [s["name"] for s in spans()] == ["crosses"]
    clear_spans()
    assert spans() == []
    with annotate("after_the_profiler"):
        pass
    assert spans() == []


# -- the serving step and the NMS tail ------------------------------------------------
def _images(seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 255, (B, H, W, 3),
                                                                  dtype=np.uint8))


def _moe_yolo(dispatch="auto"):
    torch.manual_seed(1)
    model = MoEYoloDetector(num_classes=1, variant="n", dispatch=dispatch).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("router_kernel"):
                p.normal_(0.0, 2.0 / p.shape[0] ** 0.5)
    return model


NMS_TREE = {("nms.preselect", "serve.tail"), ("nms.keep", "serve.tail"),
            ("nms.compact", "serve.tail")}


@pytest.mark.parametrize("model_name,tail", [("yolo", "full"), ("yolo", "topk"),
                                             ("moe_yolo", "full")])
def test_serving_step_span_tree(model_name, tail):
    if model_name == "yolo":
        torch.manual_seed(0)
        model = YoloDetector(num_classes=1, variant="n").eval()
    else:
        model = _moe_yolo()
    step = make_serving_step(model, pool=64, max_det=20, tail=tail)
    images, ctx = _images(3), torch.tensor([0, 4], dtype=torch.int32)
    off = step(images, ctx)
    assert spans() == []
    with profiled():
        on = step(images, ctx)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    log = spans()
    want = {("serve.step", None), ("serve.forward", "serve.step"),
            ("serve.tail", "serve.step")} | NMS_TREE
    if model_name == "moe_yolo":
        want |= {("moe.level", "serve.forward"), ("moe.route", "moe.level"),
                 ("moe.experts", "moe.level")}
        assert len(names(log, "moe.level")) == 3
    assert tree(log) == want
    assert all(len(names(log, n)) == 1 for n in ("serve.step", "serve.tail", "nms.keep"))


def test_nms_plain_path_spans_alone():
    from multimodal_moe_torch.ops.nms import batched_nms

    g = torch.Generator().manual_seed(5)
    xy = torch.rand((2, 50, 2), generator=g) * 50
    boxes = torch.cat([xy, xy + 5 + torch.rand((2, 50, 2), generator=g) * 20], -1)
    scores = torch.rand((2, 50), generator=g)
    off = batched_nms(boxes, scores, num_candidates=32, max_det=10)
    with profiled():
        on = batched_nms(boxes, scores, num_candidates=32, max_det=10)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    assert tree(spans()) == {("nms.preselect", None), ("nms.keep", None),
                             ("nms.compact", None)}


# -- the MoE level, every single-process dispatch ---------------------------------------
def _ffn(mode):
    torch.manual_seed(7)
    int8 = mode == "int8"
    m = tm.MoEFFN(D, E, k=K, dispatch="sweep" if int8 else mode, int8=int8)
    with torch.no_grad():
        m.router.router_kernel.normal_(0.0, 2.0 / D ** 0.5)
        m.router.context_bias.normal_(0.0, 1.0)
        if int8:
            g = torch.Generator().manual_seed(8)
            m.w1_q.copy_(torch.randint(-127, 128, m.w1_q.shape, generator=g))
            m.w2_q.copy_(torch.randint(-127, 128, m.w2_q.shape, generator=g))
            for name in ("s_w1", "s_w2", "s_mid"):
                getattr(m, name).fill_(0.01)
    return m


def _tokens(mode):
    g = torch.Generator().manual_seed(9)
    x = torch.randn((T, D), generator=g)
    ctx = torch.randint(0, tm.NUM_SOLAR_BINS, (T,), generator=g)
    if mode == "int8":
        return QT(torch.randint(-127, 128, (T, D), generator=g, dtype=torch.int8),
                  torch.tensor(0.02)), ctx
    return x, ctx


CAPACITY = max(int(T * K * 1.25 / E), K)
# the rows each dispatch's experts run: every token, the routed pairs or the slots
COMPUTED = {"sweep": T * E, "int8": T * E, "gmm": T * K, "dense": E * CAPACITY,
            "sparse": E * CAPACITY}


@pytest.mark.parametrize("mode", ["dense", "sweep", "sparse", "gmm", "int8"])
def test_moe_level_spans_and_rows(mode):
    m = _ffn(mode)
    x, ctx = _tokens(mode)
    with torch.no_grad():
        off = m(x, ctx)
        with profiled():
            on = m(x, ctx)
    assert torch.equal(off[0], on[0])
    for k in off[1]:
        assert torch.equal(off[1][k], on[1][k])
    log = spans()
    assert tree(log) == {("moe.level", None), ("moe.route", "moe.level"),
                         ("moe.experts", "moe.level")}
    # kernel_rows: the sweep kernel runs only on the card.
    assert names(log, "moe.experts")[0]["counts"] == {"routed_rows": T * K,
                                                      "computed_rows": COMPUTED[mode],
                                                      "kernel_rows": 0}


def test_auto_dispatch_counts_each_level_in_a_detector():
    """MoE-YOLO-n's three levels on ``auto``: each ``moe.experts`` counts
    the rows of the mode ``resolve_dispatch`` picks for its tokens."""
    model = _moe_yolo()
    with torch.no_grad(), profiled():
        model(_images(4).float() / 255.0, context_ids=torch.tensor([1, 2]))
    rows = [s["counts"] for s in names(spans(), "moe.experts")]
    tokens = [B * (H // s) * (W // s) for s in (8, 16, 32)]
    want = []
    for t in tokens:
        mode = tm.resolve_dispatch("auto", t, E)
        cap = max(int(t * K * 1.25 / E), K)
        want.append({"routed_rows": t * K,
                     "computed_rows": t * E if mode == "sweep" else E * cap,
                     "kernel_rows": 0})
    assert sorted(rows, key=lambda c: c["routed_rows"]) == \
        sorted(want, key=lambda c: c["routed_rows"])


# -- the train step -------------------------------------------------------------------
def _trainer():
    torch.manual_seed(2)
    model = MoEYoloDetector(num_classes=1, variant="n", dispatch="sweep")
    cfg = DetTrainConfig(variant="n", img_h=H, img_w=W, epochs=2, batch=B)
    return DetectionTrainer(model, cfg, loss_fn=moe_yolo_loss, steps_per_epoch=2,
                            device=torch.device("cpu"))


def _batch():
    g = torch.Generator().manual_seed(11)
    xy = torch.rand((B, 3, 2), generator=g) * torch.tensor([W - 20.0, H - 20.0])
    return {"image": _images(12), "gt_boxes": torch.cat([xy, xy + 16.0], -1),
            "gt_labels": torch.zeros((B, 3), dtype=torch.int32),
            "gt_mask": torch.tensor([[True, True, False], [True, False, False]]),
            "solar_bin": torch.tensor([0, 3])}


TRAIN_TREE = {("train.step", None), ("train.augment", "train.step"),
              ("train.forward", "train.step"), ("train.loss", "train.step"),
              ("train.backward", "train.step"), ("train.update", "train.step"),
              ("train.clip", "train.update"), ("train.sgd", "train.update"),
              ("train.ema", "train.update"),
              ("moe.level", "train.forward"), ("moe.route", "moe.level"),
              ("moe.experts", "moe.level")}


def test_train_step_span_tree_and_bitwise_state():
    trainer, batch = _trainer(), _batch()
    states = [trainer.init_state(), trainer.init_state()]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # one order of every float sum on both sides
    try:
        _, off = trainer.train_step(states[0], batch)
        with profiled():
            _, on = trainer.train_step(states[1], batch)
    finally:
        torch.set_num_threads(threads)
    for k in off:
        assert torch.equal(off[k], on[k]), k
    for (name, a), b in zip(states[0].model.named_parameters(), states[1].model.parameters()):
        assert torch.equal(a, b), name
    for k, v in states[0].ema_params.items():
        assert torch.equal(v, states[1].ema_params[k]), k
    log = spans()
    assert tree(log) == TRAIN_TREE
    assert len(names(log, "train.step")) == 1 and len(names(log, "moe.level")) == 3


# -- the card -------------------------------------------------------------------------
@pytest.mark.cuda
def test_spans_on_the_card():
    """On the card each span carries a CUDA event pair (device ms ≥ the
    kernels inside it), and no span is among the trace's device
    operations: it is a host op, not a ``gpu_user_annotation``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    x = torch.randn((2048, 2048), device=dev)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with annotate("card.outer", rows=2):
            for _ in range(4):
                with annotate("card.matmul"):
                    x = x @ x
                    x = x / x.norm()
        torch.cuda.synchronize()
    log = spans()
    assert tree(log) == {("card.outer", None), ("card.matmul", "card.outer")}
    assert all(s["device_ms"] is not None and s["device_ms"] > 0 for s in log)
    outer = names(log, "card.outer")[0]
    assert outer["device_ms"] >= sum(s["device_ms"] for s in names(log, "card.matmul")) * 0.99
    device_ops = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    assert device_ops and not any(e.name.startswith("card.") for e in device_ops)
    host = [e for e in prof.events() if e.name.startswith("card.")]
    assert len(host) == 5 and not any(e.is_user_annotation for e in host)
