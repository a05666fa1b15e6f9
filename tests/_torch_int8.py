"""Shared helpers for the int8 parity tests (tests/test_torch_quant.py,
test_torch_int8_yolo.py, test_torch_int8_rtdetr.py): JAX's quantization of
a Flax model on the CPU as ``tests/test_quant.py`` runs it, the port loaded
from the same quant tree, and the relations the outputs are held to."""

from __future__ import annotations

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_moe_torch import quant as tq
from multimodal_moe_tpu import quant as jq

EPILOGUES = ["silu", "bf16"]
# The port's int8 logits must be at least this many times closer to JAX's
# int8 logits (mean |d|) than JAX's int8 logits are to JAX's fp logits.
CLOSER = 20.0


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: the suite runs several pytest workers side by
    side, and more threads each only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def epilogue(mode: str):
    """``MMOE_I8_EPILOGUE=mode`` for the duration (both packages read it)."""
    old = os.environ.get("MMOE_I8_EPILOGUE")
    os.environ["MMOE_I8_EPILOGUE"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["MMOE_I8_EPILOGUE"]
        else:
            os.environ["MMOE_I8_EPILOGUE"] = old


def calib_images(n: int, h: int, w: int, seed: int, b: int = 2) -> "list[np.ndarray]":
    rng = np.random.default_rng(seed)
    return [rng.random((b, h, w, 3), np.float32) for _ in range(n)]


def jax_quantize(jmodel, jmodel_q, variables, images, mode: str = "absmax", **kw):
    """JAX's ``calibrate`` and ``build_quant_variables``: (qcal, qvars), numpy."""
    qcal = jq.calibrate(jmodel, variables, [jnp.asarray(x) for x in images], mode=mode, **kw)
    qvars = jq.build_quant_variables(jmodel_q, variables, qcal, jnp.asarray(images[0][:1]))
    return jax.device_get(qcal), jax.device_get(qvars)


def jax_apply(jmodel, variables, x, mode: str, **kw):
    """A jitted ``apply`` traced under epilogue ``mode`` (XLA fuses the
    epilogue as it does in serving)."""
    with epilogue(mode):
        fn = jax.jit(lambda v, a: jmodel.apply(v, a, train=False, **kw))
        return jax.device_get(fn(variables, x))


def port_apply(model, x, mode: str, **kw):
    with epilogue(mode), torch.inference_mode():
        return model(x, **kw)


def trees_equal(a, b) -> None:
    """Two quant trees: the same leaves, dtypes and values bit for bit."""
    fa, fb = tq.flatten(a), tq.flatten(b)
    assert set(fa) == set(fb), sorted(set(fa) ^ set(fb))[:10]
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype, y.dtype, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=k)


def assert_closer(port: dict, jax_q: dict, jax_fp: dict, keys=("box_logits", "cls_logits")):
    """The port's int8 outputs are ``CLOSER`` times closer to JAX's int8
    outputs than JAX's int8 outputs are to JAX's fp outputs (mean |d|);
    returns the two means per key."""
    seen = {}
    for k in keys:
        got = port[k].numpy() if isinstance(port[k], torch.Tensor) else np.asarray(port[k])
        d_port = float(np.abs(got - jax_q[k]).mean())
        d_quant = float(np.abs(jax_q[k] - jax_fp[k]).mean())
        assert d_quant > 0, k
        assert CLOSER * d_port <= d_quant, (k, d_port, d_quant)
        seen[k] = (d_port, d_quant)
    return seen


def assert_codes_close(got: torch.Tensor, ref, share: float) -> float:
    """int8 codes equal, or one apart at no more than ``share`` of them;
    returns the share that differs."""
    g = got.to(torch.int32).numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.int32)
    r = np.asarray(ref).astype(np.int32)
    assert g.shape == r.shape
    diff = np.abs(g - r)
    assert diff.max(initial=0) <= 1, int(diff.max())
    frac = float((diff > 0).mean())
    assert frac <= share, frac
    return frac


def nhwc_codes(qt) -> np.ndarray:
    """A port QT's NCHW codes as NHWC numpy (JAX's layout)."""
    return qt.q.permute(0, 2, 3, 1).numpy()


def port_qt(q_nhwc: np.ndarray, s) -> "tq.QT":
    """JAX's NHWC int8 codes as the port's NCHW QT (a channels-last view)."""
    q = torch.from_numpy(np.array(q_nhwc)).permute(0, 3, 1, 2)
    return tq.QT(q, torch.tensor(np.float32(s)))
