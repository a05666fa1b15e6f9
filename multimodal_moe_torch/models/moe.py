"""Context-routed Mixture-of-Experts (PyTorch): the fp path and the w8a8
serving sweep.

Counterpart of ``multimodal_moe_tpu/models/moe.py``: the fp32 context gate
(``token·W + context_bias[solar_bin]``), the three top-k routers with the
Switch balance loss and the ST-MoE z-loss, and the dispatch modes of
``MoEFFN``:

* ``"dense"``: ``(T, E, C)`` dispatch and combine einsums (small T);
* ``"sweep"``: every expert on every token, combined by the ``(T, E)`` gate
  matrix (dropless);
* ``"sparse"``: scatter into an ``(E·C + 1, d)`` capacity buffer whose last
  row is the trash slot, expert FFN, clipped gather; with ``use_fused_ffn``
  the expert FFN is the CUDA kernel of :mod:`..ops.moe_kernels` and the
  capacity is rounded up to its tile;
* ``"gmm"``: the (token, expert) pairs sorted by expert and both FFN
  products as grouped GEMMs over the expert segments (dropless; the CUDA
  kernels of :mod:`..ops.gmm_kernel`, forward and backward);
* ``"auto"``: dense up to 4096 tokens, then sweep up to 16 experts, else
  sparse (:func:`resolve_dispatch`).

Built with ``int8=True``, ``MoEFFN`` takes a ``quant.QT`` of int8 tokens and
always runs :func:`moe_apply_sweep_int8` (dropless, every expert on every
token, both products ``torch._int_mm``), whatever ``dispatch`` says; the
router stays fp32.

Under an active mesh (``parallel.mesh.use_mesh``: one rank a slice of the
global batch) ``MoEFFN`` routes as JAX's one ``jit`` over the global batch
does: the token count, the per-expert counts, the mean router probability
and the z-loss are summed over every rank (so are ``moe_aux_loss``,
``expert_load``, ``capacity`` and ``auto``'s choice), and queue positions
run in global token order (the rank's own cumsum plus the counts of the
ranks before it; only the drop decision reads them). With experts sharded
over the mesh's expert axis (``parallel.mesh.shard_module``), the tokens
and their routing are gathered over the expert group, each rank runs its
own experts (``sweep``: over every gathered token; ``gmm``: kernel B3 over
the pairs routed to them; ``sparse``: their capacity slots of the group's
tokens; ``dense``: as the sweep with the gates of the pairs within
capacity, the same sums as the ``(T, E, C)`` einsums, each slot holding
one token), and the partial combine is summed over the expert group, each
rank keeping its own rows. Top-k over probabilities uses ``stable_topk``
(``lax.top_k``'s order: lower index first among ties), never
``torch.topk``.

Under a profiler (``utils.profiler.annotate``) each ``MoEFFN`` call is the
span ``moe.level``; in one process it holds ``moe.route`` (the gate and the
top-k route) and ``moe.experts`` (the experts and the combine), which
counts ``routed_rows`` (T·k) and ``computed_rows``, the rows its experts
run: T·E for the sweeps, T·k for ``gmm``, the E·C capacity slots for
``dense`` and ``sparse``.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import gmm_kernel, moe_kernels
from ..ops.int8_conv import int_mm
from ..ops.nms import stable_topk
from ..parallel.mesh import EXPERT_AXIS, active_mesh, expert_rows
from ..quant import QT, record, recording, register_quant
from ..utils.profiler import annotate

# 5 labelled solar-elevation bins + "missing" (data/solar.py of the JAX package).
NUM_SOLAR_BINS = 6
# The routers' aux-loss weights: Switch balance and ST-MoE z-loss.
BALANCE_COEF, Z_LOSS_COEF = 0.01, 1e-3


class RouterOutput(NamedTuple):
    combine: torch.Tensor      # (T, E, C) fp32 combine weights
    dispatch: torch.Tensor     # (T, E, C) bool dispatch mask
    aux_loss: torch.Tensor     # scalar: balance + z-loss
    expert_load: torch.Tensor  # (E,) fraction of tokens routed per expert


class RouterDecision(NamedTuple):
    expert_idx: torch.Tensor   # (T, k) int64
    gates: torch.Tensor        # (T, k) fp32, renormalised over the selected experts
    position: torch.Tensor     # (T, k) slot within the expert's queue
    valid: torch.Tensor        # (T, k) bool: False once capacity is exceeded
    aux_loss: torch.Tensor     # scalar
    expert_load: torch.Tensor  # (E,)


def _aux_loss(logits, probs, counts, t, k, balance_coef, z_loss_coef, mesh=None):
    """Switch balance ``E·Σ f_e·P_e`` (f from the pre-capacity top-k counts)
    plus the router z-loss on the logsumexp. On a ``mesh``, ``counts`` and
    ``t`` are the global batch's, and the sums of the probabilities and of
    the squared logsumexp are summed over every rank (with their gradient)."""
    e = logits.shape[-1]
    f = counts / (t * k) * e
    lse2 = torch.logsumexp(logits, dim=-1) ** 2
    if mesh is None:
        p_mean, z = probs.mean(0), torch.mean(lse2)
    else:
        sums = mesh.all_reduce(torch.cat([probs.sum(0), lse2.sum()[None]]))
        p_mean, z = sums[:e] / t, sums[e] / t
    balance = (f * p_mean).sum() * e
    return balance_coef * balance + z_loss_coef * z


def _queue_positions(topk_idx, e):
    """Each selection's place in its expert's queue, over the flattened
    ``(T·k)`` selections (token-major, slot-minor), counting from 0."""
    t, k = topk_idx.shape
    onehot = F.one_hot(topk_idx.reshape(-1), e)                     # (T·k, E)
    # The exclusive cumsum over T·k of each expert's column, taken as one
    # 1-D scan over the expert-major flattening (a CUDA scan along dim 0 of
    # a (T·k, E) tensor runs one thread per column: ~1 s at T·k = 3.5M).
    # Each expert's running count then drops the totals of the experts
    # before it.
    running = onehot.T.reshape(-1).cumsum(0).reshape(e, -1)
    running = running - F.pad(running[:-1, -1:], (0, 0, 1, 0))
    position_flat = running.T - onehot
    return torch.gather(position_flat.reshape(t, k, e), -1, topk_idx[..., None])[..., 0]


def _select_by_logits(logits, probs, k):
    """:func:`route_top_k`'s selection, ``logits >= the k-th`` (ties can
    select more than k), and its gates renormalised over the selection."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]  # a value: tie order is moot
    selected = logits >= kth
    gates = torch.where(selected, probs, 0.0)
    return selected, gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)


def _topk_probs(logits, k):
    logits = logits.float()
    probs = torch.softmax(logits, dim=-1)
    topk_probs, topk_idx = stable_topk(probs, k)
    gates = topk_probs / torch.clamp(topk_probs.sum(-1, keepdim=True), min=1e-9)
    counts = torch.bincount(topk_idx.reshape(-1), minlength=logits.shape[-1]).float()
    return logits, probs, topk_idx, gates, counts


def route_top_k(logits, *, k: int, capacity: int, balance_coef: float = BALANCE_COEF,
                z_loss_coef: float = Z_LOSS_COEF) -> RouterOutput:
    """Capacity-constrained top-k routing, dense ``(T, E, C)`` outputs.
    Selection is by logits with ``logits >= kth``, so ties can select more
    than k; tokens past an expert's capacity are dropped for that expert."""
    logits = logits.float()
    t, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    topk, gates = _select_by_logits(logits, probs, k)               # (T, E)

    position = torch.cumsum(topk.int(), dim=0) - 1                  # (T, E)
    within = topk & (position < capacity)
    pos_onehot = F.one_hot(
        torch.where(within, position, capacity).long(), capacity + 1
    )[..., :capacity].float()                                       # (T, E, C)
    combine = gates[..., None] * pos_onehot

    load = topk.float().mean(0)
    counts = topk.float().sum(0)
    aux = _aux_loss(logits, probs, counts, t, k, balance_coef, z_loss_coef)
    return RouterOutput(combine, pos_onehot > 0, aux, load)


def route_top_k_sparse(logits, *, k: int, capacity: int, balance_coef: float = BALANCE_COEF,
                       z_loss_coef: float = Z_LOSS_COEF) -> RouterDecision:
    """The same routing as :func:`route_top_k` in O(T·k) outputs, selecting
    by probabilities. Queue positions follow the flattened ``(T·k)``
    selections, token-major and slot-minor."""
    logits, probs, topk_idx, gates, counts = _topk_probs(logits, k)
    t, e = logits.shape
    position = _queue_positions(topk_idx, e)
    aux = _aux_loss(logits, probs, counts, t, k, balance_coef, z_loss_coef)
    return RouterDecision(topk_idx, gates, position, position < capacity, aux, counts / t)


def route_top_k_dropless(logits, *, k: int, balance_coef: float = BALANCE_COEF,
                         z_loss_coef: float = Z_LOSS_COEF):
    """Top-k routing without capacity: ``(expert_idx (T, k), gates (T, k),
    aux, expert_load (E,))``."""
    logits, probs, topk_idx, gates, counts = _topk_probs(logits, k)
    t = logits.shape[0]
    aux = _aux_loss(logits, probs, counts, t, k, balance_coef, z_loss_coef)
    return topk_idx, gates, aux, counts / t


def moe_apply_sparse(tokens, decision: RouterDecision, w1, b1, w2, b2, *, capacity: int,
                     activation=F.silu, use_fused_ffn: bool = False) -> torch.Tensor:
    """Scatter tokens into the ``(E·C + 1, d)`` capacity buffer (over-capacity
    copies land in the trash row, last), run the expert FFN on ``E·C`` rows,
    gather back through clipped slots and weight by gate × valid."""
    t, d = tokens.shape
    e = w1.shape[0]
    k = decision.expert_idx.shape[1]
    dtype = tokens.dtype

    flat_valid = decision.valid.reshape(-1)
    slot = torch.where(flat_valid, decision.expert_idx.reshape(-1) * capacity
                       + decision.position.reshape(-1), e * capacity)
    src = tokens.repeat_interleave(k, dim=0)                        # (T·k, d)
    buf = torch.zeros((e * capacity + 1, d), dtype=dtype, device=tokens.device)
    buf[slot] = torch.where(flat_valid[:, None], src, 0)           # valid slots are unique

    if use_fused_ffn:
        flat_out = moe_kernels.fused_expert_ffn(
            buf[: e * capacity], w1.to(dtype), b1.to(dtype), w2.to(dtype), b2.to(dtype),
            capacity,
        )
    else:
        expert_in = buf[: e * capacity].reshape(e, capacity, d)
        mid = activation(torch.bmm(expert_in, w1.to(dtype)) + b1.to(dtype))
        flat_out = (torch.bmm(mid, w2.to(dtype)) + b2.to(dtype)).reshape(e * capacity, d)
    gathered = flat_out[torch.clamp(slot, 0, e * capacity - 1)]     # (T·k, d)
    weighted = gathered * (decision.gates.reshape(-1, 1).to(dtype)
                           * flat_valid[:, None].to(dtype))
    return weighted.reshape(t, k, d).sum(dim=1)


def sweep_combine(tokens, comb, w1, b1, w2, b2, *, activation=F.silu) -> torch.Tensor:
    """Every expert of ``w1`` over every token, combined with ``comb`` (T,
    E): its column per expert, multiply-then-sum over E."""
    dtype = tokens.dtype
    mid = activation(torch.matmul(tokens, w1.to(dtype)) + b1.to(dtype))      # (E, T, h)
    out_e = torch.matmul(mid, w2.to(dtype)) + b2.to(dtype)                   # (E, T, d)
    return (out_e * comb.T.to(dtype)[:, :, None]).sum(dim=0)


def gate_matrix(expert_idx, gates, e: int) -> torch.Tensor:
    """The ``(T, E)`` float32 matrix of each token's gate per expert."""
    comb = torch.zeros((expert_idx.shape[0], e), dtype=torch.float32, device=gates.device)
    return comb.scatter_add(1, expert_idx, gates.float())


def moe_apply_sweep(tokens, expert_idx, gates, w1, b1, w2, b2, *,
                    activation=F.silu) -> torch.Tensor:
    """Every expert over every token, combined with the ``(T, E)`` gate
    matrix as multiply-then-sum over E (dropless)."""
    comb = gate_matrix(expert_idx, gates, w1.shape[0])
    return sweep_combine(tokens, comb, w1, b1, w2, b2, activation=activation)


def moe_apply_gmm(tokens, expert_idx, gates, w1, b1, w2, b2, *,
                  activation=F.silu, first_expert: int = 0) -> torch.Tensor:
    """Dropless grouped-GEMM dispatch (megablox ``gmm``): sort the ``T·k``
    (token, expert) pairs by expert (stably, as ``jnp.argsort``), run both
    FFN products as grouped GEMMs over the contiguous expert segments in
    float32, cast to the compute type and add each row's expert bias, then
    unsort and combine with the gate weights. ``w1``… hold the experts
    ``[first_expert, first_expert + E_local)`` (a rank's shard): the pairs
    of the other experts sort after the last segment, where ``gmm`` writes
    zeros, and weigh 0."""
    t, d = tokens.shape
    e = w1.shape[0]
    k = expert_idx.shape[1]
    dtype = tokens.dtype

    flat_expert = expert_idx.reshape(-1) - first_expert                     # (T·k,)
    local = (flat_expert >= 0) & (flat_expert < e)
    key = torch.where(local, flat_expert, e)
    order = torch.argsort(key, stable=True)
    token_ids = torch.arange(t * k, device=tokens.device) // k
    src = tokens[token_ids[order]]                                          # (T·k, d) sorted
    # The segment sizes stay on the device (a bincount would read its
    # length on the host).
    group_sizes = torch.zeros(e + 1, dtype=torch.long, device=tokens.device).scatter_add_(
        0, key, torch.ones_like(key))[:e].to(torch.int32)
    eid = key[order].clamp_max(e - 1)

    # Each row's expert bias by index_select, whose gradient adds the rows
    # with atomics: an advanced-index gather's gradient walks the ~T·k/E
    # repeats of each expert serially, one warp an expert (PERF.md).
    mid = activation(gmm_kernel.grouped_matmul(src, w1.to(dtype), group_sizes).to(dtype)
                     + b1[:, 0].index_select(0, eid).to(dtype))
    out_sorted = (gmm_kernel.grouped_matmul(mid, w2.to(dtype), group_sizes).to(dtype)
                  + b2[:, 0].index_select(0, eid).to(dtype))

    inv = torch.empty_like(order).scatter_(0, order, torch.arange(t * k, device=order.device))
    weighted = out_sorted[inv] * (gates.reshape(-1) * local).reshape(-1, 1).to(dtype)
    return weighted.reshape(t, k, d).sum(dim=1)


SWEEP_INT8_BUDGET_BYTES = 1 << 28


def moe_apply_sweep_int8(tokens_q, token_scale, expert_idx, gates, w1_q, s_w1, b1, s_mid,
                         w2_q, s_w2, b2) -> torch.Tensor:
    """w8a8 expert sweep, the serving twin of :func:`moe_apply_sweep`.

    ``tokens_q`` (T, d) int8 codes at ``token_scale``; ``w1_q`` (E, d, h) and
    ``w2_q`` (E, h, d) int8 with per-expert-per-channel scales ``s_w1`` (E, h)
    and ``s_w2`` (E, d); ``b1`` (E, 1, h), ``b2`` (E, 1, d); ``s_mid`` (E,)
    the calibrated mid scales. Each expert's two products are exact int32
    ``torch._int_mm``; the mid epilogue is ``layers.apply_i8_epilogue`` with
    SiLU, requantized per expert; the output and the gate combine are fp32.
    Tokens go in chunks of at most ``SWEEP_INT8_BUDGET_BYTES`` of int32
    accumulator: at MoE-YOLO-s B=128 the whole (E, T, h) accumulator of
    level 0 would be 4·1.757M·256·4 B ≈ 7.2 GB."""
    from .layers import apply_i8_epilogue

    t, d = tokens_q.shape
    e, _, h = w1_q.shape
    comb = torch.zeros((t, e), dtype=torch.float32, device=tokens_q.device)
    comb.scatter_add_(1, expert_idx, gates.float())
    # the GEMMs' right operands column-major (cuBLASLt's int8 layout)
    w1_t = w1_q.transpose(1, 2).contiguous()
    w2_t = w2_q.transpose(1, 2).contiguous()
    out = torch.empty((t, d), dtype=torch.float32, device=tokens_q.device)
    chunk = max(1, SWEEP_INT8_BUDGET_BYTES // (4 * max(h, d)))
    for s in range(0, t, chunk):
        x = tokens_q[s:s + chunk]
        acc = None
        for i in range(e):
            x32 = int_mm(x, w1_t[i].t())
            mid_q = apply_i8_epilogue(x32, token_scale * s_w1[i], b1[i], True, s_mid[i])
            y32 = int_mm(mid_q, w2_t[i].t())
            out_e = y32.float() * (s_mid[i] * s_w2[i]) + b2[i]
            term = out_e * comb[s:s + chunk, i:i + 1]
            acc = term if acc is None else acc + term
        out[s:s + chunk] = acc
    return out


def resolve_dispatch(dispatch: str, num_tokens: int, num_experts: int) -> str:
    """Resolve ``dispatch="auto"`` to the mode :class:`MoEFFN` runs."""
    if dispatch != "auto":
        return dispatch
    if num_tokens <= MoEFFN.DENSE_TOKEN_LIMIT:
        return "dense"
    if num_experts <= MoEFFN.SWEEP_EXPERT_LIMIT:
        return "sweep"
    return "sparse"


class ContextGate(nn.Module):
    """``tokens·router_kernel + context_bias[context_ids]`` in float32. The
    parameters stay float32 when the model around them is cast (ST-MoE: the
    gate runs in fp32 even in a bf16 trunk)."""

    def __init__(self, dim: int, num_experts: int, num_context_bins: int = NUM_SOLAR_BINS):
        super().__init__()
        self.router_kernel = nn.Parameter(torch.zeros(dim, num_experts))  # JAX (in, out) layout
        self.context_bias = nn.Parameter(torch.zeros(num_context_bins, num_experts))

    def reset_parameters(self, generator: "torch.Generator | None" = None):
        """Flax's init: ``truncated_normal(0.02)`` (±2σ) kernel, zero bias."""
        with torch.no_grad():
            nn.init.trunc_normal_(self.router_kernel, 0.0, 0.02, -0.04, 0.04, generator=generator)
            self.context_bias.zero_()

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        for p in self.parameters(recurse=False):
            if p.dtype != torch.float32:
                p.data = p.data.float()
        return self

    def forward(self, tokens, context_ids):
        # index_select: its gradient adds the T rows into the few bins with
        # atomics (an advanced-index gather's walks each bin's rows serially).
        return tokens.float() @ self.router_kernel + self.context_bias.index_select(0, context_ids)


class ContextRouter(nn.Module):
    """Context gate + :func:`route_top_k` (dense ``(T, E, C)`` outputs)."""

    def __init__(self, dim: int, num_experts: int, num_context_bins: int = NUM_SOLAR_BINS,
                 k: int = 2, capacity_factor: float = 1.25, balance_coef: float = BALANCE_COEF,
                 z_loss_coef: float = Z_LOSS_COEF):
        super().__init__()
        self.gate = ContextGate(dim, num_experts, num_context_bins)
        self.num_experts, self.k, self.capacity_factor = num_experts, k, capacity_factor
        self.balance_coef, self.z_loss_coef = balance_coef, z_loss_coef

    def forward(self, tokens, context_ids) -> RouterOutput:
        t = tokens.shape[0]
        capacity = max(int(t * self.k * self.capacity_factor / self.num_experts), self.k)
        return route_top_k(self.gate(tokens, context_ids), k=self.k, capacity=capacity,
                           balance_coef=self.balance_coef, z_loss_coef=self.z_loss_coef)


def _lecun_normal_stacked_(w: torch.Tensor, generator) -> torch.Tensor:
    """Flax ``lecun_normal`` on an ``(E, in, out)`` kernel: the leading axis
    counts into the fan-in, so std = 1/sqrt(E·in) (before the truncation
    correction)."""
    std = math.sqrt(1.0 / (w.shape[0] * w.shape[1])) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
    return w


class MoEFFN(nn.Module):
    """Expert FFNs stacked ``(E, ...)`` behind a context router, with a
    residual: ``forward(tokens (T, d), context_ids (T,))`` →
    ``(tokens + moe(tokens), {"moe_aux_loss", "expert_load"})``.

    Parameters keep the Flax names and layouts (``router.router_kernel``
    ``(d, E)``, ``router.context_bias``, ``experts_w1`` ``(E, d, h)``,
    ``experts_b1`` ``(E, 1, h)``, ``experts_w2`` ``(E, h, d)``, ``experts_b2``
    ``(E, 1, d)``); the expert weights are cast to the compute dtype at use.
    With ``int8`` the expert weights are the quant leaves of JAX's ``quant``
    collection (``w1_q``, ``s_w1``, ``b1``, ``s_mid``, ``w2_q``, ``s_w2``,
    ``b2``) and the router keeps its fp32 parameters. The fp forward records
    ``mid_absmax``, the per-expert absmax of the sweep's mid activation over
    all tokens, while ``quant.calibrate`` runs.
    """

    DENSE_TOKEN_LIMIT = 4096
    SWEEP_EXPERT_LIMIT = 16
    MODES = ("auto", "dense", "sweep", "sparse", "gmm")

    def __init__(self, dim: int, num_experts: int = 4, hidden_mult: float = 2.0, k: int = 2,
                 capacity_factor: float = 1.25, num_context_bins: int = NUM_SOLAR_BINS,
                 dtype: torch.dtype = torch.float32, dispatch: str = "auto",
                 use_fused_ffn: bool = False, generator: "torch.Generator | None" = None,
                 int8: bool = False):
        super().__init__()
        if dispatch not in self.MODES:
            raise ValueError(f"dispatch must be one of {self.MODES}, got {dispatch!r}")
        h = int(dim * hidden_mult)
        e = num_experts
        self.num_experts, self.k, self.capacity_factor = num_experts, k, capacity_factor
        self.dtype, self.dispatch, self.use_fused_ffn = dtype, dispatch, use_fused_ffn
        self.int8 = int8
        self.router = ContextGate(dim, e, num_context_bins)
        if int8:
            for name, shape, dt in (("w1_q", (e, dim, h), torch.int8), ("s_w1", (e, h), None),
                                    ("b1", (e, 1, h), None), ("s_mid", (e,), None),
                                    ("w2_q", (e, h, dim), torch.int8), ("s_w2", (e, dim), None),
                                    ("b2", (e, 1, dim), None)):
                register_quant(self, name, torch.zeros(shape, dtype=dt or torch.float32))
            self.router.reset_parameters(generator)
            return
        self.experts_w1 = nn.Parameter(torch.zeros(e, dim, h))
        self.experts_b1 = nn.Parameter(torch.zeros(e, 1, h))
        self.experts_w2 = nn.Parameter(torch.zeros(e, h, dim))
        self.experts_b2 = nn.Parameter(torch.zeros(e, 1, dim))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: "torch.Generator | None" = None):
        self.router.reset_parameters(generator)
        _lecun_normal_stacked_(self.experts_w1, generator)
        _lecun_normal_stacked_(self.experts_w2, generator)
        with torch.no_grad():
            self.experts_b1.zero_()
            self.experts_b2.zero_()

    def forward(self, tokens, context_ids) -> "Tuple[torch.Tensor, Dict[str, torch.Tensor]]":
        """``tokens`` (T, d) fp, or a ``QT`` of int8 codes (the w8a8 sweep,
        fp32 out); ``context_ids`` (T,)."""
        quant = isinstance(tokens, QT)
        if quant != self.int8 or not quant and not tokens.is_floating_point():
            raise TypeError("int8 tokens come as a quant.QT (codes and scale) to a MoEFFN "
                            "built with int8=True; fp tokens to one built without")
        with annotate("moe.level"):
            if quant:
                return self._forward_int8(tokens, context_ids)
            mesh = active_mesh()
            if mesh is not None:
                return self._forward_on_mesh(tokens, context_ids, mesh)
            return self._forward_local(tokens, context_ids)

    def _forward_int8(self, tokens, context_ids):
        """The w8a8 sweep: every expert over every token."""
        t, e = tokens.q.shape[0], self.num_experts
        with annotate("moe.route"):
            tokens_fp = tokens.q.float() * tokens.s
            logits = self.router(tokens_fp, context_ids)
            topk_idx, gates, aux_loss, expert_load = route_top_k_dropless(logits, k=self.k)
        with annotate("moe.experts", routed_rows=t * self.k, computed_rows=t * e):
            out = moe_apply_sweep_int8(tokens.q, tokens.s, topk_idx, gates, self.w1_q, self.s_w1,
                                       self.b1, self.s_mid, self.w2_q, self.s_w2, self.b2)
        return tokens_fp + out, {"moe_aux_loss": aux_loss, "expert_load": expert_load}

    def _forward_local(self, tokens, context_ids):
        """One process: the route, then the dispatch mode's experts and combine."""
        t = tokens.shape[0]
        e = self.num_experts
        capacity = max(int(t * self.k * self.capacity_factor / e), self.k)
        w1, b1, w2, b2 = self.experts_w1, self.experts_b1, self.experts_w2, self.experts_b2
        if recording():
            # The sweep's mid activation over all tokens, one expert at a time.
            mid_absmax = torch.stack([F.silu(tokens.float() @ w1[i] + b1[i]).abs().amax()
                                      for i in range(e)])
            record(self, "mid_absmax", mid_absmax)

        mode = resolve_dispatch(self.dispatch, t, e)
        if mode == "sparse" and self.use_fused_ffn:
            capacity = moe_kernels.round_up_capacity(capacity)
        # The rows the experts run: every token for the sweep, the routed
        # pairs for gmm, the capacity slots for dense and sparse.
        computed = {"sweep": t * e, "gmm": t * self.k}.get(mode, e * capacity)
        x = tokens.to(self.dtype)
        with annotate("moe.route"):
            logits = self.router(tokens, context_ids)
            if mode in ("gmm", "sweep"):
                topk_idx, gates, aux_loss, expert_load = route_top_k_dropless(logits, k=self.k)
            elif mode == "dense":
                r = route_top_k(logits, k=self.k, capacity=capacity)
                aux_loss, expert_load = r.aux_loss, r.expert_load
            else:
                rd = route_top_k_sparse(logits, k=self.k, capacity=capacity)
                aux_loss, expert_load = rd.aux_loss, rd.expert_load
        with annotate("moe.experts", routed_rows=t * self.k, computed_rows=computed):
            if mode in ("gmm", "sweep"):
                apply = moe_apply_gmm if mode == "gmm" else moe_apply_sweep
                out = apply(x, topk_idx, gates, w1, b1, w2, b2)
            elif mode == "dense":
                expert_in = torch.einsum("tec,td->ecd", r.dispatch.to(x.dtype), x)
                mid = F.silu(torch.bmm(expert_in, w1.to(x.dtype)) + b1.to(x.dtype))
                expert_out = torch.bmm(mid, w2.to(x.dtype)) + b2.to(x.dtype)
                out = torch.einsum("tec,ecd->td", r.combine.to(x.dtype), expert_out)
            else:
                out = moe_apply_sparse(x, rd, w1, b1, w2, b2, capacity=capacity,
                                       use_fused_ffn=self.use_fused_ffn)
        aux = {"moe_aux_loss": aux_loss, "expert_load": expert_load}
        return tokens + out.to(tokens.dtype), aux

    def _forward_on_mesh(self, tokens, context_ids, mesh):
        """``forward`` on this rank's tokens with the global batch's routing
        (the module docstring): every rank calls it in step, with slices of
        one size."""
        e, k = self.num_experts, self.k
        t_loc = tokens.shape[0]
        t = t_loc * mesh.size
        capacity = max(int(t * k * self.capacity_factor / e), k)
        mode = resolve_dispatch(self.dispatch, t, e)
        w1, b1, w2, b2 = self.experts_w1, self.experts_b1, self.experts_w2, self.experts_b2
        rows = expert_rows(mesh, e)
        if w1.shape[0] != rows.stop - rows.start:
            raise ValueError(f"{w1.shape[0]} experts held on a mesh of {mesh.num_expert} expert "
                             f"shards of {e}: shard them (parallel.mesh.shard_module)")

        if mode == "dense":
            logits = self.router(tokens, context_ids).float()
            probs = torch.softmax(logits, dim=-1)
            selected, gates = _select_by_logits(logits, probs, k)
            local_counts = selected.sum(0)
        else:
            logits, probs, topk_idx, gates, local_counts = _topk_probs(
                self.router(tokens, context_ids), k)
        table = mesh.gather(local_counts.long()[None])                  # (ranks, E)
        counts = table.sum(0).float()
        before = table[:mesh.rank].sum(0)                               # earlier ranks' queue
        aux = _aux_loss(logits, probs, counts, t, k, BALANCE_COEF, Z_LOSS_COEF, mesh)
        load = counts / t

        sharded = mesh.num_expert > 1
        gather = (lambda a: mesh.gather(a, EXPERT_AXIS)) if sharded else (lambda a: a)
        x = gather(tokens.to(self.dtype))
        if mode == "dense":
            position = torch.cumsum(selected.long(), dim=0) - 1 + before
            comb = torch.where(selected & (position < capacity), gates, 0.0)
            partial = sweep_combine(x, gather(comb)[:, rows], w1, b1, w2, b2)
        elif mode == "sweep":
            comb = gate_matrix(topk_idx, gates, e)
            partial = sweep_combine(x, gather(comb)[:, rows], w1, b1, w2, b2)
        elif mode == "gmm":
            partial = moe_apply_gmm(x, gather(topk_idx), gather(gates), w1, b1, w2, b2,
                                    first_expert=rows.start)
        else:
            if self.use_fused_ffn:
                capacity = moe_kernels.round_up_capacity(capacity)
            position = _queue_positions(topk_idx, e) + before[topk_idx]
            # The slots of the expert group's tokens, from the first position
            # they take in each queue: at most min(C, the group's tokens).
            first = table[:mesh.d * mesh.num_expert].sum(0)
            idx = gather(topk_idx)
            slot = gather(position) - first[idx]
            valid = gather((position < capacity).long()).bool()
            valid &= (idx >= rows.start) & (idx < rows.stop)
            slots = min(capacity, x.shape[0])
            if self.use_fused_ffn:
                slots = moe_kernels.round_up_capacity(slots)
            decision = RouterDecision(idx - rows.start, gather(gates), slot, valid, aux, load)
            partial = moe_apply_sparse(x, decision, w1, b1, w2, b2, capacity=slots,
                                       use_fused_ffn=self.use_fused_ffn)
        out = mesh.own_rows(mesh.all_reduce(partial, EXPERT_AXIS), EXPERT_AXIS) if sharded \
            else partial
        return tokens + out.to(tokens.dtype), {"moe_aux_loss": aux, "expert_load": load}
