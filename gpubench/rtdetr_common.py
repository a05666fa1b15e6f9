"""What the RT-DETR drivers share: the port's detector for a configuration
of ``family: "rtdetr"``, the seeded weights by parameter name, their fit
to the pool's frames, and the capture of the program's own query
selection.

``common.build_model`` builds the YOLO family; this family is built here,
with its own weight rules, so that no file of the YOLO harness changes.
Nothing here imports the port at module level.
"""

from __future__ import annotations

import math

import torch

from . import common, deform_rooflines
from .reference import rtdetr as ref

# -- the system under test ----------------------------------------------------
def _meta_model(config: dict, dtype: torch.dtype, remat: bool = False):
    from multimodal_moe_torch.models.rtdetr import RTDETRDetector

    if config["aifi_ffn_dim"] != 4 * config["hidden_dim"] or config["decoder_ffn_dim"] != 1024:
        raise ValueError("the port builds AIFI's FFN at 4·hidden and the decoder's at 1024")
    with torch.device("meta"):
        return RTDETRDetector(num_classes=config["num_classes"], hidden_dim=config["hidden_dim"],
                              num_queries=config["num_queries"],
                              num_decoder_layers=config["num_decoder_layers"],
                              num_heads=config["num_heads"], num_points=config["num_points"],
                              num_denoising_groups=config["num_denoising_groups"],
                              backbone_depths=tuple(config["backbone_depths"]),
                              arch=config["arch"], dtype=dtype, remat=remat)


def build_model(config: dict, dtype: torch.dtype, device, weights: dict, *, train: bool = False,
                remat: bool = False):
    """The port's RT-DETR, its tensors allocated on ``device`` without their
    own initialisation and loaded strictly from ``weights``."""
    model = _meta_model(config, dtype, remat).to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model.train(train)


def weight_shapes(config: dict, dtype: torch.dtype) -> dict:
    return {k: (tuple(v.shape), v.dtype)
            for k, v in _meta_model(config, dtype).state_dict().items()}


# -- weights from the seed ------------------------------------------------------
def _rule(name: str, shape: tuple):
    """(mean, std) of a tensor's seeded values, or ``"grid"``: LeCun-normal
    convolution and Linear kernels, LayerNorm at 1 and 0, zero biases,
    ``sampling_offsets`` at the published grid init (zero kernel, the
    directional bias), the denoising content at the init's 0.02.

    Three scales keep rounding from growing through the random network as
    it cannot through a trained one. Every BatchNorm's scale starts at
    0.5 (``fit_to_frames`` then fits its statistics), and the last of each
    bottleneck's residual branch at 0.1 (the zero-γ init ResNet training
    uses, softened so that every branch does work). The last layer of each
    decoder box head starts at a tenth of LeCun's scale (the published
    init zeroes it), so that a layer refines its boxes by small steps.
    With every scale at 1 the trunk amplifies rounding about tenfold and
    the six refinements compound it: bf16 logits land 10-20 % off
    float32's, as far as fp8's (PERF.md §2)."""
    if name.endswith("num_batches_tracked"):
        return 0.0, 0.0
    if name.endswith("sampling_offsets.weight"):
        return 0.0, 0.0
    if name.endswith("sampling_offsets.bias"):
        return "grid"
    if name == "dn_content_embed":
        return 0.0, 0.02
    if ".LayerNorm_" in name:
        return (1.0, 0.0) if name.endswith(".weight") else (0.0, 0.0)
    if name.endswith("._ConvBN_2.BatchNorm_0.weight"):
        return 0.1, 0.01
    if ".BatchNorm_0." in name or ".bn." in name:
        leaf = name.rsplit(".", 1)[1]
        return {"weight": (0.5, 0.05), "bias": (0.0, 0.1), "running_mean": (0.0, 0.1),
                "running_var": (1.0, 0.1)}[leaf]
    if name.endswith(".weight") and len(shape) >= 2:
        lecun = 1.0 / math.sqrt(math.prod(shape[1:]))
        if name.startswith("bbox_head") and name.endswith(".Dense_2.weight"):
            return 0.0, 0.1 * lecun
        return 0.0, lecun
    if name.endswith(".bias") and len(shape) == 1:
        return 0.0, 0.0
    raise KeyError(f"no rule for the weights of {name}")


def make_weights(shapes: dict, config: dict, seed: int, device) -> dict:
    """Every tensor of the state dict from one normal draw on ``device``
    (values clipped at ±2σ), scaled by its rule, in the type it runs in."""
    total = sum(math.prod(s) for s, _ in shapes.values())
    flat = torch.empty(total, device=device).normal_(generator=common.generator(seed, device, 0))
    flat.clamp_(-2.0, 2.0)
    grid = ref.grid_init(config["num_heads"], ref.NUM_LEVELS, config["num_points"]).to(device)
    out, off = {}, 0
    for name, (shape, dtype) in shapes.items():
        n = math.prod(shape)
        rule = _rule(name, shape)
        t = grid.view(shape) if rule == "grid" else flat[off:off + n].view(shape) * rule[1] + rule[0]
        if name.endswith("running_var"):
            t = t.abs()
        out[name] = t.to(dtype)
        off += n
    return out


def prior_heads(weights: dict) -> "list[str]":
    """The class heads: the encoder's score and each decoder layer's."""
    return ["enc_score.bias"] + sorted(k for k in weights
                                       if k.startswith("cls_head") and k.endswith(".bias"))


def fit_to_frames(weights: dict, config: dict, frames: torch.Tensor, *, conf: float = 0.25,
                  above: int = 20) -> None:
    """Fit the seeded weights to the pool's frames, in place, as a trained
    detector sits on them: every BatchNorm's running statistics become its
    batch statistics on ``frames``, and each class head's prior (the bias
    of ``enc_score`` and of every ``cls_head``) is set so that the
    ``above``-th highest score of an image sits at ``conf`` on average:
    over the valid anchors for the encoder, over the queries for each
    decoder layer. The float32 reference computes both (TF32 off)."""
    w32 = {k: v.float() for k, v in weights.items()}
    stats: dict = {}
    heads = prior_heads(weights)
    with torch.no_grad(), common.reference_precision():
        ref.forward(w32, config, frames, train=True, batch_stats=stats)
        for name, (mean, var) in stats.items():
            for key, value in ((f"{name}.running_mean", mean), (f"{name}.running_var", var)):
                w32[key] = value
                weights[key].copy_(value)
        for k in heads:
            w32[k] = torch.zeros_like(w32[k])
        out = ref.forward(w32, config, frames)
        h, w = frames.shape[1:3]
        level_shapes = [(h // s, w // s) for s in (8, 16, 32)]
        _, valid = ref.anchors(level_shapes, frames.device)
        enc = out["enc_logits"][..., 0].masked_fill(~valid[None], -1e9)
        logits = {"enc_score.bias": enc}
        for i, ly in enumerate(out["aux_outputs"] + [out]):
            logits[f"cls_head{i}.bias"] = ly["pred_logits"][..., 0]
    target = math.log(conf / (1.0 - conf))
    for k in heads:
        kth = torch.topk(logits[k], above, dim=1).values[:, -1].mean()
        weights[k].fill_(target - float(kth))


# -- the program's own selection ------------------------------------------------------
def row_keys(x: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """An integer key of each row (the last axis) of ``x`` from its bits:
    the rows' 16-bit words, each times a salt, summed exactly in int64.
    Equal rows give equal keys in any order of summation."""
    words = x.contiguous().view(torch.int16)
    return (words.to(torch.int32) * salt[: words.shape[-1]]).sum(-1, dtype=torch.int64)


class SelectionCapture:
    """Hooks that recover the program's top-``Q`` anchors from what its
    model computes: the memory the encoder's score head reads (all anchors)
    and the content rows its query projection is given, matched row for row
    by their bits. ``on`` switches the capture; each captured forward
    appends ``(enc_logits (B, A) float32, topk (B, Q) int64)``; a content
    row found in no memory row gives index -1."""

    def __init__(self, model):
        self.on = False
        self.taken: list = []
        self._memory = None
        gen = torch.Generator().manual_seed(12345)
        self._salt = torch.randint(1, 2 ** 15, (4096,), generator=gen, dtype=torch.int32)
        self._handles = [model.enc_score.register_forward_hook(self._enc),
                         model.query_proj.register_forward_pre_hook(self._content)]

    def _enc(self, module, inputs, out) -> None:
        if self.on:
            self._memory = inputs[0]
            self._logits = out[..., 0].detach().float().clone()

    def _content(self, module, inputs) -> None:
        if not self.on or self._memory is None:
            return
        memory, content = self._memory.detach(), inputs[0].detach()
        self._memory = None
        salt = self._salt.to(memory.device)
        mk, ck = row_keys(memory, salt), row_keys(content, salt)
        keys, where = torch.sort(mk, dim=1)
        pos = torch.searchsorted(keys, ck).clamp_max(mk.shape[1] - 1)
        idx = torch.gather(where, 1, pos)
        rows = torch.gather(memory, 1, idx[..., None].expand(-1, -1, memory.shape[-1]))
        same = (rows.view(torch.int16) == content.view(torch.int16)).all(-1)
        self.taken.append((self._logits, torch.where(same, idx, -1)))

    def remove(self) -> None:
        for h in self._handles:
            h.remove()


def sampled_work(model, num_layers: int, forward) -> list:
    """The sampled work of every deformable call that ``forward()`` makes
    through ``model``'s decoder, in call order: each call's distinct value
    rows and corners (``deform_rooflines.sampled_work``) from the sampling
    locations its module computes."""
    work: list = []

    def take(module, inputs, out):
        query, ref_points, values, level_shapes = inputs
        v, loc, attn = module.sampling_inputs(query, ref_points, values)
        work.append(deform_rooflines.sampled_work(loc, attn, level_shapes, v.shape[1]))

    handles = [getattr(model, f"decoder{i}").cross_attn.register_forward_hook(take)
               for i in range(num_layers)]
    try:
        forward()
    finally:
        for h in handles:
            h.remove()
    return work
