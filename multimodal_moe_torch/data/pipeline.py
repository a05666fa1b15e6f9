"""The host input pipeline: parquet index → fixed-shape batches on the card.

Counterpart of ``multimodal_moe_tpu/data/pipeline.py``:

* **fixed shapes** — images ``(B, H, W, 3)`` uint8, ground truth padded to
  ``(B, max_boxes, ...)`` with a validity mask;
* **threaded host decode** — PIL per sample on a thread pool (``rgb``), or
  the native decoder's GIL-free batch decode to raw 4:2:0 planes
  (``yuv420``, half the host-to-device bytes);
* **copies ahead of the consumer** — ``prefetch_to_device`` keeps
  ``buffer_size`` batches in flight: pinned host memory, copies on a side
  CUDA stream, the planes turned into ``image`` on the card.

The batch order, padding and targets are JAX's, array for array
(``tests/test_torch_data.py``). pandas and PIL are imported where they are
used.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from .._device import resolve_device
from .exports import safe_iter_boxes
from .index import load_split_frames


@dataclass(frozen=True)
class ZODMoEDataConfig:
    """Dataset configuration (the JAX package's, field for field)."""

    frames_parquet: str
    split_csv: str
    image_path_col: str = "resized_image_path"
    label_col: str = "ped_present"
    boxes_col: str = "xyxy_bboxes"
    unclear_col: str = "ped_unclear_list"
    solar_col: str = "solar_context_bin"
    img_h: int = 704
    img_w: int = 1248
    max_boxes: int = 96
    unclear_policy: str = "exclude_unclear"
    drop_missing: bool = True
    image_root: Optional[str] = None  # re-root relative image paths


def _resolve_path(path_value: str, image_root: Optional[str]) -> Path:
    """A relative image path under ``image_root`` when one is given."""
    p = Path(path_value)
    if image_root is not None and not p.is_absolute():
        return Path(image_root) / p
    return p


class ZODMoEVisionDataset:
    """Frame-level dataset over parquet + split CSV.

    ``load(i)`` returns a dict with the decoded image (uint8 HWC at the
    configured size), padded detection targets, classification label and
    solar-context bin id — one sample, fixed shapes.
    """

    def __init__(self, cfg: ZODMoEDataConfig):
        from .solar import SOLAR_BIN_TO_ID

        self.cfg = cfg
        df = load_split_frames(cfg.frames_parquet, cfg.split_csv)
        if cfg.drop_missing:
            exists = df[cfg.image_path_col].map(
                lambda v: v is not None and _resolve_path(v, cfg.image_root).exists()
            )
            df = df[exists].reset_index(drop=True)
        if len(df) == 0:
            raise RuntimeError("Dataset is empty after filtering missing images.")
        self.df = df
        self._solar_to_id = SOLAR_BIN_TO_ID

    def __len__(self) -> int:
        return len(self.df)

    def __getitem__(self, i: int):
        """``(image, label)``, as a torch ``Dataset`` returns; ``load(i)``
        returns the full fixed-shape sample dict."""
        s = self.load(i)
        return s["image"], s["label"]

    def _boxes_for_row(self, row) -> np.ndarray:
        if self.cfg.boxes_col not in self.df.columns:
            return np.zeros((0, 4), np.float32)
        boxes = safe_iter_boxes(row[self.cfg.boxes_col])
        if self.cfg.unclear_policy == "exclude_unclear" and self.cfg.unclear_col in self.df.columns:
            unclear = row[self.cfg.unclear_col]
            unclear = np.asarray(unclear) if unclear is not None else np.zeros(0, bool)
            boxes = [
                b for i, b in enumerate(boxes)
                if not (i < len(unclear) and bool(unclear[i]))
            ]
        if not boxes:
            return np.zeros((0, 4), np.float32)
        return np.stack(boxes).astype(np.float32)

    def _solar_id(self, row) -> int:
        """The row's solar bin id; an unknown or absent bin → the last id."""
        cfg = self.cfg
        return self._solar_to_id.get(
            str(row[cfg.solar_col]) if cfg.solar_col in self.df.columns else "missing",
            len(self._solar_to_id) - 1,
        )

    def load_targets(self, i: int, sx: float = 1.0, sy: float = 1.0) -> Dict[str, np.ndarray]:
        """Fixed-shape ground-truth dict for one sample, no image decode.

        ``sx``/``sy`` rescale boxes when the pixels are resized on the way in
        (1.0 for pre-resized corpora)."""
        cfg = self.cfg
        row = self.df.iloc[i]
        boxes = self._boxes_for_row(row)
        if boxes.shape[0] and (sx != 1.0 or sy != 1.0):
            boxes = boxes * np.array([sx, sy, sx, sy], np.float32)
        n = min(boxes.shape[0], cfg.max_boxes)
        padded = np.zeros((cfg.max_boxes, 4), np.float32)
        padded[:n] = boxes[:n]
        mask = np.zeros(cfg.max_boxes, bool)
        mask[:n] = True

        label = int(row[cfg.label_col]) if cfg.label_col in self.df.columns else 0
        return {
            "gt_boxes": padded,                               # (max_boxes, 4)
            "gt_labels": np.zeros(cfg.max_boxes, np.int32),   # single class
            "gt_mask": mask,                                  # (max_boxes,)
            "label": np.int32(label),
            "solar_bin": np.int32(self._solar_id(row)),
        }

    def load(self, i: int) -> Dict[str, np.ndarray]:
        from PIL import Image

        cfg = self.cfg
        row = self.df.iloc[i]
        path = _resolve_path(row[cfg.image_path_col], cfg.image_root)
        with Image.open(path) as img:
            img = img.convert("RGB")
            sx = sy = 1.0
            if img.size != (cfg.img_w, cfg.img_h):
                sx = cfg.img_w / img.size[0]
                sy = cfg.img_h / img.size[1]
                img = img.resize((cfg.img_w, cfg.img_h), Image.BILINEAR)
            image = np.asarray(img, dtype=np.uint8)

        out = self.load_targets(i, sx, sy)
        out["image"] = image                                  # (H, W, 3) uint8
        return out

    def image_path(self, i: int) -> str:
        cfg = self.cfg
        return str(_resolve_path(self.df.iloc[int(i)][cfg.image_path_col], cfg.image_root))


def epoch_order(n: int, shuffle: bool, seed: int, epoch: int) -> np.ndarray:
    """The epoch's sample order, numpy's Generator as in JAX (the same
    permutation on every process; callers stride it per process)."""
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(idx)
    return idx


class DetectionLoader:
    """Threaded batch loader with optional epoch shuffling.

    Yields dicts of stacked numpy arrays with static shapes; the final
    partial batch is dropped during training (``drop_last=True``), kept and
    zero-padded for eval, with ``batch_valid`` false on the pad rows.
    """

    def __init__(
        self,
        dataset: ZODMoEVisionDataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        num_workers: int = 8,
        drop_last: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        store: str = "rgb",
    ):
        """``process_index``/``process_count`` give each process a disjoint
        strided slice of the identically shuffled epoch order.

        ``store`` selects the pixel path:

        * ``"rgb"`` — PIL decode per sample (any source size, any chroma);
          batches carry ``image`` uint8 RGB.
        * ``"yuv420"`` — native batch decode to raw 4:2:0 planes; batches
          carry ``y``/``cb``/``cr`` uint8 planes, which ``prefetch_to_device``
          (and the evaluator) turn into the same uint8 RGB on the card.
          Requires the native decoder and pre-resized 4:2:0 JPEGs, and
          raises ``ValueError`` without them.
        * ``"auto"`` — probe the first sample: ``yuv420`` when eligible,
          else ``rgb`` (with a line on stderr).
        """
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self._epoch = 0
        self.store = self._resolve_store(store)

    def _resolve_store(self, store: str) -> str:
        if store == "rgb":
            return "rgb"
        if store not in ("auto", "yuv420"):
            raise ValueError(f"unknown store {store!r}")
        cfg = self.dataset.cfg
        reason = None
        try:
            from .native_decode import decode_jpeg_bytes_yuv420, native_available

            if not native_available():
                reason = "native decoder unavailable"
            else:
                from PIL import Image

                path = Path(self.dataset.image_path(0))
                with Image.open(path) as probe:
                    if probe.size != (cfg.img_w, cfg.img_h):
                        reason = (
                            f"images are {probe.size}, not pre-resized to "
                            f"({cfg.img_w}, {cfg.img_h})"
                        )
                if reason is None and decode_jpeg_bytes_yuv420(
                    path.read_bytes(), cfg.img_h, cfg.img_w
                ) is None:
                    reason = "first JPEG is not 4:2:0 subsampled"
        except Exception as e:  # a failed probe makes "auto" take RGB, as in JAX
            reason = f"probe failed: {e}"
        if reason is None:
            return "yuv420"
        if store == "yuv420":
            raise ValueError(f"store='yuv420' not usable: {reason}")
        print(f"[loader] store=auto -> rgb ({reason})", file=sys.stderr)
        return "rgb"

    def _load_batch_yuv(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        """One whole batch through the native decoder: raw 4:2:0 planes and
        the stacked targets. The decode threads run outside the GIL."""
        from .native_decode import decode_jpeg_files_yuv420

        cfg = self.dataset.cfg
        paths = [self.dataset.image_path(i) for i in idx]
        y, cb, cr = decode_jpeg_files_yuv420(
            paths, cfg.img_h, cfg.img_w, n_threads=max(1, self.num_workers)
        )
        targets = [self.dataset.load_targets(int(i)) for i in idx]
        out = {k: np.stack([t[k] for t in targets]) for k in targets[0].keys()}
        out["y"], out["cb"], out["cr"] = y, cb, cr
        return out

    def __len__(self) -> int:
        n = len(np.arange(len(self.dataset))[self.process_index :: self.process_count])
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = epoch_order(len(self.dataset), self.shuffle, self.seed, self._epoch)
        idx = idx[self.process_index :: self.process_count]
        self._epoch += 1
        bs = self.batch_size
        n_full = len(idx) // bs
        batches: List[np.ndarray] = [idx[i * bs : (i + 1) * bs] for i in range(n_full)]
        if not self.drop_last and len(idx) % bs:
            batches.append(idx[n_full * bs :])

        yuv = self.store == "yuv420"
        # The yuv420 path threads inside the native decoder, so the Python
        # pool only pipelines whole-batch jobs two ahead; num_workers=0 (load
        # in-process) becomes one worker thread.
        pool_size = 2 if yuv else max(1, self.num_workers)
        with concurrent.futures.ThreadPoolExecutor(pool_size) as pool:
            def submit(b):
                if yuv:
                    return [pool.submit(self._load_batch_yuv, b)]
                return [pool.submit(self.dataset.load, int(i)) for i in b]

            pending = collections.deque()
            batch_iter = iter(batches)
            for _ in range(2):
                b = next(batch_iter, None)
                if b is not None:
                    pending.append((b, submit(b)))
            while pending:
                b, futures = pending.popleft()
                if yuv:
                    out = futures[0].result()
                else:
                    samples = [f.result() for f in futures]
                    out = {k: np.stack([s[k] for s in samples]) for k in samples[0].keys()}
                nxt = next(batch_iter, None)
                if nxt is not None:
                    pending.append((nxt, submit(nxt)))
                n_real = len(b)
                if n_real < bs:  # zero-pad the final eval batch
                    pad = bs - n_real
                    out = {
                        k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)], axis=0)
                        for k, v in out.items()
                    }
                    out["batch_valid"] = np.concatenate(
                        [np.ones(n_real, bool), np.zeros(pad, bool)]
                    )
                else:
                    out["batch_valid"] = np.ones(bs, bool)
                yield out


def _on_device(t: torch.Tensor, device: torch.device) -> bool:
    """Whether ``t`` already lies on ``device`` (``cuda`` without an index
    means the current card)."""
    if t.device.type != device.type:
        return False
    if device.type != "cuda":
        return True
    index = torch.cuda.current_device() if device.index is None else device.index
    return t.device.index == index


def _host_tensor(v) -> torch.Tensor:
    """A host array as a tensor on its memory (copied where numpy's is
    read-only or not contiguous, which a tensor cannot share)."""
    a = np.asarray(v)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, order="C")
    return torch.from_numpy(a)


def prefetch_to_device(
    iterator: Iterator[Dict[str, Any]],
    *,
    device=None,
    buffer_size: int = 2,
    mesh=None,
    shard: "tuple[int, int]" = (0, 1),
) -> Iterator[Dict[str, Any]]:
    """Move batches to ``device`` ahead of their consumer.

    ``device=None`` means the card (and raises without one); the tests pass
    ``device="cpu"``. On the card each host array is pinned and copied with
    ``non_blocking=True`` on a side stream; the consumer's stream waits on an
    event recorded after the copy, every tensor made on the side stream is
    marked used by the consumer's stream (``record_stream``) so the caching
    allocator cannot hand its memory out early, and the pinned sources stay
    referenced until their copies have completed. A batch of raw 4:2:0
    planes (``store="yuv420"`` loaders) gets its ``image`` on the card
    (``preprocess.yuv420_to_rgb_u8``) and loses ``y``/``cb``/``cr``, as in
    JAX. Tensors already on ``device`` (the resident loader's) pass through
    untouched. ``batch_valid`` stays a host array: the evaluator reads it
    there. A batch is yielded once ``buffer_size`` batches are queued.

    ``mesh=`` is JAX's ``sharding=``. ``shard`` is the loader's
    ``(process_index, process_count)``. A loader of ``mesh.size`` processes
    yields this rank's slice of the global batch already (the global batch
    is the ranks' batches in rank order, as
    ``make_array_from_process_local_data`` assembles it): its index must be
    the rank. A single-process loader yields the global batch, and each rank
    takes its rows (``batch_slice``) on the host.
    """
    from ..ops.preprocess import yuv420_to_rgb_u8
    from ..parallel.mesh import batch_slice

    dev = resolve_device(device)
    index, count = shard
    if mesh is not None and count != 1 and (count, index) != (mesh.size, mesh.rank):
        raise ValueError(f"a loader of process {index} of {count} on rank {mesh.rank} of a "
                         f"{mesh.size}-rank mesh")
    take_rows = mesh is not None and mesh.size > 1 and count == 1
    cuda = dev.type == "cuda"
    side = torch.cuda.Stream(device=dev) if cuda else None
    in_flight: "collections.deque" = collections.deque()  # (event, pinned sources)

    def _put(batch):
        if take_rows:
            rows = batch_slice(mesh, len(next(iter(batch.values()))))
            batch = {k: v[rows] for k, v in batch.items()}
        out, pinned, made = {}, [], []
        consumer = torch.cuda.current_stream(dev) if cuda else None
        if cuda:  # device tensors in the batch were made on the consumer's stream
            side.wait_stream(consumer)
        with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
            for k, v in batch.items():
                if k == "batch_valid":
                    out[k] = v
                    continue
                t = v if torch.is_tensor(v) else _host_tensor(v)
                if _on_device(t, dev):
                    out[k] = t
                elif cuda:
                    src = t.pin_memory()
                    pinned.append(src)
                    out[k] = src.to(dev, non_blocking=True)
                    made.append(out[k])
                else:
                    out[k] = t.to(dev)
            if "y" in out:
                out["image"] = yuv420_to_rgb_u8(out.pop("y"), out.pop("cb"), out.pop("cr"))
                made.append(out["image"])
        event = None
        if cuda:
            for t in made:
                t.record_stream(consumer)
            event = torch.cuda.Event()
            event.record(side)
            in_flight.append((event, pinned))
        return out, event

    def _take(entry):
        out, event = entry
        if event is not None:
            torch.cuda.current_stream(dev).wait_event(event)
        # Release the pinned sources of the copies that have completed.
        while in_flight and in_flight[0][0].query():
            in_flight.popleft()
        return out

    queue: "collections.deque" = collections.deque()
    for batch in iterator:
        queue.append(_put(batch))
        if len(queue) >= buffer_size:
            yield _take(queue.popleft())
    while queue:
        yield _take(queue.popleft())

