"""Build the synthetic ZOD-layout corpus and run the whole ingestion chain.

The counterpart of the JAX package's ``scripts/build_synth_corpus.py``,
with its flags and defaults, writing the same files:

  raw tree  (data/synthetic.py make_synthetic_zod_tree, seed 0)
  -> index parquet + 1248x704 resized JPEGs  (data/indexer.py)
  -> xyxy bbox stage       (add_xyxy_bboxes)
  -> solar context bins    (data/solar.py)
  -> stratified 80/10/10 splits, seed 0  (data/splits.py, no sklearn)

Layout under ``--root``: ``raw/``, ``resized_images/``,
``outputs/index/*.parquet``, ``splits/{train,val,test}_ids.csv`` and
``corpus_build_summary.json``. The default root is ``synthzod`` in the home
directory, where JAX's script names that directory of its build host's
home. Besides JAX's lines it prints each stage's wall seconds as one
``[stages]`` JSON line. Host code only: nothing here touches the card.

    python -m multimodal_moe_torch.cli.build_synth_corpus --root DIR --frames 5000
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from ..data.indexer import IndexConfig, add_xyxy_bboxes, write_index
from ..data.solar import add_solar_context_bins
from ..data.splits import create_stratified_splits, write_split_csvs
from ..data.synthetic import make_synthetic_zod_tree


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Rebuild the synthetic ZOD-layout evaluation corpus + full ETL chain.")
    p.add_argument("--root", type=str, default=str(Path("~/synthzod").expanduser()))
    p.add_argument("--frames", type=int, default=5000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument(
        "--height-dist", type=str, default="zod704", choices=["zod704", "easy"],
        help="pedestrian height distribution: zod704 matches the reference's "
        "real-ZOD 704p quantiles (p50 18.94px); easy is the legacy "
        "large-figure corpus (uniform 120-700px full-res)",
    )
    p.add_argument("--new-w", type=int, default=1248)
    p.add_argument("--new-h", type=int, default=704)
    return p.parse_args(argv)


def main(argv=None) -> None:
    import pandas as pd

    args = parse_args(argv)
    root = Path(args.root)
    t0 = time.time()
    stages = {}

    print(f"[1/4] render raw tree -> {root}/raw ({args.frames} frames)", flush=True)
    zod_root = make_synthetic_zod_tree(root / "raw", args.frames, seed=args.seed, progress=True,
                                       height_dist=args.height_dist)
    t1 = time.time()
    stages["render"] = t1 - t0
    print(f"      done in {t1 - t0:.0f}s", flush=True)

    index_dir = root / "outputs" / "index"
    pq_base = index_dir / "ZODmoe_frames.parquet"
    print(f"[2/4] index + resize -> {pq_base}", flush=True)
    cfg = IndexConfig(zod_root=zod_root, out_parquet=pq_base,
                      resized_img_root=root / "resized_images", new_w=args.new_w,
                      new_h=args.new_h, workers=args.workers)
    write_index(cfg)
    t2 = time.time()
    stages["index"] = t2 - t1
    print(f"      done in {t2 - t1:.0f}s ({args.frames / (t2 - t1):.1f} f/s)", flush=True)

    print("[3/4] bbox + solar stages", flush=True)
    df = pd.read_parquet(pq_base)
    df = add_xyxy_bboxes(df)
    df.to_parquet(index_dir / "ZODmoe_frames_with_xyxy_bboxes.parquet", index=False)
    t3 = time.time()
    stages["boxes"] = t3 - t2
    df = add_solar_context_bins(df)
    final_pq = index_dir / "ZODmoe_frames_with_xyxy_bboxes_and_solar_bins.parquet"
    df.to_parquet(final_pq, index=False)
    t4 = time.time()
    stages["solar_bins"] = t4 - t3

    print("[4/4] stratified splits (seed %d)" % args.seed, flush=True)
    splits = create_stratified_splits(df, seed=args.seed)
    csvs = write_split_csvs(splits, root / "splits")
    stages["splits"] = time.time() - t4

    summary = {
        "frames": int(len(df)),
        "final_parquet": str(final_pq),
        "splits": {k: str(v) for k, v in csvs.items()},
        "split_sizes": {k: int(len(v)) for k, v in splits.items()},
        "wall_s": round(time.time() - t0, 1),
    }
    (root / "corpus_build_summary.json").write_text(json.dumps(summary, indent=2))
    print("[stages] " + json.dumps({"seconds": stages, "workers": args.workers}), flush=True)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
