"""Build the frame-level ZOD index parquet and the resized images.

The counterpart of the JAX package's ``scripts/build_ZOD_index.py``, with
its flags and defaults (paths from ``multimodal_moe_torch/paths.py``,
1248×704, 16 workers, a ``--max-frames`` cap). Host code only.

    python -m multimodal_moe_torch.cli.build_zod_index --zod-root RAW --out-parquet P
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .. import paths
from ..data.indexer import IndexConfig, write_index


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Build ZOD frame index parquet.")
    p.add_argument("--zod-root", type=str, default=str(paths.ZOD_ROOT))
    p.add_argument("--out-parquet", type=str, default=str(paths.ZODMOE_FRAMES_PARQUET))
    p.add_argument("--resized-img-root", type=str, default=str(paths.RESIZED_IMAGES_DIR))
    p.add_argument("--no-resized-images", action="store_true",
                   help="Skip writing resized images (index metadata/annotations only).")
    p.add_argument("--new-w", type=int, default=1248)
    p.add_argument("--new-h", type=int, default=704)
    p.add_argument("--workers", type=int, default=16)
    p.add_argument("--max-frames", type=int, default=None, help="Smoke-test cap.")
    return p.parse_args(argv)


def main(argv=None) -> None:
    import pandas as pd

    args = parse_args(argv)
    cfg = IndexConfig(
        zod_root=Path(args.zod_root),
        out_parquet=Path(args.out_parquet),
        resized_img_root=None if args.no_resized_images else Path(args.resized_img_root),
        new_w=args.new_w,
        new_h=args.new_h,
        workers=args.workers,
        max_frames=args.max_frames,
    )
    out = write_index(cfg)
    df = pd.read_parquet(out)
    print(f"Saved {len(df)} frames to {out}")


if __name__ == "__main__":
    main()
