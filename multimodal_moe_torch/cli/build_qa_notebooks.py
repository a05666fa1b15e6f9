"""Build + execute the port's data-QA notebooks.

The counterpart of the JAX package's ``scripts/build_qa_notebooks.py``: the
same cells as its two notebooks, with the port's modules in their imports
(``multimodal_moe_torch.data.qa``, ``.indexer``, ``.solar``,
``.synthetic``), executed with nbclient so the committed files carry real
outputs. They run against ``$ZOD_ROOT`` when it points at a real ZOD tree
and otherwise self-provision a rendered synthetic corpus
(``data/synthetic.py``). The files are new ones,
``notebooks/torch_zod_frames_index_sanity.ipynb`` and
``notebooks/torch_zod_vision_exploration.ipynb``: JAX's two notebooks are
never written. nbformat and nbclient (with ipykernel and matplotlib for the
execution) are imported only when the notebooks are built. Host code only.

    python -m multimodal_moe_torch.cli.build_qa_notebooks [--no-execute]
"""

from __future__ import annotations

import argparse
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT_DIR = REPO / "notebooks"
NOTEBOOKS = ("torch_zod_frames_index_sanity.ipynb", "torch_zod_vision_exploration.ipynb")

SETUP = """\
# Environment: run against a real ZOD tree when ZOD_ROOT points at one,
# else self-provision a rendered synthetic corpus (this build environment
# has no real ZOD frames — data/synthetic.py renders learnable scenes).
import os, sys, json, tempfile
from pathlib import Path
sys.path.insert(0, {repo!r})

import numpy as np
import pandas as pd
import matplotlib.pyplot as plt  # ipykernel inline backend renders figures into the notebook

from multimodal_moe_torch.data import qa
from multimodal_moe_torch.data.indexer import IndexConfig, write_index, add_xyxy_bboxes
from multimodal_moe_torch.data.solar import add_solar_context_bins

zod_root = os.environ.get("ZOD_ROOT", "")
if not zod_root or not any(Path(zod_root).glob("*/metadata.json")):
    work = Path(tempfile.mkdtemp(prefix="zod_qa_nb_"))
    from multimodal_moe_torch.data.synthetic import make_synthetic_zod_tree
    zod_root = make_synthetic_zod_tree(work / "raw", 60, seed=7)
    print(f"no real ZOD tree — using synthetic corpus at {{zod_root}}")
else:
    work = Path(tempfile.mkdtemp(prefix="zod_qa_nb_"))
    zod_root = Path(zod_root)

pq = write_index(IndexConfig(
    zod_root=zod_root, out_parquet=work / "ZODmoe_frames.parquet",
    resized_img_root=work / "resized", new_w=1248, new_h=704, workers=2,
), progress=False)
df = add_solar_context_bins(add_xyxy_bboxes(pd.read_parquet(pq)))
len(df)
"""


def _nb(cells):
    import nbformat as nbf

    nb = nbf.v4.new_notebook()
    nb.metadata["kernelspec"] = {
        "display_name": "Python 3",
        "language": "python",
        "name": "python3",
    }
    nb.cells = [
        nbf.v4.new_markdown_cell(src) if kind == "md" else nbf.v4.new_code_cell(src)
        for kind, src in cells
    ]
    return nb


def sanity_nb():
    c = []
    c.append(("md", (
        "# Assessing correctness of the ZOD frames index\n\n"
        "QA battery over the canonical parquet produced by "
        "`scripts/build_ZOD_index.py` → `add_bboxes` → `add_solar_context_bins`.\n"
        "All checks live in the tested library `multimodal_moe_torch/data/qa.py` "
        "(see `tests/test_qa.py`); this notebook narrates and visualizes them.\n\n"
        "Mirrors the reference QA instrument "
        "(ref: notebooks/zod_frames_index_sanity.ipynb)."
    )))
    c.append(("code", SETUP.format(repo=str(REPO))))
    c.append(("md", "## Schema and dtypes"))
    c.append(("code", "df.info()"))
    c.append(("code", "df.describe(include='all').T.head(30)"))
    c.append(("md", (
        "## Label distributions\n\n"
        "`ped_bin_4` bins the **clear** pedestrian count: 0 → bin 0, 1–5 → 1, "
        "6–15 → 2, >15 → 3. `ped_present = ped_bin_4 > 0`."
    )))
    c.append(("code", (
        "lab = qa.label_distributions(df)\n"
        "print(json.dumps({k: v for k, v in lab.items() if k != 'ped_count_clear'}, indent=2, default=str))\n"
        "fig, axes = plt.subplots(1, 2, figsize=(10, 3.2))\n"
        "df['ped_count_clear'].hist(bins=20, ax=axes[0]); axes[0].set_title('ped_count_clear')\n"
        "df['ped_bin_4'].value_counts().sort_index().plot.bar(ax=axes[1]); axes[1].set_title('ped_bin_4')\n"
        "plt.tight_layout(); plt.show()"
    )))
    c.append(("code", "df['ped_count_clear'].describe(), df['ped_count_unclear'].describe()"))
    c.append(("md", "## Missing values"))
    c.append(("code", "qa.missing_values(df)[lambda s: s > 0]"))
    c.append(("md", (
        "## Occlusion-column consistency\n\n"
        "The seven `ped_occ_*` columns must sum to the total pedestrian count "
        "per frame, and *unclear* pedestrians must carry no usable occlusion "
        "level (they map to the missing/unknown buckets)."
    )))
    c.append(("code", (
        "occ = qa.occlusion_consistency(df)\n"
        "assert occ['n_mismatched_frames'] == 0, occ['mismatched_frame_ids']\n"
        "occ"
    )))
    c.append(("md", (
        "## Parallel-array invariant\n\n"
        "Per frame, `ped_uuid[i]`, `ped_unclear_list[i]`, "
        "`ped_occlusion_list[i]` and `ped_points_xy_resized[i]` must all "
        "describe the same pedestrian — equal lengths == clear + unclear "
        "count. A violation means the downstream exporters would pair boxes "
        "with the wrong flags (the single worst silent corruption this "
        "pipeline can have)."
    )))
    c.append(("code", (
        "bad = qa.parallel_array_invariant(df)\n"
        "assert len(bad) == 0, bad\n"
        "print(f'invariant holds on all {len(df)} frames')"
    )))
    c.append(("md", "## Context crosstabs (bins × time-of-day / weather / road type)"))
    c.append(("code", (
        "for col, tab in qa.context_crosstabs(df).items():\n"
        "    print(f'--- ped_bin_4 x {col} ---')\n"
        "    print(tab, end='\\n\\n')"
    )))
    c.append(("md", (
        "## BBox reconstruction spot check\n\n"
        "`xyxy_bboxes` (bbox stage) must equal min/max over "
        "`ped_points_xy_resized` (raw index)."
    )))
    c.append(("code", (
        "r = df[(df.ped_count_clear + df.ped_count_unclear) > 0].iloc[0]\n"
        "pts0 = np.stack([np.asarray(p, float) for p in r['ped_points_xy_resized'][0]])\n"
        "manual = [pts0[:,0].min(), pts0[:,1].min(), pts0[:,0].max(), pts0[:,1].max()]\n"
        "stored = np.asarray(r['xyxy_bboxes'][0], float)\n"
        "print('manual:', np.round(manual, 3))\n"
        "print('stored:', np.round(stored, 3))\n"
        "assert np.allclose(manual, stored, atol=1e-4)"
    )))
    c.append(("md", (
        "## Conclusions\n\n"
        "* schema, dtypes and missing-value pattern as designed\n"
        "* occlusion columns and parallel arrays consistent on every frame\n"
        "* bbox stage reproduces the raw point extents exactly\n\n"
        "The same battery gates ETL runs via `scripts/analyze_index_qa.py` "
        "(nonzero exit on invariant violations) and runs in CI "
        "(`tests/test_qa.py`)."
    )))
    return _nb(c)


def exploration_nb():
    c = []
    c.append(("md", (
        "# ZOD dataset exploration — camera pedestrian prediction\n\n"
        "What the raw frame tree contains, what survives the 1248×704 resize, "
        "and which labels the benchmark tasks use. Mirrors the reference "
        "exploration instrument (ref: notebooks/zod_vision_exploration.ipynb)."
    )))
    c.append(("code", SETUP.format(repo=str(REPO))))
    c.append(("md", (
        "## On-disk structure\n\n"
        "Each frame directory carries `metadata.json`, "
        "`annotations/object_detection.json` and "
        "`camera_front_dnat/<id>_camera_front_dnat.jpg` — the indexer walks "
        "exactly this shape."
    )))
    c.append(("code", (
        "fd = sorted(Path(zod_root).iterdir())[0]\n"
        "for p in sorted(fd.rglob('*')):\n"
        "    print(p.relative_to(fd))\n"
        "meta = json.loads((fd / 'metadata.json').read_text())\n"
        "meta"
    )))
    c.append(("md", "## Annotation anatomy — class inventory and one object"))
    c.append(("code", (
        "anns = json.loads((fd / 'annotations' / 'object_detection.json').read_text())\n"
        "from collections import Counter\n"
        "print('classes:', Counter(a['properties'].get('class') for a in anns))\n"
        "anns[0] if anns else '(no objects in this frame)'"
    )))
    c.append(("md", (
        "## Pedestrian visibility under the global resize (1248×704)\n\n"
        "The protocol resizes ~3848×2168 frames to 1248×704 (×~0.32). A "
        "pedestrian needs ≥ a dozen pixels of height to be learnable; this "
        "is the feasibility analysis for the resize choice."
    )))
    c.append(("code", (
        "bb = qa.bbox_stats(df)\n"
        "print(json.dumps(bb, indent=2, default=str))\n"
        "heights = []\n"
        "for _, r in df.iterrows():\n"
        "    for b in r['xyxy_bboxes']:\n"
        "        b = np.asarray(b, float)\n"
        "        heights.append(b[3] - b[1])\n"
        "plt.figure(figsize=(6, 3))\n"
        "plt.hist(heights, bins=40)\n"
        "plt.xlabel('pedestrian height (px, resized frame)'); plt.ylabel('count')\n"
        "plt.title('Pedestrian height distribution at 1248×704')\n"
        "plt.show()"
    )))
    c.append(("md", "## Pedestrian counts and the 4-bin label"))
    c.append(("code", (
        "counts = df['ped_count_clear']\n"
        "print(counts.describe())\n"
        "print(df['ped_bin_4'].value_counts().sort_index())"
    )))
    c.append(("md", "## Weather / time-of-day context"))
    c.append(("code", (
        "print(df['scraped_weather'].value_counts())\n"
        "print(df['time_of_day'].value_counts())\n"
        "print(df['solar_context_bin'].value_counts())"
    )))
    c.append(("md", (
        "## Occlusion distribution & the unclear↔occlusion relationship\n\n"
        "'unclear' pedestrians (ambiguous annotations) carry no usable "
        "occlusion level; exporters treat them per `unclear_policy`."
    )))
    c.append(("code", (
        "occ = qa.occlusion_consistency(df)\n"
        "print('occlusion totals:', occ['occlusion_totals'])\n"
        "print('levels attached to unclear peds:', occ['unclear_ped_occlusion_levels'])"
    )))
    c.append(("md", "## Visual sanity — boxes over a resized frame"))
    c.append(("code", (
        "from PIL import Image, ImageDraw\n"
        "r = df[df.ped_count_clear > 1].iloc[0]\n"
        "im = Image.open(r['resized_image_path']).convert('RGB')\n"
        "d = ImageDraw.Draw(im)\n"
        "for b in r['xyxy_bboxes']:\n"
        "    b = np.asarray(b, float)\n"
        "    d.rectangle(list(b), outline=(255, 0, 255), width=3)\n"
        "plt.figure(figsize=(9, 5)); plt.imshow(im); plt.axis('off')\n"
        "plt.title(f'frame {r.frame_id}: {len(r.xyxy_bboxes)} pedestrians')\n"
        "plt.show()"
    )))
    c.append(("md", (
        "## Conclusions\n\n"
        "* the frame tree parses cleanly end-to-end; labels derive exactly as "
        "documented (bins, presence, solar context)\n"
        "* the resize keeps the bulk of pedestrians above the learnability "
        "threshold; the visibility fractions above quantify the tail\n"
        "* unclear annotations are isolated from the occlusion statistics "
        "and handled by exporter policy\n"
    )))
    return _nb(c)


def main(argv=None) -> None:
    import nbformat as nbf

    ap = argparse.ArgumentParser()
    ap.add_argument("--no-execute", action="store_true")
    args = ap.parse_args(argv)

    out_dir = OUT_DIR
    out_dir.mkdir(exist_ok=True)
    for name, nb in zip(NOTEBOOKS, (sanity_nb(), exploration_nb())):
        if not args.no_execute:
            from nbclient import NotebookClient

            NotebookClient(nb, timeout=600, kernel_name="python3").execute()
        nbf.write(nb, out_dir / name)
        n_out = sum(1 for cell in nb.cells if cell.get("outputs"))
        print(f"wrote {out_dir / name} ({len(nb.cells)} cells, {n_out} with outputs)")


if __name__ == "__main__":
    main()
