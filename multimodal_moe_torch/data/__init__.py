"""The data side of the port, the counterpart of ``multimodal_moe_tpu/data/``.

Ingestion, run once on the host: ``synthetic`` (a seeded raw ZOD tree),
``indexer`` (frame dirs → the parquet index and resized JPEGs, the box
stage), ``bboxes``, ``solar`` (the context bins), ``splits`` (the
stratified 80/10/10 split, in numpy), ``exports`` (the YOLO layout and
COCO JSON) and ``qa``. The data path the training and evaluation read:
``index`` (split-filtered parquet rows), ``pipeline`` (the host loaders,
the copy to the card), ``native_decode``, ``resident`` and
``yolo_layout``. pandas, pyarrow and PIL are imported inside the functions
that use them.
"""
