"""The data path: split-filtered parquet rows, the host loaders, the native
JPEG binding, the copy to the card and the device-resident loader.

Counterpart of ``multimodal_moe_tpu/data/`` for the modules the training
and evaluation paths read; the ingestion modules that write the parquet and
label files run once on the host and are not ported.
"""
