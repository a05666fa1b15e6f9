"""Command-line entry points of the port, one module each, run as
``python -m multimodal_moe_torch.cli.<name>``: ``serve_detector`` and
``predict_detector``, with the flags and defaults of the JAX package's
``scripts/serve_detector.py`` and ``scripts/predict_detector.py``."""
