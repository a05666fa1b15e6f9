"""Command-line entry points of the port, one module each, run as
``python -m multimodal_moe_torch.cli.<name>``, each with the flags and
defaults of the JAX package's ``scripts/<name>.py``: ingestion
(``build_synth_corpus``, ``build_zod_index``, ``add_bboxes``,
``add_solar_context_bins``, ``create_splits``, ``export_yolo_dataset``,
``export_coco_dataset``, ``analyze_index_qa``,
``analyze_context_frequencies``), training (``train_yolo``, ``train_moe``,
``train_rtdetr``, ``train_vision_baseline``), evaluation and analysis
(``eval_detector``, ``quantize_yolo``, ``analyze_moe_routing``) and serving
(``serve_detector``, ``predict_detector``). ``build_zod_index`` is JAX's
``build_ZOD_index``."""
