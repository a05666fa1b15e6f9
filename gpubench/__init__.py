"""The benchmark of the PyTorch + CUDA port (``multimodal_moe_torch``) on
one H100: ``python -m gpubench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` (see ``gpubench/README.md``)."""
