"""Multi-GPU training: the process group, the ``(data, expert)`` mesh of
ranks and its collectives.

Counterpart of ``multimodal_moe_tpu/parallel/``. The JAX step is one
``jax.jit`` over the global batch that GSPMD partitions; here each rank is
a process holding its slice of the batch, and every reduction across the
batch is made global by hand (BatchNorm, the YOLO loss, the routers) under
:func:`.mesh.use_mesh`.
"""
