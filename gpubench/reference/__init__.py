"""The plain PyTorch reference the benchmark's checks compare the port
with: float32, TF32 off, importing nothing of the port."""
