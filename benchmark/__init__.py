"""The benchmark of the PyTorch and CUDA port (``benchmark/README.md``)."""
