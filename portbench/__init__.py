"""The benchmark of the PyTorch/CUDA port (see ``common.py``)."""
