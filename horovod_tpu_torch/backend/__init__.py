"""Backend families of the port: the gpu family only (``gpu_topo.py``)."""
