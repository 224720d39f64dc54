"""Parallel layers of the ported slice, and the mesh axis names.

The axis-name constants are those of ``horovod_tpu/parallel/mesh.py``
(``:28-32``), which the model configuration's defaults name.  The port
has no mesh yet: every axis is of size 1.
"""

DP_AXIS = "dp"
SP_AXIS = "sp"
TP_AXIS = "tp"
EP_AXIS = "ep"
