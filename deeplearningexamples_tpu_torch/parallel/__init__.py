"""The mesh axes of the port: start-up (``parallel/dist.py``), the mesh,
the batch's rows per rank and the collectives (``parallel/mesh.py``), and
ZeRO-1 (``parallel/zero.py``). Re-exports nothing, as ``ops/``."""
