"""Multi-GPU execution of the map over torch.distributed (one process per
GPU): the process group (dist.py), the data and part x data meshes and
their collectives (mesh.py), and the part-sharded block mapper, prober and
locator (partmesh.py)."""
