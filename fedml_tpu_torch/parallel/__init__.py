"""The cross-silo server's streaming fold (``stream_fold.py``), the
decentralized mixing topologies (``topology.py``), and the multi-process
layer: the gloo process group (``multihost.py``), meshes over its ranks
(``mesh.py``) and the parameter sharding rules (``sharding.py``)."""
