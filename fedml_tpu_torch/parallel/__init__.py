"""The cross-silo server's streaming fold (``stream_fold.py``) and the
decentralized mixing topologies (``topology.py``)."""
