"""The cross-silo server's streaming fold (``stream_fold.py``)."""
