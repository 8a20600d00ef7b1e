"""End-to-end node assemblies ("models"): the peer-side committer
pipeline and the client gateway (``models/peer.py``, assembled by
``models/txflow.py``) and the ordering node (``models/orderer.py``)
built from the port's layers."""
