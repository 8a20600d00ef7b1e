"""End-to-end node assemblies ("models"): the peer-side committer
pipeline and the client gateway built from the port's layers
(``models/peer.py``; the ordering node assembly is not ported yet)."""
