"""Ordering-service node on the port: the wire codecs, block cutter,
block creator, ledger, the BDLS and Raft chains, the message processor,
the follower and the multichannel registrar (reference: ``orderer/``;
the counterpart of ``bdls_tpu/ordering``).
"""
