"""Ordering-service node on the port: the wire codec, block cutter, block
creator, ledger and chain run-loop (reference: ``orderer/``; the
counterpart of ``bdls_tpu/ordering``). The multichannel registrar, the
message processor and the follower are not ported yet.
"""
