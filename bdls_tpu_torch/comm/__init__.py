"""The cluster mesh between ordering nodes on the port (the counterpart
of ``bdls_tpu/comm``): its wire format and the authenticated TCP
transport."""
