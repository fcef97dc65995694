"""Wire layer: the typed messages the ported data plane exchanges.

Port of ``ceph_tpu/msg/__init__.py``, reduced to ``message.py``'s EC
sub-op messages. The messenger, its transports and the rest of the
message catalog are not ported yet.
"""
