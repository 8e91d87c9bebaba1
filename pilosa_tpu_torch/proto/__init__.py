"""Wire types of the port: ``from pilosa_tpu_torch.proto import internal``.

The JAX package generates its message classes with ``protoc`` and reads
them through ``google.protobuf``; the port has its own codec
(``internal.py``) with the same message and field names and the same
bytes, and the raw-array import form (``rawimport.py``).
"""
