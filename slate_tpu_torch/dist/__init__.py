"""The distributed core (counterpart of ``slate_tpu/dist/``), so far
only the remap-record mirror of ``elastic.py`` that the serving
daemon's admission ladder reads. The tree engine, the mesh TSQR and
eigensolvers, the tuning share (ROADMAP queue 1, item 10a), the
sharded out-of-core stream and the elastic schedule (item 10b) are not
ported yet.
"""

from .elastic import remap_records, reset_remap_records  # noqa: F401
