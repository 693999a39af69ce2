"""Manager daemon pieces of the port (src/mgr/).

Only the PGMap digest codec (``pgmap``) is here, for the monitor; the
manager daemon and its modules are not ported yet.
"""
