"""OSD-side pieces of the port: so far the per-pool erasure codec
(``ec_pg.ECCodec``)."""
