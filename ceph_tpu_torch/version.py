"""Framework version — checked at plugin registration and reported
by the admin socket (the CEPH_GIT_NICE_VER role)."""

FRAMEWORK_VERSION = "ceph-tpu-1"
