"""client — what a SeaweedFS client calls: assign a file id at the
master, upload to a volume server, look a volume up (through a TTL'd
cache, or a map the master pushes), read and delete."""

from .operation import (  # noqa: F401
    VidCache, assign, delete_file, lookup, read_file, upload, upload_data,
)
