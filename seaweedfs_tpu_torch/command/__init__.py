"""command: the ``weed``-style CLI (``cli``: ``python3 -m
seaweedfs_tpu_torch.command.cli master|volume|server|filer|s3|shell|
version``) and the offline tools (``volume_tools``)."""
