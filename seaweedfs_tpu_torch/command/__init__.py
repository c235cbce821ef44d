"""command: the ``weed``-style CLI (``cli``: ``python3 -m
seaweedfs_tpu_torch.command.cli master|volume|server|filer|s3|shell|
benchmark|upload|download|filer.copy|backup|see|export|fix|compact|
scaffold|version``), the load generator it drives (``benchmark``), the
example configs (``scaffold``) and the offline tools (``volume_tools``)."""
