"""command: the offline tools (``volume_tools``)."""
